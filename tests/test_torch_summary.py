"""The port's SUMMARY-line contract (gatekeeper_tpu_torch/summary.py)
against the JAX package's (gatekeeper_tpu/summary.py), on the same seeded
documents and logs: the schema table, every line written, every parse
and lint answer, and every error raised, exactly."""

import json

import numpy as np
import pytest

from gatekeeper_tpu import summary as ref
from gatekeeper_tpu_torch import summary as port

SEEDS = range(6)


def _value(rng):
    pick = int(rng.integers(0, 6))
    if pick == 0:
        return None
    if pick == 1:
        return round(float(rng.random()) * 1000.0, 4)
    if pick == 2:
        return int(rng.integers(-5, 10_000))
    if pick == 3:
        return bool(rng.integers(0, 2))
    if pick == 4:
        return [int(x) for x in rng.integers(0, 100, size=3)]
    return f"v{int(rng.integers(0, 1000))}"


def _docs(seed: int):
    """Summary documents per mode: all required fields, some dropped, an
    `error` in place of the headline, extra fields, an unknown mode, a
    missing mode."""
    rng = np.random.default_rng(seed)
    modes = sorted(ref.REQUIRED_FIELDS)
    out = []
    for mode in modes:
        fields = ref.REQUIRED_FIELDS[mode]
        full = {f: _value(rng) for f in fields}
        full[f"extra{int(rng.integers(0, 9))}"] = _value(rng)
        out.append((mode, full))
        keep = [f for f in fields if rng.random() < 0.6]
        out.append((mode, {f: full[f] for f in keep}))
        if rng.random() < 0.5:
            out.append((mode, {"error": f"boom {seed}"}))
    out.append((f"nomode{seed}", {"p50_ms": 1.0}))
    return out


def _outcome(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:  # the same type and message, or the test fails
        return ("raise", type(e).__name__, str(e))


def test_schema_table_and_prefix_equal():
    assert port.REQUIRED_FIELDS == ref.REQUIRED_FIELDS
    assert port.SUMMARY_PREFIX == ref.SUMMARY_PREFIX
    assert port.__all__ == ref.__all__


@pytest.mark.parametrize("seed", SEEDS)
def test_format_check_and_parse_equal(seed):
    for mode, head in _docs(seed):
        line = port.format_summary(mode, head)
        assert line == ref.format_summary(mode, head)
        doc = json.loads(line[len(ref.SUMMARY_PREFIX):])
        assert port.check_summary(doc) == ref.check_summary(doc)
        for narrow in (None, mode, "soak"):
            got = _outcome(port.parse_summary_line, line, mode=narrow)
            want = _outcome(ref.parse_summary_line, line, mode=narrow)
            assert got == want


def test_malformed_lines_raise_the_same_errors():
    lines = [
        "not a summary",
        "SUMMARY: [1, 2]",
        'SUMMARY: {"p50_ms": 1}',
        'SUMMARY: {"mode": "webhook"}',
        'SUMMARY: {"mode": "nope", "a": 1}',
        "   " + ref.format_summary("webhook", {
            "p50_ms": 1, "p99_ms": 2, "throughput_rps": 3}) + "  ",
    ]
    for line in lines:
        assert _outcome(port.parse_summary_line, line) == _outcome(
            ref.parse_summary_line, line)
    assert port.check_summary({}) == ref.check_summary({})
    # a payload that is not JSON raises the same decoder error
    assert _outcome(port.parse_summary_line, "SUMMARY: {oops") == _outcome(
        ref.parse_summary_line, "SUMMARY: {oops")


@pytest.mark.parametrize("seed", SEEDS)
def test_find_summary_equal_on_seeded_logs(seed):
    """Captured output with noise, broken lines and several summaries:
    the last parseable one (narrowed to a mode or not) is found alike."""
    rng = np.random.default_rng(100 + seed)
    docs = _docs(seed)
    lines = []
    for _ in range(40):
        pick = int(rng.integers(0, 4))
        if pick == 0:
            mode, head = docs[int(rng.integers(0, len(docs)))]
            lines.append(ref.format_summary(mode, head))
        elif pick == 1:
            lines.append("SUMMARY: {truncated")
        elif pick == 2:
            lines.append(f"step {int(rng.integers(0, 99))} done")
        else:
            lines.append("  " + ref.format_summary("soak", {
                "slo_attainment": float(rng.random()), "shed_rate": 0.0,
                "leak_flagged": [], "checks": {"leak_flat": True}}))
    text = "\n".join(lines)
    for mode in (None, "soak", "webhook", "chaos"):
        assert port.find_summary(text, mode=mode) == ref.find_summary(
            text, mode=mode)
    assert port.find_summary("") is None and ref.find_summary("") is None
