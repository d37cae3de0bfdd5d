# Copied from gatekeeper_tpu/summary.py; no line below differs.
"""The bench SUMMARY line contract, shared by every lane.

Every bench entry point (`bench_webhook.py --ladder/--attribution/
--partitions/--fleet/--chaos/--churn/--external/--mutate/--soak/
--slo/--sched`, `bench.py`)
ends its run with one compact driver-parseable line:

    SUMMARY: {"mode": "<lane>", ...headline numbers...}

The full JSON artifact has outgrown capture buffers before (BENCH_r05's
`parsed: null`); the SUMMARY line is the part that must survive
truncation — which only helps if its schema cannot silently drift from
the readers (`bench_compare.py`, the soak report tests, the BENCH_r*
trajectory tooling). This module is the one place the contract lives:

  * `REQUIRED_FIELDS` — per-mode headline keys a summary MUST carry;
  * `format_summary` — the writer every lane emits through;
  * `parse_summary_line` — the strict reader (raises on an unknown
    mode or a missing required field);
  * `check_summary` — the lint form (problem list, empty = valid).

tests/test_summary_contract.py drives every bench mode's summarizer
through the strict reader so a new headline field — or a dropped one —
fails CI instead of a future postmortem.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

__all__ = [
    "REQUIRED_FIELDS",
    "SUMMARY_PREFIX",
    "check_summary",
    "format_summary",
    "parse_summary_line",
]

SUMMARY_PREFIX = "SUMMARY: "

# per-mode headline keys every SUMMARY line must carry. A key listed
# here may be null (a truncated run reports what it has) but must be
# PRESENT — presence is what the readers key on.
REQUIRED_FIELDS: Dict[str, tuple] = {
    "webhook": ("p50_ms", "p99_ms", "throughput_rps"),
    "ladder": ("rungs", "last"),
    "attribution": (
        "rungs", "sums_ok", "attribution_ratio", "dispatch_efficiency",
        "partitions_touched_p50", "partitions_touched_max",
    ),
    "partitions": (
        "parity_ok", "healthy_subset_degraded",
        "degraded_coverage_fraction", "recovery_s", "home_restored",
    ),
    "fleet": (
        "fetches_per_key_n1", "fetches_per_key_n2_isolated",
        "fetches_per_key_n2_fleet", "cold_fetch_amplification",
    ),
    "chaos": ("phases", "p50_ms", "p99_ms", "shed_rate"),
    "churn": (
        "waves", "ingest_to_serve_ms", "degraded_dispatches",
        "http_5xx",
    ),
    "external": ("phases", "cache_hit_rate", "fetches_per_batch"),
    "mutate": ("p50_ms", "p99_ms", "throughput_rps"),
    "soak": (
        "slo_attainment", "shed_rate", "leak_flagged", "checks",
    ),
    # the live SLO plane lane (obs/slo.py): streaming attainment +
    # burn rate through a fault/recover cycle, plus the autoscaler
    # signals (saturation up-bad, headroom) bench_compare.py gates
    "slo": (
        "slo_attainment", "saturation", "burn_rate_fast",
        "headroom_rps", "breaches",
    ),
    # the admission-scheduler lane (gatekeeper_tpu/sched/): the same
    # two-tenant overload through FIFO then the deadline scheduler —
    # per-class latency/attainment split, the worst per-tenant
    # attainment (bench_compare watches it down-bad), and predictive
    # (predicted_miss) vs blind (FIFO queue_full) shed counts
    "sched": (
        "quiet_p50_ms", "quiet_p99_ms", "noisy_p50_ms", "noisy_p99_ms",
        "quiet_attainment", "noisy_attainment", "tenant_attainment_min",
        "predicted_miss_shed", "blind_shed",
    ),
    # the wire-speed ingest lane (docs/ingest.md): one open-loop
    # arrival schedule through conn-per-request HTTP/1, HTTP/1.1
    # keep-alive, and the framed stream listener — goodput inside one
    # shared deadline per phase, the framed/legacy ratio, and the
    # zero-copy scanner's p50 (bench_compare watches rps_sustained
    # down-bad and decode_p50_ms up-bad)
    "ingest": (
        "offered_rps", "rps_sustained", "framed_vs_http1",
        "http1_rps_sustained", "keepalive_rps_sustained",
        "framed_attainment", "http1_attainment", "p50_ms", "p99_ms",
        "decode_p50_ms", "decode_span_share", "conns_per_1k_framed",
        "conns_per_1k_http1",
    ),
    # the verdict-integrity lane (docs/robustness.md §Verdict
    # integrity): clean → injected-SDC → self-test-healed. Divergence
    # rate and canary overhead are bench_compare WATCHED (both
    # up-bad); detection latency is arm -> corruption quarantine
    "integrity": (
        "phases", "divergence_rate", "canary_overhead_frac",
        "detection_latency_s", "selftest_healed",
    ),
}


def format_summary(mode: str, head: Dict[str, Any]) -> str:
    """Render one SUMMARY line. `mode` is stamped first so a truncated
    tail still names its lane; values serialize via default=str so an
    exotic object costs readability, never the line."""
    doc = {"mode": mode}
    doc.update(head)
    return SUMMARY_PREFIX + json.dumps(doc, default=str)


def check_summary(doc: Dict[str, Any]) -> List[str]:
    """Problem list for a parsed summary doc (empty = valid)."""
    problems: List[str] = []
    mode = doc.get("mode")
    if mode is None:
        return ["missing field: mode"]
    required = REQUIRED_FIELDS.get(mode)
    if required is None:
        return [f"unknown summary mode: {mode!r}"]
    if doc.get("error"):
        # a summarizer that caught an exception reports it instead of
        # the headline set; the reader surfaces that, not a field lint
        return []
    for f in required:
        if f not in doc:
            problems.append(f"{mode} summary missing {f!r}")
    return problems


def parse_summary_line(
    line: str, mode: Optional[str] = None
) -> Dict[str, Any]:
    """Strict SUMMARY reader: raises ValueError on a non-summary line,
    an unknown/unexpected mode, or a missing required headline field.
    `mode` narrows to one lane (the soak reader passes "soak")."""
    line = line.strip()
    if not line.startswith(SUMMARY_PREFIX):
        raise ValueError(f"not a SUMMARY line: {line[:40]!r}")
    doc = json.loads(line[len(SUMMARY_PREFIX):])
    if not isinstance(doc, dict):
        raise ValueError("SUMMARY payload is not an object")
    if mode is not None and doc.get("mode") != mode:
        raise ValueError(
            f"not a {mode} summary: mode={doc.get('mode')!r}"
        )
    problems = check_summary(doc)
    if problems:
        raise ValueError("; ".join(problems))
    return doc


def find_summary(text: str, mode: Optional[str] = None) -> Optional[
    Dict[str, Any]
]:
    """Last parseable SUMMARY line in a blob of captured output (the
    bench_compare.py input path for raw run logs); None when absent."""
    found = None
    for line in text.splitlines():
        line = line.strip()
        if not line.startswith(SUMMARY_PREFIX):
            continue
        try:
            found = parse_summary_line(line, mode=mode)
        except ValueError:
            continue
    return found
