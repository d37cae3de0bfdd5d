"""The port's C token flattener (gatekeeper_tpu_torch/native/flatten.c)
against the port's Python encoder and the JAX package's C and Python
encoders: the same token arrays AND the same vocab contents and order
(vocab ids are load-bearing everywhere downstream), in plain and in
OverlayVocab chain mode. A native build failure raises with the
compiler's output, and nothing falls back to the Python encoder unless
the caller asks for it."""

import os
import shutil
import stat

import numpy as np
import pytest

import chip_smoke
import gatekeeper_tpu.flatten.encoder as JE
from gatekeeper_tpu.flatten.vocab import Vocab as JVocab
from gatekeeper_tpu.native import load_flatten_native as j_load_native
import gatekeeper_tpu_torch.flatten.encoder as E
from gatekeeper_tpu_torch import native as native_mod
from gatekeeper_tpu_torch.constraint import AugmentedUnstructured, K8sValidationTarget
from gatekeeper_tpu_torch.constraint.torchdriver import TorchDriver
from gatekeeper_tpu_torch.flatten.encoder import K_STR, encode_token_table
from gatekeeper_tpu_torch.flatten.vocab import OverlayVocab, Vocab

FIELDS = ("spath", "idx0", "idx1", "kind", "vid", "vnum", "n_tokens", "overflow")

WEIRD_OBJS = [
    {},
    [],
    {"a": {}},
    {"a": []},
    {"a": None, "b": True, "c": False},
    {"one": 1, "true": True, "zero": 0, "false": False, "f1": 1.0},
    {"n": 0, "m": -7, "f": 1.5, "g": 2.0, "big": 10**12, "neg": -1.25e-9},
    {"s": "", "t": "hello", "q": "100m", "mem": "1Gi", "e": "1e3",
     "notq": "12abc", "spaced": "  50Mi  "},
    {"dotted.key": 1, "has%pct": 2, "#": 3, "a#b": 4,
     "kubernetes.io/ingress.class": "nginx"},
    {"arr": [1, [2, [3, [4, [5]]]], {"x": "y"}]},
    {"containers": [
        {"name": f"c{i}", "ports": [{"p": j, "tags": [[j], [i]]} for j in range(3)]}
        for i in range(5)
    ]},
    {"mixed": [{"a": 1}, [], {}, None, "s", 2.5, True]},
    {"unicode": "héllo wörld", "emoji": "🚀", "cjk": "策略"},
    {"long": "x" * 5000, "longkey" * 40: "v"},
    {"deep": {"a": {"b": {"c": {"d": {"e": [{"f": [1, 2]}]}}}}}},
]


@pytest.fixture(autouse=True)
def _compiler():
    # skip on a MISSING toolchain only: a toolchain that exists but fails
    # to build must fail these tests, not skip them
    if shutil.which(os.environ.get("CC", "gcc")) is None:
        pytest.skip("no C compiler")


def _python(objs, vocab, max_len=None):
    return encode_token_table(objs, vocab, max_len=max_len, native=False)


def _assert_tables_equal(got, want):
    for f in FIELDS:
        assert np.array_equal(getattr(got, f), getattr(want, f)), f


def _assert_vocab_equal(a, b):
    assert list(a._strs) == list(b._strs), "vocab strings/order diverge"
    assert dict(a._ids) == dict(b._ids), "vocab ids diverge"
    assert list(a._quantity) == list(b._quantity), "quantity memo diverges"


def _seeded(vocab_cls):
    v = vocab_cls()
    v.str_id("hello")
    v.intern("p:containers.#.name")
    return v


def _reviews(ids, name=None):
    handler = K8sValidationTarget()
    out = []
    for i in ids:
        pod = chip_smoke.make_pod(i, name=None if name is None else f"{name}{i}")
        out.append(handler.handle_review(AugmentedUnstructured(pod))[1])
    return out


def test_native_builds_and_loads():
    mod = native_mod.load_flatten_native()
    assert hasattr(mod, "encode_rows")
    assert native_mod.load_flatten_native() is mod


@pytest.mark.parametrize("max_len", [None, 8])
def test_native_matches_python(max_len):
    objs = WEIRD_OBJS * 3
    v_py, v_c = _seeded(Vocab), _seeded(Vocab)
    want = _python(objs, v_py, max_len)
    got = encode_token_table(objs, v_c, max_len=max_len)
    _assert_tables_equal(got, want)
    _assert_vocab_equal(v_c, v_py)


def test_native_matches_python_on_pod_reviews():
    objs = _reviews(range(300))
    v_py, v_c = Vocab(), Vocab()
    _assert_tables_equal(encode_token_table(objs, v_c), _python(objs, v_py))
    _assert_vocab_equal(v_c, v_py)


@pytest.mark.parametrize("batch", ["weird", "pods"])
def test_native_chain_mode_over_overlay(batch):
    """OverlayVocab chain mode: base ids resolve through the base dict,
    novel strings intern locally from base_len up; the base is never
    mutated."""
    base_py, base_c = Vocab(), Vocab()
    corpus = _reviews(range(100))
    _python(corpus, base_py)
    encode_token_table(corpus, base_c)
    _assert_vocab_equal(base_c, base_py)
    snapshot = list(base_c._strs)
    objs = WEIRD_OBJS if batch == "weird" else _reviews(range(50, 150), "admit-")
    ov_py, ov_c = OverlayVocab(base_py), OverlayVocab(base_c)
    want = _python(objs, ov_py)
    got = encode_token_table(objs, ov_c)
    _assert_tables_equal(got, want)
    _assert_vocab_equal(ov_c, ov_py)
    assert ov_c._strs, "the batch interned nothing locally"
    assert list(base_c._strs) == snapshot


def test_native_matches_jax_encoders(monkeypatch):
    """The port's C path against the JAX package's C path and its Python
    encoder on the same objects."""
    objs = WEIRD_OBJS * 2 + _reviews(range(120))
    v_port = _seeded(Vocab)
    got = encode_token_table(objs, v_port)
    v_jc = _seeded(JVocab)
    jnative = j_load_native()
    assert jnative is not None
    want_c = JE._encode_token_table_native(jnative, list(objs), v_jc, None)
    v_jp = _seeded(JVocab)
    monkeypatch.setattr(JE, "_flatten_native", lambda: None)
    want_py = JE.encode_token_table(objs, v_jp)
    for want, v_ref in ((want_c, v_jc), (want_py, v_jp)):
        _assert_tables_equal(got, want)
        _assert_vocab_equal(v_port, v_ref)


def test_native_quantity_fallback_parity():
    """Inputs the C parser delegates to Python (unicode whitespace, long
    mantissas, control whitespace) and non-finite floats match exactly."""
    objs = [
        {"nbsp": " 100m", "long": "0" * 70 + "1" + "Gi",
         "inf": float("inf"), "ninf": float("-inf"),
         "uspace": "  2Gi  ", "plain": "250m"},
        {"q": "\x1c100m\x1f", "r": "\x1d2Gi"},
    ]
    v_py, v_c = Vocab(), Vocab()
    want = _python(objs, v_py)
    got = encode_token_table(objs, v_c)
    _assert_tables_equal(got, want)
    _assert_vocab_equal(v_c, v_py)


def test_native_deep_nesting_raises():
    """A pathologically deep object raises a catchable RecursionError,
    not a C stack overflow."""
    deep = cur = {}
    for _ in range(5000):
        cur["a"] = {}
        cur = cur["a"]
    cur["leaf"] = 1
    with pytest.raises(RecursionError):
        encode_token_table([deep], Vocab())


def test_native_failure_raises_not_degrades(monkeypatch):
    class Broken:
        def encode_rows(self, *args):
            raise ValueError("native encode failed")

    monkeypatch.setattr(E, "_flatten_native", lambda: Broken())
    with pytest.raises(ValueError, match="native encode failed"):
        encode_token_table([{"a": 1}], Vocab())
    # the explicit request for the Python encoder never touches it
    table = encode_token_table([{"a": 1}], Vocab(), native=False)
    assert int(table.n_tokens[0]) == 1


def test_preflattened_rows_take_the_python_path(monkeypatch):
    """Rows carrying ingest preflattened tokens encode in Python (the C
    walker would see only the lifted keys)."""

    class Lazy(dict):
        _preflat_rows = [("metadata.name", -1, -1, K_STR, "lazy", 0.0)]

    def no_native():
        raise AssertionError("native path used for a preflattened row")

    monkeypatch.setattr(E, "_flatten_native", no_native)
    v = Vocab()
    table = encode_token_table([Lazy(), {"x": Lazy()}], v)
    assert table.n_tokens.tolist() == [1, 1]
    assert v.string(int(table.spath[1, 0])) == "p:x.metadata.name"


def test_build_with_missing_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CC", str(tmp_path / "no-such-cc"))
    with pytest.raises(RuntimeError, match="cannot run the C compiler"):
        native_mod.load_or_build(tmp_path / "build")
    assert not list((tmp_path / "build").glob("_flatten_native_*"))


def test_build_failure_carries_compiler_output(monkeypatch, tmp_path):
    cc = tmp_path / "failing-cc"
    cc.write_text("#!/bin/sh\necho 'flatten.c:1: error: boom' >&2\nexit 3\n")
    cc.chmod(cc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CC", str(cc))
    with pytest.raises(RuntimeError, match="flatten.c:1: error: boom") as exc:
        native_mod.load_or_build(tmp_path / "build")
    assert "rc 3" in str(exc.value)
    assert not list((tmp_path / "build").iterdir())


def test_driver_encoders_agree():
    """TorchDriver(encoder="python") and encoder="native" give identical
    audit() and review_many() results."""
    clients = {
        enc: chip_smoke.build_client(TorchDriver(device="cpu", encoder=enc), 200, 12)
        for enc in ("python", "native")
    }
    audits = {
        enc: chip_smoke._keys(c.audit().by_target[chip_smoke.TARGET].results)
        for enc, c in clients.items()
    }
    assert audits["native"] == audits["python"] and audits["native"]
    for seed in range(2):
        objs = chip_smoke.review_batch(seed, 24)
        got = {
            enc: [chip_smoke._keys(r.by_target[chip_smoke.TARGET].results)
                  for r in c.review_many(objs)]
            for enc, c in clients.items()
        }
        assert got["native"] == got["python"]
        assert any(got["native"])


def test_driver_encoder_routing(monkeypatch):
    """The driver encodes natively by default and in Python only when
    asked; an unknown encoder is refused."""
    calls = []
    real = E._flatten_native

    def counted():
        calls.append(1)
        return real()

    monkeypatch.setattr(E, "_flatten_native", counted)
    chip_smoke.build_client(TorchDriver(device="cpu", encoder="python"), 20, 4).audit()
    assert calls == []
    chip_smoke.build_client(TorchDriver(device="cpu"), 20, 4).audit()
    assert calls
    with pytest.raises(ValueError, match="encoder"):
        TorchDriver(device="cpu", encoder="fast")
