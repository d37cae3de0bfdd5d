"""The port's fused violation path as a whole, on the CPU: a Client over
TorchDriver(device="cpu") against a Client over the JAX package's
TpuDriver and over its interpreter RegoDriver, on the in-repo templates
(deploy/policies). audit() results and review_many() responses must be
identical lists, in the same order, with the same messages; the fused
dispatch's packed need bits, hot rows and pair counts must equal the JAX
dispatch's on the same corpus.
"""

import itertools
import json

import numpy as np
import pytest
import torch

import chip_smoke
from gatekeeper_tpu.constraint import (
    AugmentedUnstructured as JAug,
    Backend as JBackend,
    K8sValidationTarget as JTarget,
    RegoDriver as JRegoDriver,
)
from gatekeeper_tpu.constraint.tpudriver import TpuDriver
from gatekeeper_tpu_torch.constraint import (
    AugmentedUnstructured as TAug,
    Backend as TBackend,
    K8sValidationTarget as TTarget,
)
from gatekeeper_tpu_torch import interop
from gatekeeper_tpu_torch.constraint.torchdriver import TorchDriver
from gatekeeper_tpu_torch.engine.exprs import EvalCtx
from gatekeeper_tpu_torch.engine.programs import ProgramEvaluator

TARGET = chip_smoke.TARGET
N_CONSTRAINTS = 12
# pod generator indices: every multiple below violates one template
# (owner label, image repo/tag, memory ceiling, privileged, annotation)
POD_IDS = [
    i * m for i, m in zip(range(300), itertools.cycle([1, 499, 503, 509, 521, 541, 3]))
]


def _client(backend, target, driver):
    client = backend(driver).new_client(target())
    for t in chip_smoke.template_docs():
        client.add_template(t)
    for c in chip_smoke.constraint_docs(N_CONSTRAINTS):
        client.add_constraint(c)
    for i in POD_IDS:
        client.add_data(chip_smoke.make_pod(i))
    return client


def _batch(aug, seed, size=24):
    out = []
    for j in range(size):
        pod = chip_smoke.make_pod(POD_IDS[(seed * 7 + j) % len(POD_IDS)],
                                  name=f"admit-{seed}-{j}")
        pod["metadata"]["labels"]["release"] = f"r{seed}-{j}"
        if j % 3 == 0:
            pod["spec"]["containers"][0]["image"] = f"docker.io/novel{seed}x{j}"
        out.append(aug(pod))
    return out


def _keys(results):
    return [chip_smoke.result_key(r) for r in results]


@pytest.fixture(scope="module")
def clients():
    torch_drv = TorchDriver(device="cpu")
    tpu_drv = TpuDriver()
    return {
        "torch": (_client(TBackend, TTarget, torch_drv), torch_drv),
        "tpu": (_client(JBackend, JTarget, tpu_drv), tpu_drv),
        "rego": (_client(JBackend, JTarget, JRegoDriver()), None),
    }


def test_audit_identical(clients):
    got = _keys(clients["torch"][0].audit().by_target[TARGET].results)
    tpu = _keys(clients["tpu"][0].audit().by_target[TARGET].results)
    rego = _keys(clients["rego"][0].audit().by_target[TARGET].results)
    assert len(rego) > 50
    assert got == rego
    assert got == tpu
    stats = clients["torch"][1].stats
    # the in-repo templates all compile: every matched pair took the
    # fused route, and the violating ones rendered from compiled plans
    assert stats["interp_pairs"] == 0 and stats["compiled_pairs"] > 0
    assert stats["host_rendered_pairs"] > 0
    assert stats["render_errors"] == 0


@pytest.mark.parametrize("seed", [0, 1])
def test_review_many_identical(clients, seed):
    tpu_client, tpu_drv = clients["tpu"]
    tpu_batch = _batch(JAug, seed)
    assert tpu_client.warm_review_path(tpu_batch)
    want = [_keys(r.by_target[TARGET].results)
            for r in clients["rego"][0].review_many(_batch(JAug, seed))]
    tpu = [_keys(r.by_target[TARGET].results)
           for r in tpu_client.review_many(tpu_batch)]
    got = [_keys(r.by_target[TARGET].results)
           for r in clients["torch"][0].review_many(_batch(TAug, seed))]
    assert sum(len(w) for w in want) > 10
    assert got == want
    assert got == tpu
    assert clients["torch"][1].stats["compiled_pairs"] > 0


def test_fused_dispatch_equals_jax(clients):
    """The whole-corpus dispatch output (need bits, hot rows, hot count,
    pair counts) of both implementations on their audit corpora."""
    t_client, t_drv = clients["torch"]
    j_client, j_drv = clients["tpu"]
    t_client.audit()
    j_client.audit()
    t_cs, j_cs = t_drv._cset[TARGET], j_drv._cset[TARGET]
    t_corpus, j_corpus = t_drv._corpus[TARGET], j_drv._corpus[TARGET]
    want = j_drv.kernel.dispatch_need_all(
        j_cs.policy, j_corpus.staged, (j_corpus.g, j_corpus.g1)
    )
    got = t_drv.kernel.dispatch_need_all(
        t_cs.policy, t_corpus.staged, (t_corpus.g, t_corpus.g1)
    )
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w))
    assert int(np.asarray(want[2]).sum()) > 0


def test_programs_equal_jax_eval(clients):
    """Every compiled program's per-pod violation counts: the port's
    Expr DAG fed the JAX package's encoded corpus, tables and consts
    (through interop) equals the JAX ProgramEvaluator.eval_jax; the
    port's own ProgramEvaluator over its own encoding gives the same
    counts."""
    t_client, t_drv = clients["torch"]
    j_client, j_drv = clients["tpu"]
    t_client.audit()
    j_client.audit()
    # same templates, same corpus, same interning order -> same encoding
    assert t_drv.vocab._strs == j_drv.vocab._strs
    t_progs = t_drv._cset[TARGET].programs
    j_progs = j_drv._cset[TARGET].programs
    corpus = j_drv._corpus[TARGET]
    g = (corpus.g, corpus.g1)
    tabs = interop.tables(
        {
            "pat_member": np.asarray(j_drv.patterns.member),
            "pat_capture": np.asarray(j_drv.patterns.capture),
            **{k: np.asarray(v) for k, v in j_drv.tables.arrays().items()},
        },
        "cpu",
    )
    tok = interop.tokens(corpus.tok, "cpu")
    wants = list(np.asarray(j_drv.evaluator.eval_jax(j_progs, corpus.tok, g=g)))
    for tp, jp, want in zip(t_progs, j_progs, wants):
        consts = {}
        if jp.consts:  # one const set, stacked as the JAX policy stacks
            consts = interop.const_sets(
                {k: np.asarray(v)[None] for k, v in jp.consts.items()}, "cpu"
            )[0]
        ctx = EvalCtx(
            tok=tok,
            pat_member=tabs["pat_member"],
            pat_capture=tabs["pat_capture"],
            str_tables={k: v for k, v in tabs.items() if not k.startswith("pat_")},
            consts=consts,
            g0=g[0],
            g1=g[1],
        )
        got = tp.expr.emit(ctx).to(torch.int32).numpy()
        assert np.array_equal(got, want)
    own = ProgramEvaluator(t_drv.patterns, t_drv.tables).eval(
        t_progs, interop.tokens(t_drv._corpus[TARGET].tok, "cpu"), g
    )
    assert own.dtype == torch.int32
    assert np.array_equal(own.numpy(), np.stack(wants))
    assert np.stack(wants).any()


def test_single_review_identical(clients):
    pod = chip_smoke.make_pod(503)
    got = clients["torch"][0].review(TAug(json.loads(json.dumps(pod))))
    want = clients["rego"][0].review(JAug(pod))
    assert _keys(got.by_target[TARGET].results) == _keys(
        want.by_target[TARGET].results
    )
    assert want.by_target[TARGET].results


def test_interpreter_routes_identical(clients):
    """Rows past the device fanout cap (G_CAP) and traced queries take
    the interpreter: same results as the interpreter driver."""
    wide = chip_smoke.make_pod(503, name="wide")
    base = wide["spec"]["containers"][0]
    wide["spec"]["containers"] = [
        dict(base, name=f"c{i}") for i in range(70)
    ]
    pods = [wide, chip_smoke.make_pod(521, name="narrow")]
    want = [
        _keys(r.by_target[TARGET].results)
        for r in clients["rego"][0].review_many([JAug(p) for p in pods])
    ]
    t_client, t_drv = clients["torch"]
    got = [
        _keys(r.by_target[TARGET].results)
        for r in t_client.review_many([TAug(json.loads(json.dumps(p))) for p in pods])
    ]
    assert got == want and want[0]
    assert t_drv.stats["interp_pairs"] > 0
    assert t_drv.stats["interp_rendered_pairs"] > 0
    traced = t_client.review(TAug(json.loads(json.dumps(pods[1]))), tracing=True)
    assert _keys(traced.by_target[TARGET].results) == want[1]
    assert traced.by_target[TARGET].trace


def test_render_cache_smaller_than_sweep(clients):
    """A repeat sweep whose violating pairs outnumber the render cache
    serves the cached pairs and re-renders the rest from compiled plans,
    never on the interpreter, with identical results."""
    drv = TorchDriver(device="cpu")
    client = _client(TBackend, TTarget, drv)
    drv.render_cache_max = 10
    first = _keys(client.audit().by_target[TARGET].results)
    n_pairs = drv.stats["host_rendered_pairs"]
    assert n_pairs > 10
    second = _keys(client.audit().by_target[TARGET].results)
    assert second == first
    assert drv.stats["render_cache_hits"] == 10
    assert drv.stats["host_rendered_pairs"] == n_pairs - 10
    assert drv.stats["interp_rendered_pairs"] == 0


def test_device_tables_hold_only_slab_columns(clients):
    """The dispatch stages the string tables and the policy's `!T` slab
    columns, never the full [P, V] pattern tables; with slabs in the
    context, a pattern node whose column was not staged raises instead
    of gathering from tables the device does not hold."""
    from gatekeeper_tpu_torch.engine.exprs import ECapture, ESelPattern

    t_client, t_drv = clients["torch"]
    t_client.audit()
    policy = t_drv._cset[TARGET].policy
    tabs = t_drv.kernel._tables_device(policy)
    assert "pat_member!T" in tabs
    assert not {"pat_member", "pat_capture"} & set(tabs)
    tok = {"spath": torch.zeros((2, 3), dtype=torch.int32)}
    ctx = EvalCtx(
        tok=tok, pat_member=None, pat_capture=None, str_tables={},
        consts={}, slabs={"pat_member": torch.zeros((2, 3, 1), dtype=torch.bool)},
        slab_cols={"pat_member": {0: 0}},
    )
    assert ESelPattern(0)._emit(ctx).shape == (2, 3)
    with pytest.raises(KeyError):
        ESelPattern(1)._emit(ctx)
    with pytest.raises(KeyError):
        ECapture(0)._emit(ctx)
