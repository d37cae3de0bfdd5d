"""The full-output audit step on the port, on the CPU.

`FusedKernel.run` (match [C, N], counts [Cc, N], totals [C]) against the
JAX package's `FusedAuditKernel.run` on the harness policy
(`__graft_entry__._build_driver`, whose Gateway host join is an inventory
screen) and on the uniqueness fixtures over a mixed-GVK corpus;
`ProgramEvaluator.eval_torch` against `eval_jax`; K7's plain version
against the JAX totals expression; and `gatekeeper_tpu_torch.entry.entry`
on the CPU. Tolerance: none, every output is a bool or an int32.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
import chip_smoke
from gatekeeper_tpu.constraint import Backend as JBackend
from gatekeeper_tpu.constraint import K8sValidationTarget as JTarget
from gatekeeper_tpu.constraint.tpudriver import TpuDriver
from gatekeeper_tpu_torch import entry as torch_entry
from gatekeeper_tpu_torch.constraint import Backend as TBackend
from gatekeeper_tpu_torch.constraint import K8sValidationTarget as TTarget
from gatekeeper_tpu_torch.constraint.torchdriver import TorchDriver
from gatekeeper_tpu_torch.engine.programs import ProgramEvaluator
from gatekeeper_tpu_torch.kernels import ops

TARGET = chip_smoke.TARGET


def _inventory_client(backend, target, driver, n=160):
    client = backend(driver).new_client(target())
    for t in chip_smoke.template_docs()[:4] + chip_smoke.uniqueness_templates():
        client.add_template(t)
    kinds = {"K8sRequiredLabels", "K8sAllowedRepos", "K8sBlockNodePort", "K8sPSPPrivileged"}
    for c in chip_smoke.constraint_docs(10):
        if c["kind"] in kinds:
            client.add_constraint(c)
    for c in chip_smoke.uniqueness_constraints():
        client.add_constraint(c)
    rows = [chip_smoke.make_mixed(i) for i in range(0, 4 * n, 4)]
    rows += [chip_smoke.make_mixed(i) for i in (17, 117, 18, 118, 57, 157)]
    for r in rows:
        client.add_data(json.loads(json.dumps(r)))
    return client


def _states():
    """name -> (JAX (driver, cs, corpus), port (driver, cs, corpus))."""
    out = {}
    jd, _, jcs, jcor = ge._build_driver(19)
    td, _, tcs, tcor = torch_entry._build_driver(19, device="cpu")
    out["graft-19"] = ((jd, jcs, jcor), (td, tcs, tcor))
    pairs = []
    for backend, target, drv in ((JBackend, JTarget, TpuDriver()),
                                 (TBackend, TTarget, TorchDriver(device="cpu"))):
        _inventory_client(backend, target, drv)
        with drv._mutex:
            corpus = drv._audit_corpus(TARGET)
            cs = drv._constraint_set(TARGET)
        drv.patterns.sync()
        drv.tables.sync()
        pairs.append((drv, cs, corpus))
    out["inventory"] = tuple(pairs)
    return out


@pytest.fixture(scope="module")
def states():
    return _states()


@pytest.mark.parametrize("name", ["graft-19", "inventory"])
def test_run_equals_jax(states, name):
    (jd, jcs, jcor), (td, tcs, tcor) = states[name]
    want = jd.kernel.run(jcs.programs, jcs.ms, jcor.fb_dev, jcor.tok, jcor.g)
    got = td.kernel.run(tcs.programs, tcs.ms, tcor.fb, tcor.tok, tcor.g)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)
    match, counts, totals = got
    assert match.any() and counts.any() and totals.any()
    assert any(p is None for p in tcs.programs) or name == "inventory"
    assert any(p is not None and p.row_features for p in tcs.programs)


@pytest.mark.parametrize("name", ["graft-19", "inventory"])
def test_prepare_gives_device_tensors(states, name):
    """prepare's fn runs on the tensors it was given and counts no
    kernel launch on the CPU; run cuts its output to [:c, :n]."""
    _, (td, tcs, tcor) = states[name]
    ops.reset_launches()
    fn, args, (c, n, key) = td.kernel.prepare(
        tcs.programs, tcs.ms, tcor.fb, tcor.tok, tcor.g
    )
    match, counts, totals = fn(*args)
    assert all(t.device.type == "cpu" for t in (match, counts, totals))
    assert match.shape == (c, n) and totals.shape == (c,)
    assert counts.shape == (sum(p is not None for p in tcs.programs), n)
    assert sum(ops.LAUNCHES.values()) == 0
    assert key == td.kernel.prepare(
        tcs.programs, tcs.ms, tcor.fb, tcor.tok, tcor.g
    )[2][2]


@pytest.mark.parametrize("name", ["graft-19", "inventory"])
def test_eval_torch_equals_eval_jax(states, name):
    (jd, jcs, jcor), (td, tcs, tcor) = states[name]
    jp = [p for p in jcs.programs if p is not None]
    tp = [p for p in tcs.programs if p is not None]
    for g in (jcor.g, (jcor.g, jcor.g1)):
        want = np.asarray(jd.evaluator.eval_jax(jp, jcor.tok, g))
        got = ProgramEvaluator(td.patterns, td.tables).eval_torch(
            tp, tcor.tok, g, device="cpu"
        )
        assert got.dtype == np.int32 == want.dtype
        assert np.array_equal(got, want)
        assert want.any()


def _jax_totals(match, counts, crow, n_valid):
    """The JAX step's tail (parallel/sharding.py run_fused), as written
    there: counts scattered to the compiled rows, then where / > 0 /
    valid / sum."""
    rows = np.nonzero(crow >= 0)[0]
    viol = jnp.zeros(match.shape, jnp.int32)
    if rows.size:
        viol = viol.at[jnp.asarray(rows)].set(jnp.asarray(counts)[crow[rows]])
    valid_n = jnp.arange(match.shape[1]) < n_valid
    return np.asarray(jnp.sum(
        (jnp.where(match, viol, 0) > 0) & valid_n[None, :], axis=1
    ).astype(jnp.int32))


@pytest.mark.parametrize("seed,c,n,cc", [
    (0, 7, 33, 4), (1, 64, 1000, 40), (2, 5, 4, 5), (3, 30, 257, 1),
    (4, 12, 96, 0),
])
def test_full_totals_plain_equals_jax(seed, c, n, cc):
    r = np.random.default_rng(seed)
    match = r.random((c, n)) < 0.6
    counts = r.integers(-2, 4, (cc, n)).astype(np.int32)
    crow = np.full((c,), -1, np.int32)
    if cc:
        live = np.sort(r.choice(c, min(cc, c), replace=False))
        crow[live] = r.permutation(cc)[: live.size]
    for n_valid in (n, max(n - 3, 0), n // 2, 0):
        want = _jax_totals(match, counts, crow, n_valid)
        args = (torch.from_numpy(match), torch.from_numpy(counts) if cc else None,
                torch.from_numpy(crow), n_valid)
        got = ops.full_totals_plain(*args)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(ops.full_totals(*args).numpy(), want)
    assert ops.LAUNCHES["full_totals"] == 0


def test_full_totals_rows_outside_counts_total_zero():
    match = torch.ones((3, 8), dtype=torch.bool)
    counts = torch.ones((2, 8), dtype=torch.int32)
    crow = torch.tensor([5, 1, -1], dtype=torch.int32)
    assert ops.full_totals_plain(match, counts, crow, 6).tolist() == [0, 6, 0]


def test_entry_runs_on_cpu():
    fn, args = torch_entry.entry(device="cpu")
    match, counts, totals = fn(*args)
    # 4 constraints (labels, privileged, the unique-host screen and the
    # interpreter-routed deep scan) over 16 pods + 6 gateways
    assert match.shape == (4, 22) and counts.shape == (3, 22)
    jfn, jargs = ge.entry()
    jmatch, jcounts, jtotals = jfn(*jargs)
    assert np.array_equal(match.numpy(), np.asarray(jmatch))
    assert np.array_equal(counts.numpy(), np.asarray(jcounts))
    assert np.array_equal(totals.numpy(), np.asarray(jtotals))
    crow = args[-1]
    assert (crow < 0).sum() == 1  # the interpreter-routed deep scan ...
    assert totals[crow < 0].tolist() == [0]  # ... totals 0
    assert totals.sum() > 0


def test_entry_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_entry.entry()
