"""The port's kernel functions (plain torch versions, on the CPU) against
the JAX package, exactly: every output here is bool or int, and float
inputs are integer-valued so that sums are exact in any order.

  * slab gather (K2) vs the `two_level` row gather of
    gatekeeper_tpu/parallel/sharding.py:771-781, with and without a
    review batch's vocabulary overlay;
  * EGroup (K3) vs the JAX node's `_emit` under jax.numpy, for
    max/any/sum x bool/int32/float32 values x g0/g1/g01 axes;
  * the need tail (K4) vs FusedAuditKernel.dispatch_need (`_need_chunk_fn`
    plus the host unpack): packed bits, hot rows, hot count and pair
    statistics, with a hot-row window both smaller and larger than the
    number of hot rows.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gatekeeper_tpu.engine import exprs as jx
from gatekeeper_tpu.engine.patterns import PatternRegistry as JPatterns
from gatekeeper_tpu.engine.programs import Program as JProgram
from gatekeeper_tpu.engine.tables import StrTables as JTables
from gatekeeper_tpu.flatten import Vocab as JVocab
from gatekeeper_tpu.parallel.sharding import FusedAuditKernel, StagedBatch as JBatch
from gatekeeper_tpu_torch import interop
from gatekeeper_tpu_torch.engine import exprs as tx
from gatekeeper_tpu_torch.engine.patterns import PatternRegistry as TPatterns
from gatekeeper_tpu_torch.engine.programs import Program as TProgram
from gatekeeper_tpu_torch.engine.tables import StrTables as TTables
from gatekeeper_tpu_torch.flatten.vocab import Vocab as TVocab
from gatekeeper_tpu_torch.kernels import ops
from gatekeeper_tpu_torch.parallel.fused import FusedKernel, StagedBatch as TBatch

from test_torch_matchkernel import _raw_battery

NEG_INF = -(10.0**30)  # engine/symbolic.py's float max-init


# -- K2 slab gather -----------------------------------------------------------


def _two_level_jax(base_tab, ov_tab, ids, v_base):
    """sharding.py:771-781 `two_level`, called on jnp.maximum(ids, 0)."""
    ids = jnp.maximum(ids, 0)
    rows = base_tab.shape[0]
    base = base_tab[jnp.clip(ids, 0, rows - 1)]
    if ov_tab is None:
        return base
    loc = ids - v_base
    b = ov_tab.shape[0]
    ov = ov_tab[jnp.clip(loc, 0, b - 1)]
    return jnp.where((loc >= 0)[..., None], ov, base)


def _table(r, shape, dtype):
    if dtype == np.bool_:
        return r.random(shape) < 0.5
    return r.integers(-5, 50, size=shape).astype(dtype)


@pytest.mark.parametrize("overlay", [False, True])
@pytest.mark.parametrize("dtype", [np.bool_, np.int32, np.float32])
def test_slab_gather_equals_two_level(dtype, overlay):
    r = np.random.default_rng(11)
    v, t, b = 40, 7, 16
    tab = _table(r, (v, t), dtype)
    ov = _table(r, (b, t), dtype) if overlay else None
    v_base = 30  # ids at or above it read the overlay block
    # ids past the table and past the overlay exercise JAX's clamps
    ids = r.integers(-2, v_base + b + 5, size=(24, 12)).astype(np.int32)
    want = np.asarray(_two_level_jax(tab, ov, ids, v_base))
    got = ops.slab_gather(
        torch.from_numpy(tab),
        torch.clamp(torch.from_numpy(ids), min=0),
        None if ov is None else torch.from_numpy(ov),
        v_base,
    ).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


# -- K3 EGroup ----------------------------------------------------------------


def _egroup_inputs(r, n=20, l=24, g0=8, g1=4, dtype=np.int32):
    idx0 = r.integers(-1, g0 + 2, size=(n, l)).astype(np.int32)
    idx1 = r.integers(-1, g1 + 2, size=(n, l)).astype(np.int32)
    mask = r.random((n, l)) < 0.6
    if dtype == np.bool_:
        val = r.random((n, l)) < 0.5
    else:
        val = r.integers(-3, 9, size=(n, l)).astype(dtype)
    # one row where every token lands in slot 0 (max without init)
    idx0[0] = 0
    idx1[0] = 0
    mask[0] = True
    return idx0, idx1, mask, val


def _ctx(mod, xp_tok, g0, g1, **kw):
    return mod.EvalCtx(
        tok=xp_tok, pat_member=None, pat_capture=None, str_tables={},
        consts={}, g0=g0, g1=g1, **kw,
    )


@pytest.mark.parametrize("axis", ["g0", "g1", "g01"])
@pytest.mark.parametrize("dtype", [np.bool_, np.int32, np.float32])
@pytest.mark.parametrize("how", ["max", "any", "sum"])
def test_egroup_equals_jax_node(how, dtype, axis):
    r = np.random.default_rng(5)
    g0, g1 = 8, 4
    idx0, idx1, mask, val = _egroup_inputs(r, g0=g0, g1=g1, dtype=dtype)
    init = NEG_INF if (how == "max" and dtype == np.float32) else -1
    cols = {"idx0": idx0, "idx1": idx1, "m": mask, "v": val,
            "spath": idx0}
    jnode = jx.EGroup(jx.ETokCol("m"), jx.ETokCol("v"), axis, how, init)
    tnode = tx.EGroup(tx.ETokCol("m"), tx.ETokCol("v"), axis, how, init)
    want = np.asarray(
        jnode.emit(_ctx(jx, {k: jnp.asarray(v) for k, v in cols.items()},
                        g0, g1, np=jnp))
    )
    got = tnode.emit(
        _ctx(tx, {k: torch.from_numpy(v) for k, v in cols.items()}, g0, g1)
    ).numpy()
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape
    assert np.array_equal(got, want)


# -- K4 need tail ---------------------------------------------------------------


def _need_inputs(seed, n=96, c_viol=0.15):
    """Random specs/features (the raw match battery), per-constraint
    violation rows riding as a const slot, some interpreter-only
    constraints, row fallbacks and a partial chunk."""
    r = np.random.default_rng(seed)
    ms, fb = _raw_battery(seed, u=40, n=n)
    c = ms["kind_rows"].shape[0]
    viol = (r.random((c, n)) < c_viol).astype(np.int32)
    # constraint pairs share a row so the const-set dedup has work
    viol[1::2] = viol[0::2]
    interp = r.random(c) < 0.2
    row_fb = r.random(n) < 0.05
    n_valid = n - 9
    return ms, fb, viol, interp, row_fb, n_valid


def _jax_need(ms, fb, viol, interp, row_fb, n_valid, r_cap):
    v = JVocab()
    kernel = FusedAuditKernel(JPatterns(v), JTables(v))
    progs = [
        None if interp[i] else JProgram(
            expr=jx.EConstSlot("v"), consts={"v": viol[i]}, signature=("v",)
        )
        for i in range(len(interp))
    ]
    policy = kernel.stage_policy(progs, ms)
    n = fb["group_id"].shape[0]
    blank = np.full((n, 1), -1, np.int32)
    batch = JBatch(
        fb_dev={k: jnp.asarray(a) for k, a in fb.items()},
        tok_dev={"spath": jnp.asarray(blank), "vid": jnp.asarray(blank)},
        row_fb=jnp.asarray(row_fb),
        n_valid=n_valid,
        key=("test", n),
    )
    packed, hot, n_hot, sc, si = kernel.dispatch_need(
        policy, batch, 8, r_cap=r_cap
    )
    return np.asarray(packed), np.asarray(hot), n_hot, sc, si


def _torch_need(ms, fb, viol, interp, row_fb, n_valid, r_cap):
    v = TVocab()
    kernel = FusedKernel(TPatterns(v), TTables(v), "cpu")
    progs = [
        None if interp[i] else TProgram(
            expr=tx.EConstSlot("v"), consts={"v": viol[i]}, signature=("v",)
        )
        for i in range(len(interp))
    ]
    policy = kernel.stage_policy(progs, ms)
    n = fb["group_id"].shape[0]
    blank = torch.full((n, 1), -1, dtype=torch.int32)
    batch = TBatch(
        fb_dev=interop.features(fb, "cpu"),
        tok_dev={"spath": blank, "vid": blank},
        row_fb=torch.from_numpy(row_fb),
        n_valid=n_valid,
    )
    return kernel.dispatch_need(policy, batch, 8, r_cap=r_cap)


@pytest.mark.parametrize("r_cap", [4, 96])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_need_tail_equals_need_chunk(seed, r_cap):
    args = _need_inputs(seed)
    j_packed, j_hot, j_nh, j_sc, j_si = _jax_need(*args, r_cap)
    t_packed, t_hot, t_nh, t_sc, t_si = _torch_need(*args, r_cap)
    assert t_packed.dtype == np.uint8 and np.array_equal(t_packed, j_packed)
    assert np.array_equal(t_hot, j_hot)
    assert (t_nh, t_sc, t_si) == (j_nh, j_sc, j_si)
    assert j_sc > 0 and j_si > 0
    if r_cap == 4:
        assert j_nh > r_cap  # the overflow case the driver re-dispatches
    else:
        assert 0 < j_nh < r_cap and (j_hot == -1).any()


def test_need_layout_words_are_little_endian():
    """The int32 row packs bytes b0..b3 as b0 | b1<<8 | b2<<16 | b3<<24,
    byte bits big-endian (np.packbits): bit 0 of the need matrix is the
    top bit of the first byte."""
    match_u = torch.ones((1, 8), dtype=torch.bool)
    spec_map = torch.zeros((2,), dtype=torch.int32)
    viol = torch.zeros((2, 8), dtype=torch.bool)
    viol[0, 0] = True
    viol[1, 7] = True
    compiled = torch.ones((2,), dtype=torch.bool)
    row_fb = torch.zeros((8,), dtype=torch.bool)
    row = ops.need_tail(match_u, spec_map, viol, compiled, row_fb, 8, 8)
    p8, w4, width = ops.need_layout(2, 8)
    assert (p8, w4, width) == (2, 1, 1 + 8 + 3)
    word = int(row[0]) & 0xFFFFFFFF
    assert word.to_bytes(4, "little")[:2] == bytes([0b10000000, 0b01000000])
    assert row[1:3].tolist() == [0, 7] and row[3:9].tolist() == [-1] * 6
    assert row[9:].tolist() == [2, 16, 0]
