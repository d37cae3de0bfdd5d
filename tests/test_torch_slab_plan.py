"""Launch plans of K2 (slab gather) and K3 (EGroup), and their plain
versions at the edge widths the plans treat apart, on the CPU.

  * `ops.slab_plan`: the tiles a persistent grid walks cover every token
    once; inside a tile, the kernel's division-free (token, word) stepping
    (csrc/slab.cu, step 2) visits every word of every row once, at the
    shared-memory byte the output span expects; word widths divide the row
    and the table addresses; shared memory and residency stay within the
    H100's limits;
  * `ops.egroup_plan`: the warp-uniform row walk of csrc/group.cu covers
    every row once and every 16-token chunk of a row once; vector loads
    only for aligned rows with L % 16 == 0; shared memory within limits;
  * both plans at the widths the in-repo policies produce (recorded from a
    small audit and review batch through TorchDriver on the CPU);
  * `slab_gather_plain` against JAX's `two_level` and `egroup_plain`
    against the JAX `EGroup._emit` at those edge widths, exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from gatekeeper_tpu.engine import exprs as jx
from gatekeeper_tpu_torch.constraint.torchdriver import TorchDriver
from gatekeeper_tpu_torch.engine import exprs as tx
from gatekeeper_tpu_torch.kernels import ops

from test_torch_kernels import NEG_INF, _ctx, _table, _two_level_jax

SMS = 132  # H100 SXM
EDGE_T = (1, 3, 16, 17, 44, 45)
EDGE_L = (1, 17, 128, 130)


# -- K2 plan ------------------------------------------------------------------


def _slab_words(plan, row_bytes: int, n_here: int):
    """The (token, word, stage byte) triples csrc/slab.cu's step 2 visits
    for a tile of n_here tokens, thread by thread, stepping as it does."""
    word = plan["word"]
    w = row_bytes // word
    b = ops.SLAB_THREADS
    dtok, dword = b // w, b % w
    seen = []
    for tid in range(b):
        tok, wd = tid // w, tid % w
        for k in range(tid, n_here * w, b):
            seen.append((tok, wd, k * word))
            tok += dtok
            wd += dword
            if wd >= w:
                wd -= w
                tok += 1
    return seen


def _check_slab_plan(n_tok: int, row_bytes: int, addrs=(0,)):
    plan = ops.slab_plan(n_tok, row_bytes, addrs, SMS)
    word, tile, grid = plan["word"], plan["tile"], plan["grid"]
    assert word in (1, 2, 4, 8, 16)
    assert all(x % word == 0 for x in (row_bytes, *addrs))
    # the widest such word: twice it would not divide
    if word < 16:
        assert any(x % (2 * word) for x in (row_bytes, *addrs))
    assert tile % 16 == 0 and 16 <= tile <= 256
    assert tile == 16 or tile * row_bytes <= ops.SLAB_TILE_BYTES
    assert plan["smem"] >= -(-tile * row_bytes // 16) * 16 + 8 * tile
    assert plan["smem"] <= ops.SMEM_BLOCK_MAX
    resident = -(-grid // SMS)
    assert resident * ops.SLAB_THREADS <= ops.THREADS_PER_SM
    assert resident * (plan["smem"] + 1024) <= ops.SMEM_PER_SM
    # the persistent grid's tiles partition the tokens
    n_tiles = -(-n_tok // tile)
    assert 1 <= grid <= n_tiles
    walked = np.zeros(n_tiles, np.int64)
    for blk in range(grid):
        walked[blk::grid] += 1
    assert (walked == 1).all()
    sizes = [min(tile, n_tok - t * tile) for t in range(n_tiles)]
    assert sum(sizes) == n_tok and min(sizes) > 0
    # a full tile and the last one: each word of each row once, at the
    # stage byte its output byte has in the span
    for n_here in sorted({sizes[0], sizes[-1]}):
        seen = _slab_words(plan, row_bytes, n_here)
        w = row_bytes // word
        assert sorted((tok, wd) for tok, wd, _ in seen) == [
            (tok, wd) for tok in range(n_here) for wd in range(w)
        ]
        assert all(at == tok * row_bytes + wd * word for tok, wd, at in seen)
    return plan


@pytest.mark.parametrize("elem", [1, 4])
@pytest.mark.parametrize("t", EDGE_T)
@pytest.mark.parametrize("n_tok", [1, 37 * 29, 32768 * 128])
def test_slab_plan_covers_every_word_once(t, elem, n_tok):
    _check_slab_plan(n_tok, t * elem)


def test_slab_plan_words_follow_alignment():
    # T = 44 bool: 44-byte rows take 4-byte words; int32 rows 16-byte ones
    assert _check_slab_plan(4096, 44)["word"] == 4
    assert _check_slab_plan(4096, 176)["word"] == 16
    # a table view one row in: its address decides
    assert _check_slab_plan(4096, 176, (256, 256 + 44))["word"] == 4
    assert _check_slab_plan(4096, 16, (256, 257))["word"] == 1


def test_slab_plan_limits():
    for row_bytes in (1, 48, 768, 769, 4096, 14_000):
        plan = _check_slab_plan(100_000, row_bytes)
        # the largest power of two of tokens whose rows fit, in [16, 256]
        fit = ops.SLAB_TILE_BYTES // row_bytes
        want = 1 << max(fit.bit_length() - 1, 0)
        assert plan["tile"] == max(16, min(256, want))
    with pytest.raises(ValueError, match="shared memory"):
        ops.slab_plan(1000, 15_000, (0,), SMS)


# -- K3 plan ------------------------------------------------------------------


def _check_egroup_plan(n: int, l: int, g: int, how: str, aligned=True):
    plan = ops.egroup_plan(n, l, g, how, aligned, SMS)
    lanes, warps, grid = plan["lanes"], plan["warps"], plan["grid"]
    rpw = 32 // lanes  # rows per warp
    assert plan["vec"] == (aligned and l % 16 == 0)
    assert lanes in (1, 2, 4, 8, 16, 32)
    assert 1 <= warps <= 8
    planes = 0 if how == "any" and g <= 64 else (2 if how == "max" else 1)
    assert plan["smem"] == warps * rpw * planes * g * 4
    assert plan["smem"] <= ops.SMEM_BLOCK_MAX
    if plan["smem"] > ops.SMEM_DEFAULT:
        # only a single row per block may need to opt in past 48 KB
        assert warps == 1 and lanes == 32
    resident = -(-grid // SMS)
    assert resident * warps * 32 <= ops.THREADS_PER_SM
    assert resident * warps * 32 * ops.EGROUP_REGS <= ops.REGS_PER_SM
    assert resident * (plan["smem"] + 1024) <= ops.SMEM_PER_SM
    # the warp-uniform walk: warp gw takes rows gw*rpw + grp + k*step
    total_warps = grid * warps
    step = total_warps * rpw
    walked = np.zeros(n, np.int64)
    for gw in range(total_warps):
        for base in range(gw * rpw, n, step):
            rows = np.arange(base, min(base + rpw, n))
            walked[rows] += 1
    assert (walked == 1).all()
    # the lanes of a row cover its 16-token chunks once, two a step:
    # chunks ch and ch + lanes for ch = sub, sub + 2 * lanes, ...
    n_chunks = -(-l // 16)
    chunks = sorted(
        c for sub in range(lanes) for ch in range(sub, n_chunks, 2 * lanes)
        for c in (ch, ch + lanes) if c < n_chunks
    )
    assert chunks == list(range(n_chunks))
    assert lanes == 32 or 2 * lanes >= n_chunks
    return plan


@pytest.mark.parametrize("how", ["any", "sum", "max"])
@pytest.mark.parametrize("l", EDGE_L)
@pytest.mark.parametrize("g", [g for g, *_ in chip_smoke.EGROUP_EDGE_G])
def test_egroup_plan_covers_every_row_once(g, l, how):
    _check_egroup_plan(257, l, g, how)
    _check_egroup_plan(4099, l, g, how, aligned=False)


def test_egroup_plan_main_shape_and_limits():
    # the main path's [32768, 128] -> 64 slots: 8 rows a warp, one wave
    plan = _check_egroup_plan(32768, 128, 64, "any")
    assert plan["vec"] and plan["lanes"] == 4 and plan["smem"] == 0
    assert plan["grid"] * plan["warps"] * 8 >= 32768
    # large G: fewer warps, then more lanes per row, then opt-in memory
    assert _check_egroup_plan(500, 128, 1024, "max")["warps"] == 1
    big = _check_egroup_plan(500, 128, 10_000, "max")
    assert big["smem"] > ops.SMEM_DEFAULT
    with pytest.raises(ValueError, match="shared memory"):
        ops.egroup_plan(10, 128, 40_000, "max", True, SMS)


# -- both plans at the in-repo policies' widths ----------------------------------


@pytest.fixture(scope="module")
def in_repo_calls():
    """(slab inputs, egroup inputs) of a small audit and a review batch
    through TorchDriver on the CPU over deploy/policies."""
    rec = chip_smoke.Recorder(ops)
    rec.install()
    try:
        client = chip_smoke.build_client(TorchDriver("cpu"), 40, 16)
        client.audit()
        client.review_many(chip_smoke.review_batch(3, 12))
    finally:
        rec.remove()
    return rec.calls["slab_gather"], rec.calls["egroup"]


def test_plans_at_in_repo_widths(in_repo_calls):
    slabs, groups = in_repo_calls
    assert slabs and groups
    assert any(key[2] for key in slabs)  # a review batch's overlay
    for (args, kw) in slabs.values():
        tab, ids = args[0], args[1]
        row_bytes = tab.shape[1] * tab.element_size()
        for n_tok in (ids.numel(), 32768 * ids.shape[1]):
            _check_slab_plan(n_tok, row_bytes, (0, 256))
    for (args, kw) in groups.values():
        idx0, idx1, mask, val, axis, g0, g1, how = args[:8]
        g = {"g0": g0, "g1": g1, "g01": g0 * g1}[axis]
        n, l = mask.shape
        for rows in (n, 32768):
            _check_egroup_plan(rows, l, g, how)


# -- plain versions against JAX at the edge widths ---------------------------------


@pytest.mark.parametrize("overlay", [False, True])
@pytest.mark.parametrize("dtype", [np.bool_, np.int32, np.float32])
@pytest.mark.parametrize("t", EDGE_T)
def test_slab_gather_plain_equals_two_level_at_edges(t, dtype, overlay):
    r = np.random.default_rng(100 + t)
    v, b, v_base = 60, 9, 50
    tab = _table(r, (v, t), dtype)
    ov = _table(r, (b, t), dtype) if overlay else None
    # 37 x 29 tokens: not a multiple of any tile
    ids = r.integers(-3, v_base + b + 6, size=(37, 29)).astype(np.int32)
    edge = [-7, -1, 0, v - 1, v_base - 1, v_base, v_base + b - 1, v_base + b,
            v_base + b + 9]
    ids.reshape(-1)[: len(edge)] = edge
    want = np.asarray(_two_level_jax(tab, ov, ids, v_base))
    got = ops.slab_gather_plain(
        torch.from_numpy(tab), torch.clamp(torch.from_numpy(ids), min=0),
        None if ov is None else torch.from_numpy(ov), v_base,
    ).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


def _egroup_case(g_case, l, dtype, how, seed):
    g, axis, g0, g1 = g_case
    r = np.random.default_rng(seed)
    n = 9
    idx0 = r.integers(-1, g0 + 2, size=(n, l)).astype(np.int32)
    idx1 = r.integers(-1, g1 + 2, size=(n, l)).astype(np.int32)
    mask = r.random((n, l)) < 0.6
    mask[3] = False  # a row whose mask is all false
    idx0[5], idx1[5], mask[5] = 0, 0, True  # every token in slot 0
    if dtype == np.bool_:
        val = r.random((n, l)) < 0.5
    else:
        val = r.integers(-3, 900, size=(n, l)).astype(dtype)
    init = NEG_INF if (how == "max" and dtype == np.float32) else -1
    cols = {"idx0": idx0, "idx1": idx1, "m": mask, "v": val, "spath": idx0}
    jnode = jx.EGroup(jx.ETokCol("m"), jx.ETokCol("v"), axis, how, init)
    want = np.asarray(jnode.emit(
        _ctx(jx, {k: jnp.asarray(v) for k, v in cols.items()}, g0, g1, np=jnp)))
    got = ops.egroup_plain(
        *(torch.from_numpy(cols[k]) for k in ("idx0", "idx1", "m", "v")),
        axis, g0, g1, how, init,
    ).numpy()
    assert want.shape == (n, g)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert np.array_equal(got, want)
    # the node through the port's EGroup (the kernel's caller) agrees too
    tnode = tx.EGroup(tx.ETokCol("m"), tx.ETokCol("v"), axis, how, init)
    node = tnode.emit(
        _ctx(tx, {k: torch.from_numpy(v) for k, v in cols.items()}, g0, g1)
    ).numpy()
    assert np.array_equal(node, want)


@pytest.mark.parametrize("dtype", [np.bool_, np.int32, np.float32])
@pytest.mark.parametrize("how", ["any", "sum", "max"])
@pytest.mark.parametrize("g_case", chip_smoke.EGROUP_EDGE_G,
                         ids=[f"G{g[0]}" for g in chip_smoke.EGROUP_EDGE_G])
def test_egroup_plain_equals_jax_node_at_edge_g(g_case, how, dtype):
    i = chip_smoke.EGROUP_EDGE_G.index(g_case)
    _egroup_case(g_case, EDGE_L[i % len(EDGE_L)], dtype, how, 40 + i)


@pytest.mark.parametrize("dtype", [np.bool_, np.int32, np.float32])
@pytest.mark.parametrize("how", ["any", "sum", "max"])
@pytest.mark.parametrize("l", EDGE_L)
def test_egroup_plain_equals_jax_node_at_edge_l(l, how, dtype):
    _egroup_case(chip_smoke.EGROUP_EDGE_G[4], l, dtype, how, 70 + l)
