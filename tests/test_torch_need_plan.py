"""Launch plans of K4 (need tail) and K1 (match matrix), the arithmetic
their kernels do, and their plain versions at the edges the new designs
introduce, on the CPU.

  * `ops.need_plan`: pass 1's (review tile, constraint slice) grid covers
    every (c, n) once, tails included; pass 3's (row group, slot chunk)
    blocks and their 32-slot warp tasks cover every (c, hot slot) once;
    shared memory within limits; the grids fill the card at the main
    shapes; the plan raises past its limits;
  * a numpy emulation of csrc/need.cu's three passes (4-byte SWAR words
    of 0/1 bytes, the multiply that gathers byte bits, the lane-pair row
    words, the bit-walk compaction, ballot words ORed into one or two
    packed words through __brev and __byte_perm) equals
    `need_tail_plain` at the N, n_valid and R edges;
  * `ops.match_plan`: every review once, every spec per block, shared
    memory, opt-in and the largest spec count; `ops.match_flags`: the
    kernel's flag formulation (dead selectors answered by a constant,
    review arrays no spec reads left at their defaults) equals
    `match_matrix_plain`; the spec half is cached per staged spec set and
    rebuilt when a spec tensor is edited in place or replaced;
  * JAX parity: `need_tail_plain` through the port's FusedKernel against
    `_need_chunk_fn`'s tail at the N, n_valid and R edges, and
    `match_matrix_plain` against the JAX `match_matrix` on spec sets whose
    padded expression rows (key -1) meet padded label slots (-1, -1).
"""

import numpy as np
import pytest
import torch

from gatekeeper_tpu.engine.matchkernel import match_matrix as jax_match

import chip_smoke
from gatekeeper_tpu_torch import interop
from gatekeeper_tpu_torch.kernels import ops

from test_torch_kernels import _jax_need, _need_inputs, _torch_need
from test_torch_matchkernel import _raw_battery

SMS = 132  # H100 SXM
EDGE_N = (1, 15, 17, 31, 33)


# -- K4 plan ------------------------------------------------------------------


def _check_need_plan(c, n, r, addrs=(0,)):
    plan = ops.need_plan(c, n, r, addrs, SMS)
    cs, (g1x, g1y) = plan["cs"], plan["g1"]
    assert 1 <= cs <= ops.NEED_MAX_CS and 1 <= g1y <= ops.GRID_Y_MAX
    assert plan["vec"] == (n % 16 == 0 and all(a % 16 == 0 for a in addrs))
    # pass 1: review tiles x threads cover each review once ...
    seen = np.zeros(n, np.int64)
    for bx in range(g1x):
        n0 = bx * ops.NEED_TILE + ops.NEED_RPT * np.arange(ops.NEED_THREADS)
        for k in range(ops.NEED_RPT):
            idx = n0 + k
            np.add.at(seen, idx[idx < n], 1)
    assert (seen == 1).all()
    # ... and the slices each constraint once, so every (c, n) once
    seen_c = np.zeros(c, np.int64)
    for by in range(g1y):
        seen_c[by * cs: min(c, by * cs + cs)] += 1
    assert (seen_c == 1).all()
    # the row-any words a thread ORs into exist
    assert plan["words"] == -(-n // 32)
    # pass 3: row groups x slot chunks x 32-slot tasks: every (c, j) once
    jc, cr, (g3x, g3y) = plan["jc"], plan["cr"], plan["g3"]
    assert jc % 32 == 0 and jc <= ops.NEED_PACK_JC and cr <= ops.NEED_MAX_CR
    assert g3y <= ops.GRID_Y_MAX
    assert plan["smem3"] >= 4 * jc + 5 * cr
    assert plan["smem3"] <= ops.SMEM_DEFAULT
    rows = np.zeros(c, np.int64)
    for bx in range(g3x):
        rows[bx * cr: min(c, bx * cr + cr)] += 1
    assert (rows == 1).all()
    slots = np.zeros(r, np.int64)
    for by in range(g3y):
        j_lo, j_hi = by * jc, min(r, by * jc + jc)
        nt = -(-(j_hi - j_lo) // 32)
        for task in range(nt):  # one row's tasks
            j = j_lo + task * 32 + np.arange(32)
            np.add.at(slots, j[j < j_hi], 1)
    assert (slots == 1).all()
    return plan


@pytest.mark.parametrize("n", EDGE_N + (4099, 32768))
def test_need_plan_covers_every_pair_once(n):
    for c in (1, 37, 503, 2999):
        for r in sorted({1, min(33, n), n}):
            _check_need_plan(c, n, r)
    _check_need_plan(61, n, n, addrs=(0, 3))


def test_need_plan_main_shape_and_limits():
    # the sweep's chunks and a review batch: both grids fill the card
    for c, n, r in ((500, 32768, 1024), (500, 256, 256)):
        plan = _check_need_plan(c, n, r, (0, 512))
        assert plan["vec"]
        assert plan["g1"][0] * plan["g1"][1] >= SMS
        assert plan["g3"][0] * plan["g3"][1] >= SMS
    main = ops.need_plan(500, 32768, 1024, (0,), SMS)
    assert main["cs"] == 16 and main["g1"] == (8, 32)
    assert main["jc"] == 1024 and main["g3"] == (500, 1)
    for c, n, r in ((0, 100, 10), (5, 100, 0), (5, 100, 101)):
        with pytest.raises(ValueError):
            ops.need_plan(c, n, r, (0,), SMS)
    with pytest.raises(ValueError, match="exceed a chunk"):
        ops.need_plan(5, 2**31 - 100, 10, (0,), SMS)
    with pytest.raises(ValueError, match="grid"):
        ops.need_plan(5, 2**30, 2**30, (0,), SMS)
    with pytest.raises(ValueError, match="int32"):
        ops.need_plan(10**6, 10**5, 10**5, (0,), SMS)


# -- K4 kernels, emulated -----------------------------------------------------

ONES = np.uint32(0x01010101)


def _words16(row: np.ndarray, n0: np.ndarray, n: int) -> np.ndarray:
    """load16: [T, 4] words of 16 bytes at each n0 (bytes past n read 0)."""
    idx = n0[:, None] + np.arange(16)[None, :]
    b = np.where(idx < n, row[np.minimum(idx, n - 1)], 0).astype(np.uint32)
    b = b.reshape(-1, 4, 4)
    return (b << (8 * np.arange(4, dtype=np.uint32))).sum(-1, dtype=np.uint32)


def _popc(x: np.ndarray) -> np.ndarray:
    return np.unpackbits(x.astype("<u4").view(np.uint8)).reshape(
        x.shape + (32,)).sum(-1)


def _brev(x: int) -> int:
    return int(f"{x:032b}"[::-1], 2)


def _packed(linear: int) -> int:
    b = _brev(linear)
    return int.from_bytes(b.to_bytes(4, "little")[::-1], "little")


def _emulate_need(match_u, spec_map, viol, compiled, row_fb, n_valid, r_cap):
    """csrc/need.cu step by step on numpy uint8 / int arrays."""
    c_pad, n = viol.shape
    plan = ops.need_plan(c_pad, n, r_cap, (0,), SMS)
    nv = max(0, min(n_valid, n))
    rowwords = np.zeros(plan["words"], np.uint32)
    sc = si = 0
    cs = plan["cs"]
    for bx in range(plan["g1"][0]):
        n0 = bx * ops.NEED_TILE + ops.NEED_RPT * np.arange(ops.NEED_THREADS)
        fb = _words16(row_fb, n0, n)
        cnt = np.clip(nv - n0, 0, 16)
        b = np.clip(cnt[:, None] - 4 * np.arange(4)[None, :], 0, 4)
        vm = np.where(b == 4, ONES, ONES & ((np.uint64(1) << (8 * b).astype(
            np.uint64)) - 1).astype(np.uint32)).astype(np.uint32)
        for by in range(plan["g1"][1]):
            anyw = np.zeros((ops.NEED_THREADS, 4), np.uint32)
            for c in range(by * cs, min(c_pad, by * cs + cs)):
                m = _words16(match_u[spec_map[c]], n0, n)
                v = _words16(viol[c], n0, n)
                mv = m & vm
                fsel = fb if compiled[c] else np.full_like(fb, ONES)
                anyw |= mv & (v | fsel)
                si += int(_popc(mv & fsel).sum())
                sc += int(_popc(mv & ~fsel).sum())
            g = ((anyw * np.uint32(0x01020408)) >> np.uint32(24)) & np.uint32(0xF)
            bits = (g << (4 * np.arange(4, dtype=np.uint32))).sum(1, dtype=np.uint32)
            word = bits << (16 * (np.arange(ops.NEED_THREADS) & 1)).astype(np.uint32)
            word = word | word.reshape(-1, 2)[:, ::-1].reshape(-1)  # shfl_xor 1
            for t in range(0, ops.NEED_THREADS, 2):
                if word[t]:
                    rowwords[n0[t] >> 5] |= word[t]
    # pass 2: ascending ids by walking the set bits
    hot = []
    for i, x in enumerate(rowwords.tolist()):
        hot += [i * 32 + k for k in range(32) if x >> k & 1]
    n_hot = len(hot)
    hot = (hot + [-1] * r_cap)[:r_cap]
    # pass 3: per (row, 32-slot task) a ballot ORed into one or two words
    _, w4, width = ops.need_layout(c_pad, r_cap)
    words = [0] * w4
    for c in range(c_pad):
        for j0 in range(0, r_cap, 32):
            ballot = 0
            for k in range(32):
                j = j0 + k
                h = hot[j] if j < r_cap else -1
                if 0 <= h < nv and match_u[spec_map[c], h] and (
                        viol[c, h] or not compiled[c] or row_fb[h]):
                    ballot |= 1 << k
            if ballot:
                i0 = c * r_cap + j0
                s = i0 & 31
                words[i0 >> 5] |= _packed((ballot << s) & 0xFFFFFFFF)
                if s and ballot >> (32 - s):
                    words[(i0 >> 5) + 1] |= _packed(ballot >> (32 - s))
    words = np.asarray(words, np.uint32).view(np.int32)
    return np.concatenate([words, np.asarray(hot, np.int32),
                           np.asarray([n_hot, sc, si], np.int32)])


def _need_arrays(seed, c, n, viol=0.3, match=0.8, fb=0.05, interp=0.1):
    r = np.random.default_rng(seed)
    u = 5
    return (r.random((u, n)) < match, r.integers(0, u, c).astype(np.int32),
            r.random((c, n)) < viol, r.random(c) >= interp, r.random(n) < fb)


@pytest.mark.parametrize("n", EDGE_N + (70,))
def test_need_emulation_equals_plain_at_edges(n):
    for c in (3, 37):
        arrays = _need_arrays(n * 7 + c, c, n)
        for n_valid in sorted({0, 1, n - 1, n}):
            for r_cap in sorted({1, n}):
                want = ops.need_tail_plain(
                    *(torch.from_numpy(a) for a in arrays), n_valid, r_cap
                ).numpy()
                got = _emulate_need(*arrays, n_valid, r_cap)
                assert np.array_equal(got, want), (c, n_valid, r_cap)


@pytest.mark.parametrize("kw", [{}, {"interp": 1.0}, {"fb": 1.0},
                                {"viol": 0.001, "match": 0.7}])
def test_need_emulation_equals_plain_shares(kw):
    arrays = _need_arrays(5, 61, 4099, **kw)
    for r_cap in (33, 1024):
        want = ops.need_tail_plain(
            *(torch.from_numpy(a) for a in arrays), 4000, r_cap).numpy()
        assert np.array_equal(_emulate_need(*arrays, 4000, r_cap), want)


# -- K4 against JAX at the edges ------------------------------------------------


@pytest.mark.parametrize("r_edge", ["one", "all"])
@pytest.mark.parametrize("v_edge", ["zero", "one", "short", "all"])
@pytest.mark.parametrize("n", EDGE_N)
def test_need_tail_plain_equals_jax_at_edges(n, v_edge, r_edge):
    ms, fb, viol, interp, row_fb, _ = _need_inputs(40 + n, n=n, c_viol=0.3)
    n_valid = {"zero": 0, "one": 1, "short": n - 1, "all": n}[v_edge]
    r_cap = 1 if r_edge == "one" else n
    args = (ms, fb, viol, interp, row_fb, n_valid)
    j_packed, j_hot, j_nh, j_sc, j_si = _jax_need(*args, r_cap)
    t_packed, t_hot, t_nh, t_sc, t_si = _torch_need(*args, r_cap)
    assert np.array_equal(t_packed, j_packed)
    assert np.array_equal(t_hot, j_hot)
    assert (t_nh, t_sc, t_si) == (j_nh, j_sc, j_si)


# -- K1 plan and flags ----------------------------------------------------------


def _per_spec(ms) -> int:
    return sum(np.asarray(ms[k])[0].size for k in ops._MS_STAGED) + 1


def _check_match_plan(n, u, per, ml, reads):
    plan = ops.match_plan(n, u, u * per, ml, ml, reads, SMS)
    staged = reads & (ops.R_OBJ | ops.R_NSLAB)
    rpt, sg, threads = plan["rpt"], plan["sg"], plan["threads"]
    assert rpt == (1 if staged else 4)
    assert threads in (32, 64, 128) and plan["smem"] <= ops.SMEM_BLOCK_MAX
    assert sg in (1, 2, 4, 8) and threads % sg == 0 and (sg == 1 or u >= 8 * sg)
    tr = threads // sg
    assert plan["tile"] == tr * rpt
    # every review once: slot s of block b takes reviews (b*tr + s)*rpt + k
    seen = np.zeros(n, np.int64)
    for b in range(plan["grid"]):
        n0 = (b * tr + np.arange(tr)) * rpt
        for k in range(rpt):
            idx = n0 + k
            np.add.at(seen, idx[idx < n], 1)
    assert (seen == 1).all()
    # every spec once per block: group g runs g, g + sg, ...
    specs = sorted(x for g in range(sg) for x in range(g, u, sg))
    assert specs == list(range(u))
    lab = tr * rpt * (
        (2 * (2 * ml + 1) if reads & ops.R_OBJ else 0)
        + ((2 * ml + 1) if reads & ops.R_NSLAB else 0))
    assert plan["smem"] == 4 * (u * per + lab)
    return plan


def test_match_plan_covers_reviews_and_limits():
    ms, _ = chip_smoke._kinds_only_specs(np.random.default_rng(0), 3, 10, 8)
    per = _per_spec(ms)
    for n in (1, 3, 4, 5, 511, 512, 4099):
        for u in (1, 3, 16, 64, 200):
            _check_match_plan(n, u, per, 8, 0)
            _check_match_plan(n, u, 43, 16, 15)
    # the recorded kinds-only shape: 4 reviews a thread, fills the card
    main = _check_match_plan(100_000, 3, per, 8, 0)
    assert main["rpt"] == 4 and main["sg"] == 1 and main["grid"] >= SMS
    assert main["smem"] <= ops.SMEM_DEFAULT
    heavy = _check_match_plan(100_000, 64, 43, 16, 15)
    assert heavy["rpt"] == 1 and heavy["sg"] == 8 and heavy["grid"] >= SMS
    # past 48 KB the kernel opts in; the largest U fits, one more raises
    all_reads = ops.R_OBJ | ops.R_NSLAB | ops.R_NS | ops.R_NSSEL
    for ml in (4, 16):
        u_max = chip_smoke.match_max_u(43, ml, ml, all_reads)
        plan = _check_match_plan(2053, u_max, 43, ml, all_reads)
        assert plan["threads"] == 32 and plan["smem"] > ops.SMEM_DEFAULT
        with pytest.raises(ValueError, match="shared memory"):
            ops.match_plan(2053, u_max + 1, (u_max + 1) * 43, ml, ml,
                           all_reads, SMS)


def _flag_form(ms, fb):
    """The kernel's formulation with ops.match_flags: dead selectors
    answered by their constant, review arrays outside `reads` at the
    kernel's defaults (False / -1)."""
    host = {k: v.numpy() for k, v in ms.items()}
    flags, reads = ops.match_flags(host)
    f = torch.from_numpy(flags)[:, None]
    fb = dict(fb)
    if not reads & ops.R_NS:
        for k in ("kind_defined", "is_ns", "has_namespace"):
            fb[k] = torch.zeros_like(fb[k])
        fb["ns_name_id"] = torch.full_like(fb["ns_name_id"], -1)
    if not reads & ops.R_OBJ:
        for k in ("obj_present", "old_present"):
            fb[k] = torch.zeros_like(fb[k])
    if not reads & ops.R_NSSEL:
        for k in ("nssel_defined", "nssel_empty"):
            fb[k] = torch.zeros_like(fb[k])

    def on(bit):
        return (f & bit) != 0

    rows = ms["kind_rows"]
    g, k = rows[:, None, :, 0], rows[:, None, :, 1]
    rg, rk = fb["group_id"][None, :, None], fb["kind_id"][None, :, None]
    kind_ok = torch.any((((g != -1) & (g > -3)) | (g == -2))
                        & ((g == -2) | ((rg >= 0) & (g == rg)))
                        & ((k == -2) | ((rk >= 0) & (k == rk))), -1)
    has_ns, is_ns = fb["has_namespace"][None, :], fb["is_ns"][None, :]
    always = fb["kind_defined"][None, :] & ~is_ns & ~has_ns
    ns = fb["ns_name_id"]
    dfn = (ns >= 0)[None, :]
    in_ns = ops._isin(ns[None, :], ms["ns_ids"][:, None, :])
    in_ex = ops._isin(ns[None, :], ms["excl_ids"][:, None, :])
    ns_ok = ~on(ops.F_NS_HAS) | always | (dfn & in_ns)
    ex_ok = ~on(ops.F_EXCL_HAS) | always | (dfn & ~in_ex)
    scope_ok = torch.where(has_ns, on(ops.F_SCOPE_NS), on(ops.F_SCOPE_CL))
    nsel = (ms["nssel_invalid"], ms["nssel_ml"], ms["nssel_expr"],
            ms["nssel_expr_vals"])
    live, const = on(ops.F_NSSEL_LIVE), on(ops.F_NSSEL_CONST)
    self_ev = torch.where(live, ops._labelselector_4case_plain(*nsel, fb), const)
    plain = torch.where(live, ops._selector_match_plain(
        *nsel, fb["nssel_labels"]), const)
    other = fb["nssel_defined"][None, :] & (
        plain | (fb["nssel_empty"][None, :] & on(ops.F_NSSEL_EMPTY)))
    nssel_ok = ~on(ops.F_NSSEL_HAS) | always | torch.where(is_ns, self_ev, other)
    lab = torch.where(on(ops.F_LAB_LIVE), ops._labelselector_4case_plain(
        ms["lab_invalid"], ms["lab_ml"], ms["lab_expr"], ms["lab_expr_vals"],
        fb), on(ops.F_LAB_CONST))
    return kind_ok & ns_ok & ex_ok & scope_ok & nssel_ok & lab, flags, reads


def _torch_specs(ms, fb):
    return interop.matchspec(ms, "cpu"), interop.features(fb, "cpu")


@pytest.mark.parametrize("seed", range(6))
def test_match_flags_formulation_equals_plain(seed):
    r = np.random.default_rng(seed)
    cases = [_raw_battery(seed, u=48, n=96),
             chip_smoke._kinds_only_specs(r, 3, 97, 8),
             chip_smoke._kinds_only_specs(r, 5, 33, 4, scopes=True),
             chip_smoke._match_battery(seed, 24, 64, 16, False)]
    for ms_np, fb_np in cases:
        ms, fb = _torch_specs(ms_np, fb_np)
        got, flags, reads = _flag_form(ms, fb)
        assert torch.equal(got, ops.match_matrix_plain(ms, fb))
    # the batteries mix dead and live selectors
    assert (flags & ops.F_LAB_LIVE).any() and not (flags & ops.F_LAB_LIVE).all()
    assert reads & ops.R_OBJ


def test_match_flags_kinds_only_reads_nothing_else():
    ms, _ = chip_smoke._kinds_only_specs(np.random.default_rng(1), 3, 10, 8)
    flags, reads = ops.match_flags(ms)
    assert reads == 0
    assert (flags == ops.F_SCOPE_NS | ops.F_SCOPE_CL | ops.F_NSSEL_CONST
            | ops.F_LAB_CONST).all()


def test_match_spec_cache_follows_the_staged_tensors():
    ms, _ = _torch_specs(*_raw_battery(3, u=12, n=8))
    ops._MATCH_SPECS.clear()
    first = ops._match_spec(ms)
    assert ops._match_spec(ms) is first
    assert ops._match_spec(dict(ms)) is first  # same tensors, new dict
    # an in-place edit moves the tensor's version: a new entry, new flags
    row = int(np.flatnonzero(first.flags.numpy() & ops.F_LAB_LIVE)[0])
    ms["lab_invalid"][row] = True
    edited = ops._match_spec(ms)
    assert edited is not first
    assert not edited.flags[row] & (ops.F_LAB_LIVE | ops.F_LAB_CONST)
    # a replaced tensor (same values) builds a new entry too
    ms["scope"] = ms["scope"].clone()
    assert ops._match_spec(ms) is not edited
    assert ops._match_spec(ms).spec_words == 12 * _per_spec(ms)
    for i in range(ops._MATCH_SPECS_MAX + 3):
        ops._match_spec({**ms, "scope": ms["scope"].clone()})
    assert len(ops._MATCH_SPECS) == ops._MATCH_SPECS_MAX
    ops._MATCH_SPECS.clear()


# -- K1 against JAX on padded rows ----------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_match_plain_equals_jax_on_padded_rows(seed):
    """Padded expression rows (key -1, op -1) and padded matchLabels pairs
    against padded label slots (-1, -1): dead selectors, as the bucketed
    compiler emits them, next to live ones, invalid ones and
    ALWAYS_VIOLATED ones."""
    r = np.random.default_rng(seed)
    ms, fb = _raw_battery(100 + seed, u=32, n=80)
    for pre in ("lab", "nssel"):
        dead = r.random(32) < 0.5
        ms[pre + "_expr"][dead] = -1
        ms[pre + "_ml"][dead] = -1
        ms[pre + "_expr_vals"][dead] = -1
        # a padded key under a label-reading op stays live
        ms[pre + "_expr"][~dead & (r.random(32) < 0.3), 0, 0] = -1
    ms["nssel_has"][:16] = True
    for k in ("obj_labels", "old_labels", "nssel_labels"):
        fb[k][r.random(fb[k].shape[:2]) < 0.3] = -1
    want = np.asarray(jax_match(ms, fb))
    got = ops.match_matrix_plain(*_torch_specs(ms, fb)).numpy()
    assert np.array_equal(got, want)
    flags, _ = ops.match_flags(ms)
    assert (flags & ops.F_LAB_LIVE).any() and (~flags & ops.F_LAB_LIVE).any()
    form, _, _ = _flag_form(*_torch_specs(ms, fb))
    assert np.array_equal(form.numpy(), want)
