"""K5's launch plan and staging layout (csrc/delta.cu), on the CPU.

The kernel runs only on the card; what surrounds it is host numpy and is
tested here:

  * `ops.delta_plan` covers every delta byte exactly once, keeps source
    and destination congruent modulo 16 and keeps every segment within
    one block's DELTA_SEG bytes (offset from alignment included); the
    recorded audit_churn flush spreads over every SM with all its headers
    in the kernel parameters (the probe's flush of its table count and
    bytes);
  * a numpy emulation of K5's moves (one block per segment, DELTA_VEC
    aligned 16-byte vectors a thread, head and tail vectors byte by byte,
    headers past DELTA_PARAM_SEGS read from the staging) over the staging
    that `ops.pack_deltas` writes reproduces `ops.flush_deltas_plain` byte
    for byte on seeded tables of all three types, at fills of every
    residue modulo 16, in a staging reused across growing and shrinking
    flushes without being cleared (blocks rounded up to a power of two, as
    torch's caching host allocator hands them out).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from gatekeeper_tpu_torch.kernels import ops


def _check_plan(dsts, sizes, plan):
    """The plan invariants; -> {delta index: sorted (offset, bytes)}."""
    table, starts = plan["table"], plan["starts"].tolist()
    seg = ops.DELTA_SEG
    assert plan["header"] == table.shape[0] * ops.SEG_DTYPE.itemsize
    assert plan["total"] % 16 == 0
    spans = {}
    di = 0
    for dst, src, n in zip(table["dst"].tolist(), table["src"].tolist(),
                           table["n"].tolist()):
        # the table runs delta after delta, in the callers' order
        while not (dsts[di] <= dst < dsts[di] + sizes[di]):
            di += 1
        assert 0 < n and (dst & 15) + n <= seg
        assert (src - dst) % 16 == 0
        assert src == starts[di] + dst - dsts[di]
        # the aligned vectors holding its ends lie in its delta's slot
        lo = src - (dst & 15)
        hi = -(-(src + n) // 16) * 16
        assert starts[di] - (dsts[di] & 15) <= lo and hi <= plan["total"]
        assert hi <= -(-(starts[di] + sizes[di]) // 16) * 16
        spans.setdefault(di, []).append((dst - dsts[di], n))
    for i, n in enumerate(sizes):
        got = sorted(spans.get(i, []))
        if n == 0:
            assert not got
            continue
        assert got[0][0] == 0 and got[-1][0] + got[-1][1] == n
        assert all(a[0] + a[1] == b[0] for a, b in zip(got, got[1:]))
    slots = sorted(
        (s - (d & 15), s + n) for s, d, n in zip(starts, dsts, sizes) if n)
    assert not slots or slots[0][0] >= plan["header"]
    assert all(a[1] <= b[0] for a, b in zip(slots, slots[1:]))
    return spans


@pytest.mark.parametrize("seed", range(6))
def test_delta_plan_covers_each_byte_once(seed):
    r = np.random.default_rng(seed)
    n = int(r.integers(1, 40))
    sizes = [int(x) for x in r.choice(
        [0, 1, 15, 16, 17, 512, 2048, 4095, 4096, 4097, 8192, 22528, 100_000],
        n)]
    dsts, pos = [], 0x7F00_0000_0000 + int(r.integers(0, 4096))
    for sz in sizes:
        pos += int(r.integers(0, 600)) * 16 + int(r.integers(0, 16))
        dsts.append(pos)
        pos += sz
    plan = ops.delta_plan(dsts, sizes)
    _check_plan(dsts, sizes, plan)
    assert ops.DELTA_SEG == ops.DELTA_THREADS * ops.DELTA_VEC * 16


def test_delta_plan_empty_and_zero_rows():
    plan = ops.delta_plan([], [])
    assert plan["table"].shape == (0,) and plan["total"] == 0
    plan = ops.delta_plan([4096 + 3, 9000], [0, 0])
    assert plan["table"].shape == (0,) and plan["total"] == 0


def test_recorded_flush_spreads_over_every_sm():
    """The probe's flush (chip_smoke.DELTA_PROBE_TABLES: the recorded
    audit_churn flush's 66 tables and 651,264 bytes) at fills drawn as the
    probe draws them, each table in its own 512-byte-aligned allocation:
    at least one segment per SM of an H100, every header in the kernel
    parameters."""
    r = np.random.default_rng(5)
    dsts, sizes, pos = [], [], 1 << 40
    for dt, width, count in chip_smoke.DELTA_PROBE_TABLES:
        row = np.dtype(dt).itemsize * max(width, 1)
        for _ in range(count):
            fill = int(r.integers(100_000, 131_072 - 512))
            dsts.append(pos + fill * row)
            sizes.append(512 * row)
            pos += -(-131_072 * row // 512) * 512
    assert len(sizes) == 66 and sum(sizes) == 651_264
    plan = ops.delta_plan(dsts, sizes)
    _check_plan(dsts, sizes, plan)
    assert 132 <= plan["table"].shape[0] <= ops.DELTA_PARAM_SEGS


def _emulate_k5(staging, total, n_segs, mem):
    """K5's moves in numpy: `mem(address, nbytes)` -> a writable uint8 view
    of the destination. Headers past DELTA_PARAM_SEGS come from the
    staging's head, as the kernel reads them."""
    heads = staging[:n_segs * 16].view(ops.SEG_DTYPE)
    for b in range(n_segs):
        s = heads[b]
        dst, src, n = int(s["dst"]), int(s["src"]), int(s["n"])
        lead = dst & 15
        end = lead + n
        nv = (end + 15) // 16
        assert nv <= ops.DELTA_THREADS * ops.DELTA_VEC
        lo = src - lead
        assert lo >= 0 and lo % 16 == 0 and lo + 16 * nv <= total
        vecs = staging[lo:lo + 16 * nv]  # every thread's loads first
        mem(dst, n)[:] = vecs[lead:end]  # then the segment's own bytes


def _tables(r, residues=range(16)):
    """Seeded buffers of the three types and deltas, with bool fills at
    every residue modulo 16 (one of them a zero-row delta) and some deltas
    cast on the host."""
    bufs, fills, deltas = [], [], []
    for k in residues:
        bufs.append(torch.from_numpy(r.random(9000) < 0.5))
        fills.append(16 * int(r.integers(0, 40)) + k)
        rows = 0 if k == 9 else 512 * int(r.integers(1, 4))
        deltas.append(r.random(rows) < 0.5)
    for dt, width, rows in ((np.int32, 7, 1536), (np.float32, 3, 512),
                            (np.int32, 1, 1024), (np.bool_, 44, 512),
                            (np.float32, 50, 4096)):
        shape = (rows * 2 + 777,) + ((width,) if width > 1 else ())
        bufs.append(torch.from_numpy(r.integers(-9, 9, shape).astype(dt)))
        fills.append(int(r.integers(0, rows)))
        src = r.integers(-50, 50, (rows,) + shape[1:])
        deltas.append(src.astype(np.float64 if width % 2 else dt))
    return bufs, fills, deltas


def _plan(bufs, fills, deltas):
    ds = [ops._host_delta(d, b, f) for b, f, d in zip(bufs, fills, deltas)]
    plan = ops.delta_plan(
        [b.data_ptr() + f * b.stride(0) * b.element_size()
         for b, f in zip(bufs, fills)], [d.nbytes for d in ds])
    return plan, ds


def _block(nbytes):
    """A staging block's size: a power of two, as torch's caching host
    allocator rounds a request."""
    return 1 << max(int(nbytes) - 1, 0).bit_length()


def _flush_emulated(staging, bufs, fills, deltas):
    """Pack into `staging` and move as K5 does; -> the plan."""
    plan, ds = _plan(bufs, fills, deltas)
    assert plan["total"] <= staging.shape[0]
    ops.pack_deltas(staging, plan, ds)
    views = [(b.data_ptr(), b.numpy().reshape(-1).view(np.uint8)) for b in bufs]

    def mem(addr, n):
        for base, v in views:
            if base <= addr and addr + n <= base + v.shape[0]:
                return v[addr - base:addr - base + n]
        raise AssertionError(f"write outside every buffer at {addr:#x}")

    _emulate_k5(staging, plan["total"], plan["table"].shape[0], mem)
    return plan


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_emulated_k5_equals_plain(seed):
    r = np.random.default_rng(seed)
    bufs, fills, deltas = _tables(r)
    want = ops.flush_deltas_plain([b.clone() for b in bufs], fills, deltas)
    got = [b.clone() for b in bufs]
    total = _plan(got, fills, deltas)[0]["total"]
    staging = np.full((_block(total),), 0xA5, np.uint8)
    plan = _flush_emulated(staging, got, fills, deltas)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    # the fills reach every residue of the destination modulo 16 (but
    # the zero-row delta's, which has no segment)
    assert {int(d) & 15 for d in plan["table"]["dst"]} >= set(range(16)) - {
        (bufs[9].data_ptr() + fills[9]) & 15}


@pytest.mark.parametrize("seed", [11, 12])
def test_emulated_k5_across_arena_growth(seed):
    """Flushes of growing and then shrinking size through one staging that
    grows by whole blocks and is never cleared (the stale bytes of a larger
    flush stay behind a smaller one), one of them past DELTA_PARAM_SEGS
    segments: each equals the plain version."""
    r = np.random.default_rng(seed)
    staging = np.zeros((0,), np.uint8)
    caps = []
    for n_tabs, rows in ((1, 512), (4, 1024), (4, 60_000), (2, 512)):
        bufs, fills, deltas = [], [], []
        for _ in range(n_tabs):
            bufs.append(torch.from_numpy(
                r.integers(-9, 9, (rows * 2 + 100, 5)).astype(np.int32)))
            fills.append(int(r.integers(0, rows)))
            deltas.append(r.integers(-99, 99, (rows, 5)).astype(np.int32))
        want = ops.flush_deltas_plain([b.clone() for b in bufs], fills, deltas)
        got = [b.clone() for b in bufs]
        total = _plan(got, fills, deltas)[0]["total"]
        if total > staging.shape[0]:
            grown = np.full((_block(total),), 0x5A, np.uint8)
            grown[:staging.shape[0]] = staging
            staging = grown
        caps.append(staging.shape[0])
        plan = _flush_emulated(staging, got, fills, deltas)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        if rows == 60_000:
            assert plan["table"].shape[0] > ops.DELTA_PARAM_SEGS
    assert caps == [1 << 14, 1 << 17, 1 << 23, 1 << 23]


def test_host_delta_casts_only_where_the_type_differs():
    buf = torch.zeros((64, 3), dtype=torch.int32)
    same = np.ones((8, 3), np.int32)
    assert ops._host_delta(same, buf, 0) is same
    cast = ops._host_delta(np.full((8, 3), 2.7), buf, 0)
    assert cast.dtype == np.int32 and (cast == 2).all()
    t = ops._host_delta(torch.ones((8, 3), dtype=torch.int64), buf, 56)
    assert t.dtype == np.int32 and t.flags.c_contiguous
