"""The seven hand-written CUDA kernels of the fused violation path and the
full-output audit step, each beside its plain torch version.

Every wrapper takes the plain version for tensors that lie on the CPU (the
tests here run that way) and launches its CUDA kernel for tensors on a CUDA
device; any other device, dtype, shape or layout it does not take raises.
There is no fallback from a CUDA tensor to the plain version. `LAUNCHES`
counts kernel launches per wrapper (a launch of the plain version does not
count), so a run can show that its main path went through the kernels.

    K1 match_matrix  <- gatekeeper_tpu/engine/matchkernel.py:106
    K2 slab_gather   <- gatekeeper_tpu/parallel/sharding.py:771 (two_level)
    K3 egroup        <- gatekeeper_tpu/engine/exprs.py:510 (EGroup._emit)
    K4 need_tail     <- gatekeeper_tpu/parallel/sharding.py:852-872, 677-708
    K5 flush_deltas  <- gatekeeper_tpu/parallel/sharding.py:389-424
    K6 gather_elem   <- gatekeeper_tpu/engine/exprs.py:564-597 (EGatherElem)
    K7 full_totals   <- gatekeeper_tpu/parallel/sharding.py:1066-1086
                        (the totals tail of FusedAuditKernel.prepare)
"""

from __future__ import annotations

import ctypes
import functools
import operator
import struct
import threading
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..engine.matchspec import (
    OP_ALWAYS_VIOLATED,
    OP_EXISTS,
    OP_IN,
    OP_NOT_EXISTS,
    OP_NOT_IN,
    SCOPE_ABSENT,
    SCOPE_CLUSTER,
    SCOPE_NAMESPACED,
    SCOPE_STAR,
    WILDCARD,
)

LAUNCHES: Dict[str, int] = {
    "match_matrix": 0,
    "slab_gather": 0,
    "egroup": 0,
    "need_tail": 0,
    "flush_deltas": 0,
    "gather_elem": 0,
    "full_totals": 0,
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_cuda(*ts: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU ones; raises on a mix or on
    any other device."""
    kinds = {t.device.type for t in ts}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"tensors on unsupported/mixed devices: {sorted(kinds)}")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {rc})")


def _need(t: torch.Tensor, dtype: torch.dtype, ndim: int, name: str):
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(
            f"{name}: want {dtype} with {ndim} dims, got {t.dtype} "
            f"{tuple(t.shape)}"
        )
    return t.contiguous()


# ---------------------------------------------------------------------------
# K1 match_matrix


_MS_I32 = (
    "kind_rows", "ns_ids", "excl_ids", "scope", "lab_ml", "lab_expr",
    "lab_expr_vals", "nssel_ml", "nssel_expr", "nssel_expr_vals",
)
_MS_BOOL = (
    "ns_has", "excl_has", "lab_invalid", "nssel_has",
    "nssel_matches_empty", "nssel_invalid",
)


def _isin(needle, haystack):
    """needle [...] in haystack [..., M] (-1 pads never match)."""
    return torch.any((haystack != -1) & (haystack == needle[..., None]), -1)


def _selector_match_plain(invalid, ml, expr, expr_vals, labels):
    """LabelSelector vs label pairs: invalid [U], ml [U,P,2],
    expr [U,E,3], expr_vals [U,E,V], labels [N,ML,2] -> [U,N] bool."""
    lab_k = labels[None, :, :, 0]  # [1, N, ML]
    lab_v = labels[None, :, :, 1]
    ml_k = ml[:, None, :, 0]  # [U, 1, P]
    ml_v = ml[:, None, :, 1]
    pair_valid = ml_k != -1
    hit = (lab_k[:, :, None, :] == ml_k[..., None]) & (
        lab_v[:, :, None, :] == ml_v[..., None]
    )  # [U, N, P, ML]
    pair_ok = torch.any(hit, -1)
    ml_ok = torch.all(~pair_valid | pair_ok, -1)  # [U, N]
    e_key = expr[:, None, :, 0]  # [U, 1, E]
    e_op = expr[:, None, :, 1]
    e_nv = expr[:, None, :, 2]
    key_hit = lab_k[:, :, None, :] == e_key[..., None]  # [U, N, E, ML]
    has_key = torch.any(key_hit, -1)
    label_val = torch.amax(
        torch.where(key_hit, lab_v[:, :, None, :], -1), -1
    )  # [U, N, E]
    in_vals = _isin(label_val, expr_vals[:, None, :, :])
    violated = torch.zeros_like(has_key)
    violated = torch.where(
        e_op == OP_IN, ~has_key | ((e_nv > 0) & ~in_vals), violated
    )
    violated = torch.where(
        e_op == OP_NOT_IN, has_key & (e_nv > 0) & in_vals, violated
    )
    violated = torch.where(e_op == OP_EXISTS, ~has_key, violated)
    violated = torch.where(e_op == OP_NOT_EXISTS, has_key, violated)
    violated = torch.where(
        e_op == OP_ALWAYS_VIOLATED, torch.ones_like(violated), violated
    )
    any_violated = torch.any(violated, -1)
    return ml_ok & ~any_violated & ~invalid[:, None]


def _labelselector_4case_plain(invalid, ml, expr, expr_vals, fb):
    m_obj = _selector_match_plain(invalid, ml, expr, expr_vals, fb["obj_labels"])
    m_old = _selector_match_plain(invalid, ml, expr, expr_vals, fb["old_labels"])
    obj_p = fb["obj_present"][None, :]
    old_p = fb["old_present"][None, :]
    return torch.where(
        obj_p & old_p, m_obj | m_old, torch.where(old_p & ~obj_p, m_old, m_obj)
    )


def match_matrix_plain(ms: Dict[str, torch.Tensor], fb: Dict[str, torch.Tensor]):
    """[U, N] bool: matching_constraints for every (spec row, review); the
    torch form of gatekeeper_tpu/engine/matchkernel.py:106."""
    rows = ms["kind_rows"]  # [U, K, 2]
    g = rows[:, None, :, 0]
    k = rows[:, None, :, 1]
    rg = fb["group_id"][None, :, None]
    rk = fb["kind_id"][None, :, None]
    row_valid = ((g != -1) & (g > -3)) | (g == WILDCARD)
    g_ok = (g == WILDCARD) | ((rg >= 0) & (g == rg))
    k_ok = (k == WILDCARD) | ((rk >= 0) & (k == rk))
    kind_ok = torch.any(row_valid & g_ok & k_ok, -1)
    always = (
        fb["kind_defined"] & ~fb["is_ns"] & ~fb["has_namespace"]
    )[None, :]
    ns_name = fb["ns_name_id"]
    ns_defined = (ns_name >= 0)[None, :]
    in_ns = _isin(ns_name[None, :], ms["ns_ids"][:, None, :])
    ns_ok = ~ms["ns_has"][:, None] | always | (ns_defined & in_ns)
    in_excl = _isin(ns_name[None, :], ms["excl_ids"][:, None, :])
    excl_ok = ~ms["excl_has"][:, None] | always | (ns_defined & ~in_excl)
    sc = ms["scope"][:, None]
    has_ns = fb["has_namespace"][None, :]
    scope_ok = (
        (sc == SCOPE_ABSENT)
        | (sc == SCOPE_STAR)
        | ((sc == SCOPE_NAMESPACED) & has_ns)
        | ((sc == SCOPE_CLUSTER) & ~has_ns)
    )
    nssel = (
        ms["nssel_invalid"], ms["nssel_ml"], ms["nssel_expr"],
        ms["nssel_expr_vals"],
    )
    nssel_plain = _selector_match_plain(*nssel, fb["nssel_labels"])
    nssel_self = _labelselector_4case_plain(*nssel, fb)
    nssel_with_empty = nssel_plain | (
        fb["nssel_empty"][None, :] & ms["nssel_matches_empty"][:, None]
    )
    nssel_eval = torch.where(
        fb["is_ns"][None, :],
        nssel_self,
        fb["nssel_defined"][None, :] & nssel_with_empty,
    )
    nssel_ok = ~ms["nssel_has"][:, None] | always | nssel_eval
    label_ok = _labelselector_4case_plain(
        ms["lab_invalid"], ms["lab_ml"], ms["lab_expr"], ms["lab_expr_vals"], fb
    )
    return kind_ok & ns_ok & excl_ok & scope_ok & nssel_ok & label_ok


class _MatchSpecArgs(ctypes.Structure):
    # mirrors struct MatchSpec in csrc/match.cu field for field
    _fields_ = [
        *((k, ctypes.c_void_p) for k in (
            "kind_rows", "ns_ids", "excl_ids", "lab_ml", "lab_expr",
            "lab_vals", "nssel_ml", "nssel_expr", "nssel_vals", "flags")),
        *((k, ctypes.c_int) for k in (
            "U", "K", "M", "M2", "P", "E", "V", "P2", "E2", "V2", "reads")),
    ]


# review arrays in the order of struct MatchReview, with their dtype, their
# number of dims and the alignment their vector loads need
_FB_ORDER = (
    ("group_id", torch.int32, 1, 16), ("kind_id", torch.int32, 1, 16),
    ("ns_name_id", torch.int32, 1, 16), ("kind_defined", torch.bool, 1, 4),
    ("is_ns", torch.bool, 1, 4), ("has_namespace", torch.bool, 1, 4),
    ("obj_present", torch.bool, 1, 4), ("old_present", torch.bool, 1, 4),
    ("obj_labels", torch.int32, 3, 16), ("old_labels", torch.int32, 3, 16),
    ("nssel_defined", torch.bool, 1, 4), ("nssel_labels", torch.int32, 3, 16),
    ("nssel_empty", torch.bool, 1, 4),
)


class _MatchReview(ctypes.Structure):
    # mirrors struct MatchReview in csrc/match.cu field for field
    _fields_ = [
        *((k, ctypes.c_void_p) for k, *_ in _FB_ORDER), ("out", ctypes.c_void_p),
        *((k, ctypes.c_int) for k in (
            "ML", "ML2", "N", "rpt", "sg", "threads", "grid", "smem", "vec")),
    ]


# per-spec flags and review-array read bits (csrc/match.cu)
F_NS_HAS, F_EXCL_HAS, F_SCOPE_NS, F_SCOPE_CL = 1, 2, 4, 8
F_NSSEL_HAS, F_NSSEL_EMPTY, F_NSSEL_LIVE, F_NSSEL_CONST = 16, 32, 64, 128
F_LAB_LIVE, F_LAB_CONST = 256, 512
R_NS, R_NSSEL, R_OBJ, R_NSLAB = 1, 2, 4, 8
_LABEL_OPS = (OP_IN, OP_NOT_IN, OP_EXISTS, OP_NOT_EXISTS)
# spec arrays in the kernel's staging order (flags follow them)
_MS_STAGED = (
    "kind_rows", "ns_ids", "excl_ids", "lab_ml", "lab_expr", "lab_expr_vals",
    "nssel_ml", "nssel_expr", "nssel_expr_vals",
)
MATCH_THREADS = 128  # K1's block, at most (csrc/match.cu)


def _selector_liveness(invalid, ml, expr):
    """(live [U], const [U]) of one LabelSelector per spec row: live when
    valid, without an ALWAYS_VIOLATED expression, and with a matchLabels
    pair or a label-reading expression; a selector that is not live has
    the answer `const` for every review (valid and never violated)."""
    always_v = (expr[:, :, 1] == OP_ALWAYS_VIOLATED).any(1)
    reads = (ml[:, :, 0] != -1).any(1) | np.isin(expr[:, :, 1], _LABEL_OPS).any(1)
    const = ~invalid & ~always_v
    return const & reads, const


def match_flags(ms: Dict[str, np.ndarray]):
    """-> (flags [U] int32, reads int): K1's per-spec flags and the review
    arrays some spec reads, from host copies of the spec arrays."""
    sc = ms["scope"]
    scope_ns = np.isin(sc, (SCOPE_ABSENT, SCOPE_STAR, SCOPE_NAMESPACED))
    scope_cl = np.isin(sc, (SCOPE_ABSENT, SCOPE_STAR, SCOPE_CLUSTER))
    lab_live, lab_const = _selector_liveness(
        ms["lab_invalid"], ms["lab_ml"], ms["lab_expr"])
    ns_live, ns_const = _selector_liveness(
        ms["nssel_invalid"], ms["nssel_ml"], ms["nssel_expr"])
    nssel = ms["nssel_has"].astype(bool)
    ns_live &= nssel
    bits = (
        (ms["ns_has"], F_NS_HAS), (ms["excl_has"], F_EXCL_HAS),
        (scope_ns, F_SCOPE_NS), (scope_cl, F_SCOPE_CL),
        (nssel, F_NSSEL_HAS), (ms["nssel_matches_empty"], F_NSSEL_EMPTY),
        (ns_live, F_NSSEL_LIVE), (ns_const, F_NSSEL_CONST),
        (lab_live, F_LAB_LIVE), (lab_const, F_LAB_CONST),
    )
    flags = np.zeros(sc.shape, np.int32)
    for on, bit in bits:
        flags |= np.where(np.asarray(on, bool), bit, 0).astype(np.int32)
    reads = 0
    if (ms["ns_has"].any() or ms["excl_has"].any() or nssel.any()
            or (scope_ns != scope_cl).any()):
        reads |= R_NS
    if nssel.any():
        reads |= R_NSSEL
    if lab_live.any() or ns_live.any():
        reads |= R_OBJ
    if ns_live.any():
        reads |= R_NSLAB
    return flags, reads


def match_plan(n: int, u: int, spec_words: int, ml: int, ml2: int,
               reads: int, sms: int):
    """K1's launch plan for n reviews against u staged specs of
    `spec_words` int32 words in all (flags included): -> dict(rpt, sg,
    threads, tile, grid, smem). sg: groups of a block's threads that split
    the specs (the largest power of two up to u / 8, at most 8), so a
    thread runs at least 8 specs; the other threads / sg take a review slot
    each. Without staged labels a slot is 4 reviews; with them (R_OBJ /
    R_NSLAB), one, and the block shrinks from 128 to 64 or 32 threads
    while the slots' label rows (stride 2 * ML + 1 words) and the spec set
    exceed a block's shared memory. Past 48 KB the kernel opts in; past
    SMEM_BLOCK_MAX the plan raises."""
    staged = (2 * (2 * ml + 1) if reads & R_OBJ else 0) + (
        (2 * ml2 + 1) if reads & R_NSLAB else 0)
    rpt = 1 if staged else 4
    sg = 1
    while sg < 8 and 2 * sg * 8 <= u:
        sg *= 2
    threads = MATCH_THREADS

    def smem():
        return 4 * (spec_words + threads // sg * rpt * staged)

    while smem() > SMEM_BLOCK_MAX and threads > 32:
        threads //= 2
    if smem() > SMEM_BLOCK_MAX:
        raise ValueError(
            f"match_matrix: {spec_words} spec words and label rows of "
            f"{ml}/{ml2} exceed a block's shared memory ({smem()} > "
            f"{SMEM_BLOCK_MAX})")
    tile = threads // sg * rpt
    grid = max(1, -(-n // tile))
    if grid > 2**31 - 1:
        raise ValueError(f"match_matrix: {n} reviews exceed the grid")
    return {"rpt": rpt, "sg": sg, "threads": threads, "tile": tile,
            "grid": grid, "smem": smem()}


class _MatchSpec:
    """The spec half of one K1 launch, built once per staged spec set:
    the checked contiguous spec tensors, the flags tensor, the filled
    MatchSpec struct and the plans by review shape."""

    def __init__(self, ms: Dict[str, torch.Tensor]):
        m = {k: _need(ms[k], torch.int32, ms[k].dim(), k) for k in _MS_I32}
        m.update({k: _need(ms[k], torch.bool, 1, k) for k in _MS_BOOL})
        _on_cuda(*m.values())  # one device for every spec tensor
        host = {k: v.cpu().numpy() for k, v in m.items()}
        flags, self.reads = match_flags(host)
        dev = m["kind_rows"].device
        self.index = dev.index
        self.tensors = m  # held: `args` points into them
        self.flags = torch.from_numpy(flags).to(dev)
        u = m["kind_rows"].shape[0]
        self.u = u
        self.device = dev
        self.spec_words = u + sum(m[k][0].numel() for k in _MS_STAGED) * u
        self.plans: Dict[tuple, dict] = {}
        self.args = _MatchSpecArgs(
            kind_rows=_ptr(m["kind_rows"]), ns_ids=_ptr(m["ns_ids"]),
            excl_ids=_ptr(m["excl_ids"]), lab_ml=_ptr(m["lab_ml"]),
            lab_expr=_ptr(m["lab_expr"]), lab_vals=_ptr(m["lab_expr_vals"]),
            nssel_ml=_ptr(m["nssel_ml"]), nssel_expr=_ptr(m["nssel_expr"]),
            nssel_vals=_ptr(m["nssel_expr_vals"]), flags=_ptr(self.flags),
            reads=self.reads, U=u, K=m["kind_rows"].shape[1],
            M=m["ns_ids"].shape[1], M2=m["excl_ids"].shape[1],
            P=m["lab_ml"].shape[1], E=m["lab_expr"].shape[1],
            V=m["lab_expr_vals"].shape[2], P2=m["nssel_ml"].shape[1],
            E2=m["nssel_expr"].shape[1], V2=m["nssel_expr_vals"].shape[2],
        )

    def plan(self, n: int, ml: int, ml2: int, sms: int) -> dict:
        key = (n, ml, ml2, sms)
        got = self.plans.get(key)
        if got is None:
            got = self.plans[key] = match_plan(
                n, self.u, self.spec_words, ml, ml2, self.reads, sms)
        return got


_MATCH_SPECS: "Dict[tuple, tuple]" = {}
_MATCH_SPECS_MAX = 8
_match_lock = threading.Lock()
_MS_GET = operator.itemgetter(*(_MS_I32 + _MS_BOOL))
_VERSION = operator.attrgetter("_version")


def _match_spec(ms: Dict[str, torch.Tensor]) -> _MatchSpec:
    """The cached spec half for this spec set, keyed by the identity of
    each spec tensor. An entry holds its tensors (so no other tensor takes
    their ids while it lives) and their version counters: a tensor edited
    in place (its version moves) or replaced by another (its id differs)
    builds a new entry."""
    src = _MS_GET(ms)
    key = tuple(map(id, src))
    versions = tuple(map(_VERSION, src))
    with _match_lock:
        hit = _MATCH_SPECS.get(key)
    if hit is not None and hit[1] == versions:
        return hit[2]
    spec = _MatchSpec(ms)
    with _match_lock:
        _MATCH_SPECS.pop(key, None)
        if len(_MATCH_SPECS) >= _MATCH_SPECS_MAX:
            _MATCH_SPECS.pop(next(iter(_MATCH_SPECS)))
        _MATCH_SPECS[key] = (src, versions, spec)
    return spec


def match_matrix(ms: Dict[str, torch.Tensor], fb: Dict[str, torch.Tensor]):
    """K1 wrapper: [U, N] bool match matrix. The spec half of the launch
    is built once per staged spec set (_match_spec); a call checks and
    passes only the review half."""
    if not _on_cuda(ms["kind_rows"], fb["group_id"]):
        return match_matrix_plain(ms, fb)
    spec = _match_spec(ms)
    ts, ptrs, vec = [], [], True
    for k, dtype, ndim, align in _FB_ORDER:
        t = fb[k]
        if not t.is_cuda:
            raise ValueError(f"match_matrix: {k} is not on the card")
        if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
            t = _need(t, dtype, ndim, k)
        p = t.data_ptr()
        vec = vec and p % align == 0  # int4 / 4-byte feature loads
        ts.append(t)
        ptrs.append(p)
    if ts[0].get_device() != spec.index:
        raise ValueError("match_matrix: specs and features on different devices")
    n = ts[0].shape[0]
    out = torch.empty((spec.u, n), dtype=torch.bool, device=spec.device)
    if spec.u == 0 or n == 0:
        return out
    ml, ml2 = ts[8].shape[1], ts[11].shape[1]
    if ts[9].shape[1] != ml:
        raise ValueError("obj_labels and old_labels differ in width")
    plan = spec.plan(n, ml, ml2, _sm_count(spec.index))
    review = _MatchReview(
        *ptrs, out.data_ptr(), ml, ml2, n, plan["rpt"], plan["sg"],
        plan["threads"], plan["grid"], plan["smem"], int(vec),
    )
    from .build import library

    lib = library("match")
    _check(lib.gk_match_matrix(ctypes.byref(spec.args), ctypes.byref(review),
                               _stream()), "match_matrix")
    LAUNCHES["match_matrix"] += 1
    return out


# ---------------------------------------------------------------------------
# K2 slab_gather


def slab_gather_plain(tab, ids, ov=None, v_base: int = 0):
    """[N, L, T] rows of `tab` [V, T] at `ids` [N, L] (clamped); ids at or
    above `v_base` read the overlay block `ov` [B, T] instead."""
    base = tab[torch.clamp(ids, 0, tab.shape[0] - 1).long()]
    if ov is None:
        return base
    loc = ids - v_base
    o = ov[torch.clamp(loc, 0, ov.shape[0] - 1).long()]
    return torch.where((loc >= 0)[..., None], o, base)


_ELEM_BYTES = {torch.bool: 1, torch.int32: 4, torch.float32: 4}

# H100 limits the launch plans keep to: shared memory a block may opt in
# to, shared memory per SM, the default a block gets without opting in,
# and resident threads per SM
SMEM_BLOCK_MAX = 232_448
SMEM_PER_SM = 233_472
SMEM_DEFAULT = 48 * 1024
THREADS_PER_SM = 2048
REGS_PER_SM = 65_536
EGROUP_REGS = 40  # K3's register cap: __launch_bounds__(256, 6) in csrc/group.cu
SLAB_THREADS = 256  # K2's block (csrc/slab.cu)
SLAB_TILE_BYTES = 12 * 1024  # staged output per K2 tile, at most


def _sms(device: torch.device) -> int:
    """The card's SM count."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    return _sm_count(idx)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def slab_plan(n_tok: int, row_bytes: int, addrs: Sequence[int], sms: int):
    """K2's launch plan for n_tok tokens of rows of `row_bytes` bytes whose
    tables start at `addrs`: -> dict(word, tile, smem, grid).
    word: the widest copy (16/8/4/2/1 bytes) that divides the row width
    and every table address; tile: tokens per tile, a power of two from 16
    to 256 whose staged rows fit SLAB_TILE_BYTES (16 tokens at least, so a
    tile's output span stays 16-byte aligned); smem: the staged tile
    (padded to 16) and one row pointer per token; grid: the tiles, at most
    as many blocks as the card holds at once (each block walks tiles
    blockIdx, blockIdx + grid, ...)."""
    word = 16
    while word > 1 and any(x % word for x in (row_bytes, *addrs)):
        word //= 2
    tile = 256
    while tile > 16 and tile * row_bytes > SLAB_TILE_BYTES:
        tile //= 2
    smem = -(-tile * row_bytes // 16) * 16 + tile * 8
    if smem > SMEM_BLOCK_MAX:
        raise ValueError(f"slab_gather: rows of {row_bytes} bytes exceed "
                         f"a block's shared memory ({smem} > {SMEM_BLOCK_MAX})")
    resident = min(THREADS_PER_SM // SLAB_THREADS, SMEM_PER_SM // (smem + 1024))
    grid = max(1, min(-(-n_tok // tile), sms * resident))
    return {"word": word, "tile": tile, "smem": smem, "grid": grid}


def slab_gather(tab, ids, ov=None, v_base: int = 0):
    """K2 wrapper: see slab_gather_plain."""
    ts = (tab, ids) if ov is None else (tab, ids, ov)
    if not _on_cuda(*ts):
        return slab_gather_plain(tab, ids, ov, v_base)
    eb = _ELEM_BYTES.get(tab.dtype)
    if eb is None or tab.dim() != 2:
        raise ValueError(f"slab_gather: table {tab.dtype} {tuple(tab.shape)}")
    tab = tab.contiguous()
    ids = _need(ids, torch.int32, 2, "ids")
    if ov is not None:
        if ov.dtype != tab.dtype or ov.dim() != 2 or ov.shape[1] != tab.shape[1]:
            raise ValueError("slab_gather: overlay does not match the table")
        ov = ov.contiguous()
        if ov.shape[0] == 0:
            raise ValueError("slab_gather: empty overlay")
    v, t = tab.shape
    out = torch.empty(
        tuple(ids.shape) + (t,), dtype=tab.dtype, device=tab.device
    )
    if out.numel() == 0:
        return out
    if v == 0:
        raise ValueError("slab_gather: empty table")
    addrs = [tab.data_ptr()] + ([] if ov is None else [ov.data_ptr()])
    plan = slab_plan(ids.numel(), t * eb, addrs, _sms(tab.device))
    from .build import library

    lib = library("slab")
    rc = lib.gk_slab_gather(
        _ptr(tab), v, _ptr(ov), 0 if ov is None else ov.shape[0],
        _ptr(ids), int(v_base), _ptr(out), ids.numel(), t * eb,
        plan["word"], plan["tile"], plan["grid"], plan["smem"], _stream(),
    )
    _check(rc, "slab_gather")
    LAUNCHES["slab_gather"] += 1
    return out


# ---------------------------------------------------------------------------
# K3 egroup


_HOW = {"any": 0, "sum": 1, "max": 2}
_MODE = {"g0": 0, "g1": 1, "g01": 2}


def _egroup_types(val, how: str, init):
    """Result dtype of JAX's one-hot formulation: where(onehot, val,
    init).max / where(onehot, val, 0).sum / (onehot & val != 0).any."""
    if how == "any":
        return torch.bool
    fill = init if how == "max" else 0
    rt = torch.result_type(val, fill)
    return {torch.int64: torch.int32, torch.float64: torch.float32}.get(rt, rt)


def _egroup_index(idx0, idx1, axis: str, g0: int, g1: int):
    if axis == "g01":
        idx = torch.where((idx0 >= 0) & (idx1 >= 0), idx0 * g1 + idx1, -1)
        return idx, g0 * g1
    if axis == "g0":
        return idx0, g0
    return idx1, g1


def egroup_plain(idx0, idx1, mask, val, axis: str, g0: int, g1: int,
                 how: str, init: Any):
    """[N, G]: per-token `val` [N, L] regrouped onto array slots by
    idx0/idx1 where `mask` holds; collisions resolve by `how`, empty
    slots take `init` (max) or 0/False. Same values and types as the
    JAX node's [N, L, G] one-hot contraction."""
    idx, g = _egroup_index(idx0, idx1, axis, g0, g1)
    live = mask & (idx >= 0) & (idx < g)
    slots = torch.arange(g, device=idx.device)
    onehot = live[:, :, None] & (idx[:, :, None] == slots[None, None, :])
    out_t = _egroup_types(val, how, init)
    if how == "any":
        return torch.any(onehot & (val[:, :, None] != 0), 1)
    if how == "sum":
        v = val.to(out_t)
        return torch.sum(
            torch.where(onehot, v[:, :, None], torch.zeros((), dtype=out_t)),
            1, dtype=out_t,
        )
    v = val.to(out_t)
    fill = torch.full((), init, dtype=out_t)
    contrib = torch.where(onehot, v[:, :, None], fill)
    if out_t == torch.bool:
        return torch.any(contrib, 1)
    return torch.amax(contrib, 1)


def egroup_plan(n: int, l: int, g: int, how: str, aligned: bool, sms: int):
    """K3's launch plan for n rows of l tokens onto g slots: -> dict(vec,
    lanes, warps, smem, grid). vec: 16-byte loads (every row
    16-byte aligned: `aligned` start addresses and l % 16 == 0), else
    scalar loads; lanes: lanes per row, the power of two that covers the
    row's 16-token chunks two to a lane, up to 32; warps per block: 8,
    fewer (then more lanes per row) while the rows' shared-memory slots
    (how="any" with g <= 64 keeps none) exceed the default 48 KB; grid: the
    blocks the rows need, at most as many as the card holds at once (each
    warp walks its rows by the whole grid's stride)."""
    chunks = -(-l // 16)
    lanes = 1
    while lanes < min(-(-chunks // 2), 32):
        lanes *= 2
    planes = 0 if how == "any" and g <= 64 else (2 if how == "max" else 1)
    warps = 8

    def smem():
        return warps * (32 // lanes) * planes * g * 4

    while smem() > SMEM_DEFAULT and (warps > 1 or lanes < 32):
        if warps > 1:
            warps //= 2
        else:
            lanes *= 2
    if smem() > SMEM_BLOCK_MAX:
        raise ValueError(f"egroup: {g} slots exceed a block's shared memory")
    rows_per_block = warps * 32 // lanes
    resident = min(REGS_PER_SM // (EGROUP_REGS * 32 * warps), 32,
                   SMEM_PER_SM // (smem() + 1024))
    grid = max(1, min(-(-n // rows_per_block), sms * resident))
    return {"vec": aligned and l % 16 == 0, "lanes": lanes, "warps": warps,
            "smem": smem(), "grid": grid}


def egroup(idx0, idx1, mask, val, axis: str, g0: int, g1: int, how: str,
           init: Any = -1):
    """K3 wrapper: see egroup_plain."""
    if not _on_cuda(idx0, idx1, mask, val):
        return egroup_plain(idx0, idx1, mask, val, axis, g0, g1, how, init)
    idx0 = _need(idx0, torch.int32, 2, "idx0")
    idx1 = _need(idx1, torch.int32, 2, "idx1")
    mask = _need(mask, torch.bool, 2, "mask")
    if val.dim() != 2 or val.shape != mask.shape or idx0.shape != mask.shape:
        raise ValueError(
            f"egroup: mask {tuple(mask.shape)} / val {tuple(val.shape)} / "
            f"idx {tuple(idx0.shape)}"
        )
    out_t = _egroup_types(val, how, init)
    # the kernel reads bool, int32 or float32 values and accumulates in
    # int32 or float32; a bool max comes back through int32
    acc_t = torch.int32 if out_t == torch.bool else out_t
    if how != "any" and val.dtype not in (acc_t, torch.bool):
        val = val.to(acc_t)
    if val.dtype not in _ELEM_BYTES:
        raise ValueError(f"egroup: value dtype {val.dtype}")
    val = val.contiguous()
    val_kind = {torch.bool: 0, torch.int32: 1, torch.float32: 2}[val.dtype]
    n, l = mask.shape
    g = {"g0": g0, "g1": g1, "g01": g0 * g1}[axis]
    out = torch.empty(
        (n, g), dtype=torch.bool if how == "any" else acc_t, device=mask.device
    )
    if out.numel() == 0:
        return out
    acc_f32 = 1 if acc_t == torch.float32 else 0
    init_v = init if how == "max" else 0
    read = [mask, val] + [t for t, used in (
        (idx0, axis != "g1"), (idx1, axis != "g0")) if used]
    plan = egroup_plan(n, l, g, how, all(t.data_ptr() % 16 == 0 for t in read),
                       _sms(mask.device))
    from .build import library

    lib = library("group")
    rc = lib.gk_egroup(
        _ptr(idx0), _ptr(idx1), _ptr(mask), _ptr(val), val_kind, n, l, g,
        int(g1), _MODE[axis], _HOW[how], acc_f32,
        int(init_v) if not acc_f32 else 0,
        ctypes.c_float(float(init_v) if acc_f32 else 0.0), _ptr(out),
        int(plan["vec"]), plan["lanes"], plan["warps"], plan["grid"],
        plan["smem"], _stream(),
    )
    _check(rc, "egroup")
    LAUNCHES["egroup"] += 1
    if out_t == torch.bool and how != "any":
        out = out != 0
    return out


# ---------------------------------------------------------------------------
# K4 need_tail


def need_layout(c_pad: int, r: int):
    """(p8, w4, width) of one chunk's int32 output row:
    [w4 packed words | r hot ids | n_hot | compiled pairs | interp pairs]."""
    p8 = -(-c_pad * r // 8)
    w4 = -(-p8 // 4)
    return p8, w4, w4 + r + 3


def need_tail_plain(match_u, spec_map, viol, compiled, row_fb, n_valid: int,
                    r_cap: int):
    """One chunk's need tail, as an int32 row (need_layout): need =
    match[spec_map] & (viol | ~compiled | row_fb) & valid; hot rows =
    ascending nonzero of need.any(0), -1 filled to r_cap; the [C, r_cap]
    need columns of the hot rows packed c-major into big-endian bits,
    the bytes into little-endian int32 words."""
    dev = viol.device
    c_pad, n = viol.shape
    match = match_u[spec_map.long()]
    valid = (torch.arange(n, device=dev) < n_valid)[None, :]
    fallback = ~compiled[:, None] | row_fb[None, :]
    need = match & (viol | fallback) & valid
    stat_c = torch.sum(
        match & compiled[:, None] & ~row_fb[None, :] & valid, dtype=torch.int32
    )
    stat_i = torch.sum(match & fallback & valid, dtype=torch.int32)
    rowany = need.any(0)
    n_hot = torch.sum(rowany, dtype=torch.int32)
    nz = torch.nonzero(rowany).flatten()[:r_cap]
    hot = torch.full((r_cap,), -1, dtype=torch.int32, device=dev)
    hot[: nz.numel()] = nz.to(torch.int32)
    sub = need[:, hot.clamp(min=0).long()] & (hot >= 0)[None, :]
    p8, w4, _ = need_layout(c_pad, r_cap)
    bits = torch.zeros(w4 * 32, dtype=torch.int64, device=dev)
    bits[: c_pad * r_cap] = sub.reshape(-1).to(torch.int64)
    weights = torch.tensor(
        [128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int64, device=dev
    )
    packed = (bits.view(-1, 8) * weights).sum(1).view(-1, 4)
    words = (
        packed[:, 0]
        | (packed[:, 1] << 8)
        | (packed[:, 2] << 16)
        | (packed[:, 3] << 24)
    )
    words = torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
    return torch.cat([
        words, hot, n_hot.view(1), stat_c.view(1), stat_i.view(1),
    ])


NEED_THREADS = 256  # K4's pass-1 and pass-3 blocks (csrc/need.cu)
NEED_RPT = 16  # reviews per pass-1 thread: one 16-byte load per row
NEED_TILE = NEED_THREADS * NEED_RPT
NEED_MAX_CS = 256  # constraints per pass-1 slice, at most
NEED_PACK_JC = 4096  # hot slots a pass-3 block stages, at most
NEED_MAX_CR = 1024  # need rows per pass-3 block, at most
GRID_Y_MAX = 65_535


def need_plan(c_pad: int, n: int, r: int, addrs: Sequence[int], sms: int):
    """K4's launch plan for a [c_pad, n] chunk with r hot slots:
    -> dict(cs, g1, jc, cr, g3, smem3, vec, words).
    Pass 1: a grid g1 = (review tiles of NEED_TILE, constraint slices of cs)
    of about two blocks per SM; vec: 16-byte loads (n % 16 == 0 and every
    row array 16-byte aligned at `addrs`), else byte loads. Pass 2: one
    block over the `words` = ceil(n / 32) row-any bit words. Pass 3: a grid
    g3 = (row groups of cr, slot chunks of jc) of about four blocks per SM,
    each staging jc hot ids and cr spec rows and compiled flags (smem3
    bytes)."""
    if c_pad < 1:
        raise ValueError("need_tail: no constraint rows")
    if not 0 < r <= n:
        raise ValueError(f"need_tail: r_cap {r} outside (0, {n}]")
    if n > 2**31 - 1 - NEED_TILE:
        raise ValueError(f"need_tail: {n} reviews exceed a chunk")
    target = 4 * sms
    tiles = -(-n // NEED_TILE)
    # pass 1 at about two blocks per SM, as many as its registers (about
    # 100 a thread) let an SM hold: one wave, 16 constraints a slice at the
    # main shape; 8 (two waves) and 32 (one block per SM) were slower
    cs = min(NEED_MAX_CS, max(1, -(-c_pad // -(-target // 2 // tiles))))
    slices = -(-c_pad // cs)
    jc = min(NEED_PACK_JC, -(-r // 32) * 32)
    chunks = -(-r // jc)
    cr = min(NEED_MAX_CR, max(1, -(-c_pad * chunks // target)))
    if max(slices, chunks) > GRID_Y_MAX:
        raise ValueError(f"need_tail: [{c_pad}, {n}] with r_cap {r} exceeds "
                         f"the grid ({slices} slices, {chunks} slot chunks)")
    words = -(-n // 32)
    if need_layout(c_pad, r)[2] + words > 2**31 - 1:
        raise ValueError(f"need_tail: [{c_pad}, {r}] packed bits exceed int32")
    return {
        "cs": cs, "g1": (tiles, slices), "jc": jc, "cr": cr,
        "g3": (-(-c_pad // cr), chunks),
        "smem3": -(-(4 * jc + 5 * cr) // 16) * 16,
        "vec": n % 16 == 0 and all(a % 16 == 0 for a in addrs),
        "words": words,
    }


def need_tail(match_u, spec_map, viol, compiled, row_fb, n_valid: int,
              r_cap: int):
    """K4 wrapper: see need_tail_plain."""
    if not _on_cuda(match_u, spec_map, viol, compiled, row_fb):
        return need_tail_plain(
            match_u, spec_map, viol, compiled, row_fb, n_valid, r_cap
        )
    match_u = _need(match_u, torch.bool, 2, "match_u")
    spec_map = _need(spec_map, torch.int32, 1, "spec_map")
    viol = _need(viol, torch.bool, 2, "viol")
    compiled = _need(compiled, torch.bool, 1, "compiled")
    row_fb = _need(row_fb, torch.bool, 1, "row_fb")
    c_pad, n = viol.shape
    if (
        match_u.shape[1] != n or spec_map.shape[0] != c_pad
        or compiled.shape[0] != c_pad or row_fb.shape[0] != n
    ):
        raise ValueError("need_tail: inconsistent shapes")
    plan = need_plan(
        c_pad, n, r_cap,
        (match_u.data_ptr(), viol.data_ptr(), row_fb.data_ptr()),
        _sms(viol.device),
    )
    _, w4, width = need_layout(c_pad, r_cap)
    # the output row and the row-any bit words after it: one zeroed buffer
    buf = torch.zeros((width + plan["words"],), dtype=torch.int32,
                      device=viol.device)
    from .build import library

    lib = library("need")
    rc = lib.gk_need_tail(
        _ptr(match_u), _ptr(spec_map), _ptr(viol), _ptr(compiled),
        _ptr(row_fb), c_pad, n, max(0, min(int(n_valid), n)), r_cap,
        _ptr(buf), w4, plan["cs"], *plan["g1"], plan["jc"], plan["cr"],
        *plan["g3"], plan["smem3"], int(plan["vec"]), _stream(),
    )
    _check(rc, "need_tail")
    LAUNCHES["need_tail"] += 1
    return buf[:width]


# ---------------------------------------------------------------------------
# K5 flush_deltas


@functools.lru_cache(maxsize=None)
def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty((0,), dtype=dtype).numpy().dtype


def _host_delta(delta, buf: torch.Tensor, fill: int) -> np.ndarray:
    """A delta as a C-contiguous host array of the buffer's dtype (cast on
    the host where the dtype differs, as the JAX version's
    `.astype(b.dtype)`), checked to fit the buffer at rows
    [fill, fill + len)."""
    if isinstance(delta, torch.Tensor):
        delta = delta.detach().cpu().numpy()
    d = np.ascontiguousarray(delta, dtype=_np_dtype(buf.dtype))
    shape = buf.shape
    if d.ndim != len(shape) or d.shape[1:] != shape[1:]:
        raise ValueError(
            f"flush_deltas: delta {tuple(d.shape)} does not fit buffer "
            f"{tuple(shape)}"
        )
    if fill < 0 or fill + d.shape[0] > shape[0]:
        raise ValueError(
            f"flush_deltas: rows [{fill}, {fill + d.shape[0]}) outside "
            f"a buffer of {shape[0]}"
        )
    return d


def flush_deltas_plain(bufs: Sequence[torch.Tensor], fills: Sequence[int],
                       deltas: Sequence[Any]) -> List[torch.Tensor]:
    """Write each delta [d, ...] into its resident buffer at rows
    [fill, fill + d), in place: one `copy_` per table. -> the buffers."""
    for buf, fill, delta in zip(bufs, fills, deltas):
        d = _host_delta(delta, buf, fill)
        buf[fill:fill + d.shape[0]].copy_(torch.from_numpy(d))
    return list(bufs)


# K5's block (csrc/delta.cu): DELTA_THREADS threads move one segment of at
# most DELTA_SEG bytes, DELTA_VEC 16-byte vectors each; the first
# DELTA_PARAM_SEGS segment headers ride in the kernel parameters
DELTA_THREADS = 256
DELTA_VEC = 1
DELTA_SEG = DELTA_THREADS * DELTA_VEC * 16  # 4 KiB
DELTA_PARAM_SEGS = 248
# struct Segment of csrc/delta.cu
SEG_DTYPE = np.dtype([("dst", "<u8"), ("src", "<u4"), ("n", "<u4")])


def delta_plan(dsts: Sequence[int], sizes: Sequence[int]):
    """K5's launch plan for deltas of `sizes` bytes bound for the device
    addresses `dsts`: -> dict(table, starts, header, total).

    Each delta is cut at the multiples of DELTA_SEG in the destination's
    address space, so a segment's offset from 16-byte alignment plus its
    bytes never exceed DELTA_SEG: one block's threads move it in DELTA_VEC
    vectors each, and the recorded audit_churn flush (651,264 bytes) gives
    every SM of an H100 a segment. table: one SEG_DTYPE row per segment
    (destination, staging offset, bytes), delta after delta. starts: each
    delta's staging offset, behind the table (`header` bytes) and
    congruent to its destination modulo 16; each delta's slot is padded to
    16 bytes, so `total`, the staging's length, is a multiple of 16 and
    the aligned vectors holding a segment's ends lie in its delta's
    slot."""
    dst = np.asarray(dsts, np.int64).reshape(-1)
    size = np.asarray(sizes, np.int64).reshape(-1)
    seg = DELTA_SEG
    live = size > 0
    first = dst // seg
    counts = np.where(live, (dst + size - 1) // seg - first + 1, 0)
    n_segs = int(counts.sum())
    header = n_segs * SEG_DTYPE.itemsize
    lead = dst & 15
    slot = np.where(live, (lead + size + 15) // 16 * 16, 0)
    base = header + np.cumsum(slot) - slot
    starts = base + lead
    total = header + int(slot.sum())
    if total >= 1 << 32:
        raise ValueError(f"flush_deltas: {total} staging bytes exceed 4 GiB")
    di = np.repeat(np.arange(dst.shape[0]), counts)
    k = np.arange(n_segs) - np.repeat(np.cumsum(counts) - counts, counts)
    win = (first[di] + k) * seg
    lo = np.maximum(win, dst[di])
    hi = np.minimum(win + seg, dst[di] + size[di])
    table = np.empty((n_segs,), SEG_DTYPE)
    table["dst"] = lo
    table["src"] = starts[di] + (lo - dst[di])
    table["n"] = hi - lo
    return {"table": table, "starts": starts, "header": header, "total": total}


def pack_deltas(staging: np.ndarray, plan, deltas: Sequence[np.ndarray]) -> None:
    """Write the plan's segment table and every delta (C-contiguous host
    arrays of the buffers' dtypes, as _host_delta gives them) into
    `staging` (uint8, at least plan["total"] bytes): one slice assignment
    each, through a byte view of the staging."""
    view = memoryview(staging)
    view[:plan["header"]] = plan["table"].view(np.uint8)
    for d, pos in zip(deltas, plan["starts"].tolist()):
        if d.nbytes:
            view[pos:pos + d.nbytes] = memoryview(d).cast("B")


def flush_deltas(bufs: Sequence[torch.Tensor], fills: Sequence[int],
                 deltas: Sequence[Any]) -> List[torch.Tensor]:
    """K5 wrapper: see flush_deltas_plain. On CUDA buffers every delta is
    packed into one pinned staging buffer behind the segment table of its
    plan (delta_plan), shipped with ONE host-to-device copy, and written
    by ONE launch of K5."""
    if not bufs:
        return []
    if not _on_cuda(*bufs):
        return flush_deltas_plain(bufs, fills, deltas)
    device = bufs[0].device
    ds, dsts = [], []
    for buf, fill, delta in zip(bufs, fills, deltas):
        if (buf.device != device or not buf.is_contiguous()
                or buf.dtype not in _ELEM_BYTES or buf.dim() == 0):
            raise ValueError(
                f"flush_deltas: buffer {buf.dtype} {tuple(buf.shape)} on "
                f"{buf.device} not a contiguous bool/int32/float32 table "
                f"on {device}")
        d = _host_delta(delta, buf, fill)
        ds.append(d)
        # a delta row is a buffer row: its stride is the row's bytes
        dsts.append(buf.data_ptr() + fill * d.strides[0])
    plan = delta_plan(dsts, [d.nbytes for d in ds])
    n_segs = plan["table"].shape[0]
    if not n_segs:
        return list(bufs)
    from .build import library

    lib = library("delta")
    # torch's caching host allocator hands this block out again only after
    # the event that the non-blocking copy below records on the stream
    host = torch.empty((plan["total"],), dtype=torch.uint8, pin_memory=True)
    pack_deltas(host.numpy(), plan, ds)
    dev = torch.empty((plan["total"],), dtype=torch.uint8, device=device)
    dev.copy_(host, non_blocking=True)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.gk_flush_deltas(host.data_ptr(), dev.data_ptr(), plan["total"],
                             n_segs, stream)
    if rc < 0:
        raise RuntimeError("flush_deltas: K5 refused the plan's segment table")
    _check(rc, "flush_deltas")
    LAUNCHES["flush_deltas"] += 1
    return list(bufs)


# ---------------------------------------------------------------------------
# K6 gather_elem


def elem_index(idx0, idx1, axis: str, g0: int, g1: int):
    """JAX's flat element index: idx0 on g0; idx0 * g1 + idx1 on g01 when
    both are set (an idx1 >= g1 runs on into the next element), else -1."""
    if axis == "g0":
        return idx0, g0
    if axis != "g01":
        raise ValueError(f"gather_elem: axis {axis!r}")
    idx = torch.where((idx0 >= 0) & (idx1 >= 0), idx0 * g1 + idx1, -1)
    return idx, g0 * g1


def _gather_type(v: torch.Tensor, default: Any) -> torch.dtype:
    rt = torch.result_type(v, default)
    return {torch.int64: torch.int32, torch.float64: torch.float32}.get(rt, rt)


def gather_elem_plain(v, idx0, idx1, axis: str, g0: int, g1: int,
                      default: Any):
    """[N, L]: each token's value of its own array element, v[n, idx]
    from v [N, G], where 0 <= idx < G; `default` elsewhere. The torch
    form of take_along_axis(v, clip(idx, 0, G - 1)) under a where."""
    idx, g = elem_index(idx0, idx1, axis, g0, g1)
    safe = torch.clamp(idx, 0, g - 1)
    vals = torch.gather(v, 1, safe.long())
    out = torch.where((idx >= 0) & (idx < g), vals, default)
    return out.to(_gather_type(v, default))


def gather_elem(v, idx0, idx1, axis: str, g0: int, g1: int,
                default: Any):
    """K6 wrapper: see gather_elem_plain."""
    if not _on_cuda(v, idx0, idx1):
        return gather_elem_plain(v, idx0, idx1, axis, g0, g1, default)
    idx0 = _need(idx0, torch.int32, 2, "idx0")
    idx1 = _need(idx1, torch.int32, 2, "idx1")
    eb = _ELEM_BYTES.get(v.dtype)
    g = g0 if axis == "g0" else g0 * g1
    if axis not in ("g0", "g01") or eb is None or v.dim() != 2:
        raise ValueError(f"gather_elem: {axis} {v.dtype} {tuple(v.shape)}")
    if v.shape != (idx0.shape[0], g) or idx1.shape != idx0.shape:
        raise ValueError(
            f"gather_elem: v {tuple(v.shape)} / idx {tuple(idx0.shape)} / g {g}"
        )
    if _gather_type(v, default) != v.dtype:
        raise ValueError(f"gather_elem: default {default!r} changes {v.dtype}")
    v = v.contiguous()
    if v.dtype == torch.float32:
        bits = struct.unpack("<I", struct.pack("<f", float(default)))[0]
    else:
        bits = int(default) & 0xFFFFFFFF
    n, l = idx0.shape
    out = torch.empty((n, l), dtype=v.dtype, device=v.device)
    if out.numel() == 0:
        return out
    from .build import library

    lib = library("gather")
    rc = lib.gk_gather_elem(
        _ptr(v), g, _ptr(idx0), _ptr(idx1), 0 if axis == "g0" else 1,
        int(g1), bits, _ptr(out), n * l, l, eb, _stream(),
    )
    _check(rc, "gather_elem")
    LAUNCHES["gather_elem"] += 1
    return out


# ---------------------------------------------------------------------------
# K7 full_totals


def full_totals_plain(match, counts, crow, n_valid: int):
    """[C] int32: totals[c] = #{n < n_valid : match[c, n] and
    counts[crow[c], n] > 0}, 0 where crow[c] lies outside [0, Cc). Written
    as the JAX step writes it: counts scattered onto a [C, N] int32 `viol`
    at the compiled constraint rows, then where / > 0 / valid / sum."""
    c, n = match.shape
    dev = match.device
    viol = torch.zeros((c, n), dtype=torch.int32, device=dev)
    if counts is not None and counts.shape[0]:
        crow = crow.long()
        live = (crow >= 0) & (crow < counts.shape[0])
        rows = torch.nonzero(live).flatten()
        viol[rows] = counts[crow[rows]]
    valid = (torch.arange(n, device=dev) < n_valid)[None, :]
    return torch.sum(
        (torch.where(match, viol, 0) > 0) & valid, 1, dtype=torch.int32
    )


def full_totals(match, counts, crow, n_valid: int):
    """K7 wrapper: see full_totals_plain. The kernel reads each match row
    and the counts row it maps to once and writes only the [C] totals; no
    [C, N] intermediate is built."""
    ts = (match, crow) if counts is None else (match, counts, crow)
    if not _on_cuda(*ts):
        return full_totals_plain(match, counts, crow, n_valid)
    match = _need(match, torch.bool, 2, "match")
    crow = _need(crow, torch.int32, 1, "crow")
    c, n = match.shape
    if crow.shape[0] != c:
        raise ValueError(f"full_totals: crow {tuple(crow.shape)} for {c} rows")
    if counts is None:
        cc = 0
    else:
        counts = _need(counts, torch.int32, 2, "counts")
        if counts.shape[1] != n:
            raise ValueError(
                f"full_totals: counts {tuple(counts.shape)} vs match "
                f"{tuple(match.shape)}"
            )
        cc = counts.shape[0]
    if not 0 <= n_valid <= n:
        raise ValueError(f"full_totals: n_valid {n_valid} outside [0, {n}]")
    out = torch.empty((c,), dtype=torch.int32, device=match.device)
    if c == 0:
        return out
    from .build import library

    lib = library("totals")
    rc = lib.gk_full_totals(
        _ptr(match), _ptr(counts), cc, _ptr(crow), c, n, int(n_valid),
        _ptr(out), _stream(),
    )
    _check(rc, "full_totals")
    LAUNCHES["full_totals"] += 1
    return out
