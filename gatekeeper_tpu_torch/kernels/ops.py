"""The four hand-written CUDA kernels of the fused violation path, each
beside its plain torch version.

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
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, Optional

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
_FB_I32 = (
    "group_id", "kind_id", "ns_name_id", "obj_labels", "old_labels",
    "nssel_labels",
)
_FB_BOOL = (
    "kind_defined", "is_ns", "has_namespace", "obj_present", "old_present",
    "nssel_defined", "nssel_empty",
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


class _MatchArgs(ctypes.Structure):
    # mirrors struct MatchArgs in csrc/match.cu field for field
    _fields_ = [
        ("kind_rows", ctypes.c_void_p), ("K", ctypes.c_int),
        ("ns_has", ctypes.c_void_p), ("ns_ids", ctypes.c_void_p),
        ("M", ctypes.c_int),
        ("excl_has", ctypes.c_void_p), ("excl_ids", ctypes.c_void_p),
        ("M2", ctypes.c_int),
        ("scope", ctypes.c_void_p),
        ("lab_invalid", ctypes.c_void_p), ("lab_ml", ctypes.c_void_p),
        ("P", ctypes.c_int), ("lab_expr", ctypes.c_void_p),
        ("E", ctypes.c_int), ("lab_vals", ctypes.c_void_p),
        ("V", ctypes.c_int),
        ("nssel_has", ctypes.c_void_p),
        ("nssel_matches_empty", ctypes.c_void_p),
        ("nssel_invalid", ctypes.c_void_p), ("nssel_ml", ctypes.c_void_p),
        ("P2", ctypes.c_int), ("nssel_expr", ctypes.c_void_p),
        ("E2", ctypes.c_int), ("nssel_vals", ctypes.c_void_p),
        ("V2", ctypes.c_int),
        ("group_id", ctypes.c_void_p), ("kind_id", ctypes.c_void_p),
        ("kind_defined", ctypes.c_void_p), ("is_ns", ctypes.c_void_p),
        ("has_namespace", ctypes.c_void_p), ("ns_name_id", ctypes.c_void_p),
        ("obj_present", ctypes.c_void_p), ("old_present", ctypes.c_void_p),
        ("obj_labels", ctypes.c_void_p), ("old_labels", ctypes.c_void_p),
        ("ML", ctypes.c_int),
        ("nssel_defined", ctypes.c_void_p), ("nssel_labels", ctypes.c_void_p),
        ("ML2", ctypes.c_int), ("nssel_empty", ctypes.c_void_p),
        ("out", ctypes.c_void_p), ("U", ctypes.c_int), ("N", ctypes.c_int),
    ]


def match_matrix(ms: Dict[str, torch.Tensor], fb: Dict[str, torch.Tensor]):
    """K1 wrapper: [U, N] bool match matrix."""
    if not _on_cuda(*ms.values(), *fb.values()):
        return match_matrix_plain(ms, fb)
    m = {k: _need(ms[k], torch.int32, ms[k].dim(), k) for k in _MS_I32}
    m.update({k: _need(ms[k], torch.bool, 1, k) for k in _MS_BOOL})
    f = {k: _need(fb[k], torch.int32, fb[k].dim(), k) for k in _FB_I32}
    f.update({k: _need(fb[k], torch.bool, 1, k) for k in _FB_BOOL})
    u = m["kind_rows"].shape[0]
    n = f["group_id"].shape[0]
    out = torch.empty((u, n), dtype=torch.bool, device=f["group_id"].device)
    if u == 0 or n == 0:
        return out
    a = _MatchArgs(
        kind_rows=_ptr(m["kind_rows"]), K=m["kind_rows"].shape[1],
        ns_has=_ptr(m["ns_has"]), ns_ids=_ptr(m["ns_ids"]),
        M=m["ns_ids"].shape[1],
        excl_has=_ptr(m["excl_has"]), excl_ids=_ptr(m["excl_ids"]),
        M2=m["excl_ids"].shape[1],
        scope=_ptr(m["scope"]),
        lab_invalid=_ptr(m["lab_invalid"]), lab_ml=_ptr(m["lab_ml"]),
        P=m["lab_ml"].shape[1], lab_expr=_ptr(m["lab_expr"]),
        E=m["lab_expr"].shape[1], lab_vals=_ptr(m["lab_expr_vals"]),
        V=m["lab_expr_vals"].shape[2],
        nssel_has=_ptr(m["nssel_has"]),
        nssel_matches_empty=_ptr(m["nssel_matches_empty"]),
        nssel_invalid=_ptr(m["nssel_invalid"]), nssel_ml=_ptr(m["nssel_ml"]),
        P2=m["nssel_ml"].shape[1], nssel_expr=_ptr(m["nssel_expr"]),
        E2=m["nssel_expr"].shape[1], nssel_vals=_ptr(m["nssel_expr_vals"]),
        V2=m["nssel_expr_vals"].shape[2],
        group_id=_ptr(f["group_id"]), kind_id=_ptr(f["kind_id"]),
        kind_defined=_ptr(f["kind_defined"]), is_ns=_ptr(f["is_ns"]),
        has_namespace=_ptr(f["has_namespace"]),
        ns_name_id=_ptr(f["ns_name_id"]),
        obj_present=_ptr(f["obj_present"]),
        old_present=_ptr(f["old_present"]),
        obj_labels=_ptr(f["obj_labels"]), old_labels=_ptr(f["old_labels"]),
        ML=f["obj_labels"].shape[1],
        nssel_defined=_ptr(f["nssel_defined"]),
        nssel_labels=_ptr(f["nssel_labels"]),
        ML2=f["nssel_labels"].shape[1], nssel_empty=_ptr(f["nssel_empty"]),
        out=_ptr(out), U=u, N=n,
    )
    if f["old_labels"].shape[1] != a.ML:
        raise ValueError("obj_labels and old_labels differ in width")
    from .build import library

    lib = library("match")
    _check(lib.gk_match_matrix(ctypes.addressof(a), _stream()), "match_matrix")
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
    v, t = tab.shape
    out = torch.empty(
        tuple(ids.shape) + (t,), dtype=tab.dtype, device=tab.device
    )
    if out.numel() == 0:
        return out
    if v == 0:
        raise ValueError("slab_gather: empty table")
    from .build import library

    lib = library("slab")
    rc = lib.gk_slab_gather(
        _ptr(tab), v, _ptr(ov), 0 if ov is None else ov.shape[0],
        _ptr(ids), int(v_base), _ptr(out), ids.numel(), t, eb, _stream(),
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
    from .build import library

    lib = library("group")
    rc = lib.gk_egroup(
        _ptr(idx0), _ptr(idx1), _ptr(mask), _ptr(val), val_kind, n, l, g,
        int(g1), _MODE[axis], _HOW[how], acc_f32,
        int(init_v) if not acc_f32 else 0,
        ctypes.c_float(float(init_v) if acc_f32 else 0.0), _ptr(out),
        _stream(),
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
    if not 0 < r_cap <= n:
        raise ValueError(f"need_tail: r_cap {r_cap} outside (0, {n}]")
    _, w4, width = need_layout(c_pad, r_cap)
    out = torch.zeros((width,), dtype=torch.int32, device=viol.device)
    rowany = torch.empty((n,), dtype=torch.bool, device=viol.device)
    from .build import library

    lib = library("need")
    rc = lib.gk_need_tail(
        _ptr(match_u), _ptr(spec_map), _ptr(viol), _ptr(compiled),
        _ptr(row_fb), c_pad, n, int(n_valid), r_cap, _ptr(rowany),
        _ptr(out), w4, _stream(),
    )
    _check(rc, "need_tail")
    LAUNCHES["need_tail"] += 1
    return out
