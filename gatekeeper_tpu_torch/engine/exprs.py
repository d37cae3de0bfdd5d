"""Vectorized expression DAG for compiled template programs (torch).

Port of gatekeeper_tpu/engine/exprs.py. Compiled violation rules are DAGs
of these nodes, evaluated eagerly with torch on the tensors' own device
through the functions of `xp`. Spaces (array shapes) are:

    ()        -> [N]          per-resource scalars
    ("tok",)  -> [N, L]       per-token (object-key iteration bindings)
    ("g0",)   -> [N, G0]      per-first-level-array-element (containers)
    ("g0","g1") -> [N, G0, G1]

Nodes are pure and hash-consed per evaluation via an id-keyed memo, so
shared subexpressions evaluate once. EGroup (the regroup of token values
onto an array axis) runs through the hand-written kernel in
kernels/ops.py on CUDA tensors.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from . import xp


class Expr:
    space: Tuple[str, ...] = ()

    def emit(self, ctx: "EvalCtx"):
        memo = ctx.memo
        key = id(self)
        if key not in memo:
            memo[key] = self._emit(ctx)
        return memo[key]

    def _emit(self, ctx):  # pragma: no cover - abstract
        raise NotImplementedError


@dataclass
class EvalCtx:
    """Evaluation context: token columns, tables, per-constraint consts.

    `slabs`/`slab_cols`: optional pre-gathered fused-table slabs. The
    device path gathers the pattern/table columns the policy reads in a
    handful of fused row-gathers ([V, T] tables indexed by the token's
    spath/vid once per chunk, shared across every program group and
    const set) and each node slices its column out. With slabs, a
    pattern node must find its column there (the device context carries
    no full pattern tables); without slabs (host rendering), nodes
    gather individually. String-table lookups at ids other than the
    token's vid gather from `str_tables` either way."""

    tok: Dict[str, Any]  # spath/idx0/idx1/kind/vid/vnum, each [N, L]
    pat_member: Any  # [P, Vp] bool
    pat_capture: Any  # [P, Vp] int32
    str_tables: Dict[str, Any]  # name -> [Vs] array
    consts: Dict[str, Any]  # slot -> array (vmapped per constraint)
    g0: int = 8  # first-level array fanout
    g1: int = 8
    memo: Dict[int, Any] = field(default_factory=dict)
    # slab name -> [N, L, T] pre-gathered fused table (device path only)
    slabs: Optional[Dict[str, Any]] = None
    # slab name -> {identifier: column index}
    slab_cols: Optional[Dict[str, Dict[Any, int]]] = None
    # per-row feature arrays ([N] bool), e.g. inventory join-key
    # duplication bits; ERowFeature reads them, defaulting to True
    # (unrefined) when a caller supplies none
    row: Optional[Dict[str, Any]] = None
    # ephemeral vocab overlay (flatten.vocab.OverlayVocab): ids >= v_base
    # resolve against the batch's overlay blocks instead of the base
    # tables. ov_member/ov_capture are [B, P] (entry-major); ov_tabs maps
    # table name -> [B] rows (host/numpy path); ov_slabs/ov_cols carry
    # the per-kind [B, T] stacks for the device path.
    v_base: Optional[Any] = None
    ov_member: Optional[Any] = None
    ov_capture: Optional[Any] = None
    ov_tabs: Optional[Dict[str, Any]] = None
    ov_slabs: Optional[Dict[str, Any]] = None
    ov_cols: Optional[Dict[str, Tuple[str, int]]] = None

    @property
    def device(self):
        return self.tok["spath"].device

    @property
    def n(self) -> int:
        return self.tok["spath"].shape[0]

    @property
    def l(self) -> int:
        return self.tok["spath"].shape[1]


def _shape_for(ctx: EvalCtx, space: Tuple[str, ...]) -> Tuple[int, ...]:
    dims = [ctx.n]
    for ax in space:
        dims.append(
            {"tok": ctx.l, "g0": ctx.g0, "g1": ctx.g1, "g01": ctx.g0 * ctx.g1}[ax]
        )
    return tuple(dims)


# space dominance for broadcasting; ("tok","g0") is the rank-3 join space
_RANK = {
    (): 0,
    ("tok",): 1,
    ("g0",): 1,
    ("g01",): 2,
    ("tok", "g0"): 3,
    ("tok", "g01"): 3,
}


def _space_rank(s: Tuple[str, ...]) -> int:
    return _RANK.get(s, 0)


def join_spaces(a: Tuple[str, ...], b: Tuple[str, ...]) -> Tuple[str, ...]:
    """Smallest space both broadcast into, or None."""
    if a == b:
        return a
    if not a:
        return b
    if not b:
        return a
    pair = {a, b}
    if pair == {("g0",), ("g01",)}:
        return ("g01",)
    if pair == {("tok",), ("g0",)} or pair == {("tok", "g0"), ("g0",)} or (
        pair == {("tok", "g0"), ("tok",)}
    ):
        return ("tok", "g0")
    if pair == {("tok",), ("g01",)} or pair == {("tok", "g01"), ("g01",)} or (
        pair == {("tok", "g01"), ("tok",)}
    ):
        return ("tok", "g01")
    if pair == {("tok", "g0"), ("g01",)} or pair == {("tok", "g01"), ("g0",)}:
        return None
    return None


def _expand(ctx: EvalCtx, v, s: Tuple[str, ...], target: Tuple[str, ...]):
    if s == target:
        return v
    if s == ():
        for _ in target:
            v = v[..., None] if hasattr(v, "ndim") else v
        return v
    if s == ("g0",) and target == ("g01",):
        return xp.repeat(v, ctx.g1, -1)
    if s == ("tok",) and target in (("tok", "g0"), ("tok", "g01")):
        return v[:, :, None]
    if s == ("g0",) and target == ("tok", "g0"):
        return v[:, None, :]
    if s == ("g01",) and target == ("tok", "g01"):
        return v[:, None, :]
    if s == ("g0",) and target == ("tok", "g01"):
        return xp.repeat(v, ctx.g1, -1)[:, None, :]
    raise ValueError(f"cannot expand {s} -> {target}")


def broadcast(ctx: EvalCtx, vals: Sequence[Any], spaces: Sequence[Tuple[str, ...]]):
    """Align values of compatible spaces for elementwise ops."""
    target: Tuple[str, ...] = ()
    for s in spaces:
        j = join_spaces(target, s)
        if j is None:
            raise ValueError(f"incompatible spaces {spaces}")
        target = j
    out = [_expand(ctx, v, s, target) for v, s in zip(vals, spaces)]
    return out, target


# -- leaves -----------------------------------------------------------------


@dataclass(eq=False)
class ELit(Expr):
    value: Any
    space: Tuple[str, ...] = ()

    def _emit(self, ctx):
        return self.value


@dataclass(eq=False)
class EFullN(Expr):
    """[N] array filled with a constant (anchors scalar conds to the batch)."""

    value: Any
    space: Tuple[str, ...] = ()

    def _emit(self, ctx):
        return xp.full((ctx.n,), self.value, ctx.device)


@dataclass(eq=False)
class ERowFeature(Expr):
    """[N] bool feature supplied by the dispatch layer (e.g. the
    inventory join-key duplication screen). Missing feature -> True
    (the unrefined, coarser-but-sound screen)."""

    name: str
    space: Tuple[str, ...] = ()

    def _emit(self, ctx):
        if ctx.row is not None:
            feat = ctx.row.get(self.name)
            if feat is not None:
                return feat
        return xp.full((ctx.n,), True, ctx.device)


@dataclass(eq=False)
class EConstSlot(Expr):
    """Per-constraint constant (scalar or padded array), fed at call time."""

    slot: str
    space: Tuple[str, ...] = ()

    def _emit(self, ctx):
        return ctx.consts[self.slot]


@dataclass(eq=False)
class ETokCol(Expr):
    col: str  # spath | idx0 | idx1 | kind | vid | vnum
    space: Tuple[str, ...] = (("tok",))

    def __post_init__(self):
        self.space = ("tok",)

    def _emit(self, ctx):
        return ctx.tok[self.col]


def _slab_col(ctx, kind: str, ident) -> int:
    """Column of `ident` in the pre-gathered `kind` slab; raises when the
    policy's staging left it out (there is no per-node fallback)."""
    col = (ctx.slab_cols or {}).get(kind, {}).get(ident)
    if col is None or kind not in ctx.slabs:
        raise KeyError(f"{kind} column {ident!r} was not staged as a slab")
    return col


@dataclass(eq=False)
class ESelPattern(Expr):
    """[N, L] bool: token's schema path matches the pattern."""

    pattern_idx: int

    def __post_init__(self):
        self.space = ("tok",)

    def _emit(self, ctx):
        spath = ctx.tok["spath"]
        if ctx.slabs is not None:
            # overlay resolution happened at slab pre-gather time; the
            # device path stages every pattern its programs read
            col = _slab_col(ctx, "pat_member", self.pattern_idx)
            return (spath >= 0) & ctx.slabs["pat_member"][..., col]
        width = ctx.pat_member.shape[1]
        safe = xp.clip(spath, 0, max(width - 1, 0))
        base = (
            (spath >= 0)
            & (spath < width)
            & xp.take(ctx.pat_member[self.pattern_idx], safe)
        )
        if ctx.ov_member is None:
            return base
        loc = spath - ctx.v_base
        b = ctx.ov_member.shape[0]
        safe_loc = xp.clip(loc, 0, max(b - 1, 0))
        ov = (loc >= 0) & (loc < b) & xp.take(ctx.ov_member[:, self.pattern_idx], safe_loc)
        return xp.where(loc >= 0, ov, base)


@dataclass(eq=False)
class ECapture(Expr):
    """[N, L] int32: captured segment id for the pattern (-1 if none)."""

    pattern_idx: int

    def __post_init__(self):
        self.space = ("tok",)

    def _emit(self, ctx):
        spath = ctx.tok["spath"]
        if ctx.slabs is not None:
            col = _slab_col(ctx, "pat_capture", self.pattern_idx)
            return xp.where(spath >= 0, ctx.slabs["pat_capture"][..., col], -1)
        width = ctx.pat_capture.shape[1]
        safe = xp.clip(spath, 0, max(width - 1, 0))
        base = xp.where(
            (spath >= 0) & (spath < width),
            xp.take(ctx.pat_capture[self.pattern_idx], safe),
            -1,
        )
        if ctx.ov_capture is None:
            return base
        loc = spath - ctx.v_base
        b = ctx.ov_capture.shape[0]
        safe_loc = xp.clip(loc, 0, max(b - 1, 0))
        ov = xp.where(
            (loc >= 0) & (loc < b),
            xp.take(ctx.ov_capture[:, self.pattern_idx], safe_loc),
            -1,
        )
        return xp.where(loc >= 0, ov, base)


@dataclass(eq=False)
class EStrTable(Expr):
    """Gather a vocab-derived table at an id expression (−1 -> default)."""

    table: str
    ids: Expr
    default: Any = False

    def __post_init__(self):
        self.space = self.ids.space

    def _emit(self, ctx):
        # tok-space vid lookups ride the fused pre-gathered slabs
        if (
            ctx.slabs is not None
            and isinstance(self.ids, ETokCol)
            and self.ids.col == "vid"
        ):
            for slab in ("vid_f32", "vid_bool", "vid_i32"):
                if slab in ctx.slabs:
                    col = ctx.slab_cols[slab].get(self.table)
                    if col is not None:
                        ids = ctx.tok["vid"]
                        return xp.where(
                            ids >= 0,
                            ctx.slabs[slab][..., col],
                            self.default,
                        )
        ids = self.ids.emit(ctx)
        tab = ctx.str_tables[self.table]
        rows = tab.shape[0]
        safe = xp.clip(ids, 0, max(rows - 1, 0))
        base = xp.where(
            (ids >= 0) & (ids < rows), xp.take(tab, safe), self.default
        )
        if ctx.v_base is None:
            return base
        ov_row = None
        if ctx.ov_tabs is not None:
            ovt = ctx.ov_tabs.get(self.table)
            if ovt is not None:
                loc = ids - ctx.v_base
                b = ovt.shape[0]
                safe_loc = xp.clip(loc, 0, max(b - 1, 0))
                ov_row = xp.where(
                    (loc >= 0) & (loc < b), xp.take(ovt, safe_loc), self.default
                )
        elif ctx.ov_slabs is not None and ctx.ov_cols is not None:
            kc = ctx.ov_cols.get(self.table)
            if kc is not None:
                kind, col = kc
                ov = ctx.ov_slabs[kind]
                loc = ids - ctx.v_base
                b = ov.shape[0]
                safe_loc = xp.clip(loc, 0, max(b - 1, 0))
                ov_row = xp.where(
                    (loc >= 0) & (loc < b),
                    xp.take(ov[:, col], safe_loc),
                    self.default,
                )
        if ov_row is None:
            return base
        return xp.where(ids - ctx.v_base >= 0, ov_row, base)


@dataclass(eq=False)
class EIsInConst(Expr):
    """ids ∈ const id set (slot holds padded [K] ids, -1 pad)."""

    ids: Expr
    slot: str

    def __post_init__(self):
        self.space = self.ids.space

    def _emit(self, ctx):
        ids = self.ids.emit(ctx)
        members = ctx.consts[self.slot]  # [K]
        hit = (members != -1) & (members == ids[..., None])
        return xp.any(hit, -1)


# -- combinators ------------------------------------------------------------


@dataclass(eq=False)
class EMap(Expr):
    """Elementwise op over broadcast-aligned children."""

    fn: Callable
    args: List[Expr]
    name: str = "map"

    def __post_init__(self):
        target: Tuple[str, ...] = ()
        for a in self.args:
            j = join_spaces(target, a.space)
            if j is None:
                raise ValueError(
                    f"incompatible spaces {[a.space for a in self.args]}"
                )
            target = j
        self.space = target

    def _emit(self, ctx):
        vals = [a.emit(ctx) for a in self.args]
        vals, _ = broadcast(ctx, vals, [a.space for a in self.args])
        return self.fn(xp, *vals)


def e_and(*args: Expr) -> Expr:
    return EMap(lambda xp_, *vs: _fold(xp_, vs, lambda a, b: a & b), list(args), "and")


def e_or(*args: Expr) -> Expr:
    return EMap(lambda xp_, *vs: _fold(xp_, vs, lambda a, b: a | b), list(args), "or")


def e_not(a: Expr) -> Expr:
    return EMap(lambda xp_, v: ~v, [a], "not")


def _fold(xp_, vs, f):
    out = vs[0]
    for v in vs[1:]:
        out = f(out, v)
    return out


def e_cmp(op: str, a: Expr, b: Expr) -> Expr:
    fns = {
        "==": lambda xp_, x, y: x == y,
        "!=": lambda xp_, x, y: x != y,
        "<": lambda xp_, x, y: x < y,
        "<=": lambda xp_, x, y: x <= y,
        ">": lambda xp_, x, y: x > y,
        ">=": lambda xp_, x, y: x >= y,
    }
    return EMap(fns[op], [a, b], f"cmp{op}")


def e_arith(op: str, a: Expr, b: Expr) -> Expr:
    fns = {
        "+": lambda xp_, x, y: xp_.x32(x + y),
        "-": lambda xp_, x, y: xp_.x32(x - y),
        "*": lambda xp_, x, y: xp_.x32(x * y),
        "/": lambda xp_, x, y: xp_.x32(x / y),
        "%": lambda xp_, x, y: xp_.x32(x % y),
    }
    return EMap(fns[op], [a, b], f"arith{op}")


def e_where(c: Expr, t: Expr, f: Expr) -> Expr:
    return EMap(lambda xp_, cc, tt, ff: xp_.where(cc, tt, ff), [c, t, f], "where")


# -- reductions / regrouping ------------------------------------------------


@dataclass(eq=False)
class EReduce(Expr):
    """Reduce the innermost axis of child's space: any | all | sum | max."""

    child: Expr
    how: str

    def __post_init__(self):
        if not self.child.space:
            raise ValueError("cannot reduce a scalar space")
        self.space = self.child.space[:-1]

    def _emit(self, ctx):
        v = self.child.emit(ctx)
        if self.how == "any":
            return xp.any(v, -1)
        if self.how == "all":
            return xp.all(v, -1)
        if self.how == "sum":
            return xp.sum(v, -1)
        if self.how == "max":
            return xp.max(v, -1)
        raise ValueError(self.how)


@dataclass(eq=False)
class EReduceAxis(Expr):
    """Reduce a NAMED axis of the child's space (any | sum)."""

    child: Expr
    axis: str
    how: str = "any"

    def __post_init__(self):
        if self.axis not in self.child.space:
            raise ValueError(f"axis {self.axis} not in {self.child.space}")
        self.space = tuple(a for a in self.child.space if a != self.axis)

    def _emit(self, ctx):
        v = self.child.emit(ctx)
        dim = 1 + self.child.space.index(self.axis)
        if self.how == "any":
            return xp.any(v, dim)
        if self.how == "sum":
            return xp.sum(v, dim)
        raise ValueError(self.how)


@dataclass(eq=False)
class EGroup(Expr):
    """Regroup per-token values onto an array-index axis.

    For tokens where `mask` holds, place `value` at [n, idx] where idx is
    the token's idx0 (axis="g0") or idx1 (axis="g1"); `init` fills empty
    slots; `how` resolves collisions (max | any | sum).

    idx1 grouping composes under an idx0 binding: pass an extra equality on
    idx0 in the mask, and group by idx1 -> [N, G1].
    """

    mask: Expr  # [N, L] bool
    value: Optional[Expr]  # [N, L] or None (then value := mask)
    axis: str  # "g0" | "g1"
    how: str = "max"
    init: Any = -1

    def __post_init__(self):
        self.space = (self.axis,)

    def _emit(self, ctx):
        from ..kernels import ops

        mask = self.mask.emit(ctx)
        val = self.value.emit(ctx) if self.value is not None else mask
        # segment reduce per review row (kernels/ops.py egroup): no
        # [N, L, G] one-hot — the JAX version contracts one only because
        # scatters serialize on a TPU
        return ops.egroup(
            ctx.tok["idx0"], ctx.tok["idx1"], mask, xp.x32(val),
            self.axis, ctx.g0, ctx.g1, self.how, self.init,
        )


@dataclass(eq=False)
class EGatherElem(Expr):
    """[N, L]: for each token, the per-element value of ITS OWN array
    element — the inverse of EGroup. `elem` lives on ("g0",) (indexed by
    idx0) or ("g01",) (idx0*G1+idx1). Tokens outside the axis (idx -1)
    take `default`.

    This is what makes element-projected joins work: conditions on two
    DIFFERENT tokens of one element (a mount's name and its readOnly
    flag) become token-level expressions that agree across the element's
    tokens, so they AND correctly and reduce existentially."""

    elem: Expr
    default: Any = False

    def __post_init__(self):
        if self.elem.space not in (("g0",), ("g01",)):
            raise ValueError(f"gather from space {self.elem.space}")
        self.space = ("tok",)

    def _emit(self, ctx):
        v = self.elem.emit(ctx)
        if self.elem.space == ("g0",):
            idx = ctx.tok["idx0"]
            g = ctx.g0
        else:
            i0 = ctx.tok["idx0"]
            i1 = ctx.tok["idx1"]
            idx = xp.where((i0 >= 0) & (i1 >= 0), i0 * ctx.g1 + i1, -1)
            g = ctx.g0 * ctx.g1
        safe = xp.clip(idx, 0, g - 1)
        vals = xp.take_along_axis(v, safe, 1)
        return xp.where((idx >= 0) & (idx < g), vals, self.default)


@dataclass(eq=False)
class EGroupPresent(Expr):
    """[N, G] bool: any selected token exists at that array index."""

    mask: Expr
    axis: str

    def __post_init__(self):
        self.space = (self.axis,)
        self._inner = EGroup(self.mask, None, self.axis, how="any")

    def _emit(self, ctx):
        return self._inner.emit(ctx)
