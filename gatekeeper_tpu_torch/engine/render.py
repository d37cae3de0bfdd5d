# Copied from gatekeeper_tpu/engine/render.py; only imports and the edits noted in this header differ.
# Edit: expressions emit torch (CPU) tensors here; _BranchEval.arr expands
# a value between spaces before converting it to numpy.
"""Compiled violation-message rendering (the SURVEY §7 step-3 design).

The reference renders violation messages inside the engine (OPA topdown
sprintf; response shape vendor/.../constraint/pkg/client/regolib/
src.go:7-45). Until round 4 this build re-ran the Python interpreter per
violating (constraint, resource) pair (~1ms each), which saturated the
violation-heavy webhook. This module closes that gap:

  * at template-compile time each EXACT (non-screen) program keeps, per
    violation branch, its un-flagged condition Expr and a `RenderPlan`
    tree over the head value (format string + captured slots);
  * at render time the driver evaluates the branch conditions and slot
    expressions with numpy over ONLY the violating rows' token slices —
    the same compiled DAG the device ran, so the true (branch, element)
    set is exact — and formats messages by decoding captured vocab ids
    through the interpreter's own `_sprintf`/`opa_repr`, giving
    bit-exact message parity without interpreting any Rego.

Fallback safety: anything a plan cannot prove it renders exactly
(unsupported head shapes, flagged rows, decode anomalies) routes the
pair to the interpreter exactly as before. Semantically-undefined heads
(e.g. sprintf arity errors, missing paths) SKIP the element, matching
Rego's undefined-head semantics.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..flatten.encoder import (
    K_BOOL,
    K_EMPTY_ARR,
    K_EMPTY_OBJ,
    K_NULL,
    K_NUM,
    K_STR,
    unesc_seg,
)
from ..rego.builtins import BuiltinError, _sprintf
from ..rego.values import EMPTY_OBJ, freeze, sort_key
from .exprs import EvalCtx, Expr, _expand


class _Undef:
    """Head value semantically undefined at this element: the element
    contributes no violation (Rego undefined-head semantics)."""


class _CantRender(Exception):
    """The plan cannot guarantee an exact render: route the whole pair
    to the interpreter."""


UNDEF = _Undef()


def _decode_val(vocab, vid: int):
    """Typed value id -> frozen python value (exact: the id interns the
    canonical JSON of the scalar, so no float32 round-trip)."""
    import json

    s = vocab.string(int(vid))
    if s.startswith("s:"):
        return s[2:]
    if s.startswith("j:"):
        return freeze(json.loads(s[2:]))
    raise _CantRender(f"undecodable vocab entry {s[:16]!r}")


# ---------------------------------------------------------------------------
# plan nodes


class RVal:
    def value(self, ev: "_BranchEval", r: int, elem: Tuple[int, ...]):
        raise NotImplementedError


@dataclass
class RConst(RVal):
    v: Any  # pre-frozen

    def value(self, ev, r, elem):
        return self.v


@dataclass
class RScalar(RVal):
    """Token-table leaf: decode the captured vid by kind."""

    vid: Expr
    kind: Expr
    exists: Expr
    space: Tuple[str, ...]

    def value(self, ev, r, elem):
        if not ev.arr(self.exists, self.space)[(r, *elem)]:
            return UNDEF
        k = int(ev.arr(self.kind, self.space)[(r, *elem)])
        vid = int(ev.arr(self.vid, self.space)[(r, *elem)])
        if k == K_EMPTY_OBJ:
            return EMPTY_OBJ
        if k == K_EMPTY_ARR:
            return ()
        if k in (K_STR, K_NUM, K_BOOL, K_NULL):
            if vid < 0:
                return UNDEF
            return _decode_val(ev.vocab, vid)
        raise _CantRender(f"unexpected token kind {k}")


@dataclass
class RKey(RVal):
    """Captured object-key of a token-space iteration (ECapture ids are
    str_ids of the unescaped key)."""

    ids: Expr
    space: Tuple[str, ...]

    def value(self, ev, r, elem):
        vid = int(ev.arr(self.ids, self.space)[(r, *elem)])
        if vid < 0:
            return UNDEF
        return _decode_val(ev.vocab, vid)


@dataclass
class RPath(RVal):
    """Navigate the raw review document ("#" segments consume the
    element's array indices) — object/array-valued head references
    (e.g. a container's securityContext in a message)."""

    segs: Tuple[str, ...]  # unescaped; "#" = array index hole
    n_holes: int

    def value(self, ev, r, elem):
        idxs = ev.g_indices(elem)
        if len(idxs) < self.n_holes:
            raise _CantRender("path holes exceed element indices")
        cur = ev.review
        hole = 0
        for seg in self.segs:
            if seg == "#":
                if not isinstance(cur, (list, tuple)):
                    return UNDEF
                i = idxs[hole]
                hole += 1
                if i >= len(cur):
                    return UNDEF
                cur = cur[i]
            else:
                if not isinstance(cur, dict) or seg not in cur:
                    return UNDEF
                cur = cur[seg]
        return freeze(cur)


@dataclass
class RTokSet(RVal):
    """Set comprehension over a token selection; `axes` non-empty means
    one set per first-level array element (idx0-filtered)."""

    mask: Expr
    elem_ids: Expr
    axes: Tuple[str, ...]

    def value(self, ev, r, elem):
        m = ev.arr_raw(self.mask)[r]
        ids = ev.arr_raw(self.elem_ids)[r]
        if self.axes == ("g0",):
            idxs = ev.g_indices(elem)
            if not idxs:
                raise _CantRender("per-element token set without g index")
            m = m & (ev.idx0[r] == idxs[0])
        elif self.axes != ():
            raise _CantRender(f"token-set axes {self.axes}")
        out = set()
        for t in np.nonzero(m)[0]:
            vid = int(ids[t])
            if vid < 0:
                raise _CantRender("masked token without value id")
            out.add(_decode_val(ev.vocab, vid))
        return frozenset(out)


@dataclass
class RSetDiff(RVal):
    """const_set - token_set (requiredlabels' `missing`)."""

    const: frozenset  # pre-frozen elements
    tokset: RTokSet

    def value(self, ev, r, elem):
        present = self.tokset.value(ev, r, elem)
        if present is UNDEF:
            return UNDEF
        return frozenset(x for x in self.const if x not in present)


@dataclass
class RSprintf(RVal):
    fmt: str
    args: Tuple[RVal, ...]

    def value(self, ev, r, elem):
        vals = []
        for a in self.args:
            v = a.value(ev, r, elem)
            if v is UNDEF:
                return UNDEF
            vals.append(v)
        try:
            return _sprintf(self.fmt, tuple(vals))
        except BuiltinError:
            return UNDEF  # interp: sprintf undefined -> head undefined


@dataclass
class RObj(RVal):
    items: Tuple[Tuple[Any, RVal], ...]  # (frozen key, value plan)

    def value(self, ev, r, elem):
        d = {}
        for k, vp in self.items:
            v = vp.value(ev, r, elem)
            if v is UNDEF:
                return UNDEF
            d[k] = v
        from ..rego.values import Obj

        return Obj(d)


# ---------------------------------------------------------------------------
# plan construction (compile time)


def build_plan(comp, hv) -> Optional[RVal]:
    """Symbolic head value -> render plan, or None if any part is not
    provably exactly renderable. `comp` is the symbolic.Compiler (for
    pattern segs). A failed plan must NEVER affect compilation — the
    SVal accessors this walks (vid/exists/kindv) can raise
    CompileUnsupported on shapes the count path never materializes, and
    leaking that would demote an exact program to a screen."""
    try:
        return _plan(comp, hv)
    except _CantRender:
        return None
    except Exception:
        return None


def _plan(comp, hv) -> RVal:
    # local imports: symbolic imports this module
    from .symbolic import (
        SConst,
        SDerived,
        SKey,
        SMsg,
        SNode,
        SScalar,
        STokenSet,
    )

    if isinstance(hv, SConst):
        try:
            return RConst(freeze(hv.value))
        except TypeError:
            raise _CantRender("unfreezable const")
    if isinstance(hv, SScalar):
        if hv.num_override is not None:
            raise _CantRender("derived-number slot")
        return RScalar(
            vid=hv.vid(), kind=hv.kindv(), exists=hv.exists(), space=hv.space
        )
    if isinstance(hv, SKey):
        ids = hv.ids()
        return RKey(ids=ids, space=ids.space)
    if isinstance(hv, SNode):
        segs = tuple(
            "#" if s == "#" else unesc_seg(s) for s in hv.prefix
        )
        return RPath(segs=segs, n_holes=sum(1 for s in segs if s == "#"))
    if isinstance(hv, STokenSet):
        return RTokSet(mask=hv.mask, elem_ids=hv.elem_ids, axes=hv.axes)
    if isinstance(hv, SDerived):
        r = getattr(hv, "render", None)
        if r is not None and r[0] == "constdiff":
            _, const_elems, tokset = r
            return RSetDiff(
                const=frozenset(freeze(x) for x in const_elems),
                tokset=_plan(comp, tokset),
            )
        raise _CantRender("derived value")
    if isinstance(hv, SMsg):
        parts = getattr(hv, "parts", None)
        if parts is None and hv.recipe is not None:
            parts = ("sprintf", hv.recipe[0], (hv.recipe[1],))
        if parts is None:
            raise _CantRender("opaque message")
        if parts[0] == "sprintf":
            _, fmt, args = parts
            return RSprintf(
                fmt=fmt, args=tuple(_plan(comp, a) for a in args)
            )
        if parts[0] == "obj":
            _, items = parts
            return RObj(
                items=tuple(
                    (freeze(k), _plan(comp, v)) for k, v in items
                )
            )
        raise _CantRender(f"message parts {parts[0]}")
    # SList loses its array-vs-set kind in symbolic form; SDerived
    # without render info, SBool, etc. — all route to the interpreter
    raise _CantRender(f"head value {type(hv).__name__}")


# ---------------------------------------------------------------------------
# branch metadata stored on compiled programs


@dataclass
class Branch:
    """One grouped violation branch of an exact program."""

    space: Tuple[str, ...]
    cond: Expr  # WITHOUT safety flags: true <=> violation at element
    plan: Optional[RVal]  # None => interpreter renders this branch


# ---------------------------------------------------------------------------
# render-time evaluation


class _BranchEval:
    """Per-(program, row-subset) expression evaluation context."""

    def __init__(self, ctx: EvalCtx, vocab, g1: int):
        self.ctx = ctx
        self.vocab = vocab
        self.g1 = g1
        self.review: Any = None
        self._cache: Dict[Tuple[int, Tuple[str, ...]], np.ndarray] = {}
        self._cond_space: Tuple[str, ...] = ()
        self.idx0 = np.asarray(ctx.tok["idx0"])

    def set_element_space(self, space: Tuple[str, ...]) -> None:
        self._cond_space = space

    def g_indices(self, elem: Tuple[int, ...]) -> Tuple[int, ...]:
        """Element multi-index -> first/second-level array indices."""
        out: List[int] = []
        for ax, e in zip(self._cond_space, elem):
            if ax == "g0":
                out.append(int(e))
            elif ax == "g01":
                out.append(int(e) // self.g1)
                out.append(int(e) % self.g1)
            # "tok" contributes no array index
        return tuple(out)

    def arr_raw(self, expr: Expr) -> np.ndarray:
        return np.asarray(expr.emit(self.ctx))

    def arr(self, expr: Expr, space: Tuple[str, ...]) -> np.ndarray:
        """Evaluate and expand to [n, *element dims] of the current
        element space (scalar/ELit results broadcast too)."""
        key = (id(expr), self._cond_space)
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        raw = expr.emit(self.ctx)
        v = np.asarray(raw)
        target = self._cond_space
        want = (self.ctx.n,) + tuple(_axlen(self.ctx, a) for a in target)
        try:
            if v.ndim == 0:
                v = np.broadcast_to(v, want)
            elif space == () and target:
                v = np.broadcast_to(
                    v.reshape(v.shape + (1,) * len(target)), want
                )
            else:
                if space != target:
                    # expand the torch value, then leave torch
                    v = np.asarray(_expand(self.ctx, raw, space, target))
                v = np.broadcast_to(v, want)
        except ValueError:
            raise _CantRender(f"expand {space} -> {target}")
        self._cache[key] = v
        return v


def _axlen(ctx: EvalCtx, ax: str) -> int:
    return {
        "tok": ctx.l,
        "g0": ctx.g0,
        "g1": ctx.g1,
        "g01": ctx.g0 * ctx.g1,
    }[ax]


class RenderSet:
    """Renders violation objects for one exact program over a row
    subset. `render_row` returns the row's frozen violation objects in
    interpreter order, or None when the pair must fall back."""

    def __init__(
        self,
        program,
        ctx: EvalCtx,
        vocab,
    ):
        self.program = program
        self.ev = _BranchEval(ctx, vocab, ctx.g1)
        self._conds: List[np.ndarray] = []
        # flags: any true -> the row routes to the interpreter
        flagged = np.zeros((ctx.n,), bool)
        for f in program.flags or ():
            v = np.asarray(f.emit(ctx))
            while v.ndim > 1:
                v = v.any(axis=-1)
            flagged |= v
        self.flagged = flagged
        for br in program.branches or ():
            self._conds.append(np.asarray(br.cond.emit(ctx)))

    def render_row(self, r: int, review: Any) -> Optional[List[Any]]:
        if self.flagged[r]:
            return None
        self.ev.review = review
        objs: List[Any] = []
        seen = set()
        try:
            for br, cond in zip(self.program.branches, self._conds):
                row = cond[r]
                if row.ndim == 0:
                    elems = [()] if row else []
                else:
                    elems = [tuple(e) for e in np.argwhere(row)]
                if not elems:
                    continue
                if br.plan is None:
                    return None
                self.ev.set_element_space(br.space)
                for e in elems:
                    v = br.plan.value(self.ev, r, e)
                    if v is UNDEF:
                        continue
                    if v in seen:
                        continue
                    seen.add(v)
                    objs.append(v)
        except _CantRender:
            return None
        objs.sort(key=sort_key)
        return objs
