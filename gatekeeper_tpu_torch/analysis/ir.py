# Copied from gatekeeper_tpu/analysis/ir.py; only these edits differ.
# Edit: the docstring's first paragraph names the corpus plane, not the
# change that added it.
"""Program-IR static analysis: feature liveness, abstract
interpretation, and residual-specialization certificates.

The corpus plane makes the *policy set* analyzable (GK-C0xx corpus diagnostics);
this plane analyzes the compiled *programs* themselves — the Expr DAGs
`engine/symbolic.py` emits per (template, constraint-params) pair, with
the constraint's concrete `parameters` burned in as abstract constants.
Three artifacts come out of one walk:

  1. **Feature-liveness masks** — the exact set of schema-path patterns
     a program population can ever read. A token whose path matches no
     live pattern is *provably dead*: no `ESelPattern`/`ECapture` gate
     ever selects it, so the encoder may drop it before padding and the
     host-side flatten/encode cost (ROADMAP item 1's fixed per-batch
     tax) shrinks with it. Soundness rests on PAD EQUIVALENCE, proved
     per program (see `program_liveness`): dropping a dead token is
     indistinguishable from turning it into one more pad slot, and
     compiled programs are already pad-count-invariant (bucketed L/G
     padding varies batch to batch in production).

  2. **GK-P0xx diagnostics** through the same report/CLI/baseline
     machinery as the template (GK-Vxxx) and corpus (GK-Cxxx) planes:
     always-true / never-firing rules, parameters that provably cannot
     affect the verdict, interval-provable no-op checks, unreachable
     render branches, and the exact `CompileUnsupported` reason-code
     taxonomy for templates off the fused path.

  3. **Specialization certificates** — branches provably foldable under
     the current corpus (condition abstractly constant), handed to the
     planner as the foundation for residual sub-programs.

The abstract domain is a constant + interval + nullability product
(`AbsVal`): every transfer function over-approximates the concrete
numpy/jax semantics of `engine/exprs.py`, so a `const`/interval claim
is a proof, never a heuristic. Diagnostics here are advisory (the
baseline contract pins them); the *liveness* result feeds the serving
path, which is why `program_liveness` refuses (keep-all) rather than
guesses whenever pad equivalence cannot be established.

Code allocation note: GK-P001..P006 belong to the provider lint; the
IR plane starts at GK-P010 to keep the GK-P namespace collision-free.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import (
    Any,
    Callable,
    Dict,
    FrozenSet,
    Iterable,
    Iterator,
    List,
    Optional,
    Set,
    Tuple,
)

import numpy as np

from ..engine.exprs import (
    ECapture,
    EConstSlot,
    EFullN,
    EGatherElem,
    EGroup,
    EGroupPresent,
    EIsInConst,
    ELit,
    EMap,
    EReduce,
    EReduceAxis,
    ERowFeature,
    ESelPattern,
    EStrTable,
    ETokCol,
    Expr,
)
from ..engine.programs import Program

__all__ = [
    "IR_CODES",
    "IrDiagnostic",
    "IrLint",
    "IrReport",
    "Certificate",
    "ProgramLiveness",
    "analyze_program",
    "corpus_liveness",
    "ir_from_docs",
    "ir_from_programs",
    "pattern_reads",
    "program_liveness",
    "row_feature_pids",
]


# stable code -> (severity, one-line meaning). Like the corpus plane,
# ANY diagnostic flags the subject for baseline purposes; severity is
# reader-facing triage only.
IR_CODES: Dict[str, Tuple[str, str]] = {
    "GK-P010": ("warn", "violation rule provably fires on every row"),
    "GK-P011": ("warn", "violation rule provably never fires"),
    "GK-P012": ("info", "constraint parameter cannot affect the verdict"),
    "GK-P013": ("info", "interval-provable no-op check"),
    "GK-P014": ("info", "unreachable violation branch"),
    "GK-P015": ("info", "template off the fused path (reason code)"),
    "GK-P016": ("info", "program not liveness-maskable (keep-all)"),
}


@dataclass
class IrDiagnostic:
    """One IR finding, attached to one subject."""

    code: str
    subject: str  # "template:<Kind>" | "constraint:<Kind>/<name>"
    message: str
    path: str = ""  # provenance (branch index, const slot, ...)

    @property
    def severity(self) -> str:
        return IR_CODES.get(self.code, ("error", ""))[0]

    def to_dict(self) -> Dict[str, Any]:
        out = {
            "code": self.code,
            "severity": self.severity,
            "subject": self.subject,
            "message": self.message,
        }
        if self.path:
            out["path"] = self.path
        return out

    def render(self) -> str:
        where = f" @ {self.path}" if self.path else ""
        return f"[{self.code}] {self.subject}{where}: {self.message}"


@dataclass
class IrLint:
    """Per-subject rollup (the CorpusLint shape the CLI baseline
    machinery expects: id, source, codes, ok, render)."""

    id: str
    source: str = ""
    diagnostics: List[IrDiagnostic] = field(default_factory=list)

    def add(self, diag: IrDiagnostic) -> None:
        for d in self.diagnostics:
            if d.code == diag.code and d.message == diag.message:
                return
        self.diagnostics.append(diag)

    @property
    def codes(self) -> List[str]:
        return sorted({d.code for d in self.diagnostics})

    @property
    def ok(self) -> bool:
        return not self.diagnostics

    def to_dict(self) -> Dict[str, Any]:
        return {
            "id": self.id,
            "source": self.source,
            "ok": self.ok,
            "codes": self.codes,
            "diagnostics": [d.to_dict() for d in self.diagnostics],
        }

    def render(self) -> str:
        if self.ok:
            return f"{self.id}: ok"
        lines = [f"{self.id}:"]
        for d in self.diagnostics:
            lines.append(f"  {d.render()}")
        return "\n".join(lines)


@dataclass
class Certificate:
    """Residual-specialization certificate: one branch of one compiled
    program is provably foldable under the current corpus. `fold` is
    "dead" (condition constant False: the branch can be dropped from a
    residual sub-program) or "always" (constant True: the condition
    test can be elided). Consumed by the planner as metadata only —
    nothing in the serving path acts on a certificate yet."""

    subject: str
    kind: str
    branch: int
    fold: str  # "dead" | "always"

    def to_dict(self) -> Dict[str, Any]:
        return {
            "subject": self.subject,
            "kind": self.kind,
            "branch": self.branch,
            "fold": self.fold,
        }


@dataclass
class IrReport:
    """Whole-corpus IR outcome: per-subject lints + the serving feeds."""

    lints: List[IrLint] = field(default_factory=list)
    certificates: List[Certificate] = field(default_factory=list)
    # subject -> "exact" | "screen" | "interpreter:<reason-slug>"
    fused: Dict[str, str] = field(default_factory=dict)
    # corpus feature-liveness summary (see corpus_liveness)
    liveness: Dict[str, Any] = field(default_factory=dict)
    subjects: int = 0

    def lint_for(self, subject_id: str, source: str = "") -> IrLint:
        for lint in self.lints:
            if lint.id == subject_id:
                return lint
        lint = IrLint(id=subject_id, source=source)
        self.lints.append(lint)
        return lint

    @property
    def diagnostics(self) -> List[IrDiagnostic]:
        return [d for lint in self.lints for d in lint.diagnostics]

    @property
    def codes(self) -> List[str]:
        return sorted({d.code for d in self.diagnostics})

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for d in self.diagnostics:
            out[d.code] = out.get(d.code, 0) + 1
        return out

    @property
    def ok(self) -> bool:
        return all(lint.ok for lint in self.lints)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "subjects": self.subjects,
            "ok": self.ok,
            "counts": self.counts(),
            "fused": dict(sorted(self.fused.items())),
            "liveness": self.liveness,
            "certificates": [c.to_dict() for c in self.certificates],
            "lints": [lint.to_dict() for lint in self.lints],
        }

    def render(self) -> str:
        lines = []
        for lint in self.lints:
            if not lint.ok:
                lines.append(lint.render())
        counts = self.counts()
        summary = ", ".join(
            f"{c}={counts[c]}" for c in sorted(counts)
        ) or "clean"
        live = self.liveness or {}
        lines.append(
            f"ir: {self.subjects} subject(s), {summary}; "
            f"maskable={live.get('maskable', 0)}/"
            f"{live.get('programs', 0)} "
            f"live_patterns={live.get('live_patterns')} "
            f"certificates={len(self.certificates)}"
        )
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# IR walking


def _expr_children(e: Expr) -> Tuple[Expr, ...]:
    if isinstance(e, (EStrTable, EIsInConst)):
        return (e.ids,)
    if isinstance(e, EMap):
        return tuple(e.args)
    if isinstance(e, (EReduce, EReduceAxis)):
        return (e.child,)
    if isinstance(e, EGroup):
        return (e.mask,) if e.value is None else (e.mask, e.value)
    if isinstance(e, EGroupPresent):
        return (e.mask,)
    if isinstance(e, EGatherElem):
        return (e.elem,)
    return ()


def _iter_dag(roots: Iterable[Expr]) -> Iterator[Expr]:
    """Every node of the DAGs under `roots`, each exactly once."""
    seen: Set[int] = set()
    stack = [r for r in roots if isinstance(r, Expr)]
    while stack:
        e = stack.pop()
        if id(e) in seen:
            continue
        seen.add(id(e))
        yield e
        stack.extend(_expr_children(e))


def _plan_exprs(obj: Any, out: List[Expr], toksets: List[Any]) -> None:
    """Collect Expr leaves (and RTokSet plan nodes) from a render plan
    tree (engine/render.py RVal dataclasses), structure-generically so
    new plan node kinds degrade to 'walk their fields' instead of
    silently hiding reads."""
    if obj is None or isinstance(obj, (str, bytes, int, float, bool)):
        return
    if isinstance(obj, Expr):
        out.append(obj)
        return
    if isinstance(obj, (list, tuple, set, frozenset)):
        for x in obj:
            _plan_exprs(x, out, toksets)
        return
    if isinstance(obj, dict):
        for x in obj.values():
            _plan_exprs(x, out, toksets)
        return
    if type(obj).__name__ == "RTokSet":
        toksets.append(obj)
    d = getattr(obj, "__dict__", None)
    if d is not None and type(obj).__module__.endswith("engine.render"):
        for x in d.values():
            _plan_exprs(x, out, toksets)


def _program_roots(
    program: Program,
) -> Tuple[List[Expr], List[Expr], List[Any]]:
    """-> (all root exprs, render-sensitive roots needing the
    pad-equivalence proof at EQ level, RTokSet plan nodes needing it at
    EQ_FALSE level). The count expr is always first."""
    roots: List[Expr] = [program.expr]
    guarded: List[Expr] = []
    toksets: List[Any] = []
    for f in program.flags or ():
        roots.append(f)
        guarded.append(f)
    for br in program.branches or ():
        cond = getattr(br, "cond", None)
        if isinstance(cond, Expr):
            roots.append(cond)
            guarded.append(cond)
        plan = getattr(br, "plan", None)
        extra: List[Expr] = []
        _plan_exprs(plan, extra, toksets)
        roots.extend(extra)
    for ts in toksets:
        for attr in ("mask", "elem_ids"):
            e = getattr(ts, attr, None)
            if isinstance(e, Expr):
                roots.append(e)
    return roots, guarded, toksets


def pattern_reads(program: Program) -> FrozenSet[int]:
    """Every pattern index the program can gate a token read through
    (ESelPattern membership and ECapture capture gathers), across the
    count expr, safety flags, render branch conditions, and render
    plans."""
    roots, _, _ = _program_roots(program)
    out: Set[int] = set()
    for e in _iter_dag(roots):
        if isinstance(e, (ESelPattern, ECapture)):
            out.add(e.pattern_idx)
    return frozenset(out)


def row_feature_pids(names: Iterable[str]) -> FrozenSet[int]:
    """Pattern indices probed by per-row feature planes. The
    "invdup:<leaf>:<mirror>:<se>:<g+g+...>" features gather tokens at
    the leaf, mirror, and guard patterns over the encoded corpus
    (TpuDriver._row_feature_bits), so those patterns must stay live;
    "extdata:*" features read raw reviews, never the token table."""
    out: Set[int] = set()
    for name in names:
        if not name.startswith("invdup:"):
            continue
        parts = name.split(":")
        if len(parts) < 5:
            continue
        try:
            out.add(int(parts[1]))
            out.add(int(parts[2]))
            out.update(int(x) for x in parts[4].split("+") if x)
        except ValueError:
            continue
    return frozenset(out)


# ---------------------------------------------------------------------------
# Pad-equivalence liveness proof
#
# Masked encoding drops tokens matching no live pattern. That is sound
# for a program iff every token-space intermediate takes the SAME value
# at a dead token as at a pad slot (spath=idx0=idx1=kind=vid=-1,
# vnum=0): then the masked table is just the unmasked table with dead
# slots turned into (fewer) pad slots, and compiled programs are
# already pad-count-invariant — L and G buckets vary per batch in
# production, so any reduction's pad contribution is necessarily its
# identity. We prove per-node a three-point attribute:
#
#   EQF  value is False/0 at dead tokens AND at pad slots
#   EQV  value is equal at dead tokens and pad slots (possibly unknown)
#   NEQ  no proof (e.g. raw ETokCol columns: kind differs from -1)
#
# and require EQV at every token-axis-eliminating site (EReduce /
# EReduceAxis over "tok") and EQF for every EGroup/EGroupPresent mask
# (group scatters read idx0/idx1, which DO differ between dead and pad,
# so the mask itself must disable dead slots) and every render RTokSet
# mask (set enumeration has no pad-correctness argument to lean on).
# Any violation makes the program non-maskable: the corpus falls back
# to keep-all encoding, which is always parity-safe.

EQF, EQV, NEQ = 0, 1, 2


def _pad_dp(
    e: Expr, memo: Dict[int, int], violations: List[str]
) -> int:
    hit = memo.get(id(e))
    if hit is not None:
        return hit
    memo[id(e)] = EQV  # cycle guard (DAGs only, but stay safe)
    d = _pad_dp_compute(e, memo, violations)
    memo[id(e)] = d
    return d


def _pad_dp_compute(
    e: Expr, memo: Dict[int, int], violations: List[str]
) -> int:
    if isinstance(e, ESelPattern):
        # live patterns never match a dead token's path; pads fail the
        # spath >= 0 gate
        return EQF
    if isinstance(e, ECapture):
        return EQV  # -1 at dead (no match) and at pad (spath gate)
    if isinstance(e, ETokCol):
        return NEQ
    if isinstance(e, (ELit, EFullN, EConstSlot, ERowFeature)):
        return EQV
    if isinstance(e, EStrTable):
        d = _pad_dp(e.ids, memo, violations)
        if d == NEQ:
            return NEQ
        # captured-id lookups read row -1 -> default at dead AND pad
        if isinstance(e.ids, ECapture) and not e.default:
            return EQF
        return EQV
    if isinstance(e, EIsInConst):
        d = _pad_dp(e.ids, memo, violations)
        if d == NEQ:
            return NEQ
        # const member sets exclude the -1 pad sentinel by construction
        if isinstance(e.ids, ECapture):
            return EQF
        return EQV
    if isinstance(e, EMap):
        ds = [_pad_dp(a, memo, violations) for a in e.args]
        if e.name == "maskfill":
            # IR contract with engine/symbolic.py: args = [mask, value],
            # result is a constant fill wherever mask is False. A mask
            # that is provably False at both dead and pad slots makes
            # the output the fill constant at both, whatever the value
            # column does there.
            if ds[0] == EQF:
                return EQV
            return EQV if all(d != NEQ for d in ds) else NEQ
        if e.name == "and":
            if any(d == EQF for d in ds):
                return EQF
            return EQV if all(d != NEQ for d in ds) else NEQ
        if e.name == "or":
            if all(d == EQF for d in ds):
                return EQF
            return EQV if all(d != NEQ for d in ds) else NEQ
        # not / cmp* / arith* / where / generic elementwise: equal
        # inputs give equal outputs
        return EQV if all(d != NEQ for d in ds) else NEQ
    if isinstance(e, EReduce):
        d = _pad_dp(e.child, memo, violations)
        if e.child.space and e.child.space[-1] == "tok":
            if d == NEQ:
                violations.append(
                    f"reduce-{e.how} over tok axis of a value that "
                    "differs between dead and pad tokens"
                )
            return EQV
        return d
    if isinstance(e, EReduceAxis):
        d = _pad_dp(e.child, memo, violations)
        if e.axis == "tok":
            if d == NEQ:
                violations.append(
                    f"reduce-{e.how} over named tok axis of a value "
                    "that differs between dead and pad tokens"
                )
            return EQV
        return d
    if isinstance(e, (EGroup, EGroupPresent)):
        dm = _pad_dp(e.mask, memo, violations)
        if dm != EQF:
            violations.append(
                "group scatter mask not provably False at dead tokens "
                "(idx0/idx1 differ between dead and pad)"
            )
        if isinstance(e, EGroup) and e.value is not None:
            # value is only read where the mask holds, but walk it for
            # nested violations all the same
            _pad_dp(e.value, memo, violations)
        return EQV
    if isinstance(e, EGatherElem):
        _pad_dp(e.elem, memo, violations)
        return NEQ  # gathers through idx0/idx1: dead != pad (default)
    # unknown node kind: refuse to certify anything about it
    violations.append(f"unknown IR node {type(e).__name__}")
    return NEQ


@dataclass
class ProgramLiveness:
    """Per-program liveness verdict: the pattern read set, and whether
    the pad-equivalence proof went through (maskable=False forces
    keep-all encoding for any corpus containing this program)."""

    pids: FrozenSet[int]
    maskable: bool
    violations: Tuple[str, ...] = ()


def program_liveness(program: Program) -> ProgramLiveness:
    roots, guarded, toksets = _program_roots(program)
    memo: Dict[int, int] = {}
    violations: List[str] = []
    # the full walk (count expr first) surfaces reduction/group/unknown
    # violations everywhere
    for r in roots:
        _pad_dp(r, memo, violations)
    # render-sensitive roots: branch conds and safety flags are
    # host-reduced over the token axes, so they need the proof at their
    # own top level too
    for g in guarded:
        if "tok" in g.space and _pad_dp(g, memo, violations) == NEQ:
            violations.append(
                "render branch condition / safety flag differs between "
                "dead and pad tokens"
            )
    for ts in toksets:
        mask = getattr(ts, "mask", None)
        if isinstance(mask, Expr) and (
            _pad_dp(mask, memo, violations) != EQF
        ):
            violations.append(
                "render token-set mask not provably False at dead tokens"
            )
    pids = frozenset(
        e.pattern_idx
        for e in _iter_dag(roots)
        if isinstance(e, (ESelPattern, ECapture))
    )
    return ProgramLiveness(
        pids=pids,
        maskable=not violations,
        violations=tuple(dict.fromkeys(violations)),
    )


def corpus_liveness(
    programs: Iterable[Optional[Program]],
    extra_pids: Iterable[int] = (),
) -> Optional[FrozenSet[int]]:
    """Union liveness over a program population sharing one encoded
    corpus. Returns the live pattern-index set, or None when any
    program is non-maskable (keep-all: encode everything). Interpreter
    -routed constraints (None programs) read raw reviews, never the
    token table, so they do not constrain liveness."""
    live: Set[int] = set(extra_pids)
    for p in programs:
        if p is None:
            continue
        pl = program_liveness(p)
        if not pl.maskable:
            return None
        live |= pl.pids
        live |= row_feature_pids(p.row_features)
    return frozenset(live)


# ---------------------------------------------------------------------------
# Abstract interpretation (constant + interval + nullability)

_INF = math.inf


@dataclass(frozen=True)
class AbsVal:
    """Abstract value: interval [lo, hi] over the numeric reading of
    the node (bools as 0/1), `const` when the value is provably the
    same everywhere, `maybe_absent` when some lattice point is the
    pad/default sentinel rather than document data (the nullability
    bit: a `const` claim with maybe_absent=True still means every
    element equals const, sentinel included)."""

    lo: float = -_INF
    hi: float = _INF
    const: Optional[float] = None
    maybe_absent: bool = False

    @staticmethod
    def constant(v: Any, maybe_absent: bool = False) -> "AbsVal":
        f = float(v)
        return AbsVal(lo=f, hi=f, const=f, maybe_absent=maybe_absent)

    @staticmethod
    def interval(
        lo: float, hi: float, maybe_absent: bool = False
    ) -> "AbsVal":
        if lo == hi and not math.isinf(lo):
            return AbsVal(lo=lo, hi=hi, const=lo, maybe_absent=maybe_absent)
        return AbsVal(lo=lo, hi=hi, maybe_absent=maybe_absent)

    def join(self, other: "AbsVal") -> "AbsVal":
        const = (
            self.const
            if self.const is not None and self.const == other.const
            else None
        )
        out = AbsVal(
            lo=min(self.lo, other.lo),
            hi=max(self.hi, other.hi),
            const=const,
            maybe_absent=self.maybe_absent or other.maybe_absent,
        )
        return out


TOP = AbsVal()
BOOL = AbsVal(lo=0.0, hi=1.0)


def _abs_const_slot(consts: Dict[str, np.ndarray], slot: str) -> AbsVal:
    arr = consts.get(slot)
    if arr is None:
        return TOP
    a = np.asarray(arr)
    if a.size == 0:
        return TOP
    if a.ndim == 0:
        try:
            return AbsVal.constant(float(a))
        except (TypeError, ValueError):
            return TOP
    try:
        return AbsVal.interval(float(a.min()), float(a.max()))
    except (TypeError, ValueError):
        return TOP


_TOKCOL_BOUNDS = {
    "spath": AbsVal(lo=-1.0, hi=_INF, maybe_absent=True),
    "idx0": AbsVal(lo=-1.0, hi=_INF, maybe_absent=True),
    "idx1": AbsVal(lo=-1.0, hi=_INF, maybe_absent=True),
    "kind": AbsVal(lo=-1.0, hi=5.0, maybe_absent=True),
    "vid": AbsVal(lo=-1.0, hi=_INF, maybe_absent=True),
    "vnum": AbsVal(maybe_absent=True),
}


class _AbsInterp:
    """One abstract pass over a program's DAGs. Collects interval
    no-op findings (`noop_checks`) on the way: comparison nodes whose
    outcome is provably constant while a constraint parameter slot
    feeds the comparison."""

    def __init__(self, consts: Dict[str, np.ndarray]):
        self.consts = consts
        self.memo: Dict[int, AbsVal] = {}
        self.slot_refs: Set[str] = set()
        self.noop_checks: List[str] = []
        self._has_slot: Dict[int, bool] = {}

    def has_slot(self, e: Expr) -> bool:
        hit = self._has_slot.get(id(e))
        if hit is None:
            hit = isinstance(e, (EConstSlot, EIsInConst)) or any(
                self.has_slot(c) for c in _expr_children(e)
            )
            self._has_slot[id(e)] = hit
        return hit

    def eval(self, e: Expr) -> AbsVal:
        hit = self.memo.get(id(e))
        if hit is not None:
            return hit
        self.memo[id(e)] = TOP  # cycle guard
        v = self._eval(e)
        self.memo[id(e)] = v
        return v

    def _eval(self, e: Expr) -> AbsVal:
        if isinstance(e, (ELit, EFullN)):
            try:
                return AbsVal.constant(float(e.value))
            except (TypeError, ValueError):
                return TOP
        if isinstance(e, EConstSlot):
            self.slot_refs.add(e.slot)
            return _abs_const_slot(self.consts, e.slot)
        if isinstance(e, ERowFeature):
            return BOOL
        if isinstance(e, ETokCol):
            return _TOKCOL_BOUNDS.get(e.col, TOP)
        if isinstance(e, ESelPattern):
            return AbsVal(lo=0.0, hi=1.0, maybe_absent=True)
        if isinstance(e, ECapture):
            return AbsVal(lo=-1.0, hi=_INF, maybe_absent=True)
        if isinstance(e, EStrTable):
            self.eval(e.ids)
            try:
                default = AbsVal.constant(float(e.default))
            except (TypeError, ValueError):
                default = TOP
            return TOP.join(default)
        if isinstance(e, EIsInConst):
            self.slot_refs.add(e.slot)
            self.eval(e.ids)
            members = np.asarray(self.consts.get(e.slot, ()))
            if members.size == 0 or bool((members == -1).all()):
                # empty member set: provably False membership
                return AbsVal.constant(0.0)
            return BOOL
        if isinstance(e, EMap):
            return self._eval_map(e)
        if isinstance(e, EReduce):
            return self._eval_reduce(e.child, e.how)
        if isinstance(e, EReduceAxis):
            return self._eval_reduce(e.child, e.how)
        if isinstance(e, EGroup):
            val = (
                self.eval(e.value)
                if e.value is not None
                else self.eval(e.mask)
            )
            self.eval(e.mask)
            if e.how == "any":
                return BOOL
            if e.how == "sum":
                lo = min(0.0, val.lo)
                if val.const == 0.0:
                    return AbsVal.constant(0.0)
                return AbsVal.interval(
                    lo, _INF if val.hi > 0 else 0.0
                )
            try:
                init = AbsVal.constant(float(e.init), maybe_absent=True)
            except (TypeError, ValueError):
                init = TOP
            return val.join(init)
        if isinstance(e, EGroupPresent):
            self.eval(e.mask)
            return BOOL
        if isinstance(e, EGatherElem):
            v = self.eval(e.elem)
            try:
                default = AbsVal.constant(
                    float(e.default), maybe_absent=True
                )
            except (TypeError, ValueError):
                default = TOP
            return v.join(default)
        return TOP

    def _eval_map(self, e: EMap) -> AbsVal:
        vs = [self.eval(a) for a in e.args]
        name = e.name
        if name == "and":
            if any(v.const == 0.0 for v in vs):
                return AbsVal.constant(0.0)
            if all(v.const is not None and v.const != 0.0 for v in vs):
                return AbsVal.constant(1.0)
            return BOOL
        if name == "or":
            if any(v.const is not None and v.const != 0.0 for v in vs):
                return AbsVal.constant(1.0)
            if all(v.const == 0.0 for v in vs):
                return AbsVal.constant(0.0)
            return BOOL
        if name == "not":
            (v,) = vs
            if v.const is not None:
                return AbsVal.constant(0.0 if v.const != 0.0 else 1.0)
            return BOOL
        if name.startswith("cmp") and len(vs) == 2:
            out = _abs_cmp(name[3:], vs[0], vs[1])
            if out.const is not None and any(
                self.has_slot(a) for a in e.args
            ):
                self.noop_checks.append(
                    f"{name[3:]} comparison is constant "
                    f"{'True' if out.const else 'False'}"
                )
            return out
        if name.startswith("arith") and len(vs) == 2:
            return _abs_arith(name[5:], vs[0], vs[1])
        if name == "where" and len(vs) == 3:
            c, t, f = vs
            if c.const is not None:
                return t if c.const != 0.0 else f
            return t.join(f)
        return TOP

    def _eval_reduce(self, child: Expr, how: str) -> AbsVal:
        v = self.eval(child)
        if how in ("any", "all"):
            if v.const is not None:
                return AbsVal.constant(0.0 if v.const == 0.0 else 1.0)
            return BOOL
        if how == "sum":
            if v.const == 0.0:
                return AbsVal.constant(0.0)
            lo = 0.0 if v.lo >= 0 else -_INF
            hi = 0.0 if v.hi <= 0 else _INF
            return AbsVal.interval(lo, hi)
        if how == "max":
            return AbsVal.interval(v.lo, v.hi, maybe_absent=v.maybe_absent)
        return TOP


def _abs_cmp(op: str, a: AbsVal, b: AbsVal) -> AbsVal:
    if a.const is not None and b.const is not None:
        res = {
            "==": a.const == b.const,
            "!=": a.const != b.const,
            "<": a.const < b.const,
            "<=": a.const <= b.const,
            ">": a.const > b.const,
            ">=": a.const >= b.const,
        }.get(op)
        if res is not None:
            return AbsVal.constant(1.0 if res else 0.0)
    if op in ("<", "<="):
        if a.hi < b.lo or (op == "<=" and a.hi <= b.lo):
            return AbsVal.constant(1.0)
        if a.lo > b.hi or (op == "<" and a.lo >= b.hi):
            return AbsVal.constant(0.0)
    if op in (">", ">="):
        if a.lo > b.hi or (op == ">=" and a.lo >= b.hi):
            return AbsVal.constant(1.0)
        if a.hi < b.lo or (op == ">" and a.hi <= b.lo):
            return AbsVal.constant(0.0)
    if op == "==" and (a.hi < b.lo or b.hi < a.lo):
        return AbsVal.constant(0.0)
    if op == "!=" and (a.hi < b.lo or b.hi < a.lo):
        return AbsVal.constant(1.0)
    return BOOL


def _abs_arith(op: str, a: AbsVal, b: AbsVal) -> AbsVal:
    if a.const is not None and b.const is not None:
        try:
            res = {
                "+": a.const + b.const,
                "-": a.const - b.const,
                "*": a.const * b.const,
            }.get(op)
            if res is None and op == "/" and b.const != 0:
                res = a.const / b.const
            if res is None and op == "%" and b.const != 0:
                res = a.const % b.const
            if res is not None:
                return AbsVal.constant(res)
        except (OverflowError, ZeroDivisionError):
            return TOP
    if op == "+":
        return AbsVal.interval(a.lo + b.lo, a.hi + b.hi)
    if op == "-":
        return AbsVal.interval(a.lo - b.hi, a.hi - b.lo)
    return TOP


def analyze_program(
    subject: str,
    kind: str,
    program: Program,
    params: Any = None,
) -> Tuple[List[IrDiagnostic], List[Certificate]]:
    """Abstract-interpret one compiled program; -> (diagnostics,
    specialization certificates)."""
    diags: List[IrDiagnostic] = []
    certs: List[Certificate] = []
    interp = _AbsInterp(program.consts)
    final = interp.eval(program.expr)
    for f in program.flags or ():
        interp.eval(f)
    branch_vals: List[Optional[AbsVal]] = []
    for br in program.branches or ():
        cond = getattr(br, "cond", None)
        branch_vals.append(
            interp.eval(cond) if isinstance(cond, Expr) else None
        )
    screen_note = " (screen: over-approximate)" if program.screen else ""
    if final.lo >= 1.0:
        diags.append(
            IrDiagnostic(
                code="GK-P010",
                subject=subject,
                message=(
                    "violation count is provably >= "
                    f"{int(final.lo)} on every row{screen_note}"
                ),
            )
        )
    elif final.hi <= 0.0:
        diags.append(
            IrDiagnostic(
                code="GK-P011",
                subject=subject,
                message=(
                    "violation count is provably 0 on every row"
                    f"{screen_note}: rule can never fire"
                ),
            )
        )
    unused = sorted(set(program.consts) - interp.slot_refs)
    if unused:
        diags.append(
            IrDiagnostic(
                code="GK-P012",
                subject=subject,
                message=(
                    "constant slots burned from parameters but never "
                    f"read by the program: {', '.join(unused)}"
                ),
                path=f"consts[{','.join(unused)}]",
            )
        )
    for msg in dict.fromkeys(interp.noop_checks):
        diags.append(
            IrDiagnostic(
                code="GK-P013",
                subject=subject,
                message=f"no-op check: {msg}",
            )
        )
    for i, bv in enumerate(branch_vals):
        if bv is None:
            continue
        if bv.const == 0.0:
            diags.append(
                IrDiagnostic(
                    code="GK-P014",
                    subject=subject,
                    message=(
                        f"render branch {i} condition is provably "
                        "False: unreachable"
                    ),
                    path=f"branches[{i}]",
                )
            )
            certs.append(
                Certificate(
                    subject=subject, kind=kind, branch=i, fold="dead"
                )
            )
        elif bv.const is not None:
            certs.append(
                Certificate(
                    subject=subject, kind=kind, branch=i, fold="always"
                )
            )
    return diags, certs


def _analyze_into(
    report: IrReport,
    subject: str,
    kind: str,
    program: Program,
    params: Any,
) -> None:
    """Shared per-program analysis: diagnostics + certificates +
    maskability into the report."""
    lint = report.lint_for(subject)
    diags, certs = analyze_program(subject, kind, program, params)
    for d in diags:
        lint.add(d)
    report.certificates.extend(certs)
    pl = program_liveness(program)
    if not pl.maskable:
        lint.add(
            IrDiagnostic(
                code="GK-P016",
                subject=subject,
                message=(
                    "not liveness-maskable (keep-all encoding): "
                    + "; ".join(pl.violations[:3])
                ),
            )
        )


def _finish_liveness(report: IrReport, programs: List[Program]) -> None:
    live = corpus_liveness(programs)
    report.liveness = {
        "programs": len(programs),
        "maskable": sum(
            1 for p in programs if program_liveness(p).maskable
        ),
        "keep_all": live is None,
        "live_patterns": (len(live) if live is not None else None),
    }
    report.subjects = len(report.lints)
    for lint in report.lints:
        # the CLI prints `[source]` per row; the fused-path taxonomy
        # entry is the most useful provenance an IR subject has
        if not lint.source:
            lint.source = report.fused.get(lint.id, "")
    report.lints.sort(key=lambda lint: lint.id)


def ir_from_programs(
    items: Iterable[Tuple[str, str, Optional[Program], Any]],
    fallback_codes: Optional[Dict[str, str]] = None,
) -> IrReport:
    """Driver-side IR report over already-compiled programs. `items`
    is (subject, kind, Program-or-None, params); a None program is an
    interpreter-routed constraint whose fallback reason (the analyzer's
    GK-V code, from the driver's fallback table) becomes its fused-path
    taxonomy entry."""
    report = IrReport()
    programs: List[Program] = []
    for subject, kind, prog, params in items:
        lint = report.lint_for(subject)
        if prog is None:
            code = (fallback_codes or {}).get(kind) or "GK-V007"
            report.fused[subject] = f"interpreter:{code}"
            lint.add(
                IrDiagnostic(
                    code="GK-P015",
                    subject=subject,
                    message=(
                        f"off the fused path (analyzer code {code})"
                    ),
                    path=f"reason={code}",
                )
            )
            continue
        report.fused[subject] = "screen" if prog.screen else "exact"
        programs.append(prog)
        _analyze_into(report, subject, kind, prog, params)
    _finish_liveness(report, programs)
    return report


# ---------------------------------------------------------------------------
# Offline corpus runner (the CLI `ir` mode)


def _doc_kind(doc: Dict[str, Any]) -> str:
    k = doc.get("kind")
    return k if isinstance(k, str) else ""


def ir_from_docs(
    docs: Iterable[Dict[str, Any]],
    liveness_probe: Optional[Callable[[List[Program]], Any]] = None,
) -> IrReport:
    """Offline IR analysis over raw YAML docs (templates +
    constraints), mirroring corpus_from_docs' doc classification. Every
    subject gets a lint row (clean included) so the baseline pins the
    whole corpus. Compilation runs against a throwaway vocab with no
    oracle: templates whose helpers need the interpreter oracle
    off-line report the same reason taxonomy the live driver would."""
    from ..constraint import regocompile
    from ..constraint.templates import ConstraintTemplate
    from ..engine.programs import compile_program
    from ..engine.symbolic import CompilerEnv, CompileUnsupported
    from ..engine.tables import StrTables
    from ..flatten.vocab import Vocab

    docs = [d for d in docs if isinstance(d, dict)]
    templates = [d for d in docs if _doc_kind(d) == "ConstraintTemplate"]
    report = IrReport()

    vocab = Vocab()
    from ..engine.patterns import PatternRegistry

    patterns = PatternRegistry(vocab)
    tables = StrTables(vocab)

    mods_by_kind: Dict[str, Any] = {}
    for tdoc in templates:
        kind = ""
        try:
            ct = ConstraintTemplate.from_dict(tdoc)
            ct.validate_names()
            kind = ct.kind
            spec = ct.targets[0]
            mods_by_kind[kind] = regocompile.compile_template_modules(
                ct.kind, spec.target, spec.rego, spec.libs
            )
        except Exception as e:  # invalid templates: own-plane concern
            kind = kind or (
                ((tdoc.get("spec") or {}).get("crd") or {})
                .get("spec", {})
                .get("names", {})
                .get("kind", "")
            ) or "<invalid>"
            report.lint_for(f"template:{kind}").add(
                IrDiagnostic(
                    code="GK-P015",
                    subject=f"template:{kind}",
                    message=f"template did not parse: {e}",
                    path="reason=other",
                )
            )
            report.fused[f"template:{kind}"] = "interpreter:other"

    constraints = [
        d for d in docs if _doc_kind(d) in mods_by_kind
    ]

    def _compile(kind: str, params: Any, subject: str):
        env = CompilerEnv(
            vocab,
            patterns,
            tables,
            oracle_fn=None,
            oracle_ns=f"ir|{subject}",
            oracle_ns_shared=f"ir|{kind}",
            template_kind=kind,
        )
        return compile_program(env, mods_by_kind[kind], params)

    programs: List[Program] = []
    for kind, mods in sorted(mods_by_kind.items()):
        tsub = f"template:{kind}"
        lint = report.lint_for(tsub)
        try:
            tprog = _compile(kind, {}, tsub)
            report.fused[tsub] = "screen" if tprog.screen else "exact"
        except CompileUnsupported as e:
            slug = getattr(getattr(e, "code", None), "value", "other")
            report.fused[tsub] = f"interpreter:{slug}"
            lint.add(
                IrDiagnostic(
                    code="GK-P015",
                    subject=tsub,
                    message=f"off the fused path: {e} (reason={slug})",
                    path=f"reason={slug}",
                )
            )
        except Exception as e:
            report.fused[tsub] = "interpreter:other"
            lint.add(
                IrDiagnostic(
                    code="GK-P015",
                    subject=tsub,
                    message=f"compilation failed: {e}",
                    path="reason=other",
                )
            )

    for cdoc in sorted(
        constraints,
        key=lambda d: (
            _doc_kind(d),
            str((d.get("metadata") or {}).get("name", "")),
        ),
    ):
        kind = _doc_kind(cdoc)
        name = str((cdoc.get("metadata") or {}).get("name", ""))
        subject = f"constraint:{kind}/{name}"
        lint = report.lint_for(subject)
        params = (cdoc.get("spec") or {}).get("parameters") or {}
        try:
            prog = _compile(kind, params, subject)
            report.fused[subject] = "screen" if prog.screen else "exact"
        except CompileUnsupported as e:
            slug = getattr(getattr(e, "code", None), "value", "other")
            report.fused[subject] = f"interpreter:{slug}"
            lint.add(
                IrDiagnostic(
                    code="GK-P015",
                    subject=subject,
                    message=f"off the fused path: {e} (reason={slug})",
                    path=f"reason={slug}",
                )
            )
            continue
        except Exception as e:
            report.fused[subject] = "interpreter:other"
            lint.add(
                IrDiagnostic(
                    code="GK-P015",
                    subject=subject,
                    message=f"compilation failed: {e}",
                    path="reason=other",
                )
            )
            continue
        programs.append(prog)
        _analyze_into(report, subject, kind, prog, params)

    _finish_liveness(report, programs)
    report.liveness["patterns_total"] = patterns.n_patterns
    if liveness_probe is not None:
        liveness_probe(programs)
    return report
