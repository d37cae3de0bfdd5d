# Copied from gatekeeper_tpu/engine/symbolic.py; only imports and the edits noted in this header differ.
# Edit: EMap lambdas emit through engine/xp.py (torch) instead of a
# numpy-like module: `.astype(np.int32)` becomes `xp.astype(v, xp.int32)`.
"""Rego-subset → vectorized program compiler (symbolic partial evaluation).

Compiles ConstraintTemplate `violation` rules into Expr DAGs over the
token table, per (template, constraint-parameters) pair. The strategy is
partial evaluation: `input.parameters` is the constraint's concrete params
value, `input.review` is an abstract document backed by token patterns,
and rule bodies execute symbolically — concrete subterms fold at compile
time, review-dependent subterms emit vectorized ops.

Design decisions (see SURVEY.md §7 "hard parts"):
  * The program is a violation DETECTOR/COUNTER: it returns violations per
    resource. Messages are rendered host-side by re-evaluating only the
    ≤`--constraint-violations-limit` reported pairs with the interpreter,
    so message fidelity never constrains the kernel.
  * Document iteration is LAZY: `containers[_]` extends the abstract path
    with "#" and the array axis only materializes at leaf reads, with an
    occupancy guard per axis. Iterations fork into an array branch ("#")
    and an object branch ("*" token axis) — real data matches exactly one,
    so the other contributes zero.
  * Pure string work (regex, prefixes, to_number, helper fns like
    canonify_cpu) happens per distinct vocab entry on the host
    (tables.py), never on device.
  * Per-constraint constants land in a ConstPool (padded to power-of-two
    buckets), so constraints of the same template with the same control
    flow share one compiled program, called with different const tensors.
  * Anything outside the subset raises CompileUnsupported; the driver
    routes that template to the interpreter (hybrid routing, SURVEY.md §7).

Documented approximations (differential-tested to be unobservable on the
reference library with well-formed K8s objects):
  * Rego set-of-violations dedup across IDENTICAL {msg, details} objects
    is not replicated — counts assume distinct messages (library messages
    embed container/key names).
  * count() of token-derived sets counts tokens, not distinct values.
  * Device numeric comparisons are float32.
"""

from __future__ import annotations

import enum
import json
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..rego import ast as A
from ..flatten.encoder import K_NUM, K_STR
from ..flatten.vocab import Vocab
from .exprs import (
    ECapture,
    EConstSlot,
    EFullN,
    EGroup,
    EGroupPresent,
    EIsInConst,
    ELit,
    EMap,
    EReduce,
    EReduceAxis,
    ESelPattern,
    EStrTable,
    ETokCol,
    Expr,
    e_and,
    e_arith,
    e_cmp,
    e_not,
    e_or,
    e_where,
)
from ..flatten.encoder import esc_seg
from .patterns import PatternRegistry
from .tables import StrTables

NEG_INF = -(10.0**30)


# bump when oracle/interpreter evaluation semantics change: salts the
# persisted oracle-table memo keys (engine/tables.py _load/_save_persist)
ORACLE_MEMO_VERSION = 1


class Reason(str, enum.Enum):
    """Stable fused-path fallback taxonomy.

    Every `CompileUnsupported` raise site stamps one of these family
    codes, so consumers (the IR static-analysis plane's GK-P015
    diagnostic, fallback metrics, tests) classify *why* a template fell
    off the fused path by enum identity instead of string-matching
    human-oriented messages. Values are stable slugs: renaming a member
    is an API break; add new members instead."""

    AGGREGATE_ARG = "aggregate-arg"
    ARRAY_DEPTH = "array-depth"
    AXIS_SHAPE = "axis-shape"
    BINOP = "binop"
    BUILTIN_ARG_SHAPE = "builtin-arg-shape"
    COMPARISON = "comparison"
    COMPREHENSION = "comprehension"
    DATA_REF = "data-ref"
    DERIVED_VALUE = "derived-value"
    DESTRUCTURING = "destructuring"
    EXPR_FORM = "expr-form"
    EXTERNAL_DATA = "external-data"
    FIXED_INDEX = "fixed-index"
    FORKING = "forking"
    FUNCTION_CALL = "function-call"
    INPUT_REF = "input-ref"
    KEYED_LOOKUP = "keyed-lookup"
    OBJECT_ITERATION = "object-iteration"
    OTHER = "other"
    PARTIAL_SET = "partial-set"
    PROJECTION = "projection"
    RULE_REF = "rule-ref"
    TERM_FORM = "term-form"
    TRUTHINESS = "truthiness"
    UNSUPPORTED_BUILTIN = "unsupported-builtin"
    VIOLATION_RULE_FORM = "violation-rule-form"
    WALK_FORM = "walk-form"
    WITH_MODIFIER = "with-modifier"


class CompileUnsupported(Exception):
    """Template uses constructs outside the compilable subset.

    Carries template-kind / rule / line provenance, filled in as the
    exception unwinds through the clause compiler (`_compile_clause`
    stamps rule+line, `compile_violation_counts` stamps the kind), so
    fallback log lines and analyzer-mismatch reports cite WHERE
    compilation gave up, not just why. `code` is the stable `Reason`
    family the raise site belongs to (never derived from the message)."""

    def __init__(
        self,
        reason: str = "",
        kind: str = "",
        rule: str = "",
        line: int = 0,
        code: Optional[Reason] = None,
    ):
        self.reason = reason
        self.kind = kind
        self.rule = rule
        self.line = line
        self.code = code if code is not None else Reason.OTHER
        super().__init__(reason)

    def annotate(
        self, kind: str = "", rule: str = "", line: int = 0
    ) -> "CompileUnsupported":
        """Fill empty provenance fields (innermost context wins)."""
        if kind and not self.kind:
            self.kind = kind
        if rule and not self.rule:
            self.rule = rule
        if line and not self.line:
            self.line = line
        return self

    def __str__(self) -> str:
        ctx = []
        if self.kind:
            ctx.append(f"template={self.kind}")
        if self.rule:
            loc = self.rule + (f":{self.line}" if self.line else "")
            ctx.append(f"rule={loc}")
        if ctx:
            return f"{self.reason} [{' '.join(ctx)}]"
        return self.reason


class InventoryDependent(Exception):
    """A condition's truth depends on `data.inventory` content.

    Raised when a comparison/truthiness touches an inventory-derived
    value; caught at the statement level, where the conjunct is DROPPED
    — a sound over-approximation (weakening a conjunction can only add
    violations). Programs compiled this way are *screens*: the sparse
    pairs they flag are re-evaluated exactly by the interpreter with the
    real inventory (TpuDriver._eval_template), so audit/review results
    stay bit-exact while the dense non-matching bulk never leaves the
    device. This is how the reference's cross-join templates
    (uniqueingresshost / uniqueserviceselector,
    library/general/*/template.yaml; evaluated by the reference via the
    audit cross-join in regolib/src.go:45-62) ride the compiled path."""


@dataclass
class CompilerEnv:
    vocab: Vocab
    patterns: PatternRegistry
    tables: StrTables
    # oracle_fn(fn_name, scalar_value) -> (result, defined): interpreter-
    # backed evaluation of a pure template helper function, used to build
    # per-vocab-entry lookup tables for functions the symbolic compiler
    # can't inline (string canonicalizers like canonify_cpu)
    oracle_fn: Optional[Callable[[str, Any], Tuple[Any, bool]]] = None
    # namespace for oracle-built tables (unique per template+params)
    oracle_ns: str = ""
    # params-free namespace (unique per template only): tables for
    # helpers whose call graph never reads input.parameters register
    # here, so constraint params variants share one fill — the fill is
    # the expensive part (one interpreter call per vocab entry)
    oracle_ns_shared: str = ""
    # constraint kind, for CompileUnsupported provenance only
    template_kind: str = ""
    # external-data screen feature ("extdata:<kind>:<err|all>", set by
    # the driver when the template's external_data calls are
    # batch-extractable): external_data compiles as a screen whose
    # per-row bits the dispatch layer fills from the response cache —
    # in "err" mode (provably error-gated rules) clean cache-hit rows
    # are skipped; in "all" mode the feature only drives prefetch
    extdata_feature: Optional[str] = None


class ConstPool:
    """Per-constraint constants hoisted out of the program structure."""

    def __init__(self):
        self.values: Dict[str, np.ndarray] = {}
        self._n = 0

    def scalar(self, v: float) -> Expr:
        name = f"s{self._n}"
        self._n += 1
        self.values[name] = np.asarray(v, np.float32)
        return EConstSlot(name)

    def id_scalar(self, v: int) -> Expr:
        name = f"i{self._n}"
        self._n += 1
        self.values[name] = np.asarray(v, np.int32)
        return EConstSlot(name)

    def id_set(self, ids: Sequence[int]) -> str:
        """Padded [K] id array slot (for EIsInConst)."""
        name = f"set{self._n}"
        self._n += 1
        k = 1
        while k < max(len(ids), 1):
            k *= 2
        arr = np.full((k,), -1, np.int32)
        for i, v in enumerate(ids):
            arr[i] = v
        self.values[name] = arr
        return name


# ---------------------------------------------------------------------------
# Symbolic values


class SVal:
    pass


@dataclass
class SConst(SVal):
    value: Any


class SInput(SVal):
    """The bare `input` document (proc-mount passes it to a helper)."""


@dataclass
class SInventory(SVal):
    """Opaque value: walks and calls propagate it; any condition on it
    raises InventoryDependent (see that class). Produced by
    `data.inventory` refs always, and — in screen mode — by calls and
    comprehensions outside the compilable subset (a flatten_selector-
    style derived string whose only use is an inventory comparison needs
    no device value at all).

    `path` tracks the walked segments from the data.inventory root —
    escaped literal keys, "#" for literal array indices, "?" for
    var-iterated (unknown) segments; None once the value flowed through
    a call/comprehension and the path is unknowable. `root` identifies
    the inventory iteration the value descends from, so self-exclusion
    guards (`not identical(other, input.review)`) can be tied to the
    join they guard. Both exist solely so the invdup screen refinement
    can prove its soundness conditions (ADVICE r3 high: a cross-path
    join refined at the review leaf's own pattern under-approximates)."""

    path: Optional[Tuple[str, ...]] = None
    root: int = -1
    # derived-value provenance for the render-prune detection
    # (uniqueserviceselector's flatten_selector idiom):
    # ("rev", fn, review_prefix) for F(<review subdocument>),
    # ("inv", fn, walk_path) for F(<inventory-walked object>)
    call_tag: Any = None


@dataclass
class SNode(SVal):
    """Abstract review subdocument at a path prefix ("#" = array level,
    "*" = object-key iteration level)."""

    prefix: Tuple[str, ...]


def _axes_of(prefix: Tuple[str, ...]) -> Tuple[str, ...]:
    n = sum(1 for s in prefix if s == "#")
    if n == 0:
        return ()
    if n == 1:
        return ("g0",)
    if n == 2:
        # two array levels flatten onto one combined axis (idx0*G1 + idx1)
        return ("g01",)
    raise CompileUnsupported(">2 array levels", code=Reason.ARRAY_DEPTH)


@dataclass
class SScalar(SVal):
    """A leaf value read from the token table."""

    comp: "Compiler"
    pattern_idx: int  # -1 for derived scalars
    axes: Tuple[str, ...] = ()
    tok_space: bool = False
    sel_override: Optional[Expr] = None
    num_override: Optional[Expr] = None
    exists_override: Optional[Expr] = None
    # transformed string values (lower/trim/set-element bindings): ids of
    # known-string entries, bypassing the token columns
    vid_override: Optional[Expr] = None
    # render-signature override: derived values that stand in for a
    # message (value-position sprintf) keep SMsg-style cross-clause
    # dedup via _val_sig
    msg_sig: Optional[Tuple] = None

    @property
    def space(self) -> Tuple[str, ...]:
        return ("tok",) if self.tok_space else self.axes

    def sel(self) -> Expr:
        if self.sel_override is not None:
            return self.sel_override
        return ESelPattern(self.pattern_idx)

    def exists(self) -> Expr:
        if self.exists_override is not None:
            return self.exists_override
        if self.tok_space:
            return self.sel()
        if not self.axes:
            return EReduce(self.sel(), "any")
        return self._grouped(self.sel(), None, "any")

    def _grouped(self, mask, value, how, init=-1):
        if self.axes in (("g0",), ("g01",)):
            return EGroup(mask, value, self.axes[0], how=how, init=init)
        raise CompileUnsupported(f"axes {self.axes}", code=Reason.AXIS_SHAPE)

    def col(self, name: str, init=-1) -> Expr:
        if self.num_override is not None:
            raise CompileUnsupported("column of derived scalar", code=Reason.DERIVED_VALUE)
        if self.tok_space:
            return ETokCol(name)
        if not self.axes:
            # "maskfill" is an IR contract with analysis/ir.py: args are
            # [mask, value] and the result is a constant fill wherever
            # the mask is False, so a provably-False mask makes the node
            # pad-equivalent regardless of the value column.
            masked = EMap(
                lambda xp_, m, v: xp_.where(m, v, init),
                [self.sel(), ETokCol(name)],
                "maskfill",
            )
            return EReduce(masked, "max")
        return self._grouped(self.sel(), ETokCol(name), "max", init=init)

    def vid(self) -> Expr:
        if self.vid_override is not None:
            return self.vid_override
        return self.col("vid", -1)

    def num(self) -> Expr:
        if self.num_override is not None:
            return self.num_override
        return self.col("vnum", NEG_INF)

    def kindv(self) -> Expr:
        if self.vid_override is not None:
            return ELit(K_STR)  # transformed values are known strings
        return self.col("kind", -1)

    def truthy(self) -> Expr:
        # vid first: projected subfields carry BOTH overrides (vid for
        # identity, num for arithmetic) and `false` must stay non-truthy
        if self.vid_override is not None:
            return e_and(
                self.exists(),
                e_not(
                    e_cmp("==", self.vid_override, ELit(self.comp.false_id))
                ),
            )
        if self.num_override is not None:
            return self.exists()  # derived numbers: defined => truthy
        false_id = ELit(self.comp.false_id)
        if self.tok_space:
            return e_and(
                self.sel(), e_not(e_cmp("==", ETokCol("vid"), false_id))
            )
        return e_and(self.exists(), e_not(e_cmp("==", self.vid(), false_id)))


@dataclass
class SKey(SVal):
    """Captured object-key of a token-space iteration."""

    pattern_idx: int

    def ids(self) -> Expr:
        return ECapture(self.pattern_idx)


@dataclass
class SBool(SVal):
    expr: Expr


@dataclass
class SMsg(SVal):
    """Opaque always-defined value (sprintf output, head objects).

    `sig` is a structural signature of how the value renders (format
    string + argument source paths). Clauses whose heads carry EQUAL
    signatures render identical strings for the same (resource, element),
    so their violation objects collapse in Rego's result set — the
    compiler ORs such clauses instead of summing them.
    """

    sig: Any = None
    # single-symbolic-arg sprintf carries a LAZY transform recipe
    # (fmt, arg): comparisons materialize it into an id-transform table
    # on demand (apparmor's annotation-key join). Eager registration
    # exploded: several message-position sprintf tables mutually
    # transforming each other's products grow the vocab exponentially.
    recipe: Optional[Tuple[str, Any]] = None
    # render recipe for the compiled message path (engine/render.py):
    # ("sprintf", fmt, (SVal, ...)) or ("obj", ((const_key, SVal), ...))
    parts: Any = None

    def signature(self):
        return self.sig if self.sig is not None else ("opaque", id(self))


@dataclass
class STokenSet(SVal):
    """Set/array comprehension over a token selection.

    `axes` are OUTER array axes the elements are grouped under (e.g. the
    container axis for per-container capability sets); set operations
    reduce the token axis down to those axes via idx-grouping.
    """

    mask: Expr  # [N, L]
    elem_ids: Expr  # [N, L]
    axes: Tuple[str, ...] = ()

    def reduce_any(self, pred_mask: Optional[Expr]) -> Expr:
        m = e_and(self.mask, pred_mask) if pred_mask is not None else self.mask
        if self.axes == ():
            return EReduce(m, "any")
        if self.axes == ("g0",):
            return EGroup(m, None, "g0", how="any")
        raise CompileUnsupported("token-set axes", code=Reason.AXIS_SHAPE)

    def reduce_count(self) -> Expr:
        cnt = EMap(lambda xp_, m: xp_.astype(m, xp_.int32), [self.mask], "toint")
        if self.axes == ():
            return EReduce(cnt, "sum")
        if self.axes == ("g0",):
            return EGroup(self.mask, cnt, "g0", how="sum")
        raise CompileUnsupported("token-set axes", code=Reason.AXIS_SHAPE)


@dataclass
class SElemProj(SVal):
    """Element projection of a SECOND array iterated in token space.

    When a clause's group axis is already owned by another array (the
    host-filesystem volumes x volumeMounts join), the second array's
    elements are represented by their subtree TOKENS: subfield reads
    gather the element's per-field values back onto each token
    (EGatherElem), so conditions on different fields of one element
    agree token-wise. Sound only under EXISTENTIAL reduction (function
    bodies, negations) — one element spans many tokens, so counting
    heads over projected conditions would over-count; the `proj` taint
    on State enforces the restriction."""

    root: Tuple[str, ...]  # ends with "#": the element's array marker
    rel: Tuple[str, ...] = ()  # walked segments below the element


@dataclass
class SDerived(SVal):
    """Per-resource derived number (e.g. a count)."""

    num: Expr
    defined: Expr
    # render recipe when the derived number stands in for a computable
    # value, e.g. ("constdiff", elems, STokenSet) for const-set minus
    # token-set (the `missing` idiom) — engine/render.py rebuilds the
    # actual set host-side from it
    render: Any = None


@dataclass
class SList(SVal):
    """Small fixed list of symbolic values (concrete-iteration
    comprehensions like allowedrepos' `satisfied` array).

    Each item carries an optional guard: the element is only present in
    the list when the guard holds (body conditions of the producing
    comprehension fork)."""

    items: List[Tuple[Optional[Expr], SVal]]


# ---------------------------------------------------------------------------


@dataclass
class State:
    env: Dict[str, SVal]
    cond: List[Expr] = field(default_factory=list)
    space: Tuple[str, ...] = ()
    # axis -> occupancy guard (array slot actually exists)
    guards: Dict[str, Expr] = field(default_factory=dict)
    # axis -> owning array prefix: two DIFFERENT arrays may not share a
    # group axis in one clause (their indices would silently mis-join)
    axis_owner: Dict[str, Tuple[str, ...]] = field(default_factory=dict)
    # element-projection taint (SElemProj): conds are per-TOKEN stand-ins
    # for per-element truth, valid only once existentially reduced
    # (_eval_not); a tainted state reaching a counting head aborts the
    # compile (programs retry with projection disabled)
    proj: bool = False


def _space_join(a: Tuple[str, ...], b: Tuple[str, ...]) -> Tuple[str, ...]:
    from .exprs import join_spaces

    j = join_spaces(a, b)
    if j is None:
        raise CompileUnsupported(f"space join {a} {b}", code=Reason.AXIS_SHAPE)
    return j


def _is_review_ref(term: A.Term, st: "State") -> bool:
    """Is this term the review document (`input.review` or a var bound
    to it)? Used when matching the self-exclusion guard idiom."""
    if (
        isinstance(term, A.Ref)
        and isinstance(term.head, A.Var)
        and term.head.name == "input"
        and len(term.ops) == 1
        and isinstance(term.ops[0], A.Scalar)
        and term.ops[0].value == "review"
    ):
        return True
    if isinstance(term, A.Var):
        v = st.env.get(term.name)
        return isinstance(v, SNode) and v.prefix == ()
    return False


def _self_identity_paths(
    rule: A.Rule,
) -> Optional[Tuple[Tuple[str, ...], ...]]:
    """If this function definition is provably TRUE whenever its first
    argument IS the second argument's `.object` (and the compared
    fields are defined), return the object paths whose definedness that
    proof needs; else None.

    Accepted shape — every body statement equates obj.<p...> with
    review.object.<p...> over the same all-scalar path (either operand
    order): when obj is review.object both sides are the same value, so
    each equality holds iff the path is defined."""
    head = rule.head
    if (
        head.kind != "func"
        or not head.args
        or len(head.args) != 2
        or rule.is_default
        or rule.else_rule is not None
        or not isinstance(head.args[0], A.Var)
        or not isinstance(head.args[1], A.Var)
        or not rule.body
    ):
        return None
    obj_name, rev_name = head.args[0].name, head.args[1].name
    paths: List[Tuple[str, ...]] = []
    for expr in rule.body:
        if (
            isinstance(expr, A.TermExpr)
            and isinstance(expr.term, A.BinOp)
            and expr.term.op == "=="
        ):
            lhs, rhs = expr.term.lhs, expr.term.rhs
        elif isinstance(expr, A.Unify):
            lhs, rhs = expr.lhs, expr.rhs
        else:
            return None
        p1 = _scalar_path(lhs, obj_name)
        p2 = _scalar_path(rhs, rev_name)
        if p1 is None or p2 is None:
            p1 = _scalar_path(rhs, obj_name)
            p2 = _scalar_path(lhs, rev_name)
        if p1 is None or p2 is None:
            return None
        if p2[:1] != ("object",) or p2[1:] != p1:
            return None
        paths.append(p1)
    return tuple(paths)


def _scalar_path(
    term: A.Term, base_name: str
) -> Optional[Tuple[str, ...]]:
    """`base.<a>.<b>...` with all-scalar-string ops -> ("a", "b", ...)."""
    if (
        not isinstance(term, A.Ref)
        or not isinstance(term.head, A.Var)
        or term.head.name != base_name
    ):
        return None
    segs: List[str] = []
    for op in term.ops:
        if isinstance(op, A.Scalar) and isinstance(op.value, str):
            segs.append(op.value)
        else:
            return None
    return tuple(segs)


class Compiler:
    """Compiles one template's violation rules for one concrete params."""

    def __init__(
        self,
        env: CompilerEnv,
        modules: Sequence[A.Module],
        params: Any,
        screen_mode: bool = False,
        elem_projection: bool = True,
    ):
        # screen mode: calls/comprehensions outside the compilable
        # subset become opaque SInventory values instead of aborting —
        # the program over-approximates and flagged pairs re-check via
        # the interpreter (compile_program's fallback retry)
        self.screen_mode = screen_mode
        # element projection (SElemProj): compile second-array joins in
        # token space; off in the middle retry of compile_program's
        # chain (a projection that cannot reduce existentially aborts)
        self.elem_projection = elem_projection
        self.cenv = env
        self.vocab = env.vocab
        self.patterns = env.patterns
        self.tables = env.tables
        self.params = params
        self.pool = ConstPool()
        self.false_id = env.vocab.val_id(False)
        self.rules: Dict[str, List[A.Rule]] = {}
        for mod in modules:
            for rule in mod.rules:
                self.rules.setdefault(rule.head.name, []).append(rule)
        self._fn_depth = 0
        self.signature: List[Any] = []  # structural program signature
        self.uses_inventory = False  # compiled as a screen (see
        # InventoryDependent): flagged pairs re-check via interpreter
        # opaque: some CONDITION was dropped (inventory content or an
        # uncompilable call/comprehension became an opaque value), so
        # branch conds over-approximate for EVERY row and the compiled
        # render is off. Safety FLAGS alone do not set this — a flagged
        # program is exact on unflagged rows (the flag routes the rest).
        self.opaque = False
        self._no_inv_catch = 0  # >0 inside negation bodies
        # row-level safety flags: [N]-space bools OR'd into the clause
        # being compiled when a construct is handled under a shape
        # assumption (e.g. object-key iteration at a node that COULD
        # hold an array) — rows breaking the assumption route to the
        # interpreter instead of silently evaluating wrong
        self._force_flags: List[Expr] = []
        # (leaf pattern id, mirror pattern id, inventory root id) of
        # review-side leaves equality-joined against inventory content
        # in the clause being compiled (screen refinement; _apply_binop)
        self._clause_joins: List[Tuple[int, int, int]] = []
        # (inventory root id, guard pattern ids) for detected
        # self-exclusion guards (`not identical(obj, input.review)`)
        self._clause_guards: List[Tuple[int, Tuple[int, ...]]] = []
        self._inv_root_n = 0  # fresh ids for inventory iterations
        # extdata features recorded by external_data calls in the
        # clause being compiled (ANDed in like _clause_joins)
        self._clause_extfeats: List[str] = []
        self.row_features: List[str] = []  # features programs consume
        # outputs of compile_violation_counts for the compiled-render
        # path (engine/render.py): grouped violation branches with their
        # un-flagged conditions + render plans, and the program's safety
        # flags (a flagged row renders via the interpreter)
        self.out_branches: List[Any] = []
        self.out_flags: List[Expr] = []
        # render-prune detection (derived-key inventory joins): per-
        # clause records + per-clause inventory-root usage; assembled
        # into prune_plan when exactly one clause touches inventory and
        # its every deref is the one recorded join
        self._clause_prunes: List[Tuple[str, Tuple[str, ...], str]] = []
        self._prune_records: List[Tuple[int, Tuple]] = []
        self._clause_inv_roots: List[Tuple[int, int]] = []
        self._clause_n = 0
        self.prune_plan: Optional[Dict[str, Any]] = None

    def _pattern(self, segs: Tuple[str, ...]) -> int:
        idx = self.patterns.register(segs)
        self.signature.append(("pat", segs))
        return idx

    # -- entry --------------------------------------------------------------

    def compile_violation_counts(self) -> Expr:
        try:
            return self._compile_violation_counts()
        except CompileUnsupported as e:
            raise e.annotate(kind=self.cenv.template_kind)

    def _compile_violation_counts(self) -> Expr:
        clauses = self.rules.get("violation")
        if not clauses:
            raise CompileUnsupported("no violation rule", code=Reason.VIOLATION_RULE_FORM)
        branches: List[Tuple[Any, Tuple[str, ...], Expr, Optional[Expr], Any]]
        branches = []
        for rule in clauses:
            if rule.is_default or rule.else_rule is not None:
                raise CompileUnsupported("default/else violation rule", code=Reason.VIOLATION_RULE_FORM)
            try:
                branches.extend(self._compile_clause(rule))
            except CompileUnsupported as e:
                raise e.annotate(rule=rule.head.name, line=rule.line)
        if not branches:
            return EFullN(0)
        # Rego's violation document is a SET: clauses rendering the same
        # {msg, details} object for the same (resource, element) collapse
        # (e.g. containerlimits' two "has no resource limits" clauses).
        # Branches with EQUAL head signatures on the same space are OR'd;
        # everything else sums.
        grouped: Dict[Any, List[Any]] = {}
        order: List[Any] = []
        for sig, space, cond, cond_exact, plan in branches:
            key = (sig, space)
            ent = grouped.get(key)
            if ent is not None:
                ent[0] = e_or(ent[0], cond)
                # equal sigs render identically (the dedup contract the
                # count layer already relies on): OR the exact conds and
                # keep the first available plan
                if ent[1] is None or cond_exact is None:
                    ent[1] = None
                else:
                    ent[1] = e_or(ent[1], cond_exact)
                if ent[2] is None:
                    ent[2] = plan
            else:
                grouped[key] = [cond, cond_exact, plan]
                order.append(key)
        from .render import Branch

        self.out_branches = []
        counts: List[Expr] = []
        for key in order:
            cond, cond_exact, plan = grouped[key]
            if cond_exact is not None:
                self.out_branches.append(
                    Branch(space=key[1], cond=cond_exact, plan=plan)
                )
            cnt = EMap(lambda xp_, c: xp_.astype(c, xp_.int32), [cond], "toint")
            while cnt.space:
                cnt = EReduceAxis(cnt, cnt.space[-1], "sum")
            counts.append(cnt)
        total = counts[0]
        for c in counts[1:]:
            total = e_arith("+", total, c)
        self._assemble_prune_plan()
        return total

    def _assemble_prune_plan(self) -> None:
        """Valid iff exactly one clause touches the inventory, it walked
        exactly one root, and that root's sole use is the recorded
        derived-key join — then every object the clause can match is in
        the join key's candidate set, so the render may prune."""
        if not self._prune_records:
            return
        inv_clauses = [c for c, n in self._clause_inv_roots if n > 0]
        if len(inv_clauses) != 1:
            return
        clause = inv_clauses[0]
        recs = {r for c, r in self._prune_records if c == clause}
        if len(recs) != 1 or any(
            c != clause for c, _ in self._prune_records
        ):
            return
        root_count = next(
            n for c, n in self._clause_inv_roots if c == clause
        )
        if root_count != 1:
            return
        rec = next(iter(recs))
        if len(rec) == 4:  # path-form ("path", rel, review_pattern, tree)
            _, rel, psegs, tree = rec
            self.prune_plan = {
                "path": rel,
                "review_pattern": psegs,
                "tree": tree,
            }
        else:  # fn-form (fn, review_prefix, tree)
            fn, prefix, tree = rec
            self.prune_plan = {
                "fn": fn,
                "review_prefix": prefix,
                "tree": tree,
            }

    def _inv_rel_path(self, inv: "SInventory") -> Optional[Tuple[str, ...]]:
        """The deref path of `inv` relative to a walked inventory OBJECT
        (namespace tree: depth-4 walk; cluster tree: depth-3), or None
        when the walk doesn't address an object root or the value flowed
        through a call (path unknowable)."""
        if inv.path is None:
            return None
        if inv.path[0] == "namespace" and len(inv.path) > 5:
            return inv.path[5:]
        if inv.path[0] == "cluster" and len(inv.path) > 4:
            return inv.path[4:]
        return None

    def _compile_clause(
        self, rule: A.Rule
    ) -> List[Tuple[Any, Tuple[str, ...], Expr, Optional[Expr], Any]]:
        flags_base = len(self._force_flags)
        joins_base = len(self._clause_joins)
        extfeats_base = len(self._clause_extfeats)
        guards_base = len(self._clause_guards)
        prunes_base = len(self._clause_prunes)
        roots_base = self._inv_root_n
        self._clause_n += 1
        clause_idx = self._clause_n
        finals = self._eval_body(rule.body, State(env={}))
        for rec in self._clause_prunes[prunes_base:]:
            self._prune_records.append((clause_idx, rec))
        del self._clause_prunes[prunes_base:]
        self._clause_inv_roots.append(
            (clause_idx, self._inv_root_n - roots_base)
        )
        # safety flags raised during this clause's evaluation OR into
        # every branch: flagged rows always route to the interpreter
        clause_flags = self._force_flags[flags_base:]
        del self._force_flags[flags_base:]
        # inventory join refinements AND into the clause: a row can only
        # violate if SOME recorded join key is duplicated cluster-wide
        # (the dispatch layer supplies the per-row bits; absent bits
        # default True so the screen degrades to coarse, never unsound)
        clause_joins = sorted(set(self._clause_joins[joins_base:]))
        del self._clause_joins[joins_base:]
        guards_map: Dict[int, Tuple[int, ...]] = {}
        for root, gpids in self._clause_guards[guards_base:]:
            guards_map.setdefault(root, gpids)
        del self._clause_guards[guards_base:]
        join_refine: Optional[Expr] = None
        if clause_joins:
            from .exprs import ERowFeature

            for leaf_pid, mirror_pid, root in clause_joins:
                # feature encoding consumed by the dispatch layer
                # (TpuDriver._row_feature_bits):
                # invdup:<leaf>:<mirror>:<self-excluded 0|1>:<g+g+...>
                gpids = guards_map.get(root)
                se = 1 if gpids else 0
                gstr = "+".join(str(g) for g in (gpids or ()))
                feat_name = f"invdup:{leaf_pid}:{mirror_pid}:{se}:{gstr}"
                if feat_name not in self.row_features:
                    self.row_features.append(feat_name)
                    self.signature.append(("rowfeat", feat_name))
                f = ERowFeature(feat_name)
                # ALL dropped equalities are conjuncts: clause truth
                # implies every joined key is matched by another object,
                # so ANDing the bits stays sound and is sharpest
                join_refine = f if join_refine is None else e_and(
                    join_refine, f
                )
        clause_extfeats = sorted(set(self._clause_extfeats[extfeats_base:]))
        del self._clause_extfeats[extfeats_base:]
        if clause_extfeats:
            from .exprs import ERowFeature

            # external-data screen refinement: in "err" mode a clause
            # through an error-gated external_data call can only fire
            # when some row key is NOT a clean cache hit — AND the
            # dispatch-supplied bit in (absent bits default True, so
            # the screen degrades coarse, never unsound); "all"-mode
            # bits are all-ones and exist to drive batch prefetch
            for feat_name in clause_extfeats:
                if feat_name not in self.row_features:
                    self.row_features.append(feat_name)
                    self.signature.append(("rowfeat", feat_name))
                f = ERowFeature(feat_name)
                join_refine = f if join_refine is None else e_and(
                    join_refine, f
                )
        self.out_flags.extend(clause_flags)
        if any(st.proj for st in finals):
            # element-projected conditions reached the counting head:
            # one element spans many tokens, so the count would inflate.
            # Abort; compile_program retries with projection disabled.
            raise CompileUnsupported("unreduced element projection", code=Reason.PROJECTION)
        outs: List[Tuple[Any, Tuple[str, ...], Expr, Optional[Expr], Any]] = []
        for st in finals:
            # the head must evaluate too (undefined heads drop violations);
            # its render-signature drives cross-clause set dedup
            try:
                head_forks = self._eval_term(rule.head.key, st)
            except InventoryDependent:
                # head value depends on opaque content: keep the branch
                # with a unique (no-dedup) signature — over-counting is
                # fine for a screen, the interpreter renders exact sets
                cond = self._conj(st)
                if join_refine is not None:
                    cond = e_and(cond, join_refine)
                exact = cond
                cond = self._with_flags(cond, clause_flags)
                outs.append(
                    (
                        ("inv-head", id(rule), len(outs)),
                        cond.space,
                        cond,
                        exact,
                        None,
                    )
                )
                continue
            for hv, hs in head_forks:
                cond = self._conj(hs)
                if join_refine is not None:
                    cond = e_and(cond, join_refine)
                exact = cond
                cond = self._with_flags(cond, clause_flags)
                plan = None
                if not self.screen_mode:
                    from .render import build_plan

                    plan = build_plan(self, hv)
                outs.append(
                    (_freeze_sig(_val_sig(hv)), cond.space, cond, exact, plan)
                )
        if not outs and clause_flags:
            # the clause compiled to statically-nothing but carries
            # safety flags: flagged rows must still route
            flag = clause_flags[0]
            for f in clause_flags[1:]:
                flag = e_or(flag, f)
            outs.append((("flag-only", id(rule)), flag.space, flag, None, None))
        return outs

    def _with_flags(self, cond: Expr, flags: List[Expr]) -> Expr:
        for f in flags:
            cond = e_or(cond, f)
        return cond

    def _conj(self, st: State) -> Expr:
        # anchor to [N] so fully-concrete bodies still count per resource
        out: Expr = EFullN(True)
        for c in list(st.cond) + [g for g in st.guards.values()]:
            out = e_and(out, c)
        return out

    # -- body ---------------------------------------------------------------

    def _eval_body(self, body: List[A.Expr], state: State) -> List[State]:
        states = [state]
        for expr in body:
            nxt: List[State] = []
            for st in states:
                nxt.extend(self._eval_expr(expr, st))
            if not nxt:
                return []
            states = nxt
            if len(states) > 64:
                raise CompileUnsupported("fork explosion", code=Reason.FORKING)
        return states

    def _eval_expr(self, expr: A.Expr, st: State) -> List[State]:
        try:
            return self._eval_expr_inner(expr, st)
        except InventoryDependent:
            # the conjunct's truth depends on inventory content: DROP it
            # (treat as satisfiable) — sound over-approximation in both
            # polarities since the WHOLE statement (including any `not`)
            # is what drops (inside a negation body the exception
            # re-raises so `not P(inv)` never resolves to inner-defined/
            # undefined, which would under-approximate); the interpreter
            # re-checks flagged pairs with the real inventory
            if self._no_inv_catch:
                raise
            return [st]

    def _eval_expr_inner(self, expr: A.Expr, st: State) -> List[State]:
        if isinstance(expr, A.SomeDecl):
            return [st]
        if isinstance(expr, A.Assign):
            return self._eval_assign(expr.target, expr.value, st)
        if isinstance(expr, A.Unify):
            return self._eval_unify(expr.lhs, expr.rhs, st)
        if isinstance(expr, A.TermExpr):
            return self._eval_cond_term(expr.term, st)
        if isinstance(expr, A.NotExpr):
            return self._eval_not(expr.expr, st)
        if isinstance(expr, A.WithExpr):
            raise CompileUnsupported("with modifier", code=Reason.WITH_MODIFIER)
        raise CompileUnsupported(f"expr {type(expr).__name__}", code=Reason.EXPR_FORM)

    def _node_exists_cond(self, node: SNode) -> Optional[Expr]:
        """Definedness of an abstract node (any token beneath it)."""
        if "*" in node.prefix:
            raise CompileUnsupported("existence under object iteration", code=Reason.OBJECT_ITERATION)
        pat = self._pattern(node.prefix + ("**",))
        axes = _axes_of(node.prefix)
        sel = ESelPattern(pat)
        if not axes:
            return EReduce(sel, "any")
        if axes in (("g0",), ("g01",)):
            return EGroup(sel, None, axes[0], how="any")
        raise CompileUnsupported("existence axes", code=Reason.AXIS_SHAPE)

    def _eval_assign(self, target, value, st: State) -> List[State]:
        if isinstance(target, A.Wildcard):
            return self._eval_cond_term(value, st)
        if isinstance(target, A.ArrayTerm):
            return self._eval_destructure(target, value, st)
        if not isinstance(target, A.Var):
            raise CompileUnsupported("destructuring assignment", code=Reason.DESTRUCTURING)
        out = []
        for val, st2 in self._eval_term(value, st):
            if isinstance(val, SNode) and not val.prefix[-1:] == ("#",):
                # `x := path` fails when the path is undefined — the
                # binding itself requires existence (observable through
                # later negations, e.g. containerlimits' parse clauses).
                # Iteration elements (prefix ending in "#") are already
                # guaranteed by the axis occupancy guard.
                st2 = replace(
                    st2, cond=st2.cond + [self._node_exists_cond(val)]
                )
            env = dict(st2.env)
            env[target.name] = val
            out.append(replace(st2, env=env))
        return out

    def _eval_destructure(self, target: A.ArrayTerm, value, st: State):
        """`[prefix, name] := split(key, "/")`-style array destructuring.

        Supported value shapes: `split(sym, const_sep)` — each part
        becomes an id-transform table (defined only when the split
        yields exactly len(target) parts, matching Rego's unification
        failure on length mismatch) — and SList/SConst sequences of
        matching length."""
        n = len(target.items)
        vars_ = []
        for t in target.items:
            if isinstance(t, (A.Var, A.Wildcard)):
                vars_.append(t)
            else:
                raise CompileUnsupported("destructure target shape", code=Reason.DESTRUCTURING)
        if (
            isinstance(value, A.Call)
            and value.name == "split"
            and len(value.args) == 2
        ):
            out = []
            for sep_v, st1 in self._eval_term(value.args[1], st):
                if not isinstance(sep_v, SConst) or not isinstance(
                    sep_v.value, str
                ):
                    raise CompileUnsupported("split separator shape", code=Reason.BUILTIN_ARG_SHAPE)
                sep = sep_v.value
                for tgt_v, st2 in self._eval_term(value.args[0], st1):
                    tgt_v = self._leafify(tgt_v)
                    if isinstance(tgt_v, SConst):
                        if not isinstance(tgt_v.value, str):
                            continue
                        parts = tgt_v.value.split(sep)
                        if len(parts) != n:
                            continue
                        env = dict(st2.env)
                        for t, p in zip(vars_, parts):
                            if isinstance(t, A.Var):
                                env[t.name] = SConst(p)
                        out.append(replace(st2, env=env))
                        continue
                    env = dict(st2.env)
                    conds: List[Expr] = []
                    for i, t in enumerate(vars_):
                        def mk(sep=sep, i=i, n=n):
                            def fn(s):
                                parts = s.split(sep)
                                if len(parts) != n:
                                    raise ValueError("part count")
                                return parts[i]

                            return fn

                        forks = self._str_transform(
                            tgt_v, st2, f"split:{sep}:{i}of{n}", mk()
                        )
                        if not forks:
                            return []
                        part, _ = forks[0]
                        conds.append(part.exists())
                        if isinstance(t, A.Var):
                            env[t.name] = part
                    out.append(
                        replace(st2, env=env, cond=st2.cond + conds)
                    )
            return out
        forks = self._eval_term(value, st)
        out = []
        for val, st2 in forks:
            items = None
            if isinstance(val, SList) and len(val.items) == n:
                items = [v for _, v in val.items]
            elif isinstance(val, SConst) and isinstance(val.value, list) and (
                len(val.value) == n
            ):
                items = [SConst(x) for x in val.value]
            if items is None:
                raise CompileUnsupported("destructure value shape", code=Reason.DESTRUCTURING)
            env = dict(st2.env)
            for t, v in zip(vars_, items):
                if isinstance(t, A.Var):
                    env[t.name] = v
            out.append(replace(st2, env=env))
        return out

    def _eval_unify(self, lhs, rhs, st: State) -> List[State]:
        lvar = isinstance(lhs, A.Var) and lhs.name not in st.env
        rvar = isinstance(rhs, A.Var) and rhs.name not in st.env
        if lvar and not rvar:
            return self._eval_assign(lhs, rhs, st)
        if rvar and not lvar:
            return self._eval_assign(rhs, lhs, st)
        if isinstance(lhs, A.Wildcard):
            return self._eval_cond_term(rhs, st)
        if isinstance(rhs, A.Wildcard):
            return self._eval_cond_term(lhs, st)
        return self._eval_cond_term(A.BinOp(op="==", lhs=lhs, rhs=rhs), st)

    def _inv_barrier(self):
        """Context manager: InventoryDependent raised inside must escape
        to the ENCLOSING construct instead of dropping an inner conjunct.
        Dropping is only sound where a weaker condition can only ADD
        violations — the top-level clause conjunction. Inside negation
        bodies, comprehension bodies, function bodies, and referenced
        rule bodies, a dropped conjunct weakens a VALUE that may flow
        into non-monotone uses (count(xs) == 0, not f(x), equality), so
        the whole enclosing statement/call must drop (or the compile
        falls back / retries as a coarser screen) instead."""
        import contextlib

        @contextlib.contextmanager
        def barrier():
            self._no_inv_catch += 1
            try:
                yield
            finally:
                self._no_inv_catch -= 1

        return barrier()

    def _eval_not(self, inner: A.Expr, st: State) -> List[State]:
        sub = State(env=dict(st.env), space=st.space, guards=dict(st.guards), axis_owner=dict(st.axis_owner))
        with self._inv_barrier():
            try:
                finals = self._eval_body([inner], sub)
            except InventoryDependent:
                # the whole `not` conjunct is about to drop; if it is a
                # CLAUSE-LEVEL self-exclusion guard, record it for the
                # invdup refinement before the exception propagates.
                # Depth 1 = only this `not`'s own barrier is active; a
                # deeper nesting (comprehension/function body) inverts
                # or launders polarity, so the guard cannot be trusted
                if self._no_inv_catch == 1:
                    self._note_self_exclusion(inner, st)
                raise
        if not finals:
            return [st]  # statically undefined -> `not` succeeds
        if (
            any(f.proj for f in finals)
            and "tok" in st.space
            and not st.proj
        ):
            # the negation cannot existentially close the projection's
            # token axis (the outer space already holds an UNRELATED
            # token iteration) — mixing their token conds would misjoin
            raise CompileUnsupported("projection under open token axis", code=Reason.PROJECTION)
        exprs = []
        statically_true = False
        for f in finals:
            conds = list(f.cond)
            # inner guards beyond the outer ones participate in the inner
            # truth value (an out-of-range element does not exist)
            for ax, g in f.guards.items():
                if st.guards.get(ax) is not g:
                    conds.append(g)
            if not conds:
                statically_true = True
                break
            cond = conds[0]
            for c in conds[1:]:
                cond = e_and(cond, c)
            # reduce axes opened inside the negation (e.g. the token axis
            # of an annotations[key] join) back to the outer space
            for ax in cond.space:
                if ax not in st.space:
                    cond = EReduceAxis(cond, ax, "any")
            if any(ax not in cond.space for ax in st.space):
                # outer axes missing from inner cond: broadcasting in the
                # final AND handles it
                pass
            exprs.append(cond)
        if statically_true:
            return []  # inner always defined -> `not` fails
        combined = exprs[0]
        for e in exprs[1:]:
            combined = e_or(combined, e)
        return [replace(st, cond=st.cond + [e_not(combined)])]

    # -- terms --------------------------------------------------------------

    def _eval_term(self, term: A.Term, st: State) -> List[Tuple[SVal, State]]:
        if isinstance(term, A.Scalar):
            return [(SConst(term.value), st)]
        if isinstance(term, A.Var):
            if term.name in st.env:
                return [(st.env[term.name], st)]
            if term.name == "input":
                return [(SInput(), st)]
            if term.name in self.rules:
                return self._eval_rule_ref(term.name, [], st)
            raise CompileUnsupported(f"unbound var {term.name}", code=Reason.TERM_FORM)
        if isinstance(term, A.Wildcard):
            raise CompileUnsupported("wildcard term", code=Reason.TERM_FORM)
        if isinstance(term, A.Ref):
            return self._eval_ref(term, st)
        if isinstance(term, A.Call):
            return self._eval_call(term, st)
        if isinstance(term, A.BinOp):
            return self._eval_binop(term, st)
        if isinstance(term, A.Comprehension):
            if self.screen_mode:
                try:
                    return self._eval_comprehension(term, st)
                except (CompileUnsupported, InventoryDependent):
                    self.uses_inventory = True
                    self.opaque = True
                    return [(SInventory(), st)]
            return self._eval_comprehension(term, st)
        if isinstance(term, A.ArrayTerm):
            return self._eval_seq_literal(term.items, st, "array")
        if isinstance(term, A.SetTerm):
            return self._eval_seq_literal(term.items, st, "set")
        if isinstance(term, A.ObjectTerm):
            return self._eval_obj_literal(term, st)
        if isinstance(term, A.UnaryMinus):
            forks = self._eval_term(term.operand, st)
            out = []
            for v, s in forks:
                if isinstance(v, SConst) and isinstance(v.value, (int, float)):
                    out.append((SConst(-v.value), s))
                else:
                    raise CompileUnsupported("symbolic unary minus", code=Reason.TERM_FORM)
            return out
        raise CompileUnsupported(f"term {type(term).__name__}", code=Reason.TERM_FORM)

    def _eval_seq_literal(self, items, st: State, kind: str):
        vals, cur = [], st
        symbolic = False
        for item in items:
            forks = self._eval_term(item, cur)
            if not forks:
                return []  # undefined element -> literal undefined
            if len(forks) != 1:
                raise CompileUnsupported("forking literal element", code=Reason.FORKING)
            v, cur = forks[0]
            if not isinstance(v, SConst):
                symbolic = True
            vals.append(v)
        if symbolic:
            return [(SList([(None, v) for v in vals]), cur)]
        pyvals = [v.value for v in vals]
        if kind == "set":
            return [(SConst(set(_hashable(x) for x in pyvals)), cur)]
        return [(SConst(pyvals), cur)]

    def _eval_obj_literal(self, term: A.ObjectTerm, st: State):
        cur = st
        concrete: Dict[Any, Any] = {}
        symbolic = False
        for k, v in term.items:
            kf = self._eval_term(k, cur)
            if len(kf) != 1:
                raise CompileUnsupported("forking object key", code=Reason.FORKING)
            kv, cur = kf[0]
            vf = self._eval_term(v, cur)
            if len(vf) != 1:
                raise CompileUnsupported("forking object value", code=Reason.FORKING)
            vv, cur = vf[0]
            if isinstance(kv, SConst) and isinstance(vv, SConst):
                concrete[_hashable(kv.value)] = vv.value
            else:
                symbolic = True
        if symbolic:
            sig_items = []
            part_items: Optional[List[Tuple[Any, Any]]] = []
            for k, v in term.items:
                kf = self._eval_term(k, st)
                kv = kf[0][0] if kf else None
                vf = self._eval_term(v, st)
                vv = vf[0][0] if vf else None
                sig_items.append((_val_sig(kv), _val_sig(vv)))
                if part_items is not None and isinstance(kv, SConst):
                    part_items.append((kv.value, vv))
                else:
                    part_items = None  # symbolic key: no render recipe
            parts = (
                ("obj", tuple(part_items)) if part_items is not None else None
            )
            return [(SMsg(sig=("obj", tuple(sig_items)), parts=parts), cur)]
        return [(SConst(concrete), cur)]

    # -- refs ---------------------------------------------------------------

    def _eval_ref(self, ref: A.Ref, st: State):
        if not isinstance(ref.head, A.Var):
            raise CompileUnsupported("computed ref head", code=Reason.INPUT_REF)
        name = ref.head.name
        if name == "input":
            if not ref.ops or not isinstance(ref.ops[0], A.Scalar):
                raise CompileUnsupported("opaque input access", code=Reason.INPUT_REF)
            first = ref.ops[0].value
            if first == "parameters":
                return self._walk(SConst(self.params), ref.ops[1:], st)
            if first == "review":
                return self._walk(SNode(prefix=()), ref.ops[1:], st)
            raise CompileUnsupported(f"input.{first}", code=Reason.INPUT_REF)
        if name in st.env:
            return self._walk(st.env[name], ref.ops, st)
        if name in self.rules:
            return self._eval_rule_ref(name, ref.ops, st)
        if name == "data":
            if (
                ref.ops
                and isinstance(ref.ops[0], A.Scalar)
                and ref.ops[0].value == "inventory"
            ):
                # inventory joins compile as screens: the value is opaque
                # and conditions on it drop (InventoryDependent); walking
                # with unbound vars binds them opaquely too
                self.uses_inventory = True
                self.opaque = True
                self._inv_root_n += 1
                return self._walk(
                    SInventory(path=(), root=self._inv_root_n),
                    ref.ops[1:],
                    st,
                )
            raise CompileUnsupported("data ref outside inventory", code=Reason.DATA_REF)
        raise CompileUnsupported(f"unknown ref head {name}", code=Reason.INPUT_REF)

    def _walk(self, val: SVal, ops: List[A.Term], st: State):
        forks: List[Tuple[SVal, State]] = [(val, st)]
        for op in ops:
            nxt: List[Tuple[SVal, State]] = []
            for v, s in forks:
                nxt.extend(self._walk_one(v, op, s))
            forks = nxt
            if not forks:
                return []
        return forks

    def _walk_one(self, val: SVal, op: A.Term, st: State):
        if isinstance(val, SInventory):
            # any step stays opaque; unbound var keys (ns/name/apiversion
            # iteration) bind opaquely. The walked segment is tracked on
            # the result so inventory joins can prove their counting
            # pattern mirrors the partner's real path (esc-literal / "#"
            # for literal array indices / "?" where the segment is
            # unknowable at compile time).
            seg: Optional[str] = None
            if isinstance(op, A.Scalar):
                if isinstance(op.value, str):
                    seg = esc_seg(op.value)
                elif isinstance(op.value, (int, float)) and not isinstance(
                    op.value, bool
                ):
                    seg = "#"
            elif isinstance(op, A.Wildcard):
                seg = "?"
            elif isinstance(op, A.Var):
                bound = st.env.get(op.name)
                if bound is None:
                    env = dict(st.env)
                    env[op.name] = SInventory()
                    st = replace(st, env=env)
                    seg = "?"
                elif isinstance(bound, SConst) and isinstance(
                    bound.value, str
                ):
                    seg = esc_seg(bound.value)
                else:
                    seg = "?"
            path = (
                None
                if (val.path is None or seg is None)
                else val.path + (seg,)
            )
            return [(SInventory(path=path, root=val.root), st)]
        if isinstance(val, SInput):
            if isinstance(op, A.Scalar) and op.value == "parameters":
                return [(SConst(self.params), st)]
            if isinstance(op, A.Scalar) and op.value == "review":
                return [(SNode(prefix=()), st)]
            raise CompileUnsupported("opaque input walk", code=Reason.INPUT_REF)
        if isinstance(val, SConst):
            return self._walk_const(val.value, op, st)
        if isinstance(val, SNode):
            return self._walk_node(val, op, st)
        if isinstance(val, (SScalar, SKey, SMsg, SDerived)):
            # indexing into a leaf: undefined in Rego (object-branch values
            # walked further also land here and contribute nothing). But an
            # object-ITERATION element (tok_space over prefix.*.**) may hold
            # structure on some rows — those rows' deeper walks are real in
            # Rego, so raise a row-level safety flag routing exactly the
            # rows that have matching deeper tokens to the interpreter
            # (found via the mixed-structure partner differential test:
            # spec.rules as an object map where the template iterates it).
            if (
                isinstance(val, SScalar)
                and val.tok_space
                and val.pattern_idx >= 0
            ):
                segs = self.patterns.segs(val.pattern_idx)
                if segs and segs[-1] == "**":
                    if isinstance(op, A.Scalar) and isinstance(
                        op.value, str
                    ):
                        flag_segs = segs[:-1] + (esc_seg(op.value), "**")
                    else:
                        # var/wildcard iteration, numeric/bool indexing:
                        # any one deeper segment voids the leaf read
                        flag_segs = segs[:-1] + ("?", "**")
                    flag_pat = self._pattern(flag_segs)
                    self._force_flags.append(
                        EReduce(ESelPattern(flag_pat), "any")
                    )
                    self.uses_inventory = True
            return []
        if isinstance(val, SElemProj):
            return self._walk_elem_proj(val, op, st)
        if isinstance(val, STokenSet):
            if isinstance(op, (A.Var, A.Wildcard)) and not (
                isinstance(op, A.Var) and op.name in st.env
            ):
                if val.axes:
                    raise CompileUnsupported("iterating per-axis token set", code=Reason.WALK_FORM)
                elem = SScalar(
                    self,
                    pattern_idx=-1,
                    axes=(),
                    tok_space=True,
                    sel_override=val.mask,
                    vid_override=val.elem_ids,
                    exists_override=val.mask,
                )
                st2 = replace(st, space=_space_join(st.space, ("tok",)))
                st2 = replace(st2, cond=st2.cond + [val.mask])
                return [(elem, st2)]
            raise CompileUnsupported("walking a comprehension result", code=Reason.WALK_FORM)
        raise CompileUnsupported(f"walk {type(val).__name__}", code=Reason.WALK_FORM)

    def _walk_const(self, value: Any, op: A.Term, st: State):
        if isinstance(op, A.Scalar):
            key = op.value
            if isinstance(value, dict):
                return [(SConst(value[key]), st)] if key in value else []
            if isinstance(value, list):
                if isinstance(key, (int, float)) and int(key) == key:
                    i = int(key)
                    return [(SConst(value[i]), st)] if 0 <= i < len(value) else []
                return []
            if isinstance(value, (set, frozenset)):
                return [(SConst(key), st)] if _hashable(key) in value else []
            return []
        if isinstance(op, A.Var) and op.name in st.env:
            kv = st.env[op.name]
            if isinstance(kv, SConst):
                return self._walk_const(value, A.Scalar(kv.value), st)
            return self._lookup_symbolic(value, kv, st)
        if isinstance(op, (A.Wildcard, A.Var)):
            bind = op.name if isinstance(op, A.Var) else None
            if isinstance(value, dict):
                items = list(value.items())
            elif isinstance(value, list):
                items = list(enumerate(value))
            elif isinstance(value, (set, frozenset)):
                items = [(v, v) for v in value]
            else:
                return []
            out = []
            for k, v in items:
                env = dict(st.env)
                if bind:
                    env[bind] = SConst(k)
                out.append((SConst(v), replace(st, env=env)))
            return out
        raise CompileUnsupported("const walk op", code=Reason.WALK_FORM)

    def _lookup_symbolic(self, container: Any, key: SVal, st: State):
        """concrete_container[symbolic_key] — membership/lookup condition."""
        if isinstance(container, (set, frozenset, dict, list)):
            if isinstance(container, dict):
                keys = list(container.keys())
            elif isinstance(container, list):
                keys = list(range(len(container)))
            else:
                keys = list(container)
            str_keys = [k for k in keys if isinstance(k, str)]
            if len(str_keys) != len(keys):
                raise CompileUnsupported("non-string symbolic lookup keys", code=Reason.KEYED_LOOKUP)
            ids = [self.vocab.str_id(k) for k in str_keys]
            slot = self.pool.id_set(ids)
            self.signature.append(("idset", len(self.pool.values[slot])))
            if isinstance(key, SKey):
                cond = EIsInConst(key.ids(), slot)
            elif isinstance(key, SScalar) and key.num_override is None:
                cond = e_and(key.exists(), EIsInConst(key.vid(), slot))
            else:
                raise CompileUnsupported("symbolic lookup key shape", code=Reason.KEYED_LOOKUP)
            # the VALUE is only usable when all container values are equal
            # or the result is used as a condition; return an opaque truthy
            # value guarded by membership (values in these templates are
            # `true` markers or the keys themselves)
            st2 = replace(st, cond=st.cond + [cond])
            vals = set(
                _hashable(v)
                for v in (
                    container.values()
                    if isinstance(container, dict)
                    else container
                )
            )
            if len(vals) == 1:
                return [(SConst(next(iter(vals))), st2)]
            return [(SMsg(), st2)]
        return []

    def _walk_node(self, node: SNode, op: A.Term, st: State):
        if isinstance(op, A.Scalar):
            if not isinstance(op.value, str):
                return self._iterate_indexed(node, op, st)
            if "*" in node.prefix:
                raise CompileUnsupported("field access under object iteration", code=Reason.OBJECT_ITERATION)
            return [(SNode(node.prefix + (esc_seg(op.value),)), st)]
        if isinstance(op, A.Var) and op.name in st.env:
            kv = st.env[op.name]
            if isinstance(kv, SConst):
                if isinstance(kv.value, str):
                    return [(SNode(node.prefix + (esc_seg(kv.value),)), st)]
                if kv.value is _ARRAY_INDEX:
                    raise CompileUnsupported("array index used as key", code=Reason.KEYED_LOOKUP)
                return []
            if isinstance(kv, (SKey, SScalar)):
                return self._iterate_keyed_bound(node, kv, st)
            raise CompileUnsupported("bound node key shape", code=Reason.KEYED_LOOKUP)
        if isinstance(op, (A.Wildcard, A.Var)):
            return self._iterate_node(node, op, st)
        raise CompileUnsupported("node walk op", code=Reason.WALK_FORM)

    def _iterate_indexed(self, node: SNode, op: A.Scalar, st: State):
        """containers[0] — fixed array index."""
        idx = op.value
        if not (isinstance(idx, (int, float)) and int(idx) == idx):
            return []
        raise CompileUnsupported("fixed array index", code=Reason.FIXED_INDEX)

    def _iterate_keyed_bound(self, node: SNode, key: SVal, st: State):
        """node[k] with k already bound to a symbolic key — equality join
        between the capture and the bound key (labels[key] pattern)."""
        if "*" in node.prefix or "#" in node.prefix:
            raise CompileUnsupported("keyed join under iteration", code=Reason.KEYED_LOOKUP)
        pat = self._pattern(node.prefix + ("*", "**"))
        scalar = SScalar(self, pat, axes=(), tok_space=True)
        if isinstance(key, SKey):
            cond = e_cmp("==", ECapture(pat), key.ids())
        elif isinstance(key, SScalar) and key.num_override is None:
            cond = e_and(key.exists(), e_cmp("==", ECapture(pat), key.vid()))
        else:
            raise CompileUnsupported("keyed join key shape", code=Reason.KEYED_LOOKUP)
        st2 = replace(
            st,
            cond=st.cond + [e_and(scalar.sel(), cond)],
            space=_space_join(st.space, ("tok",)),
        )
        return [(scalar, st2)]

    def _iterate_node(self, node: SNode, op: A.Term, st: State):
        bind = op.name if isinstance(op, A.Var) else None
        forks: List[Tuple[SVal, State]] = []
        # array branch: extend with "#" (lazy axis)
        axis_conflict = False
        if (
            node.prefix.count("#") < 2
            and "*" not in node.prefix
            and "tok" not in st.space
        ):
            child = SNode(node.prefix + ("#",))
            axes = _axes_of(child.prefix)
            axis = axes[-1]
            owner = st.axis_owner.get(axis)
            if owner is not None and owner != node.prefix:
                # a second array cannot share the open group axis — but
                # the node may be an OBJECT (annotations under the
                # containers axis, the seccomp/apparmor join): skip the
                # array interpretation and let the object branch handle
                # it, with a row-level safety flag for rows where the
                # node actually holds an array (those route to the
                # interpreter instead of evaluating wrong)
                axis_conflict = True
            else:
                guard_pat = self._pattern(child.prefix + ("**",))
                guard = EGroupPresent(ESelPattern(guard_pat), axis)
                guards = dict(st.guards)
                guards[axis] = guard
                owners = dict(st.axis_owner)
                owners[axis] = node.prefix
                env = dict(st.env)
                if bind:
                    # the numeric index value: comparisons against it are
                    # statically false (no library template uses it)
                    env[bind] = SConst(_ARRAY_INDEX)
                st2 = replace(
                    st,
                    env=env,
                    space=_space_join(st.space, axes),
                    guards=guards,
                    axis_owner=owners,
                )
                forks.append((child, st2))
        # object branch: token axis over keys; allowed under an open array
        # axis too (joins land on the rank-3 ("tok","g0") space)
        if st.space in ((), ("g0",)):
            pat = self._pattern(node.prefix + ("*", "**"))
            scalar = SScalar(self, pat, axes=(), tok_space=True)
            env = dict(st.env)
            if bind:
                env[bind] = SKey(pat)
            st2 = replace(
                st,
                env=env,
                space=_space_join(st.space, ("tok",)),
                cond=st.cond + [scalar.truthy()],
            )
            forks.append((scalar, st2))
            if axis_conflict:
                if self.elem_projection:
                    # ARRAY handling without a free group axis: iterate
                    # in token space via element projection. The object
                    # and projection forks select DISJOINT tokens
                    # ("*" never matches "#"), so emitting both is exact
                    # whichever shape a row actually holds — no safety
                    # flag, no interpreter routing.
                    forks.append(self._elem_proj_fork(node, bind, st))
                else:
                    # projection disabled (retry path): rows where the
                    # node IS an array must route (Rego would bind
                    # indices there; the object branch sees nothing —
                    # an under-approximation without this flag)
                    arr_pat = self._pattern(node.prefix + ("#", "**"))
                    self._force_flags.append(
                        EReduce(ESelPattern(arr_pat), "any")
                    )
                    self.uses_inventory = True
        if not forks:
            if "tok" in st.space:
                # we're inside the phantom object-branch of an earlier
                # iteration (real data there is an array, matched by the
                # sibling fork): this fork contributes nothing
                return []
            raise CompileUnsupported("iteration not representable", code=Reason.WALK_FORM)
        return forks

    def _elem_proj_fork(
        self, node: SNode, bind: Optional[str], st: State
    ) -> Tuple[SVal, State]:
        root = node.prefix + ("#",)
        elem_any = self._pattern(root + ("**",))
        val = SElemProj(root=root, rel=())
        env = dict(st.env)
        if bind:
            env[bind] = val
        st2 = replace(
            st,
            env=env,
            space=_space_join(st.space, ("tok",)),
            cond=st.cond + [ESelPattern(elem_any)],
            proj=True,
        )
        return (val, st2)

    def _walk_elem_proj(self, val: SElemProj, op: A.Term, st: State):
        if isinstance(op, A.Scalar):
            if not isinstance(op.value, str):
                raise CompileUnsupported("indexed walk under projection", code=Reason.PROJECTION)
            return [
                (replace(val, rel=val.rel + (esc_seg(op.value),)), st)
            ]
        if isinstance(op, (A.Wildcard, A.Var)) and not (
            isinstance(op, A.Var) and op.name in st.env
        ):
            # nested array under the projected element (volumeMounts[_])
            root2 = val.root + val.rel + ("#",)
            if root2.count("#") > 2:
                raise CompileUnsupported(">2 array levels in projection", code=Reason.ARRAY_DEPTH)
            elem_any = self._pattern(root2 + ("**",))
            child = SElemProj(root=root2, rel=())
            env = dict(st.env)
            if isinstance(op, A.Var):
                env[op.name] = child
            st2 = replace(
                st,
                env=env,
                space=_space_join(st.space, ("tok",)),
                cond=st.cond + [ESelPattern(elem_any)],
                proj=True,
            )
            return [(child, st2)]
        raise CompileUnsupported("projection walk op", code=Reason.PROJECTION)

    def _elem_proj_scalar(self, v: SElemProj) -> SScalar:
        """Projected subfield read: the element's per-field value
        gathered onto each of the element's tokens (see SElemProj)."""
        from .exprs import EGatherElem

        if not v.rel:
            raise CompileUnsupported("whole projected element as value", code=Reason.PROJECTION)
        ax = "g0" if v.root.count("#") == 1 else "g01"
        pat_f = self._pattern(v.root + v.rel)
        elem_any = self._pattern(v.root + ("**",))
        grp_sel = ESelPattern(pat_f)
        vid_tok = EGatherElem(
            EGroup(grp_sel, ETokCol("vid"), ax, how="max", init=-1),
            default=-1,
        )
        ex_tok = e_and(
            ESelPattern(elem_any),
            EGatherElem(
                EGroup(grp_sel, None, ax, how="any"), default=False
            ),
        )
        num_tok = EGatherElem(
            EGroup(grp_sel, ETokCol("vnum"), ax, how="max", init=NEG_INF),
            default=NEG_INF,
        )
        return SScalar(
            self,
            pattern_idx=pat_f,
            axes=(),
            tok_space=True,
            sel_override=ex_tok,
            vid_override=vid_tok,
            num_override=num_tok,
            exists_override=ex_tok,
        )

    def _elem_proj_truthy(self, v: SElemProj) -> Expr:
        """Projected-subfield truthiness (`mount.readOnly`,
        has_field-style object checks): the element has ANY token at or
        under the subfield path and its exact leaf is not `false` —
        _node_truthy's semantics, element-gathered onto tokens."""
        from .exprs import EGatherElem

        if not v.rel:
            raise CompileUnsupported("bare projected element truthiness", code=Reason.PROJECTION)
        ax = "g0" if v.root.count("#") == 1 else "g01"
        deep = self._pattern(v.root + v.rel + ("**",))
        exact = self._pattern(v.root + v.rel)
        elem_any = self._pattern(v.root + ("**",))
        deep_any = EGatherElem(
            EGroup(ESelPattern(deep), None, ax, how="any"), default=False
        )
        false_leaf = e_and(
            ESelPattern(exact),
            e_cmp("==", ETokCol("vid"), ELit(self.false_id)),
        )
        has_false = EGatherElem(
            EGroup(false_leaf, None, ax, how="any"), default=False
        )
        return e_and(
            ESelPattern(elem_any), e_and(deep_any, e_not(has_false))
        )

    def _node_leaf(self, node: SNode) -> SScalar:
        if "*" in node.prefix:
            raise CompileUnsupported("leaf under object iteration", code=Reason.OBJECT_ITERATION)
        pat = self._pattern(node.prefix)
        return SScalar(self, pat, axes=_axes_of(node.prefix))

    def _eval_rule_ref(self, name: str, ops: List[A.Term], st: State):
        rules = self.rules[name]
        kind = rules[0].head.kind
        if kind == "set":
            if not ops:
                raise CompileUnsupported("bare partial-set ref as value", code=Reason.RULE_REF)
            out: List[Tuple[SVal, State]] = []
            for rule in rules:
                for v, s in self._iterate_partial_set(rule, ops[0], st):
                    out.extend(self._walk(v, ops[1:], s))
            return out
        if kind == "complete":
            if len(rules) == 1 and not rules[0].is_default:
                rule = rules[0]
                if not rule.body:
                    forks = self._eval_term(rule.head.value, st)
                else:
                    # computed complete rule (requiredprobes' probe_type_set):
                    # compile only when the body resolves concretely
                    sub = State(env={})
                    with self._inv_barrier():
                        finals = self._eval_body(rule.body, sub)
                    if len(finals) != 1 or finals[0].cond or finals[0].space:
                        raise CompileUnsupported("computed complete rule", code=Reason.RULE_REF)
                    forks = self._eval_term(rule.head.value, finals[0])
                    forks = [(v, st) for v, _ in forks]
                out = []
                for v, s in forks:
                    out.extend(self._walk(v, ops, s))
                return out
            raise CompileUnsupported("computed complete rule ref", code=Reason.RULE_REF)
        raise CompileUnsupported(f"rule ref {kind}", code=Reason.RULE_REF)

    def _iterate_partial_set(self, rule: A.Rule, op: A.Term, st: State):
        """Iterate/match a same-module partial set rule.

        Object-literal operands (the containerlimits
        `general_violation[{"msg": msg, "field": "containers"}]` pattern)
        unify field-by-field with an object-literal head key: caller-side
        constants PRE-BIND the head's variables before the body runs,
        caller-side unbound variables bind from the head afterwards.
        """
        pre_env: Dict[str, SVal] = {}
        post_binds: List[Tuple[str, A.Term]] = []
        if isinstance(op, A.ObjectTerm):
            if not isinstance(rule.head.key, A.ObjectTerm):
                return []
            head_map = {}
            for hk, hval in rule.head.key.items:
                if not isinstance(hk, A.Scalar):
                    raise CompileUnsupported("computed head key field", code=Reason.PARTIAL_SET)
                head_map[hk.value] = hval
            # interpreter object-pattern semantics are SUBSET match:
            # every caller field must exist in the head element, extra
            # head fields are ignored (interp.py:_bind_pattern). A
            # caller field the head lacks can never unify.
            caller_keys = {
                k.value for k, _ in op.items if isinstance(k, A.Scalar)
            }
            if len(caller_keys) != len(op.items):
                raise CompileUnsupported("computed pattern field key", code=Reason.PARTIAL_SET)
            if not caller_keys <= set(head_map):
                return []  # caller field missing from head: no match
            for k, v in op.items:
                hterm = head_map[k.value]
                if isinstance(v, A.Var) and v.name not in st.env:
                    post_binds.append((v.name, hterm))
                    continue
                if isinstance(v, A.Wildcard):
                    continue
                vf = self._eval_term(v, st)
                if len(vf) != 1 or not isinstance(vf[0][0], SConst):
                    raise CompileUnsupported("non-const pattern field", code=Reason.PARTIAL_SET)
                cv = vf[0][0]
                if isinstance(hterm, A.Var):
                    pre_env[hterm.name] = cv
                elif isinstance(hterm, A.Scalar):
                    if hterm.value != cv.value:
                        return []  # statically mismatched clause
                else:
                    raise CompileUnsupported("head field shape", code=Reason.PARTIAL_SET)
        elif not isinstance(op, (A.Var, A.Wildcard)):
            raise CompileUnsupported("partial-set operand shape", code=Reason.PARTIAL_SET)

        sub = State(env=pre_env, space=st.space, guards=dict(st.guards), axis_owner=dict(st.axis_owner))
        with self._inv_barrier():
            finals = self._eval_body(rule.body, sub)
        out = []
        for f in finals:
            for hv, hs in self._eval_term(rule.head.key, f):
                merged = replace(
                    st,
                    cond=st.cond + hs.cond,
                    space=hs.space,
                    guards=hs.guards,
                    axis_owner=hs.axis_owner,
                    proj=st.proj or hs.proj,
                )
                env = dict(merged.env)
                if isinstance(op, A.Var) and op.name not in st.env:
                    env[op.name] = hv
                for var_name, hterm in post_binds:
                    bf = self._eval_term(hterm, hs)
                    if len(bf) != 1:
                        raise CompileUnsupported("forking head field", code=Reason.FORKING)
                    env[var_name] = bf[0][0]
                merged = replace(merged, env=env)
                out.append((hv, merged))
        return out

    # -- calls --------------------------------------------------------------

    def _eval_call(self, call: A.Call, st: State):
        arg_forks: List[Tuple[List[SVal], State]] = [([], st)]
        for arg in call.args:
            nxt = []
            for vals, s in arg_forks:
                for v, s2 in self._eval_term(arg, s):
                    if isinstance(v, SNode):
                        # call operands are evaluated before the call:
                        # undefined args make the whole call undefined
                        s2 = replace(
                            s2,
                            cond=s2.cond + [self._node_exists_cond(v)],
                        )
                    nxt.append((vals + [v], s2))
            arg_forks = nxt
        out: List[Tuple[SVal, State]] = []
        for vals, s in arg_forks:
            out.extend(self._apply_call(call.name, vals, s))
        return out

    def _apply_call(self, name: str, args: List[SVal], st: State):
        # derived-value provenance for render pruning: an opaque result
        # of a pure 1-arg template helper remembers WHOSE value it is —
        # F(<review subdoc>) or F(<inventory-walked object>). Applied to
        # every opaque outcome (the inline may "succeed" opaquely when
        # its comprehension screens out, or abort outright).
        base = name.split(".")[-1] if "." in name else name
        tag = None
        if len(args) == 1 and base in self.rules:
            if isinstance(args[0], SNode):
                tag = ("rev", base, args[0].prefix)
            elif (
                isinstance(args[0], SInventory)
                and args[0].path is not None
            ):
                tag = ("inv", base, args[0].path)

        def tagged(outs):
            if tag is None:
                return outs
            return [
                (
                    replace(v, call_tag=tag)
                    if isinstance(v, SInventory) and v.call_tag is None
                    else v,
                    s,
                )
                for v, s in outs
            ]

        if name == "external_data":
            # out-of-band lookup: never exactly compilable (the answer
            # lives outside the review), but in screen mode the response
            # is opaque and the clause gains the extdata row feature —
            # the dispatch layer fills it from the batch-prefetched
            # response cache, so clean cache-hit rows stay fused and
            # only cold-miss/error rows take the interpreter rung
            if not self.screen_mode:
                raise CompileUnsupported("external_data (compiles as a batch-prefetched screen)", code=Reason.EXTERNAL_DATA)
            self.uses_inventory = True
            self.opaque = True
            feat = self.cenv.extdata_feature
            if feat:
                self._clause_extfeats.append(feat)
            return [(SInventory(), st)]
        if any(isinstance(a, SInventory) for a in args):
            # calls over inventory values (identical(), flatten_selector,
            # re_match on an iterated apiversion, sprintf into the msg)
            # produce opaque values; conditions on them drop later
            return tagged([(SInventory(), st)])
        if self.screen_mode:
            try:
                return tagged(self._apply_call_inner(name, args, st))
            except (CompileUnsupported, InventoryDependent):
                # InventoryDependent escaping a function body (via the
                # _inv_barrier) means the call's value depends on
                # inventory content: opaque, conditions on it drop
                self.uses_inventory = True
                self.opaque = True
                return tagged([(SInventory(), st)])
        return self._apply_call_inner(name, args, st)

    def _apply_call_inner(self, name: str, args: List[SVal], st: State):
        if name in self.rules:
            return self._inline_function(name, args, st)
        handler = getattr(self, f"_builtin_{name.replace('.', '_')}", None)
        if handler is not None:
            return handler(args, st)
        if all(isinstance(a, SConst) for a in args):
            from ..rego.builtins import BUILTINS, BuiltinError
            from ..rego.values import freeze, thaw

            if name in BUILTINS:
                arity, fn = BUILTINS[name]
                if arity != len(args):
                    raise CompileUnsupported(f"{name} arity", code=Reason.FUNCTION_CALL)
                try:
                    v = fn(*[freeze(a.value) for a in args])
                except BuiltinError:
                    return []
                return [(SConst(thaw(v)), st)]
        raise CompileUnsupported(f"builtin {name} symbolic", code=Reason.UNSUPPORTED_BUILTIN)

    def _inline_function(self, name: str, args: List[SVal], st: State):
        if self._fn_depth > 8:
            raise CompileUnsupported("inline depth", code=Reason.FUNCTION_CALL)
        rules = self.rules[name]
        if rules[0].head.kind != "func":
            raise CompileUnsupported(f"{name} not a function", code=Reason.FUNCTION_CALL)
        try:
            return self._inline_function_body(name, rules, args, st)
        except CompileUnsupported:
            # fall back to per-vocab-entry tableization for pure scalar
            # helpers (canonify_cpu & co)
            tabled = self._tableize_function(name, args, st)
            if tabled is not None:
                return tabled
            raise

    def _inline_function_body(
        self, name: str, rules: List[A.Rule], args: List[SVal], st: State
    ):
        try:
            return self._inline_function_rules(name, rules, args, st)
        except CompileUnsupported as e:
            raise e.annotate(rule=name, line=rules[0].line)

    def _inline_function_rules(
        self, name: str, rules: List[A.Rule], args: List[SVal], st: State
    ):
        self._fn_depth += 1
        try:
            out: List[Tuple[SVal, State]] = []
            for rule in rules:
                formals = rule.head.args or []
                if len(formals) != len(args):
                    continue
                sub = State(env={}, space=st.space, guards=dict(st.guards), axis_owner=dict(st.axis_owner))
                ok = True
                for formal, actual in zip(formals, args):
                    if isinstance(formal, A.Var):
                        sub.env[formal.name] = actual
                    elif isinstance(formal, A.Wildcard):
                        continue
                    elif isinstance(formal, A.Scalar):
                        if isinstance(actual, SConst):
                            if actual.value != formal.value:
                                ok = False
                                break
                        else:
                            cond, okk = self._sym_eq(
                                actual, SConst(formal.value)
                            )
                            if not okk:
                                raise CompileUnsupported("formal pattern", code=Reason.FUNCTION_CALL)
                            sub.cond.append(cond)
                    else:
                        raise CompileUnsupported("formal pattern shape", code=Reason.FUNCTION_CALL)
                if not ok:
                    continue
                with self._inv_barrier():
                    finals = self._eval_body(rule.body, sub)
                for f in finals:
                    vf = (
                        self._eval_term(rule.head.value, f)
                        if rule.head.value is not None
                        else [(SConst(True), f)]
                    )
                    for hv, hs in vf:
                        merged = replace(
                            st,
                            cond=st.cond + hs.cond,
                            space=hs.space,
                            guards=hs.guards,
                            proj=st.proj or hs.proj,
                        )
                        out.append((hv, merged))
            return out
        finally:
            self._fn_depth -= 1

    def _tableize_function(self, name: str, args: List[SVal], st: State):
        """Pure helper with exactly ONE symbolic scalar argument (the
        rest constants) -> per-vocab-entry value table. The constants
        fold into the table identity, so e.g. host-filesystem's
        `path_matches(<const prefix>, volume.hostPath.path)` becomes
        one boolean table over distinct path strings per prefix."""
        if self.cenv.oracle_fn is None or not args:
            return None
        sym_idx = -1
        consts: List[Any] = []
        for i, a in enumerate(args):
            if isinstance(a, SConst):
                if not _jsonable(a.value):
                    return None
                consts.append(a.value)
                continue
            if sym_idx >= 0:
                return None  # at most one symbolic slot
            sym_idx = i
            consts.append(None)
        if sym_idx < 0:
            return None
        arg = self._leafify(args[sym_idx])
        if not isinstance(arg, (SScalar, SKey)):
            return None
        if isinstance(arg, SScalar) and arg.num_override is not None:
            return None
        if not self._fn_is_pure(name, set()):
            return None
        if not self._fn_arg_scalar(name, sym_idx=sym_idx):
            return None
        oracle = self.cenv.oracle_fn
        ns = self.cenv.oracle_ns
        reads_params = self._fn_reads_params(name, set())
        if self.cenv.oracle_ns_shared and not reads_params:
            ns = self.cenv.oracle_ns_shared
        # content hash over the whole module rule set: any template edit
        # invalidates the persisted oracle memo (conservatively)
        if not hasattr(self, "_rules_hash"):
            import hashlib

            self._rules_hash = hashlib.sha256(
                repr(sorted((k, repr(v)) for k, v in self.rules.items()))
                .encode()
            ).hexdigest()
        # ORACLE_MEMO_VERSION salts the key so oracle/interpreter
        # implementation changes invalidate persisted memos
        persist_key = f"v{ORACLE_MEMO_VERSION}|{self._rules_hash}|{name}"
        if reads_params:
            persist_key += f"|{json.dumps(self.params, sort_keys=True, default=str)}"
        table_id = f"fn:{ns}:{name}"
        call_extra = None
        if len(args) > 1:
            # fold the constant arguments into the table identity: one
            # table per (function, const combination)
            cjson = json.dumps(consts, sort_keys=True, default=str)
            import hashlib as _hl

            chash = _hl.sha256(cjson.encode()).hexdigest()[:16]
            table_id += f":{sym_idx}:{chash}"
            persist_key += f"|{sym_idx}|{cjson}"
            call_extra = (sym_idx, consts)
        tname = self.tables.register(
            table_id,
            lambda v, _n=name, _o=oracle, _e=call_extra: _numeric_oracle(
                _o, _n, v, extra=_e
            ),
            dtype="float64",
            persist_key=persist_key,
        )
        self.signature.append(("table", tname))
        if isinstance(arg, SScalar):
            ids = arg.vid()
            base_def = arg.exists()
        else:
            ids = arg.ids()
            base_def = e_cmp("!=", arg.ids(), ELit(-1))
        num = EStrTable(tname, ids, default=0.0)
        dfn = e_and(base_def, EStrTable(tname + "!def", ids, default=False))
        return [(SDerived(num=num, defined=dfn), st)]

    def _fn_arg_scalar(self, name: str, sym_idx: int = 0) -> bool:
        """True if the function never walks into its SYMBOLIC formal
        (required for vid-keyed tableization; const formals pass whole
        frozen values to the oracle, so walking them is fine)."""
        for rule in self.rules.get(name, []):
            head_args = rule.head.args or []
            formals = {
                f.name
                for i, f in enumerate(head_args)
                if isinstance(f, A.Var) and i == sym_idx
            }
            bad = []

            def visit(node):
                if (
                    isinstance(node, A.Ref)
                    and isinstance(node.head, A.Var)
                    and node.head.name in formals
                    and node.ops
                ):
                    bad.append(node.head.name)

            import dataclasses as _dc

            def walk(n):
                if isinstance(n, A.Node):
                    visit(n)
                    for f in _dc.fields(n):
                        walk(getattr(n, f.name))
                elif isinstance(n, (list, tuple)):
                    for x in n:
                        walk(x)

            walk(rule)
            if bad:
                return False
        return True

    def _fn_reads_params(self, name: str, seen: set) -> bool:
        """True if the function's call graph touches input.parameters
        (then its table must stay per-params)."""
        if name in seen:
            return False
        seen.add(name)
        reads = []

        def visit(node):
            if (
                isinstance(node, A.Ref)
                and isinstance(node.head, A.Var)
                and node.head.name == "input"
            ):
                reads.append("input")
            if isinstance(node, A.Call):
                base = (
                    node.name.split(".")[-1] if "." in node.name
                    else node.name
                )
                if base in self.rules and self._fn_reads_params(base, seen):
                    reads.append(base)
            if isinstance(node, A.Ref) and isinstance(node.head, A.Var):
                if node.head.name in self.rules and self._fn_reads_params(
                    node.head.name, seen
                ):
                    reads.append(node.head.name)

        import dataclasses as _dc

        def walk(n):
            if isinstance(n, A.Node):
                visit(n)
                for f in _dc.fields(n):
                    walk(getattr(n, f.name))
            elif isinstance(n, (list, tuple)):
                for x in n:
                    walk(x)

        for rule in self.rules.get(name, []):
            walk(rule)
        return bool(reads)

    def _fn_is_pure(self, name: str, seen: set) -> bool:
        """No input.review / data refs anywhere in the call graph
        (input.parameters is concrete and allowed)."""
        if name in seen:
            return True
        seen.add(name)
        from ..constraint.regocompile import walk_module as _walk_rules

        impure = []

        def visit(node):
            if isinstance(node, A.Ref) and isinstance(node.head, A.Var):
                if node.head.name == "data":
                    impure.append("data")
                if node.head.name in self.rules and not self._fn_is_pure(
                    node.head.name, seen
                ):
                    impure.append(node.head.name)
                if node.head.name == "input":
                    if (
                        node.ops
                        and isinstance(node.ops[0], A.Scalar)
                        and node.ops[0].value == "parameters"
                    ):
                        return
                    impure.append("input")
            if isinstance(node, A.Call):
                base = node.name.split(".")[-1] if "." in node.name else node.name
                if base in self.rules and not self._fn_is_pure(base, seen):
                    impure.append(base)

        import dataclasses as _dc

        def walk(n):
            if isinstance(n, A.Node):
                visit(n)
                for f in _dc.fields(n):
                    walk(getattr(n, f.name))
            elif isinstance(n, (list, tuple)):
                for x in n:
                    walk(x)

        for rule in self.rules.get(name, []):
            walk(rule)
        return not impure

    # -- binops -------------------------------------------------------------

    def _eval_binop(self, term: A.BinOp, st: State):
        out = []
        for lv, s1 in self._eval_term(term.lhs, st):
            for rv, s2 in self._eval_term(term.rhs, s1):
                r = self._apply_binop(term.op, lv, rv, s2)
                if r is not None:
                    out.append(r)
        return out

    def _apply_binop(self, op: str, lv: SVal, rv: SVal, st: State):
        if isinstance(lv, SInventory) or isinstance(rv, SInventory):
            # equality joins between a review-side leaf and inventory
            # content record the leaf's pattern: the dispatch layer then
            # supplies a per-row "join key duplicated in the inventory"
            # feature that SHARPENS the screen (rows whose keys are
            # unique cluster-wide cannot violate a uniqueness join and
            # need no interpreter re-check).
            # The _no_inv_catch guard is load-bearing for soundness: it
            # restricts recording to TOP-LEVEL clause conjuncts. Inside
            # negations the join is anti-monotone, and inside function/
            # rule/comprehension bodies the equality may sit in ONE of
            # several definitions — ANDing the refinement into the whole
            # clause would wrongly screen forks that can violate without
            # the join (those constructs run under the _inv_barrier).
            if op == "==" and self._no_inv_catch == 0:
                # derived-key join (flatten_selector idiom): BOTH sides
                # opaque results of the same pure helper F, one over a
                # review subdocument, one over a full-tree inventory
                # walk. The clause then implies F(other) == F(review
                # side), so the interpreter render may soundly restrict
                # the inventory to a host-built F-key index's candidates
                # (VERDICT r3 #4: uniqueserviceselector at scale).
                if (
                    isinstance(lv, SInventory)
                    and isinstance(rv, SInventory)
                ):
                    tags = {}
                    for t in (lv.call_tag, rv.call_tag):
                        if t is not None:
                            tags[t[0]] = t
                    if (
                        len(tags) == 2
                        and tags["rev"][1] == tags["inv"][1]
                        and self._fn_is_pure(tags["rev"][1], set())
                    ):
                        walk = tags["inv"][2]
                        tree = walk[0] if walk else None
                        depth_ok = (
                            tree == "namespace" and len(walk) == 5
                            or tree == "cluster" and len(walk) == 4
                        ) and all(s == "?" for s in walk[1:])
                        if depth_ok:
                            self._clause_prunes.append(
                                (tags["rev"][1], tags["rev"][2], tree)
                            )
                inv = lv if isinstance(lv, SInventory) else rv
                other = rv if isinstance(lv, SInventory) else lv
                try:
                    leaf = self._leafify(other)
                except CompileUnsupported:
                    leaf = None
                if (
                    isinstance(leaf, SScalar)
                    and leaf.pattern_idx >= 0
                    and leaf.num_override is None
                    and leaf.vid_override is None
                    and isinstance(inv, SInventory)
                ):
                    mirror = self._mirror_pattern_for(
                        inv, leaf.pattern_idx
                    )
                    if mirror is not None:
                        self._clause_joins.append(
                            (leaf.pattern_idx, mirror, inv.root)
                        )
                    # path-key join (uniqueingresshost idiom): a review
                    # leaf equality-joined against a PATH deref of the
                    # walked object (`other.spec.rules[_].host == host`).
                    # Record a path-form prune: the render may restrict
                    # the inventory to objects carrying one of the
                    # review's key values at that relative path — the
                    # top-level equality conjunct guarantees every
                    # violating partner shares a key (VERDICT r4 weak
                    # #5; reference
                    # library/general/uniqueingresshost/src.rego).
                    rel = self._inv_rel_path(inv)
                    psegs = self.patterns.segs(leaf.pattern_idx)
                    if rel is not None and "**" not in psegs:
                        self._clause_prunes.append(
                            ("path", rel, psegs, inv.path[0])
                        )
            raise InventoryDependent()
        if isinstance(lv, SConst) and isinstance(rv, SConst):
            return self._const_binop(op, lv, rv, st)
        if op in ("==", "!=", "<", "<=", ">", ">="):
            return self._sym_cmp(op, lv, rv, st)
        if op in ("+", "-", "*", "/", "%"):
            if op == "-" and isinstance(lv, (SConst, STokenSet)) and (
                isinstance(rv, (SConst, STokenSet))
            ):
                maybe = self._set_difference(lv, rv, st)
                if maybe is not None:
                    return maybe
            return self._sym_arith(op, lv, rv, st)
        if op in ("&", "|"):
            raise CompileUnsupported("symbolic set intersection/union", code=Reason.BINOP)
        raise CompileUnsupported(f"binop {op}", code=Reason.BINOP)

    def _mirror_pattern_for(
        self, inv: "SInventory", leaf_pid: int
    ) -> Optional[int]:
        """The partner-side counting pattern for an inventory equality
        join, or None when the refinement must be skipped (ADVICE r3
        high: refining a cross-path join at the review leaf's own
        pattern under-approximates and misses violations).

        Sound iff every concrete partner token path consistent with the
        walk matches the returned pattern AND the leaf's own pattern is
        a sub-pattern of it (so the row self-counts, keeping the
        duplicate threshold meaningful). That holds when the walk
        addresses an object root (data.inventory.namespace[.][.][.][.]
        or .cluster[.][.][.]) and the remaining segments positionally
        mirror the leaf pattern: equal literals, or "?" (var-iterated —
        "?" matches ANY one segment, so it covers both the partner's
        real structure and the leaf's "#"/"*" position)."""
        if inv.path is None or not inv.path:
            return None
        if inv.path[0] == "namespace" and len(inv.path) >= 5:
            obj = inv.path[5:]
        elif inv.path[0] == "cluster" and len(inv.path) >= 4:
            obj = inv.path[4:]
        else:
            return None
        psegs = self.patterns.segs(leaf_pid)
        # partners are inventory objects encoded as synthesized reviews,
        # so their tokens live under the "object" root; a leaf outside
        # it (e.g. oldObject) cannot self-count — skip. A "**" leaf
        # matches variable depth, which no fixed-length mirror covers
        # (the row would not self-count at depths the mirror misses).
        if not psegs or psegs[0] != "object" or "**" in psegs:
            return None
        body = psegs[1:]
        if len(body) != len(obj):
            return None
        mirror: List[str] = ["object"]
        for p, m in zip(body, obj):
            if m == "?":
                mirror.append("?")
            elif p == m and p not in ("*", "?", "**"):
                mirror.append(m)
            else:
                return None
        if tuple(mirror) == tuple(psegs):
            return leaf_pid
        return self._pattern(tuple(mirror))

    def _note_self_exclusion(self, inner: A.Expr, st: State) -> None:
        """Detect the uniqueness-template self-exclusion idiom
        `not identical(<inventory obj>, input.review)` (reference:
        library/general/uniqueingresshost/src.rego identical/2) while
        its InventoryDependent escapes the negation barrier.

        Without a proven self-exclusion an object can join with ITSELF
        (it is part of the synced inventory), so "key carried by >=2
        distinct rows" no longer bounds violations and the refinement
        threshold must drop to 1. Records (inventory root, guard
        pattern ids) — the guard paths are the identity fields the
        proof needs DEFINED on the row (an object missing one, e.g.
        metadata.namespace on a cluster-scoped kind, makes identical()
        undefined and the exclusion void for that row)."""
        if not isinstance(inner, A.TermExpr) or not isinstance(
            inner.term, A.Call
        ):
            return
        call = inner.term
        if call.name not in self.rules or len(call.args) != 2:
            return
        a0 = call.args[0]
        if not isinstance(a0, A.Var):
            return
        inv = st.env.get(a0.name)
        if not isinstance(inv, SInventory) or inv.path is None:
            return
        rootlen = (
            5 if inv.path[:1] == ("namespace",)
            else 4 if inv.path[:1] == ("cluster",)
            else -1
        )
        if rootlen < 0 or len(inv.path) != rootlen:
            return
        if not _is_review_ref(call.args[1], st):
            return
        for rule in self.rules[call.name]:
            gpaths = _self_identity_paths(rule)
            if gpaths is not None:
                gpids = tuple(
                    self._pattern(
                        ("object",) + tuple(esc_seg(s) for s in gp)
                    )
                    for gp in gpaths
                )
                self._clause_guards.append((inv.root, gpids))
                return

    def _const_binop(self, op: str, lv: SConst, rv: SConst, st: State):
        from ..rego.values import freeze, rego_cmp

        if lv.value is _ARRAY_INDEX or rv.value is _ARRAY_INDEX:
            # array-index binding compared to a concrete value: unknown
            # number vs (usually) string — only == / != are decidable when
            # the other side is not a number
            other = rv.value if lv.value is _ARRAY_INDEX else lv.value
            if op == "==" and not isinstance(other, (int, float)):
                return (SConst(False), st)
            if op == "!=" and not isinstance(other, (int, float)):
                return (SConst(True), st)
            raise CompileUnsupported("comparison with array index", code=Reason.COMPARISON)
        if op in ("==", "!=", "<", "<=", ">", ">="):
            c = rego_cmp(freeze(lv.value), freeze(rv.value))
            res = {
                "==": c == 0,
                "!=": c != 0,
                "<": c < 0,
                "<=": c <= 0,
                ">": c > 0,
                ">=": c >= 0,
            }[op]
            return (SConst(res), st)
        a, b = lv.value, rv.value
        if isinstance(a, (set, frozenset)) and isinstance(b, (set, frozenset)):
            res = {"-": a - b, "&": a & b, "|": a | b}.get(op)
            if res is None:
                raise CompileUnsupported("const set op", code=Reason.BINOP)
            return (SConst(res), st)
        if (
            isinstance(a, (int, float))
            and isinstance(b, (int, float))
            and not isinstance(a, bool)
            and not isinstance(b, bool)
        ):
            if op in ("/", "%") and b == 0:
                return None
            res = {
                "+": a + b,
                "-": a - b,
                "*": a * b,
                "/": a / b if b != 0 else None,
                "%": a % b if b != 0 else None,
            }[op]
            return (SConst(res), st)
        raise CompileUnsupported("const binop types", code=Reason.BINOP)

    def _set_difference(self, lv: SVal, rv: SVal, st: State):
        """Set difference where at least one side is token-derived."""
        if isinstance(lv, SConst) and isinstance(rv, STokenSet):
            if not isinstance(lv.value, (set, frozenset)):
                return None
            elems = [v for v in lv.value]
            if not all(_is_scalar_const(v) for v in elems):
                raise CompileUnsupported("const set of composites", code=Reason.BINOP)
            # count(missing) = #elems whose id never appears in the token set
            self.signature.append(("constdiff", len(elems)))
            if not elems:
                return (SDerived(num=EFullN(0), defined=ELit(True)), st)
            terms = []
            for v in elems:
                vid = self.vocab.val_id(_norm_num(v))
                slot = self.pool.id_scalar(vid)
                present = rv.reduce_any(e_cmp("==", rv.elem_ids, slot))
                terms.append(
                    EMap(
                        lambda xp_, p: xp_.astype(~p, xp_.int32), [present], "miss"
                    )
                )
            cnt = terms[0]
            for t in terms[1:]:
                cnt = e_arith("+", cnt, t)
            return (
                SDerived(
                    num=cnt,
                    defined=ELit(True),
                    render=("constdiff", tuple(elems), rv),
                ),
                st,
            )
        if isinstance(lv, STokenSet) and isinstance(rv, SConst):
            if not isinstance(rv.value, (set, frozenset)):
                return None
            elems = [v for v in rv.value if _is_scalar_const(v)]
            ids = [self.vocab.val_id(_norm_num(v)) for v in elems]
            slot = self.pool.id_set(ids)
            self.signature.append(("idset", len(self.pool.values[slot])))
            mask = e_and(lv.mask, e_not(EIsInConst(lv.elem_ids, slot)))
            return (STokenSet(mask, lv.elem_ids, lv.axes), st)
        if isinstance(lv, STokenSet) and isinstance(rv, STokenSet):
            raise CompileUnsupported("token-set minus token-set", code=Reason.BINOP)
        return None

    def _sym_arith(self, op: str, lv: SVal, rv: SVal, st: State):
        ln, rn = self._as_num(lv), self._as_num(rv)
        if ln is None or rn is None:
            raise CompileUnsupported("non-numeric arithmetic", code=Reason.BINOP)
        val = e_arith(op, ln[0], rn[0])
        defined = e_and(ln[1], rn[1])
        if op in ("/", "%"):
            defined = e_and(defined, e_cmp("!=", rn[0], ELit(0.0)))
        return (SDerived(num=val, defined=defined), st)

    def _as_num(self, v: SVal):
        v = self._leafify(v)
        if isinstance(v, SConst):
            if isinstance(v.value, bool) or not isinstance(
                v.value, (int, float)
            ):
                return None
            slot = self.pool.scalar(float(v.value))
            self.signature.append(("num",))
            return (slot, ELit(True))
        if isinstance(v, SDerived):
            return (v.num, v.defined)
        if isinstance(v, SScalar):
            if v.num_override is not None:
                return (v.num_override, v.exists())
            return (
                v.num(),
                e_and(v.exists(), e_cmp("==", v.kindv(), ELit(K_NUM))),
            )
        return None

    def _materialize_msg(self, v: SVal) -> SVal:
        """SMsg with a transform recipe -> derived SScalar (comparison
        position forces the lazy sprintf into an id-transform table)."""
        if isinstance(v, SMsg) and v.recipe is not None:
            fv, arg = v.recipe
            forks = self._str_transform(
                arg,
                State(env={}),
                f"sprintf:{fv}",
                lambda s, _f=fv: _f.replace("%v", s, 1),
            )
            if forks:
                part = forks[0][0]
                if isinstance(part, SScalar):
                    return replace(part, msg_sig=v.sig)
                return part
        return v

    def _sym_eq(self, lv: SVal, rv: SVal) -> Tuple[Expr, bool]:
        lv, rv = self._leafify(lv), self._leafify(rv)
        lv, rv = self._materialize_msg(lv), self._materialize_msg(rv)
        if isinstance(lv, SConst) and not isinstance(rv, SConst):
            lv, rv = rv, lv
        if isinstance(rv, SConst):
            cv = rv.value
            if isinstance(lv, SDerived):
                if isinstance(cv, bool) or not isinstance(cv, (int, float)):
                    return ELit(False), True
                slot = self.pool.scalar(float(cv))
                self.signature.append(("num",))
                return e_and(lv.defined, e_cmp("==", lv.num, slot)), True
            if isinstance(lv, SScalar):
                if lv.num_override is not None:
                    if isinstance(cv, bool) or not isinstance(
                        cv, (int, float)
                    ):
                        return ELit(False), True
                    slot = self.pool.scalar(float(cv))
                    self.signature.append(("num",))
                    return (
                        e_and(
                            lv.exists(),
                            e_cmp("==", lv.num_override, slot),
                        ),
                        True,
                    )
                if _is_scalar_const(cv):
                    slot = self.pool.id_scalar(
                        self.vocab.val_id(_norm_num(cv))
                    )
                    self.signature.append(("id",))
                    return (
                        e_and(lv.exists(), e_cmp("==", lv.vid(), slot)),
                        True,
                    )
                return ELit(False), True
            if isinstance(lv, SKey):
                if isinstance(cv, str):
                    slot = self.pool.id_scalar(self.vocab.str_id(cv))
                    self.signature.append(("id",))
                    return e_cmp("==", lv.ids(), slot), True
                return ELit(False), True
            raise CompileUnsupported("eq const shape", code=Reason.COMPARISON)
        if isinstance(lv, SKey) and isinstance(rv, SScalar):
            lv, rv = rv, lv
        if isinstance(lv, SScalar) and isinstance(rv, SKey):
            return (
                e_and(
                    e_and(lv.exists(), e_cmp("==", lv.kindv(), ELit(K_STR))),
                    e_cmp("==", lv.vid(), rv.ids()),
                ),
                True,
            )
        if isinstance(lv, SKey) and isinstance(rv, SKey):
            return e_cmp("==", lv.ids(), rv.ids()), True
        if isinstance(lv, SScalar) and isinstance(rv, SScalar):
            # vid identity is exact whenever both sides HAVE a vid: a
            # num_override alone marks a derived number (no vid), but
            # projected subfields carry BOTH overrides and must compare
            # by typed id, not by lossy vnum
            l_vid = lv.num_override is None or lv.vid_override is not None
            r_vid = rv.num_override is None or rv.vid_override is not None
            if l_vid and r_vid:
                return (
                    e_and(
                        e_and(lv.exists(), rv.exists()),
                        e_cmp("==", lv.vid(), rv.vid()),
                    ),
                    True,
                )
        ln, rn = self._as_num(lv), self._as_num(rv)
        if ln and rn:
            return (
                e_and(e_and(ln[1], rn[1]), e_cmp("==", ln[0], rn[0])),
                True,
            )
        return ELit(False), False

    def _sym_cmp(self, op: str, lv: SVal, rv: SVal, st: State):
        lv, rv = self._leafify(lv), self._leafify(rv)
        if op in ("==", "!="):
            cond, ok = self._sym_eq(lv, rv)
            if not ok:
                raise CompileUnsupported("eq shapes", code=Reason.COMPARISON)
            if op == "!=":
                defs = []
                for v in (lv, rv):
                    if isinstance(v, SScalar):
                        defs.append(v.exists())
                    elif isinstance(v, SDerived):
                        defs.append(v.defined)
                cond = e_not(cond)
                for d in defs:
                    cond = e_and(cond, d)
            return (SBool(cond), st)
        ln, rn = self._as_num(lv), self._as_num(rv)
        if ln and rn:
            return (SBool(e_and(e_and(ln[1], rn[1]), e_cmp(op, ln[0], rn[0]))), st)
        if (
            isinstance(lv, SScalar)
            and lv.num_override is None
            and isinstance(rv, SConst)
            and isinstance(rv.value, str)
        ):
            tname = self.tables.register(
                f"cmp{op}:{rv.value}",
                lambda s, _c=rv.value, _o=op: (
                    {"<": s < _c, "<=": s <= _c, ">": s > _c, ">=": s >= _c}[
                        _o
                    ],
                    True,
                ),
                dtype=bool,
            )
            self.signature.append(("table", tname))
            cond = e_and(
                e_and(
                    lv.exists(), e_cmp("==", lv.kindv(), ELit(K_STR))
                ),
                EStrTable(tname, lv.vid()),
            )
            return (SBool(cond), st)
        raise CompileUnsupported(f"cmp {op} shapes", code=Reason.COMPARISON)

    # -- conditions ---------------------------------------------------------

    def _eval_cond_term(self, term: A.Term, st: State) -> List[State]:
        out = []
        for v, s in self._eval_term(term, st):
            c = self._truthiness(v, s)
            if c is None:
                continue
            if c is True:
                out.append(s)
            else:
                out.append(replace(s, cond=s.cond + [c]))
        return out

    def _truthiness(self, v: SVal, st: State):
        if isinstance(v, SInventory):
            raise InventoryDependent()
        if isinstance(v, SConst):
            return True if v.value is not False else None
        if isinstance(v, SBool):
            return v.expr
        if isinstance(v, SDerived):
            return v.defined
        if isinstance(v, SScalar):
            return v.truthy()
        if isinstance(v, SNode):
            return self._node_truthy(v)
        if isinstance(v, SElemProj):
            return self._elem_proj_truthy(v)
        if isinstance(v, (SMsg, SKey, STokenSet, SList)):
            return True
        raise CompileUnsupported(f"truthiness {type(v).__name__}", code=Reason.TRUTHINESS)

    def _node_truthy(self, node: SNode) -> Expr:
        """Node exists and is not the literal false."""
        if "*" in node.prefix:
            raise CompileUnsupported("node truthy under object iteration", code=Reason.OBJECT_ITERATION)
        deep = self._pattern(node.prefix + ("**",))
        axes = _axes_of(node.prefix)
        exact = self._pattern(node.prefix)
        false_id = ELit(self.false_id)
        sel_deep = ESelPattern(deep)
        sel_exact = ESelPattern(exact)
        is_false_leaf = e_and(
            sel_exact, e_cmp("==", ETokCol("vid"), false_id)
        )
        good = e_and(sel_deep, e_not(is_false_leaf))
        if not axes:
            return EReduce(good, "any")
        if axes in (("g0",), ("g01",)):
            return EGroup(good, None, axes[0], how="any")
        raise CompileUnsupported("node truthy axes", code=Reason.AXIS_SHAPE)

    # -- comprehensions ------------------------------------------------------

    def _eval_comprehension(self, term: A.Comprehension, st: State):
        """Set/array comprehension.

        The body evaluates in the OUTER state (bindings like `container`
        stay live); axes already open outside remain the set's grouping
        axes, axes/token-selections opened inside become the set's element
        dimension.
        """
        if term.kind == "object":
            raise CompileUnsupported("object comprehension", code=Reason.COMPREHENSION)
        sub = State(env=dict(st.env), space=st.space, guards=dict(st.guards), axis_owner=dict(st.axis_owner))
        with self._inv_barrier():
            finals = self._eval_body(term.body, sub)
        if not finals:
            if term.kind == "set":
                return [(SConst(set()), st)]
            return [(SConst([]), st)]
        # concrete-iteration comprehension (possibly with symbolic heads
        # and per-fork guards, e.g. allowedrepos' [good | repo =
        # params.repos[_]; good = startswith(container.image, repo)])
        if all(
            f.space == st.space and f.guards == st.guards for f in finals
        ):
            vals: List[Tuple[Optional[Expr], SVal]] = []
            for f in finals:
                guard: Optional[Expr] = None
                extra = [c for c in f.cond if c not in st.cond]
                for c in extra:
                    guard = c if guard is None else e_and(guard, c)
                for hv, hs in self._eval_term(term.head, f):
                    vals.append((guard, hv))
            if all(g is None and isinstance(v, SConst) for g, v in vals):
                elems = [v.value for _, v in vals]
                if term.kind == "set":
                    return [(SConst(set(_hashable(e) for e in elems)), st)]
                return [(SConst(elems), st)]
            if all(isinstance(v, (SConst, SBool)) for _, v in vals):
                return [(SList(vals), st)]
        outer_axes = tuple(a for a in st.space if a in ("g0", "g1"))
        pieces: List[Tuple[Expr, Expr]] = []  # (mask, elem_ids)
        for f in finals:
            hf = self._eval_term(term.head, f)
            for hv, hs in hf:
                if isinstance(hv, SNode):
                    hv = self._node_leaf(hv)
                if isinstance(hv, SConst) and hv.value is _ARRAY_INDEX:
                    # array-iteration indices as elements: numeric indices
                    # never collide with interned string/value ids, so this
                    # branch's contribution to set algebra is empty
                    continue
                if hs.proj and not st.proj:
                    # projected conds are per-token stand-ins; a set
                    # comprehension would materialize per-token
                    # duplicates (count() over it would inflate)
                    raise CompileUnsupported("element projection in comprehension", code=Reason.COMPREHENSION)
                inner_conds = list(hs.cond)
                if isinstance(hv, SKey):
                    mask: Expr = ESelPattern(hv.pattern_idx)
                    elem: Expr = hv.ids()
                elif isinstance(hv, SScalar) and hv.tok_space:
                    mask = hv.sel()
                    elem = ETokCol("vid")
                elif (
                    isinstance(hv, SScalar)
                    and hv.num_override is None
                    and hv.pattern_idx >= 0
                ):
                    # valid shapes: elements one or two array levels below
                    # the outer binding — idx0-grouping covers both since
                    # the first array level IS the outer axis
                    ok = (
                        not outer_axes
                        or (
                            outer_axes == ("g0",)
                            and hv.axes in (("g0",), ("g01",))
                        )
                    )
                    if not ok:
                        raise CompileUnsupported("comprehension axis mismatch", code=Reason.COMPREHENSION)
                    mask = hv.sel()
                    elem = ETokCol("vid")
                else:
                    raise CompileUnsupported("comprehension head shape", code=Reason.COMPREHENSION)
                for c in inner_conds:
                    if c.space not in ((), ("tok",)):
                        raise CompileUnsupported("comprehension cond space", code=Reason.COMPREHENSION)
                    mask = e_and(mask, c)
                pieces.append((mask, elem))
        if not pieces:
            return [(SConst(set() if term.kind == "set" else []), st)]
        if len(pieces) == 1:
            return [(STokenSet(pieces[0][0], pieces[0][1], outer_axes), st)]
        # union of branches: token selections over the same [N, L] space
        # are disjoint per token, so elem ids can be merged positionally
        mask = pieces[0][0]
        for m, _ in pieces[1:]:
            mask = e_or(mask, m)
        elem = pieces[0][1]
        for m, e in pieces[1:]:
            elem = e_where(m, e, elem)
        return [(STokenSet(mask, elem, outer_axes), st)]

    # -- builtins ------------------------------------------------------------

    def _builtin_count(self, args: List[SVal], st: State):
        (v,) = args
        if isinstance(v, SConst):
            try:
                return [(SConst(len(v.value)), st)]
            except TypeError:
                return []
        if isinstance(v, STokenSet):
            return [(SDerived(num=v.reduce_count(), defined=ELit(True)), st)]
        if isinstance(v, SDerived):
            return [(v, st)]  # const-diff counts are already numbers
        if isinstance(v, SList):
            if all(g is None for g, _ in v.items):
                return [(SConst(len(v.items)), st)]
            terms = []
            for g, _ in v.items:
                if g is None:
                    terms.append(EFullN(1))
                else:
                    terms.append(
                        EMap(lambda xp_, c: xp_.astype(c, xp_.int32), [g], "toint")
                    )
            cnt = terms[0]
            for t in terms[1:]:
                cnt = e_arith("+", cnt, t)
            return [(SDerived(num=cnt, defined=ELit(True)), st)]
        if isinstance(v, SNode):
            # count of an abstract node: number of ARRAY elements (distinct
            # indices present). Exact for arrays — the library's only
            # count-of-document usage (tls lists etc.); object/string counts
            # are not compiled.
            if "*" in v.prefix:
                raise CompileUnsupported("count under object iteration", code=Reason.OBJECT_ITERATION)
            child = v.prefix + ("#", "**")
            axes = _axes_of(child)
            pat = self._pattern(child)
            present = EGroupPresent(ESelPattern(pat), axes[-1])
            if len(axes) > 1:
                raise CompileUnsupported("count of nested array", code=Reason.AGGREGATE_ARG)
            cnt = EReduce(
                EMap(
                    lambda xp_, p: xp_.astype(p, xp_.int32), [present], "toint"
                ),
                "sum",
            )
            # defined only when the node IS an array (has elements or is
            # the empty-array token) or... count of undefined is undefined;
            # count of {} / "" is 0. Approximation: defined iff node exists.
            deep = self._pattern(v.prefix + ("**",))
            exists = EReduce(ESelPattern(deep), "any")
            return [(SDerived(num=cnt, defined=exists), st)]
        raise CompileUnsupported("count arg", code=Reason.AGGREGATE_ARG)

    def _builtin_any(self, args: List[SVal], st: State):
        (v,) = args
        if isinstance(v, SConst):
            try:
                return [(SConst(any(x is True for x in v.value)), st)]
            except TypeError:
                return []
        if isinstance(v, SList):
            exprs = []
            for guard, item in v.items:
                if isinstance(item, SConst):
                    if item.value is True:
                        if guard is None:
                            return [(SConst(True), st)]
                        exprs.append(guard)
                elif isinstance(item, SBool):
                    e = item.expr if guard is None else e_and(guard, item.expr)
                    exprs.append(e)
            if not exprs:
                return [(SConst(False), st)]
            out = exprs[0]
            for e in exprs[1:]:
                out = e_or(out, e)
            return [(SBool(out), st)]
        if isinstance(v, STokenSet):
            # any over a token-set of booleans: true iff the set contains
            # the literal true
            true_slot = self.pool.id_scalar(self.vocab.val_id(True))
            self.signature.append(("id",))
            return [
                (
                    SBool(
                        v.reduce_any(e_cmp("==", v.elem_ids, true_slot))
                    ),
                    st,
                )
            ]
        raise CompileUnsupported("any arg", code=Reason.AGGREGATE_ARG)

    def _builtin_all(self, args: List[SVal], st: State):
        (v,) = args
        if isinstance(v, SConst):
            try:
                return [(SConst(all(x is True for x in v.value)), st)]
            except TypeError:
                return []
        if isinstance(v, SList):
            exprs = []
            for guard, item in v.items:
                if isinstance(item, SConst):
                    if item.value is not True:
                        if guard is None:
                            return [(SConst(False), st)]
                        exprs.append(e_not(guard))
                elif isinstance(item, SBool):
                    e = item.expr if guard is None else e_or(e_not(guard), item.expr)
                    exprs.append(e)
            if not exprs:
                return [(SConst(True), st)]
            out = exprs[0]
            for e in exprs[1:]:
                out = e_and(out, e)
            return [(SBool(out), st)]
        raise CompileUnsupported("all arg", code=Reason.AGGREGATE_ARG)

    def _builtin_re_match(self, args, st: State):
        pat, target = args
        if not isinstance(pat, SConst) or not isinstance(pat.value, str):
            raise CompileUnsupported("symbolic regex pattern", code=Reason.BUILTIN_ARG_SHAPE)
        if isinstance(target, SConst):
            import re as _re

            if not isinstance(target.value, str):
                return []
            try:
                return [
                    (
                        SConst(
                            _re.search(pat.value, target.value) is not None
                        ),
                        st,
                    )
                ]
            except _re.error:
                return []
        tname = self.tables.regex(pat.value)
        self.signature.append(("table", tname))
        ids, defined = self._string_ids(target)
        return [(SBool(e_and(defined, EStrTable(tname, ids))), st)]

    def _builtin_startswith(self, args, st):
        return self._strpred(args, st, self.tables.prefix, lambda s, p: s.startswith(p))

    def _builtin_endswith(self, args, st):
        return self._strpred(args, st, self.tables.suffix, lambda s, p: s.endswith(p))

    def _builtin_contains(self, args, st):
        return self._strpred(args, st, self.tables.contains, lambda s, p: p in s)

    def _strpred(self, args, st, mk, concrete):
        target, pat = args
        if not isinstance(pat, SConst) or not isinstance(pat.value, str):
            raise CompileUnsupported("symbolic string-pred arg", code=Reason.BUILTIN_ARG_SHAPE)
        if isinstance(target, SConst):
            if not isinstance(target.value, str):
                return []
            return [(SConst(concrete(target.value, pat.value)), st)]
        tname = mk(pat.value)
        self.signature.append(("table", tname))
        ids, defined = self._string_ids(target)
        return [(SBool(e_and(defined, EStrTable(tname, ids))), st)]

    def _str_transform(self, v, st, name, fn):
        v = self._leafify(v)
        if isinstance(v, SConst):
            if not isinstance(v.value, str):
                return []
            return [(SConst(fn(v.value)), st)]
        ids, defined = self._string_ids(v)
        tname = self.tables.str_transform(name, fn)
        self.signature.append(("table", tname))
        out_ids = EStrTable(tname, ids, default=-1)
        space = ids.space
        return [
            (
                SScalar(
                    self,
                    pattern_idx=-1,
                    axes=space if space != ("tok",) else (),
                    tok_space=space == ("tok",),
                    vid_override=out_ids,
                    exists_override=defined,
                ),
                st,
            )
        ]

    def _builtin_lower(self, args, st):
        return self._str_transform(args[0], st, "lower", lambda x: x.lower())

    def _builtin_upper(self, args, st):
        return self._str_transform(args[0], st, "upper", lambda x: x.upper())

    def _builtin_trim(self, args, st):
        target, cutset = args
        if not isinstance(cutset, SConst) or not isinstance(cutset.value, str):
            raise CompileUnsupported("symbolic trim cutset", code=Reason.BUILTIN_ARG_SHAPE)
        c = cutset.value
        return self._str_transform(
            target, st, f"trim:{c}", lambda x, _c=c: x.strip(_c)
        )

    def _builtin_trim_prefix(self, args, st):
        target, pre = args
        if not isinstance(pre, SConst) or not isinstance(pre.value, str):
            raise CompileUnsupported("symbolic trim_prefix arg", code=Reason.BUILTIN_ARG_SHAPE)
        c = pre.value
        return self._str_transform(
            target,
            st,
            f"trimpre:{c}",
            lambda x, _c=c: x[len(_c):] if x.startswith(_c) else x,
        )

    def _builtin_sprintf(self, args, st):
        fmt, arglist = args
        if isinstance(fmt, SConst) and isinstance(arglist, (SConst, SList)):
            items = (
                [v for _, v in arglist.items]
                if isinstance(arglist, SList)
                else [SConst(v) for v in arglist.value]
                if isinstance(arglist.value, list)
                else None
            )
            if items is not None:
                sig = (
                    "sprintf",
                    fmt.value,
                    tuple(_val_sig(v) for v in items),
                )
                # value-position form: a single symbolic string argument
                # with one %v verb compiles to an id transform so the
                # result can join/compare (apparmor's annotation-key
                # construction); the msg_sig keeps head-dedup semantics
                arg0 = None
                if len(items) == 1:
                    try:
                        arg0 = self._leafify(items[0])
                    except CompileUnsupported:
                        arg0 = None
                if (
                    arg0 is not None
                    and isinstance(fmt.value, str)
                    and fmt.value.count("%") == 1
                    and "%v" in fmt.value
                    and isinstance(arg0, (SScalar, SKey))
                    and not (
                        isinstance(arg0, SScalar)
                        and arg0.num_override is not None
                    )
                ):
                    # lazily materializable (see SMsg.recipe)
                    return [
                        (
                            SMsg(
                                sig=sig,
                                recipe=(fmt.value, arg0),
                                parts=("sprintf", fmt.value, tuple(items)),
                            ),
                            st,
                        )
                    ]
                return [
                    (
                        SMsg(
                            sig=sig,
                            parts=("sprintf", fmt.value, tuple(items)),
                        ),
                        st,
                    )
                ]
        return [(SMsg(), st)]

    def _builtin_concat(self, args, st):
        if all(isinstance(a, SConst) for a in args):
            sep, items = args
            try:
                return [(SConst(sep.value.join(items.value)), st)]
            except Exception:
                return []
        return [(SMsg(), st)]

    def _builtin_is_number(self, args, st):
        (v,) = args
        v = self._leafify(v)
        if isinstance(v, SConst):
            return [
                (
                    SConst(
                        isinstance(v.value, (int, float))
                        and not isinstance(v.value, bool)
                    ),
                    st,
                )
            ]
        if isinstance(v, SDerived):
            return [(SBool(v.defined), st)]
        if isinstance(v, SScalar):
            if v.num_override is not None:
                return [(SBool(v.exists()), st)]
            return [
                (
                    SBool(
                        e_and(
                            v.exists(), e_cmp("==", v.kindv(), ELit(K_NUM))
                        )
                    ),
                    st,
                )
            ]
        raise CompileUnsupported("is_number arg", code=Reason.BUILTIN_ARG_SHAPE)

    def _builtin_is_string(self, args, st):
        (v,) = args
        v = self._leafify(v)
        if isinstance(v, SConst):
            return [(SConst(isinstance(v.value, str)), st)]
        if isinstance(v, SDerived):
            return [(SBool(ELit(False)), st)]
        if isinstance(v, SScalar):
            if v.num_override is not None:
                return [(SBool(ELit(False)), st)]
            return [
                (
                    SBool(
                        e_and(
                            v.exists(), e_cmp("==", v.kindv(), ELit(K_STR))
                        )
                    ),
                    st,
                )
            ]
        raise CompileUnsupported("is_string arg", code=Reason.BUILTIN_ARG_SHAPE)

    def _builtin_is_array(self, args, st):
        (v,) = args
        if isinstance(v, SConst):
            return [(SConst(isinstance(v.value, list)), st)]
        if isinstance(v, SNode):
            # an array node has element tokens or the empty-array token
            if "*" in v.prefix:
                raise CompileUnsupported("is_array under object iteration", code=Reason.OBJECT_ITERATION)
            elem_pat = self._pattern(v.prefix + ("#", "**"))
            exact = self._pattern(v.prefix)
            axes = _axes_of(v.prefix)
            from ..flatten.encoder import K_EMPTY_ARR

            empty_arr = e_and(
                ESelPattern(exact),
                e_cmp("==", ETokCol("kind"), ELit(K_EMPTY_ARR)),
            )
            arrish = e_or(ESelPattern(elem_pat), empty_arr)
            if not axes:
                return [(SBool(EReduce(arrish, "any")), st)]
            if axes in (("g0",), ("g01",)):
                return [
                    (SBool(EGroup(arrish, None, axes[0], how="any")), st)
                ]
            raise CompileUnsupported("is_array axes", code=Reason.AXIS_SHAPE)
        if isinstance(v, (SScalar, SKey, SDerived)):
            return [(SConst(False), st)] if not isinstance(v, SScalar) else [
                (SBool(ELit(False)), st)
            ]
        raise CompileUnsupported("is_array arg", code=Reason.BUILTIN_ARG_SHAPE)

    def _builtin_to_number(self, args, st):
        (v,) = args
        if isinstance(v, SDerived):
            # to_number of a number is the number itself
            return [(v, st)]
        v = self._leafify(v)
        if isinstance(v, SConst):
            try:
                if isinstance(v.value, bool):
                    return []
                return [(SConst(float(v.value)), st)]
            except (TypeError, ValueError):
                return []
        if isinstance(v, SScalar) and v.num_override is None:
            tname = self.tables.register("to_number", _to_number_host)
            self.signature.append(("table", tname))
            ids = v.vid()
            parsed = EStrTable(tname, ids, default=0.0)
            parsed_def = EStrTable(tname + "!def", ids, default=False)
            kind_num = e_cmp("==", v.kindv(), ELit(K_NUM))
            val = e_where(kind_num, v.num(), parsed)
            kind_str = e_cmp("==", v.kindv(), ELit(K_STR))
            dfn = e_and(
                v.exists(),
                e_or(kind_num, e_and(kind_str, parsed_def)),
            )
            return [(SDerived(num=val, defined=dfn), st)]
        raise CompileUnsupported("to_number arg", code=Reason.BUILTIN_ARG_SHAPE)

    def _leafify(self, v: SVal) -> SVal:
        """Materialize an abstract node as a leaf read where a scalar is
        consumed (builtin args, comparisons)."""
        if isinstance(v, SNode):
            return self._node_leaf(v)
        if isinstance(v, SElemProj):
            return self._elem_proj_scalar(v)
        return v

    def _string_ids(self, v: SVal) -> Tuple[Expr, Expr]:
        v = self._leafify(v)
        if isinstance(v, SScalar):
            if v.num_override is not None:
                raise CompileUnsupported("derived used as string", code=Reason.DERIVED_VALUE)
            return v.vid(), e_and(
                v.exists(), e_cmp("==", v.kindv(), ELit(K_STR))
            )
        if isinstance(v, SKey):
            return v.ids(), e_cmp("!=", v.ids(), ELit(-1))
        raise CompileUnsupported("string operand", code=Reason.BUILTIN_ARG_SHAPE)


def _freeze_sig(sig):
    """Signatures must be hashable dict keys."""
    try:
        hash(sig)
        return sig
    except TypeError:
        return ("unhashable", id(sig))


def _val_sig(v):
    """Render-signature of a symbolic value (see SMsg.sig)."""
    if isinstance(v, SConst):
        return ("c", _hashable(v.value))
    if isinstance(v, SMsg):
        return v.signature()
    if isinstance(v, SScalar):
        if v.msg_sig is not None:
            return v.msg_sig
        if v.pattern_idx >= 0 and v.num_override is None:
            return ("p", v.pattern_idx, v.tok_space)
        return ("deriv", id(v))
    if isinstance(v, SNode):
        return ("n", v.prefix)
    if isinstance(v, SKey):
        return ("k", v.pattern_idx)
    if isinstance(v, SList):
        return ("l", tuple(_val_sig(x) for _, x in v.items))
    return ("opaque", id(v))


class _ArrayIndexSentinel:
    """Binding value of an array-iteration index variable."""

    def __repr__(self):
        return "<array-index>"


_ARRAY_INDEX = _ArrayIndexSentinel()


def _hashable(v):
    if isinstance(v, (list, dict, set)):
        return json.dumps(v, sort_keys=True, default=str)
    return v


def _is_scalar_const(v) -> bool:
    return v is None or isinstance(v, (str, int, float, bool))


def _norm_num(v):
    if isinstance(v, float) and not isinstance(v, bool) and v.is_integer():
        return int(v)
    return v


def _to_number_host(v):
    """Rego to_number semantics per vocab entry: strings parse, numbers
    pass, booleans map to 1/0, null to 0."""
    if v is None:
        return 0.0, True
    if isinstance(v, bool):
        return (1.0 if v else 0.0), True
    if isinstance(v, (int, float)):
        return float(v), True
    try:
        return float(v), True
    except (TypeError, ValueError):
        return 0.0, False


def _jsonable(v) -> bool:
    try:
        json.dumps(v, sort_keys=True)
        return True
    except (TypeError, ValueError):
        return False


def _numeric_oracle(oracle, name: str, value, extra=None):
    """Adapter: oracle result must be numeric to live in a float table.
    `extra` = (sym_idx, consts): multi-arg call with the per-vocab value
    substituted at sym_idx."""
    try:
        if extra is not None:
            res, defined = oracle(name, value, extra=extra)
        else:
            res, defined = oracle(name, value)
    except Exception:
        return 0.0, False
    if not defined:
        return 0.0, False
    if isinstance(res, bool):
        return (1.0 if res else 0.0), True
    if isinstance(res, (int, float)):
        return float(res), True
    return 0.0, False
