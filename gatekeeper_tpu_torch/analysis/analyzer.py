# Copied from gatekeeper_tpu/analysis/analyzer.py; no line below differs.
"""Static vectorizability analysis over ConstraintTemplate Rego ASTs.

Runs at template-admission time (and offline via ``python -m
gatekeeper_tpu.analysis``) and predicts how the symbolic compiler
(`engine/symbolic.py`) will route the template, WITHOUT compiling it:

  * a **binding analysis** — the safety reorder (`rego/safety.py`)
    extended into a full bound-before-use checker with rule/line
    provenance (unsafe variables are unevaluable everywhere: INVALID);
  * a **feature audit** — every construct is checked against the
    symbolic compiler's actual capability set (builtin handler table,
    ref-walk shapes, comprehension kinds, iteration fanout) and mapped
    to a stable ``GK-Vxxx`` diagnostic code.

The verdict models `engine.programs.compile_program`'s retry chain
faithfully enough to be consulted *instead of* try/except routing:

  * constructs that abort even the screen-mode retry (with modifiers,
    ``every``, >2 nested array iterations, dynamic ref heads, fixed
    array indexing of review arrays, ...) are **hard** — the template
    is INTERPRETER;
  * constructs the screen retry absorbs (unsupported builtins over
    symbolic values, object comprehensions, inventory joins) are
    **soft** — the template still compiles, as a screen: PARTIAL_ROWS.
    Call and comprehension subtrees are themselves soft contexts (the
    screen-mode compiler catches failures there and degrades to opaque
    values), so hard findings inside them downgrade to PARTIAL_ROWS.

The analyzer is deliberately conservative in one direction only: a
VECTORIZED verdict is a *promise* that ``compile_program`` will not
raise ``CompileUnsupported`` (tests/test_analysis.py sweeps the promise
against the real compiler); PARTIAL_ROWS makes no exactness claim.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from ..rego import ast as A
from ..rego import safety
from ..rego.builtins import BUILTINS
from .report import (
    INTERPRETER,
    INVALID,
    PARTIAL_ROWS,
    VectorizabilityReport,
)

# builtins with symbolic handlers in engine/symbolic.py (Compiler
# ``_builtin_*`` methods plus the destructuring `split` special case):
# these accept review-derived arguments and stay on-device
SYMBOLIC_BUILTINS: Set[str] = {
    "count",
    "any",
    "all",
    "re_match",
    "regex.match",
    "startswith",
    "endswith",
    "contains",
    "lower",
    "upper",
    "trim",
    "trim_prefix",
    "sprintf",
    "concat",
    "is_number",
    "is_string",
    "is_array",
    "to_number",
    "split",
}


# -- abstract values --------------------------------------------------------


@dataclass(frozen=True)
class AVal:
    """Abstract value domain for the dataflow walk.

    domain:
      "const"   — literals / input.parameters / folded results
      "review"  — the review document or a sub-document/leaf of it
      "inv"     — data.inventory-derived (opaque to the compiler)
      "opaque"  — derived symbolic value (call results, set elements)
    depth: array-iteration levels opened along a review walk (the
      compiler's "#" levels; 3+ aborts compilation).
    key: value is a symbolic string usable as an object-join key
      (captured iteration keys, leaf scalars).
    """

    domain: str = "opaque"
    depth: int = 0
    key: bool = False


CONST = AVal("const")
OPAQUE = AVal("opaque")
INV = AVal("inv")


def _join(a: AVal, b: AVal) -> AVal:
    if "inv" in (a.domain, b.domain):
        return INV
    if a.domain == b.domain == "const":
        return CONST
    if "review" in (a.domain, b.domain):
        d = a if a.domain == "review" else b
        return AVal("review", depth=max(a.depth, b.depth), key=d.key)
    return AVal("opaque", depth=max(a.depth, b.depth))


# -- analyzer ---------------------------------------------------------------


@dataclass
class _Ctx:
    """Per-rule walk context."""

    env: Dict[str, AVal] = field(default_factory=dict)
    rule: str = ""
    # `:=`-assigned value terms by var name: lets the external_data
    # audit resolve `keys: images` back to the comprehension that
    # built `images` (extraction needs the defining expression)
    defs: Dict[str, Any] = field(default_factory=dict)
    rule_ast: Optional[A.Rule] = None


class Analyzer:
    def __init__(self, kind: str, modules: Sequence[A.Module]):
        self.kind = kind
        self.modules = list(modules)
        self.report = VectorizabilityReport(kind=kind)
        self.rules: Dict[str, List[A.Rule]] = {}
        for mod in self.modules:
            for rule in mod.rules:
                self.rules.setdefault(rule.head.name, []).append(rule)
        self._known = safety.module_known(
            self.modules[0] if self.modules else A.Module(),
            set(self.rules),
        )
        for mod in self.modules[1:]:
            self._known |= safety.module_known(mod, set(self.rules))
        # soft-context depth: >0 inside call/comprehension subtrees,
        # where screen-mode compilation absorbs failures
        self._soft = 0
        self._analyzed_rules: Set[int] = set()
        self._seen_diags: Set[Tuple] = set()
        # rule identity -> owning module: external_data call records
        # carry the module so key extraction can evaluate their keys
        # expression later (externaldata/extract.py)
        self._rule_module: Dict[int, A.Module] = {}
        for mod in self.modules:
            for rule in mod.rules:
                self._rule_module[id(rule)] = mod
        # the := target whose value term is currently being evaluated
        # (identity-matched): lets _eval_call know which var binds an
        # external_data response
        self._assign_target: Optional[str] = None
        self._assign_value: Any = None

    # -- diagnostics --------------------------------------------------------

    def _diag(
        self, code: str, message: str, rule: str, line: int,
        severity: str = "",
    ) -> None:
        if not severity and self._soft:
            # inside a call/comprehension the screen retry absorbs hard
            # failures: cap at PARTIAL_ROWS instead of the code default
            from .report import CODES, VERDICT_ORDER

            default_cap = CODES.get(code, ("", PARTIAL_ROWS))[1]
            if VERDICT_ORDER.index(default_cap) > VERDICT_ORDER.index(
                PARTIAL_ROWS
            ) and default_cap != INVALID:
                severity = PARTIAL_ROWS
        key = (code, message, rule, line, severity)
        if key in self._seen_diags:
            return
        self._seen_diags.add(key)
        self.report.add(
            code, message, rule=rule, line=line, severity=severity
        )

    # -- entry --------------------------------------------------------------

    def run(self) -> VectorizabilityReport:
        violations = self.rules.get("violation")
        if not violations:
            self._diag(
                "GK-V008", "no `violation` rule defined", "", 0,
                severity=INVALID,
            )
            return self.report
        for rule in violations:
            if rule.head.key is None:
                self._diag(
                    "GK-V008",
                    "`violation` must be a partial set rule "
                    "(violation[{...}])",
                    "violation",
                    rule.line,
                    severity=INVALID,
                )
            if rule.is_default or rule.else_rule is not None:
                self._diag(
                    "GK-V007",
                    "default/else `violation` rule is outside the "
                    "compilable subset",
                    "violation",
                    rule.line,
                )
        # binding analysis over every rule (helpers included: they are
        # all reachable from violation bodies in library templates, and
        # an unsafe helper is unevaluable on any engine)
        for mod in self.modules:
            for rule in mod.rules:
                self._check_bindings(rule)
        # feature audit from the entrypoint
        for rule in violations:
            self._audit_rule(rule)
        return self.report

    # -- binding analysis (GK-V005) -----------------------------------------

    def _check_bindings(self, rule: A.Rule) -> None:
        bound0: Set[str] = set()
        for formal in rule.head.args or []:
            if isinstance(formal, A.Var):
                bound0.add(formal.name)
        self._check_body_bindings(rule.body, bound0, rule)
        # rule head terms must be fully bound by the body
        bound = set(bound0)
        for e in rule.body:
            bound |= safety.all_vars(e, self._known)
        for part in (rule.head.key, rule.head.value):
            if part is None:
                continue
            missing = sorted(
                safety.needed_value(part, self._known) - bound
            )
            if missing:
                self._diag(
                    "GK-V005",
                    f"var(s) {', '.join(missing)} in rule head are "
                    "never bound in the body",
                    rule.head.name,
                    rule.line,
                    severity=INVALID,
                )
        if rule.else_rule is not None:
            self._check_bindings(rule.else_rule)

    def _check_body_bindings(
        self, body: List[A.Expr], bound0: Set[str], rule: A.Rule
    ) -> None:
        """Greedy schedulability fixpoint: any expression that can never
        be scheduled — no order of the body binds the vars it consumes —
        is a bound-before-use violation (OPA: 'var x is unsafe').

        Unlike `safety.reorder_body` (which must preserve evaluation
        order and so consults comprehension needs against a FIXED known
        set), outer-bound vars here fold into `known` between rounds:
        `comprehension_needed` over-approximates by counting locals
        blocked on outer vars, and treating bound vars as known is what
        discharges those."""
        remaining = list(body)
        bound = set(bound0)
        progress = True
        while remaining and progress:
            progress = False
            for i, e in enumerate(remaining):
                if safety.can_schedule(e, bound, self._known | bound):
                    bound |= safety.all_vars(e, self._known)
                    remaining.pop(i)
                    progress = True
                    break
        for e in remaining:  # permanently unschedulable
            missing = sorted(
                safety.expr_needed(e, self._known | bound) - bound
            )
            if missing:
                self._diag(
                    "GK-V005",
                    f"var(s) {', '.join(missing)} used before any "
                    "expression can bind them",
                    rule.head.name,
                    getattr(e, "line", 0) or rule.line,
                    severity=INVALID,
                )
            bound |= safety.all_vars(e, self._known)
        # recurse into comprehension bodies with the outer bound set so
        # internally-unsafe comprehensions get their own provenance
        for e in body:
            for comp in _comprehensions_in(e):
                self._check_body_bindings(comp.body, set(bound), rule)

    # -- feature audit ------------------------------------------------------

    def _audit_rule(self, rule: A.Rule, formals_from: str = "") -> None:
        """Audit one rule body (memoized by identity)."""
        if id(rule) in self._analyzed_rules:
            return
        self._analyzed_rules.add(id(rule))
        ctx = _Ctx(rule=rule.head.name, rule_ast=rule)
        for formal in rule.head.args or []:
            if isinstance(formal, A.Var):
                ctx.env[formal.name] = OPAQUE
        for expr in rule.body:
            self._audit_expr(expr, ctx)
        if rule.head.key is not None:
            self._eval_term(rule.head.key, ctx)
        if rule.head.value is not None:
            self._eval_term(rule.head.value, ctx)
        if rule.else_rule is not None:
            self._audit_rule(rule.else_rule)

    def _audit_expr(self, expr: A.Expr, ctx: _Ctx) -> None:
        if isinstance(expr, A.SomeDecl):
            return
        if isinstance(expr, A.WithExpr):
            self._diag(
                "GK-V007",
                "`with` modifier is outside the compilable subset",
                ctx.rule,
                expr.line,
            )
            self._audit_expr(expr.expr, ctx)
            return
        if isinstance(expr, A.Every):
            self._diag(
                "GK-V007",
                "`every` is outside the compilable subset",
                ctx.rule,
                expr.line,
            )
            return
        if isinstance(expr, A.NotExpr):
            self._audit_expr(expr.expr, ctx)
            return
        if isinstance(expr, A.Assign):
            self._audit_assign(expr.target, expr.value, ctx)
            return
        if isinstance(expr, A.Unify):
            lhs, rhs = expr.lhs, expr.rhs
            lv = isinstance(lhs, A.Var) and lhs.name not in ctx.env
            rv = isinstance(rhs, A.Var) and rhs.name not in ctx.env
            if lv and not rv:
                self._audit_assign(lhs, rhs, ctx)
            elif rv and not lv:
                self._audit_assign(rhs, lhs, ctx)
            else:
                self._eval_term(lhs, ctx)
                self._eval_term(rhs, ctx)
            return
        if isinstance(expr, A.TermExpr):
            self._eval_term(expr.term, ctx)
            return

    def _audit_assign(self, target: A.Term, value: A.Term, ctx: _Ctx):
        prev_t, prev_v = self._assign_target, self._assign_value
        if isinstance(target, A.Var):
            self._assign_target, self._assign_value = target.name, value
        try:
            val = self._eval_term(value, ctx)
        finally:
            self._assign_target, self._assign_value = prev_t, prev_v
        if isinstance(target, A.Var):
            ctx.env[target.name] = val
            ctx.defs[target.name] = value
            return
        if isinstance(target, A.Wildcard):
            return
        if isinstance(target, A.ArrayTerm):
            ok_split = (
                isinstance(value, A.Call)
                and value.name == "split"
                and len(value.args) == 2
            )
            for t in target.items:
                if not isinstance(t, (A.Var, A.Wildcard)):
                    self._diag(
                        "GK-V007",
                        "array destructuring target must be all "
                        "variables",
                        ctx.rule,
                        target.line,
                    )
                    return
            if not ok_split and val.domain == "review":
                self._diag(
                    "GK-V007",
                    "array destructuring of a review document is "
                    "outside the compilable subset (only `split` and "
                    "fixed lists destructure)",
                    ctx.rule,
                    target.line,
                )
            part = AVal("opaque", key=True)
            for t in target.items:
                if isinstance(t, A.Var):
                    ctx.env[t.name] = part
            return
        # object-pattern / nested destructuring
        self._diag(
            "GK-V007",
            "destructuring assignment target shape is outside the "
            "compilable subset",
            ctx.rule,
            getattr(target, "line", 0),
        )

    # -- terms --------------------------------------------------------------

    def _eval_term(self, term: A.Term, ctx: _Ctx) -> AVal:
        if isinstance(term, A.Scalar):
            return CONST
        if isinstance(term, A.Wildcard):
            return OPAQUE
        if isinstance(term, A.Var):
            if term.name in ctx.env:
                return ctx.env[term.name]
            if term.name in self.rules:
                return self._rule_value(term.name, ctx, term.line)
            return OPAQUE  # unbound: the binding analysis owns this
        if isinstance(term, A.Ref):
            return self._eval_ref(term, ctx)
        if isinstance(term, A.Call):
            return self._eval_call(term, ctx)
        if isinstance(term, A.BinOp):
            lv = self._eval_term(term.lhs, ctx)
            rv = self._eval_term(term.rhs, ctx)
            return _join(lv, rv)
        if isinstance(term, A.UnaryMinus):
            v = self._eval_term(term.operand, ctx)
            if v.domain != "const":
                self._diag(
                    "GK-V007",
                    "unary minus of a symbolic value is outside the "
                    "compilable subset",
                    ctx.rule,
                    term.line,
                )
            return CONST
        if isinstance(term, (A.ArrayTerm, A.SetTerm)):
            out = CONST
            for item in term.items:
                out = _join(out, self._eval_term(item, ctx))
            return replace(out, key=False)
        if isinstance(term, A.ObjectTerm):
            out = CONST
            for k, v in term.items:
                out = _join(out, self._eval_term(k, ctx))
                out = _join(out, self._eval_term(v, ctx))
            return replace(out, key=False)
        if isinstance(term, A.Comprehension):
            return self._eval_comprehension(term, ctx)
        return OPAQUE

    def _eval_comprehension(self, term: A.Comprehension, ctx: _Ctx) -> AVal:
        if term.kind == "object":
            self._diag(
                "GK-V002",
                "object comprehensions compile only as a screen "
                "(opaque value; conditions on it re-check on the "
                "interpreter)",
                ctx.rule,
                term.line,
            )
        # comprehension bodies are a soft context: the screen-mode
        # compiler catches failures here and degrades to opaque
        self._soft += 1
        try:
            sub = _Ctx(
                env=dict(ctx.env), rule=ctx.rule,
                defs=dict(ctx.defs), rule_ast=ctx.rule_ast,
            )
            for e in term.body:
                self._audit_expr(e, sub)
            head = self._eval_term(term.head, sub)
            if term.key is not None:
                head = _join(head, self._eval_term(term.key, sub))
        finally:
            self._soft -= 1
        return replace(head, key=False)

    # -- refs ---------------------------------------------------------------

    def _eval_ref(self, ref: A.Ref, ctx: _Ctx) -> AVal:
        if not isinstance(ref.head, A.Var):
            self._diag(
                "GK-V004",
                "computed ref head (expression indexed directly) is "
                "outside the compilable subset",
                ctx.rule,
                ref.line,
            )
            return OPAQUE
        name = ref.head.name
        if name == "input":
            if not ref.ops or not isinstance(ref.ops[0], A.Scalar):
                self._diag(
                    "GK-V004",
                    "dynamic access into `input` is outside the "
                    "compilable subset",
                    ctx.rule,
                    ref.line,
                )
                return OPAQUE
            first = ref.ops[0].value
            if first == "review":
                return self._walk(AVal("review"), ref.ops[1:], ctx, ref)
            if first == "parameters":
                return self._walk(CONST, ref.ops[1:], ctx, ref)
            self._diag(
                "GK-V004",
                f"`input.{first}` is not a compilable document root "
                "(only input.review / input.parameters)",
                ctx.rule,
                ref.line,
            )
            return OPAQUE
        if name == "data":
            if (
                ref.ops
                and isinstance(ref.ops[0], A.Scalar)
                and ref.ops[0].value == "inventory"
            ):
                self._diag(
                    "GK-V006",
                    "data.inventory join: compiles as a screen "
                    "(device pre-filter + interpreter re-check of "
                    "flagged rows)",
                    ctx.rule,
                    ref.line,
                )
                return self._walk(INV, ref.ops[1:], ctx, ref)
            # rewritten lib refs (data.libs.<Kind>.lib...) resolve to
            # mounted rules; anything else was allowlist-rejected
            tail = _ref_tail_rule(ref)
            if tail is not None and tail in self.rules:
                base = self._rule_value(tail, ctx, ref.line)
                return self._walk(base, [], ctx, ref)
            return OPAQUE
        if name in ctx.env:
            return self._walk(ctx.env[name], ref.ops, ctx, ref)
        if name in self.rules:
            base = self._rule_value(name, ctx, ref.line)
            return self._walk(base, ref.ops, ctx, ref, rule_ref=name)
        return OPAQUE  # unbound head: binding analysis owns it

    def _rule_value(self, name: str, ctx: _Ctx, line: int) -> AVal:
        """Referencing a rule as a value (complete rule / partial set)."""
        rules = self.rules[name]
        kind = rules[0].head.kind
        for rule in rules:
            # rule bodies referenced by ref are a HARD context (the
            # compiler evaluates them inline, uncaught)
            self._audit_rule(rule)
        if kind == "complete":
            if len(rules) > 1:
                self._diag(
                    "GK-V007",
                    f"rule `{name}` has multiple/default definitions; "
                    "computed complete-rule refs are outside the "
                    "compilable subset",
                    ctx.rule,
                    line,
                )
                return OPAQUE
            rule = rules[0]
            if rule.body and _touches_review(rule.body):
                self._diag(
                    "GK-V007",
                    f"complete rule `{name}` computes over the review "
                    "document; only concretely-resolvable rule bodies "
                    "compile",
                    ctx.rule,
                    line,
                )
            return OPAQUE if rule.body else CONST
        if kind == "func":
            self._diag(
                "GK-V007",
                f"function `{name}` referenced as a value",
                ctx.rule,
                line,
            )
        return OPAQUE

    def _walk(
        self,
        base: AVal,
        ops: Sequence[A.Term],
        ctx: _Ctx,
        ref: A.Ref,
        rule_ref: Optional[str] = None,
    ) -> AVal:
        cur = base
        for i, op in enumerate(ops):
            if cur.domain == "inv":
                # inventory walks stay opaque; unbound var segments
                # bind opaquely (mirrors SInventory._walk_one)
                if isinstance(op, A.Var) and op.name not in ctx.env:
                    ctx.env[op.name] = AVal("inv")
                continue
            if cur.domain == "const":
                if isinstance(op, (A.Scalar, A.Wildcard)):
                    continue
                if isinstance(op, A.Var):
                    if op.name not in ctx.env:
                        ctx.env[op.name] = AVal("const", key=True)
                    continue
                self._diag(
                    "GK-V004",
                    "computed key into a parameters/constant document",
                    ctx.rule,
                    ref.line,
                )
                return OPAQUE
            if cur.domain == "review":
                cur = self._walk_review(cur, op, ctx, ref, rule_ref, i)
                if cur is None:
                    return OPAQUE
                continue
            # opaque base: iterating/indexing an opaque value — the
            # compiler raises on SMsg/SDerived walks but returns [] for
            # most leaf walks; partial-set rule refs iterate fine.
            if isinstance(op, A.Var) and op.name not in ctx.env:
                ctx.env[op.name] = AVal("opaque", key=True)
            cur = OPAQUE
        return cur

    def _walk_review(
        self,
        cur: AVal,
        op: A.Term,
        ctx: _Ctx,
        ref: A.Ref,
        rule_ref: Optional[str],
        op_idx: int,
    ) -> Optional[AVal]:
        if isinstance(op, A.Scalar):
            if isinstance(op.value, str):
                return cur
            self._diag(
                "GK-V007",
                "fixed array index into the review document is "
                "outside the compilable subset (iterate with `[_]`)",
                ctx.rule,
                ref.line,
            )
            return None
        if isinstance(op, A.Wildcard) or (
            isinstance(op, A.Var) and op.name not in ctx.env
        ):
            depth = cur.depth + 1
            if depth >= 3:
                self._diag(
                    "GK-V003",
                    "3+ nested array iterations over the review "
                    "document exceed the device fanout axes "
                    "(g0 x g1 cross-join cap)",
                    ctx.rule,
                    ref.line,
                )
                return None
            if isinstance(op, A.Var):
                ctx.env[op.name] = AVal("review", depth=depth, key=True)
            return AVal("review", depth=depth, key=True)
        if isinstance(op, A.Var):  # bound key var
            kv = ctx.env[op.name]
            if kv.domain == "const":
                return cur
            if cur.depth > 0:
                self._diag(
                    "GK-V007",
                    "symbolic-key join under an open array iteration "
                    "is outside the compilable subset",
                    ctx.rule,
                    ref.line,
                )
                return None
            return AVal("review", depth=cur.depth, key=True)
        # computed key (call/binop/...): the ref-walk raises
        self._diag(
            "GK-V004",
            "computed key segment in a review document walk",
            ctx.rule,
            ref.line,
        )
        return None

    # -- calls --------------------------------------------------------------

    def _eval_call(self, call: A.Call, ctx: _Ctx) -> AVal:
        if call.name == "external_data":
            return self._eval_external_data(call, ctx)
        args = [self._eval_term(a, ctx) for a in call.args]
        name = call.name
        base = name.split(".")[-1] if "." in name else name
        if any(a.domain == "inv" for a in args):
            # calls over inventory values go opaque (screen); already
            # diagnosed at the data.inventory ref site
            return INV
        if base in self.rules and self.rules[base][0].head.kind == "func":
            sym = [a for a in args if a.domain != "const"]
            if len(sym) <= 1 and self._fn_tableizable(base):
                # pure scalar helper with at most one symbolic slot:
                # the compiler tableizes it per vocab entry via the
                # interpreter oracle (engine/symbolic._tableize_function)
                # — any builtin is allowed inside, it runs host-side
                out = AVal("opaque", key=True)
                for a in args:
                    out = _join(out, a)
                return replace(out, key=True)
            # general user function: body failures fall back to
            # tableization and then the screen retry — a soft context
            self._soft += 1
            try:
                for rule in self.rules[base]:
                    self._audit_rule(rule)
            finally:
                self._soft -= 1
            out = OPAQUE
            for a in args:
                out = _join(out, a)
            return replace(out, key=False)
        if name in SYMBOLIC_BUILTINS:
            sym = [a for a in args if a.domain != "const"]
            if name in ("re_match", "regex.match") and args and (
                args[0].domain != "const"
            ):
                self._diag(
                    "GK-V001",
                    "re_match with a non-constant pattern compiles "
                    "only as a screen",
                    ctx.rule,
                    call.line,
                )
            out = CONST if not sym else AVal("opaque", key=True)
            return out
        if name in BUILTINS:
            if any(a.domain != "const" for a in args):
                self._diag(
                    "GK-V001",
                    f"builtin `{name}` has no symbolic (vectorized) "
                    "lowering; applied to review-derived values it "
                    "compiles only as a screen",
                    ctx.rule,
                    call.line,
                )
            return CONST if all(
                a.domain == "const" for a in args
            ) else OPAQUE
        # unknown builtin: the interpreter will reject it too
        self._diag(
            "GK-V001",
            f"unknown builtin `{name}`",
            ctx.rule,
            call.line,
            severity=INTERPRETER,
        )
        return OPAQUE


    # -- external_data (GK-V009) --------------------------------------------

    def _eval_external_data(self, call: A.Call, ctx: _Ctx) -> AVal:
        """Record the call site and classify its batchability. The
        template compiles as a screen either way (the compiler treats
        the response as opaque); the classification decides how sharp
        the batch plane can be: extractable keys prefetch in one fetch
        per (provider, micro-batch), and an error-gated rule body lets
        clean-cache-hit rows skip the interpreter entirely."""
        from .report import ExternalDataCall

        for a in call.args:  # arg values still walk (diagnose refs)
            self._eval_term(a, ctx)
        spec = ExternalDataCall(rule=ctx.rule, line=call.line)
        detail = ""
        arg = call.args[0] if len(call.args) == 1 else None
        if not isinstance(arg, A.ObjectTerm):
            detail = "argument must be a literal object"
        else:
            fields: Dict[str, A.Term] = {}
            for k, v in arg.items:
                if isinstance(k, A.Scalar) and isinstance(k.value, str):
                    fields[k.value] = v
            prov = fields.get("provider")
            if isinstance(prov, A.Scalar) and isinstance(prov.value, str):
                spec.provider = prov.value
            else:
                detail = (
                    "provider must be a literal string (non-literal "
                    "providers cannot batch-prefetch)"
                )
            keys = fields.get("keys")
            resolved = self._resolve_keys_term(keys, ctx)
            if resolved is not None and self._keys_input_only(
                resolved, ctx, set()
            ):
                spec.keys_term = resolved
                rule_ast = ctx.rule_ast
                spec.module = (
                    self._rule_module.get(id(rule_ast))
                    if rule_ast is not None
                    else None
                )
                spec.extractable = spec.provider is not None
            elif not detail:
                detail = (
                    "keys expression is not input-derived; lookups "
                    "cannot batch-prefetch (per-call fetch at resolve "
                    "time)"
                )
        if (
            call is self._assign_value
            and self._assign_target is not None
            and ctx.rule_ast is not None
        ):
            spec.respvar = self._assign_target
            spec.error_gated = self._requires_errors(
                ctx.rule_ast.body, self._assign_target
            )
        self.report.external_calls.append(spec)
        msg = (
            "external_data: lookups ride the micro-batch (one fetch "
            "per provider per batch); compiles as a screen — "
            + (
                "clean cache-hit rows stay fused, cold-miss rows "
                "re-check on the interpreter"
                if spec.error_gated and spec.extractable
                else "matching rows re-check on the interpreter"
            )
        )
        if detail:
            msg += f" ({detail})"
        self._diag("GK-V009", msg, ctx.rule, call.line)
        return INV

    def _resolve_keys_term(
        self, term: Optional[A.Term], ctx: _Ctx, depth: int = 0
    ) -> Optional[A.Term]:
        """Follow `keys: somevar` through := definitions (bounded)."""
        if term is None or depth > 4:
            return None if term is None else term
        if isinstance(term, A.Var) and term.name in ctx.defs:
            return self._resolve_keys_term(
                ctx.defs[term.name], ctx, depth + 1
            )
        return term

    def _keys_input_only(
        self, term: A.Term, ctx: _Ctx, locals_: Set[str], depth: int = 0
    ) -> bool:
        """True when the keys expression depends only on input.review
        (plus literals and its own local bindings) — the condition for
        evaluating it standalone per review at prefetch time."""
        if depth > 8:
            return False
        if isinstance(term, (A.Scalar, A.Wildcard)):
            return True
        if isinstance(term, A.Var):
            if term.name in locals_:
                return True
            d = ctx.defs.get(term.name)
            if d is not None:
                return self._keys_input_only(d, ctx, locals_, depth + 1)
            return False
        if isinstance(term, (A.ArrayTerm, A.SetTerm)):
            return all(
                self._keys_input_only(t, ctx, locals_, depth + 1)
                for t in term.items
            )
        if isinstance(term, A.BinOp):
            return self._keys_input_only(
                term.lhs, ctx, locals_, depth + 1
            ) and self._keys_input_only(term.rhs, ctx, locals_, depth + 1)
        if isinstance(term, A.Call):
            # pure builtins over input-only args are fine (the
            # extraction evaluates them); helper functions may read
            # data/parameters, so they stay conservative
            if term.name == "external_data" or term.name not in BUILTINS:
                return False
            return all(
                self._keys_input_only(a, ctx, locals_, depth + 1)
                for a in term.args
            )
        if isinstance(term, A.Ref):
            if not isinstance(term.head, A.Var):
                return False
            h = term.head.name
            if h == "input":
                if not (
                    term.ops
                    and isinstance(term.ops[0], A.Scalar)
                    and term.ops[0].value == "review"
                ):
                    return False
            elif h not in locals_:
                d = ctx.defs.get(h)
                if d is None or not self._keys_input_only(
                    d, ctx, locals_, depth + 1
                ):
                    return False
            for op in term.ops:
                if isinstance(op, (A.Scalar, A.Wildcard)):
                    continue
                if isinstance(op, A.Var):
                    # an unbound var segment binds by iteration here
                    locals_.add(op.name)
                    continue
                return False
            return True
        if isinstance(term, A.Comprehension):
            sub = set(locals_)
            for e in term.body:
                if not self._comp_expr_input_only(e, ctx, sub, depth + 1):
                    return False
            if not self._keys_input_only(term.head, ctx, sub, depth + 1):
                return False
            return term.key is None or self._keys_input_only(
                term.key, ctx, sub, depth + 1
            )
        return False

    def _comp_expr_input_only(
        self, e: A.Expr, ctx: _Ctx, locals_: Set[str], depth: int
    ) -> bool:
        if isinstance(e, A.SomeDecl):
            locals_.update(e.names)
            return True
        if isinstance(e, A.Assign):
            ok = self._keys_input_only(e.value, ctx, locals_, depth)
            if isinstance(e.target, A.Var):
                locals_.add(e.target.name)
            elif isinstance(e.target, A.ArrayTerm):
                for t in e.target.items:
                    if isinstance(t, A.Var):
                        locals_.add(t.name)
            return ok
        if isinstance(e, A.Unify):
            for a, b in ((e.lhs, e.rhs), (e.rhs, e.lhs)):
                if isinstance(a, A.Var) and self._keys_input_only(
                    b, ctx, set(locals_), depth
                ):
                    self._keys_input_only(b, ctx, locals_, depth)
                    locals_.add(a.name)
                    return True
            return self._keys_input_only(
                e.lhs, ctx, locals_, depth
            ) and self._keys_input_only(e.rhs, ctx, locals_, depth)
        if isinstance(e, A.NotExpr):
            return self._comp_expr_input_only(e.expr, ctx, locals_, depth)
        if isinstance(e, A.TermExpr):
            return self._keys_input_only(e.term, ctx, locals_, depth)
        return False

    # -- error-gated proof ---------------------------------------------------

    def _requires_errors(self, body: List[A.Expr], respvar: str) -> bool:
        """True when some positive top-level body expression requires
        `respvar.errors` to be non-empty — then the rule can only fire
        when the provider returned an error entry, so the fused screen
        may soundly skip rows whose keys are all clean cache hits."""
        for e in body:
            terms: List[A.Term] = []
            if isinstance(e, A.TermExpr):
                terms = [e.term]
            elif isinstance(e, A.Assign):
                terms = [e.value]
            elif isinstance(e, A.Unify):
                terms = [e.lhs, e.rhs]
            for t in terms:
                if self._errors_requirement(t, respvar):
                    return True
        return False

    def _is_errors_ref(self, t: A.Term, respvar: str) -> bool:
        return (
            isinstance(t, A.Ref)
            and isinstance(t.head, A.Var)
            and t.head.name == respvar
            and bool(t.ops)
            and isinstance(t.ops[0], A.Scalar)
            and t.ops[0].value == "errors"
        )

    def _errors_requirement(self, t: A.Term, respvar: str) -> bool:
        # `resp.errors[_]` / `resp.errors[i][...]`: each body solution
        # demands an element, so firing implies errors is non-empty
        if self._is_errors_ref(t, respvar) and len(t.ops) >= 2:
            return True
        if not isinstance(t, A.BinOp):
            return False
        flip = {
            ">": "<", "<": ">", ">=": "<=", "<=": ">=",
            "!=": "!=", "==": "==",
        }
        for a, b, op in (
            (t.lhs, t.rhs, t.op),
            (t.rhs, t.lhs, flip.get(t.op, t.op)),
        ):
            num = b.value if isinstance(b, A.Scalar) else None
            if (
                isinstance(a, A.Call)
                and a.name == "count"
                and len(a.args) == 1
                and self._is_errors_ref(a.args[0], respvar)
                and isinstance(num, (int, float))
                and not isinstance(num, bool)
            ):
                if op == ">" and num >= 0:
                    return True
                if op in (">=", "==") and num >= 1:
                    return True
                if op == "!=" and num == 0:
                    return True
            if (
                self._is_errors_ref(a, respvar)
                and len(a.ops) == 1
                and op == "!="
                and isinstance(b, A.ArrayTerm)
                and not b.items
            ):
                return True
        return False

    # -- tableizability (mirrors symbolic._tableize_function's gates) -------

    def _fn_tableizable(self, name: str) -> bool:
        cached = getattr(self, "_tableizable_cache", None)
        if cached is None:
            cached = self._tableizable_cache = {}
        if name not in cached:
            cached[name] = self._fn_pure(name, set()) and (
                self._fn_args_unwalked(name)
            )
        return cached[name]

    def _fn_pure(self, name: str, seen: Set[str]) -> bool:
        """No input.review / data refs in the call graph (mirrors
        symbolic.Compiler._fn_is_pure; input.parameters is allowed)."""
        if name in seen:
            return True
        seen.add(name)
        impure: List[str] = []

        def visit(n: Any) -> None:
            import dataclasses as _dc

            if isinstance(n, A.Ref) and isinstance(n.head, A.Var):
                if n.head.name == "data":
                    impure.append("data")
                elif n.head.name == "input":
                    if not (
                        n.ops
                        and isinstance(n.ops[0], A.Scalar)
                        and n.ops[0].value == "parameters"
                    ):
                        impure.append("input")
                elif n.head.name in self.rules and not self._fn_pure(
                    n.head.name, seen
                ):
                    impure.append(n.head.name)
            if isinstance(n, A.Call):
                b = n.name.split(".")[-1] if "." in n.name else n.name
                if b in self.rules and not self._fn_pure(b, seen):
                    impure.append(b)
            if isinstance(n, A.Node):
                for f in _dc.fields(n):
                    visit(getattr(n, f.name))
            elif isinstance(n, (list, tuple)):
                for x in n:
                    visit(x)

        for rule in self.rules.get(name, []):
            visit(rule)
        return not impure

    def _fn_args_unwalked(self, name: str) -> bool:
        """The function never dereferences its formals (required for
        vid-keyed tableization: the oracle keys on the scalar value)."""
        for rule in self.rules.get(name, []):
            formals = {
                f.name
                for f in (rule.head.args or [])
                if isinstance(f, A.Var)
            }
            bad: List[str] = []

            def visit(n: Any) -> None:
                import dataclasses as _dc

                if (
                    isinstance(n, A.Ref)
                    and isinstance(n.head, A.Var)
                    and n.head.name in formals
                    and n.ops
                ):
                    bad.append(n.head.name)
                if isinstance(n, A.Node):
                    for f in _dc.fields(n):
                        visit(getattr(n, f.name))
                elif isinstance(n, (list, tuple)):
                    for x in n:
                        visit(x)

            visit(rule)
            if bad:
                return False
        return True


# -- helpers ----------------------------------------------------------------


def _comprehensions_in(node: Any) -> List[A.Comprehension]:
    out: List[A.Comprehension] = []

    def visit(n: Any) -> None:
        import dataclasses as _dc

        if isinstance(n, A.Comprehension):
            out.append(n)
            return  # nested comprehensions handled by recursion
        if isinstance(n, A.Node):
            for f in _dc.fields(n):
                visit(getattr(n, f.name))
        elif isinstance(n, (list, tuple)):
            for x in n:
                visit(x)

    visit(node)
    return out


def _touches_review(body: List[A.Expr]) -> bool:
    hits: List[str] = []

    def visit(n: Any) -> None:
        import dataclasses as _dc

        if isinstance(n, A.Ref) and isinstance(n.head, A.Var):
            if n.head.name in ("input", "data"):
                hits.append(n.head.name)
        if isinstance(n, A.Node):
            for f in _dc.fields(n):
                visit(getattr(n, f.name))
        elif isinstance(n, (list, tuple)):
            for x in n:
                visit(x)

    visit(body)
    return bool(hits)


def _ref_tail_rule(ref: A.Ref) -> Optional[str]:
    """Last scalar-string segment of a data.* ref (rewritten lib path)."""
    tail = None
    for op in ref.ops:
        if isinstance(op, A.Scalar) and isinstance(op.value, str):
            tail = op.value
        else:
            break
    return tail


# -- public API -------------------------------------------------------------


def analyze_modules(
    kind: str, modules: Sequence[A.Module]
) -> VectorizabilityReport:
    """Analyze a template's parsed+rewritten modules (what the Client
    mounts into the driver)."""
    return Analyzer(kind, modules).run()


def analyze_template(obj: Dict[str, Any]) -> VectorizabilityReport:
    """Analyze a raw ConstraintTemplate dict (YAML document): runs the
    same parse/validate/rewrite pipeline as Client.add_template, then
    the analyzer. Pipeline errors surface as INVALID diagnostics
    instead of exceptions, so offline lint runs never crash on one bad
    template."""
    from ..constraint.errors import InvalidTemplateError
    from ..constraint.templates import ConstraintTemplate
    from ..constraint import regocompile

    try:
        ct = ConstraintTemplate.from_dict(obj)
        ct.validate_names()
        spec = ct.targets[0]
        modules = regocompile.compile_template_modules(
            ct.kind, spec.target, spec.rego, spec.libs
        )
    except InvalidTemplateError as e:
        kind = ""
        try:
            kind = (
                ((obj.get("spec") or {}).get("crd") or {})
                .get("spec", {})
                .get("names", {})
                .get("kind", "")
            )
        except AttributeError:
            pass
        rep = VectorizabilityReport(kind=kind or "<invalid>")
        rep.add("GK-V008", str(e), severity=INVALID)
        return rep
    return analyze_modules(ct.kind, modules)
