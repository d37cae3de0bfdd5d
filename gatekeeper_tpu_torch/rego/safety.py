# Copied from gatekeeper_tpu/rego/safety.py; only imports and the edits noted in this header differ.
# Edit: source paths in comments point into the upstream Gatekeeper repo (gatekeeper/...).
"""Body safety analysis: OPA-style expression reordering.

OPA's compiler reorders rule-body literals so that every variable is bound
before it is consumed (the reference relies on this, e.g.
`selectors := [s | s = concat(":", [key, val]); val = obj.spec.selector[key]]`
in gatekeeper/library/general/uniqueserviceselector/template.yaml where
`key`/`val` are textually used before being bound). This module implements
the equivalent greedy topological reorder, shared by the interpreter and the
TPU compiler's lowering pass.
"""

from __future__ import annotations

from typing import List, Set, Tuple

from . import ast as A


def all_vars(node, known: Set[str]) -> Set[str]:
    """Every variable name mentioned in a term/expr, excluding known
    (rule/document/import) names and wildcards."""
    out: Set[str] = set()
    _collect_vars(node, known, out)
    return out


def _collect_vars(node, known: Set[str], out: Set[str]) -> None:
    if isinstance(node, A.Var):
        if node.name not in known:
            out.add(node.name)
    elif isinstance(node, A.Wildcard) or isinstance(node, A.Scalar):
        pass
    elif isinstance(node, A.Ref):
        _collect_vars(node.head, known, out)
        for op in node.ops:
            _collect_vars(op, known, out)
    elif isinstance(node, A.Call):
        for a in node.args:
            _collect_vars(a, known, out)
    elif isinstance(node, A.BinOp):
        _collect_vars(node.lhs, known, out)
        _collect_vars(node.rhs, known, out)
    elif isinstance(node, A.UnaryMinus):
        _collect_vars(node.operand, known, out)
    elif isinstance(node, A.ArrayTerm) or isinstance(node, A.SetTerm):
        for x in node.items:
            _collect_vars(x, known, out)
    elif isinstance(node, A.ObjectTerm):
        for k, v in node.items:
            _collect_vars(k, known, out)
            _collect_vars(v, known, out)
    elif isinstance(node, A.Comprehension):
        # comprehension-local vars stay local; only propagate outward needs
        out |= comprehension_needed(node, known)
    elif isinstance(node, A.TermExpr):
        _collect_vars(node.term, known, out)
    elif isinstance(node, A.Assign):
        _collect_vars(node.target, known, out)
        _collect_vars(node.value, known, out)
    elif isinstance(node, A.Unify):
        _collect_vars(node.lhs, known, out)
        _collect_vars(node.rhs, known, out)
    elif isinstance(node, A.NotExpr):
        _collect_vars(node.expr, known, out)
    elif isinstance(node, A.SomeDecl):
        out |= set(node.names)
    elif isinstance(node, A.WithExpr):
        _collect_vars(node.expr, known, out)
        for m in node.mods:
            _collect_vars(m.value, known, out)
    return


def needed_value(term: A.Term, known: Set[str]) -> Set[str]:
    """Vars that must be bound before `term` is evaluated in value position.

    Bracket operands of refs may be bound by enumeration and object/array
    patterns in ref-operand position may bind by set-membership unification,
    so those contribute nothing.
    """
    if isinstance(term, (A.Scalar, A.Wildcard)):
        return set()
    if isinstance(term, A.Var):
        return {term.name} if term.name not in known else set()
    if isinstance(term, A.Ref):
        out = needed_value(term.head, known)
        for op in term.ops:
            out |= needed_pattern(op, known)
        return out
    if isinstance(term, A.Call):
        out: Set[str] = set()
        for a in term.args:
            out |= needed_value(a, known)
        return out
    if isinstance(term, A.BinOp):
        return needed_value(term.lhs, known) | needed_value(term.rhs, known)
    if isinstance(term, A.UnaryMinus):
        return needed_value(term.operand, known)
    if isinstance(term, (A.ArrayTerm, A.SetTerm)):
        out = set()
        for x in term.items:
            out |= needed_value(x, known)
        return out
    if isinstance(term, A.ObjectTerm):
        out = set()
        for k, v in term.items:
            out |= needed_value(k, known) | needed_value(v, known)
        return out
    if isinstance(term, A.Comprehension):
        return comprehension_needed(term, known)
    return set()


def needed_pattern(term: A.Term, known: Set[str]) -> Set[str]:
    """Vars needed when `term` appears in a bindable (pattern) position."""
    if isinstance(term, (A.Var, A.Wildcard, A.Scalar)):
        return set()
    if isinstance(term, A.ArrayTerm):
        out: Set[str] = set()
        for x in term.items:
            out |= needed_pattern(x, known)
        return out
    if isinstance(term, A.ObjectTerm):
        out = set()
        for k, v in term.items:
            out |= needed_value(k, known)
            out |= needed_pattern(v, known)
        return out
    return needed_value(term, known)


def comprehension_needed(term: A.Comprehension, known: Set[str]) -> Set[str]:
    """Outer vars a comprehension requires: referenced vars that can never be
    bound by its own body (fixpoint over schedulability)."""
    referenced: Set[str] = set()
    for e in term.body:
        _collect_vars(e, known, referenced)
    head_vars: Set[str] = set()
    _collect_vars(term.head, known, head_vars)
    if term.key is not None:
        _collect_vars(term.key, known, head_vars)
    referenced_all = referenced | head_vars

    bound: Set[str] = set()
    changed = True
    while changed:
        changed = False
        for e in term.body:
            if can_schedule(e, bound, known):
                ev = all_vars(e, known)
                if not ev <= bound:
                    bound |= ev
                    changed = True
    return referenced_all - bound


def expr_needed(expr: A.Expr, known: Set[str]) -> Set[str]:
    if isinstance(expr, A.TermExpr):
        return needed_value(expr.term, known)
    if isinstance(expr, A.Assign):
        return needed_value(expr.value, known) | needed_pattern(expr.target, known)
    if isinstance(expr, A.NotExpr):
        # negated expressions must be ground
        return all_vars(expr.expr, known)
    if isinstance(expr, A.SomeDecl):
        return set()
    if isinstance(expr, A.WithExpr):
        out = expr_needed(expr.expr, known)
        for m in expr.mods:
            out |= needed_value(m.value, known)
        return out
    if isinstance(expr, A.Unify):
        # handled specially in can_schedule
        return needed_value(expr.lhs, known) | needed_value(expr.rhs, known)
    return set()


def can_schedule(expr: A.Expr, bound: Set[str], known: Set[str]) -> bool:
    if isinstance(expr, A.Unify):
        nl = needed_value(expr.lhs, known)
        nr = needed_value(expr.rhs, known)
        return nl <= bound or nr <= bound
    if isinstance(expr, A.WithExpr):
        mods_ok = all(needed_value(m.value, known) <= bound for m in expr.mods)
        return mods_ok and can_schedule(expr.expr, bound, known)
    return expr_needed(expr, known) <= bound


def reorder_body(
    body: List[A.Expr], bound0: Set[str], known: Set[str]
) -> List[A.Expr]:
    """Greedy safety reorder; stable for already-safe bodies. If no
    expression is schedulable (genuinely unsafe body), remaining expressions
    are appended in order and the evaluator reports the unsafe var."""
    remaining = list(body)
    ordered: List[A.Expr] = []
    bound = set(bound0)
    while remaining:
        for idx, e in enumerate(remaining):
            if can_schedule(e, bound, known):
                break
        else:
            idx = 0
        e = remaining.pop(idx)
        ordered.append(e)
        bound |= all_vars(e, known)
    return ordered


def module_known(mod: A.Module, rule_names: Set[str]) -> Set[str]:
    known = set(rule_names) | {"input", "data"}
    for imp in mod.imports:
        known.add(imp.alias or imp.path[-1])
    return known
