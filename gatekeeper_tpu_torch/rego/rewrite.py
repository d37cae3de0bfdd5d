# Copied from gatekeeper_tpu/rego/rewrite.py; only imports and the edits noted in this header differ.
# Edit: source paths in comments point into the upstream Gatekeeper repo (gatekeeper/...).
"""Compile-time AST rewriting: dynamic-operand hoisting for negation.

OPA's compiler (rewriteDynamics + RewriteExprTerms stages, see
gatekeeper/vendor/github.com/open-policy-agent/opa/ast/compile.go:2817)
binds refs/calls/comprehensions appearing as call operands to fresh local
variables *before* the calling expression. This is semantically observable
under negation: in

    not accept_value(rule, provided_value, params.ranges)

the operand `params.ranges` is hoisted to `__l = params.ranges` outside the
`not`, so if it is undefined the whole rule body fails instead of the `not`
succeeding. Plain negated refs (`not input.x.y`) and eq-unification sides
keep their refs inline (rewriteDynamicsEqExpr only rewrites nested bracket
operands), so `not x.y` keeps its succeed-on-undefined behavior.

The reference's policy library relies on both behaviors (e.g.
gatekeeper/library/pod-security-policy/users/src.rego vs
allow-privilege-escalation), so this pass rewrites every rule and
comprehension body at module-load time to hoist dynamics out of negated
expressions only — hoisting non-negated operands would be semantics-neutral.
"""

from __future__ import annotations

from typing import List, Tuple

from . import ast as A


class _Gen:
    def __init__(self):
        self.n = 0

    def fresh(self) -> str:
        self.n += 1
        return f"$hoist{self.n}"


def rewrite_module(mod: A.Module) -> None:
    gen = _Gen()
    for rule in mod.rules:
        rule.body = _rewrite_body(rule.body, gen)
        _rewrite_terms_in_head(rule.head, gen)


def _rewrite_terms_in_head(head: A.RuleHead, gen: _Gen) -> None:
    for t in [head.key, head.value] + list(head.args or []):
        if t is not None:
            _rewrite_nested_bodies(t, gen)


def _rewrite_body(body: A.Body, gen: _Gen) -> A.Body:
    out: List[A.Expr] = []
    for expr in body:
        out.extend(_rewrite_expr(expr, gen))
    return out


def _rewrite_expr(expr: A.Expr, gen: _Gen) -> List[A.Expr]:
    if isinstance(expr, A.NotExpr):
        hoists, inner = _hoist_expr(expr.expr, gen)
        # recursively rewrite any comprehension bodies inside
        for h in hoists:
            _rewrite_nested_bodies_expr(h, gen)
        _rewrite_nested_bodies_expr(inner, gen)
        return hoists + [A.NotExpr(expr=inner, line=expr.line)]
    if isinstance(expr, A.WithExpr):
        rewritten = _rewrite_expr(expr.expr, gen)
        return [
            A.WithExpr(expr=e, mods=expr.mods, line=expr.line) for e in rewritten
        ]
    _rewrite_nested_bodies_expr(expr, gen)
    return [expr]


def _rewrite_nested_bodies_expr(expr: A.Expr, gen: _Gen) -> None:
    if isinstance(expr, A.TermExpr):
        _rewrite_nested_bodies(expr.term, gen)
    elif isinstance(expr, A.Assign):
        _rewrite_nested_bodies(expr.target, gen)
        _rewrite_nested_bodies(expr.value, gen)
    elif isinstance(expr, A.Unify):
        _rewrite_nested_bodies(expr.lhs, gen)
        _rewrite_nested_bodies(expr.rhs, gen)
    elif isinstance(expr, A.NotExpr):
        _rewrite_nested_bodies_expr(expr.expr, gen)
    elif isinstance(expr, A.WithExpr):
        _rewrite_nested_bodies_expr(expr.expr, gen)


def _rewrite_nested_bodies(term: A.Term, gen: _Gen) -> None:
    """Apply negation-hoisting inside comprehension bodies nested in terms."""
    if isinstance(term, A.Comprehension):
        term.body = _rewrite_body(term.body, gen)
        _rewrite_nested_bodies(term.head, gen)
        if term.key is not None:
            _rewrite_nested_bodies(term.key, gen)
    elif isinstance(term, A.Ref):
        _rewrite_nested_bodies(term.head, gen)
        for op in term.ops:
            _rewrite_nested_bodies(op, gen)
    elif isinstance(term, A.Call):
        for a in term.args:
            _rewrite_nested_bodies(a, gen)
    elif isinstance(term, A.BinOp):
        _rewrite_nested_bodies(term.lhs, gen)
        _rewrite_nested_bodies(term.rhs, gen)
    elif isinstance(term, A.UnaryMinus):
        _rewrite_nested_bodies(term.operand, gen)
    elif isinstance(term, (A.ArrayTerm, A.SetTerm)):
        for x in term.items:
            _rewrite_nested_bodies(x, gen)
    elif isinstance(term, A.ObjectTerm):
        for k, v in term.items:
            _rewrite_nested_bodies(k, gen)
            _rewrite_nested_bodies(v, gen)


# -- hoisting inside a negated expression -----------------------------------


def _hoist_expr(expr: A.Expr, gen: _Gen) -> Tuple[List[A.Expr], A.Expr]:
    hoists: List[A.Expr] = []
    if isinstance(expr, A.TermExpr):
        t = expr.term
        if isinstance(t, A.Ref):
            # keep the ref itself inline; hoist dynamic bracket operands
            new_ops = [_hoist_operand(op, gen, hoists) for op in t.ops]
            new_t = A.Ref(head=t.head, ops=new_ops, line=t.line)
            return hoists, A.TermExpr(term=new_t, line=expr.line)
        if isinstance(t, (A.Call, A.BinOp)):
            return hoists, A.TermExpr(
                term=_hoist_call_like(t, gen, hoists), line=expr.line
            )
        return hoists, expr
    if isinstance(expr, A.Unify):
        # eq semantics: refs on either side stay inline; only their bracket
        # operands are hoisted
        lhs = _hoist_eq_side(expr.lhs, gen, hoists)
        rhs = _hoist_eq_side(expr.rhs, gen, hoists)
        return hoists, A.Unify(lhs=lhs, rhs=rhs, line=expr.line)
    if isinstance(expr, A.Assign):
        value = _hoist_eq_side(expr.value, gen, hoists)
        return hoists, A.Assign(target=expr.target, value=value, line=expr.line)
    if isinstance(expr, A.NotExpr):
        # double negation: rewrite inner independently
        inner_h, inner = _hoist_expr(expr.expr, gen)
        return hoists, A.NotExpr(
            expr=inner if not inner_h else expr.expr, line=expr.line
        )
    return hoists, expr


def _hoist_eq_side(t: A.Term, gen: _Gen, hoists: List[A.Expr]) -> A.Term:
    if isinstance(t, A.Ref):
        new_ops = [_hoist_operand(op, gen, hoists) for op in t.ops]
        return A.Ref(head=t.head, ops=new_ops, line=t.line)
    if isinstance(t, (A.Call, A.BinOp)):
        return _hoist_call_like(t, gen, hoists)
    return t


def _hoist_call_like(t: A.Term, gen: _Gen, hoists: List[A.Expr]) -> A.Term:
    if isinstance(t, A.Call):
        new_args = [_hoist_operand(a, gen, hoists) for a in t.args]
        return A.Call(name=t.name, args=new_args, line=t.line)
    assert isinstance(t, A.BinOp)
    if t.op == "==":
        # OPA rewrites `==` to `=` (RewriteEquals) before dynamics hoisting,
        # so equality keeps refs inline: `not x.missing == false` succeeds on
        # undefined (relied on by e.g. the reference's
        # allow-privilege-escalation template)
        lhs = _hoist_eq_side(t.lhs, gen, hoists)
        rhs = _hoist_eq_side(t.rhs, gen, hoists)
        return A.BinOp(op=t.op, lhs=lhs, rhs=rhs, line=t.line)
    lhs = _hoist_operand(t.lhs, gen, hoists)
    rhs = _hoist_operand(t.rhs, gen, hoists)
    return A.BinOp(op=t.op, lhs=lhs, rhs=rhs, line=t.line)


def _hoist_operand(t: A.Term, gen: _Gen, hoists: List[A.Expr]) -> A.Term:
    """Replace a dynamic operand with a fresh local bound before the expr."""
    if isinstance(t, A.Ref):
        # hoist nested dynamics first, then the ref itself
        new_ops = [_hoist_operand(op, gen, hoists) for op in t.ops]
        inner = A.Ref(head=t.head, ops=new_ops, line=t.line)
        v = gen.fresh()
        hoists.append(A.Unify(lhs=A.Var(name=v, line=t.line), rhs=inner, line=t.line))
        return A.Var(name=v, line=t.line)
    if isinstance(t, (A.Call, A.BinOp)):
        inner = _hoist_call_like(t, gen, hoists)
        v = gen.fresh()
        hoists.append(
            A.Unify(lhs=A.Var(name=v, line=t.line), rhs=inner, line=t.line)
        )
        return A.Var(name=v, line=t.line)
    if isinstance(t, (A.ArrayTerm, A.SetTerm)):
        items = [_hoist_operand(x, gen, hoists) for x in t.items]
        if isinstance(t, A.ArrayTerm):
            return A.ArrayTerm(items=items, line=t.line)
        return A.SetTerm(items=items, line=t.line)
    if isinstance(t, A.ObjectTerm):
        items = [
            (_hoist_operand(k, gen, hoists), _hoist_operand(v, gen, hoists))
            for k, v in t.items
        ]
        return A.ObjectTerm(items=items, line=t.line)
    # scalars, vars, wildcards, comprehensions (always defined) stay inline
    return t
