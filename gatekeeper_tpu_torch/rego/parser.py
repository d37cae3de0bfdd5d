# Copied from gatekeeper_tpu/rego/parser.py; only imports and the edits noted in this header differ.
# Edit: source paths in comments point into the upstream Gatekeeper repo (gatekeeper/...).
"""Recursive-descent Rego parser.

Produces the AST in ast.py. Grammar coverage is the dialect exercised by the
reference's policy library (gatekeeper/library), target matching library
(gatekeeper/pkg/target/target_template_source.go) and constraint hook
glue (gatekeeper/vendor/.../frameworks/constraint/pkg/client/regolib/
src.go): complete/partial/function rules with multiple clauses, default
rules, comprehensions, refs, `not`, `some`, `with` modifiers, and the infix
operator set.

Newline discipline: newlines separate body expressions at bracket depth 0
and are insignificant inside (), [], {} — mirroring OPA's scanner behavior.
"""

from __future__ import annotations

from typing import List, Optional

from .ast import (
    ArrayTerm,
    Assign,
    BinOp,
    Body,
    Call,
    Comprehension,
    Every,
    Expr,
    Import,
    Module,
    NotExpr,
    ObjectTerm,
    Ref,
    Rule,
    RuleHead,
    Scalar,
    SetTerm,
    SomeDecl,
    Term,
    TermExpr,
    UnaryMinus,
    Unify,
    Var,
    Wildcard,
    WithExpr,
    WithModifier,
)
from .lexer import Token, tokenize

COMPARE_OPS = {"==", "!=", "<", "<=", ">", ">="}


class ParseError(Exception):
    def __init__(self, msg: str, tok: Optional[Token] = None):
        loc = f" (line {tok.line}, near {tok.value!r})" if tok else ""
        super().__init__(msg + loc)


class Parser:
    def __init__(self, src: str):
        self.toks = tokenize(src)
        self.i = 0
        self.depth = 0  # bracket nesting; newlines skipped when > 0
        self.wild_counter = 0
        # When parsing the first term inside [...] or {...}, a top-level '|'
        # separates the comprehension head from its body and must not be
        # consumed as set union. Parens reset this (see _parse_primary).
        self.no_union = False

    # -- token helpers ------------------------------------------------------

    def peek(self, off: int = 0) -> Token:
        j = self.i
        seen = 0
        while j < len(self.toks):
            t = self.toks[j]
            if t.kind == "newline" and self.depth > 0:
                j += 1
                continue
            if seen == off:
                return t
            seen += 1
            j += 1
        return self.toks[-1]

    def next(self) -> Token:
        while True:
            t = self.toks[self.i]
            self.i += 1
            if t.kind == "newline" and self.depth > 0:
                continue
            return t

    def skip_newlines(self) -> None:
        while self.peek().kind == "newline":
            self.next()

    def at_punct(self, p: str) -> bool:
        t = self.peek()
        return t.kind == "punct" and t.value == p

    def at_keyword(self, k: str) -> bool:
        t = self.peek()
        return t.kind == "keyword" and t.value == k

    def expect_punct(self, p: str) -> Token:
        t = self.next()
        if t.kind != "punct" or t.value != p:
            raise ParseError(f"expected {p!r}", t)
        return t

    def expect_ident(self) -> Token:
        t = self.next()
        if t.kind != "ident":
            raise ParseError("expected identifier", t)
        return t

    def open(self, p: str) -> None:
        self.expect_punct(p)
        self.depth += 1

    def close(self, p: str) -> None:
        self.expect_punct(p)
        self.depth -= 1

    # -- module / rules -----------------------------------------------------

    def parse_module(self) -> Module:
        self.skip_newlines()
        t = self.next()
        if not (t.kind == "keyword" and t.value == "package"):
            raise ParseError("expected 'package'", t)
        pkg = self._parse_package_path()
        mod = Module(package=pkg, line=t.line)
        self.skip_newlines()
        while self.at_keyword("import"):
            mod.imports.append(self._parse_import())
            self.skip_newlines()
        while self.peek().kind != "eof":
            mod.rules.append(self._parse_rule())
            self.skip_newlines()
        return mod

    def _parse_package_path(self) -> List[str]:
        parts = []
        while True:
            t = self.next()
            if t.kind == "ident":
                parts.append(t.value)
            elif t.kind == "string":
                parts.append(t.value)
            else:
                raise ParseError("expected package path segment", t)
            if self.at_punct("."):
                self.next()
                continue
            if self.at_punct("["):
                # package templates["admission.k8s.gatekeeper.sh"]["Kind"]
                self.open("[")
                seg = self.next()
                if seg.kind != "string":
                    raise ParseError("expected string in package path", seg)
                parts.append(seg.value)
                self.close("]")
                continue
            break
        return parts

    def _parse_import(self) -> Import:
        t = self.next()  # 'import'
        path = []
        while True:
            seg = self.next()
            if seg.kind not in ("ident", "keyword", "string"):
                raise ParseError("expected import path segment", seg)
            path.append(str(seg.value))
            if self.at_punct("."):
                self.next()
                continue
            break
        alias = None
        if self.at_keyword("as"):
            self.next()
            alias = self.expect_ident().value
        return Import(path=path, alias=alias, line=t.line)

    def _parse_rule(self) -> Rule:
        is_default = False
        if self.at_keyword("default"):
            self.next()
            is_default = True
        start = self.peek()
        head = self._parse_rule_head()
        body: Body = []
        if self.at_punct("{"):
            body = self._parse_body_block()
        rule = Rule(head=head, body=body, is_default=is_default, line=start.line)
        if self.at_keyword("else"):
            raise ParseError("'else' rules are not supported", self.peek())
        return rule

    def _parse_rule_head(self) -> RuleHead:
        name_tok = self.expect_ident()
        head = RuleHead(name=name_tok.value, line=name_tok.line)
        if self.at_punct("("):
            head.kind = "func"
            head.args = []
            self.open("(")
            if not self.at_punct(")"):
                while True:
                    head.args.append(self.parse_term())
                    if self.at_punct(","):
                        self.next()
                        continue
                    break
            self.close(")")
        elif self.at_punct("["):
            self.open("[")
            head.key = self.parse_term()
            self.close("]")
            head.kind = "set"
        if self.at_punct("=") or self.at_punct(":="):
            self.next()
            head.value = self.parse_term()
            if head.kind == "set":
                head.kind = "object"
            elif head.kind != "func":
                head.kind = "complete"
        if head.kind == "complete" and head.value is None:
            head.value = Scalar(True, line=head.line)
        if head.kind == "func" and head.value is None:
            head.value = Scalar(True, line=head.line)
        return head

    def _parse_body_block(self) -> Body:
        self.expect_punct("{")
        # newlines inside a rule body are significant: do NOT bump depth
        body: Body = []
        self.skip_newlines()
        while not self.at_punct("}"):
            body.append(self.parse_expr())
            # separator: newline(s) or ';'
            while self.at_punct(";") or self.peek().kind == "newline":
                self.next()
        self.expect_punct("}")
        return body

    # -- expressions --------------------------------------------------------

    def parse_expr(self) -> Expr:
        expr = self._parse_expr_inner()
        if self.at_keyword("with"):
            mods = []
            while self.at_keyword("with"):
                wt = self.next()
                target = self.parse_term()
                if not self.at_keyword("as"):
                    raise ParseError("expected 'as' in with modifier", self.peek())
                self.next()
                value = self.parse_term()
                mods.append(WithModifier(target=target, value=value, line=wt.line))
            return WithExpr(expr=expr, mods=mods)
        return expr

    def _parse_expr_inner(self) -> Expr:
        t = self.peek()
        if t.kind == "keyword" and t.value == "not":
            self.next()
            inner = self._parse_expr_inner()
            return NotExpr(expr=inner, line=t.line)
        if t.kind == "keyword" and t.value == "some":
            self.next()
            names = [self.expect_ident().value]
            while self.at_punct(","):
                self.next()
                names.append(self.expect_ident().value)
            # `some x in xs` membership form is not used by the corpus
            if self.at_keyword("in"):
                raise ParseError("'some .. in ..' is not supported", self.peek())
            return SomeDecl(names=names, line=t.line)
        if t.kind == "keyword" and t.value == "every":
            raise ParseError("'every' is not supported", t)

        lhs = self.parse_term()
        nxt = self.peek()
        if nxt.kind == "punct" and nxt.value == ":=":
            self.next()
            value = self.parse_term()
            return Assign(target=lhs, value=value, line=t.line)
        if nxt.kind == "punct" and nxt.value == "=":
            self.next()
            rhs = self.parse_term()
            return Unify(lhs=lhs, rhs=rhs, line=t.line)
        return TermExpr(term=lhs, line=t.line)

    # -- terms with precedence ---------------------------------------------
    # compare < | < & < +- < */% < unary < postfix

    def parse_term(self) -> Term:
        return self._parse_compare()

    def _parse_term_no_union(self) -> Term:
        saved = self.no_union
        self.no_union = True
        try:
            return self.parse_term()
        finally:
            self.no_union = saved

    def _parse_term_union_ok(self) -> Term:
        saved = self.no_union
        self.no_union = False
        try:
            return self.parse_term()
        finally:
            self.no_union = saved

    def _parse_compare(self) -> Term:
        lhs = self._parse_union()
        t = self.peek()
        if t.kind == "punct" and t.value in COMPARE_OPS:
            self.next()
            rhs = self._parse_union()
            return BinOp(op=t.value, lhs=lhs, rhs=rhs, line=t.line)
        return lhs

    def _parse_union(self) -> Term:
        lhs = self._parse_intersect()
        while self.at_punct("|") and not self.no_union:
            t = self.next()
            rhs = self._parse_intersect()
            lhs = BinOp(op="|", lhs=lhs, rhs=rhs, line=t.line)
        return lhs

    def _parse_intersect(self) -> Term:
        lhs = self._parse_additive()
        while self.at_punct("&"):
            t = self.next()
            rhs = self._parse_additive()
            lhs = BinOp(op="&", lhs=lhs, rhs=rhs, line=t.line)
        return lhs

    def _parse_additive(self) -> Term:
        lhs = self._parse_multiplicative()
        while self.at_punct("+") or self.at_punct("-"):
            t = self.next()
            rhs = self._parse_multiplicative()
            lhs = BinOp(op=t.value, lhs=lhs, rhs=rhs, line=t.line)
        return lhs

    def _parse_multiplicative(self) -> Term:
        lhs = self._parse_unary()
        while self.at_punct("*") or self.at_punct("/") or self.at_punct("%"):
            t = self.next()
            rhs = self._parse_unary()
            lhs = BinOp(op=t.value, lhs=lhs, rhs=rhs, line=t.line)
        return lhs

    def _parse_unary(self) -> Term:
        if self.at_punct("-"):
            t = self.next()
            operand = self._parse_unary()
            if isinstance(operand, Scalar) and isinstance(operand.value, (int, float)):
                return Scalar(-operand.value, line=t.line)
            return UnaryMinus(operand=operand, line=t.line)
        return self._parse_postfix()

    def _parse_postfix(self) -> Term:
        base = self._parse_primary()
        # A dotted identifier chain followed by '(' is a call.
        while True:
            if self.at_punct("."):
                self.next()
                attr = self.next()
                if attr.kind not in ("ident", "keyword"):
                    raise ParseError("expected attribute name", attr)
                nxt = self.peek()
                if (
                    nxt.kind == "punct"
                    and nxt.value == "("
                    and self._is_name_chain(base)
                ):
                    name = self._name_chain_str(base) + "." + str(attr.value)
                    base = self._parse_call_args(name, attr.line)
                else:
                    base = self._ref_append(base, Scalar(str(attr.value), line=attr.line))
            elif self.at_punct("["):
                t = self.peek()
                self.open("[")
                idx = self._parse_term_union_ok()
                self.close("]")
                base = self._ref_append(base, idx, line=t.line)
            elif self.at_punct("(") and self._is_name_chain(base):
                name = self._name_chain_str(base)
                base = self._parse_call_args(name, self.peek().line)
            else:
                break
        return base

    @staticmethod
    def _is_name_chain(t: Term) -> bool:
        if isinstance(t, Var):
            return True
        if isinstance(t, Ref) and isinstance(t.head, Var):
            return all(
                isinstance(op, Scalar) and isinstance(op.value, str) for op in t.ops
            )
        return False

    @staticmethod
    def _name_chain_str(t: Term) -> str:
        if isinstance(t, Var):
            return t.name
        assert isinstance(t, Ref)
        parts = [t.head.name] + [op.value for op in t.ops]  # type: ignore[union-attr]
        return ".".join(parts)

    def _parse_call_args(self, name: str, line: int) -> Call:
        self.open("(")
        args: List[Term] = []
        if not self.at_punct(")"):
            while True:
                args.append(self._parse_term_union_ok())
                if self.at_punct(","):
                    self.next()
                    continue
                break
        self.close(")")
        return Call(name=name, args=args, line=line)

    @staticmethod
    def _ref_append(base: Term, op: Term, line: int = 0) -> Ref:
        if isinstance(base, Ref):
            base.ops.append(op)
            return base
        return Ref(head=base, ops=[op], line=getattr(base, "line", line))

    def _parse_primary(self) -> Term:
        t = self.peek()
        if t.kind == "string":
            self.next()
            return Scalar(t.value, line=t.line)
        if t.kind == "number":
            self.next()
            return Scalar(t.value, line=t.line)
        if t.kind == "keyword":
            if t.value in ("true", "false"):
                self.next()
                return Scalar(t.value == "true", line=t.line)
            if t.value == "null":
                self.next()
                return Scalar(None, line=t.line)
            raise ParseError("unexpected keyword in term", t)
        if t.kind == "ident":
            self.next()
            if t.value == "_":
                self.wild_counter += 1
                return Wildcard(line=t.line, uid=self.wild_counter)
            return Var(name=t.value, line=t.line)
        if t.kind == "punct":
            if t.value == "_":
                self.next()
                self.wild_counter += 1
                return Wildcard(line=t.line, uid=self.wild_counter)
            if t.value == "(":
                self.open("(")
                inner = self._parse_term_union_ok()
                self.close(")")
                return inner
            if t.value == "[":
                return self._parse_array(t)
            if t.value == "{":
                return self._parse_brace(t)
        raise ParseError("unexpected token in term", t)

    def _parse_array(self, t: Token) -> Term:
        self.open("[")
        if self.at_punct("]"):
            self.close("]")
            return ArrayTerm(items=[], line=t.line)
        first = self._parse_term_no_union()
        if self.at_punct("|"):
            self.next()
            body = self._parse_comprehension_body("]")
            return Comprehension(kind="array", head=first, body=body, line=t.line)
        items = [first]
        while self.at_punct(","):
            self.next()
            if self.at_punct("]"):
                break
            items.append(self._parse_term_union_ok())
        self.close("]")
        return ArrayTerm(items=items, line=t.line)

    def _parse_brace(self, t: Token) -> Term:
        self.open("{")
        if self.at_punct("}"):
            self.close("}")
            return ObjectTerm(items=[], line=t.line)
        first = self._parse_term_no_union()
        if self.at_punct(":"):
            self.next()
            value = self._parse_term_no_union()
            if self.at_punct("|"):
                self.next()
                body = self._parse_comprehension_body("}")
                return Comprehension(
                    kind="object", head=value, key=first, body=body, line=t.line
                )
            items = [(first, value)]
            while self.at_punct(","):
                self.next()
                if self.at_punct("}"):
                    break
                k = self.parse_term()
                self.expect_punct(":")
                v = self.parse_term()
                items.append((k, v))
            self.close("}")
            return ObjectTerm(items=items, line=t.line)
        if self.at_punct("|"):
            self.next()
            body = self._parse_comprehension_body("}")
            return Comprehension(kind="set", head=first, body=body, line=t.line)
        items = [first]
        while self.at_punct(","):
            self.next()
            if self.at_punct("}"):
                break
            items.append(self._parse_term_union_ok())
        self.close("}")
        return SetTerm(items=items, line=t.line)

    def _parse_comprehension_body(self, closer: str) -> Body:
        # inside a comprehension we're within brackets, so newlines are
        # already skipped; statements are separated by ';'
        saved = self.no_union
        self.no_union = False
        try:
            body: Body = []
            body.append(self.parse_expr())
            while self.at_punct(";"):
                self.next()
                if self.at_punct(closer):
                    break
                body.append(self.parse_expr())
            self.close(closer)
            return body
        finally:
            self.no_union = saved

    # -- queries ------------------------------------------------------------

    def parse_query(self) -> Body:
        """Parse a semicolon/newline-separated query (for tests/tools)."""
        body: Body = []
        self.skip_newlines()
        while self.peek().kind != "eof":
            body.append(self.parse_expr())
            while self.at_punct(";") or self.peek().kind == "newline":
                self.next()
        return body


def parse_module(src: str) -> Module:
    return Parser(src).parse_module()


def parse_query(src: str) -> Body:
    return Parser(src).parse_query()
