# Copied from gatekeeper_tpu/rego/ast.py; only imports and the edits noted in this header differ.
# Edit: source paths in comments point into the upstream Gatekeeper repo (gatekeeper/...).
"""AST for the Rego dialect used by Gatekeeper's policy library.

Shapes follow the OPA grammar (reference: the vendored OPA parser at
gatekeeper/vendor/github.com/open-policy-agent/opa/ast/) but are
re-modeled as plain Python dataclasses; only the constructs exercised by
the reference's 26 library templates, its target matching library, and the
constraint-framework hook glue are represented.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple


class Node:
    line: int = 0


# ---------------------------------------------------------------------------
# Terms


@dataclass
class Term(Node):
    pass


@dataclass
class Scalar(Term):
    """String, int, float, bool, or None (null)."""

    value: Any
    line: int = 0


@dataclass
class Var(Term):
    name: str
    line: int = 0


@dataclass
class Wildcard(Term):
    """`_` — an anonymous, always-fresh variable."""

    line: int = 0
    # unique id assigned by the parser so each `_` is a distinct variable
    uid: int = 0

    @property
    def name(self) -> str:
        return f"$wild{self.uid}"


@dataclass
class Ref(Term):
    """A reference: head term followed by operand terms.

    `input.review.object.spec.containers[_].name` has head Var("input") and
    operands [Scalar("review"), Scalar("object"), ..., Wildcard(), Scalar("name")].
    """

    head: Term
    ops: List[Term] = field(default_factory=list)
    line: int = 0


@dataclass
class ArrayTerm(Term):
    items: List[Term] = field(default_factory=list)
    line: int = 0


@dataclass
class ObjectTerm(Term):
    items: List[Tuple[Term, Term]] = field(default_factory=list)
    line: int = 0


@dataclass
class SetTerm(Term):
    items: List[Term] = field(default_factory=list)
    line: int = 0


@dataclass
class Call(Term):
    """Builtin or user function call: name is a dotted path string."""

    name: str
    args: List[Term] = field(default_factory=list)
    line: int = 0


@dataclass
class Comprehension(Term):
    """Array / set / object comprehension.

    kind: "array" | "set" | "object"
    For object comprehensions `key` is set; otherwise only `head`.
    """

    kind: str
    head: Term
    body: "Body"
    key: Optional[Term] = None
    line: int = 0


@dataclass
class UnaryMinus(Term):
    operand: Term
    line: int = 0


@dataclass
class BinOp(Term):
    """Infix operator term: arithmetic, comparison, set ops.

    op in {"+", "-", "*", "/", "%", "&", "|",
           "==", "!=", "<", "<=", ">", ">="}
    """

    op: str
    lhs: Term
    rhs: Term
    line: int = 0


# ---------------------------------------------------------------------------
# Expressions (body statements)


@dataclass
class Expr(Node):
    pass


@dataclass
class TermExpr(Expr):
    """A bare term used as an expression (truthiness / definedness check)."""

    term: Term
    line: int = 0


@dataclass
class Assign(Expr):
    """`pattern := value` — declarative assignment."""

    target: Term
    value: Term
    line: int = 0


@dataclass
class Unify(Expr):
    """`a = b` — bidirectional unification."""

    lhs: Term
    rhs: Term
    line: int = 0


@dataclass
class NotExpr(Expr):
    expr: Expr
    line: int = 0


@dataclass
class SomeDecl(Expr):
    names: List[str] = field(default_factory=list)
    line: int = 0


@dataclass
class Every(Expr):
    """`every x in xs { body }` — not used by the reference library but kept
    for forward compatibility; the parser accepts it."""

    key: Optional[str]
    value: str
    domain: Term
    body: "Body" = None  # type: ignore[assignment]
    line: int = 0


@dataclass
class WithModifier(Node):
    target: Term  # a Ref like input / data.inventory
    value: Term
    line: int = 0


@dataclass
class WithExpr(Expr):
    """expr with target as value [with ...]."""

    expr: Expr
    mods: List[WithModifier] = field(default_factory=list)
    line: int = 0


Body = List[Expr]


# ---------------------------------------------------------------------------
# Rules / modules


@dataclass
class RuleHead(Node):
    name: str
    # function arguments (None if not a function)
    args: Optional[List[Term]] = None
    # partial rule key (the term inside [...]); None for complete rules
    key: Optional[Term] = None
    # rule value (term after =); None means implicit `true`
    value: Optional[Term] = None
    # kind: "complete" | "set" | "object" | "func"
    kind: str = "complete"
    line: int = 0


@dataclass
class Rule(Node):
    head: RuleHead
    body: Body = field(default_factory=list)
    is_default: bool = False
    else_rule: Optional["Rule"] = None
    line: int = 0


@dataclass
class Import(Node):
    path: List[str] = field(default_factory=list)
    alias: Optional[str] = None
    line: int = 0


@dataclass
class Module(Node):
    package: List[str] = field(default_factory=list)
    imports: List[Import] = field(default_factory=list)
    rules: List[Rule] = field(default_factory=list)
    line: int = 0

    @property
    def package_path(self) -> str:
        return ".".join(self.package)
