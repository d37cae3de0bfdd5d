# Copied from gatekeeper_tpu/rego/__init__.py; only imports and the edits noted in this header differ.
# Edit: source paths in comments point into the upstream Gatekeeper repo (gatekeeper/...).
"""Rego frontend: lexer, parser, AST, and a topdown-style interpreter.

This is the semantics core of the framework. The interpreter is the oracle
that defines "correct" for every compiled TPU kernel, and doubles as the CPU
fallback driver for templates outside the vectorizable subset (the hybrid
routing described in SURVEY.md §7). It covers the Rego dialect used by the
reference's policy library (gatekeeper/library) and its target matching
library (gatekeeper/pkg/target/target_template_source.go).
"""

from .ast import (  # noqa: F401
    Module,
    Rule,
    RuleHead,
    Body,
    Expr,
    Term,
    Scalar,
    Var,
    Wildcard,
    Ref,
    ArrayTerm,
    ObjectTerm,
    SetTerm,
    Call,
    Comprehension,
    UnaryMinus,
    BinOp,
    Assign,
    Unify,
    NotExpr,
    SomeDecl,
    Every,
)
from .lexer import Lexer, Token, LexError  # noqa: F401
from .parser import Parser, ParseError, parse_module, parse_query  # noqa: F401
from .interp import Interpreter, RegoError, Undefined  # noqa: F401
