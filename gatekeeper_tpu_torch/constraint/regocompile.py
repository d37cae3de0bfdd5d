# Copied from gatekeeper_tpu/constraint/regocompile.py; only imports and the edits noted in this header differ.
"""Template Rego compile pipeline: parse, validate, namespace-rewrite.

AST-level equivalent of the reference's regorewriter + rego_helpers
(vendor/.../frameworks/constraint/pkg/regorewriter/regorewriter.go,
client/rego_helpers.go:17-100, client/client.go:280-345): entry-point
violation-arity enforcement, package rewriting into the per-template
namespace, lib package prefixing, `data.lib` reference rewriting, and
data-extern allowlisting. Operating on parsed ASTs (not source text) means
template kinds/targets containing dots can't corrupt paths and the driver
mounts modules without re-parsing.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Set

from ..rego import ast as A
from ..rego.parser import ParseError, parse_module
from .errors import InvalidTemplateError


def parse_template_module(src: str) -> A.Module:
    if not src or not src.strip():
        raise InvalidTemplateError("Empty module")
    try:
        return parse_module(src)
    except ParseError as e:
        raise InvalidTemplateError(f"Rego parse error: {e}") from e


def rule_arity(rule: A.Rule) -> int:
    """getRuleArity (client/rego_helpers.go:75-100): partial-set keys count
    as arity 1 (var or object), arrays of vars/objects as their length."""
    t = rule.head.key
    if t is None:
        return 0
    if isinstance(t, (A.Var, A.Wildcard, A.ObjectTerm)):
        return 1
    if isinstance(t, A.ArrayTerm):
        for e in t.items:
            if not isinstance(e, (A.Var, A.Wildcard, A.ObjectTerm)):
                raise InvalidTemplateError(
                    "Invalid rule signature: only single variables or arrays "
                    "of variables or objects allowed"
                )
        return len(t.items)
    raise InvalidTemplateError(
        "Invalid rule signature, only variables or arrays allowed"
    )


def require_rules(module: A.Module, required: dict) -> None:
    """requireRulesModule (client/rego_helpers.go:45-72)."""
    arities = {}
    for rule in module.rules:
        arities[rule.head.name] = rule_arity(rule)
    errs = []
    for name, arity in required.items():
        if name not in arities:
            errs.append(f"Missing required rule: {name}")
        elif arities[name] != arity:
            errs.append(f"Rule {name} has arity {arities[name]}, want {arity}")
    if errs:
        raise InvalidTemplateError("Invalid rego: " + "; ".join(errs))


# -- generic AST walk -------------------------------------------------------


def _walk(node: Any, visit: Callable[[Any], None]) -> None:
    """Depth-first walk over every AST node reachable from `node`."""
    if isinstance(node, A.Node):
        visit(node)
        for f in dataclasses.fields(node):  # type: ignore[arg-type]
            _walk(getattr(node, f.name), visit)
    elif isinstance(node, (list, tuple)):
        for item in node:
            _walk(item, visit)


def walk_module(module: A.Module, visit: Callable[[Any], None]) -> None:
    _walk(module.rules, visit)


def _import_data_head(imp: A.Import) -> Optional[str]:
    if len(imp.path) >= 2 and imp.path[0] == "data":
        return imp.path[1]
    return None


# -- namespace rewriting ----------------------------------------------------


def _data_ref_head(term: A.Ref) -> Optional[str]:
    """For a ref rooted at `data`, return the first path segment (or None)."""
    if isinstance(term.head, A.Var) and term.head.name == "data" and term.ops:
        first = term.ops[0]
        if isinstance(first, A.Scalar) and isinstance(first.value, str):
            return first.value
    return None


def validate_externs(module: A.Module, allowed: Sequence[str]) -> None:
    """Reject data.<field> references outside the allowlist
    (client/client.go:286-298 wires {data.lib} + allowedDataFields)."""
    allowed_set: Set[str] = set(allowed)
    bad: List[str] = []

    def visit(node: Any) -> None:
        if isinstance(node, A.Ref):
            head = _data_ref_head(node)
            if head is not None and head not in allowed_set:
                bad.append(f"data.{head}")
        elif isinstance(node, A.Call) and node.name.startswith("data."):
            seg = node.name.split(".")[1]
            if seg not in allowed_set:
                bad.append(f"data.{seg}")

    walk_module(module, visit)
    for imp in module.imports:
        head = _import_data_head(imp)
        if head is not None and head not in allowed_set:
            bad.append(f"data.{head}")
    if bad:
        raise InvalidTemplateError(
            f"invalid data references: {sorted(set(bad))} (allowed: "
            f"{sorted(allowed_set)})"
        )


def rewrite_lib_refs(module: A.Module, ns: str) -> None:
    """Rewrite data.lib.X -> data.libs.<ns>.lib.X (refs and call names).

    regorewriter's PackagePrefixer equivalent; `ns` is the template kind,
    which is unique per template and dot-free (so call-name paths stay
    unambiguous even for targets with dots in their name).
    """

    def visit(node: Any) -> None:
        if isinstance(node, A.Ref):
            if _data_ref_head(node) == "lib":
                node.ops[0:0] = [A.Scalar("libs"), A.Scalar(ns)]
        elif isinstance(node, A.Call):
            if node.name.startswith("data.lib."):
                node.name = f"data.libs.{ns}.lib." + node.name[len("data.lib.") :]

    walk_module(module, visit)
    for imp in module.imports:
        if _import_data_head(imp) == "lib":
            imp.path[1:1] = ["libs", ns]


def compile_template_modules(
    kind: str,
    target_name: str,
    rego_src: str,
    lib_srcs: Sequence[str],
    allowed_data_fields: Sequence[str] = ("inventory",),
) -> List[A.Module]:
    """Full pipeline: returns mounted-ready modules (entry first).

    The entry module's package becomes ["templates", <target>, <Kind>]
    (createTemplatePath, client/client.go:142-145); each lib's package gets
    the ["libs", <Kind>] prefix (templateLibPrefix, :147-150 — target elided
    for path-safety, kind is already unique).
    """
    entry = parse_template_module(rego_src)
    require_rules(entry, {"violation": 1})
    validate_externs(entry, ["lib", *allowed_data_fields])
    rewrite_lib_refs(entry, kind)
    entry.package = ["templates", target_name, kind]

    modules = [entry]
    for lib_src in lib_srcs:
        lib = parse_template_module(lib_src)
        if not lib.package or lib.package[0] != "lib":
            raise InvalidTemplateError(
                f"the lib package must begin with `lib`, got "
                f"{'.'.join(lib.package)!r}"
            )
        validate_externs(lib, ["lib", *allowed_data_fields])
        rewrite_lib_refs(lib, kind)
        lib.package = ["libs", kind, *lib.package]
        modules.append(lib)
    return modules
