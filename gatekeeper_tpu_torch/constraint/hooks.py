# Copied from gatekeeper_tpu/constraint/hooks.py; only imports and the edits noted in this header differ.
"""Target-neutral hook-library helpers.

The regolib hook semantics (client/regolib/src.go:7-85) that every
evaluation path shares — constraint spec access, enforcement action,
Rego-equality — factored out of the K8s matching oracle so engine code
(drivers, mutation, webhook) can consume them WITHOUT importing the
target-specific matching semantics in `constraint/match.py`. That
module is reached only through the `TargetHandler` interface
(docs/targets.md); this one is the neutral remainder.
"""

from __future__ import annotations

from typing import Any, Dict

_MISSING = object()


def get_default(obj: Any, field: str, default: Any) -> Any:
    """target-lib get_default (target_template_source.go:110-125).

    Null-valued fields count as missing.
    """
    if isinstance(obj, dict) and field in obj and obj[field] is not None:
        return obj[field]
    return default


def hook_get_default(obj: Any, field: str, default: Any) -> Any:
    """regolib hooks get_default (client/regolib/src.go:76-85).

    Unlike the target lib's, a null value IS returned (only an absent key
    falls back to the default).
    """
    if isinstance(obj, dict) and field in obj:
        return obj[field]
    return default


def constraint_spec(constraint: Dict[str, Any]) -> Any:
    return get_default(constraint, "spec", {})


def constraint_match(constraint: Dict[str, Any]) -> Any:
    return get_default(constraint_spec(constraint), "match", {})


def enforcement_action(constraint: Dict[str, Any]) -> Any:
    spec = hook_get_default(constraint, "spec", {})
    return hook_get_default(spec, "enforcementAction", "deny")


def constraint_parameters(constraint: Dict[str, Any]) -> Any:
    spec = hook_get_default(constraint, "spec", {})
    return hook_get_default(spec, "parameters", {})


def rego_scalar_eq(a: Any, b: Any) -> bool:
    """Rego equality for scalars: true != 1 (unlike Python), 1.0 == 1."""
    if isinstance(a, bool) != isinstance(b, bool):
        return False
    return a == b
