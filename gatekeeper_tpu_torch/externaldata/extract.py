# Copied from gatekeeper_tpu/externaldata/extract.py; unchanged.
"""Static key extraction for the batch plane.

The micro-batch contract — one outbound fetch per (provider, batch) —
requires knowing every key a batch will look up BEFORE evaluation. The
analyzer records each template's `external_data` call sites
(`analysis.report.ExternalDataCall`); when a call's keys expression is
*input-derived* (built from `input.review` walks, literals, and
comprehension-local bindings only), this module evaluates just that
expression per review with the Rego interpreter — a micro-evaluation
orders of magnitude cheaper than the template body — and the union of
keys across the batch feeds `ExternalDataSystem.prefetch`.

Calls whose keys cannot be statically extracted (parameters-dependent,
flowing through helpers) degrade gracefully: no prefetch, the coarse
all-rows screen, and per-call fetches at resolve time (still one fetch
per distinct missing key set per epoch).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Set


def extract_keys(interp, call, review: Any) -> Optional[Set[str]]:
    """Evaluate one recorded call's keys expression against a review.

    -> set of string keys, or None when the expression is undefined or
    errors for this review (callers treat None as "route the row" —
    coarse, sound)."""
    from ..rego.interp import _eval_term
    from ..rego.values import type_name

    if call.keys_term is None or call.module is None:
        return None
    try:
        ctx = interp.make_context({"review": review}, {})
        keys: Set[str] = set()
        found = False
        for v, _env in _eval_term(ctx, call.module, call.keys_term, {}):
            found = True
            if type_name(v) not in ("array", "set"):
                return None
            for k in v:
                if not isinstance(k, str):
                    return None
                keys.add(k)
        return keys if found else None
    except Exception:
        return None


def batch_wants(
    interp, calls: Sequence[Any], reviews: Sequence[Any]
) -> Optional[Dict[str, Set[str]]]:
    """{provider -> deduped keys} across a whole batch, or None when
    any call is unextractable (prefetch impossible)."""
    wants: Dict[str, Set[str]] = {}
    for call in calls:
        if not getattr(call, "extractable", False) or not call.provider:
            return None
        for review in reviews:
            keys = extract_keys(interp, call, review)
            if keys:
                wants.setdefault(call.provider, set()).update(keys)
    return wants
