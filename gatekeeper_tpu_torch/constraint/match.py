# Copied from gatekeeper_tpu/constraint/match.py; only imports and the edits noted in this header differ.
"""Native constraint-match semantics oracle.

Implements, in plain Python, exactly the predicate the reference installs as
an interpreted Rego library (pkg/target/target_template_source.go:6-387,
mounted via client/client.go:688-700): kind selectors, namespace /
excludedNamespaces, scope, labelSelector (with the UPDATE old/new OR-match),
namespaceSelector (resolved from `_unstable.namespace` or the synced
Namespace cache), and the `autoreject_review` rule.

This single implementation is the behavior contract shared by
  * the CPU driver (called per-review here), and
  * the vectorized TPU match kernel (gatekeeper_tpu/engine/match.py), which
    is differentially tested against this module.

Deliberately replicated quirks of the reference Rego (each covered by a test):
  * A review with NO namespace field (cluster-scoped admission request) that
    is not itself a Namespace trivially matches namespaces/excludedNamespaces/
    namespaceSelector (`always_match_ns_selectors`,
    target_template_source.go:311-314), and never autorejects: OPA's
    compiler hoists `input.review.namespace` out of the negated cache
    lookup in autoreject_review (:17), so an absent namespace fails the
    whole rule. Definedness of `input.review.kind` is likewise load-bearing
    through hoisted `is_ns(...)` operands.
  * matchExpressions `In`/`NotIn` with an empty `values` list never violate
    (the `count(values) > 0` guards at :190,:198), and unrecognized operators
    are silently ignored (no match_expression_violated clause applies).
  * A Namespace-kind review whose `object.metadata.name` is missing (e.g.
    DELETE reviews carrying only oldObject) fails `get_ns_name` (:301-309),
    so any constraint with `namespaces`/`excludedNamespaces` does not match.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Tuple

from .hooks import (  # noqa: F401  (re-exported: the M.* legacy surface)
    _MISSING,
    constraint_match,
    constraint_parameters,
    constraint_spec,
    enforcement_action,
    get_default,
    hook_get_default,
)


# -- review field helpers ---------------------------------------------------


def _review_kind(review: Any) -> Any:
    """input.review.kind as a raw ref: _MISSING when absent.

    Definedness matters: every `is_ns(input.review.kind)` call site has the
    operand hoisted by OPA's compiler (rewriteDynamics — see
    gatekeeper_tpu/rego/rewrite.py), so a review with NO kind field fails
    both `is_ns(...)` and `not is_ns(...)` clauses.
    """
    if isinstance(review, dict) and "kind" in review:
        return review["kind"]
    return _MISSING


def is_ns(review: Any) -> bool:
    """is_ns(input.review.kind) — group=="" and kind=="Namespace" (:287-290)."""
    k = _review_kind(review)
    if not isinstance(k, dict):
        return False
    return k.get("group") == "" and k.get("kind") == "Namespace"


def _review_namespace(review: Any) -> Any:
    """input.review.namespace as a raw ref: _MISSING when absent."""
    if isinstance(review, dict) and "namespace" in review:
        return review["namespace"]
    return _MISSING


def always_match_ns_selectors(review: Any) -> bool:
    """Cluster-scoped non-Namespace reviews skip all ns selectors (:311-314).

    Undefined review.kind fails the hoisted `not is_ns(...)` operand, so the
    rule is undefined (False here).
    """
    if _review_kind(review) is _MISSING:
        return False
    ns = get_default(review, "namespace", "") if isinstance(review, dict) else ""
    return (not is_ns(review)) and ns == ""


def get_ns_name(review: Any) -> Any:
    """get_ns_name (:301-309). Returns _MISSING when undefined.

    Both clauses hoist `input.review.kind` into `is_ns`/`not is_ns`, so a
    missing kind makes the whole partial set undefined.
    """
    if _review_kind(review) is _MISSING:
        return _MISSING
    if is_ns(review):
        obj = review.get("object") if isinstance(review, dict) else None
        if isinstance(obj, dict):
            meta = obj.get("metadata")
            if isinstance(meta, dict) and "name" in meta:
                return meta["name"]
        return _MISSING
    return _review_namespace(review)


def get_ns_candidates(review: Any, ns_cache: Dict[str, Any]) -> List[Any]:
    """get_ns (:292-299): the namespace OBJECT(s) for the review.

    A partial set in the reference: clause 1 contributes `_unstable.namespace`
    whenever the field is defined (any value, null included); clause 2
    contributes the synced-cache object (data.external.<t>.cluster.v1.
    Namespace[review.namespace]) whenever `not _unstable.namespace` succeeds —
    i.e. the field is absent OR false. So a literal false value yields BOTH
    members, and matches_nsselector succeeds if ANY member matches.
    """
    out: List[Any] = []
    unstable_ns = _MISSING
    if isinstance(review, dict):
        unstable = review.get("_unstable")
        if isinstance(unstable, dict) and "namespace" in unstable:
            unstable_ns = unstable["namespace"]
    if unstable_ns is not _MISSING:
        out.append(unstable_ns)
    if unstable_ns is _MISSING or unstable_ns is False:
        cached = _cached_ns(review, ns_cache)
        if cached is not _MISSING:
            out.append(cached)
    return out


def _cached_ns(review: Any, ns_cache: Dict[str, Any]) -> Any:
    name = _review_namespace(review)
    if name is _MISSING or not isinstance(ns_cache, dict):
        return _MISSING
    if not isinstance(name, str) or name not in ns_cache:
        return _MISSING
    return ns_cache[name]


# -- label selector logic ---------------------------------------------------


from .hooks import rego_scalar_eq  # noqa: E402,F401  (legacy M.* surface)


def values_shape(values: Any):
    """Normalize matchExpressions `values` the way the Rego evaluates it:
    returns (count_positive, elems) where count_positive reflects
    `count(values) > 0` (None when count() errors — numbers/bools/null)
    and elems are the members `values[_]` can yield (strings iterate to
    nothing, dicts to their values)."""
    if isinstance(values, list):
        return len(values) > 0, values
    if isinstance(values, dict):
        return len(values) > 0, list(values.values())
    if isinstance(values, str):
        return len(values) > 0, []
    return None, []  # count(number/bool/null) is a builtin error


def match_expression_violated(
    operator: Any, labels: Dict[str, Any], key: Any, values: Any
) -> bool:
    """match_expression_violated (:184-210).

    has_field counts any present key — null included, since null is truthy
    in Rego (`object[field]` binds and succeeds). The `count(values) > 0`
    guards only gate In/NotIn; Exists/DoesNotExist ignore values entirely.
    """
    has_key = isinstance(labels, dict) and key in labels
    count_pos, elems = values_shape(values)
    if operator == "In":
        if not has_key:
            return True
        return bool(count_pos) and not any(
            rego_scalar_eq(labels[key], v) for v in elems
        )
    if operator == "NotIn":
        return (
            has_key
            and bool(count_pos)
            and any(rego_scalar_eq(labels[key], v) for v in elems)
        )
    if operator == "Exists":
        return not has_key
    if operator == "DoesNotExist":
        return has_key
    return False  # unknown operators contribute no violation


def matches_label_selector(selector: Any, labels: Any) -> bool:
    """matches_label_selector (:213-230)."""
    if not isinstance(labels, dict):
        labels = {}
    match_labels = get_default(selector, "matchLabels", {})
    if isinstance(match_labels, dict):
        for k, v in match_labels.items():
            if k not in labels or not rego_scalar_eq(labels[k], v):
                return False
    elif match_labels not in ([], ""):
        # non-object matchLabels: the satisfied-count comprehension yields
        # nothing while count(matchLabels) > 0 (or errors), so no match
        return False
    match_exprs = get_default(selector, "matchExpressions", [])
    if isinstance(match_exprs, list):
        for expr in match_exprs:
            if not isinstance(expr, dict):
                # expr["operator"] undefined -> comprehension body fails for
                # this element -> no violation recorded
                continue
            if "operator" not in expr or "key" not in expr:
                continue
            if match_expression_violated(
                expr["operator"],
                labels,
                expr["key"],
                get_default(expr, "values", []),
            ):
                return False
    return True


def _object_labels(obj: Any) -> Dict[str, Any]:
    metadata = get_default(obj, "metadata", {})
    labels = get_default(metadata, "labels", {})
    return labels if isinstance(labels, dict) else {}


def _review_obj(review: Any, field: str) -> Any:
    """get_default(review, field, {}) compared against {} (:233-281)."""
    val = get_default(review, field, {})
    return val


def any_labelselector_match(selector: Any, review: Any) -> bool:
    """any_labelselector_match (:233-281): OR over object/oldObject labels."""
    obj = _review_obj(review, "object")
    old = _review_obj(review, "oldObject")
    obj_absent = obj == {}
    old_absent = old == {}
    if old_absent and not obj_absent:
        return matches_label_selector(selector, _object_labels(obj))
    if not old_absent and obj_absent:
        return matches_label_selector(selector, _object_labels(old))
    if not old_absent and not obj_absent:
        return matches_label_selector(
            selector, _object_labels(obj)
        ) or matches_label_selector(selector, _object_labels(old))
    return matches_label_selector(selector, {})


# -- the five match dimensions ----------------------------------------------


def any_kind_selector_matches(match: Any, review: Any) -> bool:
    """Kind selector (:131-156)."""
    kind_selectors = get_default(
        match, "kinds", [{"apiGroups": ["*"], "kinds": ["*"]}]
    )
    if not isinstance(kind_selectors, list):
        return False
    k = _review_kind(review)
    if not isinstance(k, dict):
        k = {}
    group = k.get("group", _MISSING)
    kind = k.get("kind", _MISSING)
    for ks in kind_selectors:
        if not isinstance(ks, dict):
            continue
        groups = ks.get("apiGroups")
        kinds = ks.get("kinds")
        if not isinstance(groups, list) or not isinstance(kinds, list):
            # ks.apiGroups[_] over a missing/non-array field is undefined
            continue
        group_ok = "*" in groups or (group is not _MISSING and group in groups)
        kind_ok = "*" in kinds or (kind is not _MISSING and kind in kinds)
        if group_ok and kind_ok:
            return True
    return False


def matches_scope(match: Any, review: Any) -> bool:
    """Scope selector (:162-178).

    A present-but-null scope passes has_field (null is truthy in Rego) yet
    equals none of "*"/"Namespaced"/"Cluster", so nothing matches.
    """
    if not _has_field(match, "scope"):
        return True
    scope = match["scope"]
    if scope == "*":
        return True
    ns = get_default(review, "namespace", "")
    if scope == "Namespaced":
        return ns != ""
    if scope == "Cluster":
        return ns == ""
    return False


def matches_namespaces(match: Any, review: Any) -> bool:
    """namespaces (:316-332)."""
    if not _has_field(match, "namespaces"):
        return True
    if always_match_ns_selectors(review):
        return True
    ns = get_ns_name(review)
    if ns is _MISSING:
        return False
    nss = match["namespaces"]
    # Rego set membership, not Python `in` (True != 1 under Rego equality)
    return isinstance(nss, list) and any(rego_scalar_eq(ns, n) for n in nss)


def does_not_match_excludednamespaces(match: Any, review: Any) -> bool:
    """excludedNamespaces (:334-350)."""
    if not _has_field(match, "excludedNamespaces"):
        return True
    if always_match_ns_selectors(review):
        return True
    ns = get_ns_name(review)
    if ns is _MISSING:
        return False
    nss = match["excludedNamespaces"]
    if not isinstance(nss, list):
        # `{n | n = match.excludedNamespaces[_]}` over a non-array is the
        # empty set, so ns is trivially not excluded
        return True
    return not any(rego_scalar_eq(ns, n) for n in nss)


def matches_nsselector(
    match: Any, review: Any, ns_cache: Dict[str, Any]
) -> bool:
    """namespaceSelector (:352-386)."""
    if not _has_field(match, "namespaceSelector"):
        return True
    if always_match_ns_selectors(review):
        return True
    if _review_kind(review) is _MISSING:
        # both remaining clauses hoist input.review.kind into is_ns
        return False
    if is_ns(review):
        return any_labelselector_match(
            get_default(match, "namespaceSelector", {}), review
        )
    selector = get_default(match, "namespaceSelector", {})
    for ns in get_ns_candidates(review, ns_cache):
        metadata = get_default(ns, "metadata", {})
        nslabels = get_default(metadata, "labels", {})
        if matches_label_selector(selector, nslabels):
            return True
    return False


def _has_field(obj: Any, field: str) -> bool:
    """has_field (:92-105): any present key counts — false via the explicit
    `object[field] == false` clause, null because null is truthy in Rego."""
    return isinstance(obj, dict) and field in obj


def matches_constraint(
    constraint: Dict[str, Any], review: Any, ns_cache: Dict[str, Any]
) -> bool:
    """matching_constraints body (:27-44) for a single constraint."""
    return matches_match(constraint_match(constraint), review, ns_cache)


def matches_match(
    match: Any, review: Any, ns_cache: Dict[str, Any]
) -> bool:
    """matches_constraint over a pre-extracted match block — the entry
    point target handlers use after translating their own match schema
    into this module's field vocabulary (docs/targets.md)."""
    if not any_kind_selector_matches(match, review):
        return False
    if not matches_namespaces(match, review):
        return False
    if not does_not_match_excludednamespaces(match, review):
        return False
    if not matches_nsselector(match, review, ns_cache):
        return False
    if not matches_scope(match, review):
        return False
    label_selector = get_default(match, "labelSelector", {})
    return any_labelselector_match(label_selector, review)


def matching_constraints(
    constraints: Iterable[Dict[str, Any]],
    review: Any,
    ns_cache: Dict[str, Any],
) -> List[Dict[str, Any]]:
    return [c for c in constraints if matches_constraint(c, review, ns_cache)]


# -- autoreject -------------------------------------------------------------


def needs_ns_selector(constraint: Dict[str, Any]) -> bool:
    """The ONLY constraint-dependent clause of autoreject_review: the
    constraint declares a namespaceSelector. Exported separately so
    batched callers can factor autoreject as
    `needs_ns_selector(c) AND review_autorejects(r)` in O(R + C); any
    future per-constraint condition MUST be added here (and the batched
    device path in tpudriver._query_many_device revisited), never
    inlined into autoreject alone."""
    return match_needs_ns_selector(constraint_match(constraint))


def match_needs_ns_selector(match: Any) -> bool:
    """needs_ns_selector over a pre-extracted (translated) match block."""
    return _has_field(match, "namespaceSelector")


def autoreject(
    constraint: Dict[str, Any], review: Any, ns_cache: Dict[str, Any]
) -> bool:
    """autoreject_review (:12-25) for a single constraint.

    Fires when the constraint needs a namespaceSelector but the review's
    namespace is neither attached (`_unstable.namespace`) nor cached, and the
    namespace field is present and not the empty string. Presence is
    required because OPA hoists `input.review.namespace` out of the negated
    cache lookup (`not DataRoot...Namespace[input.review.namespace]`), so an
    absent field fails the whole rule — cluster-scoped reviews never
    autoreject.

    Factored as needs_ns_selector(constraint) AND
    review_autorejects(review, ns_cache).
    """
    return needs_ns_selector(constraint) and review_autorejects(
        review, ns_cache
    )


def review_autorejects(review: Any, ns_cache: Dict[str, Any]) -> bool:
    """The review-side (constraint-independent) half of autoreject."""
    ns_name = _review_namespace(review)
    if ns_name is _MISSING:
        return False
    # not DataRoot.cluster.v1.Namespace[input.review.namespace]
    if (
        isinstance(ns_name, str)
        and isinstance(ns_cache, dict)
        and ns_name in ns_cache
    ):
        return False
    # not input.review._unstable.namespace — succeeds only when the path is
    # absent or the value is false (null/0/"" are truthy in Rego)
    if isinstance(review, dict):
        unstable = review.get("_unstable")
        if isinstance(unstable, dict):
            val = unstable.get("namespace", _MISSING)
            if val is not _MISSING and val is not False:
                return False
    # not input.review.namespace == ""  (undefined namespace -> succeeds)
    if ns_name == "":
        return False
    return True


# -- audit cross-join -------------------------------------------------------


def make_group_version(api_version: str) -> Optional[Tuple[str, str]]:
    """make_group_version (:74-83). Data keys hold *unescaped*
    groupVersions (storage.ParsePathEscaped unescapes what
    target.go:73's url.PathEscape encoded), so "apps/v1" splits into
    ("apps", "v1"). The Rego `[group, version] := split(...)` destructure
    is undefined for 2+ slashes — mirrored as None (object skipped)."""
    if "/" in api_version:
        parts = api_version.split("/")
        if len(parts) != 2:
            return None
        return parts[0], parts[1]
    return "", api_version


def make_review(
    obj: Any, api_version: str, kind: str, name: str, namespace: Optional[str] = None
) -> Optional[Dict[str, Any]]:
    """make_review (:61-68) + add_field namespace for namespaced objects."""
    gv = make_group_version(api_version)
    if gv is None:
        return None
    group, version = gv
    review: Dict[str, Any] = {
        "kind": {"group": group, "version": version, "kind": kind},
        "name": name,
        "object": obj,
    }
    if namespace is not None:
        review["namespace"] = namespace
    return review


def iter_cached_reviews(external: Any):
    """matching_reviews_and_constraints data walk (:47-59): yields a review
    per cached object, namespaced tree first, then cluster tree."""
    if not isinstance(external, dict):
        return
    namespaces = external.get("namespace")
    if isinstance(namespaces, dict):
        for ns_name, by_gv in sorted(namespaces.items()):
            if not isinstance(by_gv, dict):
                continue
            for gv, by_kind in sorted(by_gv.items()):
                if not isinstance(by_kind, dict):
                    continue
                for kind, by_name in sorted(by_kind.items()):
                    if not isinstance(by_name, dict):
                        continue
                    for name, obj in sorted(by_name.items()):
                        r = make_review(obj, gv, kind, name, namespace=ns_name)
                        if r is not None:
                            yield r
    cluster = external.get("cluster")
    if isinstance(cluster, dict):
        for gv, by_kind in sorted(cluster.items()):
            if not isinstance(by_kind, dict):
                continue
            for kind, by_name in sorted(by_kind.items()):
                if not isinstance(by_name, dict):
                    continue
                for name, obj in sorted(by_name.items()):
                    r = make_review(obj, gv, kind, name)
                    if r is not None:
                        yield r
