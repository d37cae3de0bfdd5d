# Copied from gatekeeper_tpu/constraint/handler.py; only imports and the edits noted in this header differ.
"""TargetHandler: the target plugin boundary (docs/targets.md).

The reference's client.TargetHandler interface (frameworks/constraint/
pkg/client/client.go + pkg/handler) covers data ingestion, review
normalization, violation post-processing, and the match schema. This
build's fused evaluation engine needs more from a target than the
reference's interpreter did — the match ORACLE, the match TENSOR
compiler, review feature encoding, audit listing, review construction
for the webhook plane, and exemption hooks — so all of those live here
too, as overridable methods with defaults that delegate to the shared
match-semantics engine (`constraint/match.py`, `engine/matchspec.py`,
`flatten/encoder.py`).

Those engine modules speak one internal review/match vocabulary — the
gkReview dict shape and the kinds/namespaces/labelSelector/
namespaceSelector match-block shape. A target whose public schema IS
that vocabulary (K8s) inherits the defaults unchanged; any other target
(agentaction/) translates its schema into the vocabulary via
`match_ir()` + `handle_review()` and gets the whole fused stack —
kernel match, analyzer, symbolic compiler, mutation screens, external
data — for free. Nothing outside this boundary imports the
match-semantics modules directly (enforced by the genericity gate in
tests/test_agentaction.py).
"""

from __future__ import annotations

import re
from abc import ABC, abstractmethod
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from .errors import InvalidConstraintError
from .types import Result


class WipeData:
    """Sentinel: deletes the target's whole data subtree (target.go:37-41)."""


class TargetHandler(ABC):
    """Target plugin: schema translation + data/review normalization."""

    # -- the reference's six-method surface ---------------------------------

    @abstractmethod
    def get_name(self) -> str: ...

    @abstractmethod
    def process_data(self, obj: Any) -> Tuple[bool, str, Any]: ...

    @abstractmethod
    def handle_review(self, obj: Any) -> Tuple[bool, Any]: ...

    @abstractmethod
    def handle_violation(self, result: Result) -> None: ...

    @abstractmethod
    def match_schema(self) -> Dict[str, Any]: ...

    @abstractmethod
    def validate_constraint(self, constraint: Dict[str, Any]) -> None: ...

    # -- match semantics (engine-facing) ------------------------------------

    def match_ir(self, constraint: Dict[str, Any]) -> Any:
        """The constraint's match block translated into the engine's
        internal match vocabulary. Identity for targets whose public
        schema is the engine vocabulary."""
        from .hooks import constraint_match

        return constraint_match(constraint)

    def matches_constraint(
        self, constraint: Dict[str, Any], review: Any, ctx_cache: Dict
    ) -> bool:
        """The host match oracle for one (constraint, review) pair."""
        from . import match as M

        return M.matches_match(self.match_ir(constraint), review, ctx_cache)

    def constraint_needs_context(self, constraint: Dict[str, Any]) -> bool:
        """The constraint-side half of the autoreject factoring (see
        match.needs_ns_selector): True when evaluating this constraint
        requires a resolved review context object."""
        from . import match as M

        return M.match_needs_ns_selector(self.match_ir(constraint))

    def review_autorejects(self, review: Any, ctx_cache: Dict) -> bool:
        """The review-side half: the review names a context object that
        is neither attached nor cached."""
        from . import match as M

        return M.review_autorejects(review, ctx_cache)

    def compile_match_specs(
        self, constraints: List[Dict[str, Any]], vocab: Any
    ):
        """Constraint-side match tensors for the fused kernel."""
        from ..engine.matchspec import compile_match_irs

        return compile_match_irs(
            [self.match_ir(c) for c in constraints], vocab
        )

    def encode_review_features(self, review: Any, ctx_cache: Dict, vocab: Any):
        """Review-side match features for the fused kernel."""
        from ..flatten.encoder import encode_review_features

        return encode_review_features(review, ctx_cache, vocab)

    def review_context_cache(
        self, storage_get: Callable[[List[str], Any], Any]
    ) -> Dict[str, Any]:
        """The synced context objects reviews resolve selectors against
        (the K8s Namespace cache). `storage_get(path, default)` reads
        the driver's data tree. Default: no context cache."""
        return {}

    # -- audit listing -------------------------------------------------------

    def iter_cached_reviews(self, external: Any) -> Iterator[Any]:
        """Reviews for every object in this target's synced data
        subtree (the audit cross-join's review stream)."""
        from . import match as M

        return M.iter_cached_reviews(external)

    def wrap_audit_object(self, obj: Any, context: Any = None) -> Any:
        """A listed object + its (optional) context object, in the
        shape handle_review() accepts — the audit manager's review
        construction."""
        return obj

    # -- webhook plane -------------------------------------------------------

    def augment_request(
        self,
        request: Dict[str, Any],
        context_getter: Optional[Callable[[str], Optional[dict]]] = None,
    ) -> Any:
        """An incoming serving-plane request in the shape
        handle_review() accepts, with its context object attached (the
        webhook's review construction). Default: pass through."""
        return request

    def request_exempt(
        self, request: Dict[str, Any], excluder: Any, process: str
    ) -> Optional[str]:
        """Process-exclusion hook: a non-None reason admits the request
        without evaluation (the K8s excluded-namespaces config)."""
        return None

    def sample_requests(self, n: int) -> List[Dict[str, Any]]:
        """Synthetic serving-plane requests for compile warmup (shape
        coverage only; never evaluated against real state)."""
        return []


def handler_for(client: Any, target: str) -> TargetHandler:
    """Resolve `target`'s handler from a Client's registry, tolerating
    registry-less test fakes (K8s default, like the drivers)."""
    registry = getattr(client, "targets", None) or {}
    h = registry.get(target)
    return h if h is not None else default_handler()


def default_handler() -> TargetHandler:
    """The compatibility default for drivers queried about a target
    name no handler was registered for: the K8s target (every pre-
    multi-target call site assumed it)."""
    from .target import K8sValidationTarget

    return K8sValidationTarget()


# -- shared selector validation ---------------------------------------------

_LABEL_VALUE_RE = re.compile(r"^(([A-Za-z0-9][-A-Za-z0-9_.]*)?[A-Za-z0-9])?$")


def label_selector_schema() -> Dict[str, Any]:
    """The matchExpressions/matchLabels selector schema fragment shared
    by every target's match_schema()."""
    string_list = {"type": "array", "items": {"type": "string"}}
    return {
        "type": "object",
        "properties": {
            "matchExpressions": {
                "type": "array",
                "items": {
                    "type": "object",
                    "properties": {
                        "key": {"type": "string"},
                        "operator": {
                            "type": "string",
                            "enum": ["In", "NotIn", "Exists", "DoesNotExist"],
                        },
                        "values": string_list,
                    },
                },
            }
        },
    }


def validate_label_selector(selector: Dict[str, Any], path: str) -> None:
    """Mirrors metav1 validation.ValidateLabelSelector: operator-specific
    values rules and label-value syntax for In/NotIn values."""
    exprs = selector.get("matchExpressions")
    if not isinstance(exprs, list):
        return
    for i, expr in enumerate(exprs):
        if not isinstance(expr, dict):
            raise InvalidConstraintError(
                f"{path}.matchExpressions[{i}]: must be an object"
            )
        op = expr.get("operator")
        values = expr.get("values") or []
        if op in ("In", "NotIn"):
            if not values:
                raise InvalidConstraintError(
                    f"{path}.matchExpressions[{i}].values: must be specified "
                    f"when `operator` is 'In' or 'NotIn'"
                )
        elif op in ("Exists", "DoesNotExist"):
            if values:
                raise InvalidConstraintError(
                    f"{path}.matchExpressions[{i}].values: may not be "
                    f"specified when `operator` is 'Exists' or 'DoesNotExist'"
                )
        else:
            raise InvalidConstraintError(
                f"{path}.matchExpressions[{i}].operator: not a valid selector "
                f"operator: {op!r}"
            )
        for v in values:
            if not isinstance(v, str) or len(v) > 63 or not _LABEL_VALUE_RE.match(v):
                raise InvalidConstraintError(
                    f"{path}.matchExpressions[{i}].values: invalid label "
                    f"value: {v!r}"
                )
