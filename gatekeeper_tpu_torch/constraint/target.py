# Copied from gatekeeper_tpu/constraint/target.py; only imports and the edits noted in this header differ.
# Edit: source paths in comments point into the upstream Gatekeeper repo (gatekeeper/...).
"""K8sValidationTarget: the Kubernetes-specific data model plugin.

TPU-native equivalent of gatekeeper/pkg/target/target.go:23-354. The
target handler owns: routing synced cluster objects into the driver's data
tree, normalizing the three review input shapes into a gkReview, extracting
the violating resource from results, and the constraint `spec.match` schema.

The Rego matching library the reference pairs with this handler
(target_template_source.go) lives natively in match.py instead.
"""

from __future__ import annotations

import json
import urllib.parse
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from .handler import (
    TargetHandler,
    WipeData,  # noqa: F401  (historic home; re-exported for importers)
    label_selector_schema,
    validate_label_selector,
)
from .types import Result


@dataclass
class AdmissionRequest:
    """A typed wrapper marking a dict as an AdmissionRequest review."""

    request: Dict[str, Any]


@dataclass
class AugmentedReview:
    """AdmissionRequest + its (optional) Namespace object (target.go:43-46)."""

    admission_request: Dict[str, Any]
    namespace: Optional[Dict[str, Any]] = None


@dataclass
class AugmentedUnstructured:
    """A cluster object + its Namespace, used by audit (target.go:53-56)."""

    object: Dict[str, Any]
    namespace: Optional[Dict[str, Any]] = None


def _gvk_of(obj: Dict[str, Any]) -> Tuple[str, str, str]:
    api_version = obj.get("apiVersion", "") or ""
    kind = obj.get("kind", "") or ""
    if "/" in api_version:
        group, version = api_version.split("/", 1)
    else:
        group, version = "", api_version
    return group, version, kind


def _meta(obj: Dict[str, Any], key: str) -> str:
    metadata = obj.get("metadata")
    if isinstance(metadata, dict):
        val = metadata.get(key)
        if isinstance(val, str):
            return val
    return ""


def _unstructured_to_admission_request(obj: Dict[str, Any]) -> Dict[str, Any]:
    """unstructuredToAdmissionRequest (target.go:144-163): kind + object +
    name only — namespace deliberately NOT set."""
    group, version, kind = _gvk_of(obj)
    return {
        "kind": {"group": group, "version": version, "kind": kind},
        "object": obj,
        "name": _meta(obj, "name"),
    }


class K8sValidationTarget(TargetHandler):
    """TargetHandler implementation for Kubernetes admission data.

    The engine's internal match/review vocabulary IS this target's
    public schema, so every engine-facing TargetHandler default
    (match_ir / matches_constraint / compile_match_specs / feature
    encoding / audit listing) applies unchanged; only the K8s-specific
    pieces — the Namespace context cache, AdmissionReview construction,
    namespace exclusion, and warmup shapes — are overridden below."""

    def get_name(self) -> str:
        return "admission.k8s.gatekeeper.sh"

    # -- data ingestion (target.go:62-89) ----------------------------------

    def process_data(self, obj: Any) -> Tuple[bool, str, Any]:
        """Returns (handled, relative path, processed data).

        Paths: cluster/<escaped groupVersion>/<kind>/<name> or
        namespace/<ns>/<escaped groupVersion>/<kind>/<name>; the
        groupVersion is url-path-escaped exactly as the reference does
        (target.go:73-75), so "apps/v1" becomes "apps%2Fv1".
        """
        if isinstance(obj, WipeData) or obj is WipeData:
            return True, "", None
        if not isinstance(obj, dict):
            return False, "", None
        group, version, kind = _gvk_of(obj)
        name = _meta(obj, "name")
        if version == "":
            raise ValueError(f"resource {name} has no version")
        if kind == "":
            raise ValueError(f"resource {name} has no kind")
        gv = f"{group}/{version}" if group else version
        # Go url.PathEscape (encodePathSegment): '$&+:=@' and unreserved
        # stay raw; '/;,?' and the RFC sub-delims !*'() are escaped
        gv = urllib.parse.quote(gv, safe="$&+:=@")
        namespace = _meta(obj, "namespace")
        if namespace == "":
            return True, f"cluster/{gv}/{kind}/{name}", obj
        return True, f"namespace/{namespace}/{gv}/{kind}/{name}", obj

    # -- review normalization (target.go:91-142) ---------------------------

    def handle_review(self, obj: Any) -> Tuple[bool, Any]:
        """Normalizes review inputs into the gkReview dict shape."""
        if isinstance(obj, AdmissionRequest):
            return True, obj.request
        if isinstance(obj, AugmentedReview):
            review = dict(obj.admission_request)
            review["_unstable"] = (
                {"namespace": obj.namespace} if obj.namespace is not None else {}
            )
            return True, review
        if isinstance(obj, AugmentedUnstructured):
            review = _unstructured_to_admission_request(obj.object)
            review["_unstable"] = (
                {"namespace": obj.namespace} if obj.namespace is not None else {}
            )
            if obj.namespace is not None:
                review["namespace"] = _meta(obj.namespace, "name")
            return True, review
        if isinstance(obj, dict):
            # raw dicts are treated as unstructured cluster objects, matching
            # the reference's unstructured.Unstructured case (target.go:113)
            return True, _unstructured_to_admission_request(obj)
        return False, None

    # -- violation post-processing (target.go:193-244) ---------------------

    def handle_violation(self, result: Result) -> None:
        review = result.review
        if not isinstance(review, dict):
            raise ValueError(f"could not cast review as map: {review!r}")
        kind_info = review.get("kind")
        if not isinstance(kind_info, dict):
            raise ValueError("review[kind] does not exist")
        fields = {}
        for k in ("group", "version", "kind"):
            v = kind_info.get(k)
            if not isinstance(v, str):
                raise ValueError(f"review[kind][{k}] is not a string: {v!r}")
            fields[k] = v
        api_version = (
            fields["version"]
            if fields["group"] == ""
            else f"{fields['group']}/{fields['version']}"
        )
        obj = review.get("object")
        if not isinstance(obj, dict):
            obj = review.get("oldObject")
        if not isinstance(obj, dict):
            raise ValueError("no object or oldObject returned in review")
        resource = json.loads(json.dumps(obj))
        resource["apiVersion"] = api_version
        resource["kind"] = fields["kind"]
        result.resource = resource

    # -- constraint spec.match schema (target.go:246-318) ------------------

    def match_schema(self) -> Dict[str, Any]:
        string_list = {"type": "array", "items": {"type": "string"}}
        label_selector = label_selector_schema()
        return {
            "type": "object",
            "properties": {
                "kinds": {
                    "type": "array",
                    "items": {
                        "type": "object",
                        "properties": {
                            "apiGroups": string_list,
                            "kinds": string_list,
                        },
                    },
                },
                "namespaces": string_list,
                "excludedNamespaces": string_list,
                "labelSelector": label_selector,
                "namespaceSelector": label_selector,
                "scope": {
                    "type": "string",
                    "enum": ["*", "Cluster", "Namespaced"],
                },
            },
        }

    # -- constraint validation (target.go:320-354) -------------------------

    def validate_constraint(self, constraint: Dict[str, Any]) -> None:
        spec = constraint.get("spec")
        match = spec.get("match") if isinstance(spec, dict) else None
        if not isinstance(match, dict):
            return
        for sel_field in ("labelSelector", "namespaceSelector"):
            selector = match.get(sel_field)
            if isinstance(selector, dict):
                validate_label_selector(selector, sel_field)

    # -- engine-facing overrides (docs/targets.md) --------------------------

    def review_context_cache(self, storage_get) -> Dict[str, Any]:
        """The synced Namespace cache — what namespaceSelector and
        autoreject resolve reviews against (target_template_source.go's
        data.external.<t>.cluster.v1.Namespace lookups)."""
        cache = storage_get(
            ["external", self.get_name(), "cluster", "v1", "Namespace"], {}
        )
        return cache if isinstance(cache, dict) else {}

    def augment_request(
        self,
        request: Dict[str, Any],
        context_getter: Optional[Callable[[str], Optional[dict]]] = None,
    ) -> Any:
        """AdmissionRequest -> AugmentedReview with the Namespace object
        attached (pkg/webhook/policy.go:354-369's nsCache.Get)."""
        ns_obj = None
        namespace = request.get("namespace", "")
        if namespace and context_getter is not None:
            ns_obj = context_getter(namespace)
        return AugmentedReview(request, namespace=ns_obj)

    def wrap_audit_object(self, obj: Any, context: Any = None) -> Any:
        return AugmentedUnstructured(obj, context)

    def request_exempt(
        self, request: Dict[str, Any], excluder: Any, process: str
    ) -> Optional[str]:
        namespace = request.get("namespace", "")
        if (
            namespace
            and excluder is not None
            and excluder.is_namespace_excluded(process, namespace)
        ):
            return "Namespace is set to be ignored by Gatekeeper config"
        return None

    def sample_requests(self, n: int) -> List[Dict[str, Any]]:
        """Warmup AdmissionRequests: label counts vary so both
        feature-shape buckets compile."""
        out = []
        for i in range(n):
            obj = _warm_pod(1 + (i % 2) * 7)
            out.append(
                {
                    "uid": f"warmup-{i}",
                    "kind": {
                        "group": "",
                        "version": "v1",
                        "kind": obj.get("kind", "Pod"),
                    },
                    "operation": "CREATE",
                    "name": f"warmup-{i}",
                    "namespace": "default",
                    "userInfo": {"username": "system:warmup"},
                    "object": obj,
                }
            )
        return out


def _warm_pod(n_labels: int) -> Dict[str, Any]:
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {
            "name": "warmup",
            "namespace": "default",
            "labels": {f"k{i}": f"v{i}" for i in range(n_labels)},
        },
        "spec": {
            "containers": [
                {
                    "name": "main",
                    "image": "warmup.invalid/img",
                    "resources": {"limits": {"cpu": "1", "memory": "1Gi"}},
                    "securityContext": {"privileged": False},
                }
            ]
        },
    }
