# Copied from gatekeeper_tpu/webhook/namespacelabel.py; no line below differs.
"""Namespace-label guard webhook.

Mirrors pkg/webhook/namespacelabel.go: rejects adding the
`admission.gatekeeper.sh/ignore` label to a Namespace unless the
namespace is in the exempt set (--exempt-namespace flag,
namespacelabel.go:25-28,69-90).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Set

from .policy import AdmissionResponse

IGNORE_LABEL = "admission.gatekeeper.sh/ignore"


class NamespaceLabelHandler:
    def __init__(self, exempt_namespaces: Optional[Iterable[str]] = None):
        self.exempt: Set[str] = set(exempt_namespaces or [])

    def handle(self, request: Dict[str, Any]) -> AdmissionResponse:
        kind = request.get("kind") or {}
        if kind.get("kind") != "Namespace" or kind.get("group"):
            return AdmissionResponse(True, "")
        obj = request.get("object") or {}
        labels = ((obj.get("metadata") or {}).get("labels")) or {}
        if IGNORE_LABEL not in labels:
            return AdmissionResponse(True, "")
        name = (obj.get("metadata") or {}).get("name") or request.get(
            "name", ""
        )
        if name in self.exempt:
            return AdmissionResponse(True, "")
        return AdmissionResponse(
            False,
            f"only exempt namespaces can have the {IGNORE_LABEL} label",
            code=403,
        )
