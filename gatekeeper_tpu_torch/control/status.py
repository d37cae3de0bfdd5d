# Copied from gatekeeper_tpu/control/status.py; unchanged.
"""Per-pod status publication + aggregation.

Mirrors the reference's status plane: each pod writes
`ConstraintTemplatePodStatus` / `ConstraintPodStatus` CRs keyed by
(pod, object) labels (apis/status/v1beta1/constrainttemplatepodstatus_types.go:34-57,
constraintpodstatus_types.go:39-77), and the status controllers
aggregate all pods' statuses into the parent object's `status.byPod`
(pkg/controller/constrainttemplatestatus/, constraintstatus/), gated by
operations.Status.

`StatusWriter` is the publication side (what the CT/constraint
controllers call); `StatusAggregator` is the aggregation controller fed
by watch events on the status GVKs.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

from .events import DELETED, Event, GVK

STATUS_GROUP = "status.gatekeeper.sh"
TEMPLATE_STATUS_GVK = GVK(STATUS_GROUP, "v1beta1", "ConstraintTemplatePodStatus")
CONSTRAINT_STATUS_GVK = GVK(STATUS_GROUP, "v1beta1", "ConstraintPodStatus")
MUTATOR_STATUS_GVK = GVK(STATUS_GROUP, "v1beta1", "MutatorPodStatus")
PROVIDER_STATUS_GVK = GVK(STATUS_GROUP, "v1beta1", "ProviderPodStatus")
STATUS_NAMESPACE = "gatekeeper-system"

# label keys (apis/status/v1beta1: ConstraintTemplateNameLabel etc.)
POD_LABEL = "internal.gatekeeper.sh/pod"
TEMPLATE_LABEL = "internal.gatekeeper.sh/constrainttemplate-name"
CONSTRAINT_KIND_LABEL = "internal.gatekeeper.sh/constraint-kind"
CONSTRAINT_NAME_LABEL = "internal.gatekeeper.sh/constraint-name"
MUTATOR_KIND_LABEL = "internal.gatekeeper.sh/mutator-kind"
MUTATOR_NAME_LABEL = "internal.gatekeeper.sh/mutator-name"
PROVIDER_NAME_LABEL = "internal.gatekeeper.sh/provider-name"


def _dashify(s: str) -> str:
    return s.lower().replace("/", "-")


class StatusWriter:
    """Publishes this pod's per-object status CRs into the cluster
    (the reference's PodStatus create/update in
    constrainttemplate_controller.go:306-313,525-551)."""

    def __init__(self, cluster, pod_name: str = "gatekeeper-pod"):
        self.cluster = cluster
        self.pod_name = pod_name

    def _apply(self, gvk: GVK, name: str, labels: Dict[str, str],
               status: Dict[str, Any]) -> None:
        self.cluster.apply(
            {
                "apiVersion": gvk.api_version,
                "kind": gvk.kind,
                "metadata": {
                    "name": name,
                    "namespace": STATUS_NAMESPACE,
                    "labels": labels,
                },
                "status": status,
            }
        )

    # -- templates -----------------------------------------------------------

    def _template_status_name(self, template: str) -> str:
        return f"{_dashify(self.pod_name)}-{_dashify(template)}"

    def publish_template(
        self,
        template: str,
        status: str,
        error: Optional[str],
        report: Optional[Any] = None,
    ) -> None:
        """`report`: the template's VectorizabilityReport — the verdict
        and diagnostic codes ride on the status CR so operators see
        which engine a template runs on (and why) without log-diving."""
        errors: List[Dict[str, str]] = []
        if error:
            errors.append({"code": "ingest_error", "message": error})
        payload: Dict[str, Any] = {
            "id": self.pod_name,
            "templateUID": template,
            "observedGeneration": 1,
            "errors": errors,
        }
        if report is not None:
            payload["vectorization"] = {
                "verdict": report.verdict,
                "codes": report.codes,
            }
        self._apply(
            TEMPLATE_STATUS_GVK,
            self._template_status_name(template),
            {POD_LABEL: self.pod_name, TEMPLATE_LABEL: template},
            payload,
        )

    def delete_template(self, template: str) -> None:
        self.cluster.delete(
            TEMPLATE_STATUS_GVK,
            STATUS_NAMESPACE,
            self._template_status_name(template),
        )

    # -- constraints ---------------------------------------------------------

    def _constraint_status_name(self, kind: str, name: str) -> str:
        return (
            f"{_dashify(self.pod_name)}-{_dashify(kind)}-{_dashify(name)}"
        )

    def publish_constraint(
        self,
        kind: str,
        name: str,
        status: str,
        enforcement_action: str,
        error: Optional[str],
    ) -> None:
        errors: List[Dict[str, str]] = []
        if error:
            errors.append({"code": "ingest_error", "message": error})
        self._apply(
            CONSTRAINT_STATUS_GVK,
            self._constraint_status_name(kind, name),
            {
                POD_LABEL: self.pod_name,
                CONSTRAINT_KIND_LABEL: kind,
                CONSTRAINT_NAME_LABEL: name,
            },
            {
                "id": self.pod_name,
                "constraintUID": f"{kind}/{name}",
                "enforced": status == "active",
                "errors": errors,
            },
        )

    def delete_constraint(self, kind: str, name: str) -> None:
        self.cluster.delete(
            CONSTRAINT_STATUS_GVK,
            STATUS_NAMESPACE,
            self._constraint_status_name(kind, name),
        )

    # -- mutators ------------------------------------------------------------

    def _mutator_status_name(self, kind: str, name: str) -> str:
        return (
            f"{_dashify(self.pod_name)}-{_dashify(kind)}-{_dashify(name)}"
        )

    def publish_mutator(
        self,
        kind: str,
        name: str,
        status: str,
        error: Optional[str],
    ) -> None:
        """MutatorPodStatus: ingestion outcome per (pod, mutator) —
        parse/spec errors AND schema conflicts ride `errors` so
        operators see why a mutator is quarantined without log-diving
        (mutatorpodstatus_types.go in the reference)."""
        errors: List[Dict[str, str]] = []
        if error:
            code = (
                "schema_conflict"
                if "schema conflict" in error
                else "ingest_error"
            )
            errors.append({"code": code, "message": error})
        self._apply(
            MUTATOR_STATUS_GVK,
            self._mutator_status_name(kind, name),
            {
                POD_LABEL: self.pod_name,
                MUTATOR_KIND_LABEL: kind,
                MUTATOR_NAME_LABEL: name,
            },
            {
                "id": self.pod_name,
                "mutatorUID": f"{kind}/{name}",
                "enforced": status == "active",
                "errors": errors,
            },
        )

    def delete_mutator(self, kind: str, name: str) -> None:
        self.cluster.delete(
            MUTATOR_STATUS_GVK,
            STATUS_NAMESPACE,
            self._mutator_status_name(kind, name),
        )

    # -- external-data providers ----------------------------------------------

    def _provider_status_name(self, name: str) -> str:
        return f"{_dashify(self.pod_name)}-provider-{_dashify(name)}"

    def publish_provider(
        self,
        name: str,
        status: str,
        error: Optional[str],
        failure_policy: Optional[str] = None,
    ) -> None:
        """ProviderPodStatus: ingestion outcome per (pod, provider) —
        spec errors ride `errors`, and the effective failurePolicy is
        echoed so operators can audit the fail-open/fail-closed posture
        per pod without reading the Provider spec."""
        errors: List[Dict[str, str]] = []
        if error:
            errors.append({"code": "ingest_error", "message": error})
        payload: Dict[str, Any] = {
            "id": self.pod_name,
            "providerUID": name,
            "active": status == "active",
            "errors": errors,
        }
        if failure_policy is not None:
            payload["failurePolicy"] = failure_policy
        self._apply(
            PROVIDER_STATUS_GVK,
            self._provider_status_name(name),
            {POD_LABEL: self.pod_name, PROVIDER_NAME_LABEL: name},
            payload,
        )

    def delete_provider(self, name: str) -> None:
        self.cluster.delete(
            PROVIDER_STATUS_GVK,
            STATUS_NAMESPACE,
            self._provider_status_name(name),
        )


class StatusAggregator:
    """Aggregates pod status CRs into parent `status.byPod` lists —
    the status controllers' reconcile, driven by watch events on the
    status GVKs (constraintstatus_controller.go,
    constrainttemplatestatus_controller.go)."""

    def __init__(self):
        self._lock = threading.Lock()
        # parent key -> {pod -> status dict}
        self._templates: Dict[str, Dict[str, dict]] = {}
        self._constraints: Dict[str, Dict[str, dict]] = {}

    def sink(self, ev: Event) -> None:
        labels = (ev.obj.get("metadata") or {}).get("labels") or {}
        pod = labels.get(POD_LABEL, "")
        status = ev.obj.get("status") or {}
        with self._lock:
            if ev.gvk == TEMPLATE_STATUS_GVK:
                parent = labels.get(TEMPLATE_LABEL, "")
                store = self._templates.setdefault(parent, {})
            elif ev.gvk == CONSTRAINT_STATUS_GVK:
                parent = (
                    f"{labels.get(CONSTRAINT_KIND_LABEL, '')}/"
                    f"{labels.get(CONSTRAINT_NAME_LABEL, '')}"
                )
                store = self._constraints.setdefault(parent, {})
            else:
                return
            if ev.type == DELETED:
                store.pop(pod, None)
            else:
                store[pod] = status

    def template_by_pod(self, template: str) -> List[dict]:
        with self._lock:
            return [
                dict(v)
                for _, v in sorted(
                    self._templates.get(template, {}).items()
                )
            ]

    def constraint_by_pod(self, kind: str, name: str) -> List[dict]:
        with self._lock:
            return [
                dict(v)
                for _, v in sorted(
                    self._constraints.get(f"{kind}/{name}", {}).items()
                )
            ]
