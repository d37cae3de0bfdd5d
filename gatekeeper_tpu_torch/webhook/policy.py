# Copied from gatekeeper_tpu/webhook/policy.py; no line below differs.
"""Validating admission handler.

Behavioral mirror of pkg/webhook/policy.go's validationHandler.Handle
(:141-221) and getDenyMessages (:224-282):

  * Gatekeeper's own service account is always allowed (:146-148);
  * DELETE reviews the existing object: oldObject replaces object, and a
    nil oldObject is a 500 (:150-165);
  * Gatekeeper's own CRs are dry-validated inline — ConstraintTemplates
    through CreateCRD, constraints through ValidateConstraint +
    enforcementAction validation (:167-178, :311-351) — user errors are
    422, internal errors 500;
  * namespaces excluded for the webhook process are allowed (:191-195);
  * the Namespace object is fetched and attached to the review
    (:354-369; here from a pluggable getter over the synced cache);
  * only `deny` results deny (403, messages joined with newlines);
    `dryrun` results are logged/counted only (:277-280).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ..constraint.errors import ConstraintFrameworkError
from ..control import PROCESS_WEBHOOK, Excluder
from ..faults import AdmissionUnavailable

SERVICE_ACCOUNT_NAMESPACE = "gatekeeper-system"
SERVICE_ACCOUNT = (
    f"system:serviceaccount:{SERVICE_ACCOUNT_NAMESPACE}:gatekeeper-admin"
)


class TraceConfig:
    """Runtime per-request tracing rules from the Config CRD's
    spec.validation.traces (config_types.go:39-51), consulted per
    request by tracingLevel (policy.go:387-408): a request traces when
    BOTH its user and GVK match a rule; dump: "All" additionally dumps
    the whole engine state. Reconciled live by the config controller."""

    def __init__(self):
        self._lock = threading.Lock()
        self._traces: List[dict] = []

    def replace(self, traces: List[dict]) -> None:
        with self._lock:
            self._traces = [t for t in (traces or []) if isinstance(t, dict)]

    def level(self, request: Dict[str, Any]) -> tuple:
        """-> (trace_enabled, dump)."""
        user = (request.get("userInfo") or {}).get("username", "")
        kind = request.get("kind") or {}
        gvk = (
            kind.get("group", ""),
            kind.get("version", ""),
            kind.get("kind", ""),
        )
        enabled = dump = False
        with self._lock:
            for t in self._traces:
                if t.get("user") != user:
                    continue
                tk = t.get("kind") or {}
                if (
                    tk.get("group", ""),
                    tk.get("version", ""),
                    tk.get("kind", ""),
                ) == gvk:
                    enabled = True
                    if str(t.get("dump", "")).lower() == "all":
                        dump = True
        return enabled, dump


@dataclass
class AdmissionResponse:
    allowed: bool
    message: str = ""
    code: int = 200
    # RFC 6902 ops from the mutation plane; rendered as base64 JSON with
    # patchType: JSONPatch (the apiserver contract). None/[] = no patch.
    patch: Optional[List[Dict[str, Any]]] = None

    def to_dict(self, uid: Optional[str] = None) -> Dict[str, Any]:
        out: Dict[str, Any] = {"allowed": self.allowed}
        if uid is not None:
            out["uid"] = uid
        if self.message or self.code != 200:
            out["status"] = {
                "code": self.code,
                "message": self.message,
            }
        if self.patch:
            import base64
            import json as _json

            out["patchType"] = "JSONPatch"
            out["patch"] = base64.b64encode(
                _json.dumps(self.patch).encode()
            ).decode()
        return out


def unavailable_response(
    e: AdmissionUnavailable,
    fail_policy: str,
    metrics=None,
    log=None,
    span=None,
    plane: str = "validation",
) -> AdmissionResponse:
    """The bottom rung of the degradation ladder, shared by every
    admission plane (validation / mutation): the request was never
    evaluated (shed / expired / every rung down) — answer with the
    endpoint's fail-open/fail-closed envelope instead of a raw 500,
    explicitly and countably. Mirrors what the apiserver's
    failurePolicy would do on a webhook timeout, but within the
    caller's deadline."""
    if metrics is not None:
        metrics.record(
            "webhook_unavailable_responses_total", 1,
            plane=plane, policy=fail_policy, reason=e.reason,
        )
    if span is not None:
        span.set_attr(unavailable_reason=e.reason)
    if log is not None:
        log.error(
            "admission evaluation unavailable",
            process="admission",
            plane=plane,
            reason=e.reason,
            fail_policy=fail_policy,
            err=e,
        )
    if fail_policy == "closed":
        return AdmissionResponse(
            False,
            f"admission evaluation unavailable ({e.reason}): {e}",
            code=503,
        )
    return AdmissionResponse(
        True,
        f"admission evaluation unavailable ({e.reason}); "
        f"failing open: {e}",
    )


# the shed reasons recorded with verdict "shed" (vs "unavailable"):
# queue_full / predictive-miss / tenant-quota sheds and deadline expiry
# all mean "dropped by the admission plane", not "every rung down"
SHED_REASONS = ("queue_full", "deadline", "predicted_miss", "tenant_capped")


def note_unavailable_decision(
    decision: Dict[str, Any], e: AdmissionUnavailable
) -> None:
    """Stamp the typed not-evaluated outcome into a handler's decision
    dict (shared by the validation / mutation / agent planes): the
    verdict, the shed reason, and — for predictive sheds — the negative
    predicted slack and whether the tenant was over its fair share."""
    decision["verdict"] = (
        "shed" if e.reason in SHED_REASONS else "unavailable"
    )
    decision["reason"] = e.reason
    slack = getattr(e, "predicted_slack_ms", None)
    if slack is not None:
        decision["predicted_slack_ms"] = round(slack, 3)
    if getattr(e, "tenant_capped", False):
        decision["tenant_capped"] = True


class ValidationHandler:
    def __init__(
        self,
        client,
        target: str,
        excluder: Optional[Excluder] = None,
        namespace_getter: Optional[Callable[[str], Optional[dict]]] = None,
        log_denies: bool = False,
        metrics=None,
        trace_config: Optional[TraceConfig] = None,
        event_sink: Optional[Callable[[Dict[str, Any]], None]] = None,
        emit_admission_events: bool = False,
        trace_log: Optional[Callable[[str], None]] = None,
        logger=None,
        tracer=None,
        # what a request that could NOT be evaluated (shed under
        # overload, deadline expired, every evaluation rung down) gets:
        # "open" allows (the reference's failurePolicy: Ignore posture —
        # audit is the backstop), "closed" denies with a 503. Evaluation
        # ERRORS (a poisoned request) remain 500s regardless.
        fail_policy: str = "open",
        # obs.DecisionLog: every handled request leaves one "why"
        # record (verdict + violations + dispatch route/rows facts the
        # batcher stashed under the trace id), head+error-sampled and
        # rate-gated (docs/observability.md §Decision log)
        decision_log=None,
    ):
        from ..logs import null_logger

        if fail_policy not in ("open", "closed"):
            raise ValueError(
                f"fail_policy must be 'open' or 'closed', got {fail_policy!r}"
            )
        self.fail_policy = fail_policy
        self.decision_log = decision_log
        self.client = client
        from ..constraint.handler import handler_for

        # the target's handler owns review construction + exemption
        # hooks (docs/targets.md); resolved once — the registry is
        # fixed for the client's lifetime
        self.target_handler = handler_for(client, target)
        # optional obs.Tracer: every handled request becomes a trace
        # (span taxonomy in docs/observability.md); denial log records
        # carry the trace_id for correlation
        self.tracer = tracer
        self.target = target
        self.excluder = excluder
        self.namespace_getter = namespace_getter
        self.log_denies = log_denies
        self.log = logger if logger is not None else null_logger()
        self.metrics = metrics
        self.trace_config = trace_config
        # violation event emission (--emit-admission-events,
        # policy.go:253-273); the sink is the K8s Events stand-in
        self.event_sink = event_sink
        self.emit_admission_events = emit_admission_events
        self.trace_log = trace_log
        # bounded: soak replicas run with log_denies on for the
        # trace-id correlation contract, and a 100%-deny scenario must
        # churn this ring, not grow it for the process lifetime
        from collections import deque

        self.denied_log: Any = deque(maxlen=4096)
        self.traces: List[str] = []  # captured per-request traces

    # -- entry ---------------------------------------------------------------

    def handle(
        self, request: Dict[str, Any], trace_id: Optional[str] = None
    ) -> AdmissionResponse:
        import time as _time

        from ..obs import start_span

        t0 = _time.perf_counter()
        kind = request.get("kind") or {}
        with start_span(
            self.tracer,
            "handler",
            # an ingested W3C traceparent (or UID-derived id) becomes
            # THE trace id for this request's whole span tree — the
            # envelope, denial log, and /debug/traces all share it
            trace_id=trace_id,
            resource_kind=kind.get("kind", ""),
            resource_namespace=request.get("namespace", ""),
            resource_name=request.get("name", ""),
            operation=request.get("operation", ""),
            username=(request.get("userInfo") or {}).get("username", ""),
        ) as span:
            decision: Dict[str, Any] = {}
            resp = self._handle(request, span, decision)
            span.set_attr(
                admission_status=(
                    "allow" if resp.allowed
                    else ("error" if resp.code >= 500 else "deny")
                ),
                code=resp.code,
            )
        status = (
            "allow" if resp.allowed
            else ("error" if resp.code >= 500 else "deny")
        )
        duration_s = _time.perf_counter() - t0
        if self.metrics is not None:
            # the webhook stats reporter's surface (request_count +
            # request_duration_seconds tagged by admission_status,
            # pkg/webhook/stats_reporter.go:34-79); the sample carries
            # the request's trace id as an OpenMetrics exemplar so a
            # p99 bucket names a concrete trace to open
            self.metrics.record("request_count", 1, admission_status=status)
            self.metrics.observe(
                "request_duration_seconds",
                duration_s,
                exemplar=getattr(span, "trace_id", None),
                admission_status=status,
            )
        self._record_decision(
            request, resp, status, duration_s,
            getattr(span, "trace_id", None) or trace_id, decision,
        )
        return resp

    def _record_decision(
        self,
        request: Dict[str, Any],
        resp: "AdmissionResponse",
        status: str,
        duration_s: float,
        trace_id: Optional[str],
        decision: Dict[str, Any],
        plane: str = "validation",
    ) -> None:
        """One per-admission "why" record: verdict + violations +
        whatever dispatch facts the batch worker stashed under the
        trace id (route, partitions dispatched vs mask-skipped,
        rows_dispatched/rows_total, fetch/cache counts). A shed or
        unevaluable request records its typed reason as the verdict so
        overload is first-class in the decision stream."""
        if self.decision_log is None:
            return
        verdict = decision.pop("verdict", None) or status
        timeout = getattr(self, "request_timeout", None)
        slack_ms = (
            (timeout - duration_s) * 1e3 if timeout is not None else None
        )
        self.decision_log.record_decision(
            plane,
            verdict,
            code=resp.code,
            trace_id=trace_id,
            duration_ms=duration_s * 1e3,
            tenant={
                "namespace": request.get("namespace", ""),
                "username": (request.get("userInfo") or {}).get(
                    "username", ""
                ),
            },
            violations=decision.pop("violations", []),
            message=resp.message if not resp.allowed else "",
            deadline_slack_ms=slack_ms,
            operation=request.get("operation", ""),
            resource={
                "kind": (request.get("kind") or {}).get("kind", ""),
                "name": request.get("name", ""),
            },
            **decision,
        )

    def _handle(
        self, request: Dict[str, Any], span=None, decision=None
    ) -> AdmissionResponse:
        from ..obs import NOOP_SPAN

        if span is None:
            span = NOOP_SPAN
        if decision is None:
            decision = {}
        user = (request.get("userInfo") or {}).get("username", "")
        if user == SERVICE_ACCOUNT:
            decision["reason"] = "service_account"
            return AdmissionResponse(True, "Gatekeeper does not self-manage")

        request = dict(request)
        if request.get("operation") == "DELETE":
            if request.get("oldObject") is None:
                return AdmissionResponse(
                    False,
                    "For admission webhooks registered for DELETE operations, "
                    "please use Kubernetes v1.15.0+.",
                    code=500,
                )
            request["object"] = request.get("oldObject")

        user_err, err = self._validate_gatekeeper_resources(request)
        if err is not None:
            return AdmissionResponse(
                False, str(err), code=422 if user_err else 500
            )

        exempt_reason = self.target_handler.request_exempt(
            request, self.excluder, PROCESS_WEBHOOK
        )
        if exempt_reason is not None:
            decision["reason"] = "exempt"
            return AdmissionResponse(True, exempt_reason)

        trace_enabled = dump = False
        if self.trace_config is not None:
            trace_enabled, dump = self.trace_config.level(request)
        try:
            results = self._review(request, tracing=trace_enabled, span=span)
        except AdmissionUnavailable as e:
            # the typed not-evaluated verdicts (shed / deadline /
            # degraded / timeout) are first-class in the decision
            # stream — an overload story must be reconstructible from
            # the records alone
            note_unavailable_decision(decision, e)
            return self._unavailable_response(e, span)
        except Exception as e:
            return AdmissionResponse(False, str(e), code=500)
        if dump:
            self._emit_trace(self.client.dump())

        msgs = self._deny_messages(
            results, request, trace_id=span.trace_id, decision=decision
        )
        if msgs:
            return AdmissionResponse(False, "\n".join(msgs), code=403)
        return AdmissionResponse(True, "")

    def _unavailable_response(
        self, e: AdmissionUnavailable, span=None, plane: str = "validation"
    ) -> AdmissionResponse:
        return unavailable_response(
            e, fail_policy=self.fail_policy, metrics=self.metrics,
            log=self.log, span=span, plane=plane,
        )

    # -- pieces --------------------------------------------------------------

    def _emit_trace(self, text: str) -> None:
        self.traces.append(text)
        if self.trace_log is not None:
            self.trace_log(text)

    def _review(
        self, request: Dict[str, Any], tracing: bool = False, span=None
    ) -> List[Any]:
        from ..obs import start_span

        review = self._augment(request)
        with start_span(self.tracer, "dispatch", parent=span, route="serial"):
            responses = self.client.review(review, tracing=tracing)
        resp = responses.by_target.get(self.target)
        if tracing and resp is not None and resp.trace:
            self._emit_trace(resp.trace)
        return resp.results if resp is not None else []

    def _augment(self, request: Dict[str, Any]):
        return self.target_handler.augment_request(
            request, self.namespace_getter
        )

    def _deny_messages(
        self,
        results: List[Any],
        request: Dict[str, Any],
        trace_id: Optional[str] = None,
        decision: Optional[Dict[str, Any]] = None,
    ) -> List[str]:
        """getDenyMessages (:224-282): deny messages are
        '[denied by <constraint>] <msg>'; dryrun results are recorded
        but never deny. Every denial record carries the request's
        trace_id so /debug/traces explains the latency behind it, and
        the violated constraint set lands in the decision record."""
        log = (
            self.log.with_values(trace_id=trace_id)
            if trace_id is not None
            else self.log
        )
        msgs: List[str] = []
        violations: List[Dict[str, Any]] = []
        for r in results:
            cname = ((r.constraint or {}).get("metadata") or {}).get(
                "name", "?"
            )
            if r.enforcement_action in ("deny", "dryrun"):
                violations.append({
                    "constraint_kind": (r.constraint or {}).get("kind", ""),
                    "constraint_name": cname,
                    "action": r.enforcement_action,
                    "msg": (r.msg or "")[:256],
                })
            if (
                r.enforcement_action in ("deny", "dryrun")
                and self.log_denies
                # shed-burst containment: the decision log's shared
                # token bucket gates sibling denial-log appends too, so
                # a deny storm is bounded across BOTH obs sinks
                and (
                    self.decision_log is None
                    or self.decision_log.allow_denial_append()
                )
            ):
                # --log-denies (policy.go:240-252): one structured
                # record per violation with the reference's key set
                log.info(
                    "denied admission",
                    process="admission",
                    event_type="violation",
                    constraint_name=cname,
                    constraint_kind=(r.constraint or {}).get("kind", ""),
                    constraint_action=r.enforcement_action,
                    resource_kind=(request.get("kind") or {}).get(
                        "kind", ""
                    ),
                    resource_namespace=request.get("namespace", ""),
                    resource_name=request.get("name", ""),
                    request_username=(request.get("userInfo") or {}).get(
                        "username", ""
                    ),
                )
                self.denied_log.append(
                    {
                        "process": "admission",
                        "event_type": "violation",
                        "trace_id": trace_id,
                        "constraint_name": cname,
                        "constraint_action": r.enforcement_action,
                        "resource_namespace": request.get("namespace", ""),
                        "resource_name": request.get("name", ""),
                        "msg": r.msg,
                    }
                )
            if (
                r.enforcement_action in ("deny", "dryrun")
                and self.emit_admission_events
                and self.event_sink is not None
            ):
                dryrun = r.enforcement_action == "dryrun"
                self.event_sink(
                    {
                        "type": "Warning",
                        "reason": (
                            "DryrunViolation" if dryrun else "FailedAdmission"
                        ),
                        "process": "admission",
                        "event_type": "violation",
                        "constraint_name": cname,
                        "constraint_kind": (r.constraint or {}).get(
                            "kind", ""
                        ),
                        "constraint_action": r.enforcement_action,
                        "resource_kind": (request.get("kind") or {}).get(
                            "kind", ""
                        ),
                        "resource_namespace": request.get("namespace", ""),
                        "resource_name": request.get("name", ""),
                        "request_username": (
                            request.get("userInfo") or {}
                        ).get("username", ""),
                        "message": r.msg,
                    }
                )
            if r.enforcement_action == "deny":
                msgs.append(f"[denied by {cname}] {r.msg}")
        if decision is not None and violations:
            decision["violations"] = violations
        return msgs

    def _validate_gatekeeper_resources(self, request: Dict[str, Any]):
        """validateGatekeeperResources (:301-351): dry-validate GK's own
        CRs inline. Returns (user_error, error|None)."""
        kind = request.get("kind") or {}
        group = kind.get("group", "")
        obj = request.get("object")
        if group == "templates.gatekeeper.sh" and kind.get("kind") == (
            "ConstraintTemplate"
        ):
            try:
                self.client.create_crd(obj)
            except ConstraintFrameworkError as e:
                return True, e
            except Exception as e:
                return False, e
            return False, None
        if group == "constraints.gatekeeper.sh":
            try:
                self.client.validate_constraint(obj)
            except ConstraintFrameworkError as e:
                return True, e
            except Exception as e:
                return False, e
            action = ((obj or {}).get("spec") or {}).get("enforcementAction")
            if action is not None and action not in ("deny", "dryrun"):
                return False, ValueError(
                    f"Could not find the provided enforcementAction value "
                    f"within the supported list: {action!r}"
                )
            return False, None
        return False, None
