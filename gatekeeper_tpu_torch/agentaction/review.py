# Copied from gatekeeper_tpu/agentaction/review.py; only this edit differs.
# Edit: the docstring names the port's ladder. The port's MicroBatcher and
# MutateBatcher have no host-interpreter rung: a fused agent batch that
# fails, or that the open breaker turns away, and a mutation screen that
# fails are answered with the endpoint's fail policy (ROADMAP §C).
"""/v1/agent/review: the agent-action serving plane.

`AgentReviewHandler` is the agent counterpart of the K8s
ValidationHandler: it rides the SAME MicroBatcher, so N concurrent
agent tool calls coalesce into ONE fused device dispatch, inherit the
whole degradation envelope (circuit breaker, bounded queue, deadline
shedding), and answer with the endpoint's fail-open/fail-closed
envelope when the fused path did not evaluate them.

Mutation runs before validation (the apiserver's webhook ordering):
when an agent-target MutationSystem is wired, the batch's tool-call
arguments are kernel-screened and rewritten first — one screen
dispatch per micro-batch — and validation sees the MUTATED action.
The response carries the RFC 6902 patch (rooted at the action object,
ops like /spec/arguments/...) alongside allowed/violations.
"""

from __future__ import annotations

import time
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import Any, Dict, List, Optional

from ..faults import AdmissionUnavailable, EvaluationTimeout
from ..webhook.policy import (
    AdmissionResponse,
    note_unavailable_decision,
    unavailable_response,
)
from ..webhook.server import DEFAULT_REQUEST_TIMEOUT
from .target import AgentAction


class AgentReviewHandler:
    """Batched agent-action review over a MicroBatcher bound to the
    agent target (plus an optional MutateBatcher bound to an
    agent-target MutationSystem)."""

    def __init__(
        self,
        batcher,
        mutate_batcher=None,
        metrics=None,
        logger=None,
        tracer=None,
        fail_policy: str = "open",
        request_timeout: float = DEFAULT_REQUEST_TIMEOUT,
        # obs.DecisionLog: agent reviews record tenant = (agent id,
        # session) so per-agent "why was my tool call denied" is
        # answerable at /debug/decisions (docs/observability.md)
        decision_log=None,
    ):
        from ..logs import null_logger

        if fail_policy not in ("open", "closed"):
            raise ValueError(
                f"fail_policy must be 'open' or 'closed', got {fail_policy!r}"
            )
        self.decision_log = decision_log
        self.batcher = batcher
        self.mutate_batcher = mutate_batcher
        self.metrics = metrics
        self.tracer = tracer
        self.log = logger if logger is not None else null_logger()
        self.fail_policy = fail_policy
        self.request_timeout = request_timeout
        # bounded ring (matching ValidationHandler): a sustained-deny
        # agent plane must churn this, never grow it
        from collections import deque

        self.denied_log: Any = deque(maxlen=4096)

    # -- entry ---------------------------------------------------------------

    def handle(
        self, request: Dict[str, Any], trace_id: Optional[str] = None
    ) -> AdmissionResponse:
        from ..obs import start_span

        t0 = time.perf_counter()
        with start_span(
            self.tracer,
            "agent_handler",
            trace_id=trace_id,
            tool=str(request.get("tool", "")),
            agent=str(request.get("agent", "")),
            session=str(request.get("session", "")),
        ) as span:
            # shed/unavailable outcomes override the verdict below — a
            # fail-open shed must NOT be recorded as a healthy allow
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
        duration_s = time.perf_counter() - t0
        if self.metrics is not None:
            self.metrics.record(
                "agent_review_count", 1, admission_status=status
            )
            self.metrics.observe(
                "agent_review_duration_seconds",
                duration_s,
                exemplar=getattr(span, "trace_id", None),
                admission_status=status,
            )
        if self.decision_log is not None:
            verdict = decision.pop("verdict", None) or status
            self.decision_log.record_decision(
                "agent",
                verdict,
                code=resp.code,
                trace_id=getattr(span, "trace_id", None) or trace_id,
                duration_ms=duration_s * 1e3,
                tenant={
                    "agent": str(request.get("agent", "")),
                    "session": str(request.get("session", "")),
                },
                message=resp.message if not resp.allowed else "",
                deadline_slack_ms=(
                    (self.request_timeout - duration_s) * 1e3
                ),
                tool=str(request.get("tool", "")),
                patch_ops=len(resp.patch or []),
                **decision,
            )
        return resp

    def _handle(
        self, request: Dict[str, Any], span=None, decision=None
    ) -> AdmissionResponse:
        if not isinstance(request, dict) or not str(
            request.get("tool") or ""
        ):
            return AdmissionResponse(
                False, "agent action review requires a tool name", code=422
            )
        if not str(request.get("agent") or ""):
            return AdmissionResponse(
                False, "agent action review requires an agent id", code=422
            )
        ctx = getattr(span, "context", None)
        patch: Optional[List[Dict[str, Any]]] = None
        record = dict(request)
        try:
            if self.mutate_batcher is not None:
                patch, record = self._mutate(record, ctx)
            # tenant identity (agent + session) extracted BEFORE
            # enqueue: shed verdicts carry it, and the scheduler's
            # fair-share quotas key on it
            deadline = self.batcher._now() + self.request_timeout
            tenant = {
                "agent": str(request.get("agent", "")),
                "session": str(request.get("session", "")),
            }
            fut = self.batcher.submit(
                record, span_ctx=ctx, deadline=deadline, tenant=tenant
            )
            try:
                results = fut.result(timeout=self.request_timeout)
            except _FutureTimeout:
                raise EvaluationTimeout(
                    f"agent review exceeded {self.request_timeout}s"
                ) from None
        except AdmissionUnavailable as e:
            if decision is not None:
                note_unavailable_decision(decision, e)
            return unavailable_response(
                e, fail_policy=self.fail_policy, metrics=self.metrics,
                log=self.log, span=span, plane="agent",
            )
        except Exception as e:
            return AdmissionResponse(False, str(e), code=500)
        msgs = self._deny_messages(results, request, span)
        if msgs:
            return AdmissionResponse(
                False, "\n".join(msgs), code=403, patch=patch
            )
        return AdmissionResponse(True, "", patch=patch)

    # -- mutation-before-validation ------------------------------------------

    def _mutate(self, record: Dict[str, Any], ctx):
        """Kernel-screened argument rewriting: ONE screen dispatch per
        micro-batch; validation always sees the mutated action."""
        from ..mutation.patch import apply_patch

        handler = self.batcher.target_handler
        review = handler.review_of(record)
        deadline = self.mutate_batcher._now() + self.request_timeout
        fut = self.mutate_batcher.submit(
            review, span_ctx=ctx, deadline=deadline
        )
        try:
            ops = fut.result(timeout=self.request_timeout)
        except _FutureTimeout:
            raise EvaluationTimeout(
                f"agent mutation exceeded {self.request_timeout}s"
            ) from None
        if not ops:
            return None, record
        mutated_obj = apply_patch(review.get("object") or {}, ops)
        spec = (
            mutated_obj.get("spec") if isinstance(mutated_obj, dict) else None
        ) or {}
        out = dict(record)
        if isinstance(spec.get("arguments"), dict):
            out["arguments"] = spec["arguments"]
        if isinstance(spec.get("capabilities"), (list, dict)):
            out["capabilities"] = spec["capabilities"]
        return ops, out

    # -- denial rendering ----------------------------------------------------

    def _deny_messages(
        self, results: List[Any], request: Dict[str, Any], span=None
    ) -> List[str]:
        msgs: List[str] = []
        trace_id = getattr(span, "trace_id", None)
        for r in results:
            cname = ((r.constraint or {}).get("metadata") or {}).get(
                "name", "?"
            )
            if r.enforcement_action in ("deny", "dryrun"):
                self.denied_log.append(
                    {
                        "process": "agent_review",
                        "event_type": "violation",
                        "trace_id": trace_id,
                        "constraint_name": cname,
                        "constraint_action": r.enforcement_action,
                        "agent": str(request.get("agent", "")),
                        "tool": str(request.get("tool", "")),
                        "msg": r.msg,
                    }
                )
            if r.enforcement_action == "deny":
                msgs.append(f"[denied by {cname}] {r.msg}")
        return msgs


def make_agent_plane(
    client,
    window_ms: float = 2.0,
    mutation_system=None,
    metrics=None,
    tracer=None,
    logger=None,
    fail_policy: str = "open",
    request_timeout: float = DEFAULT_REQUEST_TIMEOUT,
    max_queue=None,
    decision_log=None,
    sched_policy: str = "fifo",
    slo=None,
    attributor=None,
):
    """Wire the agent serving plane over an already-registered agent
    target: (review MicroBatcher, optional MutateBatcher,
    AgentReviewHandler). The WebhookServer mounts this at
    /v1/agent/review."""
    from ..webhook.mutate import MutateBatcher
    from ..webhook.server import DEFAULT_MAX_QUEUE, MicroBatcher
    from .target import TARGET_NAME

    batcher = MicroBatcher(
        client,
        TARGET_NAME,
        window_ms=window_ms,
        metrics=metrics,
        tracer=tracer,
        max_queue=max_queue if max_queue is not None else DEFAULT_MAX_QUEUE,
        decisions=decision_log,
        sched_policy=sched_policy,
        slo=slo,
        attributor=attributor,
    )
    mutate_batcher = None
    if mutation_system is not None:
        mutate_batcher = MutateBatcher(
            mutation_system,
            window_ms=window_ms,
            metrics=metrics,
            tracer=tracer,
            max_queue=max_queue if max_queue is not None else DEFAULT_MAX_QUEUE,
            decisions=decision_log,
            sched_policy=sched_policy,
            slo=slo,
            attributor=attributor,
        )
    handler = AgentReviewHandler(
        batcher,
        mutate_batcher=mutate_batcher,
        metrics=metrics,
        tracer=tracer,
        logger=logger,
        fail_policy=fail_policy,
        request_timeout=request_timeout,
        decision_log=decision_log,
    )
    return batcher, mutate_batcher, handler

