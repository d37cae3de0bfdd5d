# Copied from gatekeeper_tpu/webhook/mutate.py; only these edits differ.
# Edit: the host-oracle rung is gone. A batch that the open breaker turns
# away, or whose device screen (K1) fails, is not screened again on the
# host (`MutationSystem.screen_host`): each of its requests gets
# EvaluationUnavailable, which MutationHandler answers with the endpoint's
# fail policy, as the port's validation batcher does. The open breaker is
# counted in webhook_degraded_dispatch_total{plane="mutation"}, a failed
# screen in batch_failures and mutation_batch_failures_total. Convergence
# failures are never softened: an object is never admitted unmutated past
# a ConvergenceError.
# Edit: the docstring names the tracing plane's span conventions instead
# of the change that brought them.
"""The `/v1/mutate` serving path: micro-batched, kernel-screened.

`MutateBatcher` rides `MicroBatcher`'s coalescing worker loop (same
window/max_batch/submit semantics as the validation plane) but its
dispatch is the mutation pipeline:

  1. **screen** — ONE `match_matrix` device call (K1) for the whole
     batch decides which mutators apply to which requests (mutator
     Match specs reuse the constraint match encoding end-to-end); a
     batch the device does not screen gets the fail policy;
  2. **apply** — CPU fixpoint application for screened-in pairs only
     (`MutationSystem.apply`; ConvergenceError fails THAT request, the
     object is never admitted non-converged);
  3. **render** — RFC 6902 JSONPatch diff per request.

Each traced request gets queue_wait / screen_dispatch / apply_fixpoint
/ render_patch spans stamped by the batch worker (the tracing plane's span
conventions), and the Prometheus series in docs/metrics.md §Mutation
account the same pipeline.

`MutationHandler` is the policy layer: service-account bypass, excluded
namespaces, operation filtering, metrics, and the AdmissionResponse
with the base64 JSONPatch payload.
"""

from __future__ import annotations

import json
import time
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import Any, Dict, List, Optional, Tuple

from ..faults import (
    AdmissionUnavailable,
    EvaluationTimeout,
    EvaluationUnavailable,
    fire,
)
from ..mutation import ConvergenceError, MutationApplyError, json_patch
from .policy import (
    SERVICE_ACCOUNT,
    AdmissionResponse,
    note_unavailable_decision,
    unavailable_response,
)
from .server import DEFAULT_MAX_QUEUE, DEFAULT_REQUEST_TIMEOUT, MicroBatcher

# mutators act on the incoming object; DELETE carries none
_MUTATE_OPERATIONS = ("CREATE", "UPDATE", "")


class MutateBatcher(MicroBatcher):
    """MicroBatcher whose fused dispatch is screen→apply→render over a
    MutationSystem instead of Client.review_many. Inherits the full
    overload/degradation envelope (bounded queue, deadline shedding,
    device circuit breaker) with the mutate-plane specifics: the
    breaker gates the DEVICE SCREEN, a batch it turns away or whose
    screen fails is answered with the fail policy (no host rung), and
    convergence failures are never softened by the envelope — an
    unconverged object is rejected no matter what state the breaker is
    in."""

    # plane tag on shed/breaker/queue metrics (docs/robustness.md)
    plane = "mutation"

    def __init__(
        self,
        system,
        window_ms: float = 2.0,
        max_batch: int = 256,
        namespace_getter=None,
        metrics=None,
        tracer=None,
        max_queue: Optional[int] = DEFAULT_MAX_QUEUE,
        breaker=None,
        decisions=None,
        sched_policy: str = "fifo",
        slo=None,
        attributor=None,
    ):
        super().__init__(
            client=None,
            target="mutation",
            window_ms=window_ms,
            max_batch=max_batch,
            namespace_getter=namespace_getter,
            metrics=metrics,
            tracer=tracer,
            max_queue=max_queue,
            breaker=breaker,
            decisions=decisions,
            sched_policy=sched_policy,
            slo=slo,
            attributor=attributor,
        )
        self.system = system

    # -- the mutate dispatch -------------------------------------------------

    def _dispatch(self, batch: List[Tuple]):
        batch = self._strip_expired(batch)
        if not batch:
            return
        wall0, t0 = time.time(), time.perf_counter()
        reviews = []
        for request, _, _, _, _, _ in batch:
            review = dict(request)
            ns_obj = None
            namespace = request.get("namespace", "")
            if namespace and self.namespace_getter is not None:
                ns_obj = self.namespace_getter(namespace)
            if ns_obj is not None:
                review["_unstable"] = {"namespace": ns_obj}
            reviews.append(review)

        t_scr = time.perf_counter()
        breaker = self.breaker
        if breaker is not None and not breaker.allow():
            # breaker open: the device screen has been failing — answer
            # with the fail policy, paying zero doomed device attempts
            if self.metrics is not None:
                self.metrics.record(
                    "webhook_degraded_dispatch_total", 1, plane=self.plane
                )
            self._screen_unavailable(batch, wall0, "circuit breaker open")
            return
        try:
            fire("mutate.screen_dispatch")
            muts, matrix = self.system.screen(reviews)
        except Exception as e:
            # a failed device screen is answered with the fail policy
            # (the apiserver would admit unmutated on webhook failure
            # too — here it is explicit and counted). NEVER a
            # half-screened batch, and never a screen elsewhere.
            if breaker is not None:
                breaker.record_failure()
            self.batch_failures += 1
            if self.metrics is not None:
                self.metrics.record("mutation_batch_failures_total", 1)
            self._screen_unavailable(
                batch, wall0, f"mutation screen failed: {e!r}"
            )
            return
        if breaker is not None:
            breaker.record_success()
        screen_s = time.perf_counter() - t_scr

        self.batches_dispatched += 1
        self.requests_batched += len(batch)
        if self.metrics is not None:
            self.metrics.record("mutation_batches_total", 1)
            self.metrics.observe("mutation_screen_batch_size", len(batch))

        wall_scr_end = wall0 + (time.perf_counter() - t0)
        for i, (
            (request, fut, ctx, (sub_wall, _), _dl, _tk), review
        ) in enumerate(zip(batch, reviews)):
            selected = [m for j, m in enumerate(muts) if matrix[j, i]]
            obj = review.get("object")
            apply_s = render_s = 0.0
            iters = 0
            try:
                if not isinstance(obj, dict) or not selected:
                    patch: List[Dict[str, Any]] = []
                else:
                    t_a = time.perf_counter()
                    mutated, iters = self.system.apply(
                        obj, review, selected
                    )
                    apply_s = time.perf_counter() - t_a
                    t_r = time.perf_counter()
                    patch = json_patch(obj, mutated)
                    render_s = time.perf_counter() - t_r
                if self.metrics is not None:
                    if iters:
                        self.metrics.observe(
                            "mutation_fixpoint_iterations", iters
                        )
                    if patch:
                        self.metrics.observe(
                            "mutation_patch_bytes",
                            len(json.dumps(patch)),
                        )
                fut.set_result(patch)
            except (ConvergenceError, MutationApplyError) as e:
                if self.metrics is not None and isinstance(
                    e, ConvergenceError
                ):
                    self.metrics.record("mutation_divergence_total", 1)
                fut.set_exception(e)
            except Exception as e:
                fut.set_exception(e)
            self._record_mutate_spans(
                ctx, sub_wall, wall0, wall_scr_end, screen_s,
                apply_s, render_s, len(batch), len(selected), "batched",
            )
            if self.decisions is not None:
                tid = getattr(ctx, "trace_id", None)
                if tid is not None:
                    # the mutate plane's "why": the device screened the
                    # batch, how many mutators matched, and the
                    # fixpoint iteration count (a 15-iteration record
                    # is one churn away from a divergence 500)
                    self.decisions.note_dispatch(
                        tid,
                        route="fused",
                        mutators_matched=len(selected),
                        fixpoint_iterations=iters,
                        batch_size=len(batch),
                    )
        if muts:
            # mutation-plane pruning series: every screened (mutator ×
            # request) row is dispatched today — the same instrument
            # item 1's pruned dispatch will move for validation
            self._note_rows(
                "mono", len(muts) * len(batch), len(muts) * len(batch)
            )

    def _screen_unavailable(self, batch, wall0: float, why: str) -> None:
        """Every request of a batch the device did not screen gets the
        typed EvaluationUnavailable, which the handler answers with the
        endpoint's fail policy."""
        for _, fut, ctx, (sub_wall, _sp), _, _ in batch:
            fut.set_exception(EvaluationUnavailable(why))
            self._record_mutate_spans(
                ctx, sub_wall, wall0, wall0, 0.0, 0.0, 0.0,
                len(batch), 0, "unavailable",
            )
        self._note_decisions(batch, "unavailable")

    def _record_mutate_spans(
        self, ctx, sub_wall, wall0, wall_scr_end, screen_s,
        apply_s, render_s, batch_size, n_mutators, route,
    ) -> None:
        """Span taxonomy for the mutate plane: queue_wait (submit →
        dispatch), screen_dispatch (the shared kernel screen, recorded
        into every member trace), then per-request apply_fixpoint and
        render_patch laid out sequentially after the screen window."""
        if self.tracer is None or ctx is None:
            return
        self.tracer.record_span("queue_wait", sub_wall, wall0, parent=ctx)
        self.tracer.record_span(
            "screen_dispatch", wall0, wall0 + screen_s, parent=ctx,
            batch_size=batch_size, route=route,
        )
        cursor = wall_scr_end
        self.tracer.record_span(
            "apply_fixpoint", cursor, cursor + apply_s, parent=ctx,
            mutators=n_mutators,
        )
        cursor += apply_s
        self.tracer.record_span(
            "render_patch", cursor, cursor + render_s, parent=ctx
        )


class MutationHandler:
    """Mutating-admission policy layer over the batcher (the mutation
    webhook's counterpart of ValidationHandler)."""

    def __init__(
        self,
        batcher: MutateBatcher,
        excluder=None,
        metrics=None,
        request_timeout: float = DEFAULT_REQUEST_TIMEOUT,
        logger=None,
        tracer=None,
        # same envelope semantics as ValidationHandler: what a request
        # that could NOT be screened/applied (shed, expired, the screen
        # down) gets. Convergence failures stay 500 regardless — an
        # unconverged object is NEVER admitted.
        fail_policy: str = "open",
        # obs.DecisionLog (docs/observability.md §Decision log)
        decision_log=None,
    ):
        from ..logs import null_logger

        if fail_policy not in ("open", "closed"):
            raise ValueError(
                f"fail_policy must be 'open' or 'closed', got {fail_policy!r}"
            )
        self.fail_policy = fail_policy
        self.decision_log = decision_log
        self.batcher = batcher
        self.excluder = excluder
        self.metrics = metrics
        self.request_timeout = request_timeout
        self.log = logger if logger is not None else null_logger()
        self.tracer = tracer

    def handle(
        self, request: Dict[str, Any], trace_id: Optional[str] = None
    ) -> AdmissionResponse:
        from ..obs import start_span

        t0 = time.perf_counter()
        kind = request.get("kind") or {}
        with start_span(
            self.tracer,
            "mutate_handler",
            trace_id=trace_id,
            resource_kind=kind.get("kind", ""),
            resource_namespace=request.get("namespace", ""),
            resource_name=request.get("name", ""),
            operation=request.get("operation", ""),
        ) as span:
            # shed/unavailable outcomes override the verdict below —
            # a fail-open shed must NOT be recorded as a healthy allow
            # (per-tenant shed accounting reads these records)
            decision: Dict[str, Any] = {}
            resp = self._handle(request, span, decision)
            span.set_attr(
                mutation_status=(
                    "error"
                    if not resp.allowed
                    else ("mutated" if resp.patch else "unchanged")
                ),
                code=resp.code,
            )
        status = (
            "error"
            if not resp.allowed
            else ("mutated" if resp.patch else "unchanged")
        )
        duration_s = time.perf_counter() - t0
        if self.metrics is not None:
            self.metrics.record(
                "mutation_request_count", 1, mutation_status=status
            )
            self.metrics.observe(
                "mutation_request_duration_seconds",
                duration_s,
                exemplar=getattr(span, "trace_id", None),
                mutation_status=status,
            )
        if self.decision_log is not None:
            verdict = decision.pop("verdict", None) or (
                "allow" if resp.allowed else "error"
            )
            self.decision_log.record_decision(
                "mutation",
                verdict,
                code=resp.code,
                trace_id=getattr(span, "trace_id", None) or trace_id,
                duration_ms=duration_s * 1e3,
                tenant={
                    "namespace": request.get("namespace", ""),
                    "username": (request.get("userInfo") or {}).get(
                        "username", ""
                    ),
                },
                message=resp.message if not resp.allowed else "",
                deadline_slack_ms=(
                    (self.request_timeout - duration_s) * 1e3
                ),
                mutation_status=status,
                patch_ops=len(resp.patch or []),
                **decision,
            )
        return resp

    def _handle(
        self, request: Dict[str, Any], span=None, decision=None
    ) -> AdmissionResponse:
        from ..control import PROCESS_WEBHOOK

        user = (request.get("userInfo") or {}).get("username", "")
        if user == SERVICE_ACCOUNT:
            return AdmissionResponse(True, "Gatekeeper does not self-manage")
        if request.get("operation", "") not in _MUTATE_OPERATIONS:
            return AdmissionResponse(True, "")
        namespace = request.get("namespace", "")
        if (
            namespace
            and self.excluder is not None
            and self.excluder.is_namespace_excluded(
                PROCESS_WEBHOOK, namespace
            )
        ):
            return AdmissionResponse(
                True, "Namespace is set to be ignored by Gatekeeper config"
            )
        # deadline propagation: the request's remaining budget rides to
        # the batch worker so expiry is checked BEFORE the screen; the
        # tenant identity rides too (extracted BEFORE enqueue so shed
        # accounting and fair-share quotas key on it)
        deadline = self.batcher._now() + self.request_timeout
        fut = self.batcher.submit(
            request, span_ctx=getattr(span, "context", None),
            deadline=deadline,
            tenant={"namespace": namespace, "username": user},
        )
        try:
            try:
                patch = fut.result(timeout=self.request_timeout)
            except _FutureTimeout:
                raise EvaluationTimeout(
                    f"mutation evaluation exceeded {self.request_timeout}s"
                ) from None
        except (ConvergenceError, MutationApplyError) as e:
            # NEVER admit a non-converged / half-mutable object — this
            # stays a hard 500 even under fail-open (the envelope covers
            # requests that were never evaluated, not poisoned ones)
            self.log.error(
                "mutation failed",
                process="mutation",
                err=e,
                resource_name=request.get("name", ""),
                resource_namespace=namespace,
            )
            return AdmissionResponse(False, str(e), code=500)
        except AdmissionUnavailable as e:
            # shed / expired / the device screen down: the fail-policy
            # envelope (fail-open admits UNMUTATED — exactly what the
            # apiserver's failurePolicy: Ignore would do on timeout)
            if decision is not None:
                note_unavailable_decision(decision, e)
            return unavailable_response(
                e, fail_policy=self.fail_policy, metrics=self.metrics,
                log=self.log, span=span, plane="mutation",
            )
        except Exception as e:
            return AdmissionResponse(False, str(e), code=500)
        return AdmissionResponse(True, "", patch=patch or None)
