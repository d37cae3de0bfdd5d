# Copied from gatekeeper_tpu/webhook/server.py; only these edits differ.
# Edit: the driver's phase names are mapped: TorchDriver reports the
# device dispatch as phase_seconds["dispatch"] and the encode as
# ["encode"], where the reference reads "device_dispatch" and
# "flatten_encode" (_PHASES); the decision facts' device_seconds_share, and
# so the SloEngine's cost EWMA the scheduler predicts with, read the former.
# MicroBatcher._driver_route is "fused" on TorchDriver (every micro-batch
# goes to the device) and "interp" on the port's RegoDriver; the route rides
# the dispatch span as driver_route. A batch the fused path fails, or one
# the open breaker turns away, is not answered again on the host
# interpreter: each of its requests gets EvaluationUnavailable, which the
# handler answers with the endpoint's fail-open/fail-closed envelope (the
# reference's failurePolicy).
# Edit: the partitioned dispatch keeps that rule. A partition that fails,
# whose device breaker is open or that cannot be staged is not answered
# on the host interpreter: each request its mask selects gets
# EvaluationUnavailable, counted per partition (the dispatcher's
# "unavailable" route and webhook_partition_unavailable_total); requests
# that touch only healthy partitions get the fused, merged answer; a plan
# with every device dead answers the whole batch so. A partition is staged
# synchronously (ensure_staged with wait=True): a restage compiles no
# kernel here. The whole-plane fault point fails every partition's breaker
# once and answers the batch with the fail policy. requests_batched
# counts the requests that got a fused answer.
# Edit: WebhookServer also hands `integrity` and `attributor` to the
# driver (set_integrity, set_attributor), as the reference's Runner does,
# so a server built without the Runner wires them too.
# Edit: a path other than /v1/admit, /v1/admitlabel,
# /v1/mutate and /v1/agent/review is answered 404, so the /readyz and
# /debug/partitions, /debug/programs documents are not served (the
# dispatcher's plan_table and programs_table build them).
# Edit: warmup() warms every plane's target: the validation target and,
# with the agent plane on, the agent target from its own sample tool calls
# (the reference's warms the validation target only, so the agent
# target's first batch compiled its policy).
# Edit: with TLS, each connection's handshake runs on that connection's
# thread (`do_handshake_on_connect=False`, `_Server.finish_request`). The
# reference wraps the listening socket with the default, so accept()
# handshakes every connection in turn on the serving thread: 256 callers
# connecting at once waited up to 5.4-5.7 s for their first answer
# (PERF.md §5), and a client that connects and sends nothing stops the
# accept loop.
"""Micro-batching admission server.

The reference webhook evaluates one AdmissionReview per goroutine behind
a shared RWMutex (pkg/webhook/policy.go:141, drivers/local/local.go:303)
— concurrency without batching. The device path inverts that: concurrent
requests are coalesced for up to `window_ms` (or until `max_batch`) and
the whole batch is evaluated in ONE fused device dispatch via
`Client.review_many`.

`WebhookServer` is a stdlib HTTP server serving /v1/admit and
/v1/admitlabel with AdmissionReview JSON — the in-process stand-in for
the Go webhook pod.

Failure semantics are the reference's failurePolicy: a request the
fused path did not evaluate gets the endpoint's fail-open/fail-closed
envelope. A failed fused batch is counted (`batch_failures`,
`webhook_batch_failures_total`) and answered so, never evaluated again
elsewhere; a circuit breaker (`faults.CircuitBreaker`) turns batches
away from the fused path after K consecutive failures, so a failing
device costs no doomed attempts while it is open. Overload
protection: the admission queue is bounded (`max_queue`) with load
shedding, and requests carry their caller deadline so an already-expired
request is shed before dispatch instead of evaluated and discarded.
Shed/degraded requests get the endpoint's fail-open/fail-closed
envelope, not a raw 500.
"""

from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FutureTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..faults import (
    CircuitBreaker,
    DeadlineExceeded,
    EvaluationTimeout,
    EvaluationUnavailable,
    FaultError,
    fire,
    skew,
)
from .namespacelabel import NamespaceLabelHandler
from .policy import ValidationHandler

# the K8s webhook timeoutSeconds ceiling is 30s and Gatekeeper deploys
# with 3s; our per-request deadline stays safely under the ceiling
DEFAULT_REQUEST_TIMEOUT = 10.0

# bounded admission queue: at max_batch=256 and low-ms batch drains this
# is seconds of backlog — anything deeper is already past every caller
# deadline, so evaluating it would be pure waste (shed instead)
DEFAULT_MAX_QUEUE = 2048

# the reference's driver phase names -> TorchDriver's phase_seconds keys
_PHASES = {"flatten_encode": "encode", "device_dispatch": "dispatch"}


def review_envelope(
    review: Dict[str, Any], request: Dict[str, Any], resp,
    trace_id: Optional[str] = None,
) -> Dict[str, Any]:
    """The one AdmissionReview response envelope, shared by every
    endpoint (admit / admitlabel): echoes the request's apiVersion
    (falling back to admission/v1) and uid, and carries the handler's
    response dict — including `patchType`/`patch` when the response has
    one. With a trace id (inbound `traceparent` or the admission-UID
    derivation) the envelope echoes it as `traceId`, so the caller can
    join its admission verdict to the trace and the denial log."""
    out = {
        "apiVersion": review.get("apiVersion", "admission.k8s.io/v1"),
        "kind": "AdmissionReview",
        "response": resp.to_dict(uid=request.get("uid")),
    }
    if trace_id is not None:
        out["traceId"] = trace_id
    return out


class MicroBatcher:
    """Collects admission requests into batches for fused evaluation.

    submit() returns a Future resolving to the request's results list.
    A background worker drains the queue every `window_ms` (or as soon
    as `max_batch` requests are pending) and runs one
    `Client.review_many` call for the whole batch.
    """

    # the plane tag on shed/breaker/queue metrics
    plane = "validation"

    def __init__(
        self,
        client,
        target: str,
        window_ms: float = 2.0,
        max_batch: int = 256,
        namespace_getter: Optional[Callable[[str], Optional[dict]]] = None,
        metrics=None,
        tracer=None,
        # bounded admission queue (overload shedding); None = unbounded
        max_queue: Optional[int] = DEFAULT_MAX_QUEUE,
        # device circuit breaker: None = construct the default; False =
        # disabled; or pass a faults.CircuitBreaker to share/observe
        breaker=None,
        # device fault domains: a parallel.partition.PartitionDispatcher
        # replaces the single per-plane breaker with per-(device, plane)
        # breakers — batches fan out over constraint-subset partitions, a
        # failed partition fails ONLY the requests its subset matches
        # (fail policy), and quarantined devices re-home their partitions
        partitioner=None,
        # obs.FlightRecorder: shed bursts (and the default breaker's
        # OPEN transitions) trip postmortem captures
        recorder=None,
        # obs.DecisionLog: the batch worker stashes per-request
        # dispatch facts (route, partition set dispatched vs
        # mask-skipped, rows_dispatched/rows_total, cache counts,
        # device-time share) under each request's trace id; the handler
        # claims them when it records the decision
        decisions=None,
        # admission scheduling: "fifo" is bit-compatible with the
        # pre-scheduler queue; "deadline" turns on EDF batch formation,
        # predictive shedding, and per-tenant fair-share quotas. slo
        # (SloEngine) feeds the overload/saturation loop and the batch
        # cost EWMA; attributor seeds the cost model before the EWMA warms.
        sched_policy: str = "fifo",
        slo=None,
        attributor=None,
        # integrity.IntegrityPlane: post-response shadow-oracle
        # sampling — a deterministic CRC(trace_id) fraction of live
        # admissions re-evaluates asynchronously on the host interpreter
        integrity=None,
    ):
        self.client = client
        self.target = target
        self.partitioner = partitioner
        self.recorder = recorder
        self.decisions = decisions
        self.integrity = integrity
        # (constraint generation, corpus size) cache for rows facts
        self._rows_cache: Optional[Tuple[Any, int]] = None
        if partitioner is not None and breaker is None:
            # the per-device breaker bank replaces the plane breaker
            breaker = False
        # the target handler owns serving-plane review construction
        # (K8s: AdmissionRequest -> AugmentedReview); clients without a
        # target registry (test fakes) get the default handler
        from ..constraint.handler import handler_for

        self.target_handler = handler_for(client, target)
        self.window = window_ms / 1000.0
        self.max_batch = max_batch
        self.max_queue = max_queue
        self.namespace_getter = namespace_getter
        self.metrics = metrics
        # obs.Tracer: the batch worker stamps queue-wait + dispatch +
        # render spans into EVERY member request's trace (the shared
        # batch window, recorded per trace so each is self-contained)
        self.tracer = tracer
        if breaker is None:
            breaker = CircuitBreaker(
                plane=self.plane, metrics=metrics, tracer=tracer,
                recorder=recorder,
            )
        self.breaker: Optional[CircuitBreaker] = breaker or None
        # the admission scheduler owns enqueue-side admit/shed and the
        # dispatch-side batch cut; its clock is the batcher's deadline
        # clock, so enqueue, cut and expiry read one clock
        from ..sched import AdmissionScheduler

        self.sched = AdmissionScheduler(
            plane=self.plane,
            policy=sched_policy,
            max_queue=max_queue,
            clock=self._now,
            slo=slo,
            attributor=attributor,
            metrics=metrics,
        )
        # (request, future, span ctx | None, (wall, perf) submit stamp,
        #  monotonic deadline | None, scheduler tenant key | None)
        self._pending: List[
            Tuple[Dict[str, Any], Future, Any, Tuple, Optional[float],
                  Optional[str]]
        ] = []
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self.batches_dispatched = 0
        self.requests_batched = 0
        self.batch_failures = 0
        self.shed_count = 0

    def start(self) -> None:
        if self._thread is None:
            self._stop = False
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    def stop(self) -> None:
        with self._lock:
            self._stop = True
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        # in-flight requests must not hang until their caller timeout:
        # dispatch whatever the worker left behind
        with self._lock:
            leftover = self._pending
            self._pending = []
        if leftover:
            self._dispatch(leftover)

    def _now(self) -> float:
        """The batcher's deadline clock: monotonic plus any injected
        clock-jump skew (fault point `webhook.clock`) so chaos runs can
        simulate NTP steps without touching the real clock."""
        return time.monotonic() + skew("webhook.clock")

    def _driver_route(self) -> str:
        """What the driver does with a batch: `fused` (one device
        dispatch; TorchDriver sends every micro-batch to the device) or
        `interp` (the interpreter driver) — the route fact the dispatch
        span explains a request's latency with."""
        from ..constraint.torchdriver import TorchDriver

        drv = getattr(self.client, "_driver", None)
        return "fused" if isinstance(drv, TorchDriver) else "interp"

    # -- decision facts --------------------------------------------------------

    def _corpus_rows(self) -> Optional[int]:
        """Constraint-corpus size (the rows_total denominator), cached
        per constraint generation so the hot path pays one generation
        read per batch, not a key listing."""
        drv = getattr(self.client, "_driver", None) if self.client else None
        keys_fn = getattr(drv, "constraint_keys", None)
        if keys_fn is None:
            return None
        gen_fn = getattr(drv, "constraint_generation", None)
        gen = gen_fn() if gen_fn is not None else None
        cached = self._rows_cache
        if cached is None or cached[0] != gen:
            try:
                cached = self._rows_cache = (gen, len(keys_fn(self.target)))
            except Exception:
                return None
        return cached[1]

    def _note_rows(self, partition, rows_dispatched, rows_total) -> None:
        """The pruning-efficiency series: constraint-rows actually
        dispatched vs the full corpus, per partition."""
        if self.metrics is None or not rows_total:
            return
        self.metrics.record(
            "dispatch_rows_dispatched_total", rows_dispatched,
            plane=self.plane, partition=str(partition),
        )
        self.metrics.record(
            "dispatch_rows_total", rows_total,
            plane=self.plane, partition=str(partition),
        )

    def _extdata_fetch_count(self) -> int:
        ed = getattr(self.client, "external_data", None) if self.client \
            else None
        return int(getattr(ed, "fetch_count", 0) or 0)

    def _liveness_skipped_count(self) -> int:
        """Driver-cumulative count of provably dead token slots the IR
        feature-liveness mask dropped before padding; dispatch sites
        report the per-batch delta as a decision fact."""
        drv = getattr(self.client, "_driver", None) if self.client else None
        return int(getattr(drv, "columns_skipped_static", 0) or 0)

    def _driver_consumption(self) -> Dict[str, Any]:
        """Per-batch consumption facts from the driver's last dispatch
        stats: render-cache hits and the batch's device-execute window
        (apportioned per request by the caller)."""
        drv = getattr(self.client, "_driver", None) if self.client else None
        stats = getattr(drv, "stats", None)
        out: Dict[str, Any] = {}
        if isinstance(stats, dict):
            if "render_cache_hits" in stats:
                out["cache_hits"] = stats["render_cache_hits"]
            phases = stats.get("phase_seconds") or {}
            if _PHASES["device_dispatch"] in phases:
                out["device_seconds"] = phases[_PHASES["device_dispatch"]]
        return out

    def _note_decisions(
        self, batch, route: str, rows_dispatched=None, rows_total=None,
        extdata_fetches: Optional[int] = None, per_request=None,
        columns_skipped_static: Optional[int] = None,
    ) -> None:
        """Stash dispatch facts for every traced member request. Batch-
        shared facts (route, rows, fetches, device share) apply to all;
        `per_request` maps batch index -> overriding facts (the
        partitioned path's per-request partition sets)."""
        if self.decisions is None:
            return
        cons = self._driver_consumption()
        dev = cons.pop("device_seconds", None)
        base: Dict[str, Any] = {"route": route, "batch_size": len(batch)}
        base.update(cons)
        if rows_total is not None:
            base["rows_total"] = rows_total
            base["rows_dispatched"] = (
                rows_dispatched if rows_dispatched is not None
                else rows_total
            )
        if extdata_fetches is not None:
            base["extdata_fetches"] = extdata_fetches
        if columns_skipped_static is not None:
            # dead token slots the IR liveness mask dropped from this
            # batch's encode
            base["columns_skipped_static"] = columns_skipped_static
        if dev is not None and batch:
            # the batch's measured device window split evenly across
            # members — the request-level share of what the constraint-
            # level CostAttributor accounts exactly
            base["device_seconds_share"] = round(dev / len(batch), 9)
        for i, (_, _, ctx, _, _, _) in enumerate(batch):
            tid = getattr(ctx, "trace_id", None)
            if tid is None:
                continue
            facts = base
            if per_request is not None and i in per_request:
                facts = dict(base)
                facts.update(per_request[i])
            self.decisions.note_dispatch(tid, **facts)

    def _shed(self, fut: Future, exc: Exception, reason: str,
              ctx=None, sub_wall: Optional[float] = None) -> None:
        """Resolve a future without evaluation: counted, traced, and
        typed so the handler answers with the fail policy envelope."""
        with self._lock:  # sheds race from concurrent submit threads
            self.shed_count += 1
        if self.metrics is not None:
            self.metrics.record(
                "webhook_shed_total", 1, plane=self.plane, reason=reason
            )
        if self.tracer is not None and ctx is not None:
            now = time.time()
            self.tracer.record_span(
                "shed", sub_wall if sub_wall is not None else now, now,
                parent=ctx, reason=reason, plane=self.plane,
            )
        if self.recorder is not None:
            # shed-burst detection: the recorder counts; crossing its
            # threshold trips ONE postmortem capture for the storm
            try:
                self.recorder.note_shed(self.plane)
            except Exception:
                pass
        fut.set_exception(exc)

    def submit(self, request: Dict[str, Any], span_ctx=None,
               deadline: Optional[float] = None, tenant=None) -> Future:
        """Enqueue for the next fused dispatch. `deadline` is a
        monotonic timestamp (the caller's remaining budget): a request
        that is already expired — or expires while queued — is shed
        with DeadlineExceeded instead of ever reaching a dispatch.
        `tenant` is the decision-log tenant identity, extracted BEFORE
        enqueue so shed verdicts carry it and the scheduler's
        fair-share quotas account exactly."""
        fut: Future = Future()
        stamp = (time.time(), time.perf_counter())
        if deadline is not None and self._now() >= deadline:
            # expired before enqueue: never pay queue + dispatch for an
            # answer nobody is waiting for
            self._shed(
                fut,
                DeadlineExceeded("request deadline expired before enqueue"),
                "deadline", ctx=span_ctx, sub_wall=stamp[0],
            )
            return fut
        shed_exc = victim_item = victim_exc = None
        with self._lock:
            stopped = self._stop
            if not stopped:
                key, shed_exc, victim = self.sched.offer(
                    self._pending, tenant=tenant, deadline=deadline,
                    now=self._now(),
                )
                if shed_exc is None:
                    if victim is not None:
                        # predictive shedding under a full queue: the
                        # queued request that provably cannot make its
                        # deadline goes, not the viable newcomer
                        idx, victim_exc = victim
                        victim_item = self._pending.pop(idx)
                    self._pending.append(
                        (request, fut, span_ctx, stamp, deadline, key)
                    )
                    n = len(self._pending)
        if stopped:
            # worker is gone (and stop() may have already drained its
            # leftovers): dispatch inline so the caller never hangs
            self._dispatch(
                [(request, fut, span_ctx, stamp, deadline, None)]
            )
            return fut
        if victim_item is not None:
            _, vfut, vctx, vstamp, _, _ = victim_item
            self._shed(
                vfut, victim_exc, victim_exc.reason,
                ctx=vctx, sub_wall=vstamp[0],
            )
        if shed_exc is not None:
            self._shed(
                fut, shed_exc, getattr(shed_exc, "reason", "queue_full"),
                ctx=span_ctx, sub_wall=stamp[0],
            )
        else:
            if self.metrics is not None:
                self.metrics.gauge(
                    "admission_queue_depth", n, plane=self.plane
                )
            if n == 1 or n >= self.max_batch:
                self._wake.set()
        return fut

    def _loop(self) -> None:
        while True:
            # idle: block until the first request (or stop) arrives —
            # no fixed-cadence wakeups while the queue is empty
            self._wake.wait()
            self._wake.clear()
            if self._stop:
                return
            # a batch has started forming: coalesce for up to `window`,
            # cut short when max_batch fills
            deadline = time.monotonic() + self.window
            while not self._stop:
                with self._lock:
                    n = len(self._pending)
                remaining = deadline - time.monotonic()
                if n >= self.max_batch or remaining <= 0:
                    break
                self._wake.wait(remaining)
                self._wake.clear()
            with self._lock:
                # the scheduler cuts the batch: fifo takes everything
                # in arrival order (the pre-scheduler swap); deadline
                # policy orders EDF and defers requests that would blow
                # the earliest member deadline to the next window
                batch, rest = self.sched.cut(
                    self._pending, self.max_batch, now=self._now()
                )
                self._pending = rest
            if rest:
                # deferred work exists: start the next window now
                self._wake.set()
            if self.metrics is not None:
                self.metrics.gauge(
                    "admission_queue_depth", len(rest), plane=self.plane
                )
            if batch:
                self._dispatch(batch)
            if self._stop:
                return

    def _strip_expired(self, batch):
        """Deadline propagation: requests whose caller deadline expired
        while queued are shed here — before any dispatch — instead of
        evaluated and discarded."""
        now = self._now()
        live = []
        for item in batch:
            _, fut, ctx, stamp, deadline = item[:5]
            if deadline is not None and now >= deadline:
                self._shed(
                    fut,
                    DeadlineExceeded(
                        "request deadline expired while queued"
                    ),
                    "deadline", ctx=ctx, sub_wall=stamp[0],
                )
            else:
                live.append(item)
        return live

    def _dispatch(self, batch) -> None:
        batch = self._strip_expired(batch)
        if not batch:
            return
        wall0, t0 = time.time(), time.perf_counter()
        reviews = [
            self.target_handler.augment_request(
                request, self.namespace_getter
            )
            for request, _, _, _, _, _ in batch
        ]
        if self.partitioner is not None:
            plan = None
            try:
                plan = self.partitioner.plan()
            except Exception:
                plan = None  # plan failure: the monolithic path still serves
            if plan is not None and plan.partitions:
                self._dispatch_partitioned(batch, reviews, plan, wall0, t0)
                return
        breaker = self.breaker
        if breaker is not None and not breaker.allow():
            # breaker open: the fused path has been failing — answer with
            # the fail policy, paying zero doomed device attempts
            if self.metrics is not None:
                self.metrics.record(
                    "webhook_degraded_dispatch_total", 1, plane=self.plane
                )
            self._unavailable(batch, wall0, t0, "circuit breaker open")
            return
        fetch0 = self._extdata_fetch_count()
        skip0 = self._liveness_skipped_count()
        try:
            fire("webhook.batch_dispatch")
            all_responses = self.client.review_many(reviews)
        except Exception as e:
            if breaker is not None:
                breaker.record_failure()
            self.batch_failures += 1
            if self.metrics is not None:
                self.metrics.record("webhook_batch_failures_total", 1)
            self._unavailable(batch, wall0, t0, f"fused batch failed: {e!r}")
            return
        if breaker is not None:
            breaker.record_success()
        self.batches_dispatched += 1
        self.requests_batched += len(batch)
        if self.metrics is not None:
            self.metrics.record("webhook_batches_total", 1)
            self.metrics.observe("webhook_batch_size", len(batch))
        self._record_spans(batch, wall0, t0, route="batched")
        # the monolithic dispatch evaluates the whole corpus for every
        # member (dispatched == total under the "mono" partition label)
        rows = self._corpus_rows()
        if rows is not None:
            self._note_rows("mono", rows * len(batch), rows * len(batch))
        self._note_decisions(
            batch, self._driver_route(),
            rows_dispatched=rows, rows_total=rows,
            extdata_fetches=self._extdata_fetch_count() - fetch0,
            columns_skipped_static=self._liveness_skipped_count() - skip0,
        )
        for (_, fut, ctx, _, _, _), review, responses in zip(
            batch, reviews, all_responses
        ):
            resp = responses.by_target.get(self.target)
            results = resp.results if resp is not None else []
            fut.set_result(results)
            self._note_integrity(ctx, review, results, route="batched")

    def _note_integrity(self, ctx, review, results, **facts) -> None:
        """Offer one served admission to the verdict-integrity plane's
        shadow oracle (CRC-sampled, asynchronous, post-response). Never
        fails a request."""
        if self.integrity is None:
            return
        try:
            self.integrity.note_live(
                getattr(ctx, "trace_id", None), review, results,
                plane=self.plane, **facts,
            )
        except Exception:
            pass

    def _dispatch_partitioned(self, batch, reviews, plan,
                              wall0: float, t0: float) -> None:
        """Fault-domain dispatch: fan the batch out over the plan's
        constraint-subset partitions, each gated by its device's breaker
        and evaluating only the requests its match mask selects. A
        partition that is open, unstaged or failing answers the requests
        it selects with EvaluationUnavailable (the fail policy envelope);
        every other request gets the fused results merged back into the
        monolithic order (merge_partition_results), equal to the
        monolithic dispatch's."""
        from ..parallel.partition import merge_partition_results

        part = self.partitioner
        client = self.client
        if plan.all_dead:
            # the whole device fleet is quarantined; still run probes, or
            # nothing would ever bring a device back
            if self.metrics is not None:
                self.metrics.record(
                    "webhook_degraded_dispatch_total", 1, plane=self.plane
                )
            for p in plan.partitions:
                self._note_unavailable(p)
            self._unavailable(
                batch, wall0, t0, "every partition device is quarantined"
            )
            part.run_probes(reviews)
            return
        try:
            fire("webhook.batch_dispatch")
        except FaultError as e:
            # a whole-plane fault (the unlabeled point): every device pays
            # a failure, as before partitioning
            for p in plan.partitions:
                part.breaker(p.device).record_failure()
                self._note_unavailable(p)
            self.batch_failures += 1
            if self.metrics is not None:
                self.metrics.record("webhook_batch_failures_total", 1)
            self._unavailable(batch, wall0, t0, f"fused batch failed: {e!r}")
            part.run_probes(reviews)
            return
        fetch0 = self._extdata_fetch_count()
        skip0 = self._liveness_skipped_count()
        prefetch = getattr(client, "prefetch_external", None)
        if prefetch is not None:
            # one deduped external-data fetch epoch for the whole batch
            # (every partition dispatch then serves from the cache)
            try:
                prefetch(reviews)
            except Exception:
                pass
        try:
            masks = client.partition_match_mask(
                reviews, [p.subset for p in plan.partitions]
            )
        except Exception:
            # sound fallback: every partition sees every request
            masks = [[True] * len(reviews) for _ in plan.partitions]
        fused: List[Any] = []
        down: Dict[int, str] = {}  # partition index -> why it is down
        skipped_parts: List[int] = []
        for p, mask in zip(plan.partitions, masks):
            if not any(mask):
                # nothing in this batch touches the partition: zero cost —
                # the blast-radius contract for requests matching only
                # healthy subsets
                part.note_dispatch("skipped", p.device)
                skipped_parts.append(p.index)
                continue
            br = part.breaker(p.device)
            if not br.allow():
                if self.metrics is not None:
                    self.metrics.record(
                        "webhook_degraded_dispatch_total", 1,
                        plane=self.plane,
                    )
                down[p.index] = f"device {p.device} breaker open"
            elif not part.ensure_staged(p):
                # restage failed (backing off) or lost a race with churn
                down[p.index] = f"partition {p.index} not staged"
            else:
                fused.append((p, br))

        # mask-sliced dispatch: each partition evaluates ONLY the requests
        # its mask row selects; unselected rows contribute no result by
        # the mask's definition
        sel_by_part = {
            p.index: [i for i, hit in enumerate(masks[p.index]) if hit]
            for p in plan.partitions
        }

        def run_one(p, br):
            sel = sel_by_part[p.index]
            try:
                return p, br, client.review_many_subset(
                    [reviews[i] for i in sel], p.subset,
                    device=p.device, partition=p.index,
                ), None
            except Exception as e:
                return p, br, None, e

        executor = part.executor if len(fused) > 1 else None
        if executor is not None:
            outcomes = list(executor.map(lambda a: run_one(*a), fused))
        else:
            outcomes = [run_one(p, br) for p, br in fused]
        # partition index -> per-request result lists
        part_results: Dict[int, List[List[Any]]] = {}
        for p, br, resps, exc in outcomes:
            if exc is None:
                br.record_success()
                part.note_dispatch("fused", p.device)
                rows: List[List[Any]] = [[] for _ in reviews]
                for i, responses in zip(sel_by_part[p.index], resps):
                    resp = responses.by_target.get(self.target)
                    rows[i] = resp.results if resp is not None else []
                part_results[p.index] = rows
            else:
                br.record_failure()
                self.batch_failures += 1
                if self.metrics is not None:
                    self.metrics.record("webhook_batch_failures_total", 1)
                part.note_dispatch("failed", p.device)
                down[p.index] = (
                    f"partition {p.index} on device {p.device} failed: "
                    f"{exc!r}"
                )
        # the fail policy, scoped: only the requests a down partition's
        # mask selects
        errors: Dict[int, Exception] = {}
        degraded_reqs: Dict[int, List[int]] = {}
        for p in plan.partitions:
            why = down.get(p.index)
            if why is None:
                continue
            self._note_unavailable(p)
            for i in sel_by_part[p.index]:
                degraded_reqs.setdefault(i, []).append(p.index)
                errors.setdefault(i, EvaluationUnavailable(why))
        self.batches_dispatched += 1
        self.requests_batched += len(batch) - len(errors)
        if self.metrics is not None:
            self.metrics.record("webhook_batches_total", 1)
            self.metrics.observe("webhook_batch_size", len(batch))
        self._record_spans(
            batch, wall0, t0, route="batched" if not down else "partitioned",
        )
        if self.tracer is not None and degraded_reqs:
            # per-REQUEST accounting: only requests a down partition
            # selected carry the span
            wall1 = wall0 + (time.perf_counter() - t0)
            for i, pidx in degraded_reqs.items():
                ctx = batch[i][2]
                if ctx is not None:
                    self.tracer.record_span(
                        "unavailable_subset", wall0, wall1, parent=ctx,
                        plane=self.plane, partitions=sorted(pidx),
                    )
        # per-partition pruning-efficiency series — a partition evaluates
        # only its mask-selected requests, a mask-skipped one nothing —
        # plus the per-request partition set and mask-derived rows
        n_rev = len(reviews)
        key_count = {p.index: len(p.keys) for p in plan.partitions}
        touched = len(plan.partitions) - len(skipped_parts)
        part.note_batch_touched(touched, len(plan.partitions))
        for p in plan.partitions:
            self._note_rows(
                p.index, key_count[p.index] * len(sel_by_part[p.index]),
                key_count[p.index] * n_rev,
            )
        if self.decisions is not None:
            per_request: Dict[int, Dict[str, Any]] = {}
            for i in range(n_rev):
                matched = [
                    p.index for p in plan.partitions if masks[p.index][i]
                ]
                facts: Dict[str, Any] = {
                    "partitions_matched": matched,
                    "partitions_skipped": list(skipped_parts),
                    "partitions_touched": touched,
                    "rows_total": sum(key_count.values()),
                    "rows_excluded_static": len(plan.excluded_static),
                    "rows_dispatched": sum(key_count[j] for j in matched),
                }
                if i in degraded_reqs:
                    facts["route"] = "unavailable"
                    facts["partitions_unavailable"] = sorted(
                        degraded_reqs[i]
                    )
                per_request[i] = facts
            self._note_decisions(
                batch, self._driver_route(),
                extdata_fetches=self._extdata_fetch_count() - fetch0,
                per_request=per_request,
                columns_skipped_static=self._liveness_skipped_count() - skip0,
            )
        for i, (_, fut, ctx, _, _, _) in enumerate(batch):
            if i in errors:
                fut.set_exception(errors[i])
            else:
                merged = merge_partition_results(
                    [rows[i] for rows in part_results.values()], plan.order,
                )
                fut.set_result(merged)
                self._note_integrity(
                    ctx, reviews[i], merged, route="partitioned",
                )
        part.run_probes(reviews)

    def _note_unavailable(self, p) -> None:
        """Count one partition answered with the fail policy."""
        self.partitioner.note_dispatch("unavailable", p.device)
        if self.metrics is not None:
            self.metrics.record(
                "webhook_partition_unavailable_total", 1, plane=self.plane,
                partition=str(p.index), device=str(p.device),
            )

    def _unavailable(self, batch, wall0: float, t0: float, why: str) -> None:
        """Resolve a batch the fused path did not evaluate: every request
        gets the typed EvaluationUnavailable, which the handler answers
        with the endpoint's fail-open/fail-closed envelope."""
        for _, fut, _, _, _, _ in batch:
            fut.set_exception(EvaluationUnavailable(why))
        self._record_spans(batch, wall0, t0, route="unavailable")
        self._note_decisions(batch, "unavailable")

    def _record_spans(self, batch, wall0: float, t0: float, route: str) -> None:
        """Stamp this batch's shared timing window into every traced
        member request: queue_wait (submit -> dispatch start), dispatch
        (the fused evaluation), its flatten_encode / device_execute
        children from the driver's per-query phase split, and render.
        Phase offsets are synthesized sequentially inside the dispatch
        window — the driver reports durations, not wall stamps."""
        if self.tracer is None:
            return
        wall1 = wall0 + (time.perf_counter() - t0)
        drv = getattr(self.client, "_driver", None)
        stats = getattr(drv, "stats", None)
        phases: Dict[str, float] = {}
        attrs: Dict[str, Any] = {"driver_route": self._driver_route()}
        if isinstance(stats, dict):
            phases = stats.get("phase_seconds") or {}
            for k in ("compiled_pairs", "interp_pairs", "n_results"):
                if k in stats:
                    attrs[k] = stats[k]
        render_s = phases.get("render", 0.0)
        for _, _, ctx, (sub_wall, _sub_perf), _, _ in batch:
            if ctx is None:
                continue
            self.tracer.record_span(
                "queue_wait", sub_wall, wall0, parent=ctx
            )
            d_ctx = self.tracer.record_span(
                "dispatch", wall0, wall1, parent=ctx,
                batch_size=len(batch), route=route, **attrs
            )
            cursor = wall0
            for phase in ("flatten_encode", "device_dispatch"):
                dt = phases.get(_PHASES[phase])
                if dt:
                    self.tracer.record_span(
                        phase, cursor, cursor + dt, parent=d_ctx
                    )
                    cursor += dt
            # always recorded: on the interpreter route rendering is
            # inlined in the evaluation, reported as a point span
            self.tracer.record_span(
                "render", wall1 - render_s, wall1, parent=d_ctx
            )


class BatchedValidationHandler(ValidationHandler):
    """ValidationHandler whose review path goes through the batcher."""

    def __init__(
        self,
        batcher: MicroBatcher,
        request_timeout: float = DEFAULT_REQUEST_TIMEOUT,
        **kwargs,
    ):
        super().__init__(
            batcher.client,
            batcher.target,
            namespace_getter=batcher.namespace_getter,
            **kwargs,
        )
        self.batcher = batcher
        self.request_timeout = request_timeout
        # per-thread deadline override: the framed ingest path stamps
        # the FRAME HEADER's budget here so the scheduler sees the
        # caller's real deadline instead of the server-side default
        self._deadline_local = threading.local()

    @contextmanager
    def deadline_scope(self, deadline: Optional[float]):
        """Pin _review calls on THIS thread to an absolute monotonic
        deadline (ingest frames carry one in the header). None is a
        no-op scope — the default request_timeout budget applies."""
        if deadline is None:
            yield
            return
        self._deadline_local.value = deadline
        try:
            yield
        finally:
            self._deadline_local.value = None

    def _review(
        self, request: Dict[str, Any], tracing: bool = False, span=None
    ) -> List[Any]:
        if tracing:
            # traced requests bypass the batcher: traces are per-request
            # by definition (the driver's batched path declines tracing)
            return super()._review(request, tracing=True, span=span)
        ctx = getattr(span, "context", None)
        # deadline propagation: the request's remaining budget rides to
        # the batch worker so expiry is checked BEFORE dispatch. Tenant
        # identity is extracted BEFORE enqueue too — shed verdicts must
        # carry it, and the scheduler's quotas key on it.
        override = getattr(self._deadline_local, "value", None)
        if override is not None:
            deadline = override
            budget = max(0.0, deadline - self.batcher._now())
        else:
            deadline = self.batcher._now() + self.request_timeout
            budget = self.request_timeout
        tenant = {
            "namespace": request.get("namespace", ""),
            "username": (request.get("userInfo") or {}).get(
                "username", ""
            ),
        }
        fut = self.batcher.submit(
            request, span_ctx=ctx, deadline=deadline, tenant=tenant
        )
        try:
            return fut.result(timeout=budget)
        except _FutureTimeout:
            # a hung dispatch (device stall): the caller gets the typed
            # unavailability — answered per fail policy — while the
            # worker finishes or dies in the background
            raise EvaluationTimeout(
                f"admission evaluation exceeded {budget:.3f}s"
            ) from None


class WebhookServer:
    """Stdlib HTTP(S) server: POST /v1/admit, /v1/admitlabel and
    /v1/mutate with AdmissionReview JSON bodies, and /v1/agent/review
    with tool-call records, over HTTP/1.1 keep-alive. `tls=True`
    terminates HTTPS with the rotating self-signed pair from
    `certs.CertRotator` (cert_dir defaults to a per-server temp dir)."""

    def __init__(
        self,
        client,
        target: str,
        port: int = 0,
        excluder=None,
        namespace_getter=None,
        exempt_namespaces=None,
        window_ms: float = 2.0,
        metrics=None,
        tls: bool = False,
        cert_dir: Optional[str] = None,
        # pre-built cert rotator (fleet.FleetCertRotator for the
        # Secret-backed shared store); None builds a pod-local
        # CertRotator in cert_dir. When the rotator exposes on_rotate
        # (the fleet one does), a rotation — our own OR a peer's —
        # re-loads the live SSL context so new handshakes serve the new
        # pair WITHOUT a restart.
        rotator=None,
        request_timeout: float = DEFAULT_REQUEST_TIMEOUT,
        trace_config=None,
        event_sink=None,
        emit_admission_events: bool = False,
        log_denies: bool = False,
        logger=None,
        tracer=None,
        # mutation.MutationSystem: wires the /v1/mutate plane (None =
        # endpoint returns 404, validation-only pod)
        mutation_system=None,
        # overload / degradation envelope: fail_policy is what a
        # shed/expired/unevaluable request gets — "open" (allow; the
        # reference's failurePolicy: Ignore posture) or "closed" (deny
        # 503); max_queue bounds the admission queue
        fail_policy: str = "open",
        max_queue: Optional[int] = DEFAULT_MAX_QUEUE,
        # "127.0.0.1" keeps tests hermetic; in-cluster serving must bind
        # the pod IP surface ("0.0.0.0") or the apiserver and kubelet
        # probes can never connect
        bind_addr: str = "127.0.0.1",
        # agent-action plane (docs/targets.md): True wires
        # POST /v1/agent/review over the client's registered
        # AgentActionTarget; agent_mutation_system additionally screens
        # and rewrites tool-call arguments before validation
        agent_review: bool = False,
        agent_mutation_system=None,
        # graceful drain: seconds stop() holds the listener OPEN after
        # flipping readiness, so a load balancer watching readiness
        # routes away before connections start failing (the
        # preStop-sleep pattern; 0 = flip-and-close immediately)
        drain_grace_s: float = 0.0,
        # obs.FlightRecorder: threaded to the batcher (shed bursts), the
        # plane breaker, and the partitioner's per-device breakers so a
        # trip anywhere on this server captures one postmortem
        recorder=None,
        # obs.DecisionLog: per-admission "why" records; None = decision
        # plane off
        decision_log=None,
        # device fault domains: split the constraint corpus into this
        # many partitions, each on its own logical device with its own
        # breaker — a sick device fails only the requests its constraint
        # subset matches, not the plane. 0/None keeps the monolithic
        # dispatch + single plane breaker. On one card the devices are
        # logical fault domains; every partition runs on the same GPU.
        partitions: Optional[int] = None,
        partition_devices: Optional[int] = None,
        # obs.CostAttributor: handed to the driver (set_attributor); its
        # measured per-constraint seconds feed the partition planner and
        # the scheduler's cost model; replica tags the planner's tables
        attributor=None,
        replica: Optional[str] = None,
        # analysis.corpus.CorpusPlane: feeds the partition planner its
        # provably-dead (verdict-safe prunable) constraint keys
        corpus=None,
        # admission scheduling: policy for the batcher — "fifo" is the
        # bit-compatible rollback path, "deadline" enables EDF batch
        # formation + predictive shedding + fair-share quotas. slo is
        # the obs.SloEngine feeding the overload/saturation loop.
        sched_policy: str = "fifo",
        slo=None,
        # integrity.IntegrityPlane: handed to the driver (set_integrity)
        # for canary rows and the golden swap gate; shadow-oracle sampling
        # on the batcher and corruption quarantine via the partitioner
        integrity=None,
        # wire-speed ingest plane: True mounts a framed-stream listener
        # (ingest.IngestServer) next to the HTTP port — persistent
        # multiplexed connections, zero-copy AdmissionReview decode,
        # frame-header deadlines. The HTTP path is untouched either way.
        ingest: bool = False,
        ingest_port: int = 0,
        ingest_decode: str = "zerocopy",
        ingest_max_inflight: int = 256,
        ingest_workers: int = 64,
    ):
        self.client = client  # warmup() runs through it
        self.tracer = tracer
        self.recorder = recorder
        self.decision_log = decision_log
        self.request_timeout = request_timeout
        self.drain_grace_s = drain_grace_s
        driver = getattr(client, "_driver", None)
        for plane, setter in ((attributor, "set_attributor"),
                              (integrity, "set_integrity")):
            wire = getattr(driver, setter, None)
            if plane is not None and wire is not None:
                wire(plane)
        self.partitioner = None
        if partitions:
            from ..parallel.partition import PartitionDispatcher

            self.partitioner = PartitionDispatcher(
                client,
                target,
                k=partitions,
                devices=partition_devices,
                plane="validation",
                metrics=metrics,
                tracer=tracer,
                recorder=recorder,
                attributor=attributor,
                replica=replica,
                corpus=corpus,
            )
        # graceful-drain state: `draining` flips BEFORE the listener
        # closes (readiness consults it), in-flight HTTP requests are
        # counted so stop() can wait for them, and on_drain callbacks
        # let an observer see the flip at its exact ordering point
        self.draining = False
        self._inflight = 0
        self._inflight_cv = threading.Condition()
        self._drain_callbacks: List[Callable[[], None]] = []
        self.batcher = MicroBatcher(
            client, target, window_ms=window_ms,
            namespace_getter=namespace_getter,
            metrics=metrics, tracer=tracer,
            max_queue=max_queue,
            partitioner=self.partitioner,
            recorder=recorder,
            decisions=decision_log,
            sched_policy=sched_policy,
            slo=slo,
            attributor=attributor,
            integrity=integrity,
        )
        self.integrity = integrity
        if integrity is not None:
            # the mismatch ledger trips corruption quarantine through the
            # dispatcher; the shadow oracle re-evaluates through the
            # client's host interpreter
            integrity.attach_client(client)
            if self.partitioner is not None:
                integrity.attach_dispatcher(self.partitioner)
        self.mutate_batcher = None
        self.mutation_handler = None
        if mutation_system is not None:
            # local import: mutate.py imports from this module
            from .mutate import MutateBatcher, MutationHandler

            self.mutate_batcher = MutateBatcher(
                mutation_system, window_ms=window_ms,
                namespace_getter=namespace_getter,
                metrics=metrics, tracer=tracer,
                max_queue=max_queue,
                decisions=decision_log,
                sched_policy=sched_policy,
                slo=slo,
                attributor=attributor,
            )
            self.mutation_handler = MutationHandler(
                self.mutate_batcher,
                excluder=excluder,
                metrics=metrics,
                request_timeout=request_timeout,
                logger=logger,
                tracer=tracer,
                fail_policy=fail_policy,
                decision_log=decision_log,
            )
        self.handler = BatchedValidationHandler(
            self.batcher, excluder=excluder, metrics=metrics,
            request_timeout=request_timeout,
            trace_config=trace_config,
            event_sink=event_sink,
            emit_admission_events=emit_admission_events,
            log_denies=log_denies,
            logger=logger,
            tracer=tracer,
            fail_policy=fail_policy,
            decision_log=decision_log,
        )
        self.label_handler = NamespaceLabelHandler(exempt_namespaces)
        self.agent_batcher = None
        self.agent_mutate_batcher = None
        self.agent_handler = None
        if agent_review:
            from ..agentaction import make_agent_plane

            (
                self.agent_batcher,
                self.agent_mutate_batcher,
                self.agent_handler,
            ) = make_agent_plane(
                client,
                window_ms=window_ms,
                mutation_system=agent_mutation_system,
                metrics=metrics,
                tracer=tracer,
                logger=logger,
                fail_policy=fail_policy,
                request_timeout=request_timeout,
                max_queue=max_queue,
                decision_log=decision_log,
                sched_policy=sched_policy,
                slo=slo,
                attributor=attributor,
            )
        self.ingest = None
        if ingest:
            # local import: ingest.server imports review_envelope back
            # from this module
            from ..ingest.server import IngestServer

            self.ingest = IngestServer(
                self,
                host=bind_addr,
                port=ingest_port,
                decode=ingest_decode,
                max_inflight=ingest_max_inflight,
                workers=ingest_workers,
                metrics=metrics,
                tracer=tracer,
                decision_log=decision_log,
            )
            self.ingest_port = self.ingest.port
        outer = self

        class _Handled(Exception):
            """Control flow: response already written by the branch."""

        class _Handler(BaseHTTPRequestHandler):
            # HTTP/1.1 keep-alive: every response already carries an
            # explicit Content-Length, so persistent connections are
            # safe — sequential admissions from one client reuse a
            # single socket instead of paying setup per request.
            # Chunked bodies are not produced or accepted.
            protocol_version = "HTTP/1.1"

            def do_POST(self):  # noqa: N802
                # in-flight accounting: an ACCEPTED request must finish
                # even when stop() runs concurrently — the drain waits
                # on this counter before tearing the batcher down
                with outer._inflight_cv:
                    outer._inflight += 1
                try:
                    self._do_post()
                finally:
                    with outer._inflight_cv:
                        outer._inflight -= 1
                        outer._inflight_cv.notify_all()

            def _do_post(self):
                from ..obs import (
                    derive_trace_id,
                    format_traceparent,
                    parse_traceparent,
                )

                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                trace_id = None
                try:
                    review = json.loads(body)
                    request = review.get("request") or {}
                    # W3C trace propagation: an inbound `traceparent`
                    # names the request's trace; without one the
                    # admission UID derives a deterministic id — either
                    # way the id rides the handler's root span, the
                    # denial log and the response envelope
                    trace_id = parse_traceparent(
                        self.headers.get("traceparent")
                    ) or derive_trace_id(request.get("uid"))
                    if (
                        outer.decision_log is not None
                        and trace_id is not None
                    ):
                        # front-door attribution: the decision record
                        # names which decode route served this admission
                        # and what it weighed
                        outer.decision_log.note_dispatch(
                            trace_id,
                            decode_route="legacy",
                            bytes_on_wire=length,
                        )
                    if self.path == "/v1/admitlabel":
                        resp = outer.label_handler.handle(request)
                    elif self.path == "/v1/admit":
                        resp = outer.handler.handle(
                            request, trace_id=trace_id
                        )
                    elif self.path == "/v1/mutate":
                        if outer.mutation_handler is None:
                            payload = json.dumps(
                                {"error": "mutation not enabled"}
                            ).encode()
                            self.send_response(404)
                            raise _Handled()
                        resp = outer.mutation_handler.handle(
                            request, trace_id=trace_id
                        )
                    elif self.path == "/v1/agent/review":
                        if outer.agent_handler is None:
                            payload = json.dumps(
                                {"error": "agent review not enabled"}
                            ).encode()
                            self.send_response(404)
                            raise _Handled()
                        resp = outer.agent_handler.handle(
                            request, trace_id=trace_id
                        )
                    else:
                        payload = json.dumps(
                            {"error": f"no endpoint {self.path}"}
                        ).encode()
                        self.send_response(404)
                        raise _Handled()
                    payload = json.dumps(
                        review_envelope(
                            review, request, resp, trace_id=trace_id
                        )
                    ).encode()
                    self.send_response(200)
                except _Handled:
                    pass
                except Exception as e:
                    payload = json.dumps({"error": str(e)}).encode()
                    self.send_response(500)
                try:
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(payload)))
                    if trace_id is not None:
                        self.send_header(
                            "traceparent", format_traceparent(trace_id)
                        )
                    self.end_headers()
                    self.wfile.write(payload)
                except (BrokenPipeError, ConnectionResetError):
                    # client gave up (its own timeout) mid-response —
                    # nothing to salvage, and the handler thread must
                    # not die noisily
                    pass

            def log_message(self, *args):  # silence default stderr spam
                pass

        class _Server(ThreadingHTTPServer):
            # the stdlib default backlog (5) resets bursts of
            # concurrent connections — exactly the micro-batching
            # workload; deep enough for a full batch window
            request_queue_size = 512
            daemon_threads = True

            def finish_request(self, request, client_address):
                # TLS: the handshake runs here, on the connection's
                # thread (OpenSSL releases the GIL), not in accept()
                handshake = getattr(request, "do_handshake", None)
                if handshake is not None:
                    try:
                        handshake()
                    except OSError:  # ssl.SSLError included
                        return
                super().finish_request(request, client_address)

        self._httpd = _Server((bind_addr, port), _Handler)
        self.rotator = rotator
        self._ssl_ctx = None
        if tls:
            import ssl
            import tempfile

            from .certs import CertRotator

            if self.rotator is None:
                if cert_dir is None:
                    cert_dir = tempfile.mkdtemp(prefix="gk-certs-")
                self.rotator = CertRotator(cert_dir)
            cert_path, key_path = self.rotator.ensure()  # CertsMounted gate
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(cert_path, key_path)
            self._ssl_ctx = ctx
            self._httpd.socket = ctx.wrap_socket(
                self._httpd.socket, server_side=True,
                do_handshake_on_connect=False,
            )
            # rotation pickup without restart: SSLContext is live — a
            # re-load swaps the pair for every handshake AFTER this
            # point while established connections finish on the old one
            on_rotate = getattr(self.rotator, "on_rotate", None)
            if on_rotate is not None:
                on_rotate(self._reload_tls)
        self.scheme = "https" if tls else "http"
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None
        self.warm = False

    def _reload_tls(self) -> None:
        if self._ssl_ctx is None or self.rotator is None:
            return
        try:
            self._ssl_ctx.load_cert_chain(
                self.rotator.cert_path, self.rotator.key_path
            )
        except Exception:
            # a torn read is impossible (atomic-rename installs), but a
            # rotation racing deletion must not kill serving — the old
            # pair keeps serving until the next successful reload
            pass

    def start(self) -> None:
        self.batcher.start()
        if self.mutate_batcher is not None:
            self.mutate_batcher.start()
        if self.agent_batcher is not None:
            self.agent_batcher.start()
        if self.agent_mutate_batcher is not None:
            self.agent_mutate_batcher.start()
        if self.ingest is not None:
            self.ingest.start()
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()

    def warmup(self, sample_objects=None, targets=None) -> float:
        """Run the fused review path once per common batch shape so the
        first real admission request finds the driver's policy staged:
        for each of `targets` (default review_targets(): the validation
        plane's target and, with the agent plane on, the agent target,
        from its own sample tool calls). `sample_objects` replaces the
        validation target's samples. Returns seconds spent."""
        from ..constraint.handler import handler_for

        t0 = time.monotonic()
        # The attribute/callable resolution stays OUTSIDE the try; only
        # the warm run itself is best-effort.
        warm = self.client.warm_review_path
        for target in self.review_targets() if targets is None else targets:
            handler = handler_for(self.client, target)
            # the target supplies shape-covering synthetic requests
            if target == self.batcher.target and sample_objects is not None:
                requests = sample_objects
            else:
                requests = handler.sample_requests(192)
            reviews = [handler.augment_request(r) for r in requests]
            for batch in (reviews[:16], reviews[:100], reviews):
                try:
                    warm(batch)
                except Exception:
                    pass  # warmup is best-effort; serving works unwarmed
        self.warm = True
        return time.monotonic() - t0

    def review_targets(self) -> List[str]:
        """The targets this server's review planes dispatch: the
        validation plane's and, with the agent plane on, the agent's."""
        out = [self.batcher.target]
        if self.agent_batcher is not None:
            out.append(self.agent_batcher.target)
        return out

    def sched_snapshot(self) -> Dict[str, Any]:
        """Per-plane admission-scheduler state (the reference's
        `/readyz` `stats.sched` and `/debug/sched` document)."""
        out = {"validation": self.batcher.sched.snapshot()}
        if self.mutate_batcher is not None:
            out["mutation"] = self.mutate_batcher.sched.snapshot()
        if self.agent_batcher is not None:
            out["agent"] = self.agent_batcher.sched.snapshot()
        if self.agent_mutate_batcher is not None:
            out["agent_mutation"] = (
                self.agent_mutate_batcher.sched.snapshot()
            )
        return out

    # -- graceful drain ------------------------------------------------------

    @property
    def ready(self) -> bool:
        """Serving readiness: False from the instant a drain begins —
        the signal a load balancer / kubelet readiness probe needs
        BEFORE the listener goes away."""
        return not self.draining

    def on_drain(self, callback: Callable[[], None]) -> None:
        """Register a callback fired when draining flips (before the
        listener closes)."""
        self._drain_callbacks.append(callback)

    def begin_drain(self) -> None:
        """Flip not-ready. Idempotent; does NOT close anything — the
        listener keeps accepting (and the batcher keeps evaluating)
        until stop() proceeds, so a request racing the flip still gets
        a real answer instead of a reset."""
        if self.draining:
            return
        self.draining = True
        for cb in list(self._drain_callbacks):
            try:
                cb()
            except Exception:
                pass  # observers must not be able to wedge the drain

    def _await_inflight(self, timeout: float) -> bool:
        deadline = time.monotonic() + timeout
        with self._inflight_cv:
            while self._inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._inflight_cv.wait(timeout=min(remaining, 0.1))
        return True

    def stop(self, drain_grace_s: Optional[float] = None) -> None:
        """Graceful shutdown, in the only order that sheds zero
        accepted requests: (1) readiness flips not-ready, (2) the
        drain grace lets the LB react while the listener still
        accepts, (3) the listener closes, (4) in-flight requests —
        which block on batch futures — complete because the batcher
        is STILL RUNNING, and only then (5) the batcher stops
        (dispatching any leftovers inline) and the socket is released."""
        grace = self.drain_grace_s if drain_grace_s is None else drain_grace_s
        self.begin_drain()
        if grace > 0:
            time.sleep(grace)
        self._httpd.shutdown()
        if self.ingest is not None:
            # stop NEW frames; accepted ones are in _inflight below
            self.ingest.stop_accepting()
        # bounded by the request envelope: no accepted request can
        # legitimately outlive its own timeout + a dispatch window
        self._await_inflight(min(self.request_timeout + 1.0, 15.0))
        if self.ingest is not None:
            self.ingest.close()
        self.batcher.stop()
        if self.mutate_batcher is not None:
            self.mutate_batcher.stop()
        if self.agent_batcher is not None:
            self.agent_batcher.stop()
        if self.agent_mutate_batcher is not None:
            self.agent_mutate_batcher.stop()
        if self.partitioner is not None:
            self.partitioner.close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        # release the listening socket fd: a harness that restarts
        # servers repeatedly must not leak one fd per lifecycle
        try:
            self._httpd.server_close()
        except Exception:
            pass
