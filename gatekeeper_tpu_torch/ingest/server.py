# Copied from gatekeeper_tpu/ingest/server.py; unchanged.
"""IngestServer: frames in, verdict envelopes out (docs/ingest.md).

Glue between the framed transport and the existing admission planes.
Each request frame is served on the listener's worker pool:

    decode (zero-copy scanner, json.loads fallback)
      -> ingest_decode span recorded into the request's trace
      -> decision facts stamped (decode_route, bytes_on_wire)
      -> the SAME synchronous handler the legacy HTTP path calls
         (BatchedValidationHandler.handle -> MicroBatcher.submit ->
          AdmissionScheduler.offer) with the frame's deadline budget
      -> review_envelope JSON back in a response frame

Routing through the identical handler objects is what makes framed
verdicts byte-identical to legacy HTTP ones — the transport and the
decoder are the only things that change. Zero-copy decode applies to
validation frames only: the mutation plane rewrites `request.object`,
so its frames take the plain `json.loads` route (route "legacy"), as
do agent and namespace-label frames (tiny envelopes, nothing to lift).
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, Optional, Tuple

from ..obs import derive_trace_id
from .decode import decode_review
from .transport import (
    DEFAULT_MAX_FRAME,
    DEFAULT_MAX_INFLIGHT,
    FLAG_DEADLINE,
    Frame,
    PLANE_AGENT,
    PLANE_LABEL,
    PLANE_MUTATE,
    PLANE_VALIDATE,
    StreamListener,
)

__all__ = ["IngestServer"]


class IngestServer:
    """Framed-stream front door for one WebhookServer. Owns a
    StreamListener; serves frames through the webhook's own handler
    objects. Rollback is `--ingest off`: nothing here is load-bearing
    for the legacy HTTP path."""

    def __init__(
        self,
        webhook,
        host: str = "127.0.0.1",
        port: int = 0,
        max_frame: int = DEFAULT_MAX_FRAME,
        max_inflight: int = DEFAULT_MAX_INFLIGHT,
        workers: int = 64,
        decode: str = "zerocopy",  # "zerocopy" | "json"
        metrics=None,
        tracer=None,
        decision_log=None,
    ):
        self.webhook = webhook
        self.decode = decode
        self.metrics = metrics
        self.tracer = tracer
        self.decision_log = decision_log
        self._dlock = threading.Lock()
        self._decode_stats = {
            "zerocopy": 0, "fallback": 0, "legacy": 0, "materialized": 0,
        }
        self.listener = StreamListener(
            self._serve_frame,
            host=host,
            port=port,
            max_frame=max_frame,
            max_inflight=max_inflight,
            workers=workers,
            metrics=metrics,
        )
        self.port = self.listener.port

    def start(self) -> None:
        self.listener.start()

    def stop_accepting(self) -> None:
        self.listener.stop_accepting()

    def close(self) -> None:
        self.listener.close()

    def stats(self) -> Dict[str, Any]:
        with self._dlock:
            decode = dict(self._decode_stats)
        out = self.listener.stats()
        out["decode"] = decode
        out["port"] = self.port
        return out

    # -- per-frame serve path (listener worker pool) -------------------------

    def _count_decode(self, key: str) -> None:
        with self._dlock:
            self._decode_stats[key] += 1

    def _on_materialize(self) -> None:
        self._count_decode("materialized")
        if self.metrics is not None:
            self.metrics.record("ingest_lazy_materialize_total", 1)

    def _serve_frame(self, frame: Frame) -> Tuple[int, bytes]:
        webhook = self.webhook
        # the webhook's in-flight accounting covers framed admissions
        # too: stop() waits for accepted frames before the batchers die
        with webhook._inflight_cv:
            webhook._inflight += 1
        try:
            return self._serve_locked(frame)
        finally:
            with webhook._inflight_cv:
                webhook._inflight -= 1
                webhook._inflight_cv.notify_all()

    def _serve_locked(self, frame: Frame) -> Tuple[int, bytes]:
        from ..webhook.server import review_envelope

        webhook = self.webhook
        nbytes = len(frame.payload)
        zerocopy = (
            self.decode == "zerocopy" and frame.ftype == PLANE_VALIDATE
        )
        wall0 = time.time()
        t0 = time.perf_counter()
        try:
            review, route, reason = decode_review(
                frame.payload,
                zerocopy=zerocopy,
                on_materialize=self._on_materialize,
            )
        except Exception as e:
            # json.loads itself rejected the payload: same 500-shaped
            # answer the legacy HTTP body path gives
            if self.metrics is not None:
                self.metrics.record(
                    "ingest_decode_fallback_total", 1, reason="unparseable"
                )
            return 500, json.dumps({"error": str(e)}).encode("utf-8")
        dt = time.perf_counter() - t0
        self._count_decode(route)
        if self.metrics is not None:
            self.metrics.observe(
                "ingest_decode_seconds", dt, route=route
            )
            if route == "fallback":
                self.metrics.record(
                    "ingest_decode_fallback_total", 1,
                    reason=reason or "unknown",
                )
        if not isinstance(review, dict):
            return 500, json.dumps(
                {"error": "AdmissionReview payload is not an object"}
            ).encode("utf-8")
        request = review.get("request") or {}
        trace_id = derive_trace_id(request.get("uid"))
        if self.tracer is not None and trace_id is not None:
            # lands next to device_execute in the request's trace: the
            # handler's root span below shares the same trace id
            self.tracer.record_span(
                "ingest_decode", wall0, wall0 + dt,
                trace_id=trace_id,
                route=route,
                bytes_on_wire=nbytes,
            )
        if self.decision_log is not None and trace_id is not None:
            self.decision_log.note_dispatch(
                trace_id, decode_route=route, bytes_on_wire=nbytes
            )
        deadline: Optional[float] = None
        if frame.flags & FLAG_DEADLINE and frame.budget > 0:
            deadline = time.monotonic() + frame.budget / 1000.0
        try:
            if frame.ftype == PLANE_LABEL:
                resp = webhook.label_handler.handle(request)
            elif frame.ftype == PLANE_MUTATE:
                if webhook.mutation_handler is None:
                    return 404, json.dumps(
                        {"error": "mutation not enabled"}
                    ).encode("utf-8")
                resp = webhook.mutation_handler.handle(
                    request, trace_id=trace_id
                )
            elif frame.ftype == PLANE_AGENT:
                if webhook.agent_handler is None:
                    return 404, json.dumps(
                        {"error": "agent review not enabled"}
                    ).encode("utf-8")
                resp = webhook.agent_handler.handle(
                    request, trace_id=trace_id
                )
            else:
                with webhook.handler.deadline_scope(deadline):
                    resp = webhook.handler.handle(
                        request, trace_id=trace_id
                    )
        except Exception as e:
            return 500, json.dumps({"error": str(e)}).encode("utf-8")
        payload = json.dumps(
            review_envelope(review, request, resp, trace_id=trace_id)
        ).encode("utf-8")
        return 200, payload
