# Copied from gatekeeper_tpu/obs/tracer.py; only these edits differ.
# Edit: Tracer.size/clear and span_breakdown are left out (they serve the
# soak plane and the bench, ROADMAP A10); of the OTLP id helpers only
# _otlp_id, which format_traceparent and export_otlp read, is kept.
"""In-process request tracing: spans, traces, ring-buffer retention.

The enforcement plane must be able to account for every decision it
makes (EHV's runtime-monitor accounting, arxiv 2605.17909): a slow
AdmissionReview needs to name its cost center — batch queue wait vs
flatten/encode vs XLA compile vs device execution vs violation render.
This module is the lightweight, dependency-free tracer that carries
that attribution: OpenTelemetry's span model (trace_id / span_id /
parent links / attributes) without the SDK, exported as plain JSON at
`/debug/traces` and correlated into denial logs via `trace_id`
(`StructuredLogger.with_values`).

Design constraints that shaped it:
  * the hot path is the admission handler — span start/finish is a
    dict append under one lock, no I/O, no serialization;
  * requests cross threads (handler thread -> micro-batch worker ->
    back), so spans parent two ways: implicitly from a thread-local
    stack (nested `with` blocks on one thread), or explicitly from a
    `SpanContext` carried across the queue (`record_span`);
  * one fused batch dispatch serves many requests — the batcher
    records the SAME timing window as a span into every member
    request's trace, so each trace is self-contained;
  * retention is a bounded ring (completed traces) — tracing is always
    on and must never become the memory leak it exists to diagnose.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import re
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional

# W3C Trace Context (https://www.w3.org/TR/trace-context/): version 00,
# 32 lowercase-hex trace id, 16 lowercase-hex parent id, 2-hex flags.
# All-zero ids are explicitly invalid per spec.
_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$"
)


def parse_traceparent(header: Optional[str]) -> Optional[str]:
    """The trace id from a W3C `traceparent` header, or None when the
    header is absent/malformed (an invalid header MUST be ignored per
    spec — the request then gets a derived or fresh trace id)."""
    if not header:
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if m is None or m.group(1) == "ff":
        return None
    tid = m.group(2)
    if tid == "0" * 32 or m.group(3) == "0" * 16:
        return None
    return tid


def derive_trace_id(seed: Optional[str]) -> Optional[str]:
    """Deterministic 32-hex trace id from a stable request identity
    (the admission UID): a caller that sent no `traceparent` still gets
    a trace id any hop holding the same UID can reconstruct."""
    if not seed:
        return None
    return hashlib.sha256(str(seed).encode()).hexdigest()[:32]


def format_traceparent(trace_id: str, span_seed: str = "") -> str:
    """A well-formed `traceparent` response header for `trace_id`
    (padded/derived to 32 hex); the parent-id half is derived — this
    engine's span ids are not 16-hex, and the header only needs to name
    the trace, not a resumable span."""
    tid = _otlp_id(trace_id, 32)
    sid = hashlib.sha256((trace_id + span_seed).encode()).hexdigest()[:16]
    return f"00-{tid}-{sid}-01"


def _otlp_id(raw: Optional[str], width: int) -> str:
    """Map an internal id to the fixed-width lowercase-hex form OTLP
    requires: ids that are already hex (W3C-ingested trace ids) pass
    through zero-padded; everything else hashes deterministically."""
    if not raw:
        return "0" * width
    s = str(raw).lower()
    if re.fullmatch(r"[0-9a-f]+", s) and len(s) <= width:
        return s.zfill(width)
    return hashlib.sha256(s.encode()).hexdigest()[:width]


class SpanContext(NamedTuple):
    """The cross-thread handle: enough to parent a child span."""

    trace_id: str
    span_id: str


class Span:
    """One timed operation. Use as a context manager (enter starts the
    clock and pushes onto the thread-local stack; exit records) or let
    the tracer record pre-timed windows via `record_span`."""

    __slots__ = (
        "tracer", "name", "trace_id", "span_id", "parent_id",
        "start", "_t0", "end", "attrs", "status",
    )

    def __init__(self, tracer, name, trace_id, span_id, parent_id, attrs):
        self.tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.attrs: Dict[str, Any] = attrs
        self.start: float = 0.0
        self._t0: float = 0.0
        self.end: float = 0.0
        self.status = "ok"

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def set_attr(self, **kv) -> None:
        self.attrs.update(kv)

    def __enter__(self) -> "Span":
        self.start = time.time()
        self._t0 = time.perf_counter()
        self.tracer._push(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        # wall start + perf duration: readable timestamps, monotonic
        # durations (time.time can step under NTP)
        self.end = self.start + (time.perf_counter() - self._t0)
        if exc_type is not None:
            self.status = "error"
            self.attrs.setdefault("error", str(exc))
        self.tracer._pop(self)
        self.tracer._finish(self)
        return False

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start": self.start,
            "end": self.end,
            "duration_ms": round(max(0.0, self.end - self.start) * 1e3, 3),
            "status": self.status,
            "attrs": dict(self.attrs),
        }


class _NoopSpan:
    """Stand-in when no tracer is wired: every operation is free."""

    context = None
    trace_id = None

    def set_attr(self, **kv) -> None:
        pass

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NOOP_SPAN = _NoopSpan()


def start_span(tracer: Optional["Tracer"], name: str, parent=None, **attrs):
    """Tracer-optional span start: call sites stay unconditional
    (`with start_span(self.tracer, "dispatch") as sp:`) whether or not
    tracing is wired."""
    if tracer is None:
        return NOOP_SPAN
    return tracer.start_span(name, parent=parent, **attrs)


class Tracer:
    """Span recorder with bounded retention.

    Completed traces (every span finished) move to a ring buffer of
    `max_traces`; a trace is also force-completed at
    `max_spans_per_trace` so a leaked open span cannot pin memory.
    """

    def __init__(self, max_traces: int = 256,
                 max_spans_per_trace: int = 256):
        self.max_traces = max_traces
        self.max_spans_per_trace = max_spans_per_trace
        self._lock = threading.Lock()
        # trace_id -> {"spans": [dict], "open": int}
        self._active: Dict[str, Dict[str, Any]] = {}
        self._ring: List[Dict[str, Any]] = []
        self._ids = itertools.count(1)
        self._local = threading.local()

    # -- id allocation -------------------------------------------------------

    def _new_id(self, kind: str) -> str:
        return f"{kind}{next(self._ids):08x}"

    # -- thread-local current-span stack -------------------------------------

    def _stack(self) -> List[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _push(self, span: Span) -> None:
        self._stack().append(span)

    def _pop(self, span: Span) -> None:
        st = self._stack()
        if st and st[-1] is span:
            st.pop()

    def current(self) -> Optional[Span]:
        st = self._stack()
        return st[-1] if st else None

    # -- span lifecycle ------------------------------------------------------

    def start_span(self, name: str, parent=None, trace_id=None,
                   **attrs) -> Span:
        """New span. Parent resolution: explicit `parent`
        (Span/SpanContext) wins; else the calling thread's innermost
        open span; else a fresh trace root."""
        ctx = getattr(parent, "context", parent)
        if ctx is None:
            cur = self.current()
            ctx = cur.context if cur is not None else None
        if ctx is not None:
            tid, parent_id = ctx.trace_id, ctx.span_id
        else:
            tid, parent_id = trace_id or self._new_id("t"), None
        span = Span(self, name, tid, self._new_id("s"), parent_id, attrs)
        with self._lock:
            ent = self._active.setdefault(tid, {"spans": [], "open": 0})
            ent["open"] += 1
        return span

    def record_span(self, name: str, start: float, end: float,
                    parent=None, trace_id=None, status: str = "ok",
                    **attrs) -> Optional[SpanContext]:
        """Record an already-timed window (the cross-thread form: the
        batch worker stamps queue-wait/dispatch spans into each member
        request's trace). Returns the new span's context so callers can
        hang children off it."""
        ctx = getattr(parent, "context", parent)
        if ctx is not None:
            tid, parent_id = ctx.trace_id, ctx.span_id
        elif trace_id is not None:
            tid, parent_id = trace_id, None
        else:
            return None
        span = Span(self, name, tid, self._new_id("s"), parent_id, attrs)
        span.start, span.end, span.status = start, end, status
        # registered=False: this span never incremented the trace's
        # open count (start_span does), so it must not decrement it —
        # otherwise a worker stamping batch spans into a request trace
        # would flush the trace out from under its still-open root
        self._finish(span, registered=False)
        return span.context

    def record_window(self, name: str, wall_start: float,
                      perf_start: float, parent=None, trace_id=None,
                      status: str = "ok", **attrs) -> Optional[SpanContext]:
        """record_span for callers holding a (wall, perf_counter) start
        pair: the end stamp is wall_start + the PERF-measured elapsed
        time, so the span's duration is monotonic (an NTP step between
        the two reads cannot stretch or invert it) while its timestamps
        stay wall-readable — the same hybrid Span.__exit__ uses."""
        end = wall_start + (time.perf_counter() - perf_start)
        return self.record_span(
            name, wall_start, end, parent=parent, trace_id=trace_id,
            status=status, **attrs,
        )

    def _finish(self, span: Span, registered: bool = True) -> None:
        with self._lock:
            ent = self._active.get(span.trace_id)
            if ent is None:
                # late span on a flushed trace (out-of-order finish):
                # attach if the trace is still in the ring
                for tr in reversed(self._ring):
                    if tr["trace_id"] == span.trace_id:
                        if len(tr["spans"]) < self.max_spans_per_trace:
                            tr["spans"].append(span.to_dict())
                        return
                # unknown trace id: a standalone recorded span becomes
                # its own one-shot trace
                ent = self._active.setdefault(
                    span.trace_id, {"spans": [], "open": 1}
                )
                registered = True
            if len(ent["spans"]) < self.max_spans_per_trace:
                ent["spans"].append(span.to_dict())
            if registered:
                ent["open"] = max(0, ent["open"] - 1)
            if ent["open"] == 0 or (
                len(ent["spans"]) >= self.max_spans_per_trace
            ):
                self._flush_locked(span.trace_id, ent)

    def _flush_locked(self, trace_id: str, ent: Dict[str, Any]) -> None:
        self._active.pop(trace_id, None)
        if not ent["spans"]:
            return
        self._ring.append({"trace_id": trace_id, "spans": ent["spans"]})
        if len(self._ring) > self.max_traces:
            del self._ring[: len(self._ring) - self.max_traces]

    # -- read ----------------------------------------------------------------

    def recent(self, n: int = 50) -> List[Dict[str, Any]]:
        """Most-recent completed traces, newest first."""
        with self._lock:
            return [
                {"trace_id": t["trace_id"], "spans": list(t["spans"])}
                for t in self._ring[-n:][::-1]
            ]

    def get(self, trace_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            for t in reversed(self._ring):
                if t["trace_id"] == trace_id:
                    return {"trace_id": trace_id, "spans": list(t["spans"])}
        return None

    def export_json(self, n: int = 50, trace_id: Optional[str] = None) -> str:
        """JSON export of the ring; `trace_id` narrows to one trace
        (empty list when it is not retained) — the `/debug/traces?
        trace_id=` lookup both HTTP planes serve."""
        if trace_id is not None:
            t = self.get(trace_id)
            return json.dumps({"traces": [t] if t is not None else []})
        return json.dumps({"traces": self.recent(n)})

    def export_otlp(self, n: int = 50, trace_id: Optional[str] = None) -> str:
        """OTLP-JSON span export (`/debug/traces?format=otlp`): the ring
        rendered as one resourceSpans/scopeSpans document an OTLP
        collector's JSON receiver ingests directly. Internal ids map to
        the 128/64-bit hex forms OTLP requires (W3C-ingested trace ids
        pass through unchanged); span attrs become stringValue
        attributes."""
        if trace_id is not None:
            t = self.get(trace_id)
            traces = [t] if t is not None else []
        else:
            traces = self.recent(n)
        spans = []
        for tr in traces:
            tid = _otlp_id(tr["trace_id"], 32)
            for sp in tr.get("spans", []):
                spans.append({
                    "traceId": tid,
                    "spanId": _otlp_id(sp.get("span_id"), 16),
                    "parentSpanId": (
                        _otlp_id(sp["parent_id"], 16)
                        if sp.get("parent_id")
                        else ""
                    ),
                    "name": sp.get("name", ""),
                    "kind": 1,  # SPAN_KIND_INTERNAL
                    "startTimeUnixNano": str(
                        int(sp.get("start", 0.0) * 1e9)
                    ),
                    "endTimeUnixNano": str(int(sp.get("end", 0.0) * 1e9)),
                    "status": {
                        "code": 2 if sp.get("status") == "error" else 1
                    },
                    "attributes": [
                        {
                            "key": str(k),
                            "value": {"stringValue": str(v)},
                        }
                        for k, v in (sp.get("attrs") or {}).items()
                    ],
                })
        return json.dumps({
            "resourceSpans": [{
                "resource": {
                    "attributes": [{
                        "key": "service.name",
                        "value": {"stringValue": "gatekeeper-tpu"},
                    }],
                },
                "scopeSpans": [{
                    "scope": {"name": "gatekeeper_tpu.obs"},
                    "spans": spans,
                }],
            }],
        })
