"""Observability: the in-process tracer the audit manager and the webhook
record their spans into, and the W3C traceparent helpers the webhook
server reads (a subset of gatekeeper_tpu/obs)."""

from .tracer import (
    NOOP_SPAN,
    Span,
    SpanContext,
    Tracer,
    derive_trace_id,
    format_traceparent,
    parse_traceparent,
    start_span,
)

__all__ = [
    "NOOP_SPAN", "Span", "SpanContext", "Tracer", "derive_trace_id",
    "format_traceparent", "parse_traceparent", "start_span",
]
