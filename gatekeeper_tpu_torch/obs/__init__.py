"""Observability: the in-process tracer the audit manager records its
sweep spans into (a subset of gatekeeper_tpu/obs)."""

from .tracer import NOOP_SPAN, Span, SpanContext, Tracer, start_span

__all__ = ["NOOP_SPAN", "Span", "SpanContext", "Tracer", "start_span"]
