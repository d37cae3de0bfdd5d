"""Observability: the in-process tracer the audit manager and the webhook
record their spans into, the W3C traceparent helpers the webhook server
reads, the per-admission decision log and the live SLO engine that feeds
the admission scheduler, the per-constraint device-time cost attributor and
the trip-triggered flight recorder (gatekeeper_tpu/obs's modules)."""

from .attribution import CostAttributor
from .decisionlog import (
    DECISION_SCHEMA_FIELDS,
    DecisionLog,
    check_decision_schema,
)
from .flightrecorder import FlightRecorder
from .slo import QuantileSketch, SloEngine, SloTarget, export_slo
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
    "CostAttributor", "DECISION_SCHEMA_FIELDS", "DecisionLog", "FlightRecorder", "NOOP_SPAN", "QuantileSketch",
    "SloEngine", "SloTarget", "Span", "SpanContext", "Tracer",
    "check_decision_schema", "derive_trace_id", "export_slo",
    "format_traceparent", "parse_traceparent", "start_span",
]
