# Copied from gatekeeper_tpu/metrics/__init__.py; no line below differs.
"""Metrics registry + Prometheus text exposition.

Counterpart of pkg/metrics/ (OpenCensus views -> Prometheus exporter on
:8888, exporter.go:26, prometheus_exporter.go:17-40) and the per-package
stats reporters (webhook/audit/controller stats_reporter.go files). The
metric names follow the reference's docs/Metrics.md catalogue:
request_count, request_duration_seconds, violations,
audit_duration_seconds, audit_last_run_time, constraints,
constraint_templates, sync, watch_manager_* — tagged with the same
label keys (admission_status, enforcement_action, status, ...).

Latency distributions (`*_seconds`) expose as REAL Prometheus
histograms — cumulative `_bucket{le=...}` series plus `_min`/`_max`
gauge companions — so p50/p99 are recoverable from /metrics
(docs/metrics.md). The full emitted-name set is contract-tested
against docs/metrics.md by tests/test_metrics_contract.py.
"""

from .registry import (  # noqa: F401
    DEFAULT_LATENCY_BUCKETS,
    MetricsRegistry,
    serve_metrics,
)
