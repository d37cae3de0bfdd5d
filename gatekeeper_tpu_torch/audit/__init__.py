# Copied from gatekeeper_tpu/audit/__init__.py; unchanged.
"""Audit workload: the periodic full-state sweep.

Counterpart of the reference's audit manager (pkg/audit/manager.go).
Where the reference's default path interprets one Rego query per cluster
object per sweep (manager.go:299-327 — the throughput hot loop), this
manager drives the whole sweep through one batched `Client.audit()` call
(the TPU driver's fused kernel dispatch), then applies the same
aggregation contract: per-constraint violation cap, message truncation,
and status publication with timestamps.
"""

from .manager import (  # noqa: F401
    AuditManager,
    AuditReport,
    ConstraintStatus,
    InMemorySink,
    StatusSink,
    Violation,
    truncate_message,
)
