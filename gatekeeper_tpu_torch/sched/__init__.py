# Copied from gatekeeper_tpu/sched/__init__.py; no line below differs.
"""SLO-aware admission scheduling (docs/operations.md §Admission
scheduling).

The subsystem that closes the measurement→control loop ROADMAP item 3
left open: `AdmissionScheduler` replaces the FIFO pending queue inside
every `MicroBatcher` (validation, mutation, agent planes) with
deadline-aware batch formation, predictive shedding, and per-tenant
fair-share quotas fed by `SloEngine.autoscaler()` saturation.

Policy `"fifo"` (the default, and the rollback path for
`--sched-policy`) is bit-compatible with the pre-scheduler queue:
arrival-order batches, `queue_full` shedding of the newest arrival at
`max_queue`. Policy `"deadline"` turns the subsystem on.
"""

from .scheduler import (
    POLICIES,
    AdmissionScheduler,
    BatchCostModel,
    TokenBucket,
    export_sched,
    fair_shares,
)

__all__ = [
    "POLICIES",
    "AdmissionScheduler",
    "BatchCostModel",
    "TokenBucket",
    "export_sched",
    "fair_shares",
]
