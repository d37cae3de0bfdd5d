"""Control-plane pieces the audit manager's direct-list mode reads: the
list+watch event fabric with its in-memory cluster, and the process
excluder (a subset of gatekeeper_tpu/control)."""

from .events import ADDED, DELETED, GVK, MODIFIED, Event, EventSource, FakeCluster
from .process import (
    PROCESS_AUDIT,
    PROCESS_STAR,
    PROCESS_SYNC,
    PROCESS_WEBHOOK,
    Excluder,
)

__all__ = [
    "ADDED", "DELETED", "GVK", "MODIFIED", "Event", "EventSource",
    "FakeCluster", "PROCESS_AUDIT", "PROCESS_STAR", "PROCESS_SYNC",
    "PROCESS_WEBHOOK", "Excluder",
]
