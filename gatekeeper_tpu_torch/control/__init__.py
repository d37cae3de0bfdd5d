"""Control plane: state ingestion, readiness, process runtime (a copy of
gatekeeper_tpu/control).

The reference's equivalents live under pkg/controller/, pkg/watch/,
pkg/readiness/, and main.go; here the same architecture runs against an
`EventSource` (a fake in-memory cluster or a real apiserver adapter):
cluster -> WatchManager -> controllers -> constraint-framework Client,
with the ReadinessTracker gating /readyz and `Runner` as the
main()-equivalent.
"""

from .process import (
    PROCESS_AUDIT,
    PROCESS_STAR,
    PROCESS_SYNC,
    PROCESS_WEBHOOK,
    Excluder,
)
from .readiness import ReadinessTracker
from .events import (
    ADDED,
    DELETED,
    GVK,
    MODIFIED,
    Event,
    EventSource,
    FakeCluster,
)
from .kubecluster import KubeCluster, KubeError
from .watch import Registrar, WatchManager
from .controllers import (
    CONFIG_GVK,
    MUTATOR_GVKS,
    MutatorController,
    PROVIDER_GVK,
    TEMPLATE_GVK,
    ConfigController,
    ConstraintController,
    ControllerSwitch,
    ProviderController,
    SyncController,
    TemplateController,
    constraint_gvk,
)
from .status import StatusAggregator, StatusWriter
from .upgrade import UpgradeManager
from .runner import (
    ALL_OPERATIONS,
    OPERATION_AUDIT,
    OPERATION_STATUS,
    OPERATION_WEBHOOK,
    Runner,
    load_yaml_dir,
)

__all__ = [
    "ADDED", "ALL_OPERATIONS", "CONFIG_GVK", "ConfigController",
    "ConstraintController", "ControllerSwitch", "DELETED", "Event",
    "EventSource", "Excluder", "FakeCluster", "GVK", "KubeCluster",
    "KubeError", "MODIFIED", "MUTATOR_GVKS", "MutatorController",
    "OPERATION_AUDIT", "OPERATION_STATUS",
    "OPERATION_WEBHOOK", "PROCESS_AUDIT", "PROCESS_STAR", "PROCESS_SYNC",
    "PROCESS_WEBHOOK", "PROVIDER_GVK", "ProviderController",
    "ReadinessTracker", "Registrar", "Runner", "StatusAggregator",
    "StatusWriter", "SyncController", "TEMPLATE_GVK", "TemplateController",
    "UpgradeManager", "WatchManager", "constraint_gvk", "load_yaml_dir",
]
