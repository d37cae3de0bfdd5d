# Copied from gatekeeper_tpu/fleet/__init__.py; unchanged.
"""Fleet plane: the subsystem that turns per-process state into fleet
state, unblocking multi-replica HA webhook serving (docs/fleet.md,
ROADMAP item 2).

Three legs, one seam (`control.events.EventSource`, so everything runs
identically against the FakeCluster and a live apiserver):

  * `SecretCertStore` + `FleetCertRotator` — the Secret-backed shared
    cert store: load-or-create with conflict retry (losers adopt the
    winner's CA), peers pick rotation up from the watch WITHOUT restart
    (pkg/webhook/certs.go:119-181 behaviorally);
  * `FleetPlane` — CR-backed gossip for the external-data response
    cache (N replicas stop paying N× cold fetches) and circuit-breaker
    trips (an outage one replica discovered pre-opens peers to a
    half-open probe).
"""

from .certs import FleetCertRotator
from .plane import FLEETSTATE_GVK, FleetPlane
from .store import (
    CertRecord,
    DEFAULT_SECRET_NAME,
    GENERATION_ANNOTATION,
    SECRET_GVK,
    SecretCertStore,
)

__all__ = [
    "CertRecord",
    "DEFAULT_SECRET_NAME",
    "FLEETSTATE_GVK",
    "FleetCertRotator",
    "FleetPlane",
    "GENERATION_ANNOTATION",
    "SECRET_GVK",
    "SecretCertStore",
]
