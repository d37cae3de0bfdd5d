# Copied from gatekeeper_tpu/fleet/plane.py; unchanged.
"""FleetPlane: CR-backed gossip turning per-process caches and breakers
into fleet state.

Each replica owns ONE `FleetState` CR (named by its replica id) and
watches the whole kind through the `EventSource` seam. Outbound: a
debounced publisher thread serializes the replica's shareable state —
fresh local-origin external-data cache entries (`ResponseCache.
export_fresh`) and the current state of every registered circuit
breaker — and `apply()`s it. Inbound: peers' CR writes arrive as watch
events and merge:

  * cache entries adopt iff fresher than what we hold, with relative
    ages so TTL / negative / stale-while-revalidate windows survive the
    clock hop (`ResponseCache.merge`); adopted entries carry the peer's
    id as origin and are never re-published from here (no echo loops);
  * breaker states adopt via `CircuitBreaker.adopt`: a peer's OPEN
    pre-opens the local breaker to HALF_OPEN — the next batch is a
    single probe instead of `failure_threshold` full batches
    rediscovering an outage the fleet already paid for; a peer's
    CLOSED lets an OPEN local breaker probe early.

Everything is best-effort: a publish failure is counted and retried on
the next dirty wake (serving never blocks on the state plane), and a
cluster without the FleetState CRD degrades to exactly the old
per-process behavior.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Set

from ..control.events import DELETED, GVK
from ..logs import null_logger

FLEET_GROUP = "fleet.gatekeeper.sh"
FLEET_VERSION = "v1alpha1"
FLEETSTATE_GVK = GVK(FLEET_GROUP, FLEET_VERSION, "FleetState")

DEFAULT_NAMESPACE = "gatekeeper-system"


class FleetPlane:
    def __init__(
        self,
        cluster,
        replica_id: str,
        namespace: str = DEFAULT_NAMESPACE,
        metrics=None,
        logger=None,
        publish_interval_s: float = 0.25,
        max_published_entries: int = 512,
    ):
        self.cluster = cluster
        self.replica_id = replica_id
        self.namespace = namespace
        self.metrics = metrics
        self.log = logger if logger is not None else null_logger()
        self.publish_interval_s = publish_interval_s
        self.max_published_entries = max_published_entries
        self._lock = threading.Lock()
        self._breakers: Dict[str, Any] = {}
        self._peers: Set[str] = set()
        self._cache_system = None
        self.cache_merged = 0
        self.breaker_adoptions = 0
        self.publishes = 0
        self.publish_failures = 0
        self._dirty = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._unsubscribe: Optional[Callable[[], None]] = None
        self.started = False

    # -- attachment ------------------------------------------------------------

    def attach_cache(self, system) -> None:
        """Wire an ExternalDataSystem: its cache entries publish, peers'
        merge in, and its per-provider breakers gossip (the system calls
        register_breaker as providers upsert)."""
        self._cache_system = system
        set_fleet = getattr(system, "set_fleet", None)
        if set_fleet is not None:
            set_fleet(self)

    def register_breaker(self, name: str, breaker) -> None:
        """Track a breaker under a fleet-wide name (`device:validation`,
        `provider:<name>`, ...). Its transitions mark the plane dirty so
        trips reach peers within one publish interval."""
        with self._lock:
            if self._breakers.get(name) is breaker:
                return
            self._breakers[name] = breaker
        subscribe = getattr(breaker, "subscribe", None)
        if subscribe is not None:
            subscribe(lambda _f, _t: self._dirty.set())
        self._dirty.set()

    def unregister_breaker(self, name: str) -> None:
        with self._lock:
            self._breakers.pop(name, None)

    def notify_cache_update(self) -> None:
        """Called by the attached cache system after a successful fetch
        populated new entries — wakes the debounced publisher."""
        self._dirty.set()

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> None:
        if self.started:
            return
        self.started = True
        self._unsubscribe = self.cluster.subscribe(
            FLEETSTATE_GVK, self._on_event
        )
        # merge whatever peers already published (informer initial List)
        try:
            for obj in self.cluster.list(FLEETSTATE_GVK):
                self._merge_obj(obj)
        except Exception as e:
            self.log.error(
                "fleet state list failed", process="fleet", err=e
            )
        self.publish()
        self._thread = threading.Thread(
            target=self._loop, name="gk-fleet-publisher", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._dirty.set()
        if self._unsubscribe is not None:
            self._unsubscribe()
            self._unsubscribe = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self.started = False

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._dirty.wait()
            if self._stop.is_set():
                return
            self._dirty.clear()
            self.publish()
            # debounce: coalesce bursts of cache fills / breaker churn
            # into one CR write per interval
            self._stop.wait(self.publish_interval_s)

    # -- outbound --------------------------------------------------------------

    def state_obj(self) -> Dict[str, Any]:
        entries: List[Dict[str, Any]] = []
        if self._cache_system is not None:
            entries = self._cache_system.cache.export_fresh(
                self.max_published_entries
            )
        with self._lock:
            breakers = [
                {"name": name, "state": b.state}
                for name, b in sorted(self._breakers.items())
            ]
        return {
            "apiVersion": f"{FLEET_GROUP}/{FLEET_VERSION}",
            "kind": "FleetState",
            "metadata": {
                "name": self.replica_id,
                "namespace": self.namespace,
            },
            "spec": {
                "replica": self.replica_id,
                "cache": entries,
                "breakers": breakers,
            },
        }

    def publish(self) -> bool:
        try:
            self.cluster.apply(self.state_obj())
        except Exception as e:
            with self._lock:
                self.publish_failures += 1
            if self.metrics is not None:
                self.metrics.record("fleet_state_publish_failures_total", 1)
            self.log.debug(
                "fleet state publish failed (degrading to per-process "
                "state)", process="fleet", err=str(e),
            )
            return False
        with self._lock:
            self.publishes += 1
        if self.metrics is not None:
            self.metrics.record("fleet_state_publishes_total", 1)
        return True

    # -- inbound ---------------------------------------------------------------

    def _on_event(self, ev) -> None:
        meta = ev.obj.get("metadata") or {}
        if meta.get("namespace") not in (None, "", self.namespace):
            return
        name = meta.get("name") or ""
        if name == self.replica_id:
            return  # our own write echoing back
        if ev.type == DELETED:
            with self._lock:
                self._peers.discard(name)
            self._report_peers()
            return
        self._merge_obj(ev.obj)

    def _merge_obj(self, obj: Dict[str, Any]) -> None:
        spec = obj.get("spec") or {}
        origin = str(
            spec.get("replica")
            or (obj.get("metadata") or {}).get("name")
            or ""
        )
        if not origin or origin == self.replica_id:
            return
        with self._lock:
            self._peers.add(origin)
        self._report_peers()
        merged = 0
        if self._cache_system is not None:
            for rec in spec.get("cache") or []:
                try:
                    if self._cache_system.cache.merge(rec, origin):
                        merged += 1
                except Exception:
                    continue  # one malformed record must not stop the rest
        if merged:
            with self._lock:
                self.cache_merged += merged
            if self.metrics is not None:
                self.metrics.record(
                    "fleet_cache_merged_total", merged, peer=origin
                )
        for brec in spec.get("breakers") or []:
            name = str(brec.get("name") or "")
            state = str(brec.get("state") or "")
            with self._lock:
                breaker = self._breakers.get(name)
            if breaker is None or not state:
                continue
            adopt = getattr(breaker, "adopt", None)
            if adopt is None:
                continue
            if adopt(state):
                with self._lock:
                    self.breaker_adoptions += 1
                if self.metrics is not None:
                    self.metrics.record(
                        "fleet_breaker_adoptions_total", 1,
                        breaker=name, peer_state=state,
                    )
                self.log.info(
                    "adopted peer breaker state",
                    process="fleet", breaker=name,
                    peer=origin, peer_state=state,
                )

    def _report_peers(self) -> None:
        if self.metrics is not None:
            with self._lock:
                n = len(self._peers)
            self.metrics.gauge("fleet_peers", n)

    # -- introspection ---------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """Readyz/debug view (stats.fleet, docs/fleet.md)."""
        with self._lock:
            return {
                "replica": self.replica_id,
                "peers": sorted(self._peers),
                "cache_merged": self.cache_merged,
                "breaker_adoptions": self.breaker_adoptions,
                "publishes": self.publishes,
                "publish_failures": self.publish_failures,
                "breakers": sorted(self._breakers),
            }
