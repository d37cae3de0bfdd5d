# Copied from gatekeeper_tpu/fleet/store.py; unchanged.
"""Secret-backed shared cert store: one CA per fleet, not per pod.

The reference keeps the webhook's CA + server pair in a Secret that
every replica mounts, and resolves boot races with a load-or-create +
conflict-retry loop (pkg/webhook/certs.go:119-181): whoever creates the
Secret first wins; losers re-read and serve the winner's CA. This module
is that store behind the `EventSource` seam, so the same code runs
against the FakeCluster (tests, two in-process replicas) and a live
apiserver (`KubeCluster.create`/`apply`):

  * `load()` — the current fleet pair, or None;
  * `offer(artifacts, expected_generation)` — try to make a freshly
    generated pair THE fleet pair. Absent → atomic `create()` (a 409
    loser adopts the winner); present → generation-checked replace, so
    two replicas rotating simultaneously converge on one writer and
    the other adopts;
  * `watch(callback)` — rotation events for peers: a replica that
    did not rotate picks the new pair up from the Secret without
    restarting (docs/fleet.md).

Artifacts travel as the ca.crt / tls.crt / tls.key triple, base64 in
`data` exactly like a mounted TLS Secret, plus a monotonically
increasing generation annotation that makes "who rotated, and have I
installed it yet" a pure integer comparison.
"""

from __future__ import annotations

import base64
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

from ..control.events import Conflict, DELETED, GVK
from ..logs import null_logger

SECRET_GVK = GVK("", "v1", "Secret")

DEFAULT_SECRET_NAME = "gatekeeper-webhook-server-cert"
DEFAULT_NAMESPACE = "gatekeeper-system"

GENERATION_ANNOTATION = "fleet.gatekeeper.sh/generation"
ROTATED_BY_ANNOTATION = "fleet.gatekeeper.sh/rotated-by"

ARTIFACT_KEYS = ("ca.crt", "tls.crt", "tls.key")


@dataclass(frozen=True)
class CertRecord:
    """One parsed store state: the PEM triple + rotation provenance."""

    artifacts: Dict[str, bytes]
    generation: int
    rotated_by: str


class SecretCertStore:
    def __init__(
        self,
        cluster,
        name: str = DEFAULT_SECRET_NAME,
        namespace: str = DEFAULT_NAMESPACE,
        replica_id: str = "",
        metrics=None,
        logger=None,
    ):
        self.cluster = cluster
        self.name = name
        self.namespace = namespace
        self.replica_id = replica_id
        self.metrics = metrics
        self.log = logger if logger is not None else null_logger()
        self.conflicts = 0  # create/rotate races lost (tests/readyz)

    # -- (de)serialization ----------------------------------------------------

    def _secret_obj(self, artifacts: Dict[str, bytes],
                    generation: int) -> Dict:
        return {
            "apiVersion": "v1",
            "kind": "Secret",
            "metadata": {
                "name": self.name,
                "namespace": self.namespace,
                "annotations": {
                    GENERATION_ANNOTATION: str(generation),
                    ROTATED_BY_ANNOTATION: self.replica_id,
                },
            },
            "type": "Opaque",
            "data": {
                k: base64.b64encode(artifacts[k]).decode()
                for k in ARTIFACT_KEYS
            },
        }

    @staticmethod
    def parse(obj: Optional[Dict]) -> Optional[CertRecord]:
        """Secret object -> CertRecord, or None when the object is
        missing or holds an incomplete triple (a placeholder Secret the
        chart ships empty parses as None → first boot generates)."""
        if obj is None:
            return None
        data = obj.get("data") or {}
        artifacts: Dict[str, bytes] = {}
        for k in ARTIFACT_KEYS:
            raw = data.get(k)
            if not raw:
                return None
            try:
                artifacts[k] = base64.b64decode(raw)
            except Exception:
                return None
        meta = obj.get("metadata") or {}
        ann = meta.get("annotations") or {}
        try:
            generation = int(ann.get(GENERATION_ANNOTATION, "1"))
        except ValueError:
            generation = 1
        return CertRecord(
            artifacts=artifacts,
            generation=generation,
            rotated_by=str(ann.get(ROTATED_BY_ANNOTATION, "")),
        )

    # -- reads ----------------------------------------------------------------

    def _get_obj(self) -> Optional[Dict]:
        getter = getattr(self.cluster, "get", None)
        if getter is not None:
            return getter(SECRET_GVK, self.namespace, self.name)
        for obj in self.cluster.list(SECRET_GVK):
            meta = obj.get("metadata") or {}
            if (meta.get("namespace"), meta.get("name")) == (
                self.namespace,
                self.name,
            ):
                return obj
        return None

    def load(self) -> Optional[CertRecord]:
        return self.parse(self._get_obj())

    # -- the load-or-create / rotate write ------------------------------------

    def offer(
        self, artifacts: Dict[str, bytes], expected_generation: int = 0
    ) -> Tuple[CertRecord, bool]:
        """Try to make `artifacts` the fleet pair; returns
        (winning record, we_won). `expected_generation` is the store
        generation the caller based its decision on: 0 = it saw no
        usable Secret (load-or-create), N = it decided generation N is
        due for rotation. Every losing path re-reads and returns the
        WINNER's record — the caller must serve that, never its own
        candidate (certs.go:119-181)."""
        mine = CertRecord(
            artifacts=dict(artifacts),
            generation=expected_generation + 1,
            rotated_by=self.replica_id,
        )
        obj = self._secret_obj(artifacts, mine.generation)
        if expected_generation == 0:
            create = getattr(self.cluster, "create", None)
            existing = self._get_obj()
            if existing is not None:
                winner = self.parse(existing)
                if winner is not None:
                    # usable pair appeared between the caller's load and
                    # this offer: adopt it, write nothing
                    return self._lost_race("create", winner), False
            elif create is not None:
                try:
                    create(obj)
                    return mine, True
                except Conflict:
                    winner = self.load()
                    if winner is not None:
                        return self._lost_race("create", winner), False
                    # the race winner wrote something UNUSABLE (or the
                    # chart's empty placeholder landed between our get
                    # and create): replace it below
            # an existing-but-unusable Secret (the chart ships an empty
            # placeholder) — or a seam without create(): replace, then
            # re-read to detect a same-window double replace
            self.cluster.apply(obj)
            after = self.load()
            if after is not None and (
                (after.generation, after.rotated_by)
                != (mine.generation, self.replica_id)
            ):
                return self._lost_race("create", after), False
            return mine, True
        # rotation: a generation-checked replace. The re-read-then-apply
        # window is narrow but real; the generation check plus the final
        # re-read below make a double rotation converge on one winner.
        cur = self.load()
        if cur is not None and cur.generation != expected_generation:
            return self._lost_race("rotate", cur), False
        self.cluster.apply(obj)
        after = self.load()
        if (
            after is not None
            and (after.generation, after.rotated_by)
            != (mine.generation, self.replica_id)
        ):
            return self._lost_race("rotate", after), False
        return mine, True

    def _lost_race(
        self, kind: str, winner: Optional[CertRecord] = None
    ) -> CertRecord:
        self.conflicts += 1
        if self.metrics is not None:
            self.metrics.record("fleet_cert_conflicts_total", 1, kind=kind)
        self.log.info(
            "cert store conflict: adopting the winner's pair",
            process="fleet", kind=kind, replica=self.replica_id,
        )
        if winner is None:
            winner = self.load()
        if winner is None:
            # created-then-deleted under our feet: surface it — the
            # caller's next ensure() recreates from scratch
            raise Conflict(
                f"cert secret {self.namespace}/{self.name} vanished "
                "while resolving a write conflict"
            )
        return winner

    # -- watch ----------------------------------------------------------------

    def watch(
        self, callback: Callable[[Optional[CertRecord]], None]
    ) -> Callable[[], None]:
        """Subscribe to the Secret; `callback(record)` fires on every
        ADDED/MODIFIED of OUR secret (None on DELETED). This is how a
        replica that did not rotate picks up a peer's rotation without
        restart."""

        def sink(ev):
            meta = ev.obj.get("metadata") or {}
            if (meta.get("namespace"), meta.get("name")) != (
                self.namespace,
                self.name,
            ):
                return
            if ev.type == DELETED:
                callback(None)
                return
            rec = self.parse(ev.obj)
            if rec is not None:
                callback(rec)

        return self.cluster.subscribe(SECRET_GVK, sink)
