# Copied from gatekeeper_tpu/fleet/certs.py; unchanged.
"""FleetCertRotator: the CertRotator whose source of truth is the
shared Secret, not pod-local disk.

Local files still exist — `ssl.SSLContext.load_cert_chain` wants paths —
but they are a *cache* of the store: every install goes through the
base rotator's write-then-atomic-rename so concurrent `ensure()` callers
and rotation racing a TLS handshake can never observe a torn
ca.crt/tls.crt pair. The lifecycle (certs.go:119-181 behaviorally):

  * `ensure()` — load the Secret; fresh → install (if not already at
    that generation) and serve. Missing/expiring → generate a candidate
    pair and `offer()` it; losing the create/rotate race installs the
    winner's pair instead (one CA per fleet, always);
  * `start()` — watch the Secret: a peer's rotation arrives as a watch
    event, installs atomically, bumps `cert_generation`, and fires the
    `on_rotate` callbacks (the serving layer re-loads its SSL context;
    the CaBundleInjector re-injects the VWH) — rotation propagates to
    every replica WITHOUT restart.
"""

from __future__ import annotations

import datetime
import threading
from typing import Callable, Dict, List, Optional

from ..logs import null_logger
from ..webhook.certs import CertRotator, LOOKAHEAD_DAYS
from .store import CertRecord, SecretCertStore


class FleetCertRotator(CertRotator):
    def __init__(
        self,
        cert_dir: str,
        store: SecretCertStore,
        dns_name: str = "localhost",
        now=None,
        metrics=None,
        logger=None,
    ):
        super().__init__(cert_dir, dns_name=dns_name, now=now)
        # reentrant: watch events delivered synchronously during an
        # offer() land back in _install_record on the same thread
        self._lock = threading.RLock()
        self.store = store
        self.metrics = metrics
        self.log = logger if logger is not None else null_logger()
        self.cert_generation = 0  # store generation currently installed
        # (generation, rotated_by) of the installed pair: generation
        # alone is ambiguous when two replicas rotate in the same
        # window and both write generation N — identity disambiguates
        self._installed_id = (0, "")
        self.rotations_adopted = 0  # peer rotations installed via watch
        self._rotate_callbacks: List[Callable[[], None]] = []
        self._unsubscribe = None

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> None:
        """Begin watching the Secret for peer rotations."""
        if self._unsubscribe is None:
            self._unsubscribe = self.store.watch(self._on_record)

    def stop(self) -> None:
        if self._unsubscribe is not None:
            self._unsubscribe()
            self._unsubscribe = None

    def on_rotate(self, callback: Callable[[], None]) -> None:
        """Register a callback fired after ANY new pair is installed
        (own rotation or a peer's): SSL-context reload, CA re-inject."""
        with self._lock:
            self._rotate_callbacks.append(callback)

    # -- the contract ---------------------------------------------------------

    def ensure(self):
        with self._lock:
            rec = self.store.load()
            if rec is not None and not self._record_needs_refresh(rec):
                self._install_record(rec)
                return self.cert_path, self.key_path
            expected = rec.generation if rec is not None else 0
            winner, won = self.store.offer(
                self.generate_pair(), expected_generation=expected
            )
            self._install_record(winner)
            if won:
                self.rotations += 1
        return self.cert_path, self.key_path

    # -- internals ------------------------------------------------------------

    def _record_needs_refresh(self, rec: CertRecord) -> bool:
        exp = self.pem_expiry(rec.artifacts.get("tls.crt", b""))
        if exp is None:
            return True
        lookahead = self._now() + datetime.timedelta(days=LOOKAHEAD_DAYS)
        return exp <= lookahead

    def _install_record(self, rec: CertRecord) -> bool:
        """Install iff `rec` is new: strictly newer generation, or the
        same generation written by a DIFFERENT replica (the store's
        current content after a same-window double rotation — the
        caller only hands us authoritative records). Returns True when
        the pair on disk changed."""
        with self._lock:
            rid = (rec.generation, rec.rotated_by)
            if rid == self._installed_id:
                return False
            if rec.generation < self._installed_id[0]:
                return False  # stale record
            self.install_artifacts(rec.artifacts)
            self._installed_id = rid
            self.cert_generation = rec.generation
            if self.metrics is not None:
                self.metrics.gauge(
                    "fleet_cert_generation", rec.generation
                )
            callbacks = list(self._rotate_callbacks)
        for cb in callbacks:
            try:
                cb()
            except Exception as e:
                self.log.error(
                    "cert rotation callback failed",
                    process="fleet", err=e,
                )
        return True

    def _on_record(self, rec: Optional[CertRecord]) -> None:
        """Watch sink: a peer rotated (or the Secret vanished).

        NON-BLOCKING on the rotator lock: watch events are delivered
        synchronously from the writer's thread (FakeCluster), so two
        replicas inside ensure() writing the store would otherwise
        deadlock AB-BA (each holding its own lock, each delivering into
        the other's sink). If the lock is busy, the holder is inside
        ensure() and will install the store's authoritative record
        itself — we just re-check once it releases, off-thread."""
        if rec is None:
            return  # deletion: the next ensure() recreates
        if not self._lock.acquire(blocking=False):
            threading.Thread(
                target=self._deferred_recheck,
                name="gk-fleet-cert-recheck",
                daemon=True,
            ).start()
            return
        try:
            self._handle_record_locked(rec)
        finally:
            self._lock.release()

    def _deferred_recheck(self) -> None:
        with self._lock:
            rec = self.store.load()
            if rec is not None:
                self._handle_record_locked(rec)

    def _handle_record_locked(self, rec: CertRecord) -> None:
        rid = (rec.generation, rec.rotated_by)
        if (
            rid == self._installed_id
            or rec.generation < self.cert_generation
        ):
            return
        if rec.generation == self.cert_generation:
            # same generation, different writer: a delayed event
            # from a double rotation — the STORE is authoritative,
            # not the event payload (events replay in write order
            # but we may have installed past this one already)
            rec = self.store.load()
            if rec is None or (
                (rec.generation, rec.rotated_by)
                == self._installed_id
            ):
                return
        if (
            self._install_record(rec)
            and rec.rotated_by != self.store.replica_id
        ):
            self.rotations_adopted += 1
            if self.metrics is not None:
                self.metrics.record(
                    "fleet_cert_rotations_adopted_total", 1,
                    rotated_by=rec.rotated_by or "unknown",
                )
            self.log.info(
                "adopted peer cert rotation without restart",
                process="fleet",
                generation=rec.generation,
                rotated_by=rec.rotated_by,
            )
