# Copied from gatekeeper_tpu/faults/breaker.py; only the module docstring
# differs. Edit: an OPEN breaker's batches get the fail policy envelope
# (webhook/server.py answers them with EvaluationUnavailable), not the
# host interpreter, and the doomed attempt no longer adds serial fallbacks.
"""Circuit breaker around the fused device path.

Before this existed, a persistently failing device made EVERY batch pay
a doomed fused attempt — the failure tax scaled
with traffic exactly when the system was least healthy. The breaker
converts that into a state machine with an explicit, observable
envelope:

    CLOSED ──k consecutive failures──▶ OPEN
      ▲                                 │ recovery_seconds elapse
      │ probe succeeds                  ▼
      └───────────────────────────  HALF_OPEN ──probe fails──▶ OPEN

  * CLOSED: fused dispatches flow; consecutive failures are counted
    (any success resets the count).
  * OPEN: the fused path is short-circuited — batches are answered
    with the endpoint's fail policy, paying zero doomed device
    attempts. After `recovery_seconds` the breaker half-opens.
  * HALF_OPEN: exactly ONE batch is admitted as a probe; success closes
    the breaker, failure re-opens it (and restarts the recovery clock).

Every transition gets a Prometheus series (`device_breaker_state`,
`device_breaker_transitions_total`, `device_breaker_probes_total`) and
a tracer span, so a dashboard — not a log dive — answers "why is
admission failing open right now".
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

# gauge encoding for device_breaker_state
_STATE_VALUE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class CircuitBreaker:
    """Consecutive-failure circuit breaker with half-open probes.

    Thread-safe; `allow()` / `record_success()` / `record_failure()`
    are the whole contract. `clock` is injectable so tests advance the
    recovery window deterministically."""

    def __init__(
        self,
        failure_threshold: int = 3,
        recovery_seconds: float = 30.0,
        plane: str = "validation",
        metrics=None,
        tracer=None,
        clock: Callable[[], float] = time.monotonic,
        # device fault domains (docs/robustness.md §Fault domains): a
        # per-device breaker carries its device id as a metric tag and
        # in its name, so multi-breaker accounting (transition ledgers,
        # fleet gossip keys, snapshots) stays exact per breaker instead
        # of assuming one breaker per plane
        device=None,
        name: Optional[str] = None,
        # obs.FlightRecorder: a transition to OPEN trips a postmortem
        # capture (trigger() is queue-and-wake, safe under this lock)
        recorder=None,
    ):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = failure_threshold
        self.recovery_seconds = recovery_seconds
        self.plane = plane
        self.device = None if device is None else str(device)
        self.name = name or (
            f"device:{plane}:{self.device}"
            if self.device is not None
            else f"device:{plane}"
        )
        # the tag set every metric emission carries; the device tag is
        # only added when set, so single-breaker planes keep their
        # pre-partitioning series shape
        self._tags = {"plane": plane}
        if self.device is not None:
            self._tags["device"] = self.device
        self.metrics = metrics
        self.tracer = tracer
        self.recorder = recorder
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at: Optional[float] = None
        self._probe_in_flight = False
        self.transitions = 0  # lifetime transition count (tests/readyz)
        self.adoptions = 0  # peer states adopted via adopt() (readyz)
        # transition listeners (the fleet plane's gossip hook). Called
        # INSIDE the breaker lock — listeners must be non-blocking and
        # must never call back into the breaker (set a flag / wake an
        # event; the fleet publisher drains asynchronously).
        self._listeners = []
        self._export_state()

    # -- state ---------------------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open_locked()
            return self._state

    def snapshot(self) -> dict:
        """Readyz/debug view of the breaker, keyed by its name so
        multi-breaker planes (one per device) snapshot unambiguously."""
        with self._lock:
            self._maybe_half_open_locked()
            return {
                "name": self.name,
                "device": self.device,
                "state": self._state,
                "consecutive_failures": self._consecutive_failures,
                "transitions": self.transitions,
                "adoptions": self.adoptions,
                "probe_in_flight": self._probe_in_flight,
            }

    def _maybe_half_open_locked(self) -> None:
        if (
            self._state == OPEN
            and self._opened_at is not None
            and self._clock() - self._opened_at >= self.recovery_seconds
        ):
            self._transition_locked(HALF_OPEN)

    def _transition_locked(self, to_state: str) -> None:
        from_state = self._state
        if from_state == to_state:
            return
        self._state = to_state
        self.transitions += 1
        if to_state == OPEN:
            self._opened_at = self._clock()
            self._probe_in_flight = False
        elif to_state == HALF_OPEN:
            self._probe_in_flight = False
        else:  # CLOSED
            self._consecutive_failures = 0
            self._opened_at = None
            self._probe_in_flight = False
        self._export_state()
        for listener in self._listeners:
            try:
                listener(from_state, to_state)
            except Exception:
                pass  # gossip is best-effort; the breaker must not die
        if self.metrics is not None:
            self.metrics.record(
                "device_breaker_transitions_total", 1, **self._tags,
                from_state=from_state, to_state=to_state,
            )
        if self.tracer is not None:
            # a standalone one-span trace: transitions are rare and must
            # be findable in /debug/traces without a request to ride on
            with self.tracer.start_span(
                "breaker_transition", breaker=self.name, **self._tags,
                from_state=from_state, to_state=to_state,
            ):
                pass
        if self.recorder is not None and to_state == OPEN:
            # trip-triggered postmortem (docs/observability.md §Flight
            # recorder): trigger() only enqueues — safe under this lock
            try:
                self.recorder.trigger(
                    "breaker_open", breaker=self.name, **self._tags,
                    from_state=from_state, to_state=to_state,
                    consecutive_failures=self._consecutive_failures,
                )
            except Exception:
                pass

    def _export_state(self) -> None:
        if self.metrics is not None:
            self.metrics.gauge(
                "device_breaker_state", _STATE_VALUE[self._state],
                **self._tags,
            )

    # -- fleet gossip ---------------------------------------------------------

    def subscribe(self, listener) -> None:
        """Register a `listener(from_state, to_state)` transition hook
        (the fleet plane's publish trigger). Called inside the breaker
        lock: must be non-blocking and must not re-enter the breaker."""
        with self._lock:
            self._listeners.append(listener)

    def adopt(self, peer_state: str) -> bool:
        """Adopt a peer replica's breaker verdict (docs/fleet.md):

          * peer OPEN while we are CLOSED → pre-open to HALF_OPEN: the
            next batch is a single probe instead of
            `failure_threshold` full batches rediscovering the outage;
          * peer CLOSED while we are OPEN → HALF_OPEN early: the peer's
            success is evidence recovery happened, probe now rather
            than waiting out the local recovery window.

        A peer's HALF_OPEN is deliberately NOT adopted: it means the
        peer is *probing*, not that an outage is confirmed — and
        adopting it ping-pongs two recovered replicas between CLOSED
        and HALF_OPEN forever (A closes, B adopts B's-recovery-induced
        HALF_OPEN back, ...), which on a quiet plane never settles
        (surfaced by the soak lane's breaker transition log).

        Never adopts straight to OPEN — a peer's outage is a hint, not
        proof, for THIS replica's device/endpoint; the probe decides.
        Returns True when a transition happened."""
        with self._lock:
            self._maybe_half_open_locked()
            if peer_state == OPEN and self._state == CLOSED:
                self._transition_locked(HALF_OPEN)
            elif peer_state == CLOSED and self._state == OPEN:
                self._transition_locked(HALF_OPEN)
            else:
                return False
            self.adoptions += 1
            return True

    # -- the contract --------------------------------------------------------

    def allow(self) -> bool:
        """May this batch take the fused device path? OPEN → no;
        HALF_OPEN → yes for exactly one probe batch at a time."""
        with self._lock:
            self._maybe_half_open_locked()
            if self._state == CLOSED:
                return True
            if self._state == HALF_OPEN and not self._probe_in_flight:
                self._probe_in_flight = True
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                if self.metrics is not None:
                    self.metrics.record(
                        "device_breaker_probes_total", 1,
                        **self._tags, result="success",
                    )
                self._transition_locked(CLOSED)
            else:
                self._consecutive_failures = 0

    def record_failure(self) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                if self.metrics is not None:
                    self.metrics.record(
                        "device_breaker_probes_total", 1,
                        **self._tags, result="failure",
                    )
                self._transition_locked(OPEN)
                return
            self._consecutive_failures += 1
            if (
                self._state == CLOSED
                and self._consecutive_failures >= self.failure_threshold
            ):
                self._transition_locked(OPEN)
