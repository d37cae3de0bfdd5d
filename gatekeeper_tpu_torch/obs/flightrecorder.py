# Copied from gatekeeper_tpu/obs/flightrecorder.py; unchanged but for this
# header. Its captures read host state only (the trace ring, the cost
# table, the decision log, the fault registry, the registered sources);
# nothing in it touches the device.
"""Trip-triggered postmortem capture: the flight recorder.

A sick-chip event today is diagnosable only live — by the time an
operator looks, the trace ring has churned past the interesting window
and the breaker has probed itself half-closed. The flight recorder
makes the event diagnosable after the fact: when something trips, it
snapshots the evidence INTO one timestamped record —

  * the trace-ring tail (the degraded-request traces around the trip),
  * every registered state source (breaker/queue/partition snapshots),
  * the top-K per-constraint cost table (`obs.attribution`),
  * the active fault points (`faults.FAULTS.snapshot()`).

Triggers: circuit-breaker transition to OPEN (`faults/breaker.py`
fires the hook), device quarantine (`parallel/partition.py`), an
SLO-window breach in soak, and shed bursts (`MicroBatcher._shed` →
`note_shed`). Trigger call sites run under hot-path locks (the breaker
calls its hook inside ITS lock), so `trigger()` only appends to a
deque and wakes the worker — the capture itself runs on the recorder's
own thread after a short debounce window that coalesces a burst of
related triggers (breaker open + quarantine + shed storm = ONE event,
one record).

Retention is bounded twice: an in-memory ring of `max_records` (=16,
served at `/debug/flightrecords`) and, when a directory is configured
(`dir=` or `GATEKEEPER_TPU_FLIGHT_DIR`), the same bound on on-disk
JSON files. Captures are single-flight and rate-limited
(`min_interval_s`): a flapping breaker produces one record per window
plus a suppressed-trigger count, never a disk-filling stream.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

__all__ = ["FlightRecorder"]

DEFAULT_MAX_RECORDS = 16


def _jsonable(value: Any) -> Any:
    """Best-effort JSON coercion: a state source returning exotic
    objects must degrade to its repr, never kill the capture."""
    try:
        json.dumps(value)
        return value
    except (TypeError, ValueError):
        return repr(value)


class FlightRecorder:
    def __init__(
        self,
        tracer=None,
        attributor=None,
        metrics=None,
        # obs.DecisionLog: a capture embeds the trigger window's
        # failed/degraded decision ids + trace ids, so a postmortem
        # names the exact requests behind the trip and each is
        # retrievable at /debug/decisions?trace_id= (the decision ↔
        # flight cross-link, docs/observability.md §Decision log)
        decisions=None,
        replica: Optional[str] = None,
        max_records: int = DEFAULT_MAX_RECORDS,
        dir: Optional[str] = None,
        # captures are rate-limited: triggers landing within
        # min_interval_s of the last capture are counted, not recorded
        min_interval_s: float = 5.0,
        # the coalescing window between the first trigger and the
        # snapshot — long enough for the tripping dispatch to finish
        # recording its degraded-request spans into the trace ring
        debounce_s: float = 0.25,
        trace_tail: int = 12,
        top_k_costs: int = 10,
        # shed-burst detection (note_shed): this many sheds inside the
        # window trips one "shed_burst" record
        shed_burst_threshold: int = 50,
        shed_burst_window_s: float = 5.0,
        # compile-storm detection (note_restage_failure): this many
        # restage failures inside the window — or a recompile backlog
        # at least this deep — trips one "compile_storm" record
        compile_storm_threshold: int = 8,
        compile_storm_window_s: float = 10.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.tracer = tracer
        self.attributor = attributor
        self.metrics = metrics
        self.decisions = decisions
        self.replica = replica
        self.max_records = max(1, int(max_records))
        self.dir = dir if dir is not None else os.environ.get(
            "GATEKEEPER_TPU_FLIGHT_DIR"
        ) or None
        self.min_interval_s = min_interval_s
        self.debounce_s = debounce_s
        self.trace_tail = trace_tail
        self.top_k_costs = top_k_costs
        self.shed_burst_threshold = max(1, int(shed_burst_threshold))
        self.shed_burst_window_s = shed_burst_window_s
        self.compile_storm_threshold = max(1, int(compile_storm_threshold))
        self.compile_storm_window_s = compile_storm_window_s
        self._clock = clock
        self._sources: Dict[str, Callable[[], Any]] = {}
        self._lock = threading.Lock()
        self._pending: deque = deque()
        self._records: List[Dict[str, Any]] = []
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._seq = 0
        self._last_capture: Optional[float] = None
        self._sheds: deque = deque()  # monotonic stamps per plane-shed
        self._shed_lock = threading.Lock()
        self._restage_fails: deque = deque()  # stamps per restage fail
        self.captured = 0
        self.suppressed = 0

    # -- wiring ---------------------------------------------------------------

    def add_source(self, name: str, fn: Callable[[], Any]) -> None:
        """Register a state snapshot callable captured into every
        record under `state[name]` (breaker banks, partition plans,
        queue depths). Evaluated on the recorder thread — a raising
        source records its error string, never aborts the capture."""
        self._sources[name] = fn

    # -- triggers -------------------------------------------------------------

    def trigger(self, reason: str, **context) -> None:
        """Request a postmortem capture. Non-blocking and safe under
        ANY caller lock (the breaker fires this inside its own lock):
        the event is queued and the worker thread does the capture
        after the debounce window."""
        if self._stop.is_set():
            return
        with self._lock:
            self._pending.append({
                "reason": reason,
                "t_monotonic": self._clock(),
                "ts": time.time(),
                "context": {k: _jsonable(v) for k, v in context.items()},
            })
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, name="gk-flightrecorder",
                    daemon=True,
                )
                self._thread.start()
        self._wake.set()

    def note_shed(self, plane: str = "validation") -> None:
        """Shed-burst detector: each shed stamps the rolling window;
        crossing the threshold triggers ONE `shed_burst` capture (the
        rate limit absorbs the rest of the storm)."""
        now = self._clock()
        fire = False
        with self._shed_lock:
            self._sheds.append(now)
            horizon = now - self.shed_burst_window_s
            while self._sheds and self._sheds[0] < horizon:
                self._sheds.popleft()
            if len(self._sheds) >= self.shed_burst_threshold:
                self._sheds.clear()
                fire = True
        if fire:
            self.trigger(
                "shed_burst", plane=plane,
                threshold=self.shed_burst_threshold,
                window_s=self.shed_burst_window_s,
            )

    def note_restage_failure(
        self, plane: str = "validation", backlog: int = 0
    ) -> None:
        """Compile-storm detector (docs/compile.md §Failure modes): a
        burst of restage failures inside the rolling window — or a
        recompile backlog already at the threshold — trips ONE
        `compile_storm` capture; the `programs` source then embeds the
        program-store state table in the record. Debounce + rate limit
        are the shared trigger machinery."""
        now = self._clock()
        fire = int(backlog) >= self.compile_storm_threshold
        with self._shed_lock:
            self._restage_fails.append(now)
            horizon = now - self.compile_storm_window_s
            while self._restage_fails and self._restage_fails[0] < horizon:
                self._restage_fails.popleft()
            if len(self._restage_fails) >= self.compile_storm_threshold:
                self._restage_fails.clear()
                fire = True
        if fire:
            self.trigger(
                "compile_storm", plane=plane, backlog=int(backlog),
                threshold=self.compile_storm_threshold,
                window_s=self.compile_storm_window_s,
            )

    # -- the worker -----------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._wake.wait()
            self._wake.clear()
            if self._stop.is_set():
                return
            with self._lock:
                if not self._pending:
                    continue
            # debounce: let the tripping dispatch finish stamping its
            # spans, and let sibling triggers (quarantine riding a
            # breaker open) coalesce into the same record
            if self.debounce_s > 0:
                self._stop.wait(self.debounce_s)
            with self._lock:
                triggers = list(self._pending)
                self._pending.clear()
            if not triggers:
                continue
            now = self._clock()
            if (
                self._last_capture is not None
                and now - self._last_capture < self.min_interval_s
            ):
                self.suppressed += len(triggers)
                if self.metrics is not None:
                    self.metrics.record(
                        "flight_records_suppressed_total", len(triggers),
                        trigger=triggers[0]["reason"],
                    )
                continue
            self._last_capture = now
            self._capture(triggers)

    def _capture(self, triggers: List[Dict[str, Any]]) -> None:
        with self._lock:
            self._seq += 1
            seq = self._seq
        record: Dict[str, Any] = {
            "id": f"fr-{seq:05d}",
            "ts": time.time(),
            "replica": self.replica,
            "trigger": triggers[0]["reason"],
            "triggers": triggers,
        }
        if self.tracer is not None:
            try:
                record["trace_tail"] = self.tracer.recent(self.trace_tail)
            except Exception as e:
                record["trace_tail_error"] = str(e)
        if self.attributor is not None:
            try:
                record["costs"] = self.attributor.table(self.top_k_costs)
            except Exception as e:
                record["costs_error"] = str(e)
        if self.decisions is not None:
            # the trigger window's failed/degraded decisions: ids +
            # trace ids only (the full records stay in the decision
            # ring — one source of truth, joined by id/trace_id)
            try:
                window = self.decisions.recent_errors(
                    window_s=max(self.min_interval_s * 6, 30.0)
                )
                record["decisions"] = [
                    {
                        "id": d.get("id"),
                        "trace_id": d.get("trace_id"),
                        "plane": d.get("plane"),
                        "verdict": d.get("verdict"),
                        "route": d.get("route"),
                    }
                    for d in window
                ]
            except Exception as e:
                record["decisions_error"] = str(e)
        try:
            from ..faults import FAULTS

            record["faults"] = _jsonable(FAULTS.snapshot())
        except Exception as e:
            record["faults_error"] = str(e)
        state: Dict[str, Any] = {}
        for name, fn in list(self._sources.items()):
            try:
                state[name] = _jsonable(fn())
            except Exception as e:
                state[name] = {"error": str(e)}
        record["state"] = state
        with self._lock:
            self._records.append(record)
            if len(self._records) > self.max_records:
                del self._records[: len(self._records) - self.max_records]
        self.captured += 1
        if self.metrics is not None:
            self.metrics.record(
                "flight_records_total", 1, trigger=record["trigger"],
            )
        self._persist(record)

    def _persist(self, record: Dict[str, Any]) -> None:
        """Bounded on-disk mirror: one JSON file per record, oldest
        pruned past `max_records`. Best-effort — a full disk must not
        take the recorder (or its trigger sites) down."""
        if not self.dir:
            return
        try:
            os.makedirs(self.dir, exist_ok=True)
            path = os.path.join(
                self.dir, f"flightrecord-{record['id']}.json"
            )
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(record, f)
            os.replace(tmp, path)
            files = sorted(
                f for f in os.listdir(self.dir)
                if f.startswith("flightrecord-") and f.endswith(".json")
            )
            for stale in files[: max(0, len(files) - self.max_records)]:
                try:
                    os.remove(os.path.join(self.dir, stale))
                except OSError:
                    pass
        except OSError:
            pass

    # -- read ----------------------------------------------------------------

    def records(self) -> List[Dict[str, Any]]:
        """Newest-first record list (the `/debug/flightrecords`
        payload body)."""
        with self._lock:
            return list(reversed(self._records))

    def export_json(self) -> str:
        return json.dumps({
            "replica": self.replica,
            "captured": self.captured,
            "suppressed": self.suppressed,
            "max_records": self.max_records,
            "records": self.records(),
        })

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            n = len(self._records)
        return {
            "captured": self.captured,
            "suppressed": self.suppressed,
            "retained": n,
        }

    # -- lifecycle ------------------------------------------------------------

    def flush(self, timeout: float = 2.0) -> bool:
        """Wait until the pending trigger queue has drained (tests and
        harness teardown); True when it drained in time."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if not self._pending:
                    return True
            time.sleep(0.01)
        return False

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
