# Copied from gatekeeper_tpu/control/watch.py; unchanged.
"""Watch manager: dynamic multiplexed watches with replay.

Mirrors pkg/watch/manager.go + registrar.go + replay.go:

  * Controllers register interest in GVKs through named `Registrar`s
    (registrar.go:202-247). Watches are reference-counted per GVK
    (recordKeeper, registrar.go:52): the first registrar starts the
    underlying subscription (doAddWatch, manager.go:148), later joiners
    get an async **replay** of the current List instead of a new watch
    (replay.go:36-200); when the last registrar leaves, the subscription
    is torn down (doRemoveWatch, manager.go:209).
  * Events are distributed on a background thread to every registrar's
    sink (eventLoop/distributeEvent, manager.go:311-348) so slow
    consumers never block the source.
  * `replace_watch` swaps a registrar's whole GVK set atomically
    (registrar.go:226, the config controller's path).

The sink contract is a callable taking `Event`; controllers enqueue into
their own work queues.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, List, Optional, Set, Tuple

from .events import DELETED, Event, EventSink, EventSource, GVK, ADDED


class Registrar:
    """One controller's handle on the manager (registrar.go:202)."""

    def __init__(self, name: str, mgr: "WatchManager", sink: EventSink):
        self.name = name
        self._mgr = mgr
        self.sink = sink

    def add_watch(self, gvk: GVK) -> None:
        self._mgr._add_watch(self, gvk)

    def remove_watch(self, gvk: GVK) -> None:
        self._mgr._remove_watch(self, gvk)

    def replace_watch(self, gvks: Set[GVK]) -> None:
        self._mgr._replace_watch(self, set(gvks))

    def watched(self) -> Set[GVK]:
        return self._mgr._watched_by(self)


class WatchManager:
    def __init__(self, source: EventSource, metrics=None):
        self.source = source
        self.metrics = metrics
        self._lock = threading.RLock()
        # gvk -> {registrar name -> Registrar}
        self._interest: Dict[GVK, Dict[str, Registrar]] = {}
        self._unsubs: Dict[GVK, Callable[[], None]] = {}
        self._registrars: Dict[str, Registrar] = {}
        # distribution queue: (event, [sinks]) handled off-thread
        self._q: "queue.Queue[Optional[Tuple[Event, List[EventSink]]]]" = (
            queue.Queue()
        )
        self._inflight = 0
        self._idle = threading.Condition()
        self._thread = threading.Thread(target=self._event_loop, daemon=True)
        self._thread.start()

    # -- registrar lifecycle ---------------------------------------------------

    def new_registrar(self, name: str, sink: EventSink) -> Registrar:
        with self._lock:
            if name in self._registrars:
                raise ValueError(f"registrar {name!r} already exists")
            r = Registrar(name, self, sink)
            self._registrars[name] = r
            return r

    def _watched_by(self, r: Registrar) -> Set[GVK]:
        with self._lock:
            return {g for g, m in self._interest.items() if r.name in m}

    def watched_gvks(self) -> Set[GVK]:
        with self._lock:
            return {g for g, m in self._interest.items() if m}

    # -- watch bookkeeping -----------------------------------------------------

    def _add_watch(self, r: Registrar, gvk: GVK) -> None:
        with self._lock:
            holders = self._interest.setdefault(gvk, {})
            if r.name in holders:
                return
            first = not holders
            holders[r.name] = r
            if first:
                # first registrar: start the real subscription, then feed
                # the initial List through the same pipe (informer start)
                self._unsubs[gvk] = self.source.subscribe(
                    gvk, lambda ev: self._distribute(ev)
                )
                snapshot = self.source.list(gvk)
                for obj in snapshot:
                    self._enqueue(Event(ADDED, gvk, obj), [r.sink])
            else:
                # late joiner: async replay of current state, this
                # registrar only (replay.go:36-200)
                snapshot = self.source.list(gvk)
                for obj in snapshot:
                    self._enqueue(Event(ADDED, gvk, obj), [r.sink])
            self._report()

    def _remove_watch(self, r: Registrar, gvk: GVK) -> None:
        with self._lock:
            holders = self._interest.get(gvk, {})
            holders.pop(r.name, None)
            if not holders:
                unsub = self._unsubs.pop(gvk, None)
                if unsub is not None:
                    unsub()
                self._interest.pop(gvk, None)
            self._report()

    def _replace_watch(self, r: Registrar, gvks: Set[GVK]) -> None:
        current = self._watched_by(r)
        for g in current - gvks:
            self._remove_watch(r, g)
        for g in gvks - current:
            self._add_watch(r, g)

    def _report(self) -> None:
        if self.metrics is not None:
            n = len(self.watched_gvks())
            self.metrics.gauge("watch_manager_watched_gvk", n)
            # intended == watched here: _add_watch starts subscriptions
            # synchronously, so there is no requested-but-not-running
            # gap (the reference tracks the two separately because its
            # informer creation is async, watch/stats_reporter.go)
            self.metrics.gauge("watch_manager_intended_watch_gvk", n)

    # -- event distribution -----------------------------------------------------

    def _distribute(self, ev: Event) -> None:
        with self._lock:
            sinks = [r.sink for r in self._interest.get(ev.gvk, {}).values()]
        if sinks:
            self._enqueue(ev, sinks)

    def _enqueue(self, ev: Event, sinks: List[EventSink]) -> None:
        with self._idle:
            self._inflight += 1
        self._q.put((ev, sinks))

    def _event_loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            ev, sinks = item
            for s in sinks:
                try:
                    s(ev)
                except Exception:
                    pass  # a broken consumer must not stall the fan-out
            with self._idle:
                self._inflight -= 1
                if self._inflight == 0:
                    self._idle.notify_all()

    def wait_idle(self, timeout: float = 10.0) -> bool:
        """Block until the distribution queue fully drains (tests)."""
        import time as _time

        deadline = _time.monotonic() + timeout
        with self._idle:
            while self._inflight > 0:
                remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    return False
                self._idle.wait(remaining)
            return True

    def stop(self) -> None:
        with self._lock:
            for unsub in self._unsubs.values():
                unsub()
            self._unsubs.clear()
            self._interest.clear()
        self._q.put(None)
        self._thread.join(timeout=5)
