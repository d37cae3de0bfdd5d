# Copied from gatekeeper_tpu/control/readiness.py; only these edits differ.
# Edit: ReadinessTracker.satisfied() latches (ROADMAP §C, C6). Once it has
# returned True it stays True for the process, as Gatekeeper's tracker does
# (ready_tracker.go:138-173): a tracker created after that, such as the one
# for a constraint kind whose template arrived after Ready, still counts
# its own stats() but no longer gates readiness. The reference requires
# every tracker on every call, so a kind first seen after Ready leaves
# /readyz at 503 for good.
# Edit: ObjectTracker.cancel_all() (ROADMAP §C, C8): the template
# controller cancels every expectation of a constraint kind whose template
# failed to ingest, and stats() reports them as "cancelled".
"""Readiness tracker: the boot-time barrier.

Mirrors pkg/readiness/ready_tracker.go + object_tracker.go: at startup
the expected templates/constraints/config/data objects are registered as
expectations; ingestion paths call observe() as state lands in the
driver; the process reports Ready only when every expectation is
satisfied. Satisfaction is a one-way circuit breaker
(ready_tracker.go:138-173) — once satisfied, later churn never flips it
back.
"""

from __future__ import annotations

import threading
from typing import Dict, Hashable, Set


class ObjectTracker:
    """Expectations for one class of objects (object_tracker.go:36-213)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._expected: Set[Hashable] = set()
        self._observed: Set[Hashable] = set()
        self._populated = False
        self._satisfied = False
        self._cancelled = 0

    def expect(self, key: Hashable) -> None:
        with self._lock:
            if self._satisfied:
                return
            self._expected.add(key)

    def cancel_expect(self, key: Hashable) -> None:
        """Deleted-before-observed objects stop blocking readiness."""
        with self._lock:
            if self._satisfied:
                return
            self._expected.discard(key)
            self._observed.discard(key)

    def cancel_all(self) -> None:
        """Every expectation stops blocking readiness and the expected
        set is final (Gatekeeper's Tracker.TryCancelTemplate): a
        constraint kind whose template failed to ingest has no watch, so
        its constraints would never be observed."""
        with self._lock:
            if self._satisfied:
                return
            self._cancelled += len(self._expected - self._observed)
            self._expected.clear()
            self._observed.clear()
            self._populated = True

    def observe(self, key: Hashable) -> None:
        with self._lock:
            if self._satisfied:
                return
            self._observed.add(key)

    def expectations_done(self) -> None:
        """Population phase over: the expected set is final."""
        with self._lock:
            self._populated = True

    def satisfied(self) -> bool:
        with self._lock:
            if self._satisfied:
                return True
            if self._populated and self._expected <= self._observed:
                self._satisfied = True  # one-way circuit breaker
                return True
            return False

    def stats(self) -> Dict[str, int]:
        with self._lock:
            out = {
                "expected": len(self._expected),
                "observed": len(self._observed & self._expected),
            }
            if self._cancelled:
                out["cancelled"] = self._cancelled
            return out


class ReadinessTracker:
    """Aggregated readiness across templates, constraints (per kind),
    config, and synced data (per GVK) — ready_tracker.go:53-173."""

    def __init__(self):
        self.templates = ObjectTracker()
        self.config = ObjectTracker()
        self._lock = threading.Lock()
        self._constraints: Dict[str, ObjectTracker] = {}
        self._data: Dict[str, ObjectTracker] = {}
        # named subsystem trackers (lazy — only gate readiness once
        # requested): the fleet plane registers under "fleet" so a
        # replica is not Ready before the shared cert store resolved
        # and the state plane synced (docs/fleet.md)
        self._components: Dict[str, ObjectTracker] = {}
        # the aggregate's one-way circuit breaker: set by the first
        # satisfied() that found every tracker satisfied
        self._latched = False

    def for_constraint_kind(self, kind: str) -> ObjectTracker:
        with self._lock:
            t = self._constraints.get(kind)
            if t is None:
                t = self._constraints[kind] = ObjectTracker()
            return t

    def for_data(self, gvk: str) -> ObjectTracker:
        with self._lock:
            t = self._data.get(gvk)
            if t is None:
                t = self._data[gvk] = ObjectTracker()
            return t

    def for_component(self, name: str) -> ObjectTracker:
        with self._lock:
            t = self._components.get(name)
            if t is None:
                t = self._components[name] = ObjectTracker()
            return t

    def satisfied(self) -> bool:
        with self._lock:
            if self._latched:
                return True
            trackers = (
                [self.templates, self.config]
                + list(self._constraints.values())
                + list(self._data.values())
                + list(self._components.values())
            )
        if not all(t.satisfied() for t in trackers):
            return False
        with self._lock:
            self._latched = True
        return True

    def stats(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            out = {
                "templates": self.templates.stats(),
                "config": self.config.stats(),
            }
            for k, t in self._constraints.items():
                out[f"constraint/{k}"] = t.stats()
            for k, t in self._data.items():
                out[f"data/{k}"] = t.stats()
            for k, t in self._components.items():
                out[f"component/{k}"] = t.stats()
        return out
