# Copied from gatekeeper_tpu/control/events.py; unchanged.
"""Event fabric: the K8s-API-server stand-in the controllers watch.

The reference's control fabric is the Kubernetes API server — all state
arrives via client-go informers (list+watch per GVK) multiplexed by
pkg/watch and the forked dynamiccache (SURVEY §1 "control/data planes").
This module provides the same contract behind one small interface so the
control plane runs identically against a fake in-memory cluster (tests,
standalone benchmarking) or a real apiserver adapter:

  * `list(gvk)` — current objects of a kind (informer initial List);
  * `subscribe(gvk, sink)` — ADDED/MODIFIED/DELETED events from now on
    (informer Watch); returns an unsubscribe handle;
  * `apply(obj)` / `delete(obj)` — writes (tests / demo drivers).

`FakeCluster` is the in-memory implementation — the moral equivalent of
envtest's local apiserver in the reference's integration tests
(constrainttemplate_controller_suite_test.go:44-66): real list+watch
semantics, no network.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"


class GVK(NamedTuple):
    """group/version/Kind key (pkg/watch keys watches by schema.GVK)."""

    group: str
    version: str
    kind: str

    @classmethod
    def from_obj(cls, obj: Dict[str, Any]) -> "GVK":
        api_version = obj.get("apiVersion", "")
        group, _, version = api_version.rpartition("/")
        return cls(group, version, obj.get("kind", ""))

    @classmethod
    def parse(cls, s: str) -> "GVK":
        """"group/version/Kind" or "version/Kind" (core group)."""
        parts = s.split("/")
        if len(parts) == 2:
            return cls("", parts[0], parts[1])
        if len(parts) == 3:
            return cls(parts[0], parts[1], parts[2])
        raise ValueError(f"bad GVK string: {s!r}")

    @property
    def api_version(self) -> str:
        return f"{self.group}/{self.version}" if self.group else self.version

    def __str__(self) -> str:
        return f"{self.api_version}/{self.kind}"


def obj_key(obj: Dict[str, Any]) -> Tuple[str, str]:
    meta = obj.get("metadata") or {}
    return (meta.get("namespace") or "", meta.get("name") or "")


@dataclass(frozen=True)
class Event:
    type: str  # ADDED | MODIFIED | DELETED
    gvk: GVK
    obj: Dict[str, Any]


EventSink = Callable[[Event], None]


class Conflict(Exception):
    """create() lost a create race: the object already exists. The
    fleet plane's load-or-create motions (Secret-backed cert store)
    catch this to adopt the winner's state instead of overwriting it —
    the apiserver's 409 on POST, surfaced identically by the fake."""


class EventSource:
    """The list+watch contract (client-go informer surface)."""

    def list(self, gvk: GVK) -> List[Dict[str, Any]]:
        raise NotImplementedError

    def subscribe(self, gvk: GVK, sink: EventSink) -> Callable[[], None]:
        """Start streaming events for `gvk` to `sink`; returns an
        unsubscribe callable. No initial List replay — callers pair this
        with list() themselves (the watch manager does)."""
        raise NotImplementedError


class FakeCluster(EventSource):
    """In-memory cluster: object store + watch fan-out per GVK."""

    def __init__(self):
        self._lock = threading.RLock()
        self._objs: Dict[GVK, Dict[Tuple[str, str], Dict[str, Any]]] = {}
        self._subs: Dict[GVK, List[Tuple[int, EventSink]]] = {}
        self._next_sub = 0

    # -- reads ---------------------------------------------------------------

    def list(self, gvk: GVK) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._objs.get(gvk, {}).values())

    def get(self, gvk: GVK, namespace: str, name: str) -> Optional[dict]:
        with self._lock:
            return self._objs.get(gvk, {}).get((namespace or "", name))

    def subscribe(self, gvk: GVK, sink: EventSink) -> Callable[[], None]:
        with self._lock:
            sid = self._next_sub
            self._next_sub += 1
            self._subs.setdefault(gvk, []).append((sid, sink))

        def unsubscribe() -> None:
            with self._lock:
                subs = self._subs.get(gvk, [])
                self._subs[gvk] = [(i, s) for i, s in subs if i != sid]

        return unsubscribe

    # -- writes (test/demo surface) ------------------------------------------

    def apply(self, obj: Dict[str, Any]) -> None:
        gvk = GVK.from_obj(obj)
        key = obj_key(obj)
        with self._lock:
            store = self._objs.setdefault(gvk, {})
            etype = MODIFIED if key in store else ADDED
            store[key] = obj
            sinks = [s for _, s in self._subs.get(gvk, [])]
        ev = Event(etype, gvk, obj)
        for s in sinks:
            s(ev)

    def create(self, obj: Dict[str, Any]) -> None:
        """Create-ONLY write: raises `Conflict` when the object already
        exists (the apiserver's 409 on POST). Unlike apply(), two racing
        creators cannot both win — the loser must re-read the winner's
        object, which is exactly the load-or-create contract the fleet
        cert store builds on (certs.go:119-181)."""
        gvk = GVK.from_obj(obj)
        key = obj_key(obj)
        with self._lock:
            store = self._objs.setdefault(gvk, {})
            if key in store:
                raise Conflict(f"{gvk}/{key[0]}/{key[1]} already exists")
            store[key] = obj
            sinks = [s for _, s in self._subs.get(gvk, [])]
        ev = Event(ADDED, gvk, obj)
        for s in sinks:
            s(ev)

    def delete(self, obj_or_gvk, namespace: str = "", name: str = "") -> bool:
        if isinstance(obj_or_gvk, GVK):
            gvk = obj_or_gvk
            key = (namespace or "", name)
        else:
            gvk = GVK.from_obj(obj_or_gvk)
            key = obj_key(obj_or_gvk)
        with self._lock:
            store = self._objs.get(gvk, {})
            obj = store.pop(key, None)
            if obj is None:
                return False
            sinks = [s for _, s in self._subs.get(gvk, [])]
        ev = Event(DELETED, gvk, obj)
        for s in sinks:
            s(ev)
        return True

    def known_gvks(self) -> List[GVK]:
        with self._lock:
            return [g for g, store in self._objs.items() if store]
