# Copied from gatekeeper_tpu/control/process.py; unchanged.
"""Process excluder: per-process namespace exclusion lists.

Mirrors pkg/controller/config/process/excluder.go: the Config CRD's
spec.match entries name processes ({audit, sync, webhook, *}) and
namespaces to exclude from them (excluder.go:12-17,43-79); `*` expands
to every process (excluder.go:60-66).
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Set

PROCESS_AUDIT = "audit"
PROCESS_SYNC = "sync"
PROCESS_WEBHOOK = "webhook"
PROCESS_STAR = "*"

_ALL = (PROCESS_AUDIT, PROCESS_SYNC, PROCESS_WEBHOOK)


class Excluder:
    def __init__(self):
        self._lock = threading.Lock()
        self._excluded: Dict[str, Set[str]] = {p: set() for p in _ALL}

    def add(self, match_entries: Iterable[dict]) -> None:
        """Ingest Config spec.match entries:
        [{"processes": [...], "excludedNamespaces": [...]}]."""
        with self._lock:
            for entry in match_entries or []:
                processes = entry.get("processes") or []
                namespaces = entry.get("excludedNamespaces") or []
                targets: Set[str] = set()
                for p in processes:
                    if p == PROCESS_STAR:
                        targets.update(_ALL)
                    elif p in self._excluded:
                        targets.add(p)
                for p in targets:
                    self._excluded[p].update(
                        ns for ns in namespaces if isinstance(ns, str)
                    )

    def replace(self, match_entries: Iterable[dict]) -> None:
        """Swap in a new exclusion config atomically (the config
        controller rebuilds the excluder on every Config change)."""
        fresh = Excluder()
        fresh.add(match_entries)
        with self._lock:
            self._excluded = fresh._excluded

    def is_namespace_excluded(self, process: str, namespace: str) -> bool:
        with self._lock:
            return namespace in self._excluded.get(process, set())

    def equals(self, other: "Excluder") -> bool:
        with self._lock:
            mine = {p: set(s) for p, s in self._excluded.items()}
        with other._lock:
            theirs = {p: set(s) for p, s in other._excluded.items()}
        return mine == theirs
