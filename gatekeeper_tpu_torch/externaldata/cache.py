# Copied from gatekeeper_tpu/externaldata/cache.py; unchanged.
"""TTL response cache with negative caching + stale-while-revalidate.

The cache is what turns external data from a per-request RPC into a
batch-plane concern: per micro-batch the system classifies every
deduped key against this cache, fetches ONLY the misses in one outbound
call, and serves everything else from memory. Three entry classes:

  * positive (value, `cache_ttl_s`) — a provider answer for a key;
  * negative (error, `negative_ttl_s`) — the provider *said* the key is
    bad (unsigned image, unknown record); caching the error keeps a
    storm of failing admissions from refetching the same doomed key
    every batch;
  * stale (expired positive within `stale_ttl_s`) — served immediately
    while the batch's single fetch revalidates it; if the fetch fails,
    the stale value still answers (counted as a stale-serve).

The clock is injectable so TTL/stale windows are testable without
sleeping.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

# classification outcomes (also the cache_lookups_total result tag)
HIT = "hit"
NEGATIVE_HIT = "negative_hit"
STALE = "stale"
MISS = "miss"


@dataclass
class Entry:
    value: Any = None
    error: Optional[str] = None  # set => negative entry
    fetched_at: float = 0.0
    ttl: float = 0.0
    stale_ttl: float = 0.0
    # "" = this process fetched it; a replica id = adopted from that
    # peer via the fleet plane. Only local-origin entries are published
    # (docs/fleet.md) — otherwise two replicas would echo each other's
    # entries back and forth forever.
    origin: str = ""

    def state(self, now: float) -> str:
        age = now - self.fetched_at
        if self.error is not None:
            return NEGATIVE_HIT if age < self.ttl else MISS
        if age < self.ttl:
            return HIT
        if age < self.ttl + self.stale_ttl:
            return STALE
        return MISS


class ResponseCache:
    """Per-(provider, key) entry store. Thread-safe; bounded
    (`max_entries`) with true LRU eviction — reads refresh recency, so
    a soak's hot key set survives while a high-cardinality cold tail is
    what gets evicted; a run can never grow this map without bound.
    Evictions are counted (`evictions`, and
    `externaldata_cache_evictions_total` when metrics are wired) so a
    leak check can tell "bounded and churning" from "growing"."""

    def __init__(
        self,
        clock: Callable[[], float] = time.monotonic,
        max_entries: int = 65536,
        metrics=None,
    ):
        if max_entries < 1:
            raise ValueError("max_entries must be >= 1")
        self._clock = clock
        self.max_entries = max_entries
        self.metrics = metrics
        self._lock = threading.Lock()
        # ordered oldest-access-first: the LRU order
        self._entries: "OrderedDict[Tuple[str, str], Entry]" = OrderedDict()
        self.evictions = 0  # lifetime count (soak leak evidence)
        # bumped on every write: lets consumers key derived state (e.g.
        # precomputed row-feature bits) on cache content
        self.generation = 0

    def now(self) -> float:
        return self._clock()

    # -- reads ---------------------------------------------------------------

    def classify(
        self, provider: str, keys: List[str], now: Optional[float] = None
    ) -> Dict[str, Tuple[str, Optional[Entry]]]:
        """{key -> (state, entry|None)} for a key list, one lock hold."""
        if now is None:
            now = self._clock()
        out: Dict[str, Tuple[str, Optional[Entry]]] = {}
        with self._lock:
            for k in keys:
                e = self._entries.get((provider, k))
                if e is None:
                    out[k] = (MISS, None)
                else:
                    # LRU touch: a read of a live entry refreshes its
                    # recency so the hot working set outlives cold tails
                    self._entries.move_to_end((provider, k))
                    out[k] = (e.state(now), e)
        return out

    # -- writes --------------------------------------------------------------

    def put(
        self,
        provider: str,
        key: str,
        value: Any = None,
        error: Optional[str] = None,
        ttl: float = 0.0,
        stale_ttl: float = 0.0,
    ) -> None:
        with self._lock:
            self._entries[(provider, key)] = Entry(
                value=value,
                error=error,
                fetched_at=self._clock(),
                ttl=ttl,
                stale_ttl=stale_ttl,
            )
            self._entries.move_to_end((provider, key))
            self.generation += 1
            if len(self._entries) > self.max_entries:
                self._evict_locked()

    def _evict_locked(self) -> None:
        # pop least-recently-used until back at the bound; counted per
        # provider so an eviction storm names the key space causing it
        by_provider: Dict[str, int] = {}
        while len(self._entries) > self.max_entries:
            (prov, _k), _e = self._entries.popitem(last=False)
            self.evictions += 1
            by_provider[prov] = by_provider.get(prov, 0) + 1
        if self.metrics is not None:
            for prov, n in by_provider.items():
                self.metrics.record(
                    "externaldata_cache_evictions_total", n, provider=prov
                )

    # -- fleet sync (docs/fleet.md) ------------------------------------------

    def export_fresh(self, max_entries: int = 512) -> List[Dict[str, Any]]:
        """Local-origin, still-live entries as publishable records.
        Ages are relative (`age_s`) because replicas do not share a
        clock epoch — the merging side re-anchors against its own
        clock, preserving the TTL / negative / stale-while-revalidate
        windows exactly. Newest first, capped at `max_entries` (the
        shared-state CR must stay bounded; the tail is the oldest and
        closest to expiry anyway)."""
        with self._lock:
            now = self._clock()
            out = []
            for (p, k), e in self._entries.items():
                if e.origin:
                    continue
                if e.state(now) == MISS:
                    continue  # nothing live to share
                out.append(
                    {
                        "provider": p,
                        "key": k,
                        "value": e.value,
                        "error": e.error,
                        "age_s": round(now - e.fetched_at, 3),
                        "ttl": e.ttl,
                        "stale_ttl": e.stale_ttl,
                    }
                )
        out.sort(key=lambda r: r["age_s"])
        return out[:max_entries]

    def merge(self, record: Dict[str, Any], origin: str) -> bool:
        """Adopt a peer-published record iff it is fresher than what we
        hold (by effective fetch time under OUR clock). Expired records
        and stale-er-than-ours records are dropped; adopted entries keep
        the publisher's TTL windows and carry its replica id as origin
        so they are never re-published from here. Returns True when the
        entry was adopted."""
        provider = str(record.get("provider") or "")
        key = str(record.get("key") or "")
        if not provider or not key:
            return False
        ttl = float(record.get("ttl") or 0.0)
        stale_ttl = float(record.get("stale_ttl") or 0.0)
        age_s = max(0.0, float(record.get("age_s") or 0.0))
        if age_s >= ttl + stale_ttl:
            return False  # dead on arrival
        with self._lock:
            now = self._clock()
            fetched_at = now - age_s
            cur = self._entries.get((provider, key))
            if cur is not None and cur.fetched_at >= fetched_at:
                return False  # ours is as fresh or fresher
            self._entries[(provider, key)] = Entry(
                value=record.get("value"),
                error=record.get("error"),
                fetched_at=fetched_at,
                ttl=ttl,
                stale_ttl=stale_ttl,
                origin=origin,
            )
            self._entries.move_to_end((provider, key))
            self.generation += 1
            if len(self._entries) > self.max_entries:
                self._evict_locked()
        return True

    def drop_provider(self, provider: str) -> None:
        """Invalidate every entry of a provider (spec change/removal —
        a new URL must not serve the old endpoint's answers)."""
        with self._lock:
            for k in [k for k in self._entries if k[0] == provider]:
                del self._entries[k]
            self.generation += 1

    def wipe(self) -> None:
        with self._lock:
            self._entries.clear()
            self.generation += 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
