# Copied from gatekeeper_tpu/externaldata/system.py; only these edits differ.
# Edit: `_fetch` sends an epoch's keys in chunks of the provider's
# `maxKeysPerRequest`, ceil(n / max_keys) requests, where the reference
# sends the first max_keys and drops the rest, whose rows then fetch one
# by one as the interpreter resolves them (ROADMAP §C, C4). Each request
# passes the breaker, is counted and timed as one fetch and records its
# own failure; the first failed chunk ends the epoch's fetch, and the keys
# of the chunks before it stay cached.
"""ExternalDataSystem: the batch plane for out-of-band lookups.

One system per process holds the Provider registry, the TTL response
cache, a per-provider circuit breaker, and the HTTP fetcher. The design
invariant — enforced by tests/test_externaldata.py — is that lookups
ride the micro-batch, not break it:

  * per batch, callers dedupe keys across every pending request and
    call `prefetch()` once; the system issues at most ONE outbound
    fetch per (provider, batch) covering all cold misses (stale keys
    ride along for revalidation);
  * repeat keys answer from the cache (positive, negative, or
    stale-while-revalidate entries — cache.py);
  * `resolve()` (the `external_data` builtin's entry) then serves
    purely from memory in the common case; a provider whose batch fetch
    already failed this epoch is NOT refetched per request — failure
    semantics follow the provider's failurePolicy instead:
      - fail-open: missing keys silently resolve to nothing and the
        response carries `system_error` (error-gated templates allow);
      - fail-closed: missing keys resolve to per-key errors
        (error-gated templates deny with the provider error in the
        admission message — the fail-closed webhook envelope).

Robustness reuses the PR-4 toolkit wholesale: `faults.CircuitBreaker`
per provider (CLOSED→OPEN→HALF_OPEN with probe fetches), named
injection points `externaldata.fetch` / `externaldata.cache`, and the
injectable clock threading through cache TTLs and breaker recovery.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from ..faults import CircuitBreaker, fire
from .cache import HIT, MISS, NEGATIVE_HIT, STALE, ResponseCache
from .provider import (
    EXTERNALDATA_GROUP,
    EXTERNALDATA_VERSION,
    Provider,
    ProviderError,
    provider_from_obj,
)


class UnknownProviderError(KeyError):
    """external_data named a provider that is not registered — the
    builtin surfaces this as an undefined expression (plus a counted
    metric) so a typo'd provider is visible without denying the world."""


class _BreakerMetricsShim:
    """Renames the breaker's device_breaker_* series to the provider
    plane's externaldata_breaker_* (tagged by provider) so provider
    outages never masquerade as device failures on a dashboard."""

    def __init__(self, metrics, provider: str):
        self._m = metrics
        self._p = provider

    def record(self, name: str, value, **tags) -> None:
        tags.pop("plane", None)
        if name == "device_breaker_transitions_total":
            self._m.record(
                "externaldata_breaker_transitions_total", value,
                provider=self._p, **tags,
            )
        elif name == "device_breaker_probes_total":
            self._m.record(
                "externaldata_breaker_probes_total", value,
                provider=self._p, **tags,
            )

    def gauge(self, name: str, value, **tags) -> None:
        if name == "device_breaker_state":
            self._m.gauge(
                "externaldata_breaker_state", value, provider=self._p
            )


class HttpFetcher:
    """Stdlib ProviderRequest/ProviderResponse POST client."""

    def fetch(
        self, provider: Provider, keys: List[str]
    ) -> Tuple[List[Dict[str, Any]], str]:
        """-> (items, system_error). Raises on transport errors."""
        body = json.dumps(
            {
                "apiVersion": f"{EXTERNALDATA_GROUP}/{EXTERNALDATA_VERSION}",
                "kind": "ProviderRequest",
                "request": {"keys": list(keys)},
            }
        ).encode()
        req = urllib.request.Request(
            provider.url,
            data=body,
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        with urllib.request.urlopen(
            req, timeout=provider.timeout_s
        ) as resp:
            payload = json.loads(resp.read().decode())
        response = (payload or {}).get("response") or {}
        items = response.get("items") or []
        if not isinstance(items, list):
            raise ValueError("provider returned malformed items")
        return items, str(response.get("systemError") or "")


class ExternalDataSystem:
    """Provider registry + batch-plane lookup engine."""

    def __init__(
        self,
        metrics=None,
        tracer=None,
        logger=None,
        fetcher=None,
        clock: Callable[[], float] = time.monotonic,
        breaker_threshold: int = 3,
        breaker_recovery_s: float = 30.0,
        # response-cache bound (LRU; docs/externaldata.md): a soak
        # against a high-cardinality key space must evict, never grow
        cache_max_entries: int = 65536,
    ):
        from ..logs import null_logger

        self.metrics = metrics
        self.tracer = tracer
        self.log = logger if logger is not None else null_logger()
        self.fetcher = fetcher if fetcher is not None else HttpFetcher()
        self._clock = clock
        self.breaker_threshold = breaker_threshold
        self.breaker_recovery_s = breaker_recovery_s
        self.cache = ResponseCache(
            clock=clock, max_entries=cache_max_entries, metrics=metrics
        )
        self._lock = threading.Lock()
        self._providers: Dict[str, Provider] = {}
        self._breakers: Dict[str, CircuitBreaker] = {}
        # batch-epoch bookkeeping: a provider whose fetch failed in the
        # current epoch is not refetched until the next begin_batch() —
        # the one-fetch-per-(provider, batch) contract holds under
        # failure too (a flapping endpoint must not be hammered once
        # per flagged row)
        self._epoch = 0
        self._failed_epoch: Dict[str, Tuple[int, str]] = {}
        # stale-while-revalidate: at most one background refresh
        # in-flight per provider
        self._refreshing: Set[str] = set()
        self.fetch_count = 0  # lifetime outbound fetches (tests/bench)
        self.stale_serves = 0
        # fleet.FleetPlane when attached: fresh cache entries publish to
        # peers and per-provider breakers gossip (docs/fleet.md)
        self.fleet = None

    # -- fleet plane (docs/fleet.md) ------------------------------------------

    def set_fleet(self, plane) -> None:
        """Attach the fleet state plane: cache fills wake its publisher
        and every per-provider breaker (current and future) gossips
        trips under `provider:<name>`."""
        self.fleet = plane
        with self._lock:
            breakers = list(self._breakers.items())
        for name, breaker in breakers:
            plane.register_breaker(f"provider:{name}", breaker)

    # -- registry ------------------------------------------------------------

    def upsert(self, obj: Dict[str, Any]) -> Provider:
        p = provider_from_obj(obj)
        new_breaker = None
        with self._lock:
            old = self._providers.get(p.name)
            self._providers[p.name] = p
            if p.name not in self._breakers:
                new_breaker = self._breakers[p.name] = CircuitBreaker(
                    failure_threshold=self.breaker_threshold,
                    recovery_seconds=self.breaker_recovery_s,
                    plane="externaldata",
                    name=f"provider:{p.name}",
                    metrics=(
                        _BreakerMetricsShim(self.metrics, p.name)
                        if self.metrics is not None
                        else None
                    ),
                    tracer=self.tracer,
                    clock=self._clock,
                )
        if new_breaker is not None and self.fleet is not None:
            self.fleet.register_breaker(f"provider:{p.name}", new_breaker)
        if old is not None and old.raw.get("spec") != p.raw.get("spec"):
            # a changed spec (new URL, new TTLs) must not keep serving
            # the old endpoint's cached answers
            self.cache.drop_provider(p.name)
        self.report_gauges()
        return p

    def remove(self, name: str) -> None:
        with self._lock:
            self._providers.pop(name, None)
            self._breakers.pop(name, None)
            self._failed_epoch.pop(name, None)
        if self.fleet is not None:
            self.fleet.unregister_breaker(f"provider:{name}")
        self.cache.drop_provider(name)
        self.report_gauges()

    def wipe(self) -> None:
        """Config wipe/replay partner (the control plane's replayData
        motion): drop every provider; the bounced watches re-upsert."""
        with self._lock:
            names = list(self._breakers)
            self._providers.clear()
            self._breakers.clear()
            self._failed_epoch.clear()
        if self.fleet is not None:
            for name in names:
                self.fleet.unregister_breaker(f"provider:{name}")
        self.cache.wipe()
        self.report_gauges()

    def get(self, name: str) -> Optional[Provider]:
        with self._lock:
            return self._providers.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._providers)

    def breaker(self, name: str) -> Optional[CircuitBreaker]:
        with self._lock:
            return self._breakers.get(name)

    # -- batch plane ---------------------------------------------------------

    def begin_batch(self) -> None:
        """Open a new micro-batch epoch: a provider that failed last
        epoch becomes fetchable again (exactly once)."""
        with self._lock:
            self._epoch += 1

    def prefetch(self, wants: Dict[str, Set[str]]) -> None:
        """The batch plane's entry: {provider -> deduped keys} for one
        micro-batch. Issues at most one outbound fetch per provider
        (cold misses + stale revalidations), sent in requests of at most
        maxKeysPerRequest keys; never raises — failures are recorded for
        resolve() to answer per failurePolicy."""
        for name, keys in wants.items():
            p = self.get(name)
            if p is None or not keys:
                continue
            self._ensure_fetched(p, sorted(keys))

    def _classify(self, p: Provider, keys: List[str]):
        fire("externaldata.cache")
        states = self.cache.classify(p.name, keys)
        if self.metrics is not None:
            by_state: Dict[str, int] = {}
            for st, _ in states.values():
                by_state[st] = by_state.get(st, 0) + 1
            for st, n in by_state.items():
                self.metrics.record(
                    "externaldata_cache_lookups_total", n,
                    provider=p.name, result=st,
                )
        return states

    def _ensure_fetched(self, p: Provider, keys: List[str]) -> None:
        """Fetch whatever this key set needs, within the epoch budget:
        cold misses fetch synchronously (the batch depends on them);
        stale-only refreshes revalidate in the background while the
        stale values serve the batch now."""
        states = self._classify(p, keys)
        misses = [k for k, (st, _) in states.items() if st == MISS]
        stale = [k for k, (st, _) in states.items() if st == STALE]
        if misses:
            with self._lock:
                failed = self._failed_epoch.get(p.name)
                if failed is not None and failed[0] == self._epoch:
                    return  # this batch already paid the failure
            # one outbound fetch covers the misses AND revalidates any
            # stale keys — they're on the wire anyway
            self._fetch(p, sorted(set(misses) | set(stale)))
        elif stale:
            self._refresh_async(p, sorted(stale))

    def _refresh_async(self, p: Provider, keys: List[str]) -> None:
        with self._lock:
            if p.name in self._refreshing:
                return
            self._refreshing.add(p.name)

        def run():
            try:
                self._fetch(p, keys)
            finally:
                with self._lock:
                    self._refreshing.discard(p.name)

        threading.Thread(
            target=run, name=f"gk-extdata-refresh-{p.name}", daemon=True
        ).start()

    def _fetch(self, p: Provider, keys: List[str]) -> bool:
        """Outbound ProviderRequests of at most `p.max_keys` keys each,
        covering every key; populates the cache. Returns True when every
        request succeeded; the first failure records the failure epoch
        and ends the fetch."""
        step = max(1, p.max_keys)
        for i in range(0, len(keys), step):
            if not self._fetch_chunk(p, keys[i : i + step]):
                return False
        with self._lock:
            self._failed_epoch.pop(p.name, None)
        return True

    def _fetch_chunk(self, p: Provider, keys: List[str]) -> bool:
        """One outbound ProviderRequest; populates the cache. Returns
        True on success, records the failure epoch otherwise."""
        from ..obs import start_span

        breaker = self.breaker(p.name)
        if breaker is not None and not breaker.allow():
            self._note_failure(p, "circuit breaker open")
            return False
        t0 = time.perf_counter()
        try:
            fire("externaldata.fetch")
            with start_span(
                self.tracer, "external_fetch",
                provider=p.name, keys=len(keys),
            ):
                items, system_error = self.fetcher.fetch(p, keys)
            if system_error:
                raise RuntimeError(f"provider systemError: {system_error}")
        except Exception as e:
            if breaker is not None:
                breaker.record_failure()
            if self.metrics is not None:
                self.metrics.record(
                    "externaldata_fetches_total", 1,
                    provider=p.name, result="error",
                )
                self.metrics.observe(
                    "externaldata_fetch_seconds",
                    time.perf_counter() - t0,
                    provider=p.name, result="error",
                )
            self._note_failure(p, str(e))
            self.log.error(
                "external data fetch failed",
                process="externaldata",
                provider=p.name,
                keys=len(keys),
                err=e,
            )
            return False
        if breaker is not None:
            breaker.record_success()
        with self._lock:
            self.fetch_count += 1
        by_key = {}
        for item in items:
            if isinstance(item, dict) and "key" in item:
                by_key[str(item["key"])] = item
        for k in keys:
            item = by_key.get(k)
            if item is None:
                # the provider contract is an item per requested key; a
                # silent omission is cached as an error (negative) so it
                # cannot flap between miss-and-refetch every batch
                self.cache.put(
                    p.name, k,
                    error="provider returned no entry for key",
                    ttl=p.negative_ttl_s,
                )
            elif item.get("error"):
                self.cache.put(
                    p.name, k,
                    error=str(item["error"]),
                    ttl=p.negative_ttl_s,
                )
            else:
                self.cache.put(
                    p.name, k,
                    value=item.get("value"),
                    ttl=p.cache_ttl_s,
                    stale_ttl=p.stale_ttl_s,
                )
        if self.metrics is not None:
            self.metrics.record(
                "externaldata_fetches_total", 1,
                provider=p.name, result="ok",
            )
            self.metrics.observe(
                "externaldata_fetch_seconds",
                time.perf_counter() - t0,
                provider=p.name, result="ok",
            )
            self.metrics.observe(
                "externaldata_batch_keys", len(keys), provider=p.name
            )
        if self.fleet is not None:
            # freshly fetched entries are publishable: wake the fleet
            # publisher so peers stop paying this cold fetch
            self.fleet.notify_cache_update()
        return True

    def _note_failure(self, p: Provider, err: str) -> None:
        with self._lock:
            self._failed_epoch[p.name] = (self._epoch, err)

    # -- resolution (the builtin's entry) -------------------------------------

    def probe_clean(self, provider_name: str, key: str) -> bool:
        """Row-feature probe: True iff the key is a usable NON-error
        cache entry (fresh hit or stale-serveable). The fused screen's
        per-row bit is `not all(probe_clean)` — sound for error-gated
        templates because a clean key can never contribute an error
        entry to the resolved response."""
        p = self.get(provider_name)
        if p is None:
            return False
        st, _ = self.cache.classify(p.name, [key])[key]
        return st in (HIT, STALE)

    def resolve(self, provider_name: str, keys: List[str]) -> Dict[str, Any]:
        """Serve one external_data call. Cache-first; leftover misses
        fetch at most once per (provider, epoch); failures answer per
        the provider's failurePolicy. Returns the upstream response
        shape: {responses, errors, status_code, system_error}."""
        from ..obs import start_span

        p = self.get(provider_name)
        if p is None:
            if self.metrics is not None:
                self.metrics.record(
                    "externaldata_requests_total", 1,
                    provider=provider_name, result="unknown_provider",
                )
            raise UnknownProviderError(
                f"external data provider {provider_name!r} is not "
                "registered"
            )
        keys = sorted(set(str(k) for k in keys))
        with start_span(
            self.tracer, "cache_lookup", provider=p.name, keys=len(keys)
        ):
            states = self._classify(p, keys)
        if any(st in (MISS, STALE) for st, _ in states.values()):
            # misses fetch synchronously (the answer depends on them);
            # stale-only key sets revalidate in the background while
            # the stale values serve below
            self._ensure_fetched(p, keys)
            states = self.cache.classify(p.name, keys)
        responses: List[List[Any]] = []
        errors: List[List[str]] = []
        system_error = ""
        result = "ok"
        with self._lock:
            failed = self._failed_epoch.get(p.name)
            fetch_err = (
                failed[1]
                if failed is not None and failed[0] == self._epoch
                else None
            )
        for k in keys:
            st, entry = states[k]
            if st == HIT:
                responses.append([k, entry.value])
            elif st == STALE:
                # stale-while-revalidate: the value answers now; the
                # revalidation already rode this batch's fetch (or a
                # background refresh)
                responses.append([k, entry.value])
                with self._lock:
                    self.stale_serves += 1
                if self.metrics is not None:
                    self.metrics.record(
                        "externaldata_stale_serves_total", 1,
                        provider=p.name,
                    )
            elif st == NEGATIVE_HIT:
                errors.append([k, entry.error])
            else:  # MISS after the fetch attempt: the provider is down
                err = fetch_err or "provider unavailable"
                system_error = err
                result = "unavailable"
                if not p.fail_open:
                    # fail-closed: the missing fact becomes a per-key
                    # error — error-gated templates deny, and the
                    # admission message names the provider and cause
                    errors.append(
                        [k, f"provider {p.name} unavailable "
                            f"(fail-closed): {err}"]
                    )
        if errors and result == "ok":
            result = "error"
        if self.metrics is not None:
            self.metrics.record(
                "externaldata_requests_total", 1,
                provider=p.name, result=result,
            )
        return {
            "responses": responses,
            "errors": errors,
            "status_code": 200 if not system_error else 500,
            "system_error": system_error,
        }

    # -- introspection ---------------------------------------------------------

    def report_gauges(self) -> None:
        if self.metrics is None:
            return
        with self._lock:
            n = len(self._providers)
        self.metrics.gauge("externaldata_providers", n)

    def snapshot(self) -> Dict[str, Any]:
        """Readyz/debug view: per-provider policy + breaker state."""
        with self._lock:
            providers = dict(self._providers)
            breakers = dict(self._breakers)
            failed = dict(self._failed_epoch)
            epoch = self._epoch
        return {
            "providers": {
                name: {
                    "failure_policy": p.failure_policy,
                    "cache_ttl_s": p.cache_ttl_s,
                    "breaker": (
                        breakers[name].snapshot()
                        if name in breakers
                        else None
                    ),
                    "failed_this_epoch": (
                        failed.get(name, (None,))[0] == epoch
                    ),
                }
                for name, p in sorted(providers.items())
            },
            "cache_entries": len(self.cache),
            "cache_evictions": self.cache.evictions,
            "fetches": self.fetch_count,
            "stale_serves": self.stale_serves,
        }
