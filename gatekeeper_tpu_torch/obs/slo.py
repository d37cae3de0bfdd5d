# Copied from gatekeeper_tpu/obs/slo.py; no line below differs.
"""Live SLO & saturation plane: streaming attainment, burn-rate
alerts, and the autoscaler-facing headroom signal (ROADMAP item 3's
measurement substrate — docs/observability.md §SLO & saturation).

Before this module, SLO attainment and capacity existed only OFFLINE:
the soak reporter binned generator samples after the run and the
capacity model probed rps levels out-of-band. The serving plane itself
could not answer "am I meeting my deadline SLO right now, and how much
headroom is left?". This module is that answer, fed at the one seam
every admission already crosses — `DecisionLog.record_decision`, where
verdict, duration and `deadline_slack_ms` are in hand for all three
planes (validation / mutation / agent):

  * **Constant-memory windowed estimator** — a ring of fixed-width
    time windows per plane (and per tenant, bounded) holding
    count/ok/miss/shed plus a fixed-bucket streaming quantile sketch.
    No raw-sample retention: memory is O(planes x slots x buckets)
    regardless of traffic.
  * **Multi-window burn rate** — fast (~1 min) and slow (~15 min)
    windows judged against a configurable attainment objective
    (`SloTarget`, default the soak deadline contract). Burn rate is
    miss-fraction over error budget; `burning` latches on when the
    fast window burns past `burn_threshold` (with the slow window
    confirming) and clears only below `clear_threshold` — hysteresis,
    so a boundary-hugging burn cannot flap the signal. Entering the
    burning state fires ONE `slo_breach` flight record carrying the
    breaching window's attainment/burn numbers; the recorder embeds
    the trigger window's error decision ids (docs/observability.md
    §Flight recorder).
  * **Utilization / headroom** — an EWMA of measured device-seconds
    per admitted row (fed from the batcher's attribution seam through
    `DecisionLog.note_dispatch`) x the live arrival rate gives demand
    vs wall clock; the observed overload fraction (misses + sheds) is
    added because a plane already failing its deadline is saturated
    regardless of what the cost model claims. `saturation in [0, 1]`
    and `estimated_headroom_rps` are the `/readyz` `stats.slo`
    autoscaler contract.

Exported series: `slo_attainment{plane}`, `slo_burn_rate{plane,window}`,
`slo_error_budget_remaining`, `slo_saturation`, and the per-tenant
`slo_tenant_attainment{plane,tenant}` (cardinality-capped by the
registry like every family). `/debug/slo` serves the full snapshot on
both HTTP planes (`export_slo`).
"""

from __future__ import annotations

import json
import math
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

__all__ = [
    "QuantileSketch",
    "SloEngine",
    "SloTarget",
    "export_slo",
]

# verdicts that count as shed (resolved without evaluation) vs error
_SHED_VERDICTS = frozenset(("shed", "unavailable"))
_ERROR_VERDICTS = frozenset(("error",))


@dataclass(frozen=True)
class SloTarget:
    """The single SLO-objective definition shared by the live engine
    and the offline soak reporter (the 0.9/0.95 degrade/recover
    thresholds used to live hardcoded in soak/report.py). Scenario
    files override it via the `slo` key (`from_dict`)."""

    # attainment objective: the fraction of requests that must be
    # answered within deadline; 1 - objective is the error budget
    objective: float = 0.99
    # the deadline the live plane judges durations against; None falls
    # back to the handler's own deadline_slack (request_timeout)
    deadline_s: Optional[float] = None
    # burn-rate evaluation windows
    fast_window_s: float = 60.0
    slow_window_s: float = 900.0
    # hysteresis: burning latches ON at burn_threshold (fast window,
    # slow window confirming at slow_burn_threshold) and OFF only at
    # clear_threshold — the gap is what prevents flapping
    burn_threshold: float = 4.0
    slow_burn_threshold: float = 1.0
    clear_threshold: float = 1.0
    # minimum fast-window sample count before burn is judged (an empty
    # window must never page)
    min_samples: int = 20
    # the offline reporter's phase checks: the fault phase must drop
    # attainment below `degraded_below`, recovery must restore it to
    # `recovered_at` (previously report.py's hardcoded 0.9/0.95)
    degraded_below: float = 0.90
    recovered_at: float = 0.95

    @property
    def error_budget(self) -> float:
        return max(1e-9, 1.0 - self.objective)

    def validate(self) -> None:
        if not (0.0 < self.objective < 1.0):
            raise ValueError("objective must be in (0, 1)")
        if self.fast_window_s <= 0 or self.slow_window_s <= 0:
            raise ValueError("burn windows must be > 0")
        if self.fast_window_s > self.slow_window_s:
            raise ValueError("fast_window_s must be <= slow_window_s")
        if self.clear_threshold > self.burn_threshold:
            raise ValueError(
                "clear_threshold must be <= burn_threshold (hysteresis)"
            )
        if not (0.0 < self.degraded_below <= self.recovered_at <= 1.0):
            raise ValueError(
                "want 0 < degraded_below <= recovered_at <= 1"
            )

    def to_dict(self) -> Dict[str, Any]:
        return {
            "objective": self.objective,
            "deadline_s": self.deadline_s,
            "fast_window_s": self.fast_window_s,
            "slow_window_s": self.slow_window_s,
            "burn_threshold": self.burn_threshold,
            "slow_burn_threshold": self.slow_burn_threshold,
            "clear_threshold": self.clear_threshold,
            "min_samples": self.min_samples,
            "degraded_below": self.degraded_below,
            "recovered_at": self.recovered_at,
        }

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]], **defaults) -> "SloTarget":
        """Build from a scenario's `slo` dict (unknown keys rejected so
        a typoed override fails the scenario load, not the analysis);
        `defaults` seed fields the dict leaves unset (the soak harness
        passes `deadline_s=scenario.deadline_s` — the deadline contract
        IS the default objective's denominator)."""
        d = dict(d or {})
        known = set(cls().to_dict())
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"unknown SloTarget keys: {sorted(unknown)}"
            )
        merged = dict(defaults)
        merged.update(d)
        t = cls(**merged)
        t.validate()
        return t


class QuantileSketch:
    """Fixed-bucket streaming quantile estimator: geometric buckets
    from `BASE` seconds growing by `GROWTH` per bucket, value counts
    only — no raw samples, O(NBUCKETS) memory, mergeable across
    windows (why this over P2: P2 markers cannot be merged, and the
    ring needs per-window sketches summed into per-horizon quantiles).

    Error contract (tests/test_slo.py pins it on adversarial
    distributions): for values within [BASE, BASE*GROWTH^(NBUCKETS-1)]
    the estimate is the geometric midpoint of the true value's bucket,
    so the relative error is bounded by sqrt(GROWTH) - 1 (~12%).
    Values below BASE report BASE (absolute error <= 100 us); values
    above the top edge clamp into the last bucket."""

    BASE = 1e-4          # 100 us
    GROWTH = 1.25
    NBUCKETS = 64        # top edge ~128 s

    __slots__ = ("counts", "n")

    _LOG_GROWTH = math.log(GROWTH)

    def __init__(self) -> None:
        self.counts = [0] * self.NBUCKETS
        self.n = 0

    def _index(self, v: float) -> int:
        if v <= self.BASE:
            return 0
        idx = 1 + int(math.log(v / self.BASE) / self._LOG_GROWTH)
        return min(idx, self.NBUCKETS - 1)

    def add(self, v: float) -> None:
        self.counts[self._index(float(v))] += 1
        self.n += 1

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.n += other.n
        return self

    def _edge(self, i: int) -> float:
        return self.BASE * (self.GROWTH ** i)

    def quantile(self, q: float) -> Optional[float]:
        """Nearest-rank quantile estimate (rank int(q*(n-1)), matching
        sorted_vals[int(q*(n-1))]); None when empty."""
        if self.n <= 0:
            return None
        q = min(1.0, max(0.0, float(q)))
        rank = int(q * (self.n - 1)) + 1  # 1-based
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= rank:
                if i == 0:
                    return self.BASE
                # geometric midpoint of (edge[i-1], edge[i]]
                return math.sqrt(self._edge(i - 1) * self._edge(i))
        return self._edge(self.NBUCKETS - 1)

    def reset(self) -> None:
        for i in range(self.NBUCKETS):
            self.counts[i] = 0
        self.n = 0


class _Win:
    """One fixed-width time window's aggregates."""

    __slots__ = ("epoch", "count", "ok", "miss", "shed", "sketch")

    def __init__(self) -> None:
        self.epoch = -1
        self.count = 0
        self.ok = 0
        self.miss = 0
        self.shed = 0
        self.sketch = QuantileSketch()

    def reset(self, epoch: int) -> None:
        self.epoch = epoch
        self.count = self.ok = self.miss = self.shed = 0
        self.sketch.reset()


class _Ring:
    """`slots` fixed-width windows covering `horizon_s` (one spare so
    the current partial window never overwrites the oldest one still
    inside the horizon). Stale slots are detected by epoch tag, so a
    quiet plane costs nothing and reads correctly after any gap."""

    __slots__ = ("width", "slots", "n")

    def __init__(self, horizon_s: float, slots: int = 12) -> None:
        self.n = max(1, int(slots))
        self.width = float(horizon_s) / self.n
        self.slots = [_Win() for _ in range(self.n + 1)]

    def _win(self, now: float) -> _Win:
        epoch = int(now / self.width)
        w = self.slots[epoch % len(self.slots)]
        if w.epoch != epoch:
            w.reset(epoch)
        return w

    def add(
        self, now: float, ok: bool, shed: bool,
        duration_s: Optional[float],
    ) -> None:
        w = self._win(now)
        w.count += 1
        if shed:
            w.shed += 1
        elif ok:
            w.ok += 1
        else:
            w.miss += 1
        if duration_s is not None:
            w.sketch.add(duration_s)

    def _live(self, now: float) -> List[_Win]:
        floor = int(now / self.width) - self.n + 1
        return [w for w in self.slots if w.epoch >= floor]

    def totals(self, now: float) -> Dict[str, int]:
        live = self._live(now)
        return {
            "count": sum(w.count for w in live),
            "ok": sum(w.ok for w in live),
            "miss": sum(w.miss for w in live),
            "shed": sum(w.shed for w in live),
        }

    def quantile(self, now: float, q: float) -> Optional[float]:
        merged = QuantileSketch()
        for w in self._live(now):
            merged.merge(w.sketch)
        return merged.quantile(q)


def _attainment(t: Dict[str, int]) -> Optional[float]:
    return t["ok"] / t["count"] if t["count"] else None


class _PlaneState:
    __slots__ = ("fast", "slow", "burning")

    def __init__(self, target: SloTarget) -> None:
        self.fast = _Ring(target.fast_window_s, slots=12)
        self.slow = _Ring(target.slow_window_s, slots=15)
        self.burning = False


class SloEngine:
    """The in-process streaming SLO engine. Thread-safe; every public
    entry point is O(ring slots) worst case and never raises into the
    admission path (the DecisionLog seam wraps calls defensively
    anyway). Construct once per replica, share the replica's metrics
    registry and flight recorder."""

    def __init__(
        self,
        target: Optional[SloTarget] = None,
        metrics=None,
        recorder=None,
        replica: Optional[str] = None,
        # per-(plane, tenant) ring bound: past it new tenants aggregate
        # into the overflow counter (the metrics registry's cardinality
        # cap independently bounds the exported per-tenant series)
        max_tenants: int = 64,
        # EWMA smoothing for device-seconds-per-row
        ewma_alpha: float = 0.2,
        clock=time.monotonic,
    ):
        self.target = target or SloTarget()
        self.target.validate()
        self.metrics = metrics
        self.recorder = recorder
        self.replica = replica
        self.max_tenants = max(1, int(max_tenants))
        self.ewma_alpha = float(ewma_alpha)
        self._clock = clock
        self._t0 = clock()
        self._lock = threading.Lock()
        self._planes: Dict[str, _PlaneState] = {}
        self._tenants: Dict[str, _Ring] = {}
        self.tenant_overflow = 0
        self._cost_ewma: Optional[float] = None
        self._cost_samples = 0
        self.breaches = 0
        self.observed = 0
        self._gauge_epoch = -1

    # -- feeds ---------------------------------------------------------------

    def observe(
        self,
        plane: str,
        ok: bool,
        duration_s: Optional[float] = None,
        shed: bool = False,
        tenant: Optional[Any] = None,
    ) -> None:
        """One admission outcome. `ok` = answered within deadline
        (deny IS ok — the SLO is about answering, not admitting);
        `shed` = resolved without evaluation (queue full / deadline
        expired / fail-policy envelope), counted against attainment in
        its own bucket. Called by DecisionLog.record_decision for
        every decision BEFORE sampling, so the estimator sees the full
        stream the ring only samples."""
        now = self._clock()
        fire_ctx: Optional[Dict[str, Any]] = None
        with self._lock:
            self.observed += 1
            st = self._planes.get(plane)
            if st is None:
                st = self._planes[plane] = _PlaneState(self.target)
            st.fast.add(now, ok, shed, duration_s)
            st.slow.add(now, ok, shed, duration_s)
            tkey = self._tenant_key(plane, tenant)
            if tkey is not None:
                ring = self._tenants.get(tkey)
                if ring is None:
                    if len(self._tenants) >= self.max_tenants:
                        self.tenant_overflow += 1
                        ring = None
                    else:
                        ring = self._tenants[tkey] = _Ring(
                            self.target.fast_window_s, slots=12
                        )
                if ring is not None:
                    ring.add(now, ok, shed, duration_s)
            fire_ctx = self._evaluate_burn(plane, st, now)
            gauge_rows = self._maybe_gauge_rows(now)
        # metrics + recorder are self-locking; fire outside our lock
        if gauge_rows:
            self._export_gauges(gauge_rows)
        if fire_ctx is not None and self.recorder is not None:
            self.recorder.trigger("slo_breach", **fire_ctx)

    def reset_windows(self) -> None:
        """Drop every accumulated window (planes + tenants) and restart
        the arrival clock, keeping the cost EWMA and breach counters —
        the soak harness calls this after warmup so live attainment
        measures the same traffic the offline reporter bins."""
        with self._lock:
            self._planes.clear()
            self._tenants.clear()
            self.observed = 0
            self._t0 = self._clock()

    def note_cost(self, device_seconds: float, rows: int = 1) -> None:
        """Measured device-seconds for `rows` admitted rows (the
        batcher's attribution seam: each dispatch's device window split
        over its batch). Feeds the EWMA behind the saturation and
        headroom estimates."""
        if rows <= 0 or device_seconds < 0:
            return
        per_row = float(device_seconds) / rows
        with self._lock:
            if self._cost_ewma is None:
                self._cost_ewma = per_row
            else:
                a = self.ewma_alpha
                self._cost_ewma = a * per_row + (1 - a) * self._cost_ewma
            self._cost_samples += 1

    def cost_per_row(self) -> Optional[float]:
        """The live device-seconds-per-row EWMA (None until the first
        `note_cost`). The admission scheduler's `BatchCostModel` reads
        this to predict a candidate batch's device seconds before the
        cut (gatekeeper_tpu/sched/)."""
        with self._lock:
            return self._cost_ewma

    # -- burn-rate evaluation ------------------------------------------------

    def _burn(self, totals: Dict[str, int]) -> float:
        if not totals["count"]:
            return 0.0
        frac = (totals["miss"] + totals["shed"]) / totals["count"]
        return frac / self.target.error_budget

    def _evaluate_burn(
        self, plane: str, st: _PlaneState, now: float
    ) -> Optional[Dict[str, Any]]:
        """Hysteresis state machine; returns the slo_breach trigger
        context exactly once per entry into the burning state."""
        t = self.target
        ft = st.fast.totals(now)
        burn_fast = self._burn(ft)
        if st.burning:
            if burn_fast <= t.clear_threshold:
                st.burning = False
            return None
        if ft["count"] < t.min_samples:
            return None
        if burn_fast < t.burn_threshold:
            return None
        slo_t = st.slow.totals(now)
        if self._burn(slo_t) < t.slow_burn_threshold:
            return None
        st.burning = True
        self.breaches += 1
        return {
            "plane": plane,
            "objective": t.objective,
            "window_s": t.fast_window_s,
            "attainment_fast": _attainment(ft),
            "burn_rate_fast": round(burn_fast, 3),
            "burn_rate_slow": round(self._burn(slo_t), 3),
            "requests_fast": ft["count"],
            "misses_fast": ft["miss"],
            "sheds_fast": ft["shed"],
        }

    # -- saturation / headroom -----------------------------------------------

    def _overall_fast(self, now: float) -> Dict[str, int]:
        out = {"count": 0, "ok": 0, "miss": 0, "shed": 0}
        for st in self._planes.values():
            t = st.fast.totals(now)
            for k in out:
                out[k] += t[k]
        return out

    def _overall_slow(self, now: float) -> Dict[str, int]:
        out = {"count": 0, "ok": 0, "miss": 0, "shed": 0}
        for st in self._planes.values():
            t = st.slow.totals(now)
            for k in out:
                out[k] += t[k]
        return out

    def _utilization(self, now: float) -> Dict[str, Any]:
        t = self.target
        fast = self._overall_fast(now)
        span = min(t.fast_window_s, max(now - self._t0, 1e-6))
        arrival_rps = fast["count"] / span
        demand = (
            (self._cost_ewma or 0.0) * arrival_rps
        )
        overload = (
            (fast["miss"] + fast["shed"]) / fast["count"]
            if fast["count"] else 0.0
        )
        saturation = min(1.0, max(0.0, demand + overload))
        headroom: Optional[float] = None
        capacity: Optional[float] = None
        if self._cost_ewma and self._cost_ewma > 0:
            capacity = 1.0 / self._cost_ewma
            headroom = max(0.0, (1.0 - saturation) * capacity)
        return {
            "saturation": round(saturation, 4),
            "demand_fraction": round(min(demand, 1e9), 4),
            "overload_fraction": round(overload, 4),
            "arrival_rps": round(arrival_rps, 2),
            "device_seconds_per_row_ewma": (
                round(self._cost_ewma, 9)
                if self._cost_ewma is not None else None
            ),
            "cost_samples": self._cost_samples,
            "estimated_capacity_rps": (
                round(capacity, 1) if capacity is not None else None
            ),
            "estimated_headroom_rps": (
                round(headroom, 1) if headroom is not None else None
            ),
        }

    # -- gauge export ---------------------------------------------------------

    def _maybe_gauge_rows(self, now: float) -> Optional[List[tuple]]:
        """Gauge rows when the fast window rolled since the last
        export (caller holds the lock; emission happens outside it)."""
        if self.metrics is None:
            return None
        width = self.target.fast_window_s / 12.0
        epoch = int(now / width)
        if epoch == self._gauge_epoch:
            return None
        self._gauge_epoch = epoch
        return self._gauge_rows_locked(now)

    def _gauge_rows_locked(self, now: float) -> List[tuple]:
        rows: List[tuple] = []
        for plane, st in sorted(self._planes.items()):
            ft = st.fast.totals(now)
            att = _attainment(ft)
            if att is not None:
                rows.append(("slo_attainment", att, {"plane": plane}))
            rows.append((
                "slo_burn_rate", self._burn(ft),
                {"plane": plane, "window": "fast"},
            ))
            rows.append((
                "slo_burn_rate", self._burn(st.slow.totals(now)),
                {"plane": plane, "window": "slow"},
            ))
        slow = self._overall_slow(now)
        remaining = max(0.0, 1.0 - self._burn(slow))
        rows.append(("slo_error_budget_remaining", remaining, {}))
        util = self._utilization(now)
        rows.append(("slo_saturation", util["saturation"], {}))
        for tkey, ring in self._tenants.items():
            att = _attainment(ring.totals(now))
            if att is None:
                continue
            plane, _, tenant = tkey.partition("/")
            rows.append((
                "slo_tenant_attainment", att,
                {"plane": plane, "tenant": tenant},
            ))
        return rows

    def _export_gauges(self, rows: List[tuple]) -> None:
        # one literal call site per family: the metrics-contract scan
        # (tests/test_metrics_contract.py) matches literal names only,
        # and dynamically-named metrics are deliberately absent from
        # this codebase
        for name, value, tags in rows:
            try:
                if name == "slo_attainment":
                    self.metrics.gauge("slo_attainment", value, **tags)
                elif name == "slo_burn_rate":
                    self.metrics.gauge("slo_burn_rate", value, **tags)
                elif name == "slo_error_budget_remaining":
                    self.metrics.gauge(
                        "slo_error_budget_remaining", value, **tags
                    )
                elif name == "slo_saturation":
                    self.metrics.gauge("slo_saturation", value, **tags)
                elif name == "slo_tenant_attainment":
                    self.metrics.gauge(
                        "slo_tenant_attainment", value, **tags
                    )
            except Exception:
                pass

    # -- reads ----------------------------------------------------------------

    @staticmethod
    def _tenant_key(plane: str, tenant: Any) -> Optional[str]:
        if isinstance(tenant, dict):
            tenant = (
                tenant.get("namespace")
                or tenant.get("agent")
                or tenant.get("username")
                or ""
            )
        tenant = str(tenant or "")
        if not tenant:
            return None
        return f"{plane}/{tenant}"

    def overall_attainment(self, window: str = "slow") -> Optional[float]:
        """Attainment across planes over one burn window — the number
        the soak smoke compares against the offline report."""
        now = self._clock()
        with self._lock:
            t = (
                self._overall_fast(now) if window == "fast"
                else self._overall_slow(now)
            )
            return _attainment(t)

    def autoscaler(self) -> Dict[str, Any]:
        """The `/readyz` `stats.slo` block: the `saturation` and
        `burning` fields are the autoscaler contract (scale up when
        saturation approaches 1 or burning holds true; scale down on
        sustained headroom)."""
        now = self._clock()
        with self._lock:
            util = self._utilization(now)
            fast = self._overall_fast(now)
            return {
                "saturation": util["saturation"],
                "burning": any(
                    st.burning for st in self._planes.values()
                ),
                "estimated_headroom_rps": util["estimated_headroom_rps"],
                "arrival_rps": util["arrival_rps"],
                "attainment": _attainment(fast),
                "objective": self.target.objective,
                "breaches": self.breaches,
            }

    def snapshot(self) -> Dict[str, Any]:
        """The full `/debug/slo` body: per-plane attainment/burn/
        latency-quantiles + burning state, per-tenant fast-window
        attainment, utilization block, and the target definition."""
        now = self._clock()
        with self._lock:
            planes: Dict[str, Any] = {}
            for plane, st in sorted(self._planes.items()):
                ft = st.fast.totals(now)
                sl = st.slow.totals(now)
                p50 = st.fast.quantile(now, 0.50)
                p99 = st.fast.quantile(now, 0.99)
                planes[plane] = {
                    "attainment_fast": _attainment(ft),
                    "attainment_slow": _attainment(sl),
                    "burn_rate_fast": round(self._burn(ft), 3),
                    "burn_rate_slow": round(self._burn(sl), 3),
                    "requests_fast": ft["count"],
                    "requests_slow": sl["count"],
                    "misses_fast": ft["miss"],
                    "sheds_fast": ft["shed"],
                    "p50_ms": (
                        round(p50 * 1e3, 3) if p50 is not None else None
                    ),
                    "p99_ms": (
                        round(p99 * 1e3, 3) if p99 is not None else None
                    ),
                    "burning": st.burning,
                }
            tenants: Dict[str, Any] = {}
            for tkey, ring in sorted(self._tenants.items()):
                t = ring.totals(now)
                if not t["count"]:
                    continue
                tenants[tkey] = {
                    "attainment_fast": _attainment(t),
                    "requests_fast": t["count"],
                }
            slow = self._overall_slow(now)
            snap = {
                "replica": self.replica,
                "target": self.target.to_dict(),
                "observed": self.observed,
                "planes": planes,
                "tenants": tenants,
                "tenant_overflow": self.tenant_overflow,
                "burning": any(
                    st.burning for st in self._planes.values()
                ),
                "breaches": self.breaches,
                "error_budget_remaining": round(
                    max(0.0, 1.0 - self._burn(slow)), 4
                ),
                "utilization": self._utilization(now),
            }
        return snap


def export_slo(slo: SloEngine, path: str = "/debug/slo") -> str:
    """The one `/debug/slo` renderer both HTTP planes (health +
    metrics) share: ?plane= narrows the plane table, ?tenants=0 drops
    the tenant table (docs/observability.md §SLO & saturation)."""
    from urllib.parse import parse_qs, urlparse

    q = parse_qs(urlparse(path).query)
    snap = slo.snapshot()
    plane = (q.get("plane") or [None])[0]
    if plane:
        snap["planes"] = {
            k: v for k, v in snap["planes"].items() if k == plane
        }
        snap["tenants"] = {
            k: v for k, v in snap["tenants"].items()
            if k.startswith(f"{plane}/")
        }
    if (q.get("tenants") or ["1"])[0] in ("0", "false", "no"):
        snap.pop("tenants", None)
    return json.dumps(snap, default=str)
