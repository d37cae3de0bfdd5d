# Copied from gatekeeper_tpu/sched/scheduler.py; no line below differs.
"""The admission scheduler: deadline-driven batch formation, predictive
shedding, and per-tenant fair-share quotas.

`AdmissionScheduler` is the decision core the `MicroBatcher` planes
delegate to at two seams:

  * `offer()` — called under the batcher lock for every `submit()`:
    decides admit / shed (and, when the queue is full but the newcomer
    is viable, picks a queued *victim* that provably cannot make its
    deadline — predictive shedding evicts the doomed, not the newest);
  * `cut()` — called by the batch worker when the coalescing window
    closes: orders the pending queue earliest-deadline-first and cuts
    the largest prefix whose predicted device seconds (the
    `BatchCostModel`: live SLO cost EWMA, seeded by `CostAttributor`
    static costs) does not blow the earliest member deadline, so an
    urgent small batch preempts a large cheap one.

Per-tenant token buckets are refilled at the max-min fair share
(`fair_shares`, classic water-filling) of the capacity implied by
`SloEngine.autoscaler()` (`arrival_rps + estimated_headroom_rps`).
Quota caps and predictive shedding engage only while the plane is
*overloaded* — saturation at or above the overload threshold, which the
`autoscaler()` feedback loop lowers while the error budget is burning —
so an unloaded plane admits exactly what FIFO would.

Policy `"fifo"` short-circuits everything: arrival-order batches and
`queue_full` shedding of the newest arrival at `max_queue`, bit-compatible
with the pre-scheduler queue (the `--sched-policy fifo` rollback path).

Deadlines arrive from two front doors and are indistinguishable here:
the HTTP path derives one from the server's request timeout, while the
framed ingest path (docs/ingest.md §Wire format) stamps the budget in
the frame header — `FLAG_DEADLINE` + ms — so EDF ordering and
predictive shedding see the caller's real deadline before the payload
JSON has even been decoded.

Shed reasons (typed on `ShedError`, landing in decision records):

  * `queue_full`      — bounded queue at capacity, no viable victim;
  * `predicted_miss`  — predicted queue-wait + batch cost exceeds the
    request's remaining slack (`predicted_slack_ms` is negative);
  * `tenant_capped`   — the tenant's fair-share bucket is empty while
    the plane is overloaded.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..faults import ShedError

__all__ = [
    "POLICIES",
    "AdmissionScheduler",
    "BatchCostModel",
    "TokenBucket",
    "export_sched",
    "fair_shares",
]

POLICIES = ("fifo", "deadline")

# saturation at/above which quota caps + predictive shedding engage;
# the burn-rate feedback loop drops the threshold while the SLO error
# budget is burning (shed earlier when attainment is already bleeding)
DEFAULT_OVERLOAD_SATURATION = 0.9
BURNING_OVERLOAD_SATURATION = 0.75

# deadline classes for the bounded `class` metric label (never tenant
# names — the registry's cardinality guard is per-family)
URGENT_SLACK_S = 2.0

_FEEDBACK_INTERVAL_S = 0.5
_QUOTA_REFRESH_S = 1.0
_ACTIVE_WINDOW_S = 10.0
_MIN_SHARE_RPS = 1.0
_BURST_S = 2.0
_ARRIVAL_ALPHA = 0.2

# cold-start cost estimate before any measured signal exists
_DEFAULT_PER_ROW_S = 2e-4
# rows an "average dispatch" is assumed to carry when only the
# attributor's per-dispatch static total is available
_NOMINAL_DISPATCH_ROWS = 64


def fair_shares(
    demands: Dict[str, float], capacity: float, floor: float = 0.0
) -> Dict[str, float]:
    """Max-min fair (water-filling) apportionment of `capacity` rps
    across tenants by demand: tenants demanding less than the even
    split keep their demand; the freed surplus is re-split among the
    heavier tenants. Deterministic (ties broken by key) and exact —
    the unit battery pins the arithmetic."""
    if not demands:
        return {}
    out: Dict[str, float] = {}
    remaining = max(float(capacity), 0.0)
    items = sorted(demands.items(), key=lambda kv: (kv[1], kv[0]))
    n = len(items)
    for i, (key, demand) in enumerate(items):
        even = remaining / (n - i)
        grant = min(max(float(demand), 0.0), even)
        out[key] = max(grant, floor)
        remaining -= grant
    return out


class TokenBucket:
    """Fair-share quota bucket. `take()` always charges the request
    (usage tracking stays exact across overload transitions) but the
    debt is bounded at one burst window; the return value says whether
    the tenant was within budget."""

    __slots__ = ("rate", "burst", "tokens", "stamp")

    def __init__(self, rate_rps: float, now: float, burst_s: float = _BURST_S):
        self.rate = max(float(rate_rps), 1e-3)
        self.burst = max(self.rate * burst_s, 1.0)
        self.tokens = self.burst
        self.stamp = float(now)

    def set_rate(self, rate_rps: float, burst_s: float = _BURST_S) -> None:
        self.rate = max(float(rate_rps), 1e-3)
        self.burst = max(self.rate * burst_s, 1.0)

    def take(self, now: float, n: float = 1.0) -> bool:
        now = float(now)
        if now > self.stamp:
            self.tokens = min(
                self.burst, self.tokens + (now - self.stamp) * self.rate
            )
        self.stamp = max(self.stamp, now)
        covered = self.tokens >= n
        self.tokens = max(self.tokens - n, -self.burst)
        return covered


class BatchCostModel:
    """Predicted device seconds for an n-row batch.

    Resolution order for the per-row cost: an injected `per_row_fn`
    (the unit battery's fake attributor), the live `SloEngine` cost
    EWMA (fed by `device_seconds_share` dispatch facts), the
    `CostAttributor` static per-dispatch total amortized over a nominal
    batch, then a cold-start constant."""

    def __init__(
        self,
        slo=None,
        attributor=None,
        per_row_fn: Optional[Callable[[], Optional[float]]] = None,
        default_per_row_s: float = _DEFAULT_PER_ROW_S,
    ):
        self.slo = slo
        self.attributor = attributor
        self.per_row_fn = per_row_fn
        self.default_per_row_s = default_per_row_s

    def per_row_seconds(self) -> float:
        if self.per_row_fn is not None:
            v = self.per_row_fn()
            if v is not None and v > 0:
                return float(v)
        slo = self.slo
        if slo is not None:
            v = slo.cost_per_row()
            if v is not None and v > 0:
                return float(v)
        att = self.attributor
        if att is not None and getattr(att, "dispatches", 0):
            total = float(getattr(att, "total_seconds", 0.0))
            per_dispatch = total / max(att.dispatches, 1)
            if per_dispatch > 0:
                return per_dispatch / _NOMINAL_DISPATCH_ROWS
        return self.default_per_row_s

    def predict(self, n_rows: int) -> float:
        return self.per_row_seconds() * max(int(n_rows), 0)


class _Tenant:
    __slots__ = (
        "bucket", "last_seen", "last_arrival", "arrival_ewma",
        "share_rps", "admitted", "shed", "throttled",
    )

    def __init__(self, now: float, rate_rps: float):
        self.bucket = TokenBucket(rate_rps, now)
        self.last_seen = now
        self.last_arrival = now
        self.arrival_ewma = rate_rps
        self.share_rps = rate_rps
        self.admitted = 0
        self.shed = 0
        self.throttled = 0


class AdmissionScheduler:
    """Per-plane admission scheduling policy (one instance per
    `MicroBatcher`). Pending-queue items are the batcher's tuples;
    the scheduler only reads index 4 (deadline) and index 5 (tenant
    key), so the unit battery drives it with plain tuples."""

    DEADLINE_IDX = 4
    TENANT_IDX = 5

    def __init__(
        self,
        plane: str = "validation",
        policy: str = "fifo",
        max_queue: Optional[int] = 2048,
        clock: Callable[[], float] = time.monotonic,
        cost_model: Optional[BatchCostModel] = None,
        slo=None,
        attributor=None,
        metrics=None,
        max_tenants: int = 64,
        overload_saturation: float = DEFAULT_OVERLOAD_SATURATION,
        burning_saturation: float = BURNING_OVERLOAD_SATURATION,
        min_share_rps: float = _MIN_SHARE_RPS,
    ):
        if policy not in POLICIES:
            raise ValueError(
                f"sched policy must be one of {POLICIES}, got {policy!r}"
            )
        self.plane = plane
        self.policy = policy
        self.max_queue = max_queue
        self.clock = clock
        self.metrics = metrics
        self.slo = slo
        self.cost = cost_model if cost_model is not None else BatchCostModel(
            slo=slo, attributor=attributor
        )
        self.max_tenants = max_tenants
        self.overload_saturation = overload_saturation
        self.burning_saturation = burning_saturation
        self.min_share_rps = min_share_rps
        self._lock = threading.RLock()
        self._tenants: Dict[str, _Tenant] = {}
        self._sheds: Dict[str, int] = {
            "queue_full": 0, "predicted_miss": 0, "tenant_capped": 0,
        }
        self.admitted = 0
        self.cuts = 0
        self.last_cut: Dict[str, Any] = {}
        # autoscaler feedback state (refreshed at most every
        # _FEEDBACK_INTERVAL_S so offer() stays O(1) on the hot path)
        self._saturation = 0.0
        self._headroom_rps = 0.0
        self._arrival_rps = 0.0
        self._threshold = overload_saturation
        self._overloaded = False
        self._last_feedback = float("-inf")
        self._last_requota = float("-inf")

    # -- tenant identity -----------------------------------------------------

    @staticmethod
    def tenant_key(tenant: Any) -> Optional[str]:
        """The decision-log tenant identity: namespace (or username)
        on the K8s planes, agent/session on the agent plane."""
        if not tenant:
            return None
        if isinstance(tenant, dict):
            agent = str(tenant.get("agent") or "")
            if agent:
                session = str(tenant.get("session") or "")
                return f"{agent}/{session}" if session else agent
            name = str(
                tenant.get("namespace") or tenant.get("username") or ""
            )
            return name or None
        return str(tenant) or None

    def classify(self, deadline: Optional[float], now: float) -> str:
        """Bounded deadline class for the `class` metric label."""
        if deadline is None:
            return "none"
        return "urgent" if (deadline - now) <= URGENT_SLACK_S else "standard"

    # -- the enqueue-side decision -------------------------------------------

    def offer(
        self,
        pending: Sequence[Tuple],
        tenant: Any = None,
        deadline: Optional[float] = None,
        now: Optional[float] = None,
    ) -> Tuple[Optional[str], Optional[ShedError], Optional[Tuple[int, ShedError]]]:
        """Admission decision for one request about to enqueue.

        Returns `(tenant_key, self_shed, victim)`: `self_shed` is the
        typed exception to fail THIS request with (None = admit);
        `victim` is `(pending_index, exception)` for a queued request
        the caller must evict to make room (predictive shedding under a
        full queue — the doomed request goes, not the newest)."""
        if now is None:
            now = self.clock()
        key = self.tenant_key(tenant)
        if self.policy == "fifo":
            if self.max_queue is not None and len(pending) >= self.max_queue:
                with self._lock:
                    self._sheds["queue_full"] += 1
                self._shed_metric("queue_full", False)
                return key, ShedError(
                    f"admission queue full ({self.max_queue} pending)"
                ), None
            with self._lock:
                self.admitted += 1
            return key, None, None
        with self._lock:
            self._refresh(now)
            st = self._note_arrival(key, now)
            depth = len(pending)
            capped = st is not None and not st.bucket.take(now)
            if self._overloaded and capped:
                st.throttled += 1
                st.shed += 1
                self._sheds["tenant_capped"] += 1
                self._shed_metric("tenant_capped", True)
                if self.metrics is not None:
                    self.metrics.record(
                        "sched_tenant_throttled_total", 1, plane=self.plane
                    )
                return key, ShedError(
                    f"tenant {key} over fair-share admission quota",
                    reason="tenant_capped",
                    tenant_capped=True,
                ), None
            slack_ms = None
            if deadline is not None:
                predicted_done = now + self.cost.predict(depth + 1)
                slack_ms = (deadline - predicted_done) * 1e3
            if self._overloaded and slack_ms is not None and slack_ms < 0:
                if st is not None:
                    st.shed += 1
                self._sheds["predicted_miss"] += 1
                self._shed_metric("predicted_miss", capped)
                return key, ShedError(
                    f"predicted deadline miss ({slack_ms:.1f}ms slack "
                    f"at queue depth {depth})",
                    reason="predicted_miss",
                    predicted_slack_ms=slack_ms,
                    tenant_capped=capped,
                ), None
            if self.max_queue is not None and depth >= self.max_queue:
                victim = self._find_victim(pending, now)
                if victim is not None:
                    idx, vexc = victim
                    vkey = self._item_tenant(pending[idx])
                    vst = self._tenants.get(vkey) if vkey else None
                    if vst is not None:
                        vst.shed += 1
                    self._sheds["predicted_miss"] += 1
                    self._shed_metric("predicted_miss", False)
                    if st is not None:
                        st.admitted += 1
                    self.admitted += 1
                    return key, None, victim
                self._sheds["queue_full"] += 1
                self._shed_metric("queue_full", capped)
                return key, ShedError(
                    f"admission queue full ({self.max_queue} pending)",
                    tenant_capped=capped,
                ), None
            if st is not None:
                st.admitted += 1
            self.admitted += 1
            return key, None, None

    def _item_tenant(self, item: Tuple) -> Optional[str]:
        return item[self.TENANT_IDX] if len(item) > self.TENANT_IDX else None

    def _find_victim(
        self, pending: Sequence[Tuple], now: float
    ) -> Optional[Tuple[int, ShedError]]:
        """The queued request with the most negative predicted slack —
        it provably cannot make its deadline, so evicting it costs no
        attainment."""
        predicted_done = now + self.cost.predict(len(pending))
        worst_i = -1
        worst_slack = 0.0
        for i, item in enumerate(pending):
            dl = item[self.DEADLINE_IDX]
            if dl is None:
                continue
            slack_ms = (dl - predicted_done) * 1e3
            if slack_ms < worst_slack:
                worst_slack = slack_ms
                worst_i = i
        if worst_i < 0:
            return None
        return worst_i, ShedError(
            f"predicted deadline miss ({worst_slack:.1f}ms slack, "
            f"evicted for a viable arrival)",
            reason="predicted_miss",
            predicted_slack_ms=worst_slack,
        )

    # -- the dispatch-side decision ------------------------------------------

    def cut(
        self,
        pending: List[Tuple],
        max_batch: int,
        now: Optional[float] = None,
    ) -> Tuple[List[Tuple], List[Tuple]]:
        """Choose the batch to dispatch when the coalescing window
        closes. FIFO takes everything in arrival order (bit-compatible
        with the pre-scheduler swap); deadline policy orders EDF and
        cuts the largest prefix whose predicted completion stays inside
        the earliest member deadline."""
        if not pending:
            return [], []
        if self.policy == "fifo":
            return list(pending), []
        if now is None:
            now = self.clock()
        ordered = sorted(
            pending,
            key=lambda it: (
                it[self.DEADLINE_IDX] is None,
                it[self.DEADLINE_IDX] or 0.0,
            ),
        )
        take = 0
        min_dl: Optional[float] = None
        for item in ordered:
            if take >= max_batch:
                break
            dl = item[self.DEADLINE_IDX]
            cand_min = min_dl if dl is None else (
                dl if min_dl is None else min(min_dl, dl)
            )
            predicted_done = now + self.cost.predict(take + 1)
            if take > 0 and cand_min is not None and predicted_done > cand_min:
                break
            min_dl = cand_min
            take += 1
        batch, rest = ordered[:take], ordered[take:]
        predicted = self.cost.predict(len(batch))
        with self._lock:
            self.cuts += 1
            self.last_cut = {
                "size": len(batch),
                "predicted_seconds": round(predicted, 9),
                "deferred": len(rest),
            }
        if self.metrics is not None:
            self.metrics.observe(
                "sched_batch_predicted_seconds", predicted, plane=self.plane
            )
            depths: Dict[str, int] = {"urgent": 0, "standard": 0, "none": 0}
            for item in rest:
                depths[self.classify(item[self.DEADLINE_IDX], now)] += 1
            for cls, depth in depths.items():
                self.metrics.gauge(
                    "sched_queue_depth", depth, plane=self.plane, **{
                        "class": cls
                    }
                )
        return batch, rest

    # -- feedback + quotas ---------------------------------------------------

    def _shed_metric(self, reason: str, tenant_capped: bool) -> None:
        # the fifo rollback path emits no sched_* series: its sheds are
        # already fully accounted by webhook_shed_total, and a baseline
        # run should look exactly like the pre-scheduler plane
        if self.metrics is not None and self.policy != "fifo":
            self.metrics.record(
                "sched_shed_total", 1, plane=self.plane, reason=reason,
                tenant_capped="true" if tenant_capped else "false",
            )

    def _refresh(self, now: float) -> None:
        if now - self._last_feedback >= _FEEDBACK_INTERVAL_S:
            self._last_feedback = now
            if self.slo is not None:
                try:
                    auto = self.slo.autoscaler()
                except Exception:
                    auto = None
                if auto:
                    self._saturation = float(auto.get("saturation") or 0.0)
                    self._headroom_rps = float(
                        auto.get("estimated_headroom_rps") or 0.0
                    )
                    self._arrival_rps = float(auto.get("arrival_rps") or 0.0)
                    self._threshold = (
                        self.burning_saturation
                        if auto.get("burning")
                        else self.overload_saturation
                    )
                    self._overloaded = self._saturation >= self._threshold
        if now - self._last_requota >= _QUOTA_REFRESH_S:
            self._last_requota = now
            self._requota(now)

    def _note_arrival(self, key: Optional[str], now: float) -> Optional[_Tenant]:
        if key is None:
            return None
        st = self._tenants.get(key)
        if st is None:
            if len(self._tenants) >= self.max_tenants:
                stalest = min(
                    self._tenants, key=lambda k: self._tenants[k].last_seen
                )
                del self._tenants[stalest]
            st = _Tenant(now, self.min_share_rps)
            self._tenants[key] = st
        else:
            dt = now - st.last_arrival
            if dt > 0:
                inst = min(1.0 / dt, 1e5)
                st.arrival_ewma = (
                    _ARRIVAL_ALPHA * inst
                    + (1 - _ARRIVAL_ALPHA) * st.arrival_ewma
                )
            st.last_arrival = now
        st.last_seen = now
        return st

    def _requota(self, now: float) -> None:
        active = {
            k: st for k, st in self._tenants.items()
            if now - st.last_seen <= _ACTIVE_WINDOW_S
        }
        if not active:
            return
        capacity = max(self._arrival_rps + self._headroom_rps, 0.0)
        if capacity <= 0:
            # no saturation signal yet: apportion observed demand (no
            # effective cap — nobody is throttled below what they send)
            capacity = sum(st.arrival_ewma for st in active.values())
        demands = {k: st.arrival_ewma for k, st in active.items()}
        shares = fair_shares(demands, capacity, floor=self.min_share_rps)
        even = capacity / len(active)
        for k, st in active.items():
            # the enforcement cap: never below the even split (max-min
            # fairness caps nobody under their fair share), never below
            # the floor — quiet tenants keep burst headroom
            st.share_rps = max(shares.get(k, 0.0), even, self.min_share_rps)
            st.bucket.set_rate(st.share_rps)

    # -- read ----------------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """The `/debug/sched` + `stats.sched` document for this plane:
        policy, overload state, shed counters by reason, and the
        per-tenant quota/usage/shed table."""
        with self._lock:
            tenants = {
                k: {
                    "share_rps": round(st.share_rps, 3),
                    "tokens": round(st.bucket.tokens, 3),
                    "arrival_rps": round(st.arrival_ewma, 3),
                    "admitted": st.admitted,
                    "shed": st.shed,
                    "throttled": st.throttled,
                }
                for k, st in sorted(self._tenants.items())
            }
            return {
                "plane": self.plane,
                "policy": self.policy,
                "overloaded": self._overloaded,
                "saturation": round(self._saturation, 4),
                "overload_threshold": round(self._threshold, 4),
                "headroom_rps": round(self._headroom_rps, 3),
                "arrival_rps": round(self._arrival_rps, 3),
                "cost_per_row_s": round(self.cost.per_row_seconds(), 9),
                "admitted": self.admitted,
                "cuts": self.cuts,
                "last_cut": dict(self.last_cut),
                "sheds": dict(self._sheds),
                "tenants": tenants,
            }


def export_sched(snapshots: Dict[str, Dict[str, Any]], path: str = "") -> str:
    """Render the `/debug/sched` document (both HTTP planes serve it:
    the runner's readyz handler and `serve_metrics`). `?plane=` filters
    to one plane; `?tenants=0` drops the per-tenant tables."""
    query: Dict[str, str] = {}
    if "?" in path:
        for part in path.split("?", 1)[1].split("&"):
            if "=" in part:
                k, v = part.split("=", 1)
                query[k] = v
    planes = dict(snapshots or {})
    want = query.get("plane")
    if want:
        planes = {k: v for k, v in planes.items() if k == want}
    if query.get("tenants") == "0":
        planes = {
            k: {kk: vv for kk, vv in v.items() if kk != "tenants"}
            for k, v in planes.items()
        }
    return json.dumps({"planes": planes}, sort_keys=True, indent=1)
