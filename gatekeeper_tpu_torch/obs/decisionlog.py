# Copied from gatekeeper_tpu/obs/decisionlog.py; only these edits differ.
# Edit: the disk spool is written only to the `dir` the caller passes; the
# GATEKEEPER_TPU_DECISION_DIR fallback is left out.
# Edit: the docstring's first paragraph names the tracing and attribution
# planes instead of the change that brought them, and is rewrapped.
"""Per-admission decision log: the "why" record plane.

Tracing and cost attribution made the plane's COST diagnosable
(traces, per-constraint device seconds, flight records); this module
makes each individual VERDICT diagnosable after the fact. Every handled
admission — validation, mutation, agent review, audit violation — can
leave one bounded `DecisionRecord` answering:

  * **what happened** — allow/deny/error/unavailable, response code,
    the violated constraint keys + messages;
  * **how it was served** — the dispatch route (fused / interp / host /
    degraded), and for partitioned dispatch the exact partition set
    dispatched vs mask-skipped with the rows_dispatched/rows_total
    pruning facts from `partition_match_mask` (ROADMAP item 1's
    dispatched-rows/total-rows instrument);
  * **what it consumed** — render-cache hits, external-data fetches,
    mutation fixpoint iterations, the batch-apportioned device-time
    share, and the deadline slack left at answer time;
  * **who asked** — tenant identity (namespace / username for K8s,
    agent + session for tool calls), joined to everything else by the
    request's trace id (`/debug/traces?trace_id=`).

Retention policy (head+error sampling): denials, errors, sheds,
degraded/host routes, and the slow tail are ALWAYS kept; plain allows
are sampled at 1-in-`allow_sample_n`, deterministically by trace id so
replays and multi-replica views agree on which allows survive. The
ring is bounded (`max_records`) with an optional bounded disk spool
(`dir=`, mirroring the flight
recorder), and appends are token-bucket rate-limited so a shed burst
cannot turn the observability plane itself into the leak
(`decisions_dropped_total`). Served at `/debug/decisions`
(?trace_id= / ?verdict= / ?plane= / ?limit= / ?format=ndjson) on both
HTTP planes. docs/observability.md §Decision log.
"""

from __future__ import annotations

import json
import os
import threading
import time
import zlib
from collections import OrderedDict
from typing import Any, Dict, List, Optional

__all__ = [
    "DECISION_SCHEMA_FIELDS",
    "DecisionLog",
    "check_decision_schema",
]

DEFAULT_MAX_RECORDS = 1024
DEFAULT_ALLOW_SAMPLE_N = 16
DEFAULT_SLOW_MS = 250.0
DEFAULT_MAX_PER_S = 200.0

# fields every DecisionRecord carries (the schema contract test pins
# this against what record() actually builds)
DECISION_SCHEMA_FIELDS = (
    "id", "ts", "plane", "verdict", "code", "trace_id", "route",
    "tenant", "violations", "duration_ms", "sampled",
)

# verdicts that are never sampled out (the "error" half of head+error
# sampling); routes that force retention are judged separately
_ALWAYS_KEEP_VERDICTS = frozenset(
    # verdict_divergence: the shadow oracle's SDC evidence record —
    # far too rare and too important to lose to allow-sampling
    ("deny", "dryrun", "error", "shed", "unavailable",
     "verdict_divergence")
)
_ALWAYS_KEEP_ROUTES = frozenset(
    ("host", "degraded", "fallback", "unavailable")
)


def check_decision_schema(record: Dict[str, Any]) -> List[str]:
    """Missing-field list for one decision record (empty = valid)."""
    return [f for f in DECISION_SCHEMA_FIELDS if f not in record]


class _TokenBucket:
    """Steady-rate admission for ring appends: `rate` tokens/second,
    burst up to `burst`. Callers under a lock of their own — this one
    is self-locking and O(1) per call."""

    def __init__(self, rate: float, burst: Optional[float] = None,
                 clock=time.monotonic):
        self.rate = float(rate)
        self.burst = float(burst if burst is not None else rate)
        self._clock = clock
        self._tokens = self.burst
        self._last = clock()
        self._lock = threading.Lock()

    def allow(self, n: float = 1.0) -> bool:
        if self.rate <= 0:
            return True  # 0/negative disables the limiter
        with self._lock:
            now = self._clock()
            self._tokens = min(
                self.burst, self._tokens + (now - self._last) * self.rate
            )
            self._last = now
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False


def _keep_hash(trace_id: str) -> int:
    """Deterministic sampling hash: stable across processes and runs
    (Python's str hash is salted per process) so every replica keeps
    the SAME 1-in-N allow set for a given trace id."""
    return zlib.crc32(trace_id.encode())


class DecisionLog:
    """Bounded per-admission decision ring + the dispatch-fact side
    channel the micro-batchers feed (`note_dispatch`, keyed by trace
    id) so the handler-level `record()` can explain the route its
    request actually took."""

    def __init__(
        self,
        metrics=None,
        replica: Optional[str] = None,
        max_records: int = DEFAULT_MAX_RECORDS,
        dir: Optional[str] = None,
        # head+error sampling: keep 1 in N plain allows (1 = keep all,
        # 0/None = drop all unforced allows)
        allow_sample_n: Optional[int] = DEFAULT_ALLOW_SAMPLE_N,
        # always keep requests slower than this (the slow tail is
        # exactly what a postmortem wants explained)
        slow_ms: float = DEFAULT_SLOW_MS,
        # token-bucket append ceiling (records/second) shared by the
        # decision ring and the sibling denial logs it gates
        max_per_s: float = DEFAULT_MAX_PER_S,
        # bounded on-disk NDJSON spool (one file, rewritten on
        # rotation) — None/"" = memory only
        clock=time.monotonic,
        # optional SloEngine (obs/slo.py): every record_decision call
        # feeds it BEFORE sampling/rate-gating, so the streaming SLO
        # estimator sees the full stream the ring only samples; also
        # settable post-construction (`log.slo = engine`)
        slo=None,
    ):
        self.metrics = metrics
        self.slo = slo
        self.replica = replica
        self.max_records = max(1, int(max_records))
        self.dir = dir or None
        self.allow_sample_n = (
            int(allow_sample_n) if allow_sample_n else 0
        )
        self.slow_ms = float(slow_ms)
        self._clock = clock
        self._gate = _TokenBucket(max_per_s, clock=clock)
        self._lock = threading.Lock()
        self._ring: List[Dict[str, Any]] = []
        # trace_id -> dispatch facts stashed by the batch worker,
        # popped by record(); bounded so an orphaned fact (a request
        # whose handler died before recording) cannot accumulate
        self._facts: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._facts_max = max(64, self.max_records * 4)
        self._seq = 0
        self._spool_count = 0
        # accounting (snapshot/readyz/soak sampler)
        self.recorded = 0
        self.sampled_out = 0
        self.dropped = 0
        self.denial_log_dropped = 0
        self.route_counts: Dict[str, int] = {}
        # exact per-tenant verdict accounting over the FULL decision
        # stream (counted before sampling/rate gates — the ring only
        # samples, but attainment splits must be exact): the soak
        # reporter's per-tenant SLO-attainment source
        self._tenant_counts: Dict[str, Dict[str, int]] = {}
        self._tenant_counts_max = 64

    # -- dispatch facts (the batch worker's half) -----------------------------

    def note_dispatch(self, trace_id: Optional[str], **facts) -> None:
        """Stash one request's dispatch facts (route, partition set,
        rows, fetch/cache counts, device share) under its trace id for
        the handler-level record() to claim. Non-blocking, bounded,
        and merge-on-repeat — the mutate plane adds fixpoint facts to
        the same trace the validation dispatch already explained."""
        if not trace_id:
            return
        with self._lock:
            cur = self._facts.get(trace_id)
            if cur is None:
                while len(self._facts) >= self._facts_max:
                    self._facts.popitem(last=False)
                self._facts[trace_id] = dict(facts)
            else:
                cur.update(facts)
                self._facts.move_to_end(trace_id)
        # the batch-apportioned device share doubles as the SLO
        # engine's cost sample (saturation/headroom EWMA)
        share = facts.get("device_seconds_share")
        if share is not None and self.slo is not None:
            try:
                self.slo.note_cost(float(share), rows=1)
            except (TypeError, ValueError):
                pass

    def _pop_facts(self, trace_id: Optional[str]) -> Dict[str, Any]:
        if not trace_id:
            return {}
        with self._lock:
            return self._facts.pop(trace_id, None) or {}

    # -- sampling -------------------------------------------------------------

    def _keep_allow(self, trace_id: Optional[str]) -> bool:
        n = self.allow_sample_n
        if n <= 0:
            return False
        if n == 1:
            return True
        if trace_id:
            return _keep_hash(trace_id) % n == 0
        # no trace id: deterministic round-robin on the sequence
        with self._lock:
            seq = self._seq
        return seq % n == 0

    # -- the sibling denial-log gate ------------------------------------------

    def allow_denial_append(self, plane: str = "validation") -> bool:
        """Rate gate for the handlers' denial-log rings: same bucket as
        the decision ring, so a shed/deny storm is bounded across BOTH
        obs sinks (the satellite contract); refusals are counted."""
        if self._gate.allow():
            return True
        self.denial_log_dropped += 1
        if self.metrics is not None:
            self.metrics.record(
                "decisions_dropped_total", 1,
                plane=plane, reason="denial_log_rate",
            )
        return False

    # -- write ----------------------------------------------------------------

    def record_decision(
        self,
        plane: str,
        verdict: str,
        code: int = 200,
        trace_id: Optional[str] = None,
        duration_ms: Optional[float] = None,
        tenant: Optional[Dict[str, Any]] = None,
        violations: Optional[List[Dict[str, Any]]] = None,
        message: str = "",
        deadline_slack_ms: Optional[float] = None,
        **extra,
    ) -> Optional[Dict[str, Any]]:
        """Build + retain one decision record. Returns the record, or
        None when sampling dropped it (plain allow outside the 1-in-N
        head) or the rate gate refused it (burst overload — counted in
        `decisions_dropped_total`). Never raises: the admission path
        calls this inline and a broken field must cost a record, not a
        request."""
        self._observe_slo(
            plane, verdict, duration_ms, deadline_slack_ms, tenant
        )
        self._note_tenant(
            plane, verdict, duration_ms, deadline_slack_ms, tenant
        )
        try:
            return self._record(
                plane, verdict, code, trace_id, duration_ms, tenant,
                violations, message, deadline_slack_ms, extra,
            )
        except Exception:
            return None

    def _observe_slo(
        self, plane, verdict, duration_ms, deadline_slack_ms, tenant,
    ) -> None:
        """The live-SLO seam: runs for EVERY decision, before the
        sampling and rate gates below (the estimator must see the full
        stream), and stamps the `admission_deadline_slack_seconds`
        histogram at the same spot that stamps `deadline_slack_ms`
        into the record. Fully defensive — observability feeds must
        never cost a request."""
        try:
            if self.metrics is not None and deadline_slack_ms is not None:
                # negative slack (deadline already blown) lands in the
                # first bucket, which is exactly the bucket to alarm on
                self.metrics.observe(
                    "admission_deadline_slack_seconds",
                    deadline_slack_ms / 1e3,
                    plane=plane,
                )
            slo = self.slo
            if slo is None:
                return
            shed = verdict in ("shed", "unavailable")
            duration_s = (
                duration_ms / 1e3 if duration_ms is not None else None
            )
            if shed or verdict == "error":
                ok = False
            else:
                # deny IS ok — the SLO is about answering in time, not
                # admitting. Judge vs the target's own deadline when
                # configured (the soak contract), else vs the slack the
                # handler computed from its request timeout.
                deadline = getattr(slo.target, "deadline_s", None)
                if deadline is not None and duration_s is not None:
                    ok = duration_s <= deadline
                elif deadline_slack_ms is not None:
                    ok = deadline_slack_ms >= 0.0
                else:
                    ok = True
            slo.observe(
                plane, ok,
                duration_s=duration_s, shed=shed, tenant=tenant,
            )
        except Exception:
            pass

    @staticmethod
    def _tenant_label(plane: str, tenant) -> Optional[str]:
        """`plane/name` identity matching the SLO engine's tenant key
        convention (namespace or agent or username)."""
        if not tenant:
            return None
        if isinstance(tenant, dict):
            name = str(
                tenant.get("namespace") or tenant.get("agent")
                or tenant.get("username") or ""
            )
        else:
            name = str(tenant)
        return f"{plane}/{name}" if name else None

    def _note_tenant(
        self, plane, verdict, duration_ms, deadline_slack_ms, tenant,
    ) -> None:
        """Exact per-tenant ok/miss/shed counters over the full stream;
        ok is judged the same way `_observe_slo` judges it (the SLO
        target deadline when configured, else the handler slack)."""
        try:
            key = self._tenant_label(plane, tenant)
            if key is None:
                return
            shed = verdict in ("shed", "unavailable")
            if shed or verdict == "error":
                ok = False
            else:
                slo = self.slo
                deadline = (
                    getattr(slo.target, "deadline_s", None)
                    if slo is not None else None
                )
                if deadline is not None and duration_ms is not None:
                    ok = duration_ms / 1e3 <= deadline
                elif deadline_slack_ms is not None:
                    ok = deadline_slack_ms >= 0.0
                else:
                    ok = True
            with self._lock:
                st = self._tenant_counts.get(key)
                if st is None:
                    if len(self._tenant_counts) >= self._tenant_counts_max:
                        key = f"{plane}/(other)"
                        st = self._tenant_counts.get(key)
                    if st is None:
                        st = self._tenant_counts[key] = {
                            "count": 0, "ok": 0, "miss": 0, "shed": 0,
                        }
                st["count"] += 1
                if shed:
                    st["shed"] += 1
                elif ok:
                    st["ok"] += 1
                else:
                    st["miss"] += 1
        except Exception:
            pass

    def tenant_stats(self) -> Dict[str, Dict[str, Any]]:
        """Per-tenant attainment/shed split read straight from the
        decision stream (exact, not sampled): `{plane/name: {count, ok,
        miss, shed, attainment}}` — the soak reporter's headline for
        the multi-tenant overload scenario."""
        with self._lock:
            out: Dict[str, Dict[str, Any]] = {}
            for key, st in sorted(self._tenant_counts.items()):
                row = dict(st)
                row["attainment"] = (
                    round(st["ok"] / st["count"], 6) if st["count"] else None
                )
                out[key] = row
            return out

    def _record(
        self, plane, verdict, code, trace_id, duration_ms, tenant,
        violations, message, deadline_slack_ms, extra,
    ) -> Optional[Dict[str, Any]]:
        facts = self._pop_facts(trace_id)
        route = str(facts.get("route") or extra.pop("route", "") or "")
        slow = (
            duration_ms is not None and duration_ms >= self.slow_ms
        )
        forced = (
            verdict in _ALWAYS_KEEP_VERDICTS
            or route in _ALWAYS_KEEP_ROUTES
            or slow
        )
        sampled = not forced
        if sampled and not self._keep_allow(trace_id):
            self.sampled_out += 1
            if self.metrics is not None:
                self.metrics.record(
                    "decisions_sampled_out_total", 1, plane=plane
                )
            return None
        if not self._gate.allow():
            self.dropped += 1
            if self.metrics is not None:
                self.metrics.record(
                    "decisions_dropped_total", 1,
                    plane=plane, reason="rate_limited",
                )
            return None
        with self._lock:
            self._seq += 1
            seq = self._seq
        record: Dict[str, Any] = {
            "id": f"d-{seq:06d}",
            "ts": time.time(),
            "t_monotonic": self._clock(),
            "plane": plane,
            "verdict": verdict,
            "code": int(code),
            "trace_id": trace_id,
            "route": route or None,
            "tenant": tenant or {},
            "violations": violations or [],
            "duration_ms": (
                round(duration_ms, 3) if duration_ms is not None else None
            ),
            "sampled": sampled,
        }
        if self.replica is not None:
            record["replica"] = self.replica
        if message:
            record["message"] = message[:512]
        if deadline_slack_ms is not None:
            record["deadline_slack_ms"] = round(deadline_slack_ms, 3)
        # dispatch facts (partitions dispatched/skipped, rows, cache/
        # fetch counts, device share, fixpoint iterations) ride as-is
        for k, v in facts.items():
            if k != "route":
                record[k] = v
        for k, v in extra.items():
            record[k] = v
        with self._lock:
            self._ring.append(record)
            if len(self._ring) > self.max_records:
                del self._ring[: len(self._ring) - self.max_records]
            self.recorded += 1
            rkey = route or "unknown"
            self.route_counts[rkey] = self.route_counts.get(rkey, 0) + 1
        if self.metrics is not None:
            self.metrics.record(
                "decisions_recorded_total", 1,
                plane=plane, verdict=verdict,
            )
        self._spool(record)
        return record

    def _spool(self, record: Dict[str, Any]) -> None:
        """Bounded disk mirror: NDJSON appends, file rewritten from the
        (bounded) ring every `max_records` appends so the spool can
        never outgrow ~2x the ring. Best-effort — a full disk must not
        take the admission path down."""
        if not self.dir:
            return
        try:
            os.makedirs(self.dir, exist_ok=True)
            path = os.path.join(self.dir, "decisions.ndjson")
            self._spool_count += 1
            if self._spool_count % self.max_records == 0:
                tmp = path + ".tmp"
                with self._lock:
                    ring = list(self._ring)
                with open(tmp, "w") as f:
                    for r in ring:
                        f.write(json.dumps(r) + "\n")
                os.replace(tmp, path)
            else:
                with open(path, "a") as f:
                    f.write(json.dumps(record) + "\n")
        except (OSError, ValueError, TypeError):
            pass

    # -- read -----------------------------------------------------------------

    def records(
        self,
        trace_id: Optional[str] = None,
        verdict: Optional[str] = None,
        plane: Optional[str] = None,
        limit: int = 100,
    ) -> List[Dict[str, Any]]:
        """Newest-first filtered view (the `/debug/decisions` body)."""
        with self._lock:
            rows = list(reversed(self._ring))
        if trace_id is not None:
            rows = [r for r in rows if r.get("trace_id") == trace_id]
        if verdict is not None:
            rows = [r for r in rows if r.get("verdict") == verdict]
        if plane is not None:
            rows = [r for r in rows if r.get("plane") == plane]
        return rows[: max(1, int(limit))]

    def recent_errors(
        self, window_s: float = 30.0, limit: int = 32
    ) -> List[Dict[str, Any]]:
        """Newest-first non-allow / degraded decisions within the last
        `window_s` — the trigger-window set a flight record embeds so a
        postmortem names the exact requests that failed."""
        horizon = self._clock() - window_s
        out = []
        with self._lock:
            for r in reversed(self._ring):
                if r.get("t_monotonic", 0.0) < horizon:
                    break
                if (
                    r.get("verdict") in _ALWAYS_KEEP_VERDICTS
                    or (r.get("route") or "") in _ALWAYS_KEEP_ROUTES
                ):
                    out.append(r)
                    if len(out) >= limit:
                        break
        return out

    def export_json(self, **query) -> str:
        return json.dumps({
            "replica": self.replica,
            "recorded": self.recorded,
            "sampled_out": self.sampled_out,
            "dropped": self.dropped,
            "max_records": self.max_records,
            "decisions": self.records(**query),
        }, default=str)

    def export_ndjson(self, **query) -> str:
        """One decision per line — the `?format=ndjson` export shape
        log shippers ingest without unwrapping."""
        return "".join(
            json.dumps(r, default=str) + "\n"
            for r in self.records(**query)
        )

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "recorded": self.recorded,
                "sampled_out": self.sampled_out,
                "dropped": self.dropped,
                "denial_log_dropped": self.denial_log_dropped,
                "retained": len(self._ring),
                "pending_facts": len(self._facts),
                "routes": dict(self.route_counts),
                "tenant_keys": len(self._tenant_counts),
            }
