# Copied from gatekeeper_tpu/audit/manager.py; only this edit differs.
# Edit: with `freeze_after_sweep` set (the Runner sets it), each completed
# sweep ends with gc.freeze(), which moves the corpus it built out of the
# cyclic collector's reach.
"""Audit sweep manager.

Mirrors the behavioral contract of pkg/audit/manager.go:
  * sweep cadence `audit_interval` (default 60s, manager.go:42,344-358);
  * per-constraint violation cap `constraint_violations_limit`
    (default 20, manager.go:43,49,499-506);
  * violation messages truncated to `msg_size` bytes with a "..."
    suffix (manager.go:503,560-568);
  * per-constraint status records carrying audit timestamp, total
    violation count, and the capped violation details
    (manager.go:493-558), plus per-enforcement-action totals
    (manager.go:400-446).

The reference writes statuses to each Constraint CR's
`status.violations` via the K8s API with retry/backoff
(manager.go:581-639); here publication goes through a pluggable
`StatusSink` (in-memory by default; the control-plane layer provides a
cluster-backed one).

The data path difference is the point: instead of one interpreted query
per object (manager.go:318), one `Client.audit()` call sweeps the whole
cached state through the TPU driver's fused kernel.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ..faults import fire

DEFAULT_AUDIT_INTERVAL = 60.0
DEFAULT_CONSTRAINT_VIOLATIONS_LIMIT = 20
DEFAULT_MSG_SIZE = 256


def truncate_message(msg: str, size: int = DEFAULT_MSG_SIZE) -> str:
    """truncateString (manager.go:560-568): overlong messages keep the
    first size-3 chars plus '...'."""
    if len(msg) <= size:
        return msg
    if size > 3:
        size -= 3
    return msg[:size] + "..."


@dataclass
class Violation:
    """One entry of a constraint's status.violations list
    (apis/status/v1beta1 shape, populated by manager.go:509-520)."""

    message: str
    enforcement_action: str
    kind: str
    name: str
    namespace: str


@dataclass
class ConstraintStatus:
    """Aggregated per-constraint audit status."""

    constraint_kind: str
    constraint_name: str
    audit_timestamp: str
    total_violations: int
    violations: List[Violation] = field(default_factory=list)


@dataclass
class AuditReport:
    """One sweep's outcome."""

    timestamp: str
    duration_seconds: float
    total_violations: int
    by_enforcement_action: Dict[str, int]
    statuses: Dict[str, ConstraintStatus]  # key: "<Kind>/<name>"


class StatusSink:
    """Publication boundary for constraint statuses (the reference's
    equivalent is the status.violations API write loop)."""

    def publish(self, report: AuditReport) -> None:
        raise NotImplementedError


class InMemorySink(StatusSink):
    def __init__(self):
        self.reports: List[AuditReport] = []

    def publish(self, report: AuditReport) -> None:
        self.reports.append(report)

    @property
    def latest(self) -> Optional[AuditReport]:
        return self.reports[-1] if self.reports else None


class AuditManager:
    """Periodic audit sweeps over a constraint-framework Client."""

    def __init__(
        self,
        client,
        target: str,
        sink: Optional[StatusSink] = None,
        audit_interval: float = DEFAULT_AUDIT_INTERVAL,
        constraint_violations_limit: int = DEFAULT_CONSTRAINT_VIOLATIONS_LIMIT,
        msg_size: int = DEFAULT_MSG_SIZE,
        now: Callable[[], float] = time.time,
        metrics=None,
        event_sink: Optional[Callable[[Dict[str, Any]], None]] = None,
        emit_audit_events: bool = False,
        # --audit-from-cache (manager.go:194-206): True sweeps the
        # synced OPA cache in one fused call; False mirrors the
        # reference DEFAULT — list every cluster GVK directly
        # (auditResources, manager.go:232-342) in --audit-chunk-size
        # batches through the batched review path, covering GVKs the
        # Config never syncs
        audit_from_cache: bool = True,
        cluster=None,
        audit_chunk_size: int = 512,
        excluder=None,
        logger=None,
        tracer=None,
        # boot barrier: the loop's FIRST sweep waits for this (the
        # runner passes wait_ready) so warmup runs on the fully
        # ingested state, not an empty cache — the warm sweep is what
        # closes the first-sweep compile cliff (VERDICT r3 #7)
        wait_for: Optional[Callable[[float], bool]] = None,
        # obs.DecisionLog: each audited violation leaves one decision
        # record (plane="audit") joined to the sweep's trace id, so the
        # decision stream covers BOTH admission-time and at-rest
        # verdicts (docs/observability.md §Decision log). The log's
        # rate gate bounds a million-violation sweep.
        decision_log=None,
    ):
        from ..logs import null_logger

        self.decision_log = decision_log
        self.log = logger if logger is not None else null_logger()
        # obs.Tracer: each sweep is one trace (audit_sweep root with
        # per-phase children — dispatch/list, aggregate, status_write)
        self.tracer = tracer
        self.wait_for = wait_for
        # set after the first completed sweep: the audit path is warm
        # (kernels compiled, corpus encoded+staged, render caches primed)
        self.warmed = threading.Event()
        self.freeze_after_sweep = False
        self.client = client
        self.target = target
        self.audit_from_cache = audit_from_cache
        self.cluster = cluster
        # 0 keeps the upstream convention "no chunking" (manager.go:50);
        # negatives clamp to it. Positive values bound the list page
        # size on the wire.
        self.audit_chunk_size = max(0, int(audit_chunk_size))
        self.excluder = excluder
        self.sink = sink if sink is not None else InMemorySink()
        self.audit_interval = audit_interval
        self.violations_limit = constraint_violations_limit
        self.msg_size = msg_size
        self._now = now
        self.metrics = metrics
        # violation event emission (--emit-audit-events, manager.go:684)
        self.event_sink = event_sink
        self.emit_audit_events = emit_audit_events
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.last_run_seconds: Optional[float] = None
        self.audit_duration_seconds: Optional[float] = None
        self._reported_eas: set = set()
        self.last_error: Optional[BaseException] = None
        self.error_count = 0

    # -- one sweep -----------------------------------------------------------

    def audit(self) -> AuditReport:
        """One full sweep, then the reference's aggregation contract
        (cap, truncate, publish). From-cache mode sweeps the synced
        state in one fused Client.audit; direct mode lists the cluster
        GVK-by-GVK in chunks through the batched review path. Each
        sweep is one trace: audit_sweep -> dispatch (or per-kind
        list_and_review spans in direct mode) / aggregate /
        status_write, mirrored into `audit_phase_seconds`."""
        from ..obs import start_span

        t0 = self._now()
        timestamp = time.strftime(
            "%Y-%m-%dT%H:%M:%SZ", time.gmtime(int(t0))
        )
        # every record of this sweep shares the audit id
        # (manager.go:148: am.log = log.WithValues(logging.AuditID, ts))
        log = self.log.with_values(process="audit", audit_id=timestamp)
        with start_span(
            self.tracer, "audit_sweep", audit_id=timestamp,
            from_cache=bool(self.audit_from_cache or self.cluster is None),
        ) as root:
            report = self._audit_once(t0, timestamp, log, root)
        if self.freeze_after_sweep:
            import gc

            gc.freeze()
        return report

    def _audit_once(self, t0, timestamp, log, root) -> AuditReport:
        from ..obs import start_span

        # wall stamps only label the report/spans; all phase DURATION
        # math below runs on perf_counter marks (time.time steps under
        # NTP, and a sweep is long enough to straddle a step)
        wall_disp0 = time.time()
        perf_disp0 = time.perf_counter()
        with start_span(self.tracer, "dispatch", parent=root) as dsp:
            if self.audit_from_cache or self.cluster is None:
                log.info("Auditing from cache")
                resp = self.client.audit().by_target.get(self.target)
                results = resp.results if resp is not None else []
            else:
                log.info("Auditing via discovery client")
                results = self._audit_resources()
            stats = getattr(
                getattr(self.client, "_driver", None), "stats", None
            )
            if isinstance(stats, dict):
                dsp.set_attr(
                    **{
                        k: stats[k]
                        for k in (
                            "compiled_pairs", "interp_pairs",
                            "hot_redispatches", "n_reviews",
                        )
                        if k in stats
                    }
                )
        perf_agg0 = time.perf_counter()
        wall_agg0 = wall_disp0 + (perf_agg0 - perf_disp0)
        statuses: Dict[str, ConstraintStatus] = {}
        totals_by_ea: Dict[str, int] = {}
        for r in results:
            ckind = (r.constraint or {}).get("kind", "?")
            cname = ((r.constraint or {}).get("metadata") or {}).get(
                "name", "?"
            )
            key = f"{ckind}/{cname}"
            st = statuses.get(key)
            if st is None:
                st = ConstraintStatus(
                    constraint_kind=ckind,
                    constraint_name=cname,
                    audit_timestamp=timestamp,
                    total_violations=0,
                )
                statuses[key] = st
            st.total_violations += 1
            ea = r.enforcement_action or "deny"
            totals_by_ea[ea] = totals_by_ea.get(ea, 0) + 1
            # cap (manager.go:499-506): count everything, detail the
            # first `violations_limit`
            if len(st.violations) < self.violations_limit:
                res = r.resource if isinstance(r.resource, dict) else {}
                meta = res.get("metadata") or {}
                st.violations.append(
                    Violation(
                        message=truncate_message(r.msg or "", self.msg_size),
                        enforcement_action=ea,
                        kind=res.get("kind", ""),
                        name=meta.get("name", ""),
                        namespace=meta.get("namespace", ""),
                    )
                )
            res_l = r.resource if isinstance(r.resource, dict) else {}
            meta_l = res_l.get("metadata") or {}
            if self.decision_log is not None:
                # per-violation decision record, joined to the sweep's
                # trace id; rate-gated + ring-bounded by the log itself
                self.decision_log.record_decision(
                    "audit",
                    "deny" if ea == "deny" else "dryrun",
                    code=200,
                    trace_id=getattr(root, "trace_id", None),
                    tenant={"namespace": meta_l.get("namespace", "")},
                    violations=[{
                        "constraint_kind": ckind,
                        "constraint_name": cname,
                        "action": ea,
                        "msg": truncate_message(
                            r.msg or "", self.msg_size
                        ),
                    }],
                    route="audit",
                    resource={
                        "kind": res_l.get("kind", ""),
                        "name": meta_l.get("name", ""),
                    },
                    audit_id=timestamp,
                )
            # logViolation (manager.go:668-682)
            log.info(
                truncate_message(r.msg or "", self.msg_size),
                event_type="violation_audited",
                constraint_kind=ckind,
                constraint_name=cname,
                constraint_action=ea,
                resource_kind=res_l.get("kind", ""),
                resource_namespace=meta_l.get("namespace", ""),
                resource_name=meta_l.get("name", ""),
            )
            if self.emit_audit_events and self.event_sink is not None:
                res = r.resource if isinstance(r.resource, dict) else {}
                meta = res.get("metadata") or {}
                self.event_sink(
                    {
                        "type": "Warning",
                        "reason": "AuditViolation",
                        "process": "audit",
                        "constraint_kind": ckind,
                        "constraint_name": cname,
                        "enforcement_action": ea,
                        "resource_kind": res.get("kind", ""),
                        "resource_namespace": meta.get("namespace", ""),
                        "resource_name": meta.get("name", ""),
                        "message": truncate_message(
                            r.msg or "", self.msg_size
                        ),
                    }
                )

        duration = self._now() - t0
        report = AuditReport(
            timestamp=timestamp,
            duration_seconds=duration,
            total_violations=len(results),
            by_enforcement_action=totals_by_ea,
            statuses=statuses,
        )
        log.info("audit results", violations=len(results))
        for st in statuses.values():
            # updateConstraintStatus log shape (manager.go:652-666)
            log.debug(
                "updating constraint status",
                constraint_kind=st.constraint_kind,
                constraint_name=st.constraint_name,
                constraint_status="enforced",
                constraint_violations=str(st.total_violations),
            )
        perf_pub0 = time.perf_counter()
        wall_pub0 = wall_disp0 + (perf_pub0 - perf_disp0)
        try:
            # named fault point (docs/robustness.md): a K8s status-write
            # error — the reference's retry-with-backoff surface
            fire("audit.status_write")
            self.sink.publish(report)
        except Exception as e:
            # a failed status write must not void the sweep: the report
            # is still returned (and the next sweep re-publishes the
            # full state — statuses are absolute, not deltas)
            if self.metrics is not None:
                self.metrics.record("audit_status_write_failures_total", 1)
            log.error(
                "constraint status publish failed; next sweep will "
                "re-publish",
                err=e,
                trace_id=getattr(root, "trace_id", None),
            )
            if root is not None:
                root.set_attr(status_write_error=str(e))
        perf_pub1 = time.perf_counter()
        wall_pub1 = wall_disp0 + (perf_pub1 - perf_disp0)
        if self.tracer is not None:
            # aggregate/status_write stamped from timing marks instead
            # of open spans: an exception mid-aggregation must not leave
            # a dangling open span pinning the sweep trace
            self.tracer.record_span(
                "aggregate", wall_agg0, wall_pub0, parent=root,
                violations=len(results),
            )
            self.tracer.record_span(
                "status_write", wall_pub0, wall_pub1, parent=root,
                statuses=len(statuses),
            )
        self.last_run_seconds = t0
        self.audit_duration_seconds = duration
        if self.metrics is not None:
            for phase, dt in (
                ("dispatch", perf_agg0 - perf_disp0),
                ("aggregate", perf_pub0 - perf_agg0),
                ("status_write", perf_pub1 - perf_pub0),
            ):
                self.metrics.observe(
                    "audit_phase_seconds", dt, phase=phase
                )
            # the audit stats reporter's metric surface
            # (pkg/audit/stats_reporter.go; docs/Metrics.md:83-104);
            # enforcement actions seen in PRIOR sweeps re-report 0 when
            # their violations clear, so series never go stale
            self.metrics.observe("audit_duration_seconds", duration)
            self.metrics.gauge("audit_last_run_time", t0)
            for ea in set(totals_by_ea) | self._reported_eas:
                self.metrics.gauge(
                    "violations",
                    totals_by_ea.get(ea, 0),
                    enforcement_action=ea,
                )
            self._reported_eas |= set(totals_by_ea)
        return report

    def _audit_resources(self) -> List[Any]:
        """The reference's default path (auditResources,
        manager.go:232-342): list EVERY listable cluster GVK — synced
        or not — skipping gatekeeper's own kinds, and review objects in
        audit-chunk-size batches (each batch is one fused device
        dispatch via review_many; the reference issues one interpreted
        query per object here)."""
        skip_groups = {
            "constraints.gatekeeper.sh",
            "templates.gatekeeper.sh",
            "config.gatekeeper.sh",
            "status.gatekeeper.sh",
        }
        from ..control.events import GVK

        ns_gvk = GVK("", "v1", "Namespace")
        ns_cache: Dict[str, Any] = {}  # per-sweep (nsCache, manager.go:299)
        results: List[Any] = []
        list_pages = getattr(self.cluster, "list_pages", None)
        for gvk in sorted(self.cluster.known_gvks()):
            if gvk.group in skip_groups:
                continue
            if self.audit_chunk_size <= 0:
                # chunking disabled (the upstream --audit-chunk-size=0
                # convention): one in-memory list, one page
                pages = iter([self.cluster.list(gvk)])
            elif list_pages is not None:
                # stream apiserver pages at --audit-chunk-size: bounded
                # memory per kind (the reference's paged List w/
                # Continue, manager.go:277-298), one fused review_many
                # dispatch per page
                pages = list_pages(gvk, self.audit_chunk_size)
            else:
                objs = self.cluster.list(gvk)
                pages = (
                    objs[start : start + self.audit_chunk_size]
                    for start in range(0, len(objs), self.audit_chunk_size)
                )
            # per-kind containment: one kind failing (transient 5xx, an
            # unpageable aggregated API) must not abort the whole sweep
            # — the reference logs and moves to the next kind
            # (manager.go:277-298's error branches)
            wall_kind, perf_kind = time.time(), time.perf_counter()
            try:
                kind_results = self._review_pages(pages, ns_cache, ns_gvk)
            except Exception as e:
                self.log.error(
                    "audit list/review failed for kind",
                    err=e,
                    gvk=str(gvk),
                )
                if self.tracer is not None:
                    self.tracer.record_window(
                        "list_and_review", wall_kind, perf_kind,
                        parent=self.tracer.current(), status="error",
                        gvk=str(gvk), error=str(e),
                    )
                continue
            if self.tracer is not None:
                # one span per kind under the sweep's dispatch span
                # (direct mode's list/chunk/review phase)
                self.tracer.record_window(
                    "list_and_review", wall_kind, perf_kind,
                    parent=self.tracer.current(),
                    gvk=str(gvk), results=len(kind_results),
                )
            results.extend(kind_results)
        return results

    def _review_pages(self, pages, ns_cache, ns_gvk) -> List[Any]:
        """Review one kind's page stream; a None RESTART marker (410
        continue-token expiry -> full relist) discards the partial
        results so objects are never double-counted."""
        from ..control.process import PROCESS_AUDIT

        from ..constraint.handler import handler_for

        handler = handler_for(self.client, self.target)
        results: List[Any] = []
        for chunk in pages:
            if chunk is None:  # RESTART: pagination began again
                results = []
                continue
            reviews = []
            for obj in chunk:
                ns = (obj.get("metadata") or {}).get("namespace") or ""
                if (
                    ns
                    and self.excluder is not None
                    and self.excluder.is_namespace_excluded(
                        PROCESS_AUDIT, ns
                    )
                ):
                    continue
                # attach the Namespace object (the reference's
                # nsCache.Get, manager.go:299-317) — without it the
                # review carries no namespace and every constraint-
                # level namespace match degrades to cluster-scoped.
                # A namespaced object whose Namespace is missing is
                # SKIPPED like the reference's lookup-failure path
                # (manager.go:307-311 logs and continues).
                if ns:
                    if ns not in ns_cache:
                        ns_cache[ns] = self.cluster.get(ns_gvk, "", ns)
                    ns_obj = ns_cache[ns]
                    if ns_obj is None:
                        continue
                    reviews.append(handler.wrap_audit_object(obj, ns_obj))
                else:
                    reviews.append(handler.wrap_audit_object(obj, None))
            if not reviews:
                continue
            for responses in self.client.review_many(reviews):
                resp = responses.by_target.get(self.target)
                if resp is not None:
                    results.extend(resp.results)
        return results

    # -- sweep loop (auditManagerLoop, manager.go:344-358) -------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _loop(self) -> None:
        if self.wait_for is not None:
            try:
                fire("audit.barrier")  # chaos: simulate a barrier fault
                self.wait_for(300.0)
            except Exception as e:
                # barrier failure: sweep anyway (fail-open posture) —
                # but NEVER silently. The first sweep running against a
                # partially ingested cache under-reports violations; an
                # operator must be able to see that happened (counter)
                # and find the why (trace + correlated log record).
                trace_id = None
                if self.tracer is not None:
                    with self.tracer.start_span(
                        "audit_barrier_failure", error=str(e)
                    ) as sp:
                        trace_id = sp.trace_id
                if self.metrics is not None:
                    self.metrics.record("audit_barrier_failures_total", 1)
                self.log.error(
                    "audit boot barrier failed; sweeping anyway "
                    "(first sweep may run on partially ingested state)",
                    process="audit",
                    trace_id=trace_id,
                    err=e,
                )
        while not self._stop.is_set():
            t0 = time.monotonic()
            try:
                self.audit()
                self.last_error = None
                self.warmed.set()
            except Exception as e:  # sweep failures don't kill the loop
                self.last_error = e
                self.error_count += 1
            # fixed cadence like the reference's ticker (manager.go:
            # 344-358): the next sweep starts `audit_interval` after the
            # previous one STARTED, not after it finished
            elapsed = time.monotonic() - t0
            self._stop.wait(max(0.0, self.audit_interval - elapsed))
