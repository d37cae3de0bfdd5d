# Copied from gatekeeper_tpu/control/controllers.py; only this edit differs.
# Edit: a template whose reconcile fails (a target this client lacks, a
# CRD or compile error) cancels its constraint kind's readiness
# expectations (ROADMAP §C, C8; Gatekeeper's Tracker.TryCancelTemplate):
# no watch starts for the kind, so the constraints _populate_expectations
# listed would never be observed and the replica would never be Ready. If
# the template later ingests, its watch starts and the kind's constraints
# are ingested and counted as before. The reference keeps them expected.
"""State-ingestion controllers: the reconcile plane.

Counterparts of pkg/controller/*: each controller consumes watch events
for its GVKs and drives the constraint-framework Client, so no caller
ever touches the Client directly — exactly the reference's ingestion
architecture (SURVEY §3.4/§3.5 call stacks).

  * `TemplateController` — ConstraintTemplate upsert/delete →
    create_crd + add_template / remove_template, dynamic watch
    registration for the constraint kind, readiness observe, per-pod
    status publication, ingestion metrics
    (constrainttemplate_controller.go:244,398-485,553).
  * `ConstraintController` — one controller for ALL constraint kinds,
    fed dynamically as templates create kinds (the reference packs
    GVK+name into one shared channel, constraint_controller.go:138-189,
    util/pack.go:16; here the Event carries its GVK natively) →
    add_constraint / remove_constraint + status + metrics.
  * `ConfigController` — the singleton Config (gatekeeper-system/config,
    pkg/keys/config.go:24): rebuilds the process excluder, computes the
    sync-only GVK set, wipes all cached data, and swaps the sync
    registrar's watch set — the initial List the watch manager replays
    through the pipe IS replayData (config_controller.go:183,268-331).
  * `SyncController` — data GVK events → add_data / remove_data,
    filtered against the live sync set so stale events from a replaced
    watch are dropped (opadataclient.go FilteredDataClient), readiness
    observe + sync metrics.

Controllers process events inline on the watch manager's distribution
thread (the reference's workqueue concurrency is 1 for config/sync too);
`ControllerSwitch` drains reconciles on shutdown
(watch/controller_switch.go).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional, Set, Tuple

from ..constraint.handler import WipeData
from .events import DELETED, Event, GVK
from .process import Excluder
from .readiness import ReadinessTracker
from .watch import Registrar, WatchManager

TEMPLATE_GVK = GVK("templates.gatekeeper.sh", "v1beta1", "ConstraintTemplate")
CONFIG_GVK = GVK("config.gatekeeper.sh", "v1alpha1", "Config")
CONSTRAINT_GROUP = "constraints.gatekeeper.sh"
MUTATION_GROUP = "mutations.gatekeeper.sh"
CONFIG_NAMESPACE = "gatekeeper-system"
CONFIG_NAME = "config"

# the three mutator GVKs one MutatorController watches (the reference
# runs one controller per kind; the Event carries its GVK natively here,
# so one sink covers all three — the ConstraintController pattern)
MUTATOR_GVKS = tuple(
    GVK(MUTATION_GROUP, "v1alpha1", kind)
    for kind in ("Assign", "AssignMetadata", "ModifySet")
)

EXTERNALDATA_GROUP = "externaldata.gatekeeper.sh"
PROVIDER_GVK = GVK(EXTERNALDATA_GROUP, "v1alpha1", "Provider")


def constraint_gvk(kind: str) -> GVK:
    return GVK(CONSTRAINT_GROUP, "v1beta1", kind)


class ControllerSwitch:
    """Shutdown gate: reconciles become no-ops once stopped
    (watch/controller_switch.go)."""

    def __init__(self):
        self._on = True
        self._lock = threading.Lock()

    def enter(self) -> bool:
        with self._lock:
            return self._on

    def stop(self) -> None:
        with self._lock:
            self._on = False


class TemplateController:
    def __init__(
        self,
        client,
        watch_mgr: WatchManager,
        constraint_registrar: Registrar,
        tracker: Optional[ReadinessTracker] = None,
        switch: Optional[ControllerSwitch] = None,
        metrics=None,
        status=None,
        constraint_controller: Optional["ConstraintController"] = None,
        logger=None,
    ):
        from ..logs import null_logger

        self.client = client
        self.watch_mgr = watch_mgr
        self.constraint_registrar = constraint_registrar
        self.tracker = tracker
        self.switch = switch
        self.metrics = metrics
        self.status = status
        self.constraint_controller = constraint_controller
        self.log = logger if logger is not None else null_logger()
        self._lock = threading.Lock()
        self._kinds: Dict[str, str] = {}  # template name -> constraint kind
        self.errors: Dict[str, str] = {}  # template name -> last error

    def sink(self, ev: Event) -> None:
        if self.switch is not None and not self.switch.enter():
            return
        meta = ev.obj.get("metadata") or {}
        name = meta.get("name", "")
        t0 = time.perf_counter()
        status = "active"
        try:
            if ev.type == DELETED:
                self._on_delete(name, ev.obj)
            else:
                self._on_upsert(name, ev.obj)
            self.errors.pop(name, None)
        except Exception as e:
            status = "error"
            self.errors[name] = str(e)
            self.log.error(
                "template ingest failed",
                err=e,
                process="controller",
                template_name=name,
            )
            if ev.type != DELETED:
                self._cancel_constraint_expectations(ev.obj)
        report = None
        if ev.type != DELETED and status == "active":
            getter = getattr(self.client, "template_report", None)
            if getter is not None:
                report = getter(name)
        if self.metrics is not None:
            self.metrics.record(
                "constraint_template_ingestion_count", 1, status=status
            )
            self.metrics.observe(
                "constraint_template_ingestion_duration_seconds",
                time.perf_counter() - t0,
                status=status,
            )
            self._report_count()
            if report is not None:
                # per-template verdict + diagnostic-code counts: the
                # vectorized-vs-interpreter split as a scrapeable fact
                self.metrics.gauge(
                    "template_vectorization",
                    1,
                    kind=report.kind,
                    verdict=report.verdict,
                )
                for code in report.codes:
                    self.metrics.gauge(
                        "template_analysis_diagnostics",
                        sum(
                            1
                            for d in report.diagnostics
                            if d.code == code
                        ),
                        kind=report.kind,
                        code=code,
                    )
        if self.status is not None:
            self.status.publish_template(
                name, status, self.errors.get(name), report=report
            )
        # readiness: observed whether or not compile succeeded — an
        # erroring template must not hold the process unready forever
        # (the reference tracker observes on reconcile, not success)
        if self.tracker is not None:
            self.tracker.templates.observe(name)

    def _cancel_constraint_expectations(self, obj: dict) -> None:
        """The failed template's constraint kind, read from the document
        itself (create_crd may be what raised), stops gating readiness."""
        if self.tracker is None:
            return
        kind = (
            ((((obj.get("spec") or {}).get("crd") or {}).get("spec") or {})
             .get("names") or {})
        ).get("kind")
        if isinstance(kind, str) and kind:
            self.tracker.for_constraint_kind(kind).cancel_all()

    def _on_upsert(self, name: str, obj: dict) -> None:
        crd = self.client.create_crd(obj)
        with self._lock:
            old_kind = self._kinds.get(name)
        self.client.add_template(obj)
        if old_kind is not None and old_kind != crd.kind:
            # case-variant kind rename: add_template succeeded, so the
            # retired kind's modules/constraints are unmounted — only now
            # stop watching it and drop its controller-side state (a
            # failed add_template must leave the old kind watched)
            self._retire_kind(old_kind)
        with self._lock:
            self._kinds[name] = crd.kind
        # dynamic watch: constraints of this kind now flow to the
        # constraint controller (constrainttemplate_controller.go:458)
        self.constraint_registrar.add_watch(constraint_gvk(crd.kind))

    def _retire_kind(self, kind: str) -> None:
        self.constraint_registrar.remove_watch(constraint_gvk(kind))
        if self.constraint_controller is not None:
            # remove_watch delivers no DELETED events, so the constraint
            # controller's status/metrics/readiness for the kind must be
            # dropped explicitly
            self.constraint_controller.drop_kind(kind)

    def _on_delete(self, name: str, obj: dict) -> None:
        with self._lock:
            kind = self._kinds.pop(name, None)
        if kind is not None:
            self._retire_kind(kind)
        self.client.remove_template(obj)
        if self.tracker is not None:
            self.tracker.templates.cancel_expect(name)
        if self.status is not None:
            self.status.delete_template(name)

    def _report_count(self) -> None:
        # active = ingested templates without a live error; error = every
        # template whose last reconcile failed (ingested-before or not)
        with self._lock:
            ingested = set(self._kinds)
        errs = set(self.errors)
        self.metrics.gauge(
            "constraint_templates", len(ingested - errs), status="active"
        )
        self.metrics.gauge("constraint_templates", len(errs), status="error")


class ConstraintController:
    def __init__(
        self,
        client,
        tracker: Optional[ReadinessTracker] = None,
        switch: Optional[ControllerSwitch] = None,
        metrics=None,
        status=None,
    ):
        self.client = client
        self.tracker = tracker
        self.switch = switch
        self.metrics = metrics
        self.status = status
        self._lock = threading.Lock()
        self._by_kind: Dict[str, Set[str]] = {}  # kind -> names
        # "Kind/name" -> (enforcement_action, status) for metric series
        self._series: Dict[str, Tuple[str, str]] = {}
        self.errors: Dict[str, str] = {}  # "Kind/name" -> last error

    def sink(self, ev: Event) -> None:
        if self.switch is not None and not self.switch.enter():
            return
        kind = ev.gvk.kind
        meta = ev.obj.get("metadata") or {}
        name = meta.get("name", "")
        key = f"{kind}/{name}"
        ea = (
            (ev.obj.get("spec") or {}).get("enforcementAction") or "deny"
        )
        status = "active"
        try:
            if ev.type == DELETED:
                self.client.remove_constraint(ev.obj)
                with self._lock:
                    self._by_kind.get(kind, set()).discard(name)
                    self._series.pop(key, None)
                if self.tracker is not None:
                    self.tracker.for_constraint_kind(kind).cancel_expect(name)
                if self.status is not None:
                    self.status.delete_constraint(kind, name)
            else:
                self.client.add_constraint(ev.obj)
                with self._lock:
                    self._by_kind.setdefault(kind, set()).add(name)
            self.errors.pop(key, None)
        except Exception as e:
            status = "error"
            self.errors[key] = str(e)
        if ev.type != DELETED:
            with self._lock:
                self._series[key] = (ea, status)
            if self.tracker is not None:
                self.tracker.for_constraint_kind(kind).observe(name)
            if self.status is not None:
                self.status.publish_constraint(
                    kind, name, status, ea, self.errors.get(key)
                )
        self._report_gauges(extras=[(ea, status)])

    def drop_kind(self, kind: str) -> None:
        """Drop all controller-side state for a retired constraint kind
        (template deleted or kind renamed). The kind's watch is already
        gone, so no DELETED events will ever arrive for its constraints —
        status, metric series, and readiness expectations must be cleared
        here or they report the retired constraints as enforced forever."""
        removed: list = []
        with self._lock:
            names = self._by_kind.pop(kind, set())
            for name in names:
                series = self._series.pop(f"{kind}/{name}", None)
                if series is not None:
                    removed.append(series)
        for name in names:
            self.errors.pop(f"{kind}/{name}", None)
            if self.tracker is not None:
                self.tracker.for_constraint_kind(kind).cancel_expect(name)
            if self.status is not None:
                self.status.delete_constraint(kind, name)
        if removed:
            self._report_gauges(extras=removed)

    def _report_gauges(self, extras=()) -> None:
        if self.metrics is None:
            return
        # per-(enforcement_action, status) counts, with removed series
        # reset to 0 so stale totals never linger
        with self._lock:
            counts: Dict[Tuple[str, str], int] = {}
            for s_ea, s_st in self._series.values():
                counts[(s_ea, s_st)] = counts.get((s_ea, s_st), 0) + 1
        for (s_ea, s_st) in {*extras, *counts}:
            self.metrics.gauge(
                "constraints",
                counts.get((s_ea, s_st), 0),
                enforcement_action=s_ea,
                status=s_st,
            )


class MutatorController:
    """Assign / AssignMetadata / ModifySet ingestion: one sink for all
    three mutator GVKs, feeding the MutationSystem (the mutation
    plane's Client). Invalid specs and schema conflicts surface as
    pod-status errors and metrics, never as webhook failures — the
    system quarantines conflicted mutators itself."""

    def __init__(
        self,
        system,
        switch: Optional[ControllerSwitch] = None,
        metrics=None,
        status=None,
        logger=None,
    ):
        from ..logs import null_logger

        self.system = system
        self.switch = switch
        self.metrics = metrics
        self.status = status
        self.log = logger if logger is not None else null_logger()
        self.errors: Dict[str, str] = {}  # "Kind/name" -> last error

    def sink(self, ev: Event) -> None:
        if self.switch is not None and not self.switch.enter():
            return
        kind = ev.gvk.kind
        name = (ev.obj.get("metadata") or {}).get("name", "")
        key = f"{kind}/{name}"
        status = "active"
        t0 = time.perf_counter()
        try:
            if ev.type == DELETED:
                self.system.remove(key)
                self.errors.pop(key, None)
                if self.status is not None:
                    self.status.delete_mutator(kind, name)
            else:
                self.system.upsert(ev.obj)
                self.errors.pop(key, None)
        except Exception as e:
            status = "error"
            self.errors[key] = str(e)
            self.log.error(
                "mutator ingest failed",
                err=e,
                process="controller",
                mutator_kind=kind,
                mutator_name=name,
            )
        if ev.type != DELETED:
            # schema conflicts are computed set-wide on every upsert:
            # re-publish status for the conflicted ids so a conflict
            # introduced by mutator B shows on mutator A's status too
            conflicts = self.system.conflicts()
            err = self.errors.get(key)
            if key in conflicts:
                status = "error"
                err = (
                    "schema conflict with "
                    + ", ".join(conflicts[key])
                )
            if self.status is not None:
                self.status.publish_mutator(kind, name, status, err)
        if self.metrics is not None:
            self.metrics.record(
                "mutator_ingestion_count", 1, status=status
            )
            self.metrics.observe(
                "mutator_ingestion_duration_seconds",
                time.perf_counter() - t0,
                status=status,
            )
        self.system.report_gauges()


class ProviderController:
    """externaldata.gatekeeper.sh/v1alpha1 Provider ingestion: one sink
    feeding the ExternalDataSystem's registry. Invalid specs surface as
    ProviderPodStatus errors and metrics, never as webhook failures —
    an unregistered provider resolves undefined at evaluation time, and
    a registered one degrades per its failurePolicy."""

    def __init__(
        self,
        system,
        switch: Optional[ControllerSwitch] = None,
        metrics=None,
        status=None,
        logger=None,
    ):
        from ..logs import null_logger

        self.system = system
        self.switch = switch
        self.metrics = metrics
        self.status = status
        self.log = logger if logger is not None else null_logger()
        self.errors: Dict[str, str] = {}  # provider name -> last error

    def sink(self, ev: Event) -> None:
        if self.switch is not None and not self.switch.enter():
            return
        name = (ev.obj.get("metadata") or {}).get("name", "")
        status = "active"
        t0 = time.perf_counter()
        try:
            if ev.type == DELETED:
                self.system.remove(name)
                self.errors.pop(name, None)
                if self.status is not None:
                    self.status.delete_provider(name)
            else:
                self.system.upsert(ev.obj)
                self.errors.pop(name, None)
        except Exception as e:
            status = "error"
            self.errors[name] = str(e)
            self.log.error(
                "provider ingest failed",
                err=e,
                process="controller",
                provider_name=name,
            )
        if ev.type != DELETED and self.status is not None:
            provider = self.system.get(name)
            self.status.publish_provider(
                name,
                status,
                self.errors.get(name),
                failure_policy=(
                    provider.failure_policy if provider is not None else None
                ),
            )
        if self.metrics is not None:
            self.metrics.record(
                "provider_ingestion_count", 1, status=status
            )
            self.metrics.observe(
                "provider_ingestion_duration_seconds",
                time.perf_counter() - t0,
                status=status,
            )
        self.system.report_gauges()


class SyncController:
    def __init__(
        self,
        client,
        tracker: Optional[ReadinessTracker] = None,
        switch: Optional[ControllerSwitch] = None,
        metrics=None,
        excluder: Optional[Excluder] = None,
    ):
        self.client = client
        self.tracker = tracker
        self.switch = switch
        self.metrics = metrics
        self.excluder = excluder
        self._lock = threading.Lock()
        self._sync_set: Set[GVK] = set()

    def set_sync_set(self, gvks: Set[GVK]) -> None:
        with self._lock:
            self._sync_set = set(gvks)

    def sink(self, ev: Event) -> None:
        if self.switch is not None and not self.switch.enter():
            return
        with self._lock:
            if ev.gvk not in self._sync_set:
                return  # FilteredDataClient: stale watch events dropped
        meta = ev.obj.get("metadata") or {}
        ns = meta.get("namespace") or ""
        if (
            ns
            and self.excluder is not None
            and self.excluder.is_namespace_excluded("sync", ns)
        ):
            if self.tracker is not None:
                # the boot lister may have expected this object before
                # the excluder was configured — an excluded object must
                # not wedge /readyz
                self.tracker.for_data(str(ev.gvk)).cancel_expect(
                    (ns, meta.get("name") or "")
                )
            return
        t0 = time.perf_counter()
        if ev.type == DELETED:
            self.client.remove_data(ev.obj)
            if self.tracker is not None:
                # deleted-before-observed data must not wedge readiness
                self.tracker.for_data(str(ev.gvk)).cancel_expect(
                    (ns, meta.get("name") or "")
                )
        else:
            self.client.add_data(ev.obj)
            if self.tracker is not None:
                self.tracker.for_data(str(ev.gvk)).observe(
                    (ns, meta.get("name") or "")
                )
        if self.metrics is not None:
            self.metrics.observe(
                "sync_duration_seconds", time.perf_counter() - t0
            )
            self.metrics.record("sync", 1, kind=ev.gvk.kind)
            self.metrics.gauge(
                "sync_last_run_time", time.time(), kind=ev.gvk.kind
            )


class ConfigController:
    """Singleton Config reconcile: excluder + sync set + wipe/replay
    (config_controller.go:183-331)."""

    def __init__(
        self,
        client,
        sync_registrar: Registrar,
        sync_controller: SyncController,
        excluder: Excluder,
        tracker: Optional[ReadinessTracker] = None,
        switch: Optional[ControllerSwitch] = None,
        metrics=None,
        trace_config=None,
        # mutation wipe/replay partners: on a Config change the mutator
        # set is wiped and its watches torn down/re-added so the
        # initial-List replay rebuilds it from the cluster (the same
        # replayData motion the sync plane gets)
        mutation_system=None,
        mutation_registrar: Optional[Registrar] = None,
        # external-data wipe/replay partners: same motion for the
        # provider registry (and its response cache — a Config change
        # must not leave answers from a retired provider set serving)
        external_data_system=None,
        provider_registrar: Optional[Registrar] = None,
    ):
        self.client = client
        self.sync_registrar = sync_registrar
        self.sync_controller = sync_controller
        self.excluder = excluder
        self.tracker = tracker
        self.switch = switch
        self.metrics = metrics
        self.trace_config = trace_config
        self.mutation_system = mutation_system
        self.mutation_registrar = mutation_registrar
        self.external_data_system = external_data_system
        self.provider_registrar = provider_registrar

    def sink(self, ev: Event) -> None:
        if self.switch is not None and not self.switch.enter():
            return
        meta = ev.obj.get("metadata") or {}
        if (meta.get("namespace"), meta.get("name")) != (
            CONFIG_NAMESPACE,
            CONFIG_NAME,
        ):
            return  # only the keyed singleton is honored (keys/config.go)
        spec = {} if ev.type == DELETED else (ev.obj.get("spec") or {})

        # 1. process excluder from spec.match (excluder.go:43) and the
        # admission trace rules from spec.validation.traces
        # (config_types.go:39-51)
        self.excluder.replace(spec.get("match") or [])
        if self.trace_config is not None:
            self.trace_config.replace(
                (spec.get("validation") or {}).get("traces") or []
            )

        # 2. new sync-only set
        sync_only: Set[GVK] = set()
        for entry in ((spec.get("sync") or {}).get("syncOnly") or []):
            sync_only.add(
                GVK(
                    entry.get("group", "") or "",
                    entry.get("version", ""),
                    entry.get("kind", ""),
                )
            )

        # 3. wipe all cached data BEFORE the watch swap so replayed
        # Lists rebuild from scratch (config_controller.go:268)
        self.client.remove_data(WipeData())

        # 4. swap watches; dropping to the empty set first forces every
        # retained GVK's watch to tear down and re-add, so the initial
        # List replay rebuilds the data we just wiped for ALL GVKs in
        # the new set — the reference's replayData re-lists every
        # watched GVK, not only newly-added ones
        # (config_controller.go:294-331)
        self.sync_controller.set_sync_set(sync_only)
        self.sync_registrar.replace_watch(set())
        self.sync_registrar.replace_watch(sync_only)

        # 5. mutation wipe/replay: the process excluder just changed, so
        # the live mutator set is rebuilt from scratch the same way the
        # data cache is — wipe, then bounce the watches so the replayed
        # Lists re-upsert every mutator CR
        if self.mutation_system is not None:
            self.mutation_system.wipe()
            if self.mutation_registrar is not None:
                self.mutation_registrar.replace_watch(set())
                self.mutation_registrar.replace_watch(set(MUTATOR_GVKS))

        # 6. external-data wipe/replay: the provider registry (and its
        # response cache) rebuilds from the cluster the same way — the
        # bounced watch's initial List re-upserts every Provider CR
        if self.external_data_system is not None:
            self.external_data_system.wipe()
            if self.provider_registrar is not None:
                self.provider_registrar.replace_watch(set())
                self.provider_registrar.replace_watch({PROVIDER_GVK})

        if self.tracker is not None:
            self.tracker.config.observe((CONFIG_NAMESPACE, CONFIG_NAME))
        if self.metrics is not None:
            self.metrics.gauge("sync_gvk_count", len(sync_only))
