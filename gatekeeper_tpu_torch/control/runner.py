# Copied from gatekeeper_tpu/control/runner.py; only these edits differ.
# Edit: the MutationSystem screens on the driver's device (its `device`;
# the card unless the caller asked for the CPU).
# Edit: `capture_jax_profile` is `capture_torch_profile`: /debug/profile
# writes a torch.profiler Chrome trace.
# Edit: the Runner late-wires its registry through TorchDriver's
# `set_metrics` (reached through getattr as in the reference), so the
# driver's series (verdict gauges, driver_pairs_total,
# driver_phase_seconds, ...) reach /metrics. TorchDriver's
# `warm_review_path` compiles and
# stages the policy, so the warm thread warms the review path as the
# reference's does, and /readyz `stats.driver` carries
# `review_path_warm`: a webhook-only replica is Ready before its policy
# is compiled, and its first batch would otherwise compile it. The warm
# thread warms every target the webhook reviews (the agent target beside
# the K8s one, WebhookServer.review_targets) and polls each, and
# `review_path_warm` maps each of those targets to its state; the
# reference's warms and reports its validation target only.
# Edit: stop() also closes the readyz listener's socket.
# Edit: the webhook's Namespace lookups read a cache fed by a Namespace
# watch (registrar "namespace-cache"), asking the apiserver only on a
# miss; the reference asked the EventSource per request, one apiserver
# GET per admission on the batcher's thread under KubeCluster (ROADMAP
# §C).
# Edit: the warm thread calls gc.freeze() once ingestion is done, and the
# audit manager after every sweep (`freeze_after_sweep`): at 100,000
# synced pods each full collection otherwise walks the synced copies and
# the corpus for seconds while admission requests wait past their
# timeout. Once ingested, the warm thread also sets the collector's
# thresholds to GC_THRESHOLDS until stop(): with the heap frozen the
# default (700, 10, 10) ran a full collection every few hundred
# milliseconds of an HTTPS load (PERF.md §6).
"""The process runtime: boot a cluster-state-driven, Ready, serving
gatekeeper-tpu instance.

Counterpart of main.go (:103-308) + pkg/operations: wires the watch
manager, the four ingestion controllers, the readiness tracker (with a
real /readyz), the status plane, metrics, and the serving workloads
(admission webhook + audit manager) — gated by `operations` roles the
way `--operation` splits the reference deployment into webhook and
audit pods (operations.go:15-19,77; deploy/gatekeeper.yaml).

Nothing outside this module touches the Client directly: state flows
cluster -> watch manager -> controllers -> Client, and the serving
paths consume the Client — the reference's exact architecture
(SURVEY §3 call stacks).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Iterable, List, Optional, Sequence, Set

from .controllers import (
    CONFIG_GVK,
    CONFIG_NAME,
    CONFIG_NAMESPACE,
    ConfigController,
    ConstraintController,
    ControllerSwitch,
    MUTATOR_GVKS,
    MutatorController,
    PROVIDER_GVK,
    ProviderController,
    SyncController,
    TemplateController,
    TEMPLATE_GVK,
    constraint_gvk,
)
from .events import EventSource, FakeCluster, GVK
from .process import Excluder
from .readiness import ReadinessTracker
from .status import (
    CONSTRAINT_STATUS_GVK,
    StatusAggregator,
    StatusWriter,
    TEMPLATE_STATUS_GVK,
)
from .watch import WatchManager

OPERATION_WEBHOOK = "webhook"
OPERATION_AUDIT = "audit"
OPERATION_STATUS = "status"
ALL_OPERATIONS = (OPERATION_WEBHOOK, OPERATION_AUDIT, OPERATION_STATUS)

NAMESPACE_GVK = GVK("", "v1", "Namespace")

# the collector's thresholds once the synced state is frozen: young
# collections every 10,000 allocations, a full one after 100 of the
# middle generation's (measured on an HTTPS load at 100,000 pods, PERF.md
# §6)
GC_THRESHOLDS = (10_000, 10, 100)


class Runner:
    def __init__(
        self,
        cluster: EventSource,
        client,
        target: str,
        operations: Sequence[str] = ALL_OPERATIONS,
        pod_name: str = "gatekeeper-pod",
        metrics=None,
        audit_interval: float = 60.0,
        # --audit-chunk-size (manager.go:50): page size for the
        # discovery-list sweep's batched reviews
        audit_chunk_size: int = 512,
        webhook_port: int = 0,
        readyz_port: Optional[int] = 0,  # None disables the endpoint
        exempt_namespaces: Sequence[str] = (),
        webhook_tls: bool = False,
        emit_admission_events: bool = False,
        emit_audit_events: bool = False,
        audit_from_cache: bool = True,
        enable_profiler: bool = False,
        log_denies: bool = False,
        logger=None,
        # name of a ValidatingWebhookConfiguration to keep injected with
        # the rotating CA bundle (certs.go:183,468-515); needs
        # webhook_tls
        vwh_name: Optional[str] = None,
        # TLS artifact dir (the reference's mounted cert Secret); None =
        # per-process temp dir
        cert_dir: Optional[str] = None,
        # serving bind address: loopback for tests, "0.0.0.0" in-cluster
        bind_addr: str = "127.0.0.1",
        # obs.Tracer threaded through webhook + audit; None builds one
        # (tracing is always on — the ring is bounded)
        tracer=None,
        # overload/degradation envelope (docs/robustness.md): what a
        # shed/expired/unevaluable request gets ("open" = allow, the
        # reference's failurePolicy: Ignore posture; "closed" = 503)
        # and the admission queue bound (None = unbounded; default
        # mirrors webhook.server.DEFAULT_MAX_QUEUE)
        fail_policy: str = "open",
        max_queue=2048,
        # device fault domains (docs/robustness.md §Fault domains):
        # split the constraint corpus into this many partitions, each
        # guarded by its own per-device breaker — a sick chip sheds its
        # constraint subset instead of tripping the whole plane. 0 =
        # monolithic dispatch (the pre-partition behavior).
        partitions: int = 0,
        # fleet plane (docs/fleet.md): CR-backed gossip making the
        # external-data cache and breaker trips fleet properties.
        # True builds a FleetPlane keyed by pod_name; pass an existing
        # FleetPlane to share one across in-process replicas in tests;
        # False disables (pure per-process state)
        fleet=True,
        # name of the Secret backing the SHARED cert store (the
        # reference's mounted cert Secret, certs.go:119-181): replicas
        # load-or-create one CA and pick up rotation via watch without
        # restart. None = pod-local CertRotator in cert_dir (single
        # replica / hermetic tests). Needs webhook_tls.
        cert_secret: Optional[str] = None,
        # namespace holding the cert Secret and FleetState CRs
        fleet_namespace: str = "gatekeeper-system",
        # graceful drain (docs/robustness.md): seconds /readyz reports
        # not-ready while the webhook listener still accepts, so the
        # LB/kubelet routes away before connections start failing
        drain_grace_s: float = 0.0,
        # live SLO & saturation plane (docs/observability.md §SLO &
        # saturation): SloTarget the streaming engine judges every
        # admission against. None = defaults (99% within the handler's
        # own deadline slack, 60s/900s burn windows).
        slo_target=None,
        # admission scheduling policy (docs/operations.md §Admission
        # scheduling): "deadline" turns on EDF batch formation,
        # per-tenant fair-share quotas, and predictive shedding;
        # "fifo" is the bit-compatible legacy queue and the rollback
        # path (--sched-policy fifo)
        sched_policy: str = "fifo",
        # wire-speed ingest plane (docs/ingest.md): "on" mounts the
        # framed-stream listener with zero-copy decode, "json" keeps
        # the framed transport but decodes with plain json.loads (the
        # decode-bisect knob), "off" (default, --ingest off) is the
        # rollback path — legacy HTTP only
        ingest: str = "off",
        ingest_port: int = 0,
        # verdict-integrity plane (docs/robustness.md §Verdict
        # integrity): canary rows in every fused dispatch's padding
        # slots, a CRC-sampled shadow oracle, and corruption
        # quarantine. True (default) builds an IntegrityPlane; False
        # disables the plane entirely (the rollback path); an
        # IntegrityPlane instance is adopted as-is (tests/bench tune
        # sampling/thresholds)
        integrity=True,
    ):
        from ..logs import null_logger
        from ..obs import (
            CostAttributor,
            DecisionLog,
            FlightRecorder,
            SloEngine,
            Tracer,
        )

        self.tracer = tracer if tracer is not None else Tracer()

        self.cluster = cluster
        self.client = client
        self.target = target
        self.pod_name = pod_name
        self.operations = set(operations)
        self.log_denies = log_denies
        self.log = logger if logger is not None else null_logger()
        if metrics is None:
            from ..metrics import MetricsRegistry

            metrics = MetricsRegistry()
        self.metrics = metrics
        # late-wire the driver's own metrics (template verdict gauges,
        # fallback-reason counters) into the shared registry
        driver = getattr(client, "_driver", None)
        set_m = getattr(driver, "set_metrics", None)
        if set_m is not None:
            set_m(metrics)
        # cost-attribution + flight-recorder plane
        # (docs/observability.md): per-constraint device-time
        # accounting at the driver's dispatch seam, served at
        # /debug/costs; trip-triggered postmortems (breaker OPEN,
        # quarantine, shed burst) at /debug/flightrecords, on disk
        # when GATEKEEPER_TPU_FLIGHT_DIR is set
        self.attributor = CostAttributor(
            metrics=metrics, replica=pod_name
        )
        set_a = getattr(driver, "set_attributor", None)
        if set_a is not None:
            set_a(self.attributor)
        # per-admission decision log (docs/observability.md §Decision
        # log): every plane's "why" records, served at /debug/decisions
        # and cross-linked into flight records by id + trace id
        self.decisions = DecisionLog(metrics=metrics, replica=pod_name)
        self.recorder = FlightRecorder(
            tracer=self.tracer,
            attributor=self.attributor,
            metrics=metrics,
            decisions=self.decisions,
            replica=pod_name,
        )
        # streaming SLO engine, fed through the decision-log seam so
        # every plane's verdicts/latencies/sheds stream in without any
        # handler changes; breaches fire slo_breach flight records
        self.slo = SloEngine(
            target=slo_target,
            metrics=metrics,
            recorder=self.recorder,
            replica=pod_name,
        )
        self.decisions.slo = self.slo
        # verdict-integrity plane (docs/robustness.md §Verdict
        # integrity): golden canary sets ride the ProgramStore as
        # sidecars when the driver has one; the driver packs/strips
        # canaries and gates warm-swaps from here on
        self.integrity = None
        if integrity:
            from ..integrity import IntegrityPlane

            self.integrity = (
                integrity
                if isinstance(integrity, IntegrityPlane)
                else IntegrityPlane(
                    metrics=metrics,
                    decisions=self.decisions,
                    recorder=self.recorder,
                    store=getattr(driver, "program_store", None),
                )
            )
            self.integrity.metrics = metrics
            self.integrity.decisions = self.decisions
            self.integrity.recorder = self.recorder
            set_i = getattr(driver, "set_integrity", None)
            if set_i is not None:
                set_i(self.integrity)
            self.integrity.attach_client(client)
        self.excluder = Excluder()
        self.tracker = ReadinessTracker()
        self.switch = ControllerSwitch()
        self.watch_mgr = WatchManager(cluster, metrics=metrics)
        self.status_writer = (
            StatusWriter(cluster, pod_name)
            if OPERATION_STATUS in self.operations
            else None
        )
        self.status_agg = StatusAggregator()
        self.audit_interval = audit_interval
        self.audit_chunk_size = audit_chunk_size
        self.audit_from_cache = audit_from_cache
        # --enable-pprof equivalent (main.go:89-90,111-117): when on,
        # the readyz server also exposes /debug/profile?seconds=N which
        # captures a torch.profiler trace (Chrome trace JSON) — the
        # device-side analog of the reference's net/http/pprof endpoint
        self.enable_profiler = enable_profiler
        self._profile_lock = threading.Lock()
        self.webhook_port = webhook_port
        self.readyz_port = readyz_port
        self.fail_policy = fail_policy
        self.max_queue = max_queue
        self.partitions = int(partitions or 0)
        self.sched_policy = sched_policy
        self.ingest_mode = ingest if ingest in ("on", "json") else "off"
        self.ingest_port = ingest_port
        self.drain_grace_s = drain_grace_s
        self.exempt_namespaces = list(exempt_namespaces)
        self.webhook_tls = webhook_tls
        self.vwh_name = vwh_name
        self.cert_dir = cert_dir
        self.cert_secret = cert_secret
        self.fleet_namespace = fleet_namespace
        self.bind_addr = bind_addr
        self.ca_injector = None
        self.webhook = None
        self.audit = None
        # fleet state plane (docs/fleet.md): built here so the
        # external-data system below can attach before any provider
        # ingests; started (watch + first publish) in start()
        from ..fleet import FleetPlane

        if fleet is True:
            self.fleet = FleetPlane(
                cluster,
                replica_id=pod_name,
                namespace=fleet_namespace,
                metrics=metrics,
                logger=self.log.with_values(process="fleet"),
            )
        else:
            self.fleet = fleet or None
        self._readyz_httpd: Optional[ThreadingHTTPServer] = None
        from ..webhook.policy import TraceConfig

        self.trace_config = TraceConfig()
        self.emit_admission_events = emit_admission_events
        self.emit_audit_events = emit_audit_events
        # emitted violation events: a BOUNDED in-memory ring for
        # introspection (audit re-emits persisting violations every
        # sweep; an unbounded list would leak for the process lifetime)
        # PLUS real v1 Event objects written through the EventSource —
        # against a live apiserver these are actual cluster Events
        # (policy.go:253-273 AnnotatedEventf / audit emitEvent)
        from collections import deque

        self.events: Any = deque(maxlen=4096)
        self._event_queue: Any = deque(maxlen=4096)
        self._event_wake = threading.Event()
        self._event_stop = threading.Event()
        self._warm_stop = threading.Event()
        self._warm_thread: Optional[threading.Thread] = None
        # the collector's thresholds before the warm thread set its own
        self._gc_kept: Optional[tuple] = None
        self._event_thread = threading.Thread(
            target=self._drain_events, daemon=True
        )
        self._event_thread.start()

        # controllers (wired, not yet watching)
        self.constraint_controller = ConstraintController(
            client,
            tracker=self.tracker,
            switch=self.switch,
            metrics=metrics,
            status=self.status_writer,
        )
        self._constraint_registrar = self.watch_mgr.new_registrar(
            "constraint-controller", self.constraint_controller.sink
        )
        self.template_controller = TemplateController(
            client,
            self.watch_mgr,
            self._constraint_registrar,
            tracker=self.tracker,
            switch=self.switch,
            metrics=metrics,
            status=self.status_writer,
            constraint_controller=self.constraint_controller,
            logger=self.log,
        )
        self._template_registrar = self.watch_mgr.new_registrar(
            "template-controller", self.template_controller.sink
        )
        self.sync_controller = SyncController(
            client,
            tracker=self.tracker,
            switch=self.switch,
            metrics=metrics,
            excluder=self.excluder,
        )
        self._sync_registrar = self.watch_mgr.new_registrar(
            "sync-controller", self.sync_controller.sink
        )
        # mutation plane: the system is always built (cheap when no
        # mutators exist); the webhook serves /v1/mutate through it and
        # the controller keeps it synced with the three mutator GVKs
        from ..mutation import MutationSystem

        self.mutation_system = MutationSystem(
            metrics=metrics, logger=self.log,
            device=getattr(getattr(client, "_driver", None), "device", None),
        )
        self.mutator_controller = MutatorController(
            self.mutation_system,
            switch=self.switch,
            metrics=metrics,
            status=self.status_writer,
            logger=self.log,
        )
        self._mutator_registrar = self.watch_mgr.new_registrar(
            "mutator-controller", self.mutator_controller.sink
        )
        # external-data plane: the system is always built (cheap with no
        # providers); the Provider controller keeps its registry synced,
        # the client/driver prefetch through it, and the interpreter's
        # external_data builtin resolves via the process binding
        from ..externaldata import ExternalDataSystem

        self.external_data = ExternalDataSystem(
            metrics=metrics, tracer=self.tracer, logger=self.log
        )
        if self.fleet is not None:
            # cache entries publish to peers; per-provider breakers
            # gossip as providers ingest (docs/fleet.md)
            self.fleet.attach_cache(self.external_data)
        set_ed = getattr(client, "set_external_data", None)
        if set_ed is not None:
            set_ed(self.external_data)
        self.provider_controller = ProviderController(
            self.external_data,
            switch=self.switch,
            metrics=metrics,
            status=self.status_writer,
            logger=self.log,
        )
        self._provider_registrar = self.watch_mgr.new_registrar(
            "provider-controller", self.provider_controller.sink
        )
        # corpus analysis plane (docs/analysis.md §Corpus analysis):
        # whole-corpus diagnostics recomputed off the request path on
        # churn, snapshot on /readyz, prunable keys fed to the planner
        from ..analysis.corpus import CorpusPlane

        self.corpus = CorpusPlane(
            client,
            mutation_system=self.mutation_system,
            external_data=self.external_data,
            metrics=metrics,
        )
        self.config_controller = ConfigController(
            client,
            self._sync_registrar,
            self.sync_controller,
            self.excluder,
            tracker=self.tracker,
            switch=self.switch,
            metrics=metrics,
            trace_config=self.trace_config,
            mutation_system=self.mutation_system,
            mutation_registrar=self._mutator_registrar,
            external_data_system=self.external_data,
            provider_registrar=self._provider_registrar,
        )
        self._config_registrar = self.watch_mgr.new_registrar(
            "config-controller", self.config_controller.sink
        )
        self._status_registrar = self.watch_mgr.new_registrar(
            "status-controller", self.status_agg.sink
        )
        # the webhook's Namespace lookups read a watch-fed cache, as the
        # reference's nsCache reads the informer cache (policy.go:354-369)
        self._namespaces: Dict[str, dict] = {}
        self._namespace_registrar = self.watch_mgr.new_registrar(
            "namespace-cache", self._note_namespace
        )

    # -- boot ----------------------------------------------------------------

    def _populate_expectations(self) -> None:
        """Boot-time readiness barrier: list what exists NOW and expect
        it to be ingested before reporting Ready
        (ready_tracker.go:336-520)."""
        templates = self.cluster.list(TEMPLATE_GVK)
        for t in templates:
            name = (t.get("metadata") or {}).get("name", "")
            self.tracker.templates.expect(name)
        self.tracker.templates.expectations_done()

        for t in templates:
            kind = (
                ((((t.get("spec") or {}).get("crd") or {}).get("spec") or {})
                 .get("names") or {})
            ).get("kind") or ""
            if not kind:
                continue
            tr = self.tracker.for_constraint_kind(kind)
            for c in self.cluster.list(constraint_gvk(kind)):
                tr.expect((c.get("metadata") or {}).get("name", ""))
            tr.expectations_done()

        configs = [
            c
            for c in self.cluster.list(CONFIG_GVK)
            if ((c.get("metadata") or {}).get("namespace"),
                (c.get("metadata") or {}).get("name"))
            == (CONFIG_NAMESPACE, CONFIG_NAME)
        ]
        if configs:
            self.tracker.config.expect((CONFIG_NAMESPACE, CONFIG_NAME))
            spec = configs[0].get("spec") or {}
            for entry in ((spec.get("sync") or {}).get("syncOnly") or []):
                gvk = GVK(
                    entry.get("group", "") or "",
                    entry.get("version", ""),
                    entry.get("kind", ""),
                )
                tr = self.tracker.for_data(str(gvk))
                for obj in self.cluster.list(gvk):
                    meta = obj.get("metadata") or {}
                    tr.expect(
                        (meta.get("namespace") or "", meta.get("name") or "")
                    )
                tr.expectations_done()
        self.tracker.config.expectations_done()

    def start(self) -> None:
        # stored-version migration first (pkg/upgrade runs before the
        # controllers see state; deprecated-version objects must be
        # visible at the preferred version the watches use)
        from .upgrade import UpgradeManager

        self.upgrade_mgr = UpgradeManager(self.cluster)
        try:
            self.upgrade_mgr.upgrade()
        except Exception as e:
            # upgrade failures must not block serving (the reference
            # logs and continues, upgrade/manager.go) — but they must
            # not be invisible either
            self.log.error(
                "stored-version upgrade failed; deprecated-version "
                "objects may not be ingested",
                err=e,
            )

        self._populate_expectations()

        if self.fleet is not None:
            # readiness: the state plane must have listed peers and
            # offered its first publish before the replica reports
            # Ready (start() below is synchronous; publish failures on
            # a cluster without the CRD degrade, never block)
            comp = self.tracker.for_component("fleet")
            comp.expect("state-plane")
            comp.expectations_done()
            self.fleet.start()
            comp.observe("state-plane")

        # watch registration order mirrors setupControllers: templates
        # first (they create constraint kinds), then config (it swaps the
        # sync watches), status kinds for the aggregator
        self._template_registrar.add_watch(TEMPLATE_GVK)
        self._config_registrar.add_watch(CONFIG_GVK)
        self._provider_registrar.add_watch(PROVIDER_GVK)
        for gvk in MUTATOR_GVKS:
            self._mutator_registrar.add_watch(gvk)
        if OPERATION_STATUS in self.operations:
            self._status_registrar.add_watch(TEMPLATE_STATUS_GVK)
            self._status_registrar.add_watch(CONSTRAINT_STATUS_GVK)

        if OPERATION_WEBHOOK in self.operations:
            from ..webhook.server import WebhookServer

            # the agent-action serving plane mounts automatically
            # when the client was built with the agent target
            # registered (docs/targets.md)
            from ..agentaction import TARGET_NAME as _AGENT_TARGET

            self._namespace_registrar.add_watch(NAMESPACE_GVK)

            rotator = None
            if self.webhook_tls and self.cert_secret:
                # the Secret-backed shared cert store: one CA per
                # fleet, rotation picked up by peers without restart
                # (docs/fleet.md; certs.go:119-181 behaviorally)
                import tempfile

                from ..fleet import FleetCertRotator, SecretCertStore

                store = SecretCertStore(
                    self.cluster,
                    name=self.cert_secret,
                    namespace=self.fleet_namespace,
                    replica_id=self.pod_name,
                    metrics=self.metrics,
                    logger=self.log.with_values(process="fleet"),
                )
                rotator = FleetCertRotator(
                    self.cert_dir
                    or tempfile.mkdtemp(prefix="gk-certs-"),
                    store,
                    metrics=self.metrics,
                    logger=self.log.with_values(process="fleet"),
                )
                rotator.ensure()  # load-or-create BEFORE serving
                rotator.start()  # watch for peer rotations

            self.webhook = WebhookServer(
                self.client,
                self.target,
                agent_review=(
                    _AGENT_TARGET in getattr(self.client, "targets", {})
                ),
                port=self.webhook_port,
                excluder=self.excluder,
                namespace_getter=self._get_namespace,
                exempt_namespaces=self.exempt_namespaces,
                metrics=self.metrics,
                tls=self.webhook_tls,
                trace_config=self.trace_config,
                event_sink=self._emit_event,
                emit_admission_events=self.emit_admission_events,
                log_denies=self.log_denies,
                logger=self.log.with_values(process="webhook"),
                tracer=self.tracer,
                mutation_system=self.mutation_system,
                cert_dir=self.cert_dir,
                rotator=rotator,
                bind_addr=self.bind_addr,
                fail_policy=self.fail_policy,
                max_queue=self.max_queue,
                drain_grace_s=self.drain_grace_s,
                partitions=self.partitions or None,
                recorder=self.recorder,
                decision_log=self.decisions,
                attributor=self.attributor,
                replica=self.pod_name,
                corpus=self.corpus,
                sched_policy=self.sched_policy,
                slo=self.slo,
                integrity=self.integrity,
                ingest=self.ingest_mode != "off",
                ingest_port=self.ingest_port,
                ingest_decode=(
                    "zerocopy" if self.ingest_mode == "on" else "json"
                ),
            )
            # postmortem state sources: what a flight record snapshots
            # alongside the trace tail / cost table / fault points
            wh = self.webhook
            self.recorder.add_source(
                "webhook", lambda: {
                    "draining": wh.draining,
                    "shed": wh.batcher.shed_count,
                    "batch_failures": wh.batcher.batch_failures,
                    **(
                        {"breaker": wh.batcher.breaker.snapshot()}
                        if wh.batcher.breaker is not None
                        else {}
                    ),
                },
            )
            if wh.partitioner is not None:
                self.recorder.add_source(
                    "partitions", wh.partitioner.postmortem
                )
                # compile-plane state: a compile_storm record embeds the
                # program-store table + per-partition signatures
                self.recorder.add_source(
                    "programs", wh.partitioner.programs_table
                )
            if self.fleet is not None:
                self.recorder.add_source("fleet", self.fleet.snapshot)
            if self.integrity is not None:
                # a verdict_divergence / device_quarantine record
                # embeds the integrity plane's ledger + golden state
                self.recorder.add_source(
                    "integrity", self.integrity.snapshot
                )
            self.webhook.start()
            if (
                self.fleet is not None
                and self.webhook.partitioner is not None
            ):
                # per-device breaker state is a fleet property: each
                # device breaker registers under its
                # device:<plane>:<device_id> key as it is created, so a
                # chip sick on one replica pre-opens the same device's
                # breaker on peers (docs/fleet.md)
                self.webhook.partitioner.set_fleet(self.fleet)
            if self.fleet is not None:
                # device-breaker trips gossip: an outage one replica
                # discovered pre-opens peers' breakers to a half-open
                # probe instead of N independent rediscoveries
                for plane_name, batcher in (
                    ("device:validation", self.webhook.batcher),
                    ("device:mutation", self.webhook.mutate_batcher),
                    ("device:agent", self.webhook.agent_batcher),
                ):
                    if batcher is not None and batcher.breaker is not None:
                        self.fleet.register_breaker(
                            plane_name, batcher.breaker
                        )
            if self.vwh_name and self.webhook.rotator is not None:
                from ..webhook.certs import CaBundleInjector

                self.ca_injector = CaBundleInjector(
                    self.cluster, self.webhook.rotator, self.vwh_name
                )
                self.ca_injector.start()

        if OPERATION_AUDIT in self.operations:
            from ..audit import AuditManager

            self.audit = AuditManager(
                self.client,
                self.target,
                audit_interval=self.audit_interval,
                audit_chunk_size=self.audit_chunk_size,
                metrics=self.metrics,
                event_sink=self._emit_event,
                emit_audit_events=self.emit_audit_events,
                audit_from_cache=self.audit_from_cache,
                cluster=self.cluster,
                excluder=self.excluder,
                logger=self.log,
                tracer=self.tracer,
                wait_for=self._wait_ingested,
                decision_log=self.decisions,
            )
            # each sweep's corpus lives until the next: freeze it out of
            # the cyclic collector's reach (see the warm thread)
            self.audit.freeze_after_sweep = True
            self.audit.start()

        if self.webhook is not None:
            # background compile loop: warm the fused review path once
            # ingestion settles, and RE-warm whenever template churn
            # bumps the constraint generation and drops the route back
            # to the interpreter (serve-while-compiling: admission keeps
            # flowing on the interpreter throughout; the compiled route
            # swaps in atomically when each warm completes)
            def _warm():
                import time as _t

                # interruptible ingestion wait: this thread is
                # NON-daemon (a daemon killed mid-XLA-compile at
                # interpreter exit aborts the process, 'FATAL:
                # exception not rethrown'), so it must never out-wait
                # a stopped runner
                deadline = _t.monotonic() + 300
                while (
                    not self._warm_stop.is_set()
                    and _t.monotonic() < deadline
                ):
                    if self._wait_ingested(timeout=0.5):
                        break
                if self._warm_stop.is_set():
                    return
                # the synced state lives as long as the process: once
                # ingested, move every object alive out of the cyclic
                # collector's reach, or each full collection walks tens
                # of millions of them while the sweep and admission
                # requests wait (the audit manager freezes each sweep's
                # corpus the same way)
                import gc

                gc.freeze()
                self._gc_kept = gc.get_threshold()
                gc.set_threshold(*GC_THRESHOLDS)
                self.webhook.warmup()
                drv = getattr(self.client, "_driver", None)
                warm = getattr(drv, "review_path_warm", None)
                targets = self.webhook.review_targets()
                delay = 2.0
                while warm is not None and not self._warm_stop.wait(delay):
                    cold = [t for t in targets if not warm(t)]
                    if not cold:
                        delay = 2.0
                        continue
                    self.webhook.warmup(targets=cold)
                    if all(warm(t) for t in targets):
                        delay = 2.0
                    else:
                        # deterministic compile failure: back off instead
                        # of re-attempting full compiles every 2s forever
                        delay = min(delay * 2, 120.0)
                        self.log.error(
                            "review-path warmup failed; backing off",
                            delay_seconds=delay,
                        )

            self._warm_thread = threading.Thread(
                target=_warm, name="gk-runner-warm", daemon=False
            )
            self._warm_thread.start()

        if self.readyz_port is not None:
            self._serve_readyz()

    def _emit_event(self, ev: Dict[str, Any]) -> None:
        """Violation-event sink: the bounded in-memory ring PLUS a real
        v1 Event through the EventSource — queued for a background
        drain thread so the ADMISSION PATH never blocks on an apiserver
        write (the reference decouples via the event broadcaster the
        same way, AnnotatedEventf policy.go:253-273 / audit emitEvent)."""
        self.events.append(ev)
        try:
            self._event_queue.append(ev)
            self._event_wake.set()
        except Exception:
            pass

    def _drain_events(self) -> None:
        import hashlib
        import time as _time

        while not self._event_stop.is_set():
            self._event_wake.wait(timeout=1.0)
            self._event_wake.clear()
            while True:
                try:
                    ev = self._event_queue.popleft()
                except IndexError:
                    break
                try:
                    ts = _time.strftime(
                        "%Y-%m-%dT%H:%M:%SZ", _time.gmtime()
                    )
                    ns = ev.get("resource_namespace") or "gatekeeper-system"
                    # deterministic name per (reason, object, message):
                    # re-emissions AGGREGATE via count/lastTimestamp like
                    # the reference's recorder instead of accumulating a
                    # new Event object per sweep forever
                    key = "|".join(
                        str(ev.get(k, ""))
                        for k in (
                            "reason",
                            "resource_kind",
                            "resource_namespace",
                            "resource_name",
                            "constraint_name",
                            "message",
                        )
                    )
                    name = (
                        "gatekeeper-tpu."
                        + hashlib.sha1(key.encode()).hexdigest()[:16]
                    )
                    gvk = GVK("", "v1", "Event")
                    count = 1
                    first_ts = ts
                    getter = getattr(self.cluster, "get", None)
                    if getter is not None:
                        cur = getter(gvk, ns, name)
                        if cur is not None:
                            count = int(cur.get("count") or 0) + 1
                            first_ts = cur.get("firstTimestamp", ts)
                    self.cluster.apply(
                        {
                            "apiVersion": "v1",
                            "kind": "Event",
                            "metadata": {"name": name, "namespace": ns},
                            "type": ev.get("type", "Warning"),
                            "reason": ev.get("reason", "Violation"),
                            "message": ev.get("message", ""),
                            "source": {"component": "gatekeeper-tpu"},
                            "involvedObject": {
                                "kind": ev.get("resource_kind", ""),
                                "namespace": ev.get(
                                    "resource_namespace", ""
                                ),
                                "name": ev.get("resource_name", ""),
                            },
                            "firstTimestamp": first_ts,
                            "lastTimestamp": ts,
                            "count": count,
                        }
                    )
                except Exception as e:
                    # Event emission is best-effort in the reference too
                    self.log.debug("event emission failed", err=str(e))

    def _wait_ingested(self, timeout: float = 30.0) -> bool:
        """Block until ingestion satisfies the readiness barrier."""
        import time

        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            self.watch_mgr.wait_idle(timeout=1.0)
            if self.tracker.satisfied():
                return True
            time.sleep(0.01)
        return self.tracker.satisfied()

    def wait_ready(self, timeout: float = 30.0, warm: bool = False) -> bool:
        """Readiness = ingestion barrier satisfied, matching the
        reference (Ready as soon as state replays,
        pkg/readiness/ready_tracker.go:138-173). Kernel compilation no
        longer gates Ready (VERDICT r4 #4 reversing r3 #7): a cold pod
        serves admission from the interpreter within seconds while the
        fused path compiles in the background and swaps in atomically
        (TpuDriver.warm_review_path). Pass warm=True to additionally
        wait for the audit warm sweep — deterministic-measurement mode
        for benches and tests."""
        import time

        deadline = time.monotonic() + timeout
        if not self._wait_ingested(timeout):
            return False
        if warm and self.audit is not None:
            if not self.audit.warmed.wait(
                max(0.0, deadline - time.monotonic())
            ):
                return False
        return True

    def stop(self) -> None:
        # graceful drain FIRST: readiness flips not-ready while the
        # webhook listener still accepts, so a probing LB routes away
        # before any connection can fail (WebhookServer.stop then holds
        # the drain grace, closes the listener, and waits for in-flight
        # requests — a SIGTERM mid-load sheds zero accepted requests)
        if self.webhook is not None:
            self.webhook.begin_drain()
        # signal everything first, drain components, JOIN the warm
        # thread last — its join can ride out an in-flight XLA compile,
        # and serving must not keep running behind that wait
        self.switch.stop()
        self._event_stop.set()
        self._warm_stop.set()
        self._event_wake.set()
        if self.integrity is not None:
            self.integrity.close()  # stop the shadow-oracle worker
        if self.ca_injector is not None:
            self.ca_injector.stop()
        if self.fleet is not None:
            self.fleet.stop()
        if self.audit is not None:
            self.audit.stop()
        if self.webhook is not None:
            rot_stop = getattr(self.webhook.rotator, "stop", None)
            if rot_stop is not None:
                rot_stop()  # fleet rotator: unsubscribe the Secret watch
            self.webhook.stop()
        if self._readyz_httpd is not None:
            self._readyz_httpd.shutdown()
            self._readyz_httpd.server_close()
        if self.recorder is not None:
            self.recorder.stop()
        self.watch_mgr.stop()
        if self._warm_thread is not None:
            self._warm_thread.join(timeout=10)
            self._warm_thread = None
        if self._gc_kept is not None:
            import gc

            gc.set_threshold(*self._gc_kept)
            self._gc_kept = None

    # -- serving helpers -----------------------------------------------------

    def _note_namespace(self, ev) -> None:
        name = (ev.obj.get("metadata") or {}).get("name")
        if not name:
            return
        if ev.type == "DELETED":
            self._namespaces.pop(name, None)
        else:
            self._namespaces[name] = ev.obj

    def _get_namespace(self, name: str) -> Optional[dict]:
        ns = self._namespaces.get(name)
        if ns is None:
            # not delivered (yet): ask the apiserver
            ns = self.cluster.get(NAMESPACE_GVK, "", name)
        return ns

    def _capture_profile(self, path: str) -> bytes:
        """Capture a torch.profiler trace for ?seconds=N (default 2,
        clamped to [0, 60]); returns JSON naming the Chrome trace file
        (open with chrome://tracing or Perfetto) or an error. One
        capture at a time (the profiler rejects nesting). Concurrent
        device work — sweeps, webhook dispatches — lands in the trace."""
        from urllib.parse import parse_qs, urlparse

        try:
            q = parse_qs(urlparse(path).query)
            seconds = float(q.get("seconds", ["2"])[0])
        except (ValueError, TypeError):
            return 400, json.dumps(
                {"error": "bad seconds parameter"}
            ).encode()
        if not self._profile_lock.acquire(blocking=False):
            return 409, json.dumps(
                {"error": "a profile capture is already running"}
            ).encode()
        try:
            doc = capture_torch_profile(seconds)
            code = 500 if "error" in doc else 200
            return code, json.dumps(doc).encode()
        finally:
            self._profile_lock.release()

    def _serve_readyz(self) -> None:
        runner = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                if self.path == "/readyz":
                    # Ready = state replayed (reference semantics); warm
                    # status stays visible in stats but does not gate.
                    # A DRAINING webhook reports not-ready immediately —
                    # the flip happens before its listener closes, so a
                    # probing LB stops routing while connections still
                    # succeed (docs/robustness.md graceful drain)
                    ingested = runner.tracker.satisfied()
                    draining = (
                        runner.webhook is not None
                        and runner.webhook.draining
                    )
                    ok = ingested and not draining
                    stats = {
                        "ingested": ingested,
                        "draining": draining,
                        **runner.tracker.stats(),
                    }
                    if runner.audit is not None:
                        stats["audit"] = {
                            "warm": runner.audit.warmed.is_set(),
                            "last_sweep_seconds": (
                                runner.audit.audit_duration_seconds
                            ),
                            "errors": runner.audit.error_count,
                        }
                    if runner.webhook is not None:
                        # overload/degradation envelope health
                        # (docs/robustness.md): breaker state answers
                        # "why is admission on the interpreter", shed
                        # counts answer "are we dropping load"
                        wh = {
                            "fail_policy": runner.fail_policy,
                            "shed": runner.webhook.batcher.shed_count,
                            "batch_failures": (
                                runner.webhook.batcher.batch_failures
                            ),
                        }
                        breaker = runner.webhook.batcher.breaker
                        if breaker is not None:
                            wh["breaker"] = breaker.snapshot()
                        partitioner = getattr(
                            runner.webhook, "partitioner", None
                        )
                        if partitioner is not None:
                            # fault-domain health: the partition plan,
                            # quarantine state, and per-device breaker
                            # snapshots (docs/robustness.md §Fault
                            # domains)
                            wh["partitions"] = partitioner.snapshot()
                        mb = runner.webhook.mutate_batcher
                        if mb is not None:
                            wh["mutation"] = {
                                "shed": mb.shed_count,
                                "batch_failures": mb.batch_failures,
                                **(
                                    {"breaker": mb.breaker.snapshot()}
                                    if mb.breaker is not None
                                    else {}
                                ),
                            }
                        stats["webhook"] = wh
                        ing = getattr(runner.webhook, "ingest", None)
                        if ing is not None:
                            # front-door health (docs/ingest.md):
                            # connection/frame counts, decode-route
                            # split, protocol-error sheds
                            stats["ingest"] = ing.stats()
                    if runner.external_data is not None:
                        # provider health: per-provider breaker state +
                        # failurePolicy answers "which lookups are
                        # degraded right now" (docs/externaldata.md)
                        stats["externaldata"] = (
                            runner.external_data.snapshot()
                        )
                    if runner.fleet is not None:
                        # fleet health (docs/fleet.md): which peers are
                        # alive, what state arrived from them, and the
                        # cert generation this replica serves
                        fl = runner.fleet.snapshot()
                        rot = getattr(runner.webhook, "rotator", None)
                        fl["cert_generation"] = getattr(
                            rot, "cert_generation", None
                        )
                        fl["cert_rotations_adopted"] = getattr(
                            rot, "rotations_adopted", None
                        )
                        stats["fleet"] = fl
                    drv = getattr(runner.client, "_driver", None)
                    if drv is not None and hasattr(drv, "stats"):
                        # engine routing health (docs/metrics.md): WHY
                        # templates run interpreted + the analyzer/
                        # compiler consistency assertion
                        d_stats = drv.stats or {}
                        stats["driver"] = {
                            "fallback_codes": d_stats.get(
                                "fallback_codes",
                                {
                                    k[1]: v
                                    for k, v in getattr(
                                        drv, "_fallback_codes", {}
                                    ).items()
                                },
                            ),
                            "analyzer_mismatches": getattr(
                                drv, "analyzer_mismatches", 0
                            ),
                            "cold_batches": getattr(
                                drv, "cold_batches", 0
                            ),
                        }
                        warm = getattr(drv, "review_path_warm", None)
                        if warm is not None:
                            targets = (
                                runner.webhook.review_targets()
                                if runner.webhook is not None
                                else [runner.target]
                            )
                            stats["driver"]["review_path_warm"] = {
                                t: warm(t) for t in targets
                            }
                    # cost-attribution + flight-recorder headlines
                    # (full payloads live at /debug/costs and
                    # /debug/flightrecords)
                    stats["obs"] = {
                        "costs": runner.attributor.snapshot(),
                        "flightrecords": runner.recorder.snapshot(),
                        "decisions": runner.decisions.snapshot(),
                    }
                    # live SLO headline — the `saturation`/`burning`
                    # fields are the autoscaler contract (full
                    # breakdown at /debug/slo); docs/observability.md
                    # §SLO & saturation
                    stats["slo"] = runner.slo.autoscaler()
                    # verdict-integrity headline: canary/shadow/
                    # self-test counters + corruption-quarantine state
                    # (full payload at /debug/integrity;
                    # docs/robustness.md §Verdict integrity)
                    if runner.integrity is not None:
                        stats["integrity"] = (
                            runner.integrity.snapshot()
                        )
                    # admission-scheduler headline: per-plane policy,
                    # overload state, shed split, and per-tenant
                    # quota/usage table (full payload at /debug/sched;
                    # docs/operations.md §Admission scheduling)
                    wh = getattr(runner, "webhook", None)
                    if wh is not None and hasattr(
                        wh, "sched_snapshot"
                    ):
                        stats["sched"] = wh.sched_snapshot()
                    # corpus analysis headline (docs/analysis.md
                    # §Corpus analysis): diagnostic counts + the
                    # dead/prunable/shadowed rollup; recompute is
                    # debounced + off-path, so this only reads the
                    # cached report (and may kick a background pass)
                    corpus = getattr(runner, "corpus", None)
                    if corpus is not None:
                        corpus.maybe_recompute()
                        stats["analysis"] = {
                            "corpus": corpus.snapshot()
                        }
                    # IR static-analysis headline (docs/analysis.md
                    # §IR analysis): liveness-plane counters + the
                    # per-target report rollup (reads the cached
                    # report; first touch computes it once per
                    # constraint generation)
                    if drv is not None and hasattr(
                        drv, "liveness_stats"
                    ):
                        ir: Dict[str, Any] = drv.liveness_stats()
                        # the admission target name lives on the
                        # webhook's batcher (WebhookServer itself
                        # holds no target attr)
                        tgt = getattr(
                            getattr(
                                runner.webhook, "batcher", None
                            ),
                            "target",
                            "admission.k8s.gatekeeper.sh",
                        )
                        try:
                            rep = drv.ir_report(tgt)
                        except Exception:
                            rep = None
                        if rep is not None:
                            ir.update({
                                "ok": rep.ok,
                                "subjects": rep.subjects,
                                "counts": rep.counts(),
                                "liveness": rep.liveness,
                                "certificates": len(
                                    rep.certificates
                                ),
                            })
                        stats.setdefault("analysis", {})["ir"] = ir
                    payload = json.dumps(
                        {"ready": ok, "stats": stats}
                    ).encode()
                    self.send_response(200 if ok else 503)
                elif self.path.split("?")[0] == "/debug/traces":
                    # recent request/sweep traces — ?trace_id=/?limit=/
                    # ?format=otlp (docs/observability.md)
                    from ..metrics.registry import export_traces

                    payload = export_traces(
                        runner.tracer, self.path
                    ).encode()
                    self.send_response(200)
                elif self.path.split("?")[0] == "/debug/costs":
                    # per-constraint device-time cost table, sorted
                    # costliest-first with share-of-plane fractions
                    # (docs/observability.md §Cost attribution)
                    from ..metrics.registry import _debug_costs_k

                    payload = json.dumps(
                        runner.attributor.table(
                            _debug_costs_k(self.path)
                        )
                    ).encode()
                    self.send_response(200)
                elif self.path == "/debug/partitions":
                    # live plan composition: per-partition constraint
                    # keys, static/measured cost share, home device
                    # (docs/robustness.md §Fault domains)
                    part = getattr(
                        runner.webhook, "partitioner", None
                    )
                    if part is not None:
                        payload = json.dumps(
                            part.plan_table()
                        ).encode()
                        self.send_response(200)
                    else:
                        payload = (
                            b'{"error": "partitions disabled"}'
                        )
                        self.send_response(404)
                elif self.path == "/debug/programs":
                    # compile plane: per-partition sub-program
                    # signature/staging state + program-store
                    # hit/miss/rejected and swap generation
                    # (docs/compile.md)
                    part = getattr(
                        runner.webhook, "partitioner", None
                    )
                    if part is not None:
                        payload = json.dumps(
                            part.programs_table()
                        ).encode()
                        self.send_response(200)
                    else:
                        payload = (
                            b'{"error": "partitions disabled"}'
                        )
                        self.send_response(404)
                elif self.path == "/debug/flightrecords":
                    # trip-triggered postmortem captures, newest first
                    # (docs/observability.md §Flight recorder)
                    payload = runner.recorder.export_json().encode()
                    self.send_response(200)
                elif self.path.split("?")[0] == "/debug/decisions":
                    # per-admission "why" records — ?trace_id=/
                    # ?verdict=/?plane=/?limit=/?format=ndjson
                    # (docs/observability.md §Decision log)
                    from ..metrics.registry import export_decisions

                    payload = export_decisions(
                        runner.decisions, self.path
                    ).encode()
                    self.send_response(200)
                elif self.path.split("?")[0] == "/debug/sched":
                    # admission-scheduler plane: per-plane policy /
                    # overload / shed counters + per-tenant fair-share
                    # quota table — ?plane=/?tenants=0
                    # (docs/operations.md §Admission scheduling)
                    from ..sched import export_sched

                    wh = getattr(runner, "webhook", None)
                    if wh is not None and hasattr(
                        wh, "sched_snapshot"
                    ):
                        payload = export_sched(
                            wh.sched_snapshot(), self.path
                        ).encode()
                        self.send_response(200)
                    else:
                        payload = (
                            b'{"error": "webhook not running"}'
                        )
                        self.send_response(404)
                elif self.path.split("?")[0] == "/debug/slo":
                    # live SLO plane: per-plane/per-tenant attainment,
                    # burn rates, saturation/headroom — ?plane=/
                    # ?tenants=0 (docs/observability.md §SLO &
                    # saturation)
                    from ..obs.slo import export_slo

                    payload = export_slo(
                        runner.slo, self.path
                    ).encode()
                    self.send_response(200)
                elif self.path == "/debug/integrity":
                    # verdict-integrity plane: golden canary sets,
                    # per-device mismatch ledger, shadow-oracle
                    # counters, corruption-quarantine state
                    # (docs/robustness.md §Verdict integrity)
                    if runner.integrity is not None:
                        payload = json.dumps(
                            runner.integrity.snapshot()
                        ).encode()
                        self.send_response(200)
                    else:
                        payload = (
                            b'{"error": "integrity disabled"}'
                        )
                        self.send_response(404)
                elif self.path == "/healthz":
                    payload = b'{"ok": true}'
                    self.send_response(200)
                elif (
                    runner.enable_profiler
                    and self.path.startswith("/debug/profile")
                ):
                    code, payload = runner._capture_profile(self.path)
                    self.send_response(code)
                else:
                    payload = b'{"error": "not found"}'
                    self.send_response(404)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def log_message(self, *args):
                pass

        self._readyz_httpd = ThreadingHTTPServer(
            (self.bind_addr, self.readyz_port or 0), _Handler
        )
        self.readyz_port = self._readyz_httpd.server_address[1]
        threading.Thread(
            target=self._readyz_httpd.serve_forever, daemon=True
        ).start()


def capture_torch_profile(seconds: float) -> Dict[str, Any]:
    """One torch.profiler capture of `seconds` of live host and device
    work, written as a Chrome trace into a fresh temp directory (open
    with chrome://tracing or Perfetto). The Runner's /debug/profile
    endpoint calls it; callers own their own single-flight locking —
    the profiler itself rejects nesting."""
    import os
    import tempfile
    import time as _time

    seconds = max(0.0, min(float(seconds), 60.0))
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        out_dir = tempfile.mkdtemp(prefix="gk-torchprof-")
        with profile(activities=activities) as prof:
            _time.sleep(seconds)
        trace_file = os.path.join(out_dir, "trace.json")
        prof.export_chrome_trace(trace_file)
        return {
            "trace_dir": out_dir,
            "trace_file": trace_file,
            "seconds": seconds,
        }
    except Exception as e:
        return {"error": str(e)}


def load_yaml_dir(cluster: FakeCluster, path: str) -> int:
    """Bootstrap a FakeCluster from a directory tree of YAML manifests
    (the slim standalone stand-in for a live apiserver; SURVEY §7 M5
    allows exactly this for the benchmark configs)."""
    import os

    import yaml

    n = 0
    for root, _dirs, files in os.walk(path):
        for fname in sorted(files):
            if not fname.endswith((".yaml", ".yml")):
                continue
            with open(os.path.join(root, fname)) as f:
                for doc in yaml.safe_load_all(f):
                    if isinstance(doc, dict) and doc.get("kind"):
                        cluster.apply(doc)
                        n += 1
    return n
