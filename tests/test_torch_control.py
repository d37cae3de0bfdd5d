"""The port's control plane (gatekeeper_tpu_torch/control) on the CPU: the
cases of tests/test_control_plane.py against the port's copies — watch
manager semantics, the reconcilers (templates, constraints, data, Config,
Providers), readiness with /readyz 503 before Ready, status aggregation,
operations gating, the upgrade manager, boot from manifests and the
torch.profiler endpoint — with every Runner over a Client on
TorchDriver(device="cpu") and the port's FakeCluster. The reference's two
warm-path cases (serve-while-compiling) have no counterpart: nothing
compiles on the port; its warm thread runs once and ends.
"""

import json
import time
import urllib.request

import pytest

from gatekeeper_tpu_torch.constraint import Backend, K8sValidationTarget
from gatekeeper_tpu_torch.constraint.torchdriver import TorchDriver
from gatekeeper_tpu_torch.control import (
    CONFIG_GVK,
    FakeCluster,
    GVK,
    OPERATION_AUDIT,
    OPERATION_STATUS,
    OPERATION_WEBHOOK,
    Runner,
    TEMPLATE_GVK,
    WatchManager,
    constraint_gvk,
    load_yaml_dir,
)
from gatekeeper_tpu_torch.metrics import MetricsRegistry

TARGET = "admission.k8s.gatekeeper.sh"

REQ_LABELS = """package reqlabels

violation[{"msg": msg}] {
    required := {key | key := input.parameters.labels[_]}
    provided := {key | input.review.object.metadata.labels[key]}
    missing := required - provided
    count(missing) > 0
    msg := sprintf("missing: %v", [missing])
}
"""

DENY_ALL = """package denyall

violation[{"msg": "always denied"}] { true }
"""


def template(kind, rego):
    return {
        "apiVersion": "templates.gatekeeper.sh/v1beta1",
        "kind": "ConstraintTemplate",
        "metadata": {"name": kind.lower()},
        "spec": {
            "crd": {"spec": {"names": {"kind": kind}}},
            "targets": [{"target": TARGET, "rego": rego}],
        },
    }


def constraint(kind, name, params=None, match=None, enforcement=None):
    spec = {}
    if params is not None:
        spec["parameters"] = params
    if match is not None:
        spec["match"] = match
    if enforcement is not None:
        spec["enforcementAction"] = enforcement
    return {
        "apiVersion": "constraints.gatekeeper.sh/v1beta1",
        "kind": kind,
        "metadata": {"name": name},
        "spec": spec,
    }


def pod(name, ns="default", labels=None):
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {"name": name, "namespace": ns, "labels": labels or {}},
        "spec": {"containers": [{"name": "main", "image": "nginx"}]},
    }


def config(sync_kinds=(("", "v1", "Pod"),), match=None):
    return {
        "apiVersion": "config.gatekeeper.sh/v1alpha1",
        "kind": "Config",
        "metadata": {"name": "config", "namespace": "gatekeeper-system"},
        "spec": {
            "sync": {
                "syncOnly": [
                    {"group": g, "version": v, "kind": k}
                    for g, v, k in sync_kinds
                ]
            },
            **({"match": match} if match else {}),
        },
    }


def new_client():
    return Backend(TorchDriver(device="cpu")).new_client(K8sValidationTarget())


def make_runner(cluster, **kw):
    kw.setdefault("audit_interval", 3600.0)
    return Runner(cluster, new_client(), TARGET, **kw)


def audit_results(runner):
    return runner.audit.audit()


# ---------------------------------------------------------------------------
# watch manager


def test_watch_refcount_and_replay():
    cluster = FakeCluster()
    gvk = GVK("", "v1", "Pod")
    cluster.apply(pod("pre-existing"))
    mgr = WatchManager(cluster)
    seen_a, seen_b = [], []
    ra = mgr.new_registrar("a", seen_a.append)
    rb = mgr.new_registrar("b", seen_b.append)

    ra.add_watch(gvk)
    mgr.wait_idle()
    assert [e.obj["metadata"]["name"] for e in seen_a] == ["pre-existing"]

    # late joiner gets a replay of current state, not nothing
    rb.add_watch(gvk)
    mgr.wait_idle()
    assert [e.obj["metadata"]["name"] for e in seen_b] == ["pre-existing"]

    # live events fan out to both
    cluster.apply(pod("now"))
    mgr.wait_idle()
    assert seen_a[-1].obj["metadata"]["name"] == "now"
    assert seen_b[-1].obj["metadata"]["name"] == "now"

    # removal: a leaves, b still receives; b leaves, subscription gone
    ra.remove_watch(gvk)
    cluster.apply(pod("after-a-left"))
    mgr.wait_idle()
    assert seen_a[-1].obj["metadata"]["name"] == "now"
    assert seen_b[-1].obj["metadata"]["name"] == "after-a-left"
    rb.remove_watch(gvk)
    assert mgr.watched_gvks() == set()
    cluster.apply(pod("unwatched"))
    mgr.wait_idle()
    assert seen_b[-1].obj["metadata"]["name"] == "after-a-left"
    mgr.stop()


def test_replace_watch_swaps_set():
    cluster = FakeCluster()
    mgr = WatchManager(cluster)
    seen = []
    r = mgr.new_registrar("sync", seen.append)
    pods, svcs = GVK("", "v1", "Pod"), GVK("", "v1", "Service")
    r.replace_watch({pods})
    assert r.watched() == {pods}
    r.replace_watch({svcs})
    assert r.watched() == {svcs}
    cluster.apply(pod("p1"))
    mgr.wait_idle()
    assert seen == []  # pod watch was removed
    mgr.stop()


# ---------------------------------------------------------------------------
# boot to ready + serving


@pytest.fixture
def booted():
    cluster = FakeCluster()
    cluster.apply(template("K8sRequiredLabels", REQ_LABELS))
    cluster.apply(
        constraint(
            "K8sRequiredLabels", "need-owner", params={"labels": ["owner"]}
        )
    )
    cluster.apply(config())
    cluster.apply(pod("good", labels={"owner": "me"}))
    cluster.apply(pod("bad"))
    runner = make_runner(cluster, readyz_port=0)
    try:
        runner.start()
        assert runner.wait_ready(30), runner.tracker.stats()
        yield cluster, runner
    finally:
        runner.stop()


def test_boot_to_ready_and_audit(booted):
    cluster, runner = booted
    report = audit_results(runner)
    assert report.total_violations == 1
    st = report.statuses["K8sRequiredLabels/need-owner"]
    assert st.violations[0].name == "bad"

    # /readyz serves 200 with stats
    with urllib.request.urlopen(
        f"http://127.0.0.1:{runner.readyz_port}/readyz", timeout=30
    ) as resp:
        body = json.loads(resp.read())
    assert resp.status == 200 and body["ready"] is True


def test_metric_contract_surface(booted):
    """docs/metrics.md contract: every documented Prometheus series
    exists after boot + one admission + one sweep (the reference's
    docs/Metrics.md enumerates the same names)."""
    cluster, runner = booted
    audit_results(runner)  # one sweep
    resp = runner.webhook.handler.handle(
        {
            "uid": "m1",
            "kind": {"group": "", "version": "v1", "kind": "Pod"},
            "operation": "CREATE",
            "name": "mpod",
            "namespace": "default",
            "userInfo": {"username": "dev"},
            "object": pod("mpod"),
        }
    )
    assert resp.allowed is False
    text = runner.metrics.prometheus_text()
    for name in (
        "gatekeeper_constraints",
        "gatekeeper_constraint_templates",
        "gatekeeper_constraint_template_ingestion_count",
        "gatekeeper_constraint_template_ingestion_duration_seconds",
        "gatekeeper_request_count",
        "gatekeeper_request_duration_seconds",
        "gatekeeper_violations",
        "gatekeeper_audit_duration_seconds",
        "gatekeeper_audit_last_run_time",
        "gatekeeper_sync",
        "gatekeeper_sync_duration_seconds",
        "gatekeeper_sync_last_run_time",
        "gatekeeper_sync_gvk_count",
        "gatekeeper_watch_manager_watched_gvk",
        "gatekeeper_watch_manager_intended_watch_gvk",
    ):
        # boundary match: a deleted gatekeeper_sync counter must not be
        # satisfied by its gatekeeper_sync_duration_seconds sibling;
        # distributions expose name_count/name_sum series
        assert any(
            line.startswith(series + "{") or line.startswith(series + " ")
            for line in text.splitlines()
            for series in (name, name + "_count", name + "_sum")
        ), f"missing documented metric {name}"


def test_webhook_serves_from_ingested_state(booted):
    cluster, runner = booted
    req = {
        "uid": "u1",
        "kind": {"group": "", "version": "v1", "kind": "Pod"},
        "operation": "CREATE",
        "name": "incoming",
        "namespace": "default",
        "userInfo": {"username": "alice"},
        "object": pod("incoming"),
    }
    body = json.dumps(
        {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
         "request": req}
    ).encode()
    r = urllib.request.Request(
        f"http://127.0.0.1:{runner.webhook.port}/v1/admit",
        data=body,
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(r, timeout=30) as resp:
        out = json.loads(resp.read())
    assert out["response"]["allowed"] is False
    assert "need-owner" in out["response"]["status"]["message"]


def test_readyz_503_before_ready():
    cluster = FakeCluster()
    cluster.apply(template("K8sRequiredLabels", REQ_LABELS))
    runner = make_runner(cluster, readyz_port=0)
    # expectations populated but watches never started -> not ready
    try:
        runner._populate_expectations()
        runner._serve_readyz()
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(
                f"http://127.0.0.1:{runner.readyz_port}/readyz", timeout=30
            )
        assert exc.value.code == 503
    finally:
        runner.stop()


# ---------------------------------------------------------------------------
# churn


def test_ready_on_ingest_warm_swaps_in(booted):
    """Ready gates on state replay ONLY, matching the reference
    (ready_tracker.go:138-173); wait_ready(warm=True) is the strict mode
    that also waits for the audit warm sweep, and /readyz exposes the
    sweep's warmth as stats."""
    cluster, runner = booted
    assert runner.audit is not None
    # Ready right now (the booted fixture's wait_ready gates on
    # ingestion only), warm or not
    with urllib.request.urlopen(
        f"http://127.0.0.1:{runner.readyz_port}/readyz", timeout=30
    ) as resp:
        body = json.loads(resp.read())
    assert body["ready"] is True
    # ...and admission serves immediately regardless of compile state
    decision = runner.webhook.handler.handle(
        {
            "uid": "cold-1",
            "kind": {"group": "", "version": "v1", "kind": "Pod"},
            "operation": "CREATE",
            "name": "coldpod",
            "namespace": "default",
            "userInfo": {"username": "dev"},
            "object": pod("coldpod"),
        }
    )
    assert decision.allowed is False
    # strict mode still waits for the audit warm sweep
    assert runner.wait_ready(30, warm=True)
    assert runner.audit.warmed.is_set()
    assert runner.audit.audit_duration_seconds is not None
    with urllib.request.urlopen(
        f"http://127.0.0.1:{runner.readyz_port}/readyz", timeout=30
    ) as resp:
        body = json.loads(resp.read())
    assert body["stats"]["audit"]["warm"] is True
    assert body["stats"]["audit"]["last_sweep_seconds"] is not None


def test_warm_thread_ends_without_a_compile_step(booted):
    """The Runner's warm thread compiles and stages the policy once the
    state is ingested (TorchDriver.warm_review_path), before any batch
    asks for it, and polls review_path_warm as the reference's does: a
    constraint change is compiled again without a batch. /readyz
    stats.driver carries review_path_warm for each target the webhook
    reviews. The thread keeps polling until the Runner stops."""
    cluster, runner = booted
    drv = runner.client._driver
    t = runner._warm_thread
    assert t is not None
    assert _wait(lambda: runner.webhook.warm
                 and drv.review_path_warm(TARGET), 30)
    assert t.is_alive()
    assert drv._cset[TARGET].policy is not None
    gen0 = drv.constraint_generation()
    cluster.apply(constraint("K8sRequiredLabels", "need-team",
                             params={"labels": ["team"]}))
    assert _wait(lambda: drv.constraint_generation() > gen0
                 and drv.review_path_warm(TARGET), 30)
    assert len(drv._cset[TARGET].constraints) == 2
    with urllib.request.urlopen(
        f"http://127.0.0.1:{runner.readyz_port}/readyz", timeout=30
    ) as resp:
        body = json.loads(resp.read())
    assert body["stats"]["driver"]["review_path_warm"] == {TARGET: True}


def test_template_update_churn(booted):
    cluster, runner = booted
    # tighten the template: now requires both labels via new rego message
    new_rego = REQ_LABELS.replace("missing: %v", "absent: %v")
    cluster.apply(template("K8sRequiredLabels", new_rego))
    runner.watch_mgr.wait_idle()
    report = audit_results(runner)
    assert report.total_violations == 1
    msg = report.statuses["K8sRequiredLabels/need-owner"].violations[0].message
    assert msg.startswith("absent:")


def test_template_delete_removes_constraints(booted):
    cluster, runner = booted
    cluster.delete(template("K8sRequiredLabels", REQ_LABELS))
    runner.watch_mgr.wait_idle()
    report = audit_results(runner)
    assert report.total_violations == 0


def test_template_kind_rename_retires_old_kind(booted):
    # case-variant rename keeps name==lowercase(kind) valid but changes
    # the constraint GVK: the old kind's watch and constraints must be
    # torn down (controllers.py _on_upsert + client.add_template)
    cluster, runner = booted
    cluster.apply(template("K8SRequiredLabels", REQ_LABELS))
    runner.watch_mgr.wait_idle()
    # old-kind constraint no longer enforces
    assert audit_results(runner).total_violations == 0
    watched = set(runner.watch_mgr.watched_gvks())
    assert constraint_gvk("K8sRequiredLabels") not in watched
    assert constraint_gvk("K8SRequiredLabels") in watched
    # controller-side state for the retired kind is dropped: no pod-status
    # CR claims the old constraint is still enforced, and the constraints
    # gauge no longer counts it
    from gatekeeper_tpu_torch.control.status import CONSTRAINT_STATUS_GVK

    uids = {
        (o.get("status") or {}).get("constraintUID")
        for o in cluster.list(CONSTRAINT_STATUS_GVK)
    }
    assert "K8sRequiredLabels/need-owner" not in uids
    gauges = {
        k: v
        for k, v in runner.metrics.snapshot()["gauges"].items()
        if k.startswith("constraints{")
    }
    assert gauges and all(v == 0 for v in gauges.values()), gauges
    # a new-kind constraint flows through the fresh watch
    cluster.apply(
        constraint(
            "K8SRequiredLabels", "need-owner", params={"labels": ["owner"]}
        )
    )
    runner.watch_mgr.wait_idle()
    assert audit_results(runner).total_violations == 1


def test_constraint_churn(booted):
    cluster, runner = booted
    cluster.apply(
        constraint(
            "K8sRequiredLabels", "need-team", params={"labels": ["team"]}
        )
    )
    runner.watch_mgr.wait_idle()
    assert audit_results(runner).total_violations == 3  # both pods lack team
    cluster.delete(
        constraint("K8sRequiredLabels", "need-team")
    )
    runner.watch_mgr.wait_idle()
    assert audit_results(runner).total_violations == 1


def test_data_churn_mid_run(booted):
    cluster, runner = booted
    cluster.apply(pod("bad2"))
    runner.watch_mgr.wait_idle()
    assert audit_results(runner).total_violations == 2
    cluster.delete(pod("bad2"))
    runner.watch_mgr.wait_idle()
    assert audit_results(runner).total_violations == 1


def test_config_swap_wipes_and_replays(booted):
    cluster, runner = booted
    # swap sync to Services only: pod data must be wiped
    cluster.apply(config(sync_kinds=(("", "v1", "Service"),)))
    runner.watch_mgr.wait_idle()
    assert audit_results(runner).total_violations == 0
    # swap back: pods replayed via the new watch's initial List
    cluster.apply(config())
    runner.watch_mgr.wait_idle()
    assert audit_results(runner).total_violations == 1


def test_config_excluder_applies_to_webhook(booted):
    cluster, runner = booted
    cluster.apply(
        config(
            match=[
                {"processes": ["webhook"], "excludedNamespaces": ["kube-system"]}
            ]
        )
    )
    runner.watch_mgr.wait_idle()
    resp = runner.webhook.handler.handle(
        {
            "uid": "u2",
            "kind": {"group": "", "version": "v1", "kind": "Pod"},
            "operation": "CREATE",
            "name": "sys-pod",
            "namespace": "kube-system",
            "userInfo": {"username": "alice"},
            "object": pod("sys-pod", ns="kube-system"),
        }
    )
    assert resp.allowed is True
    assert "ignored" in resp.message


# ---------------------------------------------------------------------------
# status plane


def test_status_published_and_aggregated(booted):
    cluster, runner = booted
    runner.watch_mgr.wait_idle()
    by_pod = runner.status_agg.template_by_pod("k8srequiredlabels")
    assert len(by_pod) == 1 and by_pod[0]["errors"] == []
    c_by_pod = runner.status_agg.constraint_by_pod(
        "K8sRequiredLabels", "need-owner"
    )
    assert len(c_by_pod) == 1 and c_by_pod[0]["enforced"] is True


def test_bad_template_reports_error_status(booted):
    cluster, runner = booted
    cluster.apply(template("K8sBroken", "package broken\nthis is not rego"))
    runner.watch_mgr.wait_idle()
    assert "k8sbroken" in runner.template_controller.errors
    by_pod = runner.status_agg.template_by_pod("k8sbroken")
    assert len(by_pod) == 1 and by_pod[0]["errors"]


# ---------------------------------------------------------------------------
# operations gating


def test_operations_gating():
    cluster = FakeCluster()
    cluster.apply(template("K8sRequiredLabels", REQ_LABELS))
    audit_only = make_runner(cluster, operations=[OPERATION_AUDIT])
    try:
        audit_only.start()
        assert audit_only.webhook is None and audit_only.audit is not None
        assert audit_only.status_writer is None
    finally:
        audit_only.stop()

    webhook_only = make_runner(cluster, operations=[OPERATION_WEBHOOK])
    try:
        webhook_only.start()
        assert webhook_only.webhook is not None and webhook_only.audit is None
    finally:
        webhook_only.stop()


# ---------------------------------------------------------------------------
# boot from a manifest directory


def test_boot_from_yaml_dir(tmp_path):
    import yaml

    (tmp_path / "01-template.yaml").write_text(
        yaml.safe_dump(template("K8sDenyAll", DENY_ALL))
    )
    (tmp_path / "02-constraint.yaml").write_text(
        yaml.safe_dump(constraint("K8sDenyAll", "deny-everything"))
    )
    (tmp_path / "03-config.yaml").write_text(yaml.safe_dump(config()))
    (tmp_path / "04-pod.yaml").write_text(yaml.safe_dump(pod("victim")))

    cluster = FakeCluster()
    n = load_yaml_dir(cluster, str(tmp_path))
    assert n == 4
    runner = make_runner(cluster)
    try:
        runner.start()
        assert runner.wait_ready(30), runner.tracker.stats()
        report = audit_results(runner)
        assert report.total_violations == 1
        assert report.statuses[
            "K8sDenyAll/deny-everything"
        ].violations[0].name == "victim"
    finally:
        runner.stop()


def test_trace_config_reconciled_and_applied(booted):
    """Config spec.validation.traces flips per-request tracing at
    runtime (config_types.go:39-51; policy.go:387-408)."""
    cluster, runner = booted
    cfg = config()
    cfg["spec"]["validation"] = {
        "traces": [
            {
                "user": "auditor",
                "kind": {"group": "", "version": "v1", "kind": "Pod"},
            }
        ]
    }
    cluster.apply(cfg)
    runner.watch_mgr.wait_idle()
    h = runner.webhook.handler

    req = {
        "uid": "t1",
        "kind": {"group": "", "version": "v1", "kind": "Pod"},
        "operation": "CREATE",
        "name": "traced",
        "namespace": "default",
        "userInfo": {"username": "auditor"},
        "object": pod("traced"),
    }
    before = len(h.traces)
    h.handle(req)
    assert len(h.traces) > before  # matched rule -> trace captured
    assert "eval" in h.traces[-1] or "tpu" in h.traces[-1]

    other = dict(req, userInfo={"username": "someone-else"})
    before = len(h.traces)
    h.handle(other)
    assert len(h.traces) == before  # non-matching user -> no trace


def test_admission_and_audit_events_emitted():
    cluster = FakeCluster()
    cluster.apply(template("K8sRequiredLabels", REQ_LABELS))
    cluster.apply(
        constraint(
            "K8sRequiredLabels", "need-owner", params={"labels": ["owner"]}
        )
    )
    cluster.apply(config())
    cluster.apply(pod("bad"))
    runner = make_runner(
        cluster, emit_admission_events=True, emit_audit_events=True
    )
    try:
        runner.start()
        assert runner.wait_ready(30)
        resp = runner.webhook.handler.handle(
            {
                "uid": "e1",
                "kind": {"group": "", "version": "v1", "kind": "Pod"},
                "operation": "CREATE",
                "name": "evpod",
                "namespace": "default",
                "userInfo": {"username": "dev"},
                "object": pod("evpod"),
            }
        )
        assert resp.allowed is False
        admission_events = [
            e for e in runner.events if e["reason"] == "FailedAdmission"
        ]
        assert admission_events and admission_events[0]["resource_name"] == (
            "evpod"
        )

        runner.audit.audit()
        audit_events = [
            e for e in runner.events if e["reason"] == "AuditViolation"
        ]
        assert audit_events and audit_events[0]["resource_name"] == "bad"
    finally:
        runner.stop()


def test_config_edit_with_unchanged_syncset_keeps_data(booted):
    """A Config change that does NOT alter syncOnly (e.g. only match or
    traces edited) must still leave synced data intact: the wipe that
    precedes the watch swap has to be followed by a replay of EVERY GVK
    in the new set, retained ones included (config_controller.go:294)."""
    cluster, runner = booted
    assert audit_results(runner).total_violations == 1
    cluster.apply(
        config(
            match=[{"processes": ["webhook"],
                    "excludedNamespaces": ["kube-system"]}]
        )
    )
    runner.watch_mgr.wait_idle()
    # the pod data survived the wipe via replay
    assert audit_results(runner).total_violations == 1


def test_excluded_data_does_not_wedge_readiness():
    """An object listed at boot but excluded by the Config's sync match
    must not hold /readyz at 503 (the sink cancels its expectation)."""
    cluster = FakeCluster()
    cluster.apply(template("K8sRequiredLabels", REQ_LABELS))
    cluster.apply(
        constraint(
            "K8sRequiredLabels", "need-owner", params={"labels": ["owner"]}
        )
    )
    cluster.apply(
        config(
            match=[{"processes": ["sync"],
                    "excludedNamespaces": ["kube-system"]}]
        )
    )
    cluster.apply(pod("sys", ns="kube-system"))
    cluster.apply(pod("normal"))
    runner = make_runner(cluster)
    try:
        runner.start()
        assert runner.wait_ready(30), runner.tracker.stats()
        # the excluded pod was not ingested
        assert audit_results(runner).total_violations == 1  # only "normal"
    finally:
        runner.stop()


def test_upgrade_manager_migrates_stored_versions():
    """pkg/upgrade parity: gatekeeper objects stored at v1alpha1 are
    migrated to v1beta1 before the controllers watch, so they ingest."""
    cluster = FakeCluster()
    old_tmpl = template("K8sRequiredLabels", REQ_LABELS)
    old_tmpl["apiVersion"] = "templates.gatekeeper.sh/v1alpha1"
    cluster.apply(old_tmpl)
    old_c = constraint(
        "K8sRequiredLabels", "need-owner", params={"labels": ["owner"]}
    )
    old_c["apiVersion"] = "constraints.gatekeeper.sh/v1alpha1"
    cluster.apply(old_c)
    cluster.apply(config())
    cluster.apply(pod("bad"))

    runner = make_runner(cluster)
    try:
        runner.start()
        assert runner.wait_ready(30), runner.tracker.stats()
        assert len(runner.upgrade_mgr.upgraded) == 2
        # migrated objects live at v1beta1 now...
        assert cluster.list(TEMPLATE_GVK)
        assert not cluster.list(
            GVK("templates.gatekeeper.sh", "v1alpha1", "ConstraintTemplate")
        )
        # ...and were ingested: the policy enforces
        assert audit_results(runner).total_violations == 1
    finally:
        runner.stop()


def test_upgrade_never_clobbers_preferred_version():
    """A stale v1alpha1 copy must not overwrite the live v1beta1 object
    of the same name during migration."""
    from gatekeeper_tpu_torch.control import UpgradeManager

    cluster = FakeCluster()
    new_tmpl = template("K8sRequiredLabels", REQ_LABELS)
    cluster.apply(new_tmpl)
    stale = template("K8sRequiredLabels", DENY_ALL)
    stale["apiVersion"] = "templates.gatekeeper.sh/v1alpha1"
    cluster.apply(stale)

    UpgradeManager(cluster).upgrade()
    (kept,) = cluster.list(TEMPLATE_GVK)
    rego = kept["spec"]["targets"][0]["rego"]
    assert "required" in rego  # the v1beta1 content survived
    assert not cluster.list(
        GVK("templates.gatekeeper.sh", "v1alpha1", "ConstraintTemplate")
    )


def test_debug_profiler_endpoint():
    """--enable-pprof equivalent: /debug/profile captures a torch.profiler
    trace and names its Chrome trace file; off by default (404)."""
    import os as _os
    import urllib.error

    cluster = FakeCluster()
    runner = make_runner(cluster, enable_profiler=True, readyz_port=0,
                         operations=[OPERATION_AUDIT])
    try:
        runner.start()
        with urllib.request.urlopen(
            f"http://127.0.0.1:{runner.readyz_port}/debug/profile?seconds=0.1",
            timeout=30,
        ) as r:
            out = json.loads(r.read())
        assert _os.path.isdir(out["trace_dir"])
        with open(out["trace_file"]) as f:
            assert "traceEvents" in json.load(f)
    finally:
        runner.stop()

    off = make_runner(cluster, readyz_port=0, operations=[OPERATION_AUDIT])
    try:
        off.start()
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(
                f"http://127.0.0.1:{off.readyz_port}/debug/profile",
                timeout=10,
            )
        assert exc.value.code == 404
    finally:
        off.stop()


# ---------------------------------------------------------------------------
# external-data provider controller (docs/externaldata.md)


def provider_obj(name, url="http://sig.example/v1", **spec):
    base = {"url": url, "timeout": 2, "cacheTTLSeconds": 30}
    base.update(spec)
    return {
        "apiVersion": "externaldata.gatekeeper.sh/v1alpha1",
        "kind": "Provider",
        "metadata": {"name": name},
        "spec": base,
    }


def provider_status(cluster, name, pod_name="gatekeeper-pod"):
    from gatekeeper_tpu_torch.control.status import (
        PROVIDER_STATUS_GVK,
        STATUS_NAMESPACE,
    )

    return cluster.get(
        PROVIDER_STATUS_GVK,
        STATUS_NAMESPACE,
        f"{pod_name}-provider-{name}",
    )


def test_provider_controller_lifecycle(booted):
    """Provider CR churn: upsert -> registry + ProviderPodStatus;
    invalid spec -> error status (never a crash); delete -> both gone."""
    cluster, runner = booted
    cluster.apply(provider_obj("sigs", failurePolicy="Fail"))
    runner.watch_mgr.wait_idle()
    p = runner.external_data.get("sigs")
    assert p is not None and p.failure_policy == "closed"
    st = provider_status(cluster, "sigs")
    assert st is not None
    assert st["status"]["active"] is True
    assert st["status"]["failurePolicy"] == "closed"

    # invalid spec: quarantined with an error status, registry keeps
    # serving the last good version? No — upsert rejects, so the OLD
    # provider stays registered and the status carries the error
    cluster.apply(provider_obj("sigs", url="ftp://nope"))
    runner.watch_mgr.wait_idle()
    st = provider_status(cluster, "sigs")
    assert st["status"]["active"] is False
    assert any(
        "scheme" in e["message"] for e in st["status"]["errors"]
    )
    assert runner.external_data.get("sigs") is not None

    cluster.delete(
        GVK("externaldata.gatekeeper.sh", "v1alpha1", "Provider"),
        "",
        "sigs",
    )
    runner.watch_mgr.wait_idle()
    assert runner.external_data.get("sigs") is None
    assert provider_status(cluster, "sigs") is None


def test_provider_config_wipe_replay(booted):
    """A Config change wipes the provider registry + response cache and
    the bounced watch replays every Provider CR (the control plane's
    replayData motion, extended to external data)."""
    cluster, runner = booted
    cluster.apply(provider_obj("sigs"))
    cluster.apply(provider_obj("cmdb", url="http://cmdb.example/q"))
    runner.watch_mgr.wait_idle()
    assert runner.external_data.names() == ["cmdb", "sigs"]
    # seed a cache entry that the wipe must drop
    runner.external_data.cache.put("sigs", "k", value="v", ttl=300)
    cluster.apply(config(sync_kinds=(("", "v1", "Pod"), ("", "v1", "Namespace"))))
    runner.watch_mgr.wait_idle()
    assert runner.external_data.names() == ["cmdb", "sigs"]
    from gatekeeper_tpu_torch.externaldata.cache import MISS

    assert (
        runner.external_data.cache.classify("sigs", ["k"])["k"][0] == MISS
    )


def test_provider_ingestion_metrics_and_readyz(booted):
    cluster, runner = booted
    cluster.apply(provider_obj("sigs"))
    runner.watch_mgr.wait_idle()
    text = runner.metrics.prometheus_text()
    assert any(
        line.startswith("gatekeeper_provider_ingestion_count{")
        for line in text.splitlines()
    )
    assert any(
        line.startswith("gatekeeper_externaldata_providers ")
        or line.startswith("gatekeeper_externaldata_providers{")
        for line in text.splitlines()
    )
    with urllib.request.urlopen(
        f"http://127.0.0.1:{runner.readyz_port}/readyz", timeout=30
    ) as resp:
        body = json.loads(resp.read())
    ed = body["stats"]["externaldata"]
    assert "sigs" in ed["providers"]
    assert ed["providers"]["sigs"]["breaker"]["state"] == "closed"


def test_host_oracle_freezes_no_inventory_for_an_inventory_free_policy():
    """The shadow oracle's interpreter evaluation (Client.review_host) of
    a policy whose templates read no data.inventory leaves the synced
    objects unfrozen; a batch's interpreter renders too. Freezing 100,000
    pods under the serving mutex stalled admission on the card."""
    from gatekeeper_tpu_torch.constraint import AugmentedUnstructured

    drv = TorchDriver(device="cpu")
    client = Backend(drv).new_client(K8sValidationTarget())
    client.add_template(template("K8sRequiredLabels", REQ_LABELS))
    client.add_constraint(constraint(
        "K8sRequiredLabels", "need-owner", params={"labels": ["owner"]}))
    for i in range(20):
        client.add_data(pod(f"p{i}"))
    got = client.review_host(AugmentedUnstructured(pod("x")))
    assert [r.msg for r in got.by_target[TARGET].results]
    assert client.audit().by_target[TARGET].results
    assert drv._frozen_inv == {}


def test_host_oracle_yields_to_queued_fused_dispatches():
    """The host oracle (the shadow oracle's Client.review_host) waits
    while a fused dispatch is queued on the serving mutex, for at most
    ORACLE_YIELD_S, so back-to-back oracle calls cannot hold admission
    batches past their timeout; a dispatch counts while it waits."""
    import threading

    from gatekeeper_tpu_torch.constraint import AugmentedUnstructured
    from gatekeeper_tpu_torch.constraint import torchdriver

    drv = TorchDriver(device="cpu")
    client = Backend(drv).new_client(K8sValidationTarget())
    client.add_template(template("K8sRequiredLabels", REQ_LABELS))
    client.add_constraint(constraint(
        "K8sRequiredLabels", "need-owner", params={"labels": ["owner"]}))
    review = AugmentedUnstructured(pod("x"))

    # a dispatch blocked on the mutex is counted, and runs once released
    done = threading.Event()
    drv._mutex.acquire()
    try:
        t = threading.Thread(
            target=lambda: (client.review_many([review]), done.set()))
        t.start()
        deadline = time.monotonic() + 10
        while drv._fused_waiting != 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert drv._fused_waiting == 1
    finally:
        drv._mutex.release()
    assert done.wait(30)
    t.join(30)
    assert drv._fused_waiting == 0

    # the oracle waits while one is queued...
    drv._fused_waiting = 1
    timer = threading.Timer(0.3, lambda: setattr(drv, "_fused_waiting", 0))
    timer.start()
    t0 = time.monotonic()
    assert client.review_host(review).by_target[TARGET].results
    assert time.monotonic() - t0 >= 0.25
    timer.join(5)
    # ...and proceeds after ORACLE_YIELD_S if the queue never drains
    drv._fused_waiting = 1
    try:
        t0 = time.monotonic()
        client.review_host(review)
        assert torchdriver.ORACLE_YIELD_S <= time.monotonic() - t0 < 10
    finally:
        drv._fused_waiting = 0


# ---------------------------------------------------------------------------
# mutation: the mutator controller, its status, the Runner's wiring


def _mutator(kind, name, location, value=None, match=None):
    spec = {"location": location}
    if kind == "ModifySet":
        spec["parameters"] = {"operation": "merge",
                              "values": {"fromList": [value]}}
    else:
        spec["parameters"] = {"assign": {"value": value}}
    if kind != "AssignMetadata":
        spec["applyTo"] = [{"groups": [""], "versions": ["v1"],
                            "kinds": ["Pod"]}]
    if match is not None:
        spec["match"] = match
    return {"apiVersion": "mutations.gatekeeper.sh/v1alpha1", "kind": kind,
            "metadata": {"name": name}, "spec": spec}


MUTATOR_EVENTS = [
    ("ADDED", _mutator("Assign", "obj-view", "spec.foo.bar", "v")),
    ("ADDED", _mutator("Assign", "broken", "spec..x", "v")),
    ("ADDED", _mutator("AssignMetadata", "owner", "metadata.labels.owner",
                       "platform")),
    ("ADDED", _mutator("Assign", "list-view", "spec.foo[name: x].bar", "v")),
    ("ADDED", _mutator("ModifySet", "args", "spec.containers[name: *].args",
                       "--v")),
    ("MODIFIED", _mutator("Assign", "broken", "spec.x", "v")),
    ("DELETED", _mutator("Assign", "list-view", "spec.foo[name: x].bar",
                         "v")),
    ("DELETED", _mutator("ModifySet", "args",
                         "spec.containers[name: *].args", "--v")),
]


def test_mutator_controller_ingest_remove_and_status_equal_jax():
    """MutatorController ingestion, schema-conflict quarantine, removal
    and the MutatorPodStatus writes, step by step against the JAX
    package's controller over its own FakeCluster."""
    from gatekeeper_tpu.control import FakeCluster as JFakeCluster
    from gatekeeper_tpu.control.controllers import (
        MUTATOR_GVKS as J_MUTATOR_GVKS,
        MutatorController as JMutatorController,
    )
    from gatekeeper_tpu.control.events import Event as JEvent
    from gatekeeper_tpu.control.status import (
        MUTATOR_STATUS_GVK as J_STATUS_GVK,
        StatusWriter as JStatusWriter,
    )
    from gatekeeper_tpu.metrics import MetricsRegistry as JMetricsRegistry
    from gatekeeper_tpu.mutation import MutationSystem as JMutationSystem
    from gatekeeper_tpu_torch.control import MUTATOR_GVKS, MutatorController
    from gatekeeper_tpu_torch.control.events import Event
    from gatekeeper_tpu_torch.control.status import (
        MUTATOR_STATUS_GVK,
        StatusWriter,
    )
    from gatekeeper_tpu_torch.mutation import MutationSystem

    sides = []
    for (cluster, gvks, ctrl_cls, event, writer, status_gvk, registry,
         system) in (
        (FakeCluster(), MUTATOR_GVKS, MutatorController, Event, StatusWriter,
         MUTATOR_STATUS_GVK, MetricsRegistry(),
         MutationSystem(device="cpu")),
        (JFakeCluster(), J_MUTATOR_GVKS, JMutatorController, JEvent,
         JStatusWriter, J_STATUS_GVK, JMetricsRegistry(), JMutationSystem()),
    ):
        system.metrics = registry
        ctrl = ctrl_cls(system, metrics=registry,
                        status=writer(cluster, "pod-1"))
        by_kind = {g.kind: g for g in gvks}
        steps = []
        for etype, obj in MUTATOR_EVENTS:
            ctrl.sink(event(etype, by_kind[obj["kind"]], obj))
            steps.append((
                dict(ctrl.errors), system.conflicts(),
                [m.id for m in system.ordered()],
                sorted((s["metadata"]["name"], s["metadata"].get("labels"),
                        s["status"]) for s in cluster.list(status_gvk)),
            ))
        snap = registry.snapshot()
        sides.append((steps, snap["gauges"], {
            k: v for k, v in snap["counters"].items()
            if k.startswith("mutator_ingestion_count")}))
    assert sides[0] == sides[1]
    steps = sides[0][0]
    assert steps[3][1]  # the list-view/obj-view conflict quarantined both
    assert "Assign/obj-view" not in steps[3][2]
    assert not steps[-1][1] and "Assign/obj-view" in steps[-1][2]
    assert "Assign/broken" in steps[1][0] and not steps[5][0]


def _post_mutate(runner, req):
    body = json.dumps({"apiVersion": "admission.k8s.io/v1",
                       "kind": "AdmissionReview", "request": req}).encode()
    r = urllib.request.Request(
        f"http://127.0.0.1:{runner.webhook.port}/v1/mutate", data=body,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(r, timeout=30) as resp:
        return json.loads(resp.read())


def _wait(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.02)
    return pred()


def test_runner_serves_mutate_and_config_replays_mutators(booted):
    """Mutator CRs ingest through the Runner's watches into /v1/mutate;
    a Config change wipes the mutator set and the bounced watches replay
    it; the screen runs on the driver's device."""
    import base64

    from gatekeeper_tpu_torch.mutation.patch import apply_patch

    cluster, runner = booted
    assert runner.mutation_system.device == runner.client._driver.device
    cluster.apply(_mutator("AssignMetadata", "owner", "metadata.labels.owner",
                           "platform"))
    cluster.apply(_mutator("Assign", "pull", "spec.containers[name: *]."
                           "imagePullPolicy", "Always",
                           match={"labelSelector": {"matchLabels": {
                               "app": "web"}}}))
    assert _wait(lambda: runner.mutation_system.count() == 2)
    obj = pod("incoming", labels={"app": "web"})
    req = {"uid": "m1", "kind": {"group": "", "version": "v1",
                                 "kind": "Pod"},
           "operation": "CREATE", "name": "incoming", "namespace": "default",
           "userInfo": {"username": "alice"}, "object": obj}
    out = _post_mutate(runner, req)
    ops = json.loads(base64.b64decode(out["response"]["patch"]))
    after = apply_patch(obj, ops)
    assert after["metadata"]["labels"]["owner"] == "platform"
    assert after["spec"]["containers"][0]["imagePullPolicy"] == "Always"
    assert runner.mutation_system.screen_dispatches >= 1
    gen = runner.mutation_system.generation
    cluster.apply(config(sync_kinds=(("", "v1", "Pod"),
                                     ("", "v1", "Namespace"))))
    runner.watch_mgr.wait_idle(timeout=10)
    assert _wait(lambda: runner.mutation_system.count() == 2)
    assert runner.mutation_system.generation >= gen + 2  # wiped, replayed
    out = _post_mutate(runner, dict(req, uid="m2"))
    assert out["response"]["patch"]


def test_readyz_mutation_and_corpus_blocks(booted):
    cluster, runner = booted
    cluster.apply(_mutator("AssignMetadata", "owner", "metadata.labels.owner",
                           "platform"))
    assert _wait(lambda: runner.mutation_system.count() == 1)
    runner.corpus.refresh(force=True)

    def readyz():
        with urllib.request.urlopen(
            f"http://127.0.0.1:{runner.readyz_port}/readyz", timeout=30
        ) as resp:
            return json.loads(resp.read())["stats"]

    stats = readyz()
    mut = stats["webhook"]["mutation"]
    assert mut["shed"] == 0 and mut["batch_failures"] == 0
    assert mut["breaker"]["state"] == "closed"
    corpus = stats["analysis"]["corpus"]
    assert corpus["computed"] and corpus["subjects"] == 3
    assert "mutation" in stats["sched"]
    text = runner.metrics.prometheus_text()
    assert "gatekeeper_mutator_ingestion_count{" in text


def test_ingest_mutation_frames_answer_as_http():
    """Framed mutation requests go to the mutation handler: the same
    answer bytes as /v1/mutate over HTTP (the reference's frame routing;
    the port answered them 404 before mutation was ported)."""
    from gatekeeper_tpu_torch.ingest import PLANE_MUTATE, StreamClient
    from gatekeeper_tpu_torch.mutation import MutationSystem
    from gatekeeper_tpu_torch.webhook import WebhookServer

    system = MutationSystem(device="cpu")
    system.upsert(_mutator("AssignMetadata", "owner",
                           "metadata.labels.owner", "platform"))
    server = WebhookServer(new_client(), TARGET, window_ms=2.0,
                           request_timeout=30, ingest=True,
                           mutation_system=system)
    server.start()
    try:
        for i, operation in enumerate(("CREATE", "DELETE")):
            req = {"uid": f"f{i}", "kind": {"group": "", "version": "v1",
                                            "kind": "Pod"},
                   "operation": operation, "name": f"p{i}",
                   "namespace": "default",
                   "userInfo": {"username": "alice"},
                   "object": pod(f"p{i}")}
            body = json.dumps({"apiVersion": "admission.k8s.io/v1",
                               "kind": "AdmissionReview",
                               "request": req}).encode()
            with StreamClient("127.0.0.1", server.ingest.port) as c:
                status, payload = c.request(body, PLANE_MUTATE,
                                            timeout=30.0)
            r = urllib.request.Request(
                f"http://127.0.0.1:{server.port}/v1/mutate", data=body,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(r, timeout=30) as resp:
                http_body = json.loads(resp.read())
            assert status == 200
            framed = json.loads(payload)
            assert framed == http_body
            assert ("patch" in framed["response"]) is (operation == "CREATE")
        assert server.batcher.requests_batched == 0
        assert server.mutate_batcher.requests_batched >= 2
    finally:
        server.stop()


def test_runner_freezes_each_sweep_and_sets_collector_thresholds(
        monkeypatch):
    """Once ingested, the Runner freezes the heap and sets the collector
    thresholds of PERF.md §6 until it stops; every audit sweep freezes
    again."""
    import gc

    from gatekeeper_tpu_torch.control.runner import GC_THRESHOLDS

    kept = gc.get_threshold()
    freezes = []
    real = gc.freeze
    monkeypatch.setattr(gc, "freeze", lambda: freezes.append(1) or real())
    cluster = FakeCluster()
    cluster.apply(config())
    cluster.apply(pod("a"))
    runner = make_runner(cluster)
    try:
        runner.start()
        assert runner.wait_ready(30)
        assert _wait(lambda: gc.get_threshold() == GC_THRESHOLDS)
        assert _wait(lambda: len(freezes) == 2)  # ingested, first sweep
        assert runner.audit.freeze_after_sweep
        for _ in range(3):
            runner.audit.audit()
        assert len(freezes) == 5
    finally:
        runner.stop()
    assert gc.get_threshold() == kept


# ---------------------------------------------------------------------------
# C6: Ready latches for good, as Gatekeeper's tracker does


def _readyz(port):
    try:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/readyz", timeout=30
        ) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, None


def _new_kind_after_ready(cluster, tracker):
    """A template and a constraint of a kind first seen after Ready; wait
    until the constraint's tracker has observed it."""
    cluster.apply(template("K8sDenyAll", DENY_ALL))
    cluster.apply(constraint("K8sDenyAll", "deny-everything"))
    assert _wait(lambda: "constraint/K8sDenyAll" in tracker.stats(), 30)


def test_ready_latches_when_a_constraint_kind_arrives_after_ready(booted):
    """C6: once Ready, a port Runner stays Ready when a template and a
    constraint of a new kind are created; the new kind's tracker still
    counts its own stats."""
    cluster, runner = booted
    assert _readyz(runner.readyz_port)[0] == 200
    _new_kind_after_ready(cluster, runner.tracker)
    assert _wait(lambda: any(
        c.get("kind") == "K8sDenyAll"
        for c in runner.client._driver._constraints(TARGET)), 30)
    runner.watch_mgr.wait_idle(10)
    code, body = _readyz(runner.readyz_port)
    assert code == 200, runner.tracker.stats()
    assert "constraint/K8sDenyAll" in runner.tracker.stats()
    assert runner.tracker.satisfied()
    # the latch is the aggregate's: a bare tracker unlatched stays so
    assert not runner.tracker.for_constraint_kind("Never").satisfied()
    assert runner.tracker.satisfied()


def test_jax_package_unlatches_when_a_constraint_kind_arrives_after_ready():
    """The reference side of C6, pinned as a standing divergence: the JAX
    package's Runner answers /readyz 503 after the same sequence."""
    from gatekeeper_tpu.constraint import (
        Backend as JBackend,
        K8sValidationTarget as JTarget,
        RegoDriver as JRegoDriver,
    )
    from gatekeeper_tpu.control import FakeCluster as JFakeCluster
    from gatekeeper_tpu.control import Runner as JRunner

    cluster = JFakeCluster()
    cluster.apply(template("K8sRequiredLabels", REQ_LABELS))
    cluster.apply(constraint("K8sRequiredLabels", "need-owner",
                             params={"labels": ["owner"]}))
    cluster.apply(config())
    cluster.apply(pod("good", labels={"owner": "me"}))
    runner = JRunner(cluster,
                     JBackend(JRegoDriver()).new_client(JTarget()), TARGET,
                     readyz_port=0, audit_interval=3600.0)
    try:
        runner.start()
        assert runner.wait_ready(30), runner.tracker.stats()
        assert _readyz(runner.readyz_port)[0] == 200
        _new_kind_after_ready(cluster, runner.tracker)
        runner.watch_mgr.wait_idle(10)
        assert _readyz(runner.readyz_port)[0] == 503
        assert not runner.tracker.satisfied()
    finally:
        runner.stop()


# ---------------------------------------------------------------------------
# the agent-action plane through run.py's --agent-review


SHELL_ALLOWLIST = """package agentshellallowlist
allowed_cmd(c) { c == input.parameters.allowed[_] }
violation[{"msg": msg}] {
  cmd := input.review.object.spec.arguments.command
  not allowed_cmd(cmd)
  msg := sprintf("shell command <%v> is outside the allowlist", [cmd])
}
"""


def test_agent_review_flag_mounts_the_agent_plane():
    """`--agent-review` registers AgentActionTarget beside the K8s target;
    the Runner mounts /v1/agent/review, gossips the `device:agent`
    breaker over the fleet plane, warms both targets and reports each in
    /readyz stats.driver.review_path_warm; an agent constraint created
    after Ready is served and /readyz stays 200 (C6)."""
    from gatekeeper_tpu.control import GVK as JGVK
    from gatekeeper_tpu_torch import run as trun
    from gatekeeper_tpu_torch.agentaction import TARGET_NAME
    from test_kubecluster import MockApiServer

    agent_tmpl = template("AgentShellAllowlist", SHELL_ALLOWLIST)
    agent_tmpl["spec"]["targets"][0]["target"] = TARGET_NAME
    allow = constraint("AgentShellAllowlist", "shell-allowlist",
                       params={"allowed": ["ls"]},
                       match={"tools": ["shell.*"]})
    m = MockApiServer()
    m.register(JGVK("", "v1", "Secret"), "secrets", True)
    m.register(JGVK("fleet.gatekeeper.sh", "v1alpha1", "FleetState"),
               "fleetstates", True)
    m.register(JGVK("constraints.gatekeeper.sh", "v1beta1",
                    "AgentShellAllowlist"), "agentshellallowlists", False)
    m.seed({"apiVersion": "v1", "kind": "Namespace",
            "metadata": {"name": "default"}})
    m.seed(template("K8sRequiredLabels", REQ_LABELS))
    m.seed(constraint("K8sRequiredLabels", "need-owner",
                      params={"labels": ["owner"]}))
    args = trun.build_parser().parse_args(
        ["--kube-url", m.url, "--port", "0", "--health-addr-port", "0",
         "--audit-interval", "3600", "--log-level", "error",
         "--fleet-namespace", "default", "--agent-review"])
    assert trun.build_parser().parse_args([]).agent_review is False
    cluster, runner = trun.build_runner(args, webhook_tls=False,
                                        device="cpu")
    assert set(runner.client.targets) == {TARGET, TARGET_NAME}
    url = None
    try:
        runner.start()
        assert runner.wait_ready(60), runner.tracker.stats()
        assert runner.webhook.agent_handler is not None
        assert runner.webhook.review_targets() == [TARGET, TARGET_NAME]
        assert "device:agent" in runner.fleet.snapshot()["breakers"]
        drv = runner.client._driver
        assert _wait(lambda: drv.review_path_warm(TARGET)
                     and drv.review_path_warm(TARGET_NAME), 30)
        k8s_set = drv._cset[TARGET]
        # an agent template and constraint after Ready
        m.seed(agent_tmpl)
        m.seed(allow)
        assert _wait(lambda: len(drv._constraints(TARGET_NAME)) == 1, 30)
        assert _wait(lambda: drv.review_path_warm(TARGET_NAME), 30)
        # the K8s set was neither rebuilt nor cold
        assert drv._cset[TARGET] is k8s_set and drv.review_path_warm(TARGET)
        code, body = _readyz(runner.readyz_port)
        assert code == 200
        assert body["stats"]["driver"]["review_path_warm"] == {
            TARGET: True, TARGET_NAME: True}
        url = f"http://127.0.0.1:{runner.webhook.port}/v1/agent/review"

        def review(command, tool="shell.exec"):
            body = json.dumps({"request": {
                "uid": command, "agent": "planner-1", "tool": tool,
                "arguments": {"command": command}}}).encode()
            with urllib.request.urlopen(url, data=body, timeout=30) as f:
                return json.loads(f.read())["response"]

        denied = review("rm")
        assert denied["allowed"] is False
        assert "shell-allowlist" in denied["status"]["message"]
        assert review("ls")["allowed"] is True
        assert review("rm", tool="net.fetch")["allowed"] is True
        assert runner.webhook.agent_batcher.batches_dispatched >= 3
    finally:
        runner.stop()
        cluster.stop()
        m.close()


def test_constraint_churn_is_counted_per_target():
    """TorchDriver counts constraint churn per target: an agent
    constraint leaves the K8s target's whole set and subset set compiled
    and its review path warm, and cools the agent target's; a write of
    the whole constraints tree cools every target."""
    from gatekeeper_tpu_torch.agentaction import (
        AgentActionTarget,
        TARGET_NAME,
    )
    from gatekeeper_tpu_torch.constraint.torchdriver import constraint_key

    drv = TorchDriver(device="cpu")
    client = Backend(drv).new_client(K8sValidationTarget(),
                                     AgentActionTarget())
    client.add_template(template("K8sRequiredLabels", REQ_LABELS))
    for i in range(2):
        client.add_constraint(constraint("K8sRequiredLabels", f"req-{i}",
                                         params={"labels": [f"l{i}"]}))
    agent_tmpl = template("AgentShellAllowlist", SHELL_ALLOWLIST)
    agent_tmpl["spec"]["targets"][0]["target"] = TARGET_NAME
    client.add_template(agent_tmpl)
    client.add_constraint(constraint("AgentShellAllowlist", "allow-ls",
                                     params={"allowed": ["ls"]}))
    for t in (TARGET, TARGET_NAME):
        assert drv.warm_review_path(t, [])
    k8s_set = drv._constraint_set(TARGET)
    sub = frozenset(constraint_key(c) for c in k8s_set.constraints[:1])
    k8s_sub = drv._subset_cset(TARGET, sub)
    gen0 = drv.constraint_generation()

    client.add_constraint(constraint("AgentShellAllowlist", "allow-cat",
                                     params={"allowed": ["cat"]}))
    assert drv.constraint_generation() > gen0
    assert drv._constraint_set(TARGET) is k8s_set
    assert drv._subset_cset(TARGET, sub) is k8s_sub
    assert drv.subset_carryforwards == 0
    assert drv.review_path_warm(TARGET)
    assert not drv.review_path_warm(TARGET_NAME)
    assert len(drv._constraint_set(TARGET_NAME).constraints) == 2

    assert drv.warm_review_path(TARGET_NAME, [])
    drv.put_data("constraints", drv.storage.get(["constraints"], None))
    assert not drv.review_path_warm(TARGET)
    assert not drv.review_path_warm(TARGET_NAME)
    assert drv._constraint_set(TARGET) is not k8s_set
    # the subset's content is unchanged: carried forward, not rebuilt
    assert drv._subset_cset(TARGET, sub) is k8s_sub
    assert drv.subset_carryforwards == 1


# ---------------------------------------------------------------------------
# C8: a replica without a target's plane beside templates of that target


AGENT_KINDS = ("AgentShellAllowlist", "AgentNetAllowlist", "AgentFsAllowlist")


def _c8_cluster(fake_cluster):
    """A K8s template and constraint beside 3 agent templates with 2
    constraints each (seeded: the same documents for both packages)."""
    from gatekeeper_tpu_torch.agentaction import TARGET_NAME

    cluster = fake_cluster()
    cluster.apply(template("K8sRequiredLabels", REQ_LABELS))
    cluster.apply(constraint("K8sRequiredLabels", "need-owner",
                             params={"labels": ["owner"]}))
    for i, kind in enumerate(AGENT_KINDS):
        tmpl = template(kind, SHELL_ALLOWLIST.replace(
            "agentshellallowlist", kind.lower()))
        tmpl["spec"]["targets"][0]["target"] = TARGET_NAME
        cluster.apply(tmpl)
        for j in range(2):
            cluster.apply(constraint(kind, f"{kind.lower()}-{j}",
                                     params={"allowed": [f"cmd{i}{j}"]},
                                     match={"tools": ["shell.*"]}))
    cluster.apply(config())
    cluster.apply(pod("good", labels={"owner": "me"}))
    return cluster


def test_replica_without_a_target_becomes_ready_beside_its_templates():
    """C8 repaired: a K8s-only port Runner beside agent templates and
    their constraints is Ready; each agent kind's tracker reports its
    expectations cancelled, and each agent template's status keeps its
    ingest error."""
    cluster = _c8_cluster(FakeCluster)
    runner = make_runner(cluster, readyz_port=0)
    try:
        runner.start()
        assert runner.wait_ready(15), runner.tracker.stats()
        stats = runner.tracker.stats()
        for kind in AGENT_KINDS:
            assert stats[f"constraint/{kind}"] == {
                "expected": 0, "observed": 0, "cancelled": 2}, stats
            name = kind.lower()
            assert name in runner.template_controller.errors
            by_pod = runner.status_agg.template_by_pod(name)
            assert len(by_pod) == 1 and by_pod[0]["errors"], by_pod
        assert stats["constraint/K8sRequiredLabels"] == {
            "expected": 1, "observed": 1}
        assert _readyz(runner.readyz_port)[0] == 200
        # the K8s policy serves as before
        assert [r.constraint["metadata"]["name"]
                for r in runner.client.review(pod("bad")).results()] == [
            "need-owner"]
    finally:
        runner.stop()


def test_jax_package_never_ready_beside_an_unservable_target():
    """The reference side of C8, pinned as a standing divergence: the JAX
    package's Runner on the same cluster ingests everything it can and
    stays unready, each agent kind 0 of 2 observed."""
    from gatekeeper_tpu.constraint import (
        Backend as JBackend,
        K8sValidationTarget as JTarget,
        RegoDriver as JRegoDriver,
    )
    from gatekeeper_tpu.control import FakeCluster as JFakeCluster
    from gatekeeper_tpu.control import Runner as JRunner

    cluster = _c8_cluster(JFakeCluster)
    runner = JRunner(cluster,
                     JBackend(JRegoDriver()).new_client(JTarget()), TARGET,
                     readyz_port=0, audit_interval=3600.0)
    try:
        runner.start()
        assert _wait(lambda: all(
            k.lower() in runner.template_controller.errors
            for k in AGENT_KINDS), 15)
        runner.watch_mgr.wait_idle(10)
        assert not runner.wait_ready(2)
        stats = runner.tracker.stats()
        for kind in AGENT_KINDS:
            assert stats[f"constraint/{kind}"] == {
                "expected": 2, "observed": 0}, stats
        assert _readyz(runner.readyz_port)[0] == 503
    finally:
        runner.stop()
