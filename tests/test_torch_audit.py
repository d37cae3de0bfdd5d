"""The port's audit controller (gatekeeper_tpu_torch.audit.AuditManager over
TorchDriver("cpu")) against the JAX package's AuditManager over TpuDriver,
on the same inputs: the cases of tests/test_audit_manager.py (the
per-constraint cap, message truncation, the sweep loop, corpus reuse,
direct-list sweeps over unsynced kinds with the excluder, namespace
attachment, structured logs), plus the fault point and the sweep's spans.
The managers share a fixed clock, so whole reports compare equal.
"""

import copy
import threading

import pytest

import chip_smoke
from gatekeeper_tpu.audit import AuditManager as JManager, InMemorySink as JSink
from gatekeeper_tpu.constraint import (
    Backend as JBackend,
    K8sValidationTarget as JTarget,
)
from gatekeeper_tpu.constraint.tpudriver import TpuDriver
from gatekeeper_tpu.control import Excluder as JExcluder, FakeCluster as JCluster
from gatekeeper_tpu.logs import CapturingLogger as JLogger
from gatekeeper_tpu.obs import Tracer as JTracer
from gatekeeper_tpu_torch.audit import AuditManager as TManager, InMemorySink as TSink
from gatekeeper_tpu_torch.audit.manager import truncate_message
from gatekeeper_tpu_torch.constraint import (
    Backend as TBackend,
    K8sValidationTarget as TTarget,
)
from gatekeeper_tpu_torch.constraint.torchdriver import TorchDriver
from gatekeeper_tpu_torch.control import Excluder as TExcluder, FakeCluster as TCluster
from gatekeeper_tpu_torch.faults import FAULTS, FaultError, fire
from gatekeeper_tpu_torch.logs import CapturingLogger as TLogger
from gatekeeper_tpu_torch.obs import Tracer as TTracer

TARGET = chip_smoke.TARGET
NOW = 1_760_000_000.0

REQ_LABELS = """package authlabels

violation[{"msg": msg, "details": {"missing": missing}}] {
    required := {key | key := input.parameters.labels[_]}
    provided := {key | input.review.object.metadata.labels[key]}
    missing := required - provided
    count(missing) > 0
    msg := sprintf("required labels are missing on this object: %v (policy note: %v)", [missing, input.parameters.note])
}
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


def constraint(kind, name, params=None, match=None, action=None):
    spec = {"match": match or {"kinds": [{"apiGroups": [""], "kinds": ["Pod"]}]}}
    if params is not None:
        spec["parameters"] = params
    if action is not None:
        spec["enforcementAction"] = action
    return {
        "apiVersion": "constraints.gatekeeper.sh/v1beta1",
        "kind": kind,
        "metadata": {"name": name},
        "spec": spec,
    }


def pod(i, labels, ns="default"):
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {"name": f"p{i}", "namespace": ns, "labels": labels},
        "spec": {"containers": [{"name": "c", "image": "nginx"}]},
    }


N_CORPUS = 2000
N_BAD = 57  # pods missing the required label (> the 20-violation cap)

SIDES = {
    "torch": (TBackend, TTarget, lambda: TorchDriver(device="cpu"), TManager, TSink),
    "tpu": (JBackend, JTarget, TpuDriver, JManager, JSink),
}


def _client(side, templates, constraints, objs):
    backend, target, driver, _, _ = SIDES[side]
    client = backend(driver()).new_client(target())
    for t in templates:
        client.add_template(t)
    for c in constraints:
        client.add_constraint(c)
    for o in objs:
        client.add_data(copy.deepcopy(o))
    return client


def _manager(side, client, **kw):
    _, _, _, manager, sink = SIDES[side]
    kw.setdefault("sink", sink())
    kw.setdefault("now", lambda: NOW)
    kw.setdefault("audit_interval", 3600)
    return manager(client, TARGET, **kw)


def _corpus():
    out = []
    for i in range(N_CORPUS):
        labels = {"app": "a"}
        if i % (N_CORPUS // N_BAD + 1) != 0:
            labels["owner"] = "team"
        out.append(pod(i, labels))
    return out


@pytest.fixture(scope="module")
def managers():
    """Both sides' manager over the label corpus, a long-note constraint
    (messages past the cap of 256 bytes) and a dryrun one."""
    templates = [template("AuthLabels", REQ_LABELS)]
    constraints = [
        constraint("AuthLabels", "need-owner",
                   {"labels": ["owner"], "note": "x" * 400}),
        constraint("AuthLabels", "need-tier",
                   {"labels": ["tier"], "note": "n"}, action="dryrun"),
    ]
    objs = _corpus()
    out = {}
    for side in SIDES:
        client = _client(side, templates, constraints, objs)
        out[side] = (_manager(side, client), client)
    return out


def test_sweep_counts_cap_and_actions(managers):
    got = chip_smoke.report_key(managers["torch"][0].audit())
    want = chip_smoke.report_key(managers["tpu"][0].audit())
    assert got == want
    statuses = {s[0]: s for s in got["statuses"]}
    owner = statuses["AuthLabels/need-owner"]
    assert owner[4] > 20 and len(owner[5]) == 20  # capped detail list
    tier = statuses["AuthLabels/need-tier"]
    assert tier[4] == N_CORPUS and len(tier[5]) == 20
    assert got["by_action"] == {"deny": owner[4], "dryrun": N_CORPUS}
    assert got["total"] == owner[4] + N_CORPUS
    sink = managers["torch"][0].sink
    assert chip_smoke.report_key(sink.latest) == got


def test_messages_truncated(managers):
    report = managers["torch"][0].audit()
    assert chip_smoke.report_key(report) == chip_smoke.report_key(
        managers["tpu"][0].audit()
    )
    st = report.statuses["AuthLabels/need-owner"]
    for v in st.violations:
        assert len(v.message) <= 256
        assert v.message.endswith("...")
        assert v.name.startswith("p")
        assert v.namespace == "default"


def test_truncate_message_rules():
    assert truncate_message("short") == "short"
    assert truncate_message("a" * 256) == "a" * 256
    long = truncate_message("a" * 300)
    assert long == "a" * 253 + "..." and len(long) == 256
    assert truncate_message("abcdef", 3) == "abc..."


def test_second_sweep_reuses_encoded_corpus(managers):
    """Steady-state sweeps neither re-encode the corpus nor upload any
    table."""
    mgr, client = managers["torch"]
    drv = client._driver
    mgr.audit()
    c1 = drv._corpus[TARGET]
    mgr.audit()
    assert drv._corpus[TARGET] is c1
    up = drv.stats["upload"]
    assert up["full_uploads"] == 0 and up["delta_flushes"] == 0


def test_sweeps_across_churn_equal_jax():
    """Sweeps before and after add/remove-data churn on the larger
    corpus: reports equal the JAX manager's; the port's second sweep
    ships only new vocab rows."""
    templates = [template("AuthLabels", REQ_LABELS)]
    constraints = [constraint("AuthLabels", "need-owner",
                              {"labels": ["owner"], "note": "n"})]
    corpus = _corpus()
    sides = {}
    for side in SIDES:
        client = _client(side, templates, constraints, corpus)
        sides[side] = (_manager(side, client), client)
    reports = []
    for rnd in range(2):
        if rnd:
            for _, client in sides.values():
                for o in corpus[:40]:
                    client.remove_data(copy.deepcopy(o))
                for j in range(40):
                    client.add_data(pod(10_000 + j, {"app": f"new{j}"}))
        got, want = (chip_smoke.report_key(sides[s][0].audit()) for s in SIDES)
        assert got == want
        reports.append(got)
    assert reports[0] != reports[1]
    up = sides["torch"][1]._driver.stats["upload"]
    assert up["full_uploads"] == 0 and up["delta_flushes"] == 1


def test_sweep_loop_runs_on_interval():
    client = _client(
        "torch", [template("AuthLabels", REQ_LABELS)],
        [constraint("AuthLabels", "need-owner", {"labels": ["owner"], "note": "n"})],
        [pod(0, {"app": "a"})],
    )
    sink = TSink()
    mgr = TManager(client, TARGET, sink=sink, audit_interval=0.05)
    mgr.audit()
    n0 = len(sink.reports)
    mgr.start()
    try:
        threading.Event().wait(1.5)
        assert len(sink.reports) >= n0 + 2
        assert mgr.warmed.is_set() and mgr.last_error is None
    finally:
        mgr.stop()


ANY_DENY = {
    "apiVersion": "templates.gatekeeper.sh/v1beta1",
    "kind": "ConstraintTemplate",
    "metadata": {"name": "anydeny"},
    "spec": {
        "crd": {"spec": {"names": {"kind": "AnyDeny"}}},
        "targets": [{
            "target": TARGET,
            "rego": 'package anydeny\n\nviolation[{"msg": m}] '
                    '{ input.review.object.metadata.labels.bad\n'
                    'm := "bad label" }\n',
        }],
    },
}


def _widget(name, ns, bad=False):
    return {
        "apiVersion": "widgets.example.com/v1",
        "kind": "Widget",
        "metadata": {"name": name, "namespace": ns,
                     "labels": {"bad": "1"} if bad else {}},
    }


def test_audit_resources_covers_unsynced_gvks():
    """Direct-list mode finds violations in kinds never synced, skipping
    gatekeeper's own kinds, excluded namespaces and objects whose
    Namespace is missing; chunking at one object per page."""
    reports = {}
    for side, cluster_cls, excluder_cls in (
        ("torch", TCluster, TExcluder), ("tpu", JCluster, JExcluder),
    ):
        cluster = cluster_cls()
        for ns in ("default", "kube-system"):
            cluster.apply({"apiVersion": "v1", "kind": "Namespace",
                           "metadata": {"name": ns}})
        cluster.apply(_widget("w-bad", "default", bad=True))
        cluster.apply(_widget("w-ok", "default"))
        cluster.apply(_widget("w-excluded", "kube-system", bad=True))
        cluster.apply(_widget("w-orphan", "ghost-ns", bad=True))
        cluster.apply({
            "apiVersion": "constraints.gatekeeper.sh/v1beta1",
            "kind": "AnyDeny",
            "metadata": {"name": "deny-bad", "labels": {"bad": "1"}},
            "spec": {},
        })
        excluder = excluder_cls()
        excluder.replace(
            [{"processes": ["audit"], "excludedNamespaces": ["kube-system"]}]
        )
        client = _client(side, [ANY_DENY], [{
            "apiVersion": "constraints.gatekeeper.sh/v1beta1",
            "kind": "AnyDeny", "metadata": {"name": "deny-bad"}, "spec": {},
        }], [])
        cached = _manager(side, client).audit()
        assert cached.total_violations == 0  # nothing synced
        direct = _manager(
            side, client, audit_from_cache=False, cluster=cluster,
            excluder=excluder, audit_chunk_size=1,
        ).audit()
        reports[side] = chip_smoke.report_key(direct)
    assert reports["torch"] == reports["tpu"]
    assert reports["torch"]["total"] == 1
    ((_, _, _, _, _, viols),) = reports["torch"]["statuses"]
    assert viols[0][3] == "w-bad"


ALL_DENY = {
    "apiVersion": "templates.gatekeeper.sh/v1beta1",
    "kind": "ConstraintTemplate",
    "metadata": {"name": "alldeny"},
    "spec": {
        "crd": {"spec": {"names": {"kind": "AllDeny"}}},
        "targets": [{
            "target": TARGET,
            "rego": 'package alldeny\n\nviolation[{"msg": "no"}] { true }\n',
        }],
    },
}


@pytest.mark.parametrize("chunk", [0, 2, 512])
def test_audit_resources_attaches_namespaces_for_matching(chunk):
    """Direct-list mode attaches each object's Namespace, so namespaces
    and namespaceSelector match; every chunking convention agrees."""
    prod_only = constraint("AllDeny", "prod-only", match={
        "kinds": [{"apiGroups": [""], "kinds": ["Pod"]}],
        "namespaces": ["prod"],
        "namespaceSelector": {"matchLabels": {"env": "prod"}},
    })
    reports = {}
    for side, cluster_cls in (("torch", TCluster), ("tpu", JCluster)):
        cluster = cluster_cls()
        for ns, labels in (("prod", {"env": "prod"}), ("dev", {"env": "dev"})):
            cluster.apply({"apiVersion": "v1", "kind": "Namespace",
                           "metadata": {"name": ns, "labels": labels}})
            for i in range(3):
                cluster.apply(pod(f"{ns}-{i}", {"app": "a"}, ns=ns))
        client = _client(side, [ALL_DENY], [prod_only], [])
        reports[side] = chip_smoke.report_key(_manager(
            side, client, audit_from_cache=False, cluster=cluster,
            audit_chunk_size=chunk,
        ).audit())
    assert reports["torch"] == reports["tpu"]
    names = [v[3] for s in reports["torch"]["statuses"] for v in s[5]]
    assert sorted(names) == ["pprod-0", "pprod-1", "pprod-2"]


def test_audit_logs_structured_violations():
    records = {}
    for side, logger_cls in (("torch", TLogger), ("tpu", JLogger)):
        client = _client(
            side, [template("AuthLabels", REQ_LABELS)],
            [constraint("AuthLabels", "need-owner",
                        {"labels": ["owner"], "note": "n"})],
            [pod(1, {"app": "a"})],
        )
        log = logger_cls()
        report = _manager(side, client, logger=log).audit()
        assert report.total_violations == 1
        records[side] = [
            {k: v for k, v in r.items() if k != "ts"} for r in log.records
        ]
    assert records["torch"] == records["tpu"]
    (rec,) = [r for r in records["torch"]
              if r.get("event_type") == "violation_audited"]
    assert rec["process"] == "audit" and rec["resource_name"] == "p1"
    assert rec["constraint_kind"] == "AuthLabels"


def test_status_write_fault_keeps_the_report():
    """A failed status publication (the `audit.status_write` fault point)
    leaves the sweep's report intact and is logged."""
    client = _client(
        "torch", [template("AuthLabels", REQ_LABELS)],
        [constraint("AuthLabels", "need-owner", {"labels": ["owner"], "note": "n"})],
        [pod(1, {"app": "a"})],
    )
    log = TLogger()
    sink = TSink()
    mgr = _manager("torch", client, sink=sink, logger=log)
    FAULTS.arm("audit.status_write", mode="error", count=1)
    try:
        report = mgr.audit()
    finally:
        FAULTS.reset()
    assert report.total_violations == 1 and sink.reports == []
    assert any("publish failed" in r["msg"] for r in log.records)
    mgr.audit()
    assert len(sink.reports) == 1


def test_fault_point_fires_after_and_count():
    FAULTS.arm("point", mode="error", after=1, count=1)
    try:
        fire("point")  # skipped: the first hit
        with pytest.raises(FaultError):
            fire("point")
        fire("point")  # spent
        assert FAULTS.hits("point") == 3 and FAULTS.fired("point") == 1
    finally:
        FAULTS.reset()
    fire("point")  # disarmed


def test_sweep_spans_equal_jax():
    """Each sweep is one trace: audit_sweep with dispatch, aggregate and
    status_write children, carrying the same attributes as the JAX
    manager's."""
    spans = {}
    for side, tracer_cls in (("torch", TTracer), ("tpu", JTracer)):
        client = _client(
            side, [template("AuthLabels", REQ_LABELS)],
            [constraint("AuthLabels", "need-owner",
                        {"labels": ["owner"], "note": "n"})],
            [pod(i, {"app": "a"}) for i in range(5)],
        )
        tracer = tracer_cls()
        _manager(side, client, tracer=tracer).audit()
        (trace,) = tracer.recent()
        spans[side] = sorted(
            (s["name"], sorted(s["attrs"].items()), s["status"])
            for s in trace["spans"]
        )
    assert spans["torch"] == spans["tpu"]
    assert [s[0] for s in spans["torch"]] == [
        "aggregate", "audit_sweep", "dispatch", "status_write"
    ]
