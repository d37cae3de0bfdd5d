"""The port's admission scheduler (gatekeeper_tpu_torch/sched) on the CPU:
the cases of tests/test_sched.py that need no soak harness, on the port's
AdmissionScheduler, MicroBatcher and DecisionLog over
TorchDriver(device="cpu"); one seeded sequence of offer/cut calls under an
injected clock and a fake SLO signal, driven through the JAX scheduler and
the port's, giving identical admit, shed and victim decisions, cuts and
snapshots; and the SloEngine's cost EWMA fed by a fused batch (the
device-seconds fact TorchDriver reports as phase_seconds["dispatch"])."""

import json
import random

import pytest

from gatekeeper_tpu.sched import (
    AdmissionScheduler as JAdmissionScheduler,
    BatchCostModel as JBatchCostModel,
)
from gatekeeper_tpu_torch.constraint import Backend, K8sValidationTarget
from gatekeeper_tpu_torch.constraint.torchdriver import TorchDriver
from gatekeeper_tpu_torch.faults import ShedError
from gatekeeper_tpu_torch.metrics import MetricsRegistry
from gatekeeper_tpu_torch.obs import DecisionLog, SloEngine, Tracer
from gatekeeper_tpu_torch.sched import (
    POLICIES,
    AdmissionScheduler,
    BatchCostModel,
    TokenBucket,
    export_sched,
    fair_shares,
)
from gatekeeper_tpu_torch.webhook.server import (
    BatchedValidationHandler,
    MicroBatcher,
)

TARGET = "admission.k8s.gatekeeper.sh"


class FakeSlo:
    """Injected autoscaler signal (the scheduler's only SLO seam)."""

    def __init__(self, saturation=0.0, headroom=100.0, arrival=10.0,
                 burning=False, cost=None):
        self.saturation = saturation
        self.headroom = headroom
        self.arrival = arrival
        self.burning = burning
        self.cost = cost

    def autoscaler(self):
        return {
            "saturation": self.saturation,
            "burning": self.burning,
            "estimated_headroom_rps": self.headroom,
            "arrival_rps": self.arrival,
        }

    def cost_per_row(self):
        return self.cost


def item(deadline=None, tenant=None):
    """A pending-queue tuple: the scheduler reads only indices 4/5."""
    return ("req", "fut", None, (0.0, 0.0), deadline, tenant)


def make_sched(policy="deadline", clock_box=None, per_row=0.1, **kw):
    clock_box = clock_box if clock_box is not None else [0.0]
    kw.setdefault("cost_model", BatchCostModel(per_row_fn=lambda: per_row))
    return AdmissionScheduler(
        plane="validation", policy=policy,
        clock=lambda: clock_box[0], **kw
    )


# -- fair shares + token bucket ----------------------------------------------


def test_fair_shares_water_filling_exact():
    shares = fair_shares({"a": 10.0, "b": 20.0, "c": 200.0}, 100.0)
    assert shares == {"a": 10.0, "b": 20.0, "c": 70.0}
    shares = fair_shares({"a": 10.0, "b": 500.0, "c": 500.0}, 100.0)
    assert shares == {"a": 10.0, "b": 45.0, "c": 45.0}
    shares = fair_shares({"b": 0.0, "a": 0.0}, 10.0, floor=1.0)
    assert shares == {"a": 1.0, "b": 1.0}
    assert fair_shares({}, 100.0) == {}
    shares = fair_shares({"a": 5.0}, 0.0, floor=0.5)
    assert shares == {"a": 0.5}


def test_token_bucket_refill_and_bounded_debt():
    b = TokenBucket(rate_rps=2.0, now=0.0)  # burst = 2 rps * 2 s = 4
    assert b.burst == 4.0 and b.tokens == 4.0
    for _ in range(4):
        assert b.take(0.0)
    assert not b.take(0.0)
    assert b.tokens == -1.0
    for _ in range(50):
        b.take(0.0)
    assert b.tokens == -4.0
    b.take(1.5, n=0.0)
    assert b.tokens == pytest.approx(-1.0)
    assert b.take(100.0)
    assert b.tokens == pytest.approx(3.0)
    b.set_rate(0.0)
    assert b.rate == pytest.approx(1e-3)


def test_cost_model_resolution_order():
    slo = FakeSlo(cost=0.02)

    class Att:
        dispatches = 10
        total_seconds = 64.0  # 6.4 s/dispatch over 64 nominal rows

    m = BatchCostModel(slo=slo, attributor=Att(), per_row_fn=lambda: 0.5)
    assert m.per_row_seconds() == 0.5
    m = BatchCostModel(slo=slo, attributor=Att())
    assert m.per_row_seconds() == 0.02
    m = BatchCostModel(slo=FakeSlo(cost=None), attributor=Att())
    assert m.per_row_seconds() == pytest.approx(0.1)
    m = BatchCostModel()
    assert m.per_row_seconds() == pytest.approx(2e-4)
    assert m.predict(10) == pytest.approx(2e-3)
    assert m.predict(-5) == 0.0


# -- the enqueue-side decision ------------------------------------------------


def test_fifo_policy_is_bit_compatible():
    """The rollback path: exact legacy shed message, newest-arrival
    drop, no victims, and NO sched_* metric series."""
    metrics = MetricsRegistry()
    s = make_sched(policy="fifo", max_queue=2, metrics=metrics)
    pending = [item(), item()]
    key, shed, victim = s.offer(pending, tenant={"namespace": "ns1"})
    assert key == "ns1"
    assert victim is None
    assert isinstance(shed, ShedError)
    assert str(shed) == "admission queue full (2 pending)"
    assert shed.reason == "queue_full"
    key, shed, victim = s.offer([], tenant={"namespace": "ns1"})
    assert shed is None and victim is None
    assert s.admitted == 1
    batch, rest = s.cut(pending, max_batch=64)
    assert batch == pending and rest == []
    snap = metrics.snapshot()
    for family in snap.values():
        if isinstance(family, dict):
            assert not any(k.startswith("sched_") for k in family)


def test_unloaded_plane_admits_exactly_like_fifo():
    clock = [0.0]
    s = make_sched(clock_box=clock, slo=FakeSlo(saturation=0.2),
                   max_queue=8)
    key, shed, victim = s.offer(
        [], tenant={"namespace": "ns1"}, deadline=0.05
    )
    assert shed is None and victim is None
    assert s.snapshot()["overloaded"] is False


def test_predictive_shed_boundary_cases():
    clock = [100.0]
    s = make_sched(clock_box=clock, slo=FakeSlo(saturation=0.95),
                   max_queue=64, min_share_rps=1000.0)
    pending = [item(deadline=200.0)] * 4
    key, shed, victim = s.offer(
        pending, tenant={"namespace": "ns1"}, deadline=100.5
    )
    assert shed is None
    key, shed, victim = s.offer(
        pending, tenant={"namespace": "ns1"}, deadline=100.4999
    )
    assert isinstance(shed, ShedError)
    assert shed.reason == "predicted_miss"
    assert shed.predicted_slack_ms < 0
    assert victim is None
    key, shed, victim = s.offer(pending, tenant={"namespace": "ns1"})
    assert shed is None
    snap = s.snapshot()
    assert snap["overloaded"] is True
    assert snap["sheds"]["predicted_miss"] == 1
    assert snap["tenants"]["ns1"]["shed"] == 1
    assert snap["tenants"]["ns1"]["admitted"] == 2


def test_full_queue_evicts_doomed_victim_not_viable_newcomer():
    clock = [100.0]
    s = make_sched(clock_box=clock, max_queue=4)
    doomed = item(deadline=100.01, tenant="ns-doomed")
    pending = [
        doomed,
        item(deadline=100.9, tenant="a"),
        item(deadline=101.0, tenant="b"),
        item(tenant="c"),
    ]
    key, shed, victim = s.offer(
        pending, tenant={"namespace": "ns-new"}, deadline=100.9
    )
    assert shed is None
    assert victim is not None
    idx, vexc = victim
    assert pending[idx] is doomed
    assert vexc.reason == "predicted_miss"
    assert vexc.predicted_slack_ms < 0
    assert s.snapshot()["sheds"]["predicted_miss"] == 1
    viable = [item(deadline=200.0, tenant="a")] * 4
    key, shed, victim = s.offer(
        viable, tenant={"namespace": "ns-new"}, deadline=200.0
    )
    assert victim is None
    assert isinstance(shed, ShedError)
    assert shed.reason == "queue_full"
    assert str(shed) == "admission queue full (4 pending)"


def test_tenant_capped_only_while_overloaded():
    metrics = MetricsRegistry()
    clock = [0.0]
    slo = FakeSlo(saturation=0.95, headroom=0.0, arrival=0.0)
    s = make_sched(clock_box=clock, slo=slo, max_queue=64, metrics=metrics)
    tenant = {"namespace": "hog"}
    assert s.offer([], tenant=tenant)[1] is None
    assert s.offer([], tenant=tenant)[1] is None
    key, shed, victim = s.offer([], tenant=tenant)
    assert isinstance(shed, ShedError)
    assert shed.reason == "tenant_capped"
    assert shed.tenant_capped is True
    snap = s.snapshot()
    assert snap["sheds"]["tenant_capped"] == 1
    assert snap["tenants"]["hog"]["throttled"] == 1
    assert snap["tenants"]["hog"]["tokens"] < 0
    counters = metrics.snapshot()["counters"]
    assert any(k.startswith("sched_tenant_throttled_total") for k in counters)
    assert any(
        k.startswith("sched_shed_total") and 'reason="tenant_capped"' in k
        for k in counters
    )
    s2 = make_sched(clock_box=[0.0], slo=FakeSlo(saturation=0.1),
                    max_queue=64)
    for _ in range(5):
        assert s2.offer([], tenant=tenant)[1] is None
    assert s2.snapshot()["tenants"]["hog"]["tokens"] < 0


def test_requota_is_max_min_fair_over_live_headroom():
    clock = [0.0]
    slo = FakeSlo(saturation=0.95, headroom=60.0, arrival=40.0)
    s = make_sched(clock_box=clock, slo=slo, max_queue=64)
    for t in ("a", "b"):
        s.offer([], tenant={"namespace": t})
    clock[0] = 1.5
    s.offer([], tenant={"namespace": "a"})
    snap = s.snapshot()
    assert snap["tenants"]["a"]["share_rps"] >= 50.0
    assert snap["tenants"]["b"]["share_rps"] >= 50.0


def test_tenant_key_identity():
    tk = AdmissionScheduler.tenant_key
    assert tk({"namespace": "ns1", "username": "u"}) == "ns1"
    assert tk({"username": "u"}) == "u"
    assert tk({"agent": "planner", "session": "s1"}) == "planner/s1"
    assert tk({"agent": "planner"}) == "planner"
    assert tk(None) is None
    assert tk({}) is None
    assert tk("raw") == "raw"


def test_classify_deadline_classes():
    s = make_sched()
    assert s.classify(None, 0.0) == "none"
    assert s.classify(1.5, 0.0) == "urgent"
    assert s.classify(2.0, 0.0) == "urgent"
    assert s.classify(2.1, 0.0) == "standard"


# -- the dispatch-side decision ----------------------------------------------


def test_cut_orders_edf_and_respects_earliest_deadline():
    metrics = MetricsRegistry()
    s = make_sched(clock_box=[0.0], metrics=metrics)  # per_row 0.1
    nodl = item(tenant="d")
    pending = [
        nodl, item(deadline=5.0, tenant="b"),
        item(deadline=0.35, tenant="a"), item(deadline=10.0, tenant="c"),
    ]
    batch, rest = s.cut(pending, max_batch=64, now=0.0)
    assert [it[4] for it in batch] == [0.35, 5.0, 10.0]
    assert rest == [nodl]
    snap = s.snapshot()
    assert snap["cuts"] == 1
    assert snap["last_cut"] == {
        "size": 3,
        "predicted_seconds": pytest.approx(0.3),
        "deferred": 1,
    }
    msnap = metrics.snapshot()
    assert any(
        k.startswith("sched_batch_predicted_seconds")
        for k in msnap["distributions"]
    )
    assert any(k.startswith("sched_queue_depth") for k in msnap["gauges"])
    urgent = item(deadline=0.15, tenant="u")
    batch, rest = s.cut([nodl, urgent], max_batch=64, now=0.0)
    assert batch == [urgent] and rest == [nodl]
    many = [item(deadline=100.0) for _ in range(8)]
    batch, rest = s.cut(many, max_batch=3, now=0.0)
    assert len(batch) == 3 and len(rest) == 5
    assert s.cut([], max_batch=8) == ([], [])


# -- snapshot + export --------------------------------------------------------


def test_snapshot_and_export_sched_filters():
    s = make_sched(slo=FakeSlo(saturation=0.95))
    s.offer([], tenant={"namespace": "ns1"}, deadline=100.0)
    snap = s.snapshot()
    for k in ("plane", "policy", "overloaded", "saturation",
              "overload_threshold", "headroom_rps", "arrival_rps",
              "cost_per_row_s", "admitted", "cuts", "last_cut",
              "sheds", "tenants"):
        assert k in snap, k
    doc = {"validation": snap, "mutation": make_sched().snapshot()}
    full = json.loads(export_sched(doc, "/debug/sched"))
    assert set(full["planes"]) == {"validation", "mutation"}
    one = json.loads(export_sched(doc, "/debug/sched?plane=validation"))
    assert set(one["planes"]) == {"validation"}
    lean = json.loads(export_sched(doc, "/debug/sched?tenants=0"))
    assert all("tenants" not in p for p in lean["planes"].values())
    assert "tenants" in full["planes"]["validation"]


def test_policy_validation():
    assert POLICIES == ("fifo", "deadline")
    with pytest.raises(ValueError):
        AdmissionScheduler(policy="lifo")


# -- the same seeded decisions as the JAX scheduler ---------------------------


def _drive(sched_cls, cost_cls, seed, policy, saturation, burning):
    """One seeded sequence of offer/cut calls on an injected clock; ->
    every decision, cut and snapshot, as plain data."""
    rng = random.Random(seed)
    clock = [1000.0]
    slo = FakeSlo(saturation=saturation, headroom=rng.choice([0.0, 50.0]),
                  arrival=rng.uniform(5.0, 80.0), burning=burning)
    s = sched_cls(
        plane="validation", policy=policy, max_queue=12,
        clock=lambda: clock[0], slo=slo, max_tenants=4,
        cost_model=cost_cls(slo=slo, per_row_fn=lambda: 0.004),
    )
    pending, log = [], []
    for step in range(400):
        clock[0] += rng.expovariate(60.0)
        if rng.random() < 0.15:
            batch, rest = s.cut(list(pending), rng.choice([1, 4, 16]),
                                now=clock[0])
            log.append(("cut", [it[0] for it in batch],
                        [it[0] for it in rest]))
            pending = rest
            continue
        tenant = rng.choice([{"namespace": f"ns{rng.randrange(6)}"},
                             {"username": "u"}, None, {}])
        deadline = rng.choice([None, clock[0] + rng.uniform(-0.01, 0.2)])
        key, shed, victim = s.offer(pending, tenant=tenant,
                                    deadline=deadline, now=clock[0])
        if victim is not None:
            idx, vexc = victim
            log.append(("victim", pending[idx][0], str(vexc), vexc.reason,
                        vexc.predicted_slack_ms))
            pending.pop(idx)
        if shed is not None:
            log.append(("shed", step, key, str(shed), shed.reason,
                        shed.predicted_slack_ms, shed.tenant_capped))
        else:
            pending.append((step, None, None, (0.0, 0.0), deadline, key))
            log.append(("admit", step, key))
    return log, s.snapshot()


@pytest.mark.parametrize("seed,policy,saturation,burning", [
    (11, "fifo", 0.95, False),
    (12, "deadline", 0.2, False),
    (13, "deadline", 0.95, False),
    (14, "deadline", 0.8, True),
])
def test_decisions_equal_the_jax_scheduler(seed, policy, saturation, burning):
    """Admits, sheds (reason, message, slack), victims, cuts and the
    final snapshot equal the JAX AdmissionScheduler's on the same seeded
    offer/cut sequence."""
    want = _drive(JAdmissionScheduler, JBatchCostModel, seed, policy,
                  saturation, burning)
    got = _drive(AdmissionScheduler, BatchCostModel, seed, policy,
                 saturation, burning)
    assert got == want
    kinds = {e[0] for e in got[0]}
    assert {"admit", "cut"} <= kinds
    if policy == "deadline" and saturation >= 0.75:
        assert "shed" in kinds


# -- integration: batcher -> decision log, and verdict parity -----------------


def _ns_client():
    rego = """package schedlabels

violation[{"msg": msg}] {
    required := {key | key := input.parameters.labels[_]}
    provided := {key | input.review.object.metadata.labels[key]}
    missing := required - provided
    count(missing) > 0
    msg := sprintf("missing: %v", [missing])
}
"""
    cl = Backend(TorchDriver(device="cpu")).new_client(K8sValidationTarget())
    cl.add_template({
        "apiVersion": "templates.gatekeeper.sh/v1beta1",
        "kind": "ConstraintTemplate",
        "metadata": {"name": "schedlabels"},
        "spec": {
            "crd": {"spec": {"names": {"kind": "SchedLabels"}}},
            "targets": [{"target": TARGET, "rego": rego}],
        },
    })
    cl.add_constraint({
        "apiVersion": "constraints.gatekeeper.sh/v1beta1",
        "kind": "SchedLabels",
        "metadata": {"name": "need-owner"},
        "spec": {"parameters": {"labels": ["owner"]}},
    })
    return cl


def _request(i, ns, labels=None):
    obj = {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {
            "name": f"p{i}", "namespace": ns,
            **({"labels": labels} if labels else {}),
        },
        "spec": {"containers": [{"name": "c", "image": "nginx"}]},
    }
    return {
        "uid": f"uid-{i}",
        "kind": {"group": "", "version": "v1", "kind": "Pod"},
        "operation": "CREATE",
        "name": f"p{i}",
        "namespace": ns,
        "userInfo": {"username": "alice"},
        "object": obj,
    }


def test_predicted_miss_lands_in_decision_log_with_negative_slack():
    client = _ns_client()
    decisions = DecisionLog(allow_sample_n=0, max_per_s=0)
    batcher = MicroBatcher(
        client, TARGET, window_ms=5.0, max_queue=8,
        decisions=decisions, sched_policy="deadline",
        slo=FakeSlo(saturation=0.95),
    )
    batcher.sched.cost = BatchCostModel(per_row_fn=lambda: 10.0)
    handler = BatchedValidationHandler(
        batcher, request_timeout=0.5, fail_policy="open",
        decision_log=decisions,
    )
    resp = handler.handle(_request(0, "ns-pred"))
    assert resp.allowed
    recs = decisions.records(verdict="shed")
    assert len(recs) == 1
    rec = recs[0]
    assert rec["reason"] == "predicted_miss"
    assert rec["predicted_slack_ms"] < 0
    assert rec["tenant"]["namespace"] == "ns-pred"
    assert batcher.sched.snapshot()["sheds"]["predicted_miss"] == 1


def test_admitted_verdicts_identical_fifo_vs_deadline():
    def run(policy):
        batcher = MicroBatcher(
            _ns_client(), TARGET, window_ms=2.0, sched_policy=policy,
        )
        handler = BatchedValidationHandler(batcher, request_timeout=10)
        batcher.start()
        try:
            out = []
            for i in range(8):
                labels = {"owner": "x"} if i % 2 else None
                r = handler.handle(_request(i, f"ns{i % 3}", labels))
                out.append((r.allowed, r.code, r.message))
            return out
        finally:
            batcher.stop()

    assert run("fifo") == run("deadline")


def test_fused_batch_feeds_the_slo_cost_per_row():
    """A fused batch on TorchDriver feeds the SloEngine's device-seconds
    EWMA through the decision facts (TorchDriver's phase is "dispatch",
    the reference's "device_dispatch"), so the deadline scheduler
    predicts from the measured cost, not the cold-start 2e-4 s/row."""
    client = _ns_client()
    slo = SloEngine()
    decisions = DecisionLog(slo=slo, allow_sample_n=1, max_per_s=0)
    batcher = MicroBatcher(
        client, TARGET, window_ms=2.0, decisions=decisions,
        sched_policy="deadline", slo=slo, tracer=Tracer(),
    )
    handler = BatchedValidationHandler(
        batcher, request_timeout=10, decision_log=decisions,
        tracer=batcher.tracer,
    )
    assert slo.cost_per_row() is None
    batcher.start()
    try:
        resp = handler.handle(_request(0, "ns-a"))
    finally:
        batcher.stop()
    assert not resp.allowed and resp.code == 403
    dispatch_s = client._driver.stats["phase_seconds"]["dispatch"]
    assert slo.cost_per_row() == pytest.approx(dispatch_s, rel=1e-6)
    rec = decisions.records(verdict="deny")[0]
    assert rec["route"] == "fused"
    assert rec["device_seconds_share"] == pytest.approx(dispatch_s, rel=1e-6)
    assert rec["rows_total"] == 1
    snap = batcher.sched.snapshot()
    assert snap["cost_per_row_s"] == round(slo.cost_per_row(), 9)
    assert snap["cuts"] == 1 and snap["admitted"] == 1
