"""The port's decision log and live SLO engine (gatekeeper_tpu_torch/obs
decisionlog.py and slo.py) on the CPU: the cases of tests/test_slo.py and
tests/test_decisionlog.py that need no Runner, mutation plane or
partitions, on the port's classes and its MicroBatcher over
TorchDriver(device="cpu"); and seeded observations under an injected clock
fed to both packages' SloEngine (directly and through DecisionLog), giving
equal autoscaler() documents and snapshots."""

import json
import math
import random

import pytest

from gatekeeper_tpu.obs import (
    DecisionLog as JDecisionLog,
    SloEngine as JSloEngine,
    SloTarget as JSloTarget,
)
from gatekeeper_tpu_torch.constraint import Backend, K8sValidationTarget
from gatekeeper_tpu_torch.constraint.torchdriver import TorchDriver
from gatekeeper_tpu_torch.faults import FAULTS
from gatekeeper_tpu_torch.metrics import MetricsRegistry
from gatekeeper_tpu_torch.obs import (
    DECISION_SCHEMA_FIELDS,
    DecisionLog,
    QuantileSketch,
    SloEngine,
    SloTarget,
    Tracer,
    check_decision_schema,
)
from gatekeeper_tpu_torch.obs.slo import export_slo
from gatekeeper_tpu_torch.webhook.server import (
    BatchedValidationHandler,
    MicroBatcher,
    WebhookServer,
)

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

NAMESPACES = ["ns-a", "ns-b", "ns-c", "ns-d"]


@pytest.fixture(autouse=True)
def _clean_faults():
    FAULTS.reset()
    yield
    FAULTS.reset()


def counter(metrics, name, **tags):
    snap = metrics.snapshot()["counters"]
    total = 0
    for key, v in snap.items():
        if not key.startswith(name):
            continue
        if all(f'{k}="{val}"' in key for k, val in tags.items()):
            total += v
    return total


def build_ns_client():
    """4 constraint kinds, each matching exactly one namespace."""
    cl = Backend(TorchDriver(device="cpu")).new_client(K8sValidationTarget())
    for i, ns in enumerate(NAMESPACES):
        kind = f"Dec{chr(65 + i)}"
        cl.add_template({
            "apiVersion": "templates.gatekeeper.sh/v1beta1",
            "kind": "ConstraintTemplate",
            "metadata": {"name": kind.lower()},
            "spec": {
                "crd": {"spec": {"names": {"kind": kind}}},
                "targets": [{
                    "target": TARGET,
                    "rego": REQ_LABELS.replace("reqlabels", kind.lower()),
                }],
            },
        })
        cl.add_constraint({
            "apiVersion": "constraints.gatekeeper.sh/v1beta1",
            "kind": kind,
            "metadata": {"name": f"need-owner-{ns}"},
            "spec": {
                "match": {"namespaces": [ns]},
                "parameters": {"labels": ["owner"]},
            },
        })
    return cl


def ns_request(i, ns, labels=None):
    obj = {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {
            "name": f"p{i}",
            "namespace": ns,
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


# ---------------------------------------------------------------------------
# helpers


class FakeClock:
    def __init__(self, t: float = 10_000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class RecorderStub:
    def __init__(self):
        self.trips = []

    def trigger(self, reason, **ctx):
        self.trips.append((reason, ctx))


class MetricsStub:
    def __init__(self):
        self.gauges = []

    def gauge(self, name, value, **tags):
        self.gauges.append((name, value, tags))

    def record(self, *a, **k):
        pass

    def observe(self, *a, **k):
        pass


def engine(clock=None, recorder=None, metrics=None, **target_kw):
    target_kw.setdefault("objective", 0.9)
    target_kw.setdefault("min_samples", 10)
    return SloEngine(
        target=SloTarget(**target_kw),
        metrics=metrics,
        recorder=recorder,
        replica="t",
        clock=clock or FakeClock(),
    )


# ---------------------------------------------------------------------------
# quantile sketch: bounded relative error on adversarial distributions


def _exact(vals, q):
    s = sorted(vals)
    return s[int(q * (len(s) - 1))]


# relative-error contract: geometric midpoint of a GROWTH=1.25 bucket
# is within sqrt(1.25) - 1 (~11.8%) of any value in the bucket
_REL_BOUND = math.sqrt(QuantileSketch.GROWTH) - 1 + 1e-9


def _adversarial_distributions():
    rng = random.Random(170817)
    return {
        "lognormal": [rng.lognormvariate(-3.0, 1.0) for _ in range(5000)],
        # two modes three decades apart: a sketch tuned to one mode's
        # scale must not smear the other
        "bimodal": [
            (5e-4 if rng.random() < 0.5 else 2.0)
            * rng.uniform(0.9, 1.1)
            for _ in range(4000)
        ],
        # heavy tail: p99 lives far from the body
        "pareto": [1e-3 * rng.paretovariate(1.5) for _ in range(4000)],
        "uniform_wide": [rng.uniform(1e-4, 10.0) for _ in range(4000)],
        "constant": [0.05] * 1000,
    }


def test_sketch_bounded_relative_error_adversarial():
    for name, vals in _adversarial_distributions().items():
        sk = QuantileSketch()
        for v in vals:
            sk.add(v)
        assert sk.n == len(vals)
        for q in (0.5, 0.9, 0.99):
            exact = _exact(vals, q)
            est = sk.quantile(q)
            if exact <= QuantileSketch.BASE:
                # sub-resolution values report BASE (absolute error
                # <= 100 us), not a relative guarantee
                assert est == QuantileSketch.BASE
                continue
            rel = abs(est - exact) / exact
            assert rel <= _REL_BOUND, (name, q, exact, est, rel)


def test_sketch_merge_equals_single_sketch():
    """Mergeability is why this sketch over P2: per-window sketches
    summed into a horizon quantile must equal one big sketch."""
    rng = random.Random(7)
    vals = [rng.lognormvariate(-2.0, 1.5) for _ in range(2000)]
    whole = QuantileSketch()
    a, b = QuantileSketch(), QuantileSketch()
    for i, v in enumerate(vals):
        whole.add(v)
        (a if i % 2 else b).add(v)
    merged = QuantileSketch().merge(a).merge(b)
    assert merged.n == whole.n
    for q in (0.1, 0.5, 0.9, 0.99):
        assert merged.quantile(q) == whole.quantile(q)


def test_sketch_empty_and_clamp():
    sk = QuantileSketch()
    assert sk.quantile(0.5) is None
    sk.add(1e9)  # far above the top edge: clamps, never raises
    assert sk.quantile(0.5) <= QuantileSketch.BASE * (
        QuantileSketch.GROWTH ** QuantileSketch.NBUCKETS
    )


# ---------------------------------------------------------------------------
# SloTarget: the shared objective definition


def test_slo_target_rejects_unknown_keys_and_bad_shapes():
    with pytest.raises(ValueError, match="unknown SloTarget keys"):
        SloTarget.from_dict({"objectve": 0.99})
    with pytest.raises(ValueError):
        SloTarget.from_dict({"objective": 1.5})
    with pytest.raises(ValueError):
        SloTarget.from_dict({"fast_window_s": 60.0, "slow_window_s": 30.0})
    with pytest.raises(ValueError):
        SloTarget.from_dict({"burn_threshold": 2.0, "clear_threshold": 3.0})
    with pytest.raises(ValueError):
        SloTarget.from_dict({"degraded_below": 0.99, "recovered_at": 0.9})


def test_slo_target_defaults_merge_and_roundtrip():
    # harness default: the scenario's deadline contract seeds the
    # target unless the scenario's slo dict overrides it
    t = SloTarget.from_dict({}, deadline_s=0.5)
    assert t.deadline_s == 0.5
    t = SloTarget.from_dict({"deadline_s": 1.0}, deadline_s=0.5)
    assert t.deadline_s == 1.0
    t = SloTarget.from_dict(None)
    assert t.objective == 0.99
    assert SloTarget.from_dict(t.to_dict()) == t
    assert abs(SloTarget(objective=0.9).error_budget - 0.1) < 1e-12


# ---------------------------------------------------------------------------
# burn-rate window arithmetic (injected clocks, no sleeps)


def test_burn_rate_arithmetic_and_window_aging():
    clk = FakeClock()
    e = engine(clock=clk)  # objective 0.9 -> budget 0.1
    for _ in range(16):
        e.observe("validation", ok=True, duration_s=0.01)
    for _ in range(4):
        e.observe("validation", ok=False, duration_s=0.2)
    p = e.snapshot()["planes"]["validation"]
    assert p["attainment_fast"] == 0.8
    assert p["burn_rate_fast"] == 2.0  # (4/20) / 0.1
    assert p["requests_fast"] == 20 and p["misses_fast"] == 4

    # past the fast horizon the fast window is empty but the slow
    # window still remembers the same 20 decisions
    clk.advance(66.0)
    p = e.snapshot()["planes"]["validation"]
    assert p["requests_fast"] == 0 and p["attainment_fast"] is None
    assert p["burn_rate_fast"] == 0.0
    assert p["requests_slow"] == 20 and p["burn_rate_slow"] == 2.0

    # past the slow horizon everything ages out
    clk.advance(960.0)
    p = e.snapshot()["planes"]["validation"]
    assert p["requests_slow"] == 0 and p["attainment_slow"] is None


def test_shed_counts_against_budget_deny_does_not():
    e = engine()
    for _ in range(10):
        e.observe("validation", ok=True)          # deny IS ok
    for _ in range(10):
        e.observe("validation", ok=False, shed=True)
    p = e.snapshot()["planes"]["validation"]
    assert p["attainment_fast"] == 0.5
    assert p["sheds_fast"] == 10 and p["misses_fast"] == 0
    assert p["burn_rate_fast"] == 5.0  # (10/20) / 0.1


def test_min_samples_gate_an_empty_window_never_pages():
    rec = RecorderStub()
    e = engine(recorder=rec, min_samples=10)
    for _ in range(9):  # 100% miss but below min_samples
        e.observe("validation", ok=False)
    assert rec.trips == [] and e.snapshot()["burning"] is False


# ---------------------------------------------------------------------------
# hysteresis: one trigger per entry, no flapping


def test_hysteresis_latches_once_and_does_not_flap():
    clk = FakeClock()
    rec = RecorderStub()
    e = engine(clock=clk, recorder=rec)
    # trip: 10 misses -> burn 10 >= 4 (slow confirming)
    for _ in range(10):
        e.observe("validation", ok=False)
    assert len(rec.trips) == 1
    reason, ctx = rec.trips[0]
    assert reason == "slo_breach" and ctx["plane"] == "validation"
    assert ctx["burn_rate_fast"] >= 4.0 and ctx["requests_fast"] == 10
    assert ctx["attainment_fast"] == 0.0 and ctx["misses_fast"] == 10
    # continued burning while latched: no second trigger
    for _ in range(20):
        e.observe("validation", ok=False)
    assert len(rec.trips) == 1 and e.snapshot()["burning"] is True
    # burn hugging the band between clear (1.0) and trip (4.0)
    # thresholds must not clear OR re-trip: age the storm out, then
    # 2 misses per 8 ok -> burn settles at 2.0 (misses first, so the
    # instantaneous burn never dips to the clear threshold)
    clk.advance(66.0)
    for _ in range(2):
        e.observe("validation", ok=False)
    for _ in range(8):
        e.observe("validation", ok=True)
    assert len(rec.trips) == 1
    assert e.snapshot()["planes"]["validation"]["burning"] is True
    # clear: a clean fast window drops burn below clear_threshold
    clk.advance(66.0)
    e.observe("validation", ok=True)
    assert e.snapshot()["burning"] is False
    # a second full breach fires a SECOND record (fresh window; the
    # slow window still confirms from history)
    clk.advance(66.0)
    for _ in range(10):
        e.observe("validation", ok=False)
    assert len(rec.trips) == 2
    assert e.breaches == 2


def test_planes_burn_independently():
    rec = RecorderStub()
    e = engine(recorder=rec)
    for _ in range(10):
        e.observe("mutation", ok=False)
    for _ in range(10):
        e.observe("validation", ok=True)
    assert [r[1]["plane"] for r in rec.trips] == ["mutation"]
    snap = e.snapshot()
    assert snap["planes"]["mutation"]["burning"] is True
    assert snap["planes"]["validation"]["burning"] is False
    assert snap["burning"] is True  # any plane burning


# ---------------------------------------------------------------------------
# tenant rings: cardinality capped, overflow counted


def test_tenant_rings_capped_with_overflow_counter():
    e = SloEngine(
        target=SloTarget(objective=0.9, min_samples=10),
        replica="t", max_tenants=2, clock=FakeClock(),
    )
    for ns in ("ns-a", "ns-b", "ns-c", "ns-d"):
        for _ in range(3):
            e.observe("validation", ok=True, tenant={"namespace": ns})
    snap = e.snapshot()
    assert set(snap["tenants"]) == {"validation/ns-a", "validation/ns-b"}
    assert snap["tenants"]["validation/ns-a"]["requests_fast"] == 3
    assert snap["tenant_overflow"] == 6  # 2 tenants x 3 observes
    # tenant-less and empty tenants don't occupy a slot
    e.observe("validation", ok=True, tenant=None)
    e.observe("validation", ok=True, tenant={"namespace": ""})
    assert len(e.snapshot()["tenants"]) == 2


# ---------------------------------------------------------------------------
# saturation / headroom


def test_saturation_combines_cost_demand_and_overload():
    clk = FakeClock()
    e = engine(clock=clk, fast_window_s=10.0)
    # pure overload: no cost model yet, 5 of 20 shed -> 0.25
    for _ in range(15):
        e.observe("validation", ok=True)
    for _ in range(5):
        e.observe("validation", ok=False, shed=True)
    util = e.snapshot()["utilization"]
    assert util["saturation"] == 0.25
    assert util["estimated_headroom_rps"] is None  # no cost samples
    # cost EWMA x arrival adds the demand term and unlocks headroom
    e.note_cost(0.02, rows=1)  # 20 ms/row -> capacity 50 rps
    clk.advance(10.0)  # fresh window
    e.reset_windows()
    for _ in range(10):
        e.observe("validation", ok=True)
    util = e.snapshot()["utilization"]
    assert util["estimated_capacity_rps"] == 50.0
    assert util["device_seconds_per_row_ewma"] == 0.02
    assert 0.0 < util["saturation"] <= 1.0
    assert util["estimated_headroom_rps"] is not None
    # autoscaler block carries the contract fields
    a = e.autoscaler()
    for k in ("saturation", "burning", "estimated_headroom_rps",
              "arrival_rps", "attainment", "objective", "breaches"):
        assert k in a
    assert a["burning"] is False and a["attainment"] == 1.0


def test_reset_windows_keeps_cost_ewma_and_breaches():
    rec = RecorderStub()
    e = engine(recorder=rec)
    e.note_cost(0.01)
    for _ in range(10):
        e.observe("validation", ok=False)
    assert e.breaches == 1
    e.reset_windows()
    snap = e.snapshot()
    assert snap["planes"] == {} and snap["observed"] == 0
    assert snap["breaches"] == 1
    assert snap["utilization"]["device_seconds_per_row_ewma"] == 0.01


# ---------------------------------------------------------------------------
# gauge export: debounced to fast-window slot rolls


def test_gauge_export_debounced_to_slot_rolls():
    clk = FakeClock()
    m = MetricsStub()
    e = engine(clock=clk, metrics=m, fast_window_s=60.0)
    e.observe("validation", ok=True)
    first = len(m.gauges)
    assert first > 0
    names = {g[0] for g in m.gauges}
    assert {"slo_attainment", "slo_burn_rate",
            "slo_error_budget_remaining", "slo_saturation"} <= names
    # same slot: a request storm exports nothing new
    for _ in range(50):
        e.observe("validation", ok=True)
    assert len(m.gauges) == first
    # next slot (fast_window/12): one more export
    clk.advance(60.0 / 12 + 0.01)
    e.observe("validation", ok=True, tenant={"namespace": "ns-a"})
    assert len(m.gauges) > first
    clk.advance(60.0 / 12 + 0.01)
    e.observe("validation", ok=True, tenant={"namespace": "ns-a"})
    tenant_rows = [g for g in m.gauges if g[0] == "slo_tenant_attainment"]
    assert tenant_rows and tenant_rows[-1][2] == {
        "plane": "validation", "tenant": "ns-a",
    }


# ---------------------------------------------------------------------------
# /debug/slo renderer


def test_export_slo_filters():
    e = engine()
    e.observe("validation", ok=True, tenant={"namespace": "ns-a"})
    e.observe("mutation", ok=True, tenant={"namespace": "ns-b"})
    full = json.loads(export_slo(e))
    assert set(full["planes"]) == {"validation", "mutation"}
    assert set(full["tenants"]) == {"validation/ns-a", "mutation/ns-b"}
    only_v = json.loads(export_slo(e, "/debug/slo?plane=validation"))
    assert set(only_v["planes"]) == {"validation"}
    assert set(only_v["tenants"]) == {"validation/ns-a"}
    no_t = json.loads(export_slo(e, "/debug/slo?tenants=0"))
    assert "tenants" not in no_t


# ---------------------------------------------------------------------------
# the decision-log seam


def test_decision_log_seam_feeds_engine_before_sampling():
    from gatekeeper_tpu_torch.metrics import MetricsRegistry
    from gatekeeper_tpu_torch.obs.decisionlog import DecisionLog

    reg = MetricsRegistry()
    log = DecisionLog(metrics=reg, replica="t", allow_sample_n=1000)
    e = engine()
    log.slo = e
    # plain allows the ring samples out still reach the estimator
    for i in range(40):
        log.record_decision(
            "validation", "allow", duration_ms=5.0,
            deadline_slack_ms=900.0,
            tenant={"namespace": "default"},
        )
    assert e.observed == 40
    p = e.snapshot()["planes"]["validation"]
    assert p["attainment_fast"] == 1.0
    # shed/unavailable verdicts count in the shed bucket; errors miss
    log.record_decision("validation", "unavailable")
    log.record_decision("validation", "error", duration_ms=1.0)
    p = e.snapshot()["planes"]["validation"]
    assert p["sheds_fast"] == 1 and p["misses_fast"] == 1
    # the slack histogram is stamped at the same seam
    text = reg.prometheus_text()
    assert "admission_deadline_slack_seconds" in text
    assert 'plane="validation"' in text


def test_decision_log_seam_judges_deadline_over_slack():
    from gatekeeper_tpu_torch.obs.decisionlog import DecisionLog

    log = DecisionLog(replica="t")
    e = engine(deadline_s=0.1)
    log.slo = e
    # within deadline: ok even with negative slack (the handler's
    # timeout is not the target's contract)
    log.record_decision(
        "validation", "deny", duration_ms=50.0, deadline_slack_ms=-1.0
    )
    # over deadline: a miss even though the verdict was produced
    log.record_decision(
        "validation", "deny", duration_ms=200.0, deadline_slack_ms=500.0
    )
    p = e.snapshot()["planes"]["validation"]
    assert p["requests_fast"] == 2
    assert p["misses_fast"] == 1 and p["attainment_fast"] == 0.5



# -- unit: schema, sampling, rate gate ---------------------------------------


def test_record_schema_contract_every_plane():
    """Every retained record carries the full DECISION_SCHEMA_FIELDS
    set, whatever plane wrote it."""
    log = DecisionLog(allow_sample_n=1)
    recs = [
        log.record_decision("validation", "deny", code=403, trace_id="a" * 32,
                   duration_ms=3.0,
                   violations=[{"constraint_name": "c0"}]),
        log.record_decision("mutation", "allow", trace_id="b" * 32,
                   duration_ms=1.0, mutation_status="mutated"),
        log.record_decision("agent", "deny", code=403, trace_id="c" * 32,
                   tenant={"agent": "planner-1", "session": "s-1"}),
        log.record_decision("audit", "deny", route="audit",
                   trace_id="d" * 32),
    ]
    for rec in recs:
        assert rec is not None
        assert check_decision_schema(rec) == [], rec
    # the agent record's tenant is the (agent, session) identity
    agent = log.records(plane="agent")[0]
    assert agent["tenant"] == {"agent": "planner-1", "session": "s-1"}
    assert set(DECISION_SCHEMA_FIELDS) <= set(recs[0].keys())


def test_allow_sampling_is_deterministic_by_trace_id():
    """Same trace-id universe + same rate -> the SAME kept subset in
    two independent logs (CRC-based, process-salt-free); the rate is
    approximately honored."""
    ids = [f"{i:032x}" for i in range(400)]
    kept = []
    for _ in range(2):
        log = DecisionLog(allow_sample_n=8, max_per_s=0)
        for tid in ids:
            log.record_decision("validation", "allow", trace_id=tid)
        kept.append({r["trace_id"] for r in log.records(limit=1000)})
    assert kept[0] == kept[1]
    assert 0 < len(kept[0]) < len(ids)
    # roughly 1-in-8 (binomial slack)
    assert len(ids) / 16 < len(kept[0]) < len(ids) / 3
    # sampled-out accounting
    log2 = DecisionLog(allow_sample_n=8, max_per_s=0)
    for tid in ids:
        log2.record_decision("validation", "allow", trace_id=tid)
    snap = log2.snapshot()
    assert snap["recorded"] + snap["sampled_out"] == len(ids)


def test_error_half_is_never_sampled_out():
    """Denials, sheds, unavailable, degraded/host routes, and the slow
    tail are ALWAYS retained — head sampling only touches plain fast
    allows."""
    log = DecisionLog(allow_sample_n=0, slow_ms=100.0, max_per_s=0)
    assert log.record_decision("validation", "allow", trace_id="1" * 32) is None
    assert log.record_decision("validation", "deny", trace_id="2" * 32)
    assert log.record_decision("validation", "shed", trace_id="3" * 32)
    assert log.record_decision("validation", "unavailable", trace_id="4" * 32)
    assert log.record_decision("validation", "allow", trace_id="5" * 32,
                      route="degraded")
    assert log.record_decision("validation", "allow", trace_id="6" * 32,
                      route="host")
    # slow tail: 150ms > slow_ms
    assert log.record_decision("validation", "allow", trace_id="7" * 32,
                      duration_ms=150.0)
    verdicts = [r["verdict"] for r in log.records(limit=100)]
    assert "allow" in verdicts and "deny" in verdicts
    assert log.snapshot()["recorded"] == 6


def test_rate_gate_bounds_ring_and_denial_log_appends():
    """A burst past the token bucket drops appends — counted in
    decisions_dropped_total — and the denial-log gate shares the same
    budget (the shed-burst containment satellite)."""
    metrics = MetricsRegistry()
    clock = [0.0]
    log = DecisionLog(
        metrics=metrics, allow_sample_n=1, max_per_s=10,
        clock=lambda: clock[0],
    )
    kept = sum(
        1
        for i in range(50)
        if log.record_decision("validation", "deny", trace_id=f"{i:032x}")
    )
    assert kept < 50
    snap = log.snapshot()
    assert snap["dropped"] == 50 - kept
    assert counter(
        metrics, "decisions_dropped_total", reason="rate_limited"
    ) == 50 - kept
    # the denial-log gate draws from the same (exhausted) bucket
    assert log.allow_denial_append() is False
    assert log.snapshot()["denial_log_dropped"] == 1
    assert counter(
        metrics, "decisions_dropped_total", reason="denial_log_rate"
    ) == 1
    # refill: time passes, appends flow again
    clock[0] = 10.0
    assert log.record_decision("validation", "deny", trace_id="f" * 32)
    assert log.allow_denial_append() is True


def test_ring_and_disk_spool_bounded(tmp_path):
    log = DecisionLog(
        max_records=8, allow_sample_n=1, max_per_s=0,
        dir=str(tmp_path),
    )
    for i in range(40):
        log.record_decision("validation", "deny", trace_id=f"{i:032x}")
    assert log.snapshot()["retained"] == 8
    rows = log.records(limit=100)
    assert len(rows) == 8
    assert rows[0]["trace_id"] == f"{39:032x}"  # newest first
    spool = (tmp_path / "decisions.ndjson").read_text().splitlines()
    # the spool rewrites from the bounded ring every max_records
    # appends, so it can never outgrow ~2x the ring
    assert len(spool) <= 2 * 8
    assert all(json.loads(line)["plane"] == "validation"
               for line in spool)


def test_note_dispatch_facts_merge_and_bound():
    """Facts stash: merge-on-repeat (validation + mutate facts on one
    trace), popped exactly once by record(), bounded."""
    log = DecisionLog(allow_sample_n=1, max_per_s=0)
    log.note_dispatch("t1", route="fused", rows_total=10)
    log.note_dispatch("t1", fixpoint_iterations=3)
    rec = log.record_decision("validation", "allow", trace_id="t1")
    assert rec["route"] == "fused"
    assert rec["rows_total"] == 10
    assert rec["fixpoint_iterations"] == 3
    # popped: a second record on the same trace carries no facts
    rec2 = log.record_decision("validation", "deny", trace_id="t1")
    assert rec2["route"] is None
    # bounded: orphans evict oldest-first
    for i in range(log._facts_max + 50):
        log.note_dispatch(f"orphan-{i}", route="fused")
    assert log.snapshot()["pending_facts"] <= log._facts_max


# -- handler-level verdicts for the overload path ----------------------------


def test_shed_decisions_recorded_with_typed_verdict():
    """A queue-full shed records verdict='shed' with the typed reason —
    the overload story is reconstructible from decisions alone."""
    from gatekeeper_tpu_torch.webhook import ValidationHandler

    client = build_ns_client()
    decisions = DecisionLog(allow_sample_n=0, max_per_s=0)
    batcher = MicroBatcher(
        client, TARGET, window_ms=5.0, max_queue=0,
        decisions=decisions,
    )
    handler = BatchedValidationHandler(
        batcher, request_timeout=1.0, fail_policy="open",
        decision_log=decisions,
    )
    # no batcher.start(): max_queue=0 sheds at submit
    resp = handler.handle(ns_request(0, "ns-a"))
    assert resp.allowed  # fail-open envelope
    recs = decisions.records(verdict="shed")
    assert len(recs) == 1
    assert recs[0]["reason"] == "queue_full"
    assert recs[0]["plane"] == "validation"

    # the serial (non-batched) handler records decisions too
    serial = ValidationHandler(
        client, TARGET, decision_log=decisions,
    )
    assert not serial.handle(ns_request(1, "ns-b")).allowed
    assert decisions.records(verdict="deny", plane="validation")


def test_shed_decisions_carry_tenant_for_exact_accounting():
    """The tenant identity is extracted BEFORE enqueue, so a queue-full
    shed record still names its tenant, and `tenant_stats()` counts the
    shed against that tenant exactly (the validation half of the
    reference case; the mutation plane is not ported)."""
    decisions = DecisionLog(allow_sample_n=0, max_per_s=0)
    batcher = MicroBatcher(
        build_ns_client(), TARGET, window_ms=5.0, max_queue=0,
        decisions=decisions,
    )
    handler = BatchedValidationHandler(
        batcher, request_timeout=1.0, fail_policy="open",
        decision_log=decisions,
    )
    assert handler.handle(ns_request(0, "ns-a")).allowed
    rec = decisions.records(verdict="shed", plane="validation")[0]
    assert rec["reason"] == "queue_full"
    assert rec["tenant"] == {"namespace": "ns-a", "username": "alice"}
    stats = decisions.tenant_stats()
    assert stats["validation/ns-a"]["shed"] == 1
    assert stats["validation/ns-a"]["count"] == 1
    assert stats["validation/ns-a"]["attainment"] == 0.0


def test_http_decision_record_matches_trace_spans():
    """POST /v1/admit on the port's WebhookServer with a decision log and
    a tracer: the record found by the envelope's traceId carries the
    verdict, violations, tenant, the fused route and the batch's device
    share, and the same trace holds the dispatch span; the HTTP front
    door stamps its decode route."""
    metrics = MetricsRegistry()
    tracer = Tracer()
    decisions = DecisionLog(
        metrics=metrics, replica="r0", allow_sample_n=1, max_per_s=0
    )
    srv = WebhookServer(
        build_ns_client(), TARGET, metrics=metrics, tracer=tracer,
        decision_log=decisions, log_denies=True,
    )
    srv.start()
    try:
        def post(i, ns, labels=None):
            import urllib.request

            body = json.dumps({
                "apiVersion": "admission.k8s.io/v1",
                "kind": "AdmissionReview",
                "request": ns_request(i, ns, labels=labels),
            }).encode()
            with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/v1/admit", body, timeout=60
            ) as resp:
                return json.loads(resp.read())

        deny = post(0, "ns-b")
        allow = post(1, "ns-a", labels={"owner": "x"})
    finally:
        srv.stop()
    assert deny["response"]["allowed"] is False
    assert allow["response"]["allowed"] is True
    (rec,) = decisions.records(trace_id=deny["traceId"])
    assert check_decision_schema(rec) == []
    assert rec["replica"] == "r0"
    assert rec["verdict"] == "deny" and rec["code"] == 403
    assert rec["violations"][0]["constraint_name"] == "need-owner-ns-b"
    assert rec["tenant"] == {"namespace": "ns-b", "username": "alice"}
    assert rec["route"] == "fused" and rec["decode_route"] == "legacy"
    assert rec["rows_total"] == 4 and rec["rows_dispatched"] == 4
    assert rec["device_seconds_share"] >= 0.0
    assert rec["deadline_slack_ms"] > 0
    spans = tracer.get(deny["traceId"])["spans"]
    dispatch = [s for s in spans if s["name"] == "dispatch"]
    assert dispatch and dispatch[0]["attrs"]["route"] == "batched"
    assert dispatch[0]["attrs"]["driver_route"] == "fused"
    # the driver's phases are read under the port's names
    assert {"flatten_encode", "device_dispatch"} <= {s["name"] for s in spans}
    assert counter(metrics, "decisions_recorded_total",
                   plane="validation", verdict="deny") == 1


# -- the same SLO documents as the JAX engine ---------------------------------


class _Clock:
    def __init__(self, t):
        self.t = t

    def __call__(self):
        return self.t


def _feed(engine_cls, target_cls, log_cls, seed):
    """Seeded decisions on an injected clock: observations straight into
    one SloEngine and the same stream through a DecisionLog into a second
    one; -> their autoscaler() and snapshot() documents along the way."""
    rng = random.Random(seed)
    clk = _Clock(5_000.0)
    target = target_cls(objective=0.95, min_samples=15, fast_window_s=30.0,
                        slow_window_s=300.0, deadline_s=0.25)
    direct = engine_cls(target=target, replica="r", max_tenants=5, clock=clk)
    seam = engine_cls(target=target, replica="r", max_tenants=5, clock=clk)
    log = log_cls(slo=seam, allow_sample_n=4, max_per_s=0, clock=clk)
    docs = []
    for step in range(600):
        clk.t += rng.expovariate(20.0) if rng.random() < 0.97 else 40.0
        plane = rng.choice(["validation", "validation", "label"])
        tenant = rng.choice([{"namespace": f"ns{rng.randrange(8)}"},
                             {"username": "u1"}, None])
        verdict = rng.choice(["allow", "deny", "shed", "error", "allow"])
        duration_ms = rng.lognormvariate(3.0, 1.5)
        slack_ms = rng.uniform(-100.0, 900.0)
        if rng.random() < 0.3:
            cost = rng.uniform(1e-5, 3e-3)
            direct.note_cost(cost)
            log.note_dispatch(f"t{step}", device_seconds_share=cost)
        shed = verdict == "shed"
        ok = not shed and verdict != "error" and duration_ms <= 250.0
        direct.observe(plane, ok, duration_s=duration_ms / 1e3, shed=shed,
                       tenant=tenant)
        log.record_decision(plane, verdict, trace_id=f"t{step}",
                            duration_ms=duration_ms,
                            deadline_slack_ms=slack_ms, tenant=tenant)
        if step % 97 == 0:
            docs.append((direct.autoscaler(), seam.autoscaler()))
    for eng in (direct, seam):
        docs.append((eng.autoscaler(), eng.snapshot(),
                     eng.overall_attainment("fast"), eng.cost_per_row()))
    docs.append((log.snapshot(), log.tenant_stats()))
    return docs


@pytest.mark.parametrize("seed", [3, 17, 2024])
def test_slo_documents_equal_the_jax_engine(seed):
    want = _feed(JSloEngine, JSloTarget, JDecisionLog, seed)
    got = _feed(SloEngine, SloTarget, DecisionLog, seed)
    assert got == want
    final = got[-3]
    assert final[1]["observed"] == 600
    assert final[3] is not None
