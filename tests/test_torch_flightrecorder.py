"""The port's flight recorder (gatekeeper_tpu_torch/obs/flightrecorder.py)
and its wiring, on the CPU, against the JAX package's.

Ports the recorder cases of tests/test_attribution.py (contents and
sources, debounce and rate limit, bounds in memory and on disk),
test_chaos.py (a device fault trips exactly one record),
test_integrity.py (one record per shadow-divergence burst),
test_decisionlog.py (the record names the trigger window's decisions)
and test_compile_plane.py (compile_storm); then the Runner's wiring
(/debug/flightrecords, the /readyz headline, GATEKEEPER_TPU_FLIGHT_DIR)
and a parity case: one trigger sequence under a fake clock gives the
same records and suppressed counts in both packages.
"""

import json
import os
import time
import urllib.request
from concurrent.futures import Future

import pytest

from gatekeeper_tpu.obs import FlightRecorder as JFlightRecorder
from gatekeeper_tpu_torch.constraint import Backend, K8sValidationTarget
from gatekeeper_tpu_torch.constraint.torchdriver import TorchDriver
from gatekeeper_tpu_torch.faults import CLOSED, FAULTS, OPEN, device_point
from gatekeeper_tpu_torch.metrics import MetricsRegistry, serve_metrics
from gatekeeper_tpu_torch.obs import (
    CostAttributor,
    DecisionLog,
    FlightRecorder,
    Tracer,
)
from gatekeeper_tpu_torch.parallel.partition import PartitionDispatcher
from gatekeeper_tpu_torch.webhook.server import (
    BatchedValidationHandler,
    MicroBatcher,
)

TARGET = "admission.k8s.gatekeeper.sh"
NAMESPACES = ["ns-a", "ns-b", "ns-c", "ns-d"]

REQ_LABELS = """package reqlabels

violation[{"msg": msg}] {
    required := {key | key := input.parameters.labels[_]}
    provided := {key | input.review.object.metadata.labels[key]}
    missing := required - provided
    count(missing) > 0
    msg := sprintf("missing: %v", [missing])
}
"""


@pytest.fixture(autouse=True)
def _clean_faults():
    FAULTS.reset()
    yield
    FAULTS.reset()


def _wait(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.01)
    return pred()


def _get(port, path):
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}{path}", timeout=10
    ) as r:
        return json.loads(r.read())


# ---------------------------------------------------------------------------
# the recorder itself (tests/test_attribution.py)


def test_capture_contents_and_sources():
    tracer = Tracer()
    with tracer.start_span("unavailable_subset", plane="validation"):
        pass
    attributor = CostAttributor()
    attributor.note_dispatch([("K", "a", 1.0)], 0.02)
    rec = FlightRecorder(
        tracer=tracer, attributor=attributor, replica="r0",
        min_interval_s=0.0, debounce_s=0.0,
    )
    rec.add_source("queue", lambda: {"depth": 7})
    rec.add_source("broken", lambda: (_ for _ in ()).throw(ValueError("x")))
    FAULTS.arm("driver.device_dispatch", "error", count=2)
    try:
        rec.trigger("breaker_open", breaker="device:validation:1",
                    from_state="closed", to_state="open")
        assert _wait(lambda: rec.records())
        (record,) = rec.records()
        assert record["trigger"] == "breaker_open"
        assert record["replica"] == "r0"
        assert record["triggers"][0]["context"]["breaker"] == (
            "device:validation:1")
        assert any(s["name"] == "unavailable_subset"
                   for t in record["trace_tail"] for s in t["spans"])
        assert record["costs"]["rows"][0]["kind"] == "K"
        assert record["state"]["queue"] == {"depth": 7}
        assert "error" in record["state"]["broken"]
        # the port's fault registry: its armed points are in the record
        assert "driver.device_dispatch" in record["faults"]
    finally:
        rec.stop()


def test_debounce_coalesces_and_rate_limits():
    rec = FlightRecorder(min_interval_s=60.0, debounce_s=0.1)
    try:
        for i in range(5):
            rec.trigger("breaker_open", n=i)
        assert _wait(lambda: rec.captured)
        assert rec.captured == 1
        (record,) = rec.records()
        assert len(record["triggers"]) == 5
        rec.trigger("breaker_open", n=99)
        rec.flush()
        time.sleep(0.3)
        assert rec.captured == 1 and rec.suppressed >= 1
    finally:
        rec.stop()


def test_bounded_in_memory_and_on_disk(tmp_path):
    d = str(tmp_path / "flight")
    rec = FlightRecorder(dir=d, min_interval_s=0.0, debounce_s=0.0,
                         max_records=16)
    try:
        for i in range(25):
            rec.trigger("unit_test", i=i)
            assert _wait(lambda: rec.captured > i)
        assert rec.captured == 25
        records = rec.records()
        assert len(records) == 16
        assert records[0]["triggers"][0]["context"]["i"] == 24
        files = [f for f in os.listdir(d) if f.endswith(".json")]
        assert len(files) == 16
        with open(os.path.join(d, sorted(files)[-1])) as f:
            assert json.load(f)["trigger"] == "unit_test"
    finally:
        rec.stop()


def test_flight_dir_from_the_environment(tmp_path, monkeypatch):
    d = str(tmp_path / "env-flight")
    monkeypatch.setenv("GATEKEEPER_TPU_FLIGHT_DIR", d)
    rec = FlightRecorder(min_interval_s=0.0, debounce_s=0.0)
    try:
        assert rec.dir == d
        rec.trigger("unit_test")
        assert _wait(lambda: rec.captured)
        assert _wait(lambda: os.path.isdir(d) and os.listdir(d))
        assert os.listdir(d) == ["flightrecord-fr-00001.json"]
    finally:
        rec.stop()


def test_serve_metrics_serves_flightrecords():
    rec = FlightRecorder(min_interval_s=0.0, debounce_s=0.0)
    httpd = serve_metrics(MetricsRegistry(), recorder=rec)
    try:
        rec.trigger("unit_test")
        assert _wait(lambda: rec.captured)
        doc = _get(httpd.server_address[1], "/debug/flightrecords")
        assert doc["records"][0]["trigger"] == "unit_test"
        assert doc["max_records"] == 16 and doc["captured"] == 1
    finally:
        httpd.shutdown()
        rec.stop()


def test_shed_burst_from_the_batcher():
    """MicroBatcher._shed feeds note_shed: crossing the threshold trips
    ONE shed_burst record for the storm."""
    client = Backend(TorchDriver(device="cpu")).new_client(
        K8sValidationTarget())
    rec = FlightRecorder(min_interval_s=60.0, debounce_s=0.05,
                         shed_burst_threshold=3)
    batcher = MicroBatcher(client, TARGET, recorder=rec)
    try:
        assert batcher.breaker.recorder is rec
        for _ in range(7):
            fut = Future()
            batcher._shed(fut, RuntimeError("shed"), "unit_test")
            assert fut.exception() is not None
        assert _wait(lambda: rec.captured)
        time.sleep(0.2)
        assert rec.captured == 1
        assert rec.records()[0]["trigger"] == "shed_burst"
        assert rec.records()[0]["triggers"][0]["context"]["plane"] == (
            "validation")
    finally:
        rec.stop()


# ---------------------------------------------------------------------------
# compile_storm (tests/test_compile_plane.py)


def test_compile_storm_fires_on_backlog_and_embeds_programs_source():
    rec = FlightRecorder(min_interval_s=0.0, debounce_s=0.0,
                         compile_storm_threshold=3)
    try:
        rec.add_source("programs", lambda: {"store": {"entries": 2}})
        rec.note_restage_failure(plane="validation", backlog=3)
        assert _wait(lambda: rec.records())
        record = rec.records()[-1]
        assert record["trigger"] == "compile_storm"
        ctx = record["triggers"][0]["context"]
        assert ctx["backlog"] == 3 and ctx["plane"] == "validation"
        assert record["state"]["programs"] == {"store": {"entries": 2}}
    finally:
        rec.stop()


def test_compile_storm_fires_on_restage_failure_burst():
    rec = FlightRecorder(min_interval_s=0.0, debounce_s=0.0,
                         compile_storm_threshold=3,
                         compile_storm_window_s=30.0)
    try:
        rec.note_restage_failure(backlog=0)
        rec.note_restage_failure(backlog=0)
        assert not rec.records()
        rec.note_restage_failure(backlog=0)
        assert _wait(lambda: rec.records())
        assert rec.records()[-1]["trigger"] == "compile_storm"
    finally:
        rec.stop()


# ---------------------------------------------------------------------------
# a device fault trips exactly one record (tests/test_chaos.py,
# tests/test_decisionlog.py)


def _ns_request(i, ns):
    return {
        "uid": f"u{i}",
        "kind": {"group": "", "version": "v1", "kind": "Pod"},
        "operation": "CREATE",
        "name": f"p{i}",
        "namespace": ns,
        "object": {
            "apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": f"p{i}", "namespace": ns},
            "spec": {"containers": [{"name": "c", "image": "nginx"}]},
        },
    }


def _ns_client(backend, target, driver):
    cl = backend(driver).new_client(target())
    for i, ns in enumerate(NAMESPACES):
        kind = f"Fault{chr(65 + i)}"
        cl.add_template({
            "apiVersion": "templates.gatekeeper.sh/v1beta1",
            "kind": "ConstraintTemplate",
            "metadata": {"name": kind.lower()},
            "spec": {
                "crd": {"spec": {"names": {"kind": kind}}},
                "targets": [{"target": TARGET, "rego": REQ_LABELS.replace(
                    "reqlabels", kind.lower())}],
            },
        })
        cl.add_constraint({
            "apiVersion": "constraints.gatekeeper.sh/v1beta1",
            "kind": kind,
            "metadata": {"name": f"need-owner-{ns}"},
            "spec": {"match": {"namespaces": [ns]},
                     "parameters": {"labels": ["owner"]}},
        })
    return cl


def _partitioned_trip(pkg):
    """4 kinds, one namespace each, over a 4-partition plan; device 1 is
    armed to fail, and two ns-b requests trip its breaker. Returns what
    the recorder and the decision log saw."""
    if pkg == "jax":
        from gatekeeper_tpu.constraint import Backend as B
        from gatekeeper_tpu.constraint import K8sValidationTarget as T
        from gatekeeper_tpu.constraint import TpuDriver
        from gatekeeper_tpu.faults import FAULTS as faults
        from gatekeeper_tpu.faults import device_point as dp
        from gatekeeper_tpu.metrics import MetricsRegistry as Reg
        from gatekeeper_tpu.metrics import serve_metrics as serve
        from gatekeeper_tpu.obs import DecisionLog as DL
        from gatekeeper_tpu.obs import Tracer as Tr
        from gatekeeper_tpu.parallel.partition import (
            PartitionDispatcher as PD,
        )
        from gatekeeper_tpu.webhook.server import (
            BatchedValidationHandler as BVH,
            MicroBatcher as MB,
        )

        Rec, driver = JFlightRecorder, TpuDriver(use_jax=False)
    else:
        B, T, faults, dp = Backend, K8sValidationTarget, FAULTS, device_point
        Reg, serve, DL, Tr = MetricsRegistry, serve_metrics, DecisionLog, Tracer
        PD, BVH, MB = PartitionDispatcher, BatchedValidationHandler, MicroBatcher
        Rec, driver = FlightRecorder, TorchDriver(device="cpu")
    client = _ns_client(B, T, driver)
    metrics, tracer = Reg(), Tr()
    decisions = DL(metrics=metrics, allow_sample_n=1, max_per_s=0)
    recorder = Rec(tracer=tracer, metrics=metrics, decisions=decisions,
                   min_interval_s=300.0, debounce_s=0.15, max_records=16)
    clock = [0.0]
    disp = PD(client, TARGET, k=4, metrics=metrics, tracer=tracer,
              failure_threshold=2, recovery_seconds=5.0,
              clock=lambda: clock[0], recorder=recorder)
    recorder.add_source("partitions", disp.postmortem)
    batcher = MB(client, TARGET, window_ms=1.0, metrics=metrics,
                 tracer=tracer, partitioner=disp, decisions=decisions)
    handler = BVH(batcher, request_timeout=5.0, metrics=metrics,
                  tracer=tracer, fail_policy="open", decision_log=decisions)
    batcher.start()
    httpd = serve(metrics, tracer=tracer, recorder=recorder,
                  decisions=decisions)
    out = {}
    try:
        for i, ns in enumerate(NAMESPACES):
            assert not handler.handle(_ns_request(i, ns)).allowed
        assert recorder.records() == []
        faults.arm(dp("driver.device_dispatch", 1), mode="error")
        out["answers"] = [handler.handle(_ns_request(30 + i, "ns-b"))
                          for i in range(2)]
        assert disp.breaker(1).state == OPEN
        assert _wait(lambda: recorder.records())
        # traffic after the trip mints no more records
        handler.handle(_ns_request(40, "ns-b"))
        recorder.flush()
        time.sleep(0.3)
        out["records"] = recorder.records()
        out["http"] = _get(httpd.server_address[1], "/debug/flightrecords")
        out["by_trace"] = {
            d["trace_id"]: _get(httpd.server_address[1],
                                f"/debug/decisions?trace_id={d['trace_id']}")
            for r in out["records"] for d in r.get("decisions") or []
            if d.get("trace_id")
        }
        out["tracer"] = tracer
        out["counters"] = metrics.snapshot()["counters"]
    finally:
        faults.reset()
        batcher.stop()
        disp.close()
        recorder.stop()
        httpd.shutdown()
    return out


def _shape(record):
    ctx = record["triggers"][0]["context"]
    part = record["state"]["partitions"]
    return (record["trigger"], len(record["triggers"]), ctx["breaker"],
            ctx["from_state"], ctx["to_state"], part["quarantined"],
            part["quarantined_constraint_keys"])


def test_device_fault_trips_exactly_one_record_as_jax():
    """A device fault that opens `device:validation:1` leaves exactly ONE
    record: the breaker transition, the quarantined partition's
    constraint keys and the unavailable requests' traces, retrievable at
    /debug/flightrecords; the JAX package's stack records the same."""
    got = _partitioned_trip("torch")
    ref = _partitioned_trip("jax")
    (record,) = got["records"]
    assert _shape(record) == (
        "breaker_open", 1, "device:validation:1", CLOSED, OPEN, [1],
        ["FaultB/need-owner-ns-b"])
    assert [_shape(r) for r in got["records"]] == [
        _shape(r) for r in ref["records"]]
    # the port answers the failed partition with the fail policy
    assert all(a.allowed for a in got["answers"])
    unavailable = [t for t in record["trace_tail"] if any(
        s["name"] == "unavailable_subset" for s in t["spans"])]
    assert unavailable
    assert got["http"]["max_records"] == 16
    assert [r["id"] for r in got["http"]["records"]] == [record["id"]]
    assert got["counters"][
        'flight_records_total{trigger="breaker_open"}'] == 1


def test_record_names_the_window_decisions_retrievable_by_trace_id():
    """The record's `decisions` section names the trigger window's failed
    requests (the port's route: "unavailable"); each retrieves at
    /debug/decisions by its trace id and its trace carries the
    unavailable span."""
    got = _partitioned_trip("torch")
    (record,) = got["records"]
    linked = [d for d in record.get("decisions") or []
              if d.get("route") == "unavailable"]
    assert linked, record.get("decisions")
    tid = linked[0]["trace_id"]
    doc = got["by_trace"][tid]
    assert len(doc["decisions"]) == 1
    assert doc["decisions"][0]["id"] == linked[0]["id"]
    assert doc["decisions"][0]["route"] == "unavailable"
    assert any(d.get("trace_id") == tid
               for r in got["http"]["records"] for d in r["decisions"])
    trace = got["tracer"].get(tid)
    assert any(s["name"] == "unavailable_subset" for s in trace["spans"])


# ---------------------------------------------------------------------------
# one record per shadow-divergence burst (tests/test_integrity.py)


def test_shadow_divergence_burst_leaves_one_record():
    from test_torch_integrity import (
        _batch,
        _client,
        _process_plane,
        _wait_shadow,
    )
    from gatekeeper_tpu_torch.constraint import (
        Backend as TBackend,
        K8sValidationTarget as TTarget,
    )

    drv = TorchDriver(device="cpu")
    client = _client(TBackend, TTarget, drv)
    objs = _batch(5, 8)
    results = [r.by_target[TARGET].results
               for r in client.review_many(objs)]
    wrong = [i for i, rs in enumerate(results) if rs]
    assert len(wrong) >= 2
    decisions = DecisionLog()
    recorder = FlightRecorder(decisions=decisions, debounce_s=0.05,
                              min_interval_s=60.0)
    plane = _process_plane(client, drv, decisions=decisions,
                           recorder=recorder)
    try:
        for i in wrong:  # every sampled admission dropped its violations
            assert plane.note_live(f"t-{i}", objs[i], [])
        snap = _wait_shadow(plane,
                            lambda s: s["divergences"] == len(wrong))
        assert snap["divergences"] == len(wrong)
        assert len(decisions.records(verdict="verdict_divergence",
                                     limit=100)) == len(wrong)
        assert _wait(lambda: recorder.records())
        recorder.flush()
        time.sleep(0.2)
        records = [r for r in recorder.records() if any(
            t.get("reason") == "verdict_divergence" for t in r["triggers"])]
        assert len(records) == 1, records
    finally:
        plane.close()
        recorder.stop()


# ---------------------------------------------------------------------------
# parity under a fake clock


def _fake_clock_sequence(cls):
    """One trigger sequence against a recorder whose clock is a list the
    test moves; each step waits until its triggers are accounted for
    (captured into a record or suppressed) before the next."""
    now = [0.0]
    rec = cls(min_interval_s=5.0, debounce_s=0.0, shed_burst_threshold=3,
              shed_burst_window_s=1.0, compile_storm_threshold=2,
              compile_storm_window_s=10.0, clock=lambda: now[0])
    fired = [0]
    trigger = rec.trigger

    def counting(reason, **ctx):
        fired[0] += 1
        trigger(reason, **ctx)

    rec.trigger = counting
    steps = [
        (0.0, lambda: rec.trigger("breaker_open", breaker="device:a")),
        (1.0, lambda: rec.trigger("device_quarantine", device=1)),
        (2.0, lambda: rec.note_shed("validation")),
        (2.5, lambda: rec.note_shed("validation")),
        (10.0, lambda: rec.note_shed("mutation")),
        (10.2, lambda: rec.note_shed("mutation")),
        (10.4, lambda: rec.note_shed("mutation")),
        (12.0, lambda: rec.note_restage_failure(backlog=0)),
        (20.0, lambda: rec.note_restage_failure(backlog=0)),
        (20.5, lambda: rec.note_restage_failure(backlog=0)),
        (21.0, lambda: rec.trigger("slo_breach", plane="validation")),
        (30.0, lambda: rec.note_restage_failure(backlog=9)),
    ]

    def accounted():
        return sum(len(r["triggers"]) for r in rec.records()) \
            + rec.suppressed

    try:
        for t, step in steps:
            now[0] = t
            step()
            assert _wait(lambda: accounted() == fired[0])
        return {
            "records": [
                (r["trigger"], [(x["reason"], x["t_monotonic"],
                                 x["context"]) for x in r["triggers"]])
                for r in reversed(rec.records())
            ],
            "captured": rec.captured,
            "suppressed": rec.suppressed,
            "snapshot": rec.snapshot(),
        }
    finally:
        rec.stop()


def test_fake_clock_sequence_equals_jax():
    got = _fake_clock_sequence(FlightRecorder)
    assert got == _fake_clock_sequence(JFlightRecorder)
    assert [r[0] for r in got["records"]] == [
        "breaker_open", "shed_burst", "compile_storm", "compile_storm"]
    assert got["suppressed"] == 2


# ---------------------------------------------------------------------------
# the Runner's wiring


def test_runner_records_a_breaker_trip_and_serves_it(tmp_path,
                                                     monkeypatch):
    """The Runner builds the recorder, hands it to the webhook's breaker
    and registers its state sources: three failed admission batches open
    the breaker and leave one record on /debug/flightrecords and on disk,
    with the armed fault points, the webhook source's open breaker and
    the /readyz headline; a clean boot records nothing."""
    from test_torch_control import (
        _readyz,
        config,
        constraint,
        make_runner,
        pod,
        template,
    )
    from gatekeeper_tpu_torch.control import FakeCluster

    monkeypatch.setenv("GATEKEEPER_TPU_FLIGHT_DIR", str(tmp_path / "fr"))
    cluster = FakeCluster()
    cluster.apply(template("K8sRequiredLabels", REQ_LABELS))
    cluster.apply(constraint("K8sRequiredLabels", "need-owner",
                             params={"labels": ["owner"]}))
    cluster.apply(config())
    cluster.apply(pod("good", labels={"owner": "me"}))
    runner = make_runner(cluster, readyz_port=0, webhook_port=0)
    try:
        runner.start()
        assert runner.wait_ready(30), runner.tracker.stats()
        port = runner.readyz_port
        assert _get(port, "/debug/flightrecords")["records"] == []
        assert runner.webhook.batcher.breaker.recorder is runner.recorder
        assert runner.slo.recorder is runner.recorder
        assert runner.integrity.recorder is runner.recorder
        FAULTS.arm("driver.device_dispatch", "error")
        url = f"http://127.0.0.1:{runner.webhook.port}/v1/admit"
        for i in range(4):
            body = json.dumps({
                "apiVersion": "admission.k8s.io/v1",
                "kind": "AdmissionReview",
                "request": _ns_request(i, "default")}).encode()
            req = urllib.request.Request(
                url, data=body, headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as r:
                json.loads(r.read())
        assert runner.webhook.batcher.breaker.state == OPEN
        assert _wait(lambda: runner.recorder.captured == 1)
        time.sleep(0.4)
        doc = _get(port, "/debug/flightrecords")
        (record,) = doc["records"]
        assert record["trigger"] == "breaker_open"
        assert "driver.device_dispatch" in record["faults"]
        assert record["state"]["webhook"]["breaker"]["state"] == OPEN
        assert "fleet" not in record["state"] or record["state"]["fleet"]
        assert "costs" in record and "trace_tail" in record
        code, body = _readyz(port)
        assert code == 200
        assert body["stats"]["obs"]["flightrecords"] == {
            "captured": 1, "suppressed": 0, "retained": 1}
        assert os.listdir(tmp_path / "fr") == [
            f"flightrecord-{record['id']}.json"]
    finally:
        FAULTS.reset()
        runner.stop()
    assert runner.recorder._stop.is_set()
