"""Verdict-integrity canaries on the port, on the CPU:

  * the canary reviews and their golden digests equal the JAX package's
    (`synth_reviews` + `result_digest` over the interpreter's verdicts)
    for the same constraints, the whole set's and a subset's;
  * canaries ride in a dispatch's padding slots and no canary reaches a
    result: review_many and review_many_subset answer as with no
    integrity plane, at a batch with free slots and at one whose bucket
    has none (no canary then);
  * a clean dispatch reports no mismatch, and the `integrity.canary`
    fault point counts one per batch, per device;
  * prepare_subset swaps a changed subset only after its golden replay:
    with `integrity.selftest` armed the swap is rejected and the old set
    keeps serving.
"""

import pytest

import chip_smoke
from gatekeeper_tpu.constraint import (
    Backend as JBackend,
    K8sValidationTarget as JTarget,
)
from gatekeeper_tpu.constraint.tpudriver import TpuDriver
from gatekeeper_tpu.integrity import IntegrityPlane as JIntegrityPlane
from gatekeeper_tpu.integrity import canary as jcanary
from gatekeeper_tpu_torch.constraint import (
    AugmentedUnstructured as TAug,
    Backend as TBackend,
    K8sValidationTarget as TTarget,
)
from gatekeeper_tpu_torch.constraint.torchdriver import TorchDriver
from gatekeeper_tpu_torch.faults import FAULTS
from gatekeeper_tpu_torch.integrity import IntegrityPlane
from gatekeeper_tpu_torch.integrity import canary as tcanary

TARGET = chip_smoke.TARGET
PATH = f'hooks["{TARGET}"].violation'


@pytest.fixture(autouse=True)
def _clean_faults():
    FAULTS.reset()
    yield
    FAULTS.reset()


def _client(backend, target, driver, n=16, joins=False):
    client = backend(driver).new_client(target())
    for t in chip_smoke.template_docs():
        client.add_template(t)
    for c in chip_smoke.constraint_docs(n):
        client.add_constraint(c)
    for i in range(20):
        client.add_data(chip_smoke.make_pod(i))
    if joins:
        for t in chip_smoke.uniqueness_templates():
            client.add_template(t)
        for c in chip_smoke.uniqueness_constraints():
            client.add_constraint(c)
        for i in range(60):
            client.add_data(chip_smoke.make_mixed(i))
    return client


def _batch(seed, size):
    out = []
    for j in range(size):
        pod = chip_smoke.make_pod(7 * j + seed, name=f"integ-{seed}-{j}")
        if j % 3 == 0:
            pod["metadata"]["labels"].pop("owner", None)
        out.append(TAug(pod))
    return out


def _keys(responses):
    return [[chip_smoke.result_key(r) for r in resp.by_target[TARGET].results]
            for resp in responses]


@pytest.mark.parametrize("which", ["whole", "subset", "joins"])
def test_golden_canaries_equal_reference(which):
    """Golden sets equal the JAX package's. A policy that reads no
    inventory derives them against an empty one, without freezing the
    synced objects; one with the uniqueness joins reads the inventory."""
    t_drv, j_drv = TorchDriver(device="cpu"), TpuDriver(use_jax=False)
    _client(TBackend, TTarget, t_drv, joins=which == "joins")
    _client(JBackend, JTarget, j_drv, joins=which == "joins")
    constraints = t_drv._constraints(TARGET)
    assert constraints == j_drv._constraints(TARGET)
    if which == "subset":
        constraints = constraints[1::3]
    elif which == "joins":
        constraints = [c for c in constraints if c["kind"].startswith(
            "K8sUnique")] + constraints[:2]
    sigkey = "sig"
    got = IntegrityPlane().golden_for(
        TARGET, sigkey, constraints, t_drv._interp_closure(TARGET, constraints)
    )
    want = JIntegrityPlane().golden_for(
        TARGET, sigkey, constraints, j_drv._interp_closure(TARGET, constraints)
    )
    assert got == want
    assert got["reviews"] == jcanary.synth_reviews(constraints)
    assert tcanary.synth_reviews(constraints) == got["reviews"]
    # the canaries have verdicts to corrupt
    assert len(set(got["digests"])) > 1
    assert got["digests"] == [
        jcanary.result_digest(
            j_drv._interp_closure(TARGET, constraints)(r)
        ) for r in got["reviews"]
    ]
    assert (TARGET in t_drv._frozen_inv) == (which == "joins")


# 24 reviews fill a 64-row bucket with 40 free slots; 64 leave none
@pytest.mark.parametrize("size", [24, 64])
def test_no_canary_reaches_a_result(size):
    drv = TorchDriver(device="cpu")
    client = _client(TBackend, TTarget, drv)
    keys = drv.constraint_keys(TARGET)
    subset = frozenset(keys[0::2])
    plain = _keys(client.review_many(_batch(size, size)))
    plain_sub = _keys(client.review_many_subset(_batch(size, size), subset))
    plane = IntegrityPlane()
    drv.set_integrity(plane)
    got = _keys(client.review_many(_batch(size, size)))
    n_whole = drv.stats["n_reviews"]
    got_sub = _keys(client.review_many_subset(_batch(size, size), subset))
    n_sub = drv.stats["n_reviews"]
    assert got == plain and got_sub == plain_sub
    assert sum(map(len, got)) > 0
    snap = plane.snapshot()["canary"]
    canaries = 0 if size == 64 else plane.k
    assert n_whole == n_sub == size + canaries
    assert snap["rows"] == 2 * canaries
    assert snap["batches"] == (0 if size == 64 else 2)
    assert snap["mismatch_batches"] == 0
    # every canary identity stays out of the answers
    assert not any("integrity-canary" in k[2] for rs in got for k in rs)


def test_canary_fault_counts_per_device():
    drv = TorchDriver(device="cpu")
    client = _client(TBackend, TTarget, drv)
    plane = IntegrityPlane(quarantine_threshold=2)
    drv.set_integrity(plane)
    subset = frozenset(drv.constraint_keys(TARGET)[0::2])
    FAULTS.arm("integrity.canary[device=3]", "error")
    client.review_many_subset(_batch(1, 24), subset, device=3)
    client.review_many_subset(_batch(2, 24), subset, device=3)
    client.review_many_subset(_batch(3, 24), subset, device=1)
    snap = plane.snapshot()
    assert snap["canary"]["mismatch_batches"] == 2
    assert snap["canary"]["per_device"] == {
        "3": {"mismatches": 2, "consecutive": 2}
    }
    assert list(snap["quarantined"]) == ["3"]


def _churned(client, drv):
    """Stage a subset, then change one member's parameters."""
    subset = frozenset(k for k in drv.constraint_keys(TARGET)
                       if k.startswith("K8sRequiredLabels/"))
    assert client.prepare_subset(subset)
    old = drv._cset_sub[(TARGET, subset)]
    c = next(c for c in drv._constraints(TARGET)
             if c["kind"] == "K8sRequiredLabels")
    c = dict(c, spec=dict(c["spec"], parameters={"labels": [{"key": "tier"}]}))
    client.add_constraint(c)
    return subset, old


def test_selftest_fault_rejects_the_swap():
    drv = TorchDriver(device="cpu")
    client = _client(TBackend, TTarget, drv, n=24)
    drv.set_integrity(IntegrityPlane())
    subset, old = _churned(client, drv)
    swaps0, gen0 = drv.subset_swaps, drv.swap_generation()
    FAULTS.arm("integrity.selftest", "error")
    assert drv.prepare_subset(PATH, subset) is False
    assert FAULTS.fired("integrity.selftest") == 1
    assert drv._cset_sub[(TARGET, subset)] is old
    assert (drv.subset_swaps, drv.swap_generation()) == (swaps0, gen0)
    FAULTS.reset()
    assert drv.prepare_subset(PATH, subset) is True
    assert drv.subset_swaps == swaps0 + 1
    assert drv._cset_sub[(TARGET, subset)] is not old


def test_review_host_and_shadow_oracle_use_the_interpreter(monkeypatch):
    """ROADMAP C3: TorchDriver inherited the base driver's query_host,
    which answered a query without a subset through the fused path, so
    Client.review_host (the oracle the smoke and the shadow oracle hold
    fused answers against) was no oracle. Now it answers on the
    interpreter, as the JAX TpuDriver's does, and equals the fused path."""
    import time

    from gatekeeper_tpu.constraint import AugmentedUnstructured as JAug

    drv = TorchDriver(device="cpu")
    client = _client(TBackend, TTarget, drv)
    j_client = _client(JBackend, JTarget, TpuDriver(use_jax=False))
    objs = _batch(5, 8)
    fused = _keys(client.review_many(objs))
    monkeypatch.setattr(
        drv, "_eval_reviews_split",
        lambda *a, **kw: pytest.fail("the oracle took the fused path"),
    )
    host = _keys([client.review_host(o) for o in objs])
    want = _keys([j_client.review_host(JAug(o.object)) for o in objs])
    assert host == fused == want
    assert sum(map(len, host)) > 0
    # the shadow oracle re-evaluates through review_host
    plane = IntegrityPlane(shadow_sample_n=1)
    plane.attach_client(client)
    drv.set_integrity(plane)
    try:
        assert plane.note_live("t-1", objs[0], [])  # a wrong live verdict
        deadline = time.monotonic() + 10
        while plane.shadow_divergences == 0 and time.monotonic() < deadline:
            plane.drain_shadow()
            time.sleep(0.01)
        assert plane.shadow_divergences == 1 and fused[0]
    finally:
        plane.close()


# -- C5: the shadow oracle in a process of its own ----------------------------


def _wait_shadow(plane, pred, timeout=60.0):
    import time

    deadline = time.monotonic() + timeout
    while not pred(plane.snapshot()["shadow"]) and \
            time.monotonic() < deadline:
        time.sleep(0.02)
    return plane.snapshot()["shadow"]


def _process_plane(client, drv, **kw):
    plane = IntegrityPlane(shadow_sample_n=1, **kw)
    plane.attach_client(client)
    drv.set_integrity(plane)
    return plane


def test_process_oracle_reports_a_wrong_device_verdict(monkeypatch):
    """ROADMAP §C, C5: with the oracle in a process of its own, a right
    verdict is confirmed and a wrong one (a device answer with a
    violation dropped) is reported as a divergence, as on the thread;
    the serving process never runs the interpreter for it."""
    import os

    drv = TorchDriver(device="cpu")
    client = _client(TBackend, TTarget, drv)
    objs = _batch(5, 6)
    served = client.review_many(objs)
    results = [r.by_target[TARGET].results for r in served]
    bad = next(i for i, rs in enumerate(results) if rs)
    monkeypatch.setattr(client, "review_host", lambda *a, **kw: pytest.fail(
        "the serving process ran the oracle"))
    plane = _process_plane(client, drv)
    try:
        for i, (obj, rs) in enumerate(zip(objs, results)):
            assert plane.note_live(f"t-{i}", obj, rs)
        snap = _wait_shadow(plane, lambda s: s["evaluated"] == len(objs))
        assert snap["evaluated"] == len(objs) and snap["divergences"] == 0
        assert plane.note_live("t-wrong", objs[bad], results[bad][1:])
        snap = _wait_shadow(plane, lambda s: s["divergences"] == 1)
        assert snap["divergences"] == 1
        assert plane._oracle_proc.pid != os.getpid()
        assert snap["eval_seconds"] > 0 and len(plane.shadow_intervals) == 7
    finally:
        plane.close()
    assert plane._oracle_proc is None


def test_process_oracle_through_the_webhook_reports_injected_verdicts(
        monkeypatch):
    """A wrong device verdict injected into the fused path while the
    webhook serves: every sampled admission with a violation is reported,
    and the right ones before it are not."""
    import json
    import urllib.request

    from gatekeeper_tpu_torch.obs import Tracer
    from gatekeeper_tpu_torch.webhook import WebhookServer

    drv = TorchDriver(device="cpu")
    client = _client(TBackend, TTarget, drv)
    plane = IntegrityPlane(shadow_sample_n=1)
    # a traced request carries the trace id the sampling hashes
    server = WebhookServer(client, TARGET, window_ms=1.0, integrity=plane,
                           request_timeout=60, tracer=Tracer())
    server.start()

    def post(i, pod):
        req = {"uid": f"w-{i}", "operation": "CREATE", "name": f"w-{i}",
               "namespace": pod["metadata"]["namespace"],
               "kind": {"group": "", "version": "v1", "kind": "Pod"},
               "userInfo": {"username": "alice"}, "object": pod}
        body = json.dumps({"apiVersion": "admission.k8s.io/v1",
                           "kind": "AdmissionReview", "request": req})
        with urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{server.port}/v1/admit",
                data=body.encode()), timeout=60) as r:
            return json.loads(r.read())["response"]["allowed"]

    pods = [o.object for o in _batch(9, 8)]
    try:
        allowed = [post(i, p) for i, p in enumerate(pods)]
        assert not all(allowed)
        snap = _wait_shadow(plane, lambda s: s["evaluated"] == len(pods))
        assert snap["divergences"] == 0
        inner = client.review_many

        def wrong(objs, *a, **kw):  # the device drops every violation
            out = inner(objs, *a, **kw)
            for resp in out:
                resp.by_target[TARGET].results = []
            return out

        monkeypatch.setattr(client, "review_many", wrong)
        assert all(post(100 + i, p) for i, p in enumerate(pods))
        snap = _wait_shadow(
            plane, lambda s: s["evaluated"] == 2 * len(pods))
        assert snap["divergences"] == allowed.count(False)
    finally:
        server.stop()
        plane.close()


def test_process_oracle_counts_stale_and_dropped_samples(monkeypatch):
    drv = TorchDriver(device="cpu")
    client = _client(TBackend, TTarget, drv)
    objs = _batch(3, 5)
    plane = _process_plane(client, drv, shadow_queue_max=2)
    monkeypatch.setattr(plane, "_ensure_worker", lambda: None)
    try:
        for i, obj in enumerate(objs):
            assert plane.note_live(f"s-{i}", obj, [])
        assert plane.snapshot()["shadow"]["dropped"] == 3
        # the policy moves before the queued samples are evaluated
        client.add_constraint(chip_smoke.constraint_docs(17)[-1])
        plane.drain_shadow(timeout_s=60)
        snap = plane.snapshot()["shadow"]
        assert snap["skipped_stale"] == 2 and snap["evaluated"] == 0
        assert plane._oracle_proc is None  # nothing was sent
        # a sample at the new generation is evaluated in the process
        assert plane.note_live("s-new", objs[0], [])
        plane.drain_shadow(timeout_s=60)
        snap = plane.snapshot()["shadow"]
        assert snap["evaluated"] == 1 and plane._oracle_proc is not None
    finally:
        plane.close()


def test_process_oracle_resolves_external_data_through_the_parent(
        stub_provider):
    """A policy that calls external data evaluates in the oracle process
    against the serving process's ExternalDataSystem: the answers the
    webhook served are confirmed, a wrong one is reported."""
    from gatekeeper_tpu_torch.externaldata import ExternalDataSystem
    from tests.test_torch_externaldata import (
        external_constraint,
        external_template,
    )

    system = ExternalDataSystem()
    system.upsert(stub_provider.provider_obj())
    drv = TorchDriver(device="cpu")
    client = TBackend(drv).new_client(TTarget())
    client.set_external_data(system)
    client.add_template(external_template())
    client.add_constraint(external_constraint())
    pods = [{"apiVersion": "v1", "kind": "Pod",
             "metadata": {"name": f"x{i}", "namespace": "default"},
             "spec": {"containers": [{"name": "c", "image": img}]}}
            for i, img in enumerate(["good:1", "bad-img:2", "good:3"])]
    objs = [TAug(p) for p in pods]
    results = [r.by_target[TARGET].results for r in client.review_many(objs)]
    assert [bool(r) for r in results] == [False, True, False]
    fetches = stub_provider.fetch_count
    plane = _process_plane(client, drv)
    try:
        for i, (obj, rs) in enumerate(zip(objs, results)):
            plane.note_live(f"e-{i}", obj, rs)
        plane.note_live("e-wrong", objs[1], [])
        snap = _wait_shadow(plane, lambda s: s["evaluated"] == 4)
        assert snap["evaluated"] == 4 and snap["divergences"] == 1
        assert stub_provider.fetch_count == fetches  # served from the cache
    finally:
        plane.close()
        from gatekeeper_tpu_torch.externaldata import set_system

        set_system(None)


def test_inventory_reading_policy_stays_on_the_worker_thread(monkeypatch):
    """The constraints whose template reads the synced inventory (the
    uniqueness joins) are evaluated on the worker thread and every other
    constraint in the oracle process, which is sent no join template; the
    joined verdicts confirm the served ones, and a wrong verdict on either
    side is reported."""
    joins = set(chip_smoke.UNIQUENESS)
    drv = TorchDriver(device="cpu")
    client = _client(TBackend, TTarget, drv, joins=True)
    objs = chip_smoke.mixed_review_batch(1, 24, 60) + _batch(5, 6)
    results = [r.by_target[TARGET].results for r in client.review_many(objs)]

    def kinds(rs):
        return {r.constraint["kind"] for r in rs}

    join = next(i for i, rs in enumerate(results) if kinds(rs) & joins)
    plain = next(i for i, rs in enumerate(results)
                 if rs and not kinds(rs) & joins)
    subsets, sent = [], []
    host = client.review_host

    def review_host(obj, subset=None):
        subsets.append(subset)
        return host(obj, subset=subset)

    monkeypatch.setattr(client, "review_host", review_host)
    plane = _process_plane(client, drv)
    policy_at = plane._policy_at

    def recorded(gen, leave_out=frozenset()):
        sent.append(policy_at(gen, leave_out))
        return sent[-1]

    monkeypatch.setattr(plane, "_policy_at", recorded)
    try:
        for i, (obj, rs) in enumerate(zip(objs, results)):
            assert plane.note_live(f"i-{i}", obj, rs)
        snap = _wait_shadow(plane, lambda s: s["evaluated"] == len(objs))
        assert snap["evaluated"] == len(objs) and snap["divergences"] == 0
        assert snap["thread_seconds"] > 0 and plane._oracle_proc is not None
        want = {f"{c['kind']}/{c['metadata']['name']}"
                for c in chip_smoke.uniqueness_constraints()}
        assert len(subsets) == len(objs) and all(s == want for s in subsets)
        templates, constraints = sent[0]
        assert len(sent) == 1 and constraints
        assert not {c["kind"] for c in constraints} & joins
        assert not {t["spec"]["crd"]["spec"]["names"]["kind"]
                    for t in templates} & joins
        assert plane.note_live("i-join", objs[join], [
            r for r in results[join] if r.constraint["kind"] not in joins])
        assert plane.note_live("i-plain", objs[plain], results[plain][1:])
        snap = _wait_shadow(plane, lambda s: s["divergences"] == 2)
        assert snap["divergences"] == 2
    finally:
        plane.close()


def test_process_oracle_restarts_after_its_process_died():
    drv = TorchDriver(device="cpu")
    client = _client(TBackend, TTarget, drv)
    objs = _batch(6, 2)
    plane = _process_plane(client, drv)
    try:
        plane.note_live("d-0", objs[0], [])
        _wait_shadow(plane, lambda s: s["evaluated"] == 1)
        first = plane._oracle_proc
        first._proc.kill()
        first._proc.join(10)
        plane.note_live("d-1", objs[1], [])
        snap = _wait_shadow(plane, lambda s: s["evaluated"] == 2)
        assert snap["evaluated"] == 2
        assert plane._oracle_proc is not first and plane._oracle_proc.alive
    finally:
        plane.close()
