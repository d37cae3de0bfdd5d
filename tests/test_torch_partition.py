"""Fault-domain partitions on the port's webhook, on the CPU, over HTTP:

  * WebhookServer(partitions=k) for k = 1, 2, 4 answers every request
    exactly as the monolithic server does, and as the JAX TpuDriver's
    `query_many_subset` over the same plan's subsets, merged by the JAX
    `merge_partition_results`;
  * with `driver.device_dispatch[device=1]` armed, only the requests whose
    match mask touches partition 1 get the fail-policy envelope (counted
    per partition); after three failing batches device 1's breaker opens,
    partition 1 re-homes onto a healthy device and its requests get fused
    answers again; the other requests stay fused throughout. No request
    is answered on the host interpreter;
  * churning N of K partitions (new parameters for one constraint each)
    moves `program_compiles` by exactly N, and the other K - N partitions
    carry their staged sets forward;
  * a fault at `compile.swap` leaves the old subset set serving.
"""

import copy

import pytest

import chip_smoke
from gatekeeper_tpu.constraint import (
    Backend as JBackend,
    K8sValidationTarget as JTarget,
)
from gatekeeper_tpu.constraint.tpudriver import TpuDriver
from gatekeeper_tpu.parallel.partition import (
    merge_partition_results as j_merge,
)
from gatekeeper_tpu_torch.constraint import (
    AugmentedUnstructured as TAug,
    Backend as TBackend,
    K8sValidationTarget as TTarget,
)
from gatekeeper_tpu_torch.constraint.torchdriver import TorchDriver
from gatekeeper_tpu_torch.faults import FAULTS, FaultError, OPEN
from gatekeeper_tpu_torch.metrics import MetricsRegistry
from gatekeeper_tpu_torch.webhook import WebhookServer

TARGET = chip_smoke.TARGET
PATH = f'hooks["{TARGET}"].violation'
N_CONSTRAINTS = 16


@pytest.fixture(autouse=True)
def _clean_faults():
    FAULTS.reset()
    yield
    FAULTS.reset()


def _constraints():
    """constraint_docs with match blocks of three shapes (every Pod, Pods
    in ns1, Pods in ns2), so a request's mask touches some partitions
    and not others."""
    out = chip_smoke.constraint_docs(N_CONSTRAINTS)
    for i, c in enumerate(out):
        if i % 3:
            c["spec"]["match"]["namespaces"] = [f"ns{i % 3}"]
    return out


def _client(backend, target, driver):
    client = backend(driver).new_client(target())
    for t in chip_smoke.template_docs():
        client.add_template(t)
    for c in _constraints():
        client.add_constraint(c)
    for i in range(24):
        client.add_data(chip_smoke.make_pod(i))
    return client


def _pods(seed, n):
    out = []
    for j in range(n):
        pod = chip_smoke.make_pod(13 * j + seed, name=f"part-{seed}-{j}")
        pod["metadata"]["namespace"] = f"ns{j % 4}"
        if j % 3 == 1:
            pod["metadata"]["labels"].pop("owner", None)
        if j % 5 == 2:
            pod["spec"]["containers"][0]["image"] = f"docker.io/novel{j}"
        out.append(pod)
    return out


def _requests(seed, n):
    return [chip_smoke.admission_request(p, f"u{seed}-{j}")
            for j, p in enumerate(_pods(seed, n))]


def _posts(requests):
    return [("/v1/admit", chip_smoke._envelope(r)) for r in requests]


def _serve(client, requests, threads=8, **kw):
    server = WebhookServer(client, TARGET, window_ms=2.0, **kw)
    server.start()
    try:
        bodies, _, _ = chip_smoke._drive_http(
            server.port, _posts(requests), threads
        )
    finally:
        server.stop()
    return server, bodies


@pytest.fixture(scope="module")
def clients():
    t_drv, j_drv = TorchDriver(device="cpu"), TpuDriver(use_jax=False)
    return (
        (_client(TBackend, TTarget, t_drv), t_drv),
        (_client(JBackend, JTarget, j_drv), j_drv),
    )


@pytest.mark.parametrize("k", [1, 2, 4])
def test_partitioned_server_equals_monolith_and_reference(clients, k):
    (t_client, t_drv), (j_client, _) = clients
    requests = _requests(k, 48)
    _, mono = _serve(t_client, requests)
    server, part = _serve(t_client, requests, partitions=k)
    assert part == mono
    plan = server.partitioner.plan()
    assert len(plan.partitions) == k
    assert sorted(key for p in plan.partitions for key in p.keys) == sorted(
        t_drv.constraint_keys(TARGET)
    )
    # the JAX driver over the same subsets, merged in the same order
    handler = JTarget()
    objs = [handler.augment_request(r) for r in requests]
    per_part = [
        [resp.by_target[TARGET].results if TARGET in resp.by_target else []
         for resp in j_client.review_many_subset(objs, p.subset)]
        for p in plan.partitions
    ]
    want = [
        chip_smoke._response_of(
            j_merge([rows[i] for rows in per_part], plan.order))
        for i in range(len(requests))
    ]
    assert [chip_smoke._response_fields(b) for b in part] == want
    assert any(not w[0] for w in want) and any(w[0] for w in want)
    snap = server.partitioner.snapshot()
    assert snap["dispatches"]["unavailable"] == 0
    assert snap["dispatches"]["fused"] > 0
    assert server.batcher.requests_batched == len(requests)


def test_device_fault_fails_only_its_partition(clients, monkeypatch):
    (t_client, t_drv), _ = clients
    requests = _requests(7, 24)
    _, mono = _serve(t_client, requests)
    expected = [chip_smoke._response_fields(b) for b in mono]
    # the host interpreter must not answer any request
    monkeypatch.setattr(
        t_client, "review_host",
        lambda *a, **kw: pytest.fail("answered on the host interpreter"),
    )
    metrics = MetricsRegistry()
    server = WebhookServer(t_client, TARGET, window_ms=1.0, partitions=4,
                           metrics=metrics)
    server.start()
    try:
        part = server.partitioner
        plan = part.plan()
        handler = TTarget()
        masks = t_client.partition_match_mask(
            [handler.augment_request(r) for r in requests],
            [p.subset for p in plan.partitions],
        )
        touches = masks[1]
        assert any(touches) and not all(touches)
        FAULTS.arm("driver.device_dispatch[device=1]", "error")
        got, failed = [], 0
        for req in requests:  # one request per batch, in order
            (body,), _, _ = chip_smoke._drive_http(
                server.port, _posts([req]), 1
            )
            got.append(body)
        for i, body in enumerate(got):
            fields = chip_smoke._response_fields(body)
            if touches[i] and failed < 3:
                failed += 1
                assert fields[0] is True and fields[2].startswith(
                    "admission evaluation unavailable (degraded)"
                ), fields
            else:
                assert fields == expected[i]
        assert failed == 3
        assert part.breaker(1).state == OPEN
        new_plan = part.plan()
        assert new_plan.partitions[1].home_device == 1
        assert new_plan.partitions[1].device != 1
        assert part.rehomes >= 1
        snap = part.snapshot()
        assert snap["dispatches"]["failed"] == 3
        assert snap["dispatches"]["unavailable"] == 3
        assert snap["quarantined"] == [1]
        counters = metrics.snapshot()["counters"]
        assert counters[
            'webhook_partition_unavailable_total'
            '{device="1",partition="1",plane="validation"}'
        ] == 3
        assert FAULTS.fired("driver.device_dispatch[device=1]") == 3
    finally:
        server.stop()


# -- the incremental compile plane -------------------------------------------

_REGO = """package churnN
violation[{"msg": msg}] {
    required := {key | key := input.parameters.labels[_]}
    provided := {key | input.review.object.metadata.labels[key]}
    missing := required - provided
    count(missing) > 0
    msg := sprintf("missing: %v", [missing])
}
"""
KINDS = ["ChurnA", "ChurnB", "ChurnC", "ChurnD"]


def _kind_constraint(kind, label):
    return {
        "apiVersion": "constraints.gatekeeper.sh/v1beta1",
        "kind": kind,
        "metadata": {"name": f"c-{kind.lower()}"},
        "spec": {
            "match": {"kinds": [{"apiGroups": [""], "kinds": ["Pod"]}]},
            "parameters": {"labels": [label]},
        },
    }


def _churn_client():
    client = TBackend(TorchDriver(device="cpu")).new_client(TTarget())
    for n, kind in enumerate(KINDS):
        client.add_template({
            "apiVersion": "templates.gatekeeper.sh/v1beta1",
            "kind": "ConstraintTemplate",
            "metadata": {"name": kind.lower()},
            "spec": {
                "crd": {"spec": {"names": {"kind": kind}}},
                "targets": [{"target": TARGET,
                             "rego": _REGO.replace("churnN", f"churn{n}")}],
            },
        })
        client.add_constraint(_kind_constraint(kind, "owner"))
    return client


@pytest.mark.parametrize("n_churn", [1, 2])
def test_churn_recompiles_only_churned_partitions(n_churn):
    client = _churn_client()
    drv = client._driver
    requests = _requests(3, 16)
    server = WebhookServer(client, TARGET, window_ms=1.0, partitions=4)
    server.start()
    try:
        chip_smoke._drive_http(server.port, _posts(requests), 4)
        plan = server.partitioner.plan()
        assert [len(p.keys) for p in plan.partitions] == [1, 1, 1, 1]
        compiles0 = drv.program_compiles
        carry0 = drv.subset_carryforwards
        churned = [p.keys[0].split("/")[0] for p in plan.partitions[:n_churn]]
        for kind in churned:
            client.add_constraint(_kind_constraint(kind, "team"))
        bodies, _, _ = chip_smoke._drive_http(
            server.port, _posts(_requests(4, 16)), 1
        )
        assert server.partitioner.plan().partitions == plan.partitions
        assert drv.program_compiles - compiles0 == n_churn
        assert drv.subset_carryforwards - carry0 == 4 - n_churn
        # the churned constraints now require "team", which no pod has
        denied = [b for b in bodies if not b["response"]["allowed"]]
        assert len(denied) == len(bodies)
        for kind in churned:
            assert all(f"c-{kind.lower()}" in b["response"]["status"]["message"]
                       for b in denied)
        assert server.partitioner.snapshot()["dispatches"]["unavailable"] == 0
    finally:
        server.stop()


def test_compile_swap_fault_leaves_old_subset_serving():
    client = _churn_client()
    drv = client._driver
    subset = frozenset(["ChurnA/c-churna"])
    assert client.prepare_subset(subset) is True
    old = drv._cset_sub[(TARGET, subset)]
    swaps0, gen0 = drv.subset_swaps, drv.swap_generation()
    pod = chip_smoke.make_pod(1)
    pod["metadata"]["labels"] = {"team": "core"}
    (before,) = client.review_many_subset([TAug(pod)], subset)
    assert len(before.by_target[TARGET].results) == 1
    client.add_constraint(_kind_constraint("ChurnA", "team"))
    FAULTS.arm("compile.swap", "error")
    with pytest.raises(FaultError):
        drv.prepare_subset(PATH, subset)
    assert FAULTS.fired("compile.swap") == 1
    assert drv._cset_sub[(TARGET, subset)] is old
    assert (drv.subset_swaps, drv.swap_generation()) == (swaps0, gen0)
    FAULTS.reset()
    assert drv.prepare_subset(PATH, subset) is True
    assert drv.subset_swaps == swaps0 + 1
    assert drv._cset_sub[(TARGET, subset)] is not old
    (after,) = client.review_many_subset([TAug(copy.deepcopy(pod))], subset)
    assert after.by_target[TARGET].results == []


def test_constraint_churn_keeps_the_frozen_inventory():
    """The interpreter's frozen inventory (what a golden canary derivation
    reads under the serving mutex) survives a constraint change and is
    frozen again only when the synced objects change."""
    client = _churn_client()
    drv = client._driver
    client.add_data(chip_smoke.make_pod(5))
    inv = drv._inventory(TARGET)
    client.add_constraint(_kind_constraint("ChurnB", "team"))
    assert drv._inventory(TARGET) is inv
    client.add_data(chip_smoke.make_pod(6))
    again = drv._inventory(TARGET)
    assert again is not inv
    assert len(again["namespace"]["ns6"]["v1"]["Pod"]) == 1
