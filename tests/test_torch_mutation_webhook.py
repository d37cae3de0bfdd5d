"""The port's /v1/mutate plane (gatekeeper_tpu_torch/webhook/mutate.py and
WebhookServer's mutation_system) against the JAX package's on the CPU.

Two WebhookServers, one per package, each with a MutationSystem holding
the same seeded mutators, answer the same AdmissionReviews over HTTP: base64
JSONPatch answers, Gatekeeper's service-account bypass, excluded
namespaces, operations that never mutate, a ConvergenceError's 500 and the
envelope, equal by uid. Then the standing divergence: in the port a batch
whose device screen fails, or that the open breaker turns away, is answered
with the fail policy and never screened on the host (`screen_host`); the
JAX package screens it on the host instead.
"""

import base64
import json
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from gatekeeper_tpu.constraint import (
    Backend as JBackend,
    K8sValidationTarget as JTarget,
    RegoDriver as JRegoDriver,
)
from gatekeeper_tpu.control import Excluder as JExcluder
from gatekeeper_tpu.mutation import MutationSystem as JMutationSystem
from gatekeeper_tpu.webhook import WebhookServer as JWebhookServer
from gatekeeper_tpu_torch.constraint import Backend, K8sValidationTarget
from gatekeeper_tpu_torch.constraint.driver import RegoDriver
from gatekeeper_tpu_torch.control import Excluder
from gatekeeper_tpu_torch.faults import OPEN
from gatekeeper_tpu_torch.metrics import MetricsRegistry
from gatekeeper_tpu_torch.mutation import MutationSystem
from gatekeeper_tpu_torch.mutation.patch import apply_patch
from gatekeeper_tpu_torch.webhook import WebhookServer
from gatekeeper_tpu_torch.webhook.mutate import MutateBatcher, MutationHandler
from gatekeeper_tpu_torch.webhook.policy import SERVICE_ACCOUNT
from tests.test_torch_mutation import assign, assign_meta, modify_set, pod

TARGET = "admission.k8s.gatekeeper.sh"

MUTATORS = [
    assign("pull-always", "spec.containers[name: *].imagePullPolicy",
           "Always", match={"labelSelector": {"matchExpressions": [
               {"key": "app", "operator": "Exists"}]}}),
    assign("non-root", "spec.securityContext.runAsNonRoot", True,
           match={"namespaces": ["prod", "default"]}),
    assign_meta("owner", "metadata.labels.owner", "platform",
                match={"excludedNamespaces": ["dev"]}),
    assign_meta("cost", "metadata.annotations.cost-center", "42",
                match={"labelSelector": {"matchLabels": {"env": "prod"}}}),
    modify_set("args", "spec.containers[name: *].args", ["--log=json"],
               match={"labelSelector": {"matchExpressions": [
                   {"key": "tier", "operator": "NotIn",
                    "values": ["front"]}]}}),
]
FLIP = [
    assign("flip-a", "spec.phase", "a",
           params={"assignIf": {"in": [None, "b"]}},
           match={"namespaces": ["flip"]}),
    assign("flip-b", "spec.phase", "b",
           params={"assignIf": {"in": [None, "a"]}},
           match={"namespaces": ["flip"]}),
]


def requests(seed, n=48):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        ns = str(rng.choice(["default", "prod", "dev", "kube-system",
                             "flip"], p=[0.35, 0.25, 0.2, 0.1, 0.1]))
        obj = pod(rng, i, ns=ns)
        op = str(rng.choice(["CREATE", "UPDATE", "DELETE", "CONNECT"],
                            p=[0.6, 0.25, 0.1, 0.05]))
        req = {"uid": f"uid-{seed}-{i}",
               "kind": {"group": "", "version": "v1", "kind": "Pod"},
               "operation": op, "name": obj["metadata"]["name"],
               "namespace": ns, "object": obj,
               "userInfo": {"username": SERVICE_ACCOUNT if i % 17 == 5
                            else "alice"}}
        if op == "UPDATE":
            req["oldObject"] = pod(rng, i, ns=ns)
        out.append(req)
    return out


def _post(port, path, req):
    body = {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
            "request": req}
    r = urllib.request.urlopen(urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}), timeout=60)
    return json.loads(r.read())


def _server(pkg, docs, **kw):
    if pkg == "torch":
        system = MutationSystem(device="cpu")
        client = Backend(RegoDriver()).new_client(K8sValidationTarget())
        excluder, cls = Excluder(), WebhookServer
    else:
        system = JMutationSystem()
        client = JBackend(JRegoDriver()).new_client(JTarget())
        excluder, cls = JExcluder(), JWebhookServer
    for d in docs:
        system.upsert(d)
    excluder.add([{"processes": ["webhook"],
                   "excludedNamespaces": ["kube-system"]}])
    server = cls(client, TARGET, window_ms=5.0, excluder=excluder,
                 mutation_system=system, request_timeout=60, **kw)
    server.start()
    return server, system


@pytest.mark.parametrize("seed", [0, 1])
def test_mutate_answers_equal_jax(seed):
    reqs = requests(seed)
    got = {}
    for pkg in ("torch", "tpu"):
        server, system = _server(pkg, MUTATORS + FLIP)
        try:
            with ThreadPoolExecutor(max_workers=16) as ex:
                outs = list(ex.map(
                    lambda r: _post(server.port, "/v1/mutate", r), reqs))
            screens = system.screen_dispatches
        finally:
            server.stop()
        got[pkg] = {o["response"]["uid"]: o for o in outs}
        assert 1 <= screens < len(reqs)  # micro-batched
    assert got["torch"] == got["tpu"]
    by_uid = {r["uid"]: r for r in reqs}
    mutated = errors = 0
    for uid, out in got["torch"].items():
        resp, req = out["response"], by_uid[uid]
        if "patch" in resp:
            ops = json.loads(base64.b64decode(resp["patch"]))
            after = apply_patch(req["object"], ops)
            assert after != req["object"]
            mutated += 1
        if not resp["allowed"]:
            assert resp["status"]["code"] == 500
            assert "converge" in resp["status"]["message"]
            assert req["namespace"] == "flip"
            errors += 1
    assert mutated > 10 and errors > 0


def _batcher(system, metrics, **kw):
    batcher = MutateBatcher(system, window_ms=1.0, metrics=metrics)
    return batcher, MutationHandler(batcher, metrics=metrics,
                                    request_timeout=60, **kw)


def _fail_screen_host(monkeypatch, system):
    monkeypatch.setattr(system, "screen_host", lambda *a, **kw: pytest.fail(
        "a batch was screened on the host"))


@pytest.mark.parametrize("policy", ["open", "closed"])
def test_failed_screen_answers_fail_policy_never_host(monkeypatch, policy):
    """Standing divergence: the JAX package answers a batch whose device
    screen failed through MutationSystem.screen_host; the port answers
    it with the fail policy and counts it."""
    metrics = MetricsRegistry()
    system = MutationSystem(device="cpu", metrics=metrics)
    for d in MUTATORS:
        system.upsert(d)
    monkeypatch.setattr(system, "screen", lambda *a, **kw: (_ for _ in ()
                        ).throw(RuntimeError("K1 launch failed")))
    _fail_screen_host(monkeypatch, system)
    batcher, handler = _batcher(system, metrics, fail_policy=policy)
    batcher.start()
    try:
        resp = handler.handle(requests(3, 1)[0] | {"operation": "CREATE",
                                                    "namespace": "prod"})
    finally:
        batcher.stop()
    assert resp.patch is None
    assert "K1 launch failed" in resp.message
    assert resp.allowed is (policy == "open")
    if policy == "closed":
        assert resp.code == 503
    counters = metrics.snapshot()["counters"]
    assert counters["mutation_batch_failures_total"] == 1
    assert batcher.batch_failures == 1
    assert sum(v for k, v in counters.items() if k.startswith(
        "webhook_unavailable_responses_total")) == 1


def test_open_breaker_answers_fail_policy_never_host(monkeypatch):
    metrics = MetricsRegistry()
    system = MutationSystem(device="cpu", metrics=metrics)
    system.upsert(MUTATORS[1])
    monkeypatch.setattr(system, "screen", lambda *a, **kw: (_ for _ in ()
                        ).throw(RuntimeError("K1 launch failed")))
    _fail_screen_host(monkeypatch, system)
    batcher, handler = _batcher(system, metrics)
    batcher.start()
    req = requests(4, 1)[0] | {"operation": "CREATE", "namespace": "prod",
                               "userInfo": {"username": "alice"}}
    try:
        for _ in range(batcher.breaker.failure_threshold):
            assert "K1 launch failed" in handler.handle(req).message
        assert batcher.breaker.state == OPEN
        resp = handler.handle(req)
    finally:
        batcher.stop()
    assert resp.allowed and resp.patch is None
    assert "circuit breaker open" in resp.message
    counters = metrics.snapshot()["counters"]
    assert counters[
        'webhook_degraded_dispatch_total{plane="mutation"}'] == 1


def test_jax_package_screens_a_failed_batch_on_the_host(monkeypatch):
    """The reference side of the divergence above, pinned."""
    from gatekeeper_tpu.webhook import MutateBatcher as JMutateBatcher
    from gatekeeper_tpu.webhook import MutationHandler as JMutationHandler

    system = JMutationSystem()
    system.upsert(MUTATORS[1])
    monkeypatch.setattr(system, "screen", lambda *a, **kw: (_ for _ in ()
                        ).throw(RuntimeError("device fault")))
    batcher = JMutateBatcher(system, window_ms=1.0)
    handler = JMutationHandler(batcher, request_timeout=60)
    batcher.start()
    try:
        resp = handler.handle(requests(4, 1)[0] | {
            "operation": "CREATE", "namespace": "prod",
            "userInfo": {"username": "alice"}})
    finally:
        batcher.stop()
    assert resp.allowed and resp.patch


def test_convergence_error_is_never_softened(monkeypatch):
    """A ConvergenceError stays a 500 under fail-open, and the object is
    not admitted unmutated."""
    system = MutationSystem(device="cpu")
    for d in FLIP:
        system.upsert(d)
    batcher, handler = _batcher(system, None, fail_policy="open")
    batcher.start()
    try:
        resp = handler.handle(requests(5, 1)[0] | {
            "operation": "CREATE", "namespace": "flip",
            "userInfo": {"username": "alice"}})
    finally:
        batcher.stop()
    assert not resp.allowed and resp.code == 500 and resp.patch is None


def test_mutate_404_without_a_system():
    client = Backend(RegoDriver()).new_client(K8sValidationTarget())
    server = WebhookServer(client, TARGET, window_ms=1.0)
    server.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server.port, "/v1/mutate", requests(6, 1)[0])
        assert e.value.code == 404
        assert server.mutate_batcher is None
        assert "mutation" not in server.sched_snapshot()
    finally:
        server.stop()
