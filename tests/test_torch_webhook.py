"""The port's admission webhook (gatekeeper_tpu_torch/webhook) on the CPU:
the validation handler's semantics (policy.go:141-408), the namespace-label
guard, micro-batching and the HTTP server, over TorchDriver(device="cpu")
— the cases of tests/test_webhook.py without TLS and cert rotation — and
parity with the JAX package's WebhookServer over TpuDriver: the same
AdmissionReviews POSTed over HTTP from several threads give equal
response bodies."""

import io
import json
import os
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import pytest

from gatekeeper_tpu.constraint import (
    Backend as JBackend,
    K8sValidationTarget as JTarget,
    TpuDriver,
)
from gatekeeper_tpu.control import Excluder as JExcluder
from gatekeeper_tpu.webhook import WebhookServer as JWebhookServer
from gatekeeper_tpu_torch.constraint import (
    AugmentedUnstructured,
    Backend,
    K8sValidationTarget,
    RegoDriver,
)
from gatekeeper_tpu_torch.constraint.torchdriver import TorchDriver
from gatekeeper_tpu_torch.control import Excluder
from gatekeeper_tpu_torch.faults import (
    CLOSED,
    FAULTS,
    OPEN,
    EvaluationUnavailable,
)
from gatekeeper_tpu_torch.logs import StructuredLogger
from gatekeeper_tpu_torch.metrics import MetricsRegistry, serve_metrics
from gatekeeper_tpu_torch.obs import Tracer
from gatekeeper_tpu_torch.webhook import (
    IGNORE_LABEL,
    MicroBatcher,
    NamespaceLabelHandler,
    TraceConfig,
    ValidationHandler,
    WebhookServer,
)
from gatekeeper_tpu_torch.webhook.policy import SERVICE_ACCOUNT

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

DENY_IMAGE = """package denyimage

violation[{"msg": msg}] {
    c := input.review.object.spec.containers[_]
    startswith(c.image, input.parameters.prefix)
    msg := sprintf("container %v uses %v", [c.name, c.image])
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


def constraint(kind, name, params=None, enforcement=None, match=None):
    spec = {}
    if params is not None:
        spec["parameters"] = params
    if enforcement is not None:
        spec["enforcementAction"] = enforcement
    if match is not None:
        spec["match"] = match
    return {
        "apiVersion": "constraints.gatekeeper.sh/v1beta1",
        "kind": kind,
        "metadata": {"name": name},
        "spec": spec,
    }


def admission_request(obj, operation="CREATE", name=None, namespace=None,
                      old_object=None, username="alice", uid="u1"):
    kind = obj.get("kind") if obj else "Pod"
    group = ""
    api_version = (obj or {}).get("apiVersion", "v1")
    if "/" in api_version:
        group, version = api_version.split("/", 1)
    else:
        version = api_version
    req = {
        "uid": uid,
        "kind": {"group": group, "version": version, "kind": kind},
        "operation": operation,
        "userInfo": {"username": username},
        "object": obj,
    }
    if name is not None:
        req["name"] = name
    if namespace is not None:
        req["namespace"] = namespace
    if old_object is not None:
        req["oldObject"] = old_object
    return req


def pod(name="p", ns="default", labels=None, image="nginx"):
    meta = {"name": name, "namespace": ns}
    if labels:
        meta["labels"] = labels
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": meta,
        "spec": {"containers": [{"name": "c", "image": image}]},
    }


def _load(cl):
    cl.add_template(template("ReqLabels", REQ_LABELS))
    cl.add_constraint(
        constraint("ReqLabels", "need-owner", params={"labels": ["owner"]})
    )
    cl.add_constraint(
        constraint(
            "ReqLabels",
            "want-team",
            params={"labels": ["team"]},
            enforcement="dryrun",
        )
    )
    return cl


@pytest.fixture()
def client():
    return _load(Backend(TorchDriver(device="cpu")).new_client(K8sValidationTarget()))


@pytest.fixture()
def handler(client):
    return ValidationHandler(client, TARGET, log_denies=True)


def post(server, path, req, _retry=True):
    body = json.dumps(
        {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
         "request": req}
    ).encode()
    try:
        r = urllib.request.urlopen(
            urllib.request.Request(
                f"http://127.0.0.1:{server.port}{path}",
                data=body,
                headers={"Content-Type": "application/json"},
            ),
            timeout=60,
        )
    except (ConnectionResetError, TimeoutError):
        # full-suite runs starve the CPU; one retry absorbs the transient
        if not _retry:
            raise
        return post(server, path, req, _retry=False)
    return json.loads(r.read())


def test_deny_and_dryrun(handler):
    resp = handler.handle(admission_request(pod(labels={"app": "x"})))
    assert not resp.allowed and resp.code == 403
    # only the deny constraint denies; dryrun is logged but allows
    assert "[denied by need-owner]" in resp.message
    assert "want-team" not in resp.message
    dryrun_logs = [
        e for e in handler.denied_log if e["constraint_action"] == "dryrun"
    ]
    assert dryrun_logs


def test_log_denies_emits_structured_records(client):
    """--log-denies parity (policy.go:240-252): every deny/dryrun
    violation logs one JSON record with the reference's standard keys."""
    buf = io.StringIO()
    h = ValidationHandler(
        client, TARGET, log_denies=True, logger=StructuredLogger(stream=buf)
    )
    resp = h.handle(admission_request(pod(labels={"app": "x"})))
    assert not resp.allowed
    records = [json.loads(line) for line in buf.getvalue().splitlines()]
    denies = [r for r in records if r["msg"] == "denied admission"]
    assert denies, records
    rec = denies[0]
    for key in (
        "process", "event_type", "constraint_name", "constraint_kind",
        "constraint_action", "resource_kind", "resource_namespace",
        "resource_name", "request_username",
    ):
        assert key in rec, rec
    assert rec["process"] == "admission"
    assert rec["event_type"] == "violation"
    assert rec["constraint_kind"] == "ReqLabels"
    assert {r["constraint_action"] for r in denies} == {"deny", "dryrun"}


def test_allow_compliant(handler):
    resp = handler.handle(
        admission_request(pod(labels={"owner": "me", "team": "t"}))
    )
    assert resp.allowed


def test_gk_service_account_bypasses(handler):
    resp = handler.handle(admission_request(pod(), username=SERVICE_ACCOUNT))
    assert resp.allowed
    assert "self-manage" in resp.message


def test_delete_reviews_old_object(handler):
    bad_old = pod(labels={"app": "x"})
    resp = handler.handle(
        admission_request(None, operation="DELETE", old_object=bad_old)
    )
    assert not resp.allowed and resp.code == 403


def test_delete_without_old_object_500(handler):
    resp = handler.handle(admission_request(None, operation="DELETE"))
    assert not resp.allowed and resp.code == 500


def test_excluded_namespace_allowed(client):
    excluder = Excluder()
    excluder.add([
        {"processes": ["webhook"], "excludedNamespaces": ["kube-system"]}
    ])
    h = ValidationHandler(client, TARGET, excluder=excluder)
    resp = h.handle(
        admission_request(pod(ns="kube-system"), namespace="kube-system")
    )
    assert resp.allowed
    assert "ignored" in resp.message
    # audit process exclusion does not leak into the webhook
    assert not excluder.is_namespace_excluded("audit", "kube-system")


def test_template_validation_422(handler):
    bad = template("BadTempl", "package x\nviolation { true ")  # parse error
    req = admission_request(bad)
    req["kind"] = {
        "group": "templates.gatekeeper.sh",
        "version": "v1beta1",
        "kind": "ConstraintTemplate",
    }
    resp = handler.handle(req)
    assert not resp.allowed and resp.code == 422


def test_constraint_validation(handler):
    unknown = constraint("NoSuchKind", "c1")
    req = admission_request(unknown)
    req["kind"] = {
        "group": "constraints.gatekeeper.sh",
        "version": "v1beta1",
        "kind": "NoSuchKind",
    }
    resp = handler.handle(req)
    assert not resp.allowed and resp.code == 422

    bad_action = constraint("ReqLabels", "c2", enforcement="explode")
    req = admission_request(bad_action)
    req["kind"] = {
        "group": "constraints.gatekeeper.sh",
        "version": "v1beta1",
        "kind": "ReqLabels",
    }
    resp = handler.handle(req)
    assert not resp.allowed and resp.code == 500


def test_namespace_attach_for_nsselector(client):
    client.add_constraint(
        constraint(
            "ReqLabels",
            "prod-only",
            params={"labels": ["compliance"]},
            match={"namespaceSelector": {"matchLabels": {"env": "prod"}}},
        )
    )
    namespaces = {
        "prod": {"apiVersion": "v1", "kind": "Namespace",
                 "metadata": {"name": "prod", "labels": {"env": "prod"}}},
        "dev": {"apiVersion": "v1", "kind": "Namespace",
                "metadata": {"name": "dev", "labels": {"env": "dev"}}},
    }
    h = ValidationHandler(client, TARGET, namespace_getter=namespaces.get)
    resp = h.handle(
        admission_request(
            pod(ns="prod", labels={"owner": "x", "team": "t"}),
            namespace="prod",
        )
    )
    assert not resp.allowed and "prod-only" in resp.message
    resp = h.handle(
        admission_request(
            pod(ns="dev", labels={"owner": "x", "team": "t"}),
            namespace="dev",
        )
    )
    assert resp.allowed


def test_metrics_recorded(client):
    metrics = MetricsRegistry()
    h = ValidationHandler(client, TARGET, metrics=metrics)
    h.handle(admission_request(pod(labels={"owner": "o", "team": "t"})))
    h.handle(admission_request(pod(labels={"app": "x"})))
    snap = metrics.snapshot()
    assert snap["counters"]['request_count{admission_status="allow"}'] == 1
    assert snap["counters"]['request_count{admission_status="deny"}'] == 1


def test_serve_metrics_exposes_request_count(client):
    metrics = MetricsRegistry()
    ValidationHandler(client, TARGET, metrics=metrics).handle(
        admission_request(pod(labels={"app": "x"}))
    )
    httpd = serve_metrics(metrics)
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        text = urllib.request.urlopen(f"{base}/metrics", timeout=30).read()
        assert b'request_count{admission_status="deny"} 1' in text
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"{base}/debug/traces", timeout=30)
        assert err.value.code == 404
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_namespace_label_guard():
    h = NamespaceLabelHandler(exempt_namespaces=["kube-system"])
    ns = {
        "apiVersion": "v1",
        "kind": "Namespace",
        "metadata": {"name": "evil", "labels": {IGNORE_LABEL: "1"}},
    }
    resp = h.handle(admission_request(ns, name="evil"))
    assert not resp.allowed and resp.code == 403
    ns2 = {
        "apiVersion": "v1",
        "kind": "Namespace",
        "metadata": {"name": "kube-system", "labels": {IGNORE_LABEL: "1"}},
    }
    assert h.handle(admission_request(ns2, name="kube-system")).allowed
    plain = {"apiVersion": "v1", "kind": "Namespace",
             "metadata": {"name": "ok"}}
    assert h.handle(admission_request(plain, name="ok")).allowed


def test_review_many_matches_serial(client):
    objs = [
        AugmentedUnstructured(
            pod(f"p{i}", labels={"owner": "o"} if i % 2 else None)
        )
        for i in range(8)
    ]
    batched = client.review_many(objs)
    for obj, responses in zip(objs, batched):
        serial = client.review(obj)
        want = [
            (r.msg, r.enforcement_action)
            for r in serial.by_target[TARGET].results
        ]
        got = [
            (r.msg, r.enforcement_action)
            for r in responses.by_target[TARGET].results
        ]
        assert got == want


def test_webhook_server_end_to_end(client):
    tracer = Tracer()
    server = WebhookServer(client, TARGET, window_ms=1.0, tracer=tracer)
    server.start()
    try:
        # concurrent requests coalesce into micro-batches
        reqs = [
            admission_request(
                pod(f"p{i}", labels={"owner": "o"} if i % 2 else {"app": "x"}),
                uid=f"uid{i}",
            )
            for i in range(16)
        ]
        with ThreadPoolExecutor(max_workers=16) as ex:
            outs = list(ex.map(lambda r: post(server, "/v1/admit", r), reqs))
        for i, out in enumerate(outs):
            assert out["response"]["uid"] == f"uid{i}"
            assert out["response"]["allowed"] == bool(i % 2)
        assert server.batcher.requests_batched >= 16
        assert server.batcher.batches_dispatched <= 16
        assert server.batcher.batch_failures == 0

        # label endpoint
        ns = {"apiVersion": "v1", "kind": "Namespace",
              "metadata": {"name": "evil", "labels": {IGNORE_LABEL: "1"}}}
        out = post(server, "/v1/admitlabel", admission_request(ns, name="evil"))
        assert out["response"]["allowed"] is False
    finally:
        server.stop()
    # every batch went through the fused route, and the trace says so
    dispatch = [
        s for t in tracer.recent(64) for s in t["spans"]
        if s["name"] == "dispatch"
    ]
    assert dispatch
    assert {s["attrs"]["route"] for s in dispatch} == {"batched"}
    assert {s["attrs"]["driver_route"] for s in dispatch} == {"fused"}


def test_batch_failure_falls_back_per_request(client):
    """A failed fused batch is not evaluated again elsewhere: each of its
    requests gets EvaluationUnavailable, counted as one batch failure,
    and no per-request review runs."""
    calls = {"many": 0, "single": 0}

    class FaultyClient:
        def review_many(self, reviews, tracing=False):
            calls["many"] += 1
            raise RuntimeError("device fault injected")

        def review(self, review, tracing=False):
            calls["single"] += 1
            return client.review(review)

        review_host = review

    batcher = MicroBatcher(FaultyClient(), TARGET, window_ms=1.0)
    batcher.start()
    try:
        futs = [
            batcher.submit(admission_request(pod(f"fb{i}", labels={})))
            for i in range(4)
        ]
        for f in futs:
            with pytest.raises(EvaluationUnavailable,
                               match="device fault injected"):
                f.result(timeout=10)
    finally:
        batcher.stop()
    assert calls["many"] >= 1 and calls["single"] == 0
    assert batcher.batch_failures == calls["many"]
    assert batcher.requests_batched == 0


def test_fault_point_counts_failures_and_opens_breaker(client):
    """The webhook.batch_dispatch fault point fails the fused batch: each
    request gets the fail policy envelope, every failure is counted, and
    after three the breaker opens and turns the next batch away."""
    for fail_policy, allowed, code in (("open", True, 200),
                                       ("closed", False, 503)):
        metrics = MetricsRegistry()
        server = WebhookServer(client, TARGET, window_ms=1.0,
                               metrics=metrics, fail_policy=fail_policy)
        server.start()
        FAULTS.arm("webhook.batch_dispatch", "error")
        try:
            for i in range(4):
                out = post(server, "/v1/admit", admission_request(
                    pod(f"f{i}", labels={"app": "x"}), uid=f"f{i}"))
                resp = out["response"]
                assert resp["allowed"] is allowed
                assert resp["status"].get("code", 200) == code
                assert "admission evaluation unavailable (degraded)" in (
                    resp["status"]["message"]
                )
        finally:
            FAULTS.disarm()
            server.stop()
        assert server.batcher.batch_failures == 3
        assert server.batcher.batches_dispatched == 0
        assert server.batcher.breaker.state == OPEN
        counters = metrics.snapshot()["counters"]
        assert counters["webhook_batch_failures_total"] == 3
        assert counters[
            'webhook_degraded_dispatch_total{plane="validation"}'
        ] == 1
        assert counters[
            "webhook_unavailable_responses_total"
            f'{{plane="validation",policy="{fail_policy}",reason="degraded"}}'
        ] == 4


def test_batcher_submit_after_stop_dispatches_inline(client):
    """submit() racing stop() must not strand the caller's future until
    the request timeout: once the worker is gone, dispatch inline."""
    batcher = MicroBatcher(client, TARGET, window_ms=1.0)
    batcher.start()
    batcher.stop()
    fut = batcher.submit(admission_request(pod("late", labels={})))
    results = fut.result(timeout=5)
    assert any(r.enforcement_action == "deny" for r in results)
    assert batcher.breaker.state == CLOSED


@pytest.mark.parametrize("fail_policy,allowed,code", [
    ("open", True, 200), ("closed", False, 503),
])
def test_full_queue_sheds_per_fail_policy(client, fail_policy, allowed, code):
    """A request the bounded queue cannot take is never evaluated: it is
    shed, counted, and answered with the endpoint's fail policy."""
    metrics = MetricsRegistry()
    server = WebhookServer(client, TARGET, max_queue=0, metrics=metrics,
                           fail_policy=fail_policy)
    resp = server.handler.handle(admission_request(pod(labels={"app": "x"})))
    assert (resp.allowed, resp.code) == (allowed, code)
    assert "queue_full" in resp.message
    assert server.batcher.shed_count == 1
    assert server.batcher.batches_dispatched == 0
    counters = metrics.snapshot()["counters"]
    assert counters[
        'webhook_shed_total{plane="validation",reason="queue_full"}'
    ] == 1


def test_expired_deadline_is_shed_before_dispatch(client):
    server = WebhookServer(client, TARGET, request_timeout=0.0)
    resp = server.handler.handle(admission_request(pod(labels={"app": "x"})))
    assert resp.allowed and "deadline" in resp.message
    assert server.batcher.shed_count == 1
    assert server.batcher.requests_batched == 0


def test_traced_request_bypasses_batcher(client):
    """A request matching a Config trace rule is reviewed on its own
    (traces are per request), with the same verdict."""
    traces = TraceConfig()
    traces.replace([{"user": "alice",
                     "kind": {"group": "", "version": "v1", "kind": "Pod"}}])
    server = WebhookServer(client, TARGET, trace_config=traces)
    resp = server.handler.handle(admission_request(pod(labels={"app": "x"})))
    assert not resp.allowed and "[denied by need-owner]" in resp.message
    assert server.batcher.requests_batched == 0


def test_warmup_then_serve(client):
    server = WebhookServer(client, TARGET, window_ms=1.0)
    assert server.warmup() >= 0.0 and server.warm
    server.start()
    try:
        out = post(server, "/v1/admit", admission_request(
            pod("w", labels={"owner": "o", "team": "t"}), uid="w"))
        assert out["response"] == {"allowed": True, "uid": "w"}
    finally:
        server.stop()


def test_drain_flips_readiness_and_answers_inflight(client):
    """stop() flips readiness first (callbacks fire once), then answers
    every accepted request before the batcher goes."""
    server = WebhookServer(client, TARGET, window_ms=1.0)
    flips = []
    server.on_drain(lambda: flips.append(server.ready))
    server.start()
    reqs = [admission_request(pod(f"d{i}", labels={"app": "x"}), uid=f"d{i}")
            for i in range(8)]
    with ThreadPoolExecutor(max_workers=8) as ex:
        futs = [ex.submit(post, server, "/v1/admit", r) for r in reqs]
        outs = [f.result(timeout=60) for f in futs]
        server.stop(drain_grace_s=0.01)
    assert flips == [False] and not server.ready
    assert [o["response"]["allowed"] for o in outs] == [False] * 8
    server.begin_drain()
    assert flips == [False]


def test_driver_route():
    fused = MicroBatcher(
        Backend(TorchDriver(device="cpu")).new_client(K8sValidationTarget()),
        TARGET,
    )
    assert fused._driver_route() == "fused"
    interp = MicroBatcher(
        Backend(RegoDriver()).new_client(K8sValidationTarget()), TARGET
    )
    assert interp._driver_route() == "interp"


UNPORTED = [
    ("tls", True), ("cert_dir", "certs"), ("rotator", object()),
    ("mutation_system", object()), ("agent_review", True),
    ("agent_mutation_system", object()), ("partitions", 2),
    ("partition_devices", 2), ("attributor", object()), ("replica", "r0"),
    ("corpus", object()), ("integrity", object()), ("recorder", object()),
]


# the driver planes (partitions, cost attribution, integrity), TLS, the
# mutation plane, the corpus plane, the agent plane and the flight
# recorder have their arguments since they were ported; those cases check
# the wiring instead
PORTED = {"partitions", "partition_devices", "attributor", "replica",
          "integrity", "tls", "cert_dir", "rotator", "mutation_system",
          "corpus", "agent_review", "agent_mutation_system", "recorder"}
TLS_ARGS = {"tls", "cert_dir", "rotator"}


@pytest.mark.parametrize("name,value", UNPORTED, ids=[n for n, _ in UNPORTED])
def test_unported_plane_raises(client, name, value, tmp_path):
    """The planes not ported have no arguments: the server cannot be
    built with one and then serve without it. The ported driver planes
    are accepted and handed to the batcher, the partitioner and the
    driver; the TLS arguments make the server serve HTTPS with the
    rotator's pair."""
    from gatekeeper_tpu_torch.integrity import IntegrityPlane
    from gatekeeper_tpu_torch.obs import CostAttributor
    from gatekeeper_tpu_torch.webhook import CertRotator

    if name in TLS_ARGS:
        kw = {"tls": True, "cert_dir": str(tmp_path / "certs")}
        if name == "rotator":
            kw = {"tls": True, "rotator": CertRotator(str(tmp_path / "rot"))}
        server = WebhookServer(client, TARGET, **kw)
        server.start()
        try:
            assert server.scheme == "https"
            assert os.path.exists(server.rotator.cert_path)
            if name == "rotator":
                assert server.rotator is kw["rotator"]
            else:
                assert server.rotator.cert_dir == kw["cert_dir"]
        finally:
            server.stop()
        return
    if name not in PORTED:
        with pytest.raises(TypeError, match=name):
            WebhookServer(client, TARGET, **{name: value})
        return
    kw = {"partitions": 2, name: value}
    if name == "attributor":
        kw[name] = CostAttributor()
    elif name == "integrity":
        kw[name] = IntegrityPlane()
    elif name == "recorder":
        from gatekeeper_tpu_torch.obs import FlightRecorder

        kw[name] = FlightRecorder()
    elif name == "mutation_system":
        from gatekeeper_tpu_torch.mutation import MutationSystem

        kw[name] = MutationSystem(device="cpu")
    elif name == "corpus":
        from gatekeeper_tpu_torch.analysis.corpus import CorpusPlane

        kw[name] = CorpusPlane(client)
    elif name == "agent_mutation_system":
        from gatekeeper_tpu_torch.agentaction import AgentActionTarget
        from gatekeeper_tpu_torch.mutation import MutationSystem

        kw.update(agent_review=True, agent_mutation_system=MutationSystem(
            target_handler=AgentActionTarget(), device="cpu"))
    server = WebhookServer(client, TARGET, **kw)
    server.start()
    try:
        part = server.batcher.partitioner
        assert part is server.partitioner and part.k == 2
        assert server.batcher.breaker is None  # the per-device bank instead
        drv = client._driver
        if name == "partition_devices":
            assert part.devices == (0, 1)
        elif name == "replica":
            assert part.replica == "r0"
        elif name == "attributor":
            assert drv.attributor is kw[name] is part.attributor
        elif name == "integrity":
            assert drv.integrity is kw[name] is server.batcher.integrity
            assert kw[name]._dispatcher is part
        elif name == "mutation_system":
            assert server.mutate_batcher.system is kw[name]
            assert server.mutation_handler.batcher is server.mutate_batcher
        elif name == "corpus":
            assert part.corpus is kw[name]
        elif name == "recorder":
            assert server.recorder is kw[name] is server.batcher.recorder
            assert part.recorder is kw[name]
            assert part.breaker(0).recorder is kw[name]
        elif name in ("agent_review", "agent_mutation_system"):
            from gatekeeper_tpu_torch.agentaction import TARGET_NAME

            assert server.agent_batcher.target == TARGET_NAME
            assert server.agent_handler.batcher is server.agent_batcher
            assert set(server.sched_snapshot()) >= {"validation", "agent"}
            if name == "agent_mutation_system":
                assert server.agent_mutate_batcher.system is kw[name]
                assert server.agent_handler.mutate_batcher is \
                    server.agent_mutate_batcher
            else:
                assert server.agent_mutate_batcher is None
    finally:
        server.stop()


def test_tls_handshake_runs_on_the_connection_thread(client, tmp_path):
    """A client that connects and never starts its TLS handshake holds
    only its own connection's thread: another caller's HTTPS request is
    answered meanwhile (the reference handshakes in accept(), so it would
    wait behind the silent client)."""
    import json
    import socket
    import ssl

    server = WebhookServer(client, TARGET, tls=True,
                           cert_dir=str(tmp_path / "certs"))
    server.start()
    silent = socket.create_connection(("127.0.0.1", server.port))
    try:
        ctx = ssl.create_default_context(cafile=server.rotator.ca_path)
        ctx.check_hostname = False
        body = json.dumps({
            "apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
            "request": admission_request(pod("tls-1"), namespace="default"),
        }).encode()
        req = urllib.request.Request(
            f"https://127.0.0.1:{server.port}/v1/admit", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, context=ctx, timeout=20) as r:
            assert "response" in json.loads(r.read())
    finally:
        silent.close()
        server.stop()


@pytest.mark.parametrize("path", ["/v1/mutate", "/v1/agent/review"])
def test_unported_endpoint_404(client, path):
    server = WebhookServer(client, TARGET)
    server.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            post(server, path, admission_request(pod()))
        assert err.value.code == 404
    finally:
        server.stop()


# -- parity with the JAX package's WebhookServer --------------------------------


def _parity_client(backend, target, driver):
    cl = _load(backend(driver).new_client(target()))
    cl.add_template(template("DenyImage", DENY_IMAGE))
    cl.add_constraint(
        constraint("DenyImage", "no-evil", params={"prefix": "evil/"})
    )
    cl.add_constraint(
        constraint("DenyImage", "warn-docker", params={"prefix": "docker.io/"},
                   enforcement="warn")
    )
    return cl


def _parity_requests():
    reqs = []
    for i in range(40):
        labels = {"app": "x"}
        if i % 2:
            labels["owner"] = "o"
        if i % 3 == 0:
            labels["team"] = "t"
        image = ("evil/img", "docker.io/lib", "nginx")[i % 3]
        ns = ("default", "kube-system", "prod")[i % 3]
        reqs.append(admission_request(
            pod(f"p{i}", ns=ns, labels=labels, image=image),
            namespace=ns, name=f"p{i}", uid=f"pod-{i}",
        ))
    reqs.append(admission_request(
        None, operation="DELETE", old_object=pod("gone", labels={"app": "x"}),
        uid="delete-old",
    ))
    reqs.append(admission_request(None, operation="DELETE", uid="delete-none"))
    reqs.append(admission_request(pod("sa"), username=SERVICE_ACCOUNT, uid="sa"))
    bad = template("BadTempl", "package x\nviolation { true ")
    req = admission_request(bad, uid="bad-template")
    req["kind"] = {"group": "templates.gatekeeper.sh", "version": "v1beta1",
                   "kind": "ConstraintTemplate"}
    reqs.append(req)
    req = admission_request(constraint("NoSuchKind", "c1"), uid="bad-constraint")
    req["kind"] = {"group": "constraints.gatekeeper.sh", "version": "v1beta1",
                   "kind": "NoSuchKind"}
    reqs.append(req)
    return [("/v1/admit", r) for r in reqs] + [
        ("/v1/admitlabel", admission_request(
            {"apiVersion": "v1", "kind": "Namespace",
             "metadata": {"name": n, "labels": {IGNORE_LABEL: "1"}}},
            name=n, uid=f"label-{n}",
        ))
        for n in ("evil", "kube-system")
    ]


def test_parity_with_jax_webhook_server():
    """The same AdmissionReviews, POSTed over HTTP from several threads,
    to the JAX WebhookServer over TpuDriver and the port's over
    TorchDriver(device="cpu"): response bodies equal by uid."""
    exclude = [{"processes": ["webhook"], "excludedNamespaces": ["kube-system"]}]
    j_excluder, t_excluder = JExcluder(), Excluder()
    j_excluder.add(exclude)
    t_excluder.add(exclude)
    servers = {
        "jax": JWebhookServer(
            _parity_client(JBackend, JTarget, TpuDriver()), TARGET,
            window_ms=2.0, excluder=j_excluder,
            exempt_namespaces=["kube-system"],
        ),
        "port": WebhookServer(
            _parity_client(Backend, K8sValidationTarget, TorchDriver(device="cpu")),
            TARGET, window_ms=2.0, excluder=t_excluder,
            exempt_namespaces=["kube-system"],
        ),
    }
    reqs = _parity_requests()
    bodies = {}
    for name, server in servers.items():
        server.start()
        try:
            with ThreadPoolExecutor(max_workers=8) as ex:
                outs = list(ex.map(lambda pr: post(server, *pr), reqs))
        finally:
            server.stop()
        bodies[name] = {o["response"]["uid"]: o for o in outs}
    assert len(bodies["port"]) == len(reqs)
    assert bodies["port"] == bodies["jax"]
    codes = {o["response"].get("status", {}).get("code", 200)
             for o in bodies["port"].values()}
    assert codes == {200, 403, 422, 500}
    assert servers["port"].batcher.batch_failures == 0
    # the 27 pods outside kube-system and the DELETE with an oldObject
    # are evaluated; the rest are answered before the batcher
    assert servers["port"].batcher.requests_batched == 28
