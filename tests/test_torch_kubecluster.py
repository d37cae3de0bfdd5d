"""The port's apiserver EventSource and process entry on the CPU.

`gatekeeper_tpu_torch.control.KubeCluster` against tests/test_kubecluster.py's
MockApiServer (imported, not edited): discovery and lists, limit/continue
paging with a 410 on continue, watch streams with resourceVersion replay,
bookmarks, 410 relists and chaos kills, and the apply conflict retry. Then
the port's Runner over that KubeCluster with TLS, CA-bundle injection,
status CRs and v1 Events; the process wiring `build_runner(args,
webhook_tls=False, device="cpu")` held against the JAX package's
build_runner on the same seeded apiserver (equal audit totals, per-
constraint statuses and status CRs); and the webhook's CertRotator through
both certificate generators, answering over HTTPS.
"""

import json
import ssl
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

from test_kubecluster import (
    REQ_LABELS,
    MockApiServer,
    config,
    constraint,
    pod,
    template,
)
from gatekeeper_tpu.control import GVK as JGVK
from gatekeeper_tpu_torch.constraint import Backend, K8sValidationTarget
from gatekeeper_tpu_torch.constraint.torchdriver import TorchDriver
from gatekeeper_tpu_torch.control import (
    ADDED,
    DELETED,
    GVK,
    MODIFIED,
    KubeCluster,
    Runner,
)

TARGET = "admission.k8s.gatekeeper.sh"

DENY_IMAGE = """package denyimage

violation[{"msg": msg}] {
    c := input.review.object.spec.containers[_]
    startswith(c.image, input.parameters.prefix)
    msg := sprintf("container %v uses %v", [c.name, c.image])
}
"""


@pytest.fixture()
def mock():
    m = MockApiServer()
    try:
        yield m
    finally:
        m.close()


def _wait(pred, timeout=10.0, step=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(step)
    return pred()


def _names(events):
    return {(e.obj.get("metadata") or {}).get("name") for e in events}


# -- protocol ----------------------------------------------------------------


def test_discovery_and_list(mock):
    kc = KubeCluster(base_url=mock.url)
    try:
        mock.seed(pod("a", {"x": "1"}))
        mock.seed(pod("b"))
        pods = kc.list(GVK("", "v1", "Pod"))
        assert {p["metadata"]["name"] for p in pods} == {"a", "b"}
        assert all(p["kind"] == "Pod" and p["apiVersion"] == "v1" for p in pods)
        assert kc.get(GVK("", "v1", "Pod"), "default", "a")["metadata"][
            "labels"] == {"x": "1"}
        assert kc.get(GVK("", "v1", "Pod"), "default", "zzz") is None
        gvks = kc.known_gvks()
        assert GVK("", "v1", "Pod") in gvks
        assert GVK("templates.gatekeeper.sh", "v1alpha1",
                   "ConstraintTemplate") in gvks
    finally:
        kc.stop()


def test_list_pagination_and_pages(mock):
    kc = KubeCluster(base_url=mock.url)
    try:
        kc.list_chunk_size = 7
        for i in range(23):
            mock.seed(pod(f"pg{i}"))
        mock.list_requests = 0
        pods = kc.list(GVK("", "v1", "Pod"))
        assert {p["metadata"]["name"] for p in pods} == {
            f"pg{i}" for i in range(23)}
        assert mock.list_requests == 4  # 7+7+7+2
        pages = list(kc.list_pages(GVK("", "v1", "Pod"), 10))
        assert [len(p) for p in pages] == [10, 10, 3]
        assert list(kc.list_pages(GVK("nosuch.group", "v1", "Absent"), 3)) == []
    finally:
        kc.stop()


def test_list_pages_continue_expiry_relists(mock):
    for i in range(7):
        mock.seed(pod(f"x{i}"))
    kc = KubeCluster(base_url=mock.url)
    try:
        mock.expire_continues = 1
        out = list(kc.list_pages(GVK("", "v1", "Pod"), 3))
        assert None in out, "RESTART marker missing"
        fresh = out[out.index(None) + 1:]
        assert {o["metadata"]["name"] for page in fresh for o in page} == {
            f"x{i}" for i in range(7)}
        mock.expire_continues = 2
        with pytest.raises(Exception):
            list(kc.list_pages(GVK("", "v1", "Pod"), 3))
    finally:
        kc.stop()


def test_watch_streams_modified_and_deleted(mock):
    kc = KubeCluster(base_url=mock.url, watch_timeout_seconds=5)
    got = []
    unsub = kc.subscribe(GVK("", "v1", "Pod"), got.append)
    try:
        mock.seed(pod("w1"))
        assert _wait(lambda: "w1" in _names(got))
        mock.seed(pod("w1", {"upd": "1"}))
        mock.remove(pod("w1"))
        assert _wait(lambda: DELETED in [e.type for e in got])
        types = [e.type for e in got if e.obj["metadata"]["name"] == "w1"]
        assert types[0] == ADDED and MODIFIED in types
    finally:
        unsub()
        kc.stop()


def test_watch_resumes_from_bookmark_without_relist(mock):
    mock.bookmark_interval = 0.1
    kc = KubeCluster(base_url=mock.url, watch_timeout_seconds=1)
    got = []
    unsub = kc.subscribe(GVK("", "v1", "Pod"), got.append)
    try:
        mock.seed(pod("b1"))
        assert _wait(lambda: got), "watch never delivered"
        lists_after_boot = mock.list_requests
        time.sleep(2.5)  # two clean server-side closes
        assert mock.list_requests == lists_after_boot
        mock.seed(pod("b2"))
        assert _wait(lambda: _names(got) == {"b1", "b2"})
        assert mock.list_requests == lists_after_boot
    finally:
        unsub()
        kc.stop()


def test_watch_410_relists_without_losing_objects(mock):
    mock.log_retention = 5
    kc = KubeCluster(base_url=mock.url, watch_timeout_seconds=2)
    got = []
    unsub = kc.subscribe(GVK("", "v1", "Pod"), got.append)
    try:
        mock.seed(pod("t0"))
        assert _wait(lambda: got)
        lists_after_boot = mock.list_requests
        mock.fail_watch = 2
        mock.kill_watches()
        for i in range(12):
            mock.seed(pod(f"t{i + 1}"))
        want = {f"t{i}" for i in range(13)}
        assert _wait(lambda: want <= _names(got), timeout=20), (
            want - _names(got))
        assert mock.watch_410s >= 1
        assert mock.list_requests > lists_after_boot
    finally:
        unsub()
        kc.stop()


def test_watch_chaos_kill_reconverges_and_late_crd(mock):
    kc = KubeCluster(base_url=mock.url, watch_timeout_seconds=5)
    got, late_got = [], []
    late = GVK("constraints.gatekeeper.sh", "v1beta1", "K8sLateKind")
    unsub = kc.subscribe(GVK("", "v1", "Pod"), got.append)
    unsub_late = kc.subscribe(late, late_got.append)
    try:
        for i in range(9):
            mock.seed(pod(f"c{i}"))
            if i % 3 == 2:
                mock.kill_watches()
                time.sleep(0.05)
        want = {f"c{i}" for i in range(9)}

        def added():
            return [e.obj["metadata"]["name"] for e in got if e.type == ADDED]

        assert _wait(lambda: want <= set(added()), timeout=20)
        assert len(added()) == len(set(added())), "duplicate ADDED events"
        # a kind served only after the subscription is rediscovered
        assert not late_got
        mock.register(JGVK(*late), "k8slatekinds", False)
        mock.seed({"apiVersion": "constraints.gatekeeper.sh/v1beta1",
                   "kind": "K8sLateKind", "metadata": {"name": "late-1"},
                   "spec": {}})
        assert _wait(lambda: late_got, timeout=20)
        assert late_got[0].type == ADDED
    finally:
        unsub()
        unsub_late()
        kc.stop()


def test_apply_conflict_retry_and_delete(mock):
    kc = KubeCluster(base_url=mock.url)
    try:
        kc.apply(pod("c1", {"v": "1"}))
        kc.apply(pod("c1", {"v": "2"}))  # 409 on POST -> read-modify-PUT
        assert kc.get(GVK("", "v1", "Pod"), "default", "c1")["metadata"][
            "labels"] == {"v": "2"}
        assert kc.delete(pod("c1")) is True
        assert kc.delete(pod("c1")) is False
    finally:
        kc.stop()


# -- the Runner against the apiserver ------------------------------------------


def _admit(port, obj, scheme="http", ctx=None):
    review = {
        "apiVersion": "admission.k8s.io/v1",
        "kind": "AdmissionReview",
        "request": {
            "uid": f"u-{obj['metadata']['name']}",
            "kind": {"group": "", "version": "v1", "kind": "Pod"},
            "operation": "CREATE",
            "name": obj["metadata"]["name"],
            "namespace": obj["metadata"]["namespace"],
            "userInfo": {"username": "tester"},
            "object": obj,
        },
    }
    req = urllib.request.Request(
        f"{scheme}://127.0.0.1:{port}/v1/admit",
        data=json.dumps(review).encode(),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    with urllib.request.urlopen(req, context=ctx, timeout=30) as resp:
        return json.loads(resp.read())["response"]


def test_runner_e2e_tls_status_events_against_apiserver(mock, tmp_path):
    mock.seed(template("K8sRequiredLabels", REQ_LABELS))
    mock.seed(constraint("K8sRequiredLabels", "need-owner",
                         {"labels": ["owner"]}))
    mock.seed(config())
    mock.seed(pod("good", {"owner": "me"}))
    mock.seed(pod("bad"))
    mock.seed({
        "apiVersion": "admissionregistration.k8s.io/v1",
        "kind": "ValidatingWebhookConfiguration",
        "metadata": {"name": "gatekeeper-vwh"},
        "webhooks": [{"name": "validation.gatekeeper.sh", "clientConfig": {}}],
    })
    kc = KubeCluster(base_url=mock.url, watch_timeout_seconds=5)
    client = Backend(TorchDriver(device="cpu")).new_client(K8sValidationTarget())
    runner = Runner(
        kc, client, TARGET, audit_interval=3600.0, readyz_port=0,
        webhook_tls=True, cert_dir=str(tmp_path), vwh_name="gatekeeper-vwh",
        emit_audit_events=True,
    )
    try:
        runner.start()
        assert runner.wait_ready(60), runner.tracker.stats()
        report = runner.audit.audit()
        assert report.total_violations == 1
        st = report.statuses["K8sRequiredLabels/need-owner"]
        assert st.violations[0].name == "bad"
        status_gvk = JGVK("status.gatekeeper.sh", "v1beta1",
                          "ConstraintPodStatus")
        assert _wait(lambda: any(
            (s.get("status") or {}).get("constraintUID")
            == "K8sRequiredLabels/need-owner"
            for s in mock.store.list(status_gvk)))
        vwh = mock.store.list(JGVK("admissionregistration.k8s.io", "v1",
                                   "ValidatingWebhookConfiguration"))[0]
        assert vwh["webhooks"][0]["clientConfig"].get("caBundle")
        assert _wait(lambda: any(
            e.get("reason") == "AuditViolation"
            and (e.get("involvedObject") or {}).get("name") == "bad"
            for e in mock.store.list(JGVK("", "v1", "Event"))))
        # live churn flows watch -> sync -> audit
        mock.seed(pod("bad2"))
        assert _wait(lambda: runner.audit.audit().total_violations == 2,
                     timeout=15, step=0.2)
        # HTTPS admission, verified against the rotator's CA
        ctx = ssl.create_default_context(cafile=runner.webhook.rotator.ca_path)
        ctx.check_hostname = False
        out = _admit(runner.webhook.port, pod("nolabel"), "https", ctx)
        assert out["allowed"] is False
        assert "need-owner" in out["status"]["message"]
    finally:
        runner.stop()
        kc.stop()


def _seed_parity_cluster(m, rng):
    for kind, plural in (("K8sDenyImage", "k8sdenyimages"),):
        m.register(JGVK("constraints.gatekeeper.sh", "v1beta1", kind),
                   plural, False)
    m.seed({"apiVersion": "v1", "kind": "Namespace",
            "metadata": {"name": "default"}})
    m.seed(template("K8sRequiredLabels", REQ_LABELS))
    m.seed(template("K8sDenyImage", DENY_IMAGE))
    m.seed(constraint("K8sRequiredLabels", "need-owner", {"labels": ["owner"]}))
    m.seed(constraint("K8sRequiredLabels", "need-team", {"labels": ["team"]}))
    dry = constraint("K8sDenyImage", "no-latest", {"prefix": "registry.bad/"})
    dry["spec"]["enforcementAction"] = "dryrun"
    m.seed(dry)
    m.seed(constraint("K8sDenyImage", "no-docker", {"prefix": "docker.io/"}))
    m.seed(config())
    images = ["nginx", "docker.io/redis", "registry.bad/app", "quay.io/x"]
    for i in range(40):
        labels = {}
        if rng.random() < 0.5:
            labels["owner"] = "o"
        if rng.random() < 0.5:
            labels["team"] = "t"
        p = pod(f"p{i:02d}", labels)
        p["spec"]["containers"] = [
            {"name": f"c{j}", "image": images[int(rng.integers(4))]}
            for j in range(int(rng.integers(1, 4)))
        ]
        m.seed(p)


def _report_doc(report):
    return (
        report.total_violations,
        dict(report.by_enforcement_action),
        {
            key: (st.total_violations, sorted(
                (v.kind, v.namespace, v.name, v.message, v.enforcement_action)
                for v in st.violations))
            for key, st in sorted(report.statuses.items())
        },
    )


def test_process_wiring_equals_jax_runner(mock):
    """build_runner over TorchDriver(device="cpu") and the JAX package's
    build_runner over TpuDriver, against the same seeded apiserver: equal
    audit totals and per-constraint statuses, in discovery mode (paged
    lists) and from the synced cache, and equal ConstraintPodStatus
    CRs; the metrics server main() wires serves the audit series and
    the tracer's /debug/traces."""
    from gatekeeper_tpu import run as jrun
    from gatekeeper_tpu_torch import run as trun
    from gatekeeper_tpu_torch.metrics import serve_metrics

    _seed_parity_cluster(mock, np.random.default_rng(3))
    argv = ["--kube-url", mock.url, "--audit-interval", "3600",
            "--audit-chunk-size", "7", "--health-addr-port", "0",
            "--log-level", "error", "--operation", "audit",
            "--operation", "status"]
    docs = {}
    for name, mod, kw in (("torch", trun, {"device": "cpu"}),
                          ("tpu", jrun, {})):
        args = mod.build_parser().parse_args(argv + ["--pod-name", name])
        cluster, runner = mod.build_runner(args, webhook_tls=False, **kw)
        try:
            runner.start()
            assert runner.wait_ready(60), runner.tracker.stats()
            assert runner.audit.audit_chunk_size == 7
            disc = _report_doc(runner.audit.audit())
            runner.audit.audit_from_cache = True
            cached = _report_doc(runner.audit.audit())
            crs = sorted(
                (s["status"]["constraintUID"], s["status"]["enforced"],
                 s["status"]["errors"])
                for s in mock.store.list(JGVK(
                    "status.gatekeeper.sh", "v1beta1", "ConstraintPodStatus"))
                if s["status"]["id"] == name
            )
            docs[name] = (disc, cached, crs)
            if name == "torch":
                assert isinstance(runner.client._driver, TorchDriver)
                httpd = serve_metrics(runner.metrics, port=0,
                                      tracer=runner.tracer)
                try:
                    base = f"http://127.0.0.1:{httpd.server_address[1]}"
                    with urllib.request.urlopen(f"{base}/metrics",
                                                timeout=10) as r:
                        text = r.read().decode()
                    assert 'gatekeeper_violations{enforcement_action="deny"}' \
                        in text
                    with urllib.request.urlopen(f"{base}/debug/traces",
                                                timeout=10) as r:
                        assert json.loads(r.read())["traces"]
                finally:
                    httpd.shutdown()
                    httpd.server_close()
        finally:
            runner.stop()
            cluster.stop()
    assert docs["torch"] == docs["tpu"]
    disc, cached, crs = docs["torch"]
    assert disc == cached
    assert disc[0] > 20 and disc[1].get("dryrun", 0) > 0
    assert len(crs) == 4 and all(enf for _, enf, _ in crs)


def test_build_runner_device_none_needs_a_card(mock):
    from gatekeeper_tpu_torch import run as trun

    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present: device=None builds on it")
    args = trun.build_parser().parse_args(["--kube-url", mock.url])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trun.build_runner(args, webhook_tls=False)
    parser = trun.build_parser()
    assert not any(a.startswith("--device")
                   for a in parser._option_string_actions)
    # the fleet plane's shared cert store is the process default, as in
    # the reference
    assert parser.parse_args([]).cert_secret == (
        "gatekeeper-webhook-server-cert")


# -- certificates ------------------------------------------------------------


@pytest.fixture(params=["cryptography", "openssl"])
def generator(request, monkeypatch):
    if request.param == "cryptography":
        pytest.importorskip("cryptography")
    else:
        # the openssl fallback: `import cryptography` fails
        monkeypatch.setitem(sys.modules, "cryptography", None)
    return request.param


def test_cert_rotator_serves_https_and_rotates(generator, tmp_path):
    import datetime

    from gatekeeper_tpu_torch.webhook import CertRotator, WebhookServer

    client = Backend(TorchDriver(device="cpu")).new_client(K8sValidationTarget())
    client.add_template(template("K8sRequiredLabels", REQ_LABELS))
    client.add_constraint(constraint("K8sRequiredLabels", "need-owner",
                                     {"labels": ["owner"]}))
    rot = CertRotator(str(tmp_path))
    server = WebhookServer(client, TARGET, window_ms=1.0, tls=True,
                           rotator=rot)
    try:
        server.start()
        assert server.scheme == "https" and rot.rotations == 1
        ctx = ssl.create_default_context(cafile=rot.ca_path)
        out = _admit(server.port, pod("tls-pod"), "https", ctx)
        assert out["allowed"] is False
        assert "need-owner" in out["status"]["message"]
        exp = CertRotator.pem_expiry(open(rot.cert_path, "rb").read())
        assert exp is not None and exp > datetime.datetime.now(
            datetime.timezone.utc) + datetime.timedelta(days=300)
    finally:
        server.stop()
    rot.ensure()
    assert rot.rotations == 1  # fresh certs: no churn
    future = datetime.datetime.now(datetime.timezone.utc) + \
        datetime.timedelta(days=365 - 30)
    rot2 = CertRotator(str(tmp_path), now=lambda: future)
    rot2.ensure()
    assert rot2.rotations == 1  # inside the 90-day lookahead: rotated


def test_subscribe_delivers_events_from_now_on(mock):
    """The EventSource contract: subscribe delivers events from now on;
    objects that existed before it are the caller's own List to replay
    (the WatchManager's). The reference's watcher emitted them again."""
    for i in range(5):
        mock.seed(pod(f"old{i}"))
    kc = KubeCluster(base_url=mock.url, watch_timeout_seconds=5)
    got = []
    unsub = kc.subscribe(GVK("", "v1", "Pod"), got.append)
    try:
        mock.seed(pod("new"))
        assert _wait(lambda: "new" in _names(got))
        time.sleep(0.3)
        assert _names(got) == {"new"}
    finally:
        unsub()
        kc.stop()


def test_runner_ingests_each_object_once_and_caches_namespaces(mock):
    """Through the Runner over KubeCluster: every synced pod reaches
    add_data exactly once at boot (the Config reconciles once, so no wipe
    lands mid-ingest), and admissions read Namespaces from the
    watch-fed cache, with no apiserver GET per request."""
    from gatekeeper_tpu_torch import run as trun

    mock.seed({"apiVersion": "v1", "kind": "Namespace",
               "metadata": {"name": "default"}})
    mock.seed(template("K8sRequiredLabels", REQ_LABELS))
    mock.seed(constraint("K8sRequiredLabels", "need-owner",
                         {"labels": ["owner"]}))
    mock.seed(config())
    for i in range(30):
        mock.seed(pod(f"p{i}"))
    args = trun.build_parser().parse_args(
        ["--kube-url", mock.url, "--port", "0", "--health-addr-port", "0",
         "--audit-interval", "3600", "--log-level", "error"])
    cluster, runner = trun.build_runner(args, webhook_tls=False, device="cpu")
    adds, wipes, ns_gets = [], [], []
    client = runner.client
    add, remove, get = client.add_data, client.remove_data, cluster.get
    client.add_data = lambda obj: (adds.append(obj["metadata"]["name"]),
                                   add(obj))[1]
    client.remove_data = lambda obj: (wipes.append(obj), remove(obj))[1]
    cluster.get = lambda gvk, ns, name: (
        ns_gets.append(name) if gvk.kind == "Namespace" else None,
        get(gvk, ns, name))[1]
    try:
        runner.start()
        assert runner.wait_ready(60, warm=True), runner.tracker.stats()
        runner.watch_mgr.wait_idle(10)
        assert sorted(adds) == sorted(f"p{i}" for i in range(30))
        assert len(wipes) == 1  # the one Config reconcile's wipe
        del ns_gets[:]  # the first (discovery) sweep reads Namespaces too
        for i in range(3):
            out = _admit(runner.webhook.port, pod(f"admit{i}"))
            assert out["allowed"] is False
        assert ns_gets == []
    finally:
        runner.stop()
        cluster.stop()
