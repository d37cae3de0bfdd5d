"""The port's native HTTP front (gatekeeper_tpu_torch/webhook/bridge.py with
native/bridge_frontend.cpp) on the CPU: the cases of tests/test_bridge.py
on the port's BridgeStack over TorchDriver(device="cpu") — the front built
with g++ from the repo's source into build/gatekeeper_tpu_torch/native/ —
plus response bodies equal, by uid, to the port's HTTP WebhookServer's, and
a failed front build that raises with the compiler's output."""

import json
import socket
import stat
import subprocess
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import pytest

from gatekeeper_tpu_torch import native
from gatekeeper_tpu_torch.constraint import Backend, K8sValidationTarget
from gatekeeper_tpu_torch.constraint.torchdriver import TorchDriver
from gatekeeper_tpu_torch.control import Excluder
from gatekeeper_tpu_torch.webhook import WebhookServer
from gatekeeper_tpu_torch.webhook.bridge import (
    BatchBridgeServer,
    BridgeStack,
    build_frontend,
)
from test_torch_webhook import _parity_client, _parity_requests

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


def make_client():
    client = Backend(TorchDriver(device="cpu")).new_client(K8sValidationTarget())
    client.add_template({
        "apiVersion": "templates.gatekeeper.sh/v1beta1",
        "kind": "ConstraintTemplate",
        "metadata": {"name": "k8srequiredlabels"},
        "spec": {
            "crd": {"spec": {"names": {"kind": "K8sRequiredLabels"}}},
            "targets": [{"target": TARGET, "rego": REQ_LABELS}],
        },
    })
    client.add_constraint({
        "apiVersion": "constraints.gatekeeper.sh/v1beta1",
        "kind": "K8sRequiredLabels",
        "metadata": {"name": "need-owner"},
        "spec": {
            "match": {"kinds": [{"apiGroups": [""], "kinds": ["Pod"]}]},
            "parameters": {"labels": ["owner"]},
        },
    })
    return client


def review_body(i, labels):
    return json.dumps({
        "apiVersion": "admission.k8s.io/v1",
        "kind": "AdmissionReview",
        "request": {
            "uid": f"uid-{i}",
            "kind": {"group": "", "version": "v1", "kind": "Pod"},
            "operation": "CREATE",
            "name": f"p{i}",
            "namespace": "default",
            "userInfo": {"username": "t"},
            "object": {
                "apiVersion": "v1",
                "kind": "Pod",
                "metadata": {"name": f"p{i}", "namespace": "default",
                             "labels": labels},
                "spec": {"containers": [{"name": "c", "image": "nginx"}]},
            },
        },
    }).encode()


def post(port, body, path="/v1/admit"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body,
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def _frontend(sock, deadline_ms):
    proc = subprocess.Popen(
        [str(build_frontend()), "--port", "0", "--backend", sock,
         "--deadline-ms", str(deadline_ms)],
        stdout=subprocess.PIPE, text=True,
    )
    return proc, int(proc.stdout.readline().split()[1])


def _stop(proc):
    proc.terminate()
    try:
        proc.wait(timeout=5)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    proc.stdout.close()


def test_frontend_builds_from_the_repo_source():
    exe = build_frontend()
    assert exe.parent == native.NATIVE_DIR
    assert exe.name.startswith("bridge_frontend_")
    assert exe.stat().st_mode & stat.S_IXUSR
    assert build_frontend() == exe  # built once, then reused


def test_frontend_build_failure_raises(monkeypatch, tmp_path):
    cxx = tmp_path / "failing-cxx"
    cxx.write_text(
        "#!/bin/sh\necho 'bridge_frontend.cpp:1: error: boom' >&2\nexit 4\n")
    cxx.chmod(cxx.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CXX", str(cxx))
    with pytest.raises(RuntimeError, match="error: boom") as exc:
        build_frontend(tmp_path / "build")
    assert "rc 4" in str(exc.value)
    assert not list((tmp_path / "build").iterdir())
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-cxx"))
    with pytest.raises(RuntimeError, match="cannot run the C\\+\\+ compiler"):
        build_frontend(tmp_path / "build")


def test_bridge_end_to_end(tmp_path):
    stack = BridgeStack(
        make_client(), TARGET, str(tmp_path / "gk.sock"), deadline_ms=30000,
        sched_policy="deadline",
    )
    stack.start()
    try:
        deny = post(stack.port, review_body(1, {}))
        assert deny["response"]["allowed"] is False
        assert "need-owner" in deny["response"]["status"]["message"]
        assert deny["response"]["uid"] == "uid-1"
        allow = post(stack.port, review_body(2, {"owner": "me"}))
        assert allow["response"]["allowed"] is True
        with urllib.request.urlopen(
            f"http://127.0.0.1:{stack.port}/healthz", timeout=10
        ) as r:
            assert json.loads(r.read())["ok"] is True
        stack.batcher.batches_dispatched = 0
        stack.batcher.requests_batched = 0
        with ThreadPoolExecutor(max_workers=32) as ex:
            outs = list(ex.map(
                lambda i: post(stack.port, review_body(100 + i, {})),
                range(64)))
        assert all(o["response"]["allowed"] is False for o in outs)
        assert stack.backend.requests_served >= 66
        assert (stack.batcher.requests_batched
                > stack.batcher.batches_dispatched)
        assert stack.batcher.batch_failures == 0
        assert stack.batcher._driver_route() == "fused"
    finally:
        stack.stop()
    assert not (tmp_path / "gk.sock").exists()


def test_bridge_fails_open_on_deadline(tmp_path):
    class StallingHandler:
        def handle(self, request):
            time.sleep(5.0)
            raise AssertionError("unreachable in this test window")

    sock = str(tmp_path / "stall.sock")
    backend = BatchBridgeServer(StallingHandler(), sock)
    backend.start()
    proc, port = _frontend(sock, 400)
    try:
        t0 = time.monotonic()
        out = post(port, review_body(7, {}))
        elapsed = time.monotonic() - t0
        assert out["response"]["allowed"] is True
        assert out["response"]["uid"] == "uid-7"
        assert "failing open" in " ".join(out["response"].get("warnings", []))
        assert elapsed < 3.0, f"deadline not enforced ({elapsed:.1f}s)"
    finally:
        _stop(proc)
        backend.stop()


def test_bridge_fails_open_when_backend_down(tmp_path):
    proc, port = _frontend(str(tmp_path / "nonexistent.sock"), 500)
    try:
        out = post(port, review_body(9, {}))
        assert out["response"]["allowed"] is True
        assert out["response"]["uid"] == "uid-9"
    finally:
        _stop(proc)


def test_bridge_fail_open_uid_ignores_nested_uids(tmp_path):
    proc, port = _frontend(str(tmp_path / "nonexistent.sock"), 500)
    try:
        body = json.dumps({
            "apiVersion": "admission.k8s.io/v1",
            "kind": "AdmissionReview",
            "request": {
                "kind": {"group": "", "version": "v1", "kind": "Pod"},
                "object": {"metadata": {"name": "p",
                                        "uid": "WRONG-object-uid"}},
                "oldObject": {"metadata": {"uid": "WRONG-old-uid"}},
                "uid": "the-request-uid",
            },
        }).encode()
        out = post(port, body)
        assert out["response"]["allowed"] is True
        assert out["response"]["uid"] == "the-request-uid"
    finally:
        _stop(proc)


def _http_req(body):
    return (
        b"POST /v1/admit HTTP/1.1\r\n"
        b"Host: x\r\nContent-Type: application/json\r\n"
        b"Content-Length: " + str(len(body)).encode() + b"\r\n"
        b"Connection: keep-alive\r\n\r\n" + body
    )


def _http_bodies(data: bytes):
    """Complete HTTP response bodies parsed from a byte stream."""
    out = []
    rest = data
    while True:
        sep = rest.find(b"\r\n\r\n")
        if sep < 0:
            return out
        head = rest[:sep].decode("latin-1").lower()
        cl = 0
        for line in head.split("\r\n"):
            if line.startswith("content-length:"):
                cl = int(line.split(":", 1)[1].strip())
        body_start = sep + 4
        if len(rest) < body_start + cl:
            return out
        out.append(rest[body_start:body_start + cl])
        rest = rest[body_start + cl:]


def test_bridge_keep_alive_pipelined_requests(tmp_path):
    stack = BridgeStack(
        make_client(), TARGET, str(tmp_path / "gp.sock"),
        deadline_ms=30000, request_timeout=60,
    )
    stack.start()
    try:
        payload = _http_req(review_body(1, {})) + _http_req(
            review_body(2, {"owner": "me"}))
        with socket.create_connection(("127.0.0.1", stack.port), 30) as s:
            s.sendall(payload)
            s.settimeout(30)
            data = b""
            uids = []
            while len(uids) < 2:
                chunk = s.recv(65536)
                assert chunk, f"connection closed early; got {data!r}"
                data += chunk
                uids = [json.loads(part)["response"]["uid"]
                        for part in _http_bodies(data)]
        assert uids == ["uid-1", "uid-2"]
    finally:
        stack.stop()


def test_bridge_rejects_chunked_encoding(tmp_path):
    stack = BridgeStack(
        make_client(), TARGET, str(tmp_path / "gc.sock"),
        deadline_ms=30000, request_timeout=60,
    )
    stack.start()
    try:
        with socket.create_connection(("127.0.0.1", stack.port), 30) as s:
            s.sendall(
                b"POST /v1/admit HTTP/1.1\r\nHost: x\r\n"
                b"Transfer-Encoding: chunked\r\n\r\n"
                b"5\r\nhello\r\n0\r\n\r\n"
            )
            s.settimeout(30)
            data = s.recv(65536)
        assert data.startswith(b"HTTP/1.1 501")
    finally:
        stack.stop()


def test_bridge_routes_admitlabel(tmp_path):
    stack = BridgeStack(
        make_client(), TARGET, str(tmp_path / "gl.sock"),
        deadline_ms=30000, exempt_namespaces=["exempt-ns"],
    )
    stack.start()
    try:
        def label_review(ns, labels):
            return json.dumps({
                "apiVersion": "admission.k8s.io/v1",
                "kind": "AdmissionReview",
                "request": {
                    "uid": "lu",
                    "kind": {"group": "", "version": "v1",
                             "kind": "Namespace"},
                    "operation": "CREATE",
                    "name": ns,
                    "object": {"apiVersion": "v1", "kind": "Namespace",
                               "metadata": {"name": ns, "labels": labels}},
                },
            }).encode()

        deny = post(stack.port, label_review(
            "app-ns", {"admission.gatekeeper.sh/ignore": "yes"}),
            path="/v1/admitlabel")
        assert deny["response"]["allowed"] is False
        ok = post(stack.port, label_review(
            "exempt-ns", {"admission.gatekeeper.sh/ignore": "yes"}),
            path="/v1/admitlabel")
        assert ok["response"]["allowed"] is True
    finally:
        stack.stop()


def test_bridge_bodies_equal_the_http_webhook_server(tmp_path):
    """The same AdmissionReviews from 8 threads to the port's HTTP
    WebhookServer and, through the C++ front, to a BridgeStack over an
    equal client: response bodies equal by uid. The bridge's envelope
    carries no traceId (the reference's bridge frame has no trace
    context), so that one key is set aside."""
    exclude = [{"processes": ["webhook"], "excludedNamespaces": ["kube-system"]}]

    def excluder():
        e = Excluder()
        e.add(exclude)
        return e

    def fresh_client():
        return _parity_client(Backend, K8sValidationTarget,
                              TorchDriver(device="cpu"))

    reqs = _parity_requests()
    bodies = [
        (path, json.dumps({"apiVersion": "admission.k8s.io/v1",
                           "kind": "AdmissionReview",
                           "request": req}).encode())
        for path, req in reqs
    ]
    server = WebhookServer(fresh_client(), TARGET, window_ms=2.0,
                           excluder=excluder(),
                           exempt_namespaces=["kube-system"])
    stack = BridgeStack(fresh_client(), TARGET, str(tmp_path / "gb.sock"),
                        deadline_ms=60_000, excluder=excluder(),
                        exempt_namespaces=["kube-system"])
    out = {}
    for name, port, start, stop in (
        ("http", lambda: server.port, server.start, server.stop),
        ("bridge", lambda: stack.port, stack.start, stack.stop),
    ):
        start()
        try:
            with ThreadPoolExecutor(max_workers=8) as ex:
                docs = list(ex.map(
                    lambda pb: post(port(), pb[1], path=pb[0]), bodies))
        finally:
            stop()
        out[name] = {d["response"]["uid"]: d for d in docs}
    for d in out["http"].values():
        assert d.pop("traceId")
    assert len(out["bridge"]) == len(reqs)
    assert out["bridge"] == out["http"]
    assert not any("warnings" in d["response"] and "failing open" in
                   " ".join(d["response"]["warnings"])
                   for d in out["bridge"].values())
    assert stack.batcher.requests_batched == 28
    assert stack.batcher.batch_failures == 0
