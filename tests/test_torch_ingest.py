"""The port's framed ingest plane (gatekeeper_tpu_torch/ingest) on the CPU:
frame bytes equal to the JAX encode_frame's for every frame type; the
reader and listener cases of tests/test_ingest.py; seeded AdmissionReview
bodies (duplicate keys, NaN, deep nesting, invalid UTF-8 among them)
through both packages' decode_review, giving equal envelopes, routes and
preflattened token rows; framed and HTTP verdicts byte-identical on the
port's WebhookServer over TorchDriver(device="cpu"); and the port's framed
server against the JAX WebhookServer(ingest=True) over TpuDriver, giving
equal response bodies by uid."""

import http.client
import json
import random
import socket
import struct
import threading
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import pytest

from gatekeeper_tpu.constraint import (
    Backend as JBackend,
    K8sValidationTarget as JTarget,
    TpuDriver,
)
from gatekeeper_tpu.control import Excluder as JExcluder
from gatekeeper_tpu.ingest import decode as jdecode
from gatekeeper_tpu.ingest import transport as jtransport
from gatekeeper_tpu.webhook import WebhookServer as JWebhookServer
from gatekeeper_tpu_torch.constraint import Backend, K8sValidationTarget
from gatekeeper_tpu_torch.constraint.torchdriver import TorchDriver
from gatekeeper_tpu_torch.control import Excluder
from gatekeeper_tpu_torch.ingest import decode as tdecode
from gatekeeper_tpu_torch.ingest.decode import (
    DecodeSurprise,
    LazyObject,
    decode_review,
    scan_review,
)
from gatekeeper_tpu_torch.ingest.transport import (
    FRAME_ERROR,
    FRAME_HEADER,
    FRAME_PING,
    FRAME_PONG,
    FRAME_RESPONSE,
    FRAME_VERSION,
    FLAG_DEADLINE,
    BadFrameType,
    BadVersion,
    FrameReader,
    FrameTooLarge,
    PLANE_AGENT,
    PLANE_LABEL,
    PLANE_MUTATE,
    PLANE_VALIDATE,
    ShortFrame,
    StreamClient,
    StreamListener,
    encode_frame,
)
from gatekeeper_tpu_torch.webhook import WebhookServer
from test_torch_webhook import _parity_client, _parity_requests

TARGET = "admission.k8s.gatekeeper.sh"

_PRIV_REGO = """package privileged

violation[{"msg": msg}] {
    c := input.review.object.spec.containers[_]
    c.securityContext.privileged
    msg := sprintf("privileged container %v", [c.name])
}
"""

FRAME_TYPES = {
    "validate": PLANE_VALIDATE, "mutate": PLANE_MUTATE,
    "agent": PLANE_AGENT, "label": PLANE_LABEL,
    "response": FRAME_RESPONSE, "error": FRAME_ERROR,
    "ping": FRAME_PING, "pong": FRAME_PONG,
}


def _template(kind, rego):
    return {
        "apiVersion": "templates.gatekeeper.sh/v1beta1",
        "kind": "ConstraintTemplate",
        "metadata": {"name": kind.lower()},
        "spec": {
            "crd": {"spec": {"names": {"kind": kind}}},
            "targets": [{"target": TARGET, "rego": rego}],
        },
    }


def _review_body(i=0, violating=True, extra_meta=None):
    sc = {"privileged": True} if violating else {}
    meta = {
        "name": f"req{i}",
        "namespace": f"ns{i % 7}",
        "labels": {"app": f"svc{i % 3}"},
    }
    if extra_meta:
        meta.update(extra_meta)
    return json.dumps({
        "apiVersion": "admission.k8s.io/v1",
        "kind": "AdmissionReview",
        "request": {
            "uid": f"uid-{i}",
            "kind": {"group": "", "version": "v1", "kind": "Pod"},
            "operation": "CREATE",
            "name": meta["name"],
            "namespace": meta["namespace"],
            "userInfo": {"username": "ingest-test"},
            "object": {
                "apiVersion": "v1",
                "kind": "Pod",
                "metadata": meta,
                "spec": {
                    "containers": [{
                        "name": "main",
                        "image": "nginx",
                        "securityContext": sc,
                    }],
                },
            },
        },
    }).encode()


@pytest.fixture()
def client():
    cl = Backend(TorchDriver(device="cpu")).new_client(K8sValidationTarget())
    cl.add_template(_template("IngestPriv", _PRIV_REGO))
    cl.add_constraint({
        "apiVersion": "constraints.gatekeeper.sh/v1beta1",
        "kind": "IngestPriv",
        "metadata": {"name": "no-priv"},
        "spec": {"match": {"kinds": [{"apiGroups": [""], "kinds": ["Pod"]}]}},
    })
    return cl


# -- frame codec --------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(FRAME_TYPES))
def test_frame_bytes_equal_the_jax_encoder(name):
    ftype = FRAME_TYPES[name]
    assert ftype == getattr(
        jtransport, {"validate": "PLANE_VALIDATE", "mutate": "PLANE_MUTATE",
                     "agent": "PLANE_AGENT", "label": "PLANE_LABEL"}.get(
            name, f"FRAME_{name.upper()}"))
    rng = random.Random(ftype)
    for _ in range(16):
        payload = bytes(rng.randrange(256)
                        for _ in range(rng.choice([0, 1, 7, 300])))
        rid = rng.randrange(2 ** 64)
        budget = rng.choice([0, 1, 250, 2 ** 32 - 1])
        for flags in (None, 0, FLAG_DEADLINE, 0xFF):
            got = encode_frame(ftype, rid, payload, budget=budget, flags=flags)
            want = jtransport.encode_frame(ftype, rid, payload, budget=budget,
                                           flags=flags)
            assert got == want
    assert FRAME_HEADER.format == jtransport.FRAME_HEADER.format


def test_frame_codec_round_trip_all_planes():
    reader = FrameReader()
    cases = [
        (PLANE_VALIDATE, 1, b'{"a":1}', 250),
        (PLANE_MUTATE, 2, b"x" * 1000, 0),
        (PLANE_AGENT, 3, b"", 50),
        (FRAME_RESPONSE, 4, b"ok", 200),
        (FRAME_ERROR, 5, b"bad", 400),
        (FRAME_PING, 6, b"", 0),
        (FRAME_PONG, 7, b"", 0),
    ]
    wire = b"".join(
        encode_frame(t, rid, payload, budget=b) for t, rid, payload, b in cases
    )
    frames = reader.feed(wire)
    assert reader.pending_bytes() == 0
    assert len(frames) == len(cases)
    for frame, (t, rid, payload, b) in zip(frames, cases):
        assert frame.ftype == t
        assert frame.request_id == rid
        assert bytes(frame.payload) == payload
        assert frame.budget == b
        assert frame.flags == (FLAG_DEADLINE if b else 0)


def test_frame_reader_reassembles_byte_at_a_time():
    body = _review_body(9)
    wire = encode_frame(PLANE_VALIDATE, 77, body, budget=500)
    reader = FrameReader()
    frames = []
    for i in range(len(wire)):
        frames.extend(reader.feed(wire[i:i + 1]))
    assert len(frames) == 1
    assert frames[0].request_id == 77
    assert bytes(frames[0].payload) == body


def test_frame_reader_rejects_malformed():
    with pytest.raises(FrameTooLarge):
        FrameReader(max_frame=1024).feed(
            struct.pack(">I", 1024 + FRAME_HEADER.size + 1)
        )
    with pytest.raises(ShortFrame):
        FrameReader().feed(struct.pack(">I", FRAME_HEADER.size - 1))
    hdr = FRAME_HEADER.pack(FRAME_VERSION + 1, PLANE_VALIDATE, 0, 0, 0, 1)
    with pytest.raises(BadVersion):
        FrameReader().feed(struct.pack(">I", len(hdr)) + hdr)
    hdr = FRAME_HEADER.pack(FRAME_VERSION, 0x7A, 0, 0, 0, 1)
    with pytest.raises(BadFrameType):
        FrameReader().feed(struct.pack(">I", len(hdr)) + hdr)


# -- listener robustness ------------------------------------------------------


def _echo_listener():
    listener = StreamListener(
        lambda frame: (200, bytes(frame.payload)),
        host="127.0.0.1", port=0, max_frame=64 * 1024,
    )
    listener.start()
    return listener


def _serves_ok(listener):
    with StreamClient("127.0.0.1", listener.port) as c:
        status, payload = c.request(b"still-alive", timeout=5.0)
    return status == 200 and payload == b"still-alive"


def test_listener_sheds_malformed_and_keeps_serving():
    listener = _echo_listener()
    try:
        blobs = [
            b"GET / HTTP/1.1\r\n\r\n",
            struct.pack(">I", 10 ** 8),
            struct.pack(">I", 2),
            encode_frame(PLANE_VALIDATE, 1, b"x")[:9],
            FRAME_HEADER.pack(9, PLANE_VALIDATE, 0, 0, 0, 1),
        ]
        for blob in blobs:
            s = socket.create_connection(("127.0.0.1", listener.port))
            try:
                s.sendall(blob)
                s.settimeout(2.0)
                try:
                    s.recv(4096)
                except OSError:
                    pass
            finally:
                s.close()
        assert listener.stats()["protocol_errors_total"] > 0
        assert _serves_ok(listener)
    finally:
        listener.close()


def test_listener_survives_seeded_garbage_fuzz():
    listener = _echo_listener()
    rng = random.Random(1311)
    try:
        for _ in range(60):
            n = rng.randrange(1, 200)
            blob = bytes(rng.randrange(256) for _ in range(n))
            s = socket.create_connection(("127.0.0.1", listener.port))
            try:
                s.sendall(blob)
            except OSError:
                pass
            finally:
                s.close()
        assert _serves_ok(listener)
    finally:
        listener.close()


def test_listener_ping_pong_and_multiplexing():
    listener = _echo_listener()
    try:
        with StreamClient("127.0.0.1", listener.port) as c:
            futs = [
                c.submit(f"payload-{i}".encode(), PLANE_VALIDATE)
                for i in range(32)
            ]
            for i, fut in enumerate(futs):
                status, payload = fut.result(timeout=5.0)
                assert status == 200
                assert payload == f"payload-{i}".encode()
        stats = listener.stats()
        assert stats["frames_total"] >= 32
        assert stats["connections_total"] >= 1
    finally:
        listener.close()


# -- decode: the same envelopes, routes and rows as the JAX decoder -----------


def _rand_value(rng, depth):
    r = rng.random()
    if depth > 3 or r < 0.45:
        return rng.choice([
            rng.randrange(-10 ** 6, 10 ** 6), rng.uniform(-1e3, 1e3),
            10 ** rng.randrange(10, 30), rng.choice([True, False, None]),
            "".join(rng.choice("ab\"\\/\t\nå中\U0001f600 ")
                    for _ in range(rng.randrange(0, 12))),
            "250Mi", "2", "",
        ])
    if r < 0.75:
        return {f"k{rng.randrange(50)}": _rand_value(rng, depth + 1)
                for _ in range(rng.randrange(0, 5))}
    return [_rand_value(rng, depth + 1) for _ in range(rng.randrange(0, 5))]


def _deep(n):
    out = {"leaf": n}
    for i in range(n):
        out = {f"d{i}": [out]} if i % 2 else {f"d{i}": out}
    return out


def _seeded_bodies(seed):
    """AdmissionReview-shaped bodies with seeded object trees; one in six
    each carries duplicate keys, NaN/Infinity, deep nesting, invalid
    UTF-8, or whitespace and escapes the dict path never emits."""
    rng = random.Random(seed)
    out = []
    for i in range(30):
        obj = {
            "apiVersion": rng.choice(["v1", "apps/v1"]),
            "kind": rng.choice(["Pod", "Deployment", "Service"]),
            "metadata": {"name": f"o{i}", "namespace": f"ns{i % 4}",
                         "labels": {"app": f"a{rng.randrange(3)}"}},
            "spec": _rand_value(rng, 0),
        }
        req = {"uid": f"s{seed}-{i}", "operation": "CREATE",
               "kind": {"group": "", "version": "v1", "kind": obj["kind"]},
               "namespace": obj["metadata"]["namespace"],
               "userInfo": {"username": "u"}, "object": obj}
        case = i % 6
        if case == 2:
            obj["spec"] = {"n": float("nan"), "m": rng.choice(
                [float("inf"), float("-inf")])}
        if case == 3:
            obj["spec"] = _deep(rng.randrange(20, 60))
        if rng.random() < 0.3:
            req["oldObject"] = dict(obj, status=_rand_value(rng, 1))
        body = json.dumps({"apiVersion": "admission.k8s.io/v1",
                           "kind": "AdmissionReview", "request": req},
                          ensure_ascii=rng.random() < 0.5).encode()
        if case == 1:
            body = body.replace(b'"operation"', b'"uid": "dup", "operation"', 1)
        elif case == 4:
            body = body.replace(b'"u"}', b'"u\xff\xfe"}', 1)
        elif case == 5:
            body = body.replace(b", ", b" ,\r\n\t", 3).replace(
                b'"app"', b'"\\u0061pp"', 1)
        out.append(body)
    return out


def _outcome(mod, body):
    try:
        review, route, reason = mod.decode_review(body)
    except Exception as e:  # json.loads rejected it: same on both sides
        return ("raised", type(e).__name__, str(e))
    request = review.get("request") or {} if isinstance(review, dict) else {}
    rows = {}
    for k in ("object", "oldObject"):
        v = request.get(k) if isinstance(request, dict) else None
        rows[k] = (type(v).__name__, getattr(v, "_preflat_rows", None))
    text = json.dumps(_deep_materialize(review))
    return (route, reason, rows, text)


def _deep_materialize(x):
    if isinstance(x, dict):
        return {k: _deep_materialize(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_deep_materialize(v) for v in x]
    return x


@pytest.mark.parametrize("seed", range(6))
def test_decode_equals_the_jax_decoder(seed):
    """The same wire bytes give the same route, fallback reason, lazy
    object rows and envelope (key order included) on both packages."""
    routes = set()
    for body in _seeded_bodies(seed):
        got, want = _outcome(tdecode, body), _outcome(jdecode, body)
        assert got == want, body[:120]
        routes.add(got[0])
        if got[0] == "zerocopy":
            assert got[2]["object"][0] == "LazyObject"
            assert got[2]["object"][1]
    assert {"zerocopy", "fallback", "raised"} <= routes


def test_decode_parity_with_json_loads():
    bodies = [_review_body(i, violating=bool(i % 2)) for i in range(8)]
    bodies.append(_review_body(3, extra_meta={"annotations": {
        "unicode": "påd-中文-\U0001f600",
        "escapes": "tab\tnl\nquote\"back\\slash/solidus",
        "controls": "\u0000\u001f",
    }}))
    bodies.extend(json.dumps(doc).encode() for doc in [
        {"numbers": [0, -0, 1e10, -1.5e-7, 0.25, 123456789012345678,
                     3.141592653589793, 1e308]},
        {"empties": [{}, [], "", {"nested": {}}]},
        {"deep": {"a": {"b": {"c": {"d": {"e": [[[[1]]]]}}}}}},
        {"big": "x" * 70000, "after": 1},
        {"request": {"object": None, "oldObject": None}},
    ])
    for body in bodies:
        review, route, reason = decode_review(body)
        assert route in ("zerocopy", "fallback"), (route, body[:60])
        assert _deep_materialize(review) == json.loads(body), body[:80]


def test_decode_rejects_what_json_rejects():
    for bad in (b"", b"{", b'{"a":', b"nope", b'{"a":1}trail', b'[1,2,]'):
        with pytest.raises(ValueError):
            json.loads(bad)
        with pytest.raises(ValueError):
            decode_review(bad)


def test_decode_fallback_on_duplicate_keys_matches_json():
    body = b'{"a": 1, "a": 2, "b": {"c": 3, "c": 4}}'
    with pytest.raises(DecodeSurprise):
        scan_review(body)
    review, route, reason = decode_review(body)
    assert (route, reason) == ("fallback", "dup_key")
    assert review == json.loads(body)


def test_lazy_object_defers_materialization():
    hits = []
    review = scan_review(_review_body(5), on_materialize=lambda: hits.append(1))
    obj = review["request"]["object"]
    assert isinstance(obj, LazyObject)
    assert obj["kind"] == "Pod"
    assert obj["metadata"]["name"] == "req5"
    assert not hits
    assert obj._preflat_rows
    assert obj["spec"]["containers"][0]["image"] == "nginx"
    assert obj["spec"]["containers"][0]["name"] == "main"
    assert hits == [1]


# -- server-level contracts on the port ---------------------------------------


def _start_server(client, **kw):
    server = WebhookServer(
        client, TARGET, window_ms=2.0, request_timeout=30, **kw
    )
    server.start()
    return server


def test_http11_keepalive_reuses_socket(client):
    server = _start_server(client)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.port)
        try:
            fds = []
            for i in range(2):
                conn.request("POST", "/v1/admit", body=_review_body(i),
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                doc = json.loads(resp.read())
                assert resp.status == 200
                assert doc["response"]["uid"] == f"uid-{i}"
                fds.append(conn.sock.fileno())
            assert fds[0] == fds[1]
        finally:
            conn.close()
    finally:
        server.stop()


def test_framed_and_http_verdicts_byte_identical(client):
    server = _start_server(client, ingest=True, sched_policy="deadline")
    try:
        for i, violating in ((0, True), (1, False)):
            body = _review_body(i, violating=violating)
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.port}/v1/admit", data=body,
                headers={"Content-Type": "application/json"}, method="POST",
            )
            with urllib.request.urlopen(req, timeout=30) as resp:
                http_bytes = resp.read()
            with StreamClient("127.0.0.1", server.ingest.port) as c:
                status, framed_bytes = c.request(
                    body, PLANE_VALIDATE, budget_ms=5000, timeout=30.0
                )
            assert status == 200
            assert framed_bytes == http_bytes
            doc = json.loads(framed_bytes)
            assert doc["response"]["allowed"] is (not violating)
        stats = server.ingest.stats()
        assert stats["decode"]["zerocopy"] >= 2
        assert stats["decode"]["fallback"] == 0
        assert server.batcher.batch_failures == 0
        assert server.sched_snapshot()["validation"]["policy"] == "deadline"
    finally:
        server.stop()


def test_ingest_server_fallback_counter(client):
    dup_body = (
        b'{"apiVersion":"admission.k8s.io/v1","kind":"AdmissionReview",'
        b'"request":{"uid":"dup-1","uid":"dup-1",'
        b'"kind":{"group":"","version":"v1","kind":"Pod"},'
        b'"operation":"CREATE",'
        b'"object":{"apiVersion":"v1","kind":"Pod",'
        b'"metadata":{"name":"d","namespace":"ns0"},'
        b'"spec":{"containers":[{"name":"c","image":"nginx"}]}}}}'
    )
    server = _start_server(client, ingest=True)
    try:
        with StreamClient("127.0.0.1", server.ingest.port) as c:
            status, payload = c.request(
                dup_body, PLANE_VALIDATE, budget_ms=5000, timeout=30.0
            )
        assert status == 200
        assert json.loads(payload)["response"]["uid"] == "dup-1"
        assert server.ingest.stats()["decode"]["fallback"] >= 1
    finally:
        server.stop()


@pytest.mark.parametrize("plane,error", [
    (PLANE_MUTATE, "mutation not enabled"),
    (PLANE_AGENT, "agent review not enabled"),
])
def test_unported_plane_frames_answer_404(client, plane, error):
    server = _start_server(client, ingest=True)
    try:
        with StreamClient("127.0.0.1", server.ingest.port) as c:
            status, payload = c.request(_review_body(0), plane, timeout=30.0)
        assert status == 404
        assert json.loads(payload) == {"error": error}
        assert server.batcher.requests_batched == 0
    finally:
        server.stop()


def _agent_client():
    from gatekeeper_tpu_torch.agentaction import AgentActionTarget
    from test_agentaction import SHELL_REGO, agent_constraint, agent_template

    cl = Backend(TorchDriver(device="cpu")).new_client(
        K8sValidationTarget(), AgentActionTarget())
    cl.add_template(agent_template("AgentShellAllowlist", SHELL_REGO))
    cl.add_constraint(agent_constraint(
        "AgentShellAllowlist", "shell-allowlist",
        match={"tools": ["shell.*"]}, params={"allowed": ["ls"]}))
    return cl


def _agent_body(i, command):
    return json.dumps({
        "apiVersion": "agentaction.gatekeeper.sh/v1",
        "kind": "AgentActionReview",
        "request": {"uid": f"call-{i}", "id": f"call-{i}",
                    "agent": f"planner-{i % 3}", "session": "s-1",
                    "tool": ["shell.exec", "net.fetch"][i % 2],
                    "arguments": {"command": command}},
    }).encode()


def test_agent_frames_answered_by_the_agent_plane():
    """With the agent plane on, a framed 'A' request is answered by
    webhook.agent_handler with the bytes /v1/agent/review answers over
    HTTP; with it off, only the agent frame gets the 404."""
    server = _start_server(_agent_client(), ingest=True, agent_review=True)
    try:
        bodies = [_agent_body(i, ["ls", "rm"][i % 3 == 0]) for i in range(12)]
        with StreamClient("127.0.0.1", server.ingest.port) as c:
            framed = [c.request(b, PLANE_AGENT, budget_ms=5000, timeout=30.0)
                      for b in bodies]
        http_out = []
        for b in bodies:
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.port}/v1/agent/review", data=b)
            with urllib.request.urlopen(req, timeout=30) as f:
                http_out.append((f.status, f.read()))
        assert [(st, json.loads(p)) for st, p in framed] == \
            [(st, json.loads(p)) for st, p in http_out]
        allowed = [json.loads(p)["response"]["allowed"] for _, p in framed]
        assert allowed == [not (i % 3 == 0 and i % 2 == 0)
                           for i in range(12)]
        assert server.agent_batcher.requests_batched == 24
        assert server.batcher.requests_batched == 0
    finally:
        server.stop()
    off = _start_server(_agent_client(), ingest=True)
    try:
        with StreamClient("127.0.0.1", off.ingest.port) as c:
            status, payload = c.request(_agent_body(0, "rm"), PLANE_AGENT,
                                        timeout=30.0)
            assert (status, json.loads(payload)) == (
                404, {"error": "agent review not enabled"})
            status, _ = c.request(_review_body(0), PLANE_VALIDATE,
                                  timeout=30.0)
            assert status == 200
    finally:
        off.stop()


def test_stream_client_close_releases_server_connection(client):
    server = _start_server(client, ingest=True)
    try:
        clients = [StreamClient("127.0.0.1", server.ingest.port)
                   for _ in range(4)]
        for i, c in enumerate(clients):
            status, _ = c.request(_review_body(i), PLANE_VALIDATE,
                                  timeout=30.0)
            assert status == 200
        assert server.ingest.stats()["connections_active"] == 4
        for c in clients:
            c.close()
        deadline = 50
        while deadline and server.ingest.stats()["connections_active"]:
            threading.Event().wait(0.1)
            deadline -= 1
        assert server.ingest.stats()["connections_active"] == 0
    finally:
        server.stop()


def test_stop_releases_the_ingest_port(client):
    """After stop() the listener's accept thread has exited and its port
    can be bound again (the JAX listener closes the socket under a thread
    blocked in accept(), which keeps the port bound)."""
    server = _start_server(client, ingest=True)
    port = server.ingest.port
    with StreamClient("127.0.0.1", port) as c:
        assert c.request(_review_body(0), PLANE_VALIDATE, timeout=30.0)[0] == 200
    accept = server.ingest.listener._accept_thread
    server.stop()
    accept.join(timeout=5)
    assert not accept.is_alive()
    with socket.socket() as s:
        s.bind(("127.0.0.1", port))


# -- parity with the JAX package's framed server --------------------------------


_PLANES = {"/v1/admit": PLANE_VALIDATE, "/v1/admitlabel": PLANE_LABEL}


def test_framed_parity_with_jax_webhook_server():
    """The same AdmissionReviews as framed requests over 4 connections,
    8 threads, with frame-header deadlines, to the JAX WebhookServer
    (ingest=True) over TpuDriver and the port's over
    TorchDriver(device="cpu"), both under the deadline policy: response
    bodies equal by uid, every validation frame decoded zero-copy."""
    exclude = [{"processes": ["webhook"], "excludedNamespaces": ["kube-system"]}]
    j_excluder, t_excluder = JExcluder(), Excluder()
    j_excluder.add(exclude)
    t_excluder.add(exclude)
    kw = dict(window_ms=2.0, exempt_namespaces=["kube-system"], ingest=True,
              sched_policy="deadline")
    servers = {
        "jax": JWebhookServer(
            _parity_client(JBackend, JTarget, TpuDriver()), TARGET,
            excluder=j_excluder, **kw),
        "port": WebhookServer(
            _parity_client(Backend, K8sValidationTarget,
                           TorchDriver(device="cpu")), TARGET,
            excluder=t_excluder, **kw),
    }
    frames = [
        (_PLANES[path], json.dumps({"apiVersion": "admission.k8s.io/v1",
                                    "kind": "AdmissionReview",
                                    "request": req}).encode())
        for path, req in _parity_requests()
    ]
    bodies = {}
    for name, server in servers.items():
        server.start()
        conns = [StreamClient("127.0.0.1", server.ingest.port)
                 for _ in range(4)]
        try:
            def send(i):
                plane, body = frames[i]
                status, payload = conns[i % 4].request(
                    body, plane, budget_ms=30_000 + i, timeout=60.0)
                assert status == 200
                return json.loads(payload)

            with ThreadPoolExecutor(max_workers=8) as ex:
                outs = list(ex.map(send, range(len(frames))))
            stats = server.ingest.stats()
        finally:
            for c in conns:
                c.close()
            server.stop()
        bodies[name] = {o["response"]["uid"]: o for o in outs}
        n_label = sum(p == PLANE_LABEL for p, _ in frames)
        assert stats["decode"]["zerocopy"] == len(frames) - n_label
        assert stats["decode"]["legacy"] == n_label
    assert len(bodies["port"]) == len(frames)
    assert bodies["port"] == bodies["jax"]
    assert servers["port"].batcher.batch_failures == 0
    assert servers["port"].batcher.requests_batched == 28
