# Copied from gatekeeper_tpu/webhook/bridge.py; only these edits differ.
# Edit: build_frontend is the port's (native/__init__.py): it builds
# native/bridge_frontend.cpp with g++ (or $CXX) into
# build/gatekeeper_tpu_torch/native/ under a name that carries a hash of the
# source, and a failed build raises with the compiler's output instead of
# returning None (there is no cached binary in ~/.cache and no
# GATEKEEPER_TPU_NATIVE_DIR).
"""Admission serving bridge, Python back half.

Pairs with native/bridge_frontend.cpp (SURVEY §2.4 row 3 / §7 step 5):
the C++ frontend terminates the admission HTTP traffic on native
threads and streams each AdmissionReview body over a Unix socket as
length-prefixed frames; this server parses them, routes through the
SAME micro-batching ValidationHandler the in-process webhook uses (so
concurrent requests coalesce into fused device dispatches), and replies
with the complete AdmissionReview response JSON. A frontend that gets
no reply within its --deadline-ms fails open (the reference's
failurePolicy: Ignore posture; audit is the backstop).

`build_frontend()` compiles the C++ half on demand with the same
lazy-build discipline as the native flattener (source ships, binaries
don't); a failed build raises.
"""

from __future__ import annotations

import json
import os
import socket
import struct
import subprocess
import threading
from typing import Optional

from ..faults import fire
from ..logs import null_logger
from ..native import build_frontend


class BatchBridgeServer:
    """Unix-socket frame server feeding the micro-batching handler.

    Frames carry "<http path>\\n<body>": /v1/admit routes to `handler`,
    /v1/admitlabel to `label_handler` (the ns-label webhook, mirroring
    webhook/server.py's in-process routing)."""

    def __init__(self, handler, socket_path: str, label_handler=None,
                 logger=None):
        self.handler = handler  # ValidationHandler-compatible .handle()
        self.label_handler = label_handler
        self.socket_path = socket_path
        self.log = logger if logger is not None else null_logger()
        self._sock: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.requests_served = 0

    def start(self) -> None:
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(self.socket_path)
        self._sock.listen(1024)
        self._sock.settimeout(0.5)
        self._thread = threading.Thread(target=self._accept, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if self._sock is not None:
            self._sock.close()
            self._sock = None
        if os.path.exists(self.socket_path):
            try:
                os.unlink(self.socket_path)
            except OSError:
                pass

    def _accept(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(
                target=self._serve, args=(conn,), daemon=True
            ).start()

    def _recv_full(self, conn: socket.socket, n: int) -> Optional[bytes]:
        buf = b""
        while len(buf) < n:
            chunk = conn.recv(n - len(buf))
            if not chunk:
                return None
            buf += chunk
        return buf

    def _serve(self, conn: socket.socket) -> None:
        with conn:
            header = self._recv_full(conn, 4)
            if header is None:
                return
            (length,) = struct.unpack("!I", header)
            if length > 64 << 20:
                return
            body = self._recv_full(conn, length)
            if body is None:
                return
            out = self._process(body)
            try:
                conn.sendall(struct.pack("!I", len(out)) + out)
            except OSError:
                pass

    def _process(self, frame: bytes) -> bytes:
        try:
            # named fault point (docs/robustness.md): "error" simulates
            # a backend processing crash (the frame gets the 500 doc and
            # the frontend's --deadline-ms fail-open is the backstop);
            # "hang" a stalled backend worker
            fire("bridge.process")
            path, _, body = frame.partition(b"\n")
            handler = self.handler
            if path == b"/v1/admitlabel" and self.label_handler is not None:
                handler = self.label_handler
            review = json.loads(body)
            request = review.get("request") or {}
            resp = handler.handle(request)
            doc = {
                "apiVersion": review.get(
                    "apiVersion", "admission.k8s.io/v1"
                ),
                "kind": "AdmissionReview",
                "response": resp.to_dict(uid=request.get("uid")),
            }
        except Exception as e:
            self.log.error("bridge request failed", err=e)
            doc = {
                "apiVersion": "admission.k8s.io/v1",
                "kind": "AdmissionReview",
                "response": {
                    "uid": "",
                    "allowed": False,
                    "status": {"code": 500, "message": str(e)},
                },
            }
        self.requests_served += 1
        return json.dumps(doc).encode()


class BridgeStack:
    """Backend + compiled frontend as one unit (tests/bench/demo)."""

    def __init__(
        self,
        client,
        target: str,
        socket_path: str,
        port: int = 0,
        deadline_ms: int = 2000,
        window_ms: float = 2.0,
        exempt_namespaces=(),
        metrics=None,
        tracer=None,
        max_queue=None,
        # admission scheduling (docs/operations.md §Admission
        # scheduling): the bridge rides the same MicroBatcher seam,
        # so the deadline policy + fair-share quotas apply here too
        sched_policy: str = "fifo",
        slo=None,
        attributor=None,
        **handler_kwargs,
    ):
        from .namespacelabel import NamespaceLabelHandler
        from .server import (
            DEFAULT_MAX_QUEUE,
            BatchedValidationHandler,
            MicroBatcher,
        )

        self.batcher = MicroBatcher(
            client, target, window_ms=window_ms,
            metrics=metrics, tracer=tracer,
            max_queue=max_queue if max_queue is not None
            else DEFAULT_MAX_QUEUE,
            sched_policy=sched_policy, slo=slo, attributor=attributor,
        )
        handler_kwargs.setdefault("metrics", metrics)
        handler_kwargs.setdefault("tracer", tracer)
        self.handler = BatchedValidationHandler(
            self.batcher, **handler_kwargs
        )
        self.backend = BatchBridgeServer(
            self.handler,
            socket_path,
            label_handler=NamespaceLabelHandler(exempt_namespaces),
        )
        self.socket_path = socket_path
        self.deadline_ms = deadline_ms
        self.requested_port = port
        self.port: Optional[int] = None
        self._proc: Optional[subprocess.Popen] = None

    def start(self) -> None:
        binary = str(build_frontend())
        self.batcher.start()
        self.backend.start()
        try:
            self._proc = subprocess.Popen(
                [
                    binary,
                    "--port", str(self.requested_port),
                    "--backend", self.socket_path,
                    "--deadline-ms", str(self.deadline_ms),
                ],
                stdout=subprocess.PIPE,
                text=True,
            )
            line = self._proc.stdout.readline().strip()
            if not line.startswith("LISTENING "):
                raise RuntimeError(f"frontend failed to start: {line!r}")
            self.port = int(line.split()[1])
        except Exception:
            # never leak the running batcher/backend (callers invoke
            # start() before entering their try/finally)
            self.stop()
            raise

    def stop(self) -> None:
        if self._proc is not None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self._proc.kill()
            self._proc = None
        self.backend.stop()
        self.batcher.stop()
