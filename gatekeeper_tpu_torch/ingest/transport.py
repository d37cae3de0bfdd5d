# Copied from gatekeeper_tpu/ingest/transport.py; only this edit differs.
# Edit: StreamListener.stop_accepting shuts the listening socket down before
# closing it. close() alone leaves the accept thread blocked in accept(),
# which keeps the socket listening and its port bound after the server has
# stopped; shutdown() wakes accept() (EINVAL) and the thread exits.
"""Framed streaming transport (docs/ingest.md §Wire format).

The legacy front door is stdlib `ThreadingHTTPServer`: one TCP
connection, one thread, one full HTTP parse per admission. At the
rates the accelerated evaluator sustains, connection setup and header
parsing dominate. This module is the replacement path: persistent
multiplexed connections carrying length-prefixed frames, so thousands
of in-flight admissions share a handful of sockets.

Wire format — every frame is:

    u32 big-endian  length of (header + payload)
    16-byte header  struct ">BBBBIQ":
        u8   version        (FRAME_VERSION = 1)
        u8   frame type     request plane tag or response/error/ping
        u8   flags          FLAG_DEADLINE: budget field is meaningful
        u8   reserved       (0 on the wire)
        u32  budget         request: deadline budget in ms from frame
                            arrival; response: HTTP-equivalent status
        u64  request id     client-chosen correlation id
    payload             request: AdmissionReview JSON bytes
                        response: envelope JSON bytes

Request planes mirror the legacy URL map: 'V' /v1/admit,
'M' /v1/mutate, 'A' /v1/agent/review, 'L' /v1/admitlabel.

Flow control: the per-connection reader thread blocks once
`max_inflight` frames from that connection are being served — TCP
backpressure does the rest. Bounds (`max_frame`, `max_inflight`) and
typed `ProtocolError`s shed the offending CONNECTION (best-effort
error frame, then close); a malformed peer can never take the
listener down.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
import time as _time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

__all__ = [
    "BadFrameType",
    "BadVersion",
    "DEFAULT_MAX_FRAME",
    "DEFAULT_MAX_INFLIGHT",
    "FLAG_DEADLINE",
    "FRAME_ERROR",
    "FRAME_HEADER",
    "FRAME_PING",
    "FRAME_PONG",
    "FRAME_RESPONSE",
    "FRAME_VERSION",
    "Frame",
    "FrameReader",
    "FrameTooLarge",
    "PLANE_AGENT",
    "PLANE_LABEL",
    "PLANE_MUTATE",
    "PLANE_VALIDATE",
    "ProtocolError",
    "REQUEST_PLANES",
    "ShortFrame",
    "StreamClient",
    "StreamListener",
    "encode_frame",
]

FRAME_VERSION = 1
FRAME_HEADER = struct.Struct(">BBBBIQ")
_LEN_PREFIX = struct.Struct(">I")

PLANE_VALIDATE = 0x56  # 'V' -> /v1/admit
PLANE_MUTATE = 0x4D    # 'M' -> /v1/mutate
PLANE_AGENT = 0x41     # 'A' -> /v1/agent/review
PLANE_LABEL = 0x4C     # 'L' -> /v1/admitlabel
FRAME_RESPONSE = 0x52  # 'R'
FRAME_ERROR = 0x45     # 'E'
FRAME_PING = 0x50      # 'P'
FRAME_PONG = 0x51      # 'Q'

REQUEST_PLANES: Dict[int, str] = {
    PLANE_VALIDATE: "validation",
    PLANE_MUTATE: "mutation",
    PLANE_AGENT: "agent",
    PLANE_LABEL: "label",
}
_KNOWN_TYPES = frozenset(REQUEST_PLANES) | {
    FRAME_RESPONSE, FRAME_ERROR, FRAME_PING, FRAME_PONG,
}

FLAG_DEADLINE = 0x01

DEFAULT_MAX_FRAME = 4 * 1024 * 1024  # payload bound, bytes
DEFAULT_MAX_INFLIGHT = 256           # frames being served, per conn


class ProtocolError(Exception):
    """Wire-level violation: sheds the connection, never the
    listener. `code` slugs label `ingest_protocol_errors_total`."""

    code = "protocol"


class FrameTooLarge(ProtocolError):
    code = "frame_too_large"


class ShortFrame(ProtocolError):
    code = "short_frame"


class BadVersion(ProtocolError):
    code = "bad_version"


class BadFrameType(ProtocolError):
    code = "bad_frame_type"


class TruncatedStream(ProtocolError):
    code = "truncated_stream"


class InflightExceeded(ProtocolError):
    code = "inflight_exceeded"


class Frame(NamedTuple):
    ftype: int
    flags: int
    budget: int       # request: deadline ms; response: status code
    request_id: int
    payload: memoryview


def encode_frame(
    ftype: int,
    request_id: int,
    payload: bytes = b"",
    budget: int = 0,
    flags: Optional[int] = None,
) -> bytes:
    """One wire frame (length prefix + header + payload)."""
    if flags is None:
        flags = FLAG_DEADLINE if budget else 0
    hdr = FRAME_HEADER.pack(
        FRAME_VERSION, ftype, flags, 0, budget, request_id
    )
    return _LEN_PREFIX.pack(FRAME_HEADER.size + len(payload)) + hdr + payload


class FrameReader:
    """Incremental frame parser — feed it whatever recv() returned,
    get back every complete frame. One per connection; a raised
    ProtocolError poisons the reader and the connection is shed."""

    def __init__(self, max_frame: int = DEFAULT_MAX_FRAME):
        self._buf = bytearray()
        self.max_frame = max_frame

    def pending_bytes(self) -> int:
        return len(self._buf)

    def feed(self, data: bytes) -> List[Frame]:
        self._buf += data
        frames: List[Frame] = []
        buf = self._buf
        while True:
            if len(buf) < 4:
                break
            length = int.from_bytes(buf[:4], "big")
            if length < FRAME_HEADER.size:
                raise ShortFrame(f"frame length {length}")
            if length > self.max_frame + FRAME_HEADER.size:
                raise FrameTooLarge(f"frame length {length}")
            if len(buf) < 4 + length:
                break
            mv = memoryview(buf)
            blob = bytes(mv[4:4 + length])
            mv.release()
            del buf[:4 + length]
            version, ftype, flags, _, budget, rid = FRAME_HEADER.unpack_from(
                blob, 0
            )
            if version != FRAME_VERSION:
                raise BadVersion(f"version {version}")
            if ftype not in _KNOWN_TYPES:
                raise BadFrameType(f"type 0x{ftype:02x}")
            frames.append(
                Frame(
                    ftype, flags, budget, rid,
                    memoryview(blob)[FRAME_HEADER.size:],
                )
            )
        return frames


class _Conn:
    __slots__ = ("sock", "addr", "wlock", "cv", "inflight", "open")

    def __init__(self, sock: socket.socket, addr):
        self.sock = sock
        self.addr = addr
        self.wlock = threading.Lock()
        self.cv = threading.Condition()
        self.inflight = 0
        self.open = True


class StreamListener:
    """Accept loop + one reader thread per connection + a shared
    worker pool running `frame_handler(frame) -> (status, payload)`
    for each request frame. Responses are written back on the frame's
    connection under a per-connection write lock (frames from one
    socket complete out of order; the request id correlates)."""

    def __init__(
        self,
        frame_handler: Callable[[Frame], Tuple[int, bytes]],
        host: str = "127.0.0.1",
        port: int = 0,
        max_frame: int = DEFAULT_MAX_FRAME,
        max_inflight: int = DEFAULT_MAX_INFLIGHT,
        workers: int = 64,
        metrics=None,
        backlog: int = 512,
    ):
        self.frame_handler = frame_handler
        self.max_frame = max_frame
        self.max_inflight = max_inflight
        self.metrics = metrics
        self._lock = threading.Lock()
        self._conns: Dict[int, _Conn] = {}
        self._next_conn = 0
        self._stopping = False
        self._stats = {
            "connections_total": 0,
            "frames_total": 0,
            "protocol_errors_total": 0,
            "bytes_in": 0,
            "bytes_out": 0,
            "shed_connections": 0,
        }
        self._pool = ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="ingest-worker"
        )
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(backlog)
        self.host, self.port = self._sock.getsockname()[:2]
        self._accept_thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="ingest-accept", daemon=True
        )
        self._accept_thread.start()

    def stop_accepting(self) -> None:
        with self._lock:
            self._stopping = True
        # shutdown BEFORE close, as for connections: it wakes the accept
        # thread blocked in accept(), which would otherwise keep the
        # listening socket (and its port) alive
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass

    def drain(self, timeout: float = 2.0) -> bool:
        """Wait (bounded) until no frame is being served — the last
        step between the webhook's own inflight wait and the response
        WRITE, which happens on the pool after the handler returns."""
        deadline = _time.monotonic() + timeout
        while _time.monotonic() < deadline:
            with self._lock:
                busy = any(
                    c.inflight > 0 for c in self._conns.values()
                )
            if not busy:
                return True
            _time.sleep(0.01)
        return False

    def close(self) -> None:
        """Full stop: no new connections, shed the live ones, drain
        the pool. Callers wanting graceful drain wait on their own
        inflight accounting first (webhook/server.py does)."""
        self.stop_accepting()
        self.drain()
        with self._lock:
            conns = list(self._conns.values())
        for conn in conns:
            self._close_conn(conn)
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=2.0)
        self._pool.shutdown(wait=False)

    # -- stats / metrics -----------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out = dict(self._stats)
            out["connections_active"] = len(self._conns)
            out["inflight"] = sum(c.inflight for c in self._conns.values())
        return out

    def _bump(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._stats[key] += n

    def _gauge_conns(self) -> None:
        if self.metrics is not None:
            with self._lock:
                n = len(self._conns)
            self.metrics.gauge("ingest_connections_active", n)

    # -- accept / read -------------------------------------------------------

    def _accept_loop(self) -> None:
        while True:
            try:
                sock, addr = self._sock.accept()
            except OSError:
                return  # listening socket closed
            with self._lock:
                if self._stopping:
                    try:
                        sock.close()
                    except OSError:
                        pass
                    return
                cid = self._next_conn
                self._next_conn += 1
                conn = _Conn(sock, addr)
                self._conns[cid] = conn
                self._stats["connections_total"] += 1
            try:
                sock.setsockopt(
                    socket.IPPROTO_TCP, socket.TCP_NODELAY, 1
                )
            except OSError:
                pass
            if self.metrics is not None:
                self.metrics.record("ingest_connections_total", 1)
            self._gauge_conns()
            threading.Thread(
                target=self._conn_loop,
                args=(cid, conn),
                name=f"ingest-conn-{cid}",
                daemon=True,
            ).start()

    def _conn_loop(self, cid: int, conn: _Conn) -> None:
        reader = FrameReader(self.max_frame)
        try:
            while conn.open:
                try:
                    data = conn.sock.recv(65536)
                except OSError:
                    break
                if not data:
                    if reader.pending_bytes():
                        raise TruncatedStream(
                            f"{reader.pending_bytes()} bytes"
                        )
                    break
                self._bump("bytes_in", len(data))
                if self.metrics is not None:
                    self.metrics.record(
                        "ingest_bytes_total", len(data), direction="in"
                    )
                for frame in reader.feed(data):
                    self._dispatch(conn, frame)
        except ProtocolError as e:
            self._shed(conn, e)
        except Exception:
            self._close_conn(conn)
        finally:
            with self._lock:
                self._conns.pop(cid, None)
            self._close_conn(conn)
            self._gauge_conns()

    def _dispatch(self, conn: _Conn, frame: Frame) -> None:
        if frame.ftype == FRAME_PING:
            self._send(
                conn, encode_frame(FRAME_PONG, frame.request_id)
            )
            return
        if frame.ftype not in REQUEST_PLANES:
            # a response/error frame arriving at the listener is a
            # confused peer — shed it
            raise BadFrameType(f"0x{frame.ftype:02x} at listener")
        self._bump("frames_total")
        if self.metrics is not None:
            self.metrics.record(
                "ingest_frames_total", 1,
                plane=REQUEST_PLANES[frame.ftype],
            )
        # flow control: block the reader (and, through TCP, the peer)
        # once this connection has max_inflight frames being served
        with conn.cv:
            while conn.inflight >= self.max_inflight and conn.open:
                conn.cv.wait(timeout=1.0)
            if not conn.open:
                return
            conn.inflight += 1
        self._pool.submit(self._serve_one, conn, frame)

    # -- serve / write -------------------------------------------------------

    def _serve_one(self, conn: _Conn, frame: Frame) -> None:
        try:
            try:
                status, payload = self.frame_handler(frame)
            except Exception as e:  # app error == HTTP 500, not a shed
                status, payload = 500, json.dumps(
                    {"error": str(e)}
                ).encode("utf-8")
            self._send(
                conn,
                encode_frame(
                    FRAME_RESPONSE, frame.request_id, payload,
                    budget=status, flags=0,
                ),
            )
        finally:
            with conn.cv:
                conn.inflight -= 1
                conn.cv.notify()

    def _send(self, conn: _Conn, data: bytes) -> None:
        try:
            with conn.wlock:
                conn.sock.sendall(data)
            self._bump("bytes_out", len(data))
            if self.metrics is not None:
                self.metrics.record(
                    "ingest_bytes_total", len(data), direction="out"
                )
        except OSError:
            self._close_conn(conn)

    def _shed(self, conn: _Conn, exc: ProtocolError) -> None:
        self._bump("protocol_errors_total")
        self._bump("shed_connections")
        if self.metrics is not None:
            self.metrics.record(
                "ingest_protocol_errors_total", 1, code=exc.code
            )
        try:  # best-effort error frame; the peer may already be gone
            self._send(
                conn,
                encode_frame(
                    FRAME_ERROR, 0,
                    json.dumps({"error": exc.code}).encode("utf-8"),
                    budget=400, flags=0,
                ),
            )
        except Exception:
            pass
        self._close_conn(conn)

    def _close_conn(self, conn: _Conn) -> None:
        with conn.cv:
            conn.open = False
            conn.cv.notify_all()
        # shutdown BEFORE close: close() alone leaves the kernel file
        # description alive while the reader thread is blocked in
        # recv() on it, so no FIN ever reaches the peer and the
        # connection leaks on both sides
        try:
            conn.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            conn.sock.close()
        except OSError:
            pass


class StreamClient:
    """One multiplexed connection to a StreamListener. `submit()`
    returns a Future resolving to (status, payload bytes); a reader
    thread correlates responses by request id. Used by the bench
    lane, the soak harness's framed transport, and the tests."""

    def __init__(
        self,
        host: str,
        port: int,
        max_frame: int = DEFAULT_MAX_FRAME,
        connect_timeout: float = 10.0,
    ):
        self._sock = socket.create_connection(
            (host, port), timeout=connect_timeout
        )
        self._sock.settimeout(None)
        try:
            self._sock.setsockopt(
                socket.IPPROTO_TCP, socket.TCP_NODELAY, 1
            )
        except OSError:
            pass
        self._wlock = threading.Lock()
        self._plock = threading.Lock()
        self._pending: Dict[int, Future] = {}
        self._next_id = 1
        self._closed = False
        self._reader = FrameReader(max_frame)
        self._thread = threading.Thread(
            target=self._read_loop, name="ingest-client", daemon=True
        )
        self._thread.start()

    def submit(
        self,
        payload: bytes,
        plane: int = PLANE_VALIDATE,
        budget_ms: int = 0,
    ) -> "Future[Tuple[int, bytes]]":
        fut: Future = Future()
        with self._plock:
            if self._closed:
                raise ConnectionError("stream client closed")
            rid = self._next_id
            self._next_id += 1
            self._pending[rid] = fut
        data = encode_frame(plane, rid, payload, budget=budget_ms)
        try:
            with self._wlock:
                self._sock.sendall(data)
        except OSError as e:
            with self._plock:
                self._pending.pop(rid, None)
            raise ConnectionError(str(e))
        return fut

    def request(
        self,
        payload: bytes,
        plane: int = PLANE_VALIDATE,
        budget_ms: int = 0,
        timeout: Optional[float] = 30.0,
    ) -> Tuple[int, bytes]:
        return self.submit(payload, plane, budget_ms).result(timeout)

    def _read_loop(self) -> None:
        try:
            while True:
                data = self._sock.recv(65536)
                if not data:
                    raise ConnectionError("stream closed by peer")
                for frame in self._reader.feed(data):
                    if frame.ftype == FRAME_PONG:
                        continue
                    if frame.ftype == FRAME_ERROR and frame.request_id == 0:
                        raise ProtocolError(
                            bytes(frame.payload).decode(
                                "utf-8", "replace"
                            )
                        )
                    with self._plock:
                        fut = self._pending.pop(frame.request_id, None)
                    if fut is not None:
                        fut.set_result(
                            (frame.budget, bytes(frame.payload))
                        )
        except Exception as e:
            self._fail_all(e)

    def _fail_all(self, exc: Exception) -> None:
        with self._plock:
            self._closed = True
            pending = list(self._pending.values())
            self._pending.clear()
        for fut in pending:
            if not fut.done():
                fut.set_exception(
                    exc if isinstance(exc, Exception) else
                    ConnectionError(str(exc))
                )
        # shutdown first: it wakes the reader thread blocked in recv()
        # and pushes the FIN out; a bare close() would leave the kernel
        # file description pinned by that blocked recv, silently
        # leaking the server-side connection
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass

    def close(self) -> None:
        self._fail_all(ConnectionError("stream client closed"))
        self._thread.join(timeout=1.0)

    def __enter__(self) -> "StreamClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
