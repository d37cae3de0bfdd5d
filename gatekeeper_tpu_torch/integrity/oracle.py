"""The shadow oracle in a process of its own.

The integrity plane re-evaluates a sampled admission on the host
interpreter and compares the verdict with the one the card served. On a
thread of the serving process that evaluation (0.1-0.6 s over hundreds of
constraints, pure Python) holds the GIL and the driver's serving mutex
while admission batches wait (PERF.md §6). `OracleProcess` moves it
into a child process with its own interpreter client:

  * the parent sends the policy (templates and constraints) at a
    constraint generation, then one sampled review at a time; the child
    answers each with its verdicts, cut to what `canary.result_digest`
    reads, and the wall interval of its evaluation;
  * a policy that calls external data resolves through the parent: the
    child's `external_data` builtin asks the parent's live
    ExternalDataSystem (its cache, or one fetch from the parent's
    reader thread), as an in-process oracle would;
  * the comparison, the divergence accounting and quarantine stay in
    the parent (IntegrityPlane._shadow_eval).

The constraint kinds whose template may read the synced inventory are not
sent here: the child holds no synced objects, so the plane evaluates those
constraints on its own worker thread and joins their verdicts with the
child's.
"""

from __future__ import annotations

import multiprocessing
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["OracleProcess", "policy_snapshot"]


def policy_snapshot(
    client, leave_out=frozenset()
) -> Tuple[List[dict], List[dict]]:
    """The client's templates (their source documents) and constraints,
    in the order the client holds them, without the constraint kinds in
    `leave_out`."""
    with client._lock:
        templates = [
            dict(e.template.raw) for e in client._templates.values()
            if e.template.kind not in leave_out
        ]
        constraints = [
            c for (_, kind), sub in sorted(client._constraints.items())
            if kind not in leave_out
            for _, c in sorted(sub.items())
        ]
    return templates, constraints


class OracleProcess:
    """One spawned child evaluating sampled reviews on its interpreter
    client. `evaluate` is called from one thread at a time (the plane's
    shadow worker) and blocks on the child's answer; a reader thread
    named "integrity-shadow" takes the child's messages."""

    def __init__(self, start_timeout_s: float = 60.0):
        self.start_timeout_s = start_timeout_s
        ctx = multiprocessing.get_context("spawn")
        self._conn, child = ctx.Pipe()
        self._proc = ctx.Process(
            target=_child_main, args=(child,), name="gk-shadow-oracle",
            daemon=True,
        )
        self._proc.start()
        child.close()
        self._send_lock = threading.Lock()
        self._pending: Dict[int, Future] = {}
        self._seq = 0
        self._policy_gen: Any = object()  # nothing sent yet
        self._closed = False
        self._reader = threading.Thread(
            target=self._read_loop, name="integrity-shadow", daemon=True
        )
        self._reader.start()

    @property
    def pid(self) -> Optional[int]:
        return self._proc.pid

    @property
    def alive(self) -> bool:
        return not self._closed and self._proc.is_alive()

    def _send(self, msg) -> None:
        with self._send_lock:
            self._conn.send(msg)

    def _call(self, kind: str, *payload, timeout: float) -> Any:
        fut: Future = Future()
        with self._send_lock:
            if self._closed:
                raise RuntimeError("shadow oracle process closed")
            self._seq += 1
            seq = self._seq
            self._pending[seq] = fut
            self._conn.send((kind, seq) + payload)
        try:
            return fut.result(timeout=timeout)
        finally:
            self._pending.pop(seq, None)

    def evaluate(
        self, gen: Any, policy, review: Any, timeout: float = 60.0
    ) -> Tuple[List[Any], float, float]:
        """The child's verdicts for `review` under the policy at
        constraint generation `gen` (`_digest_rows`), and the wall
        interval (perf_counter, shared by the processes on one host) of
        its evaluation. `policy` is called for (templates, constraints)
        only when the child holds another generation."""
        if gen != self._policy_gen:
            templates, constraints = policy()
            self._call("policy", gen, templates, constraints,
                       timeout=max(timeout, self.start_timeout_s))
            self._policy_gen = gen
        return self._call("eval", review, timeout=timeout)

    def _read_loop(self) -> None:
        while True:
            try:
                msg = self._conn.recv()
            except (EOFError, OSError):
                break
            kind = msg[0]
            if kind == "extdata":
                self._answer_extdata(*msg[1:])
                continue
            fut = self._pending.get(msg[1])
            if fut is None:
                continue
            if kind == "ok":
                fut.set_result(msg[2])
            else:
                fut.set_exception(RuntimeError(msg[2]))
        for fut in list(self._pending.values()):
            if not fut.done():
                fut.set_exception(RuntimeError("shadow oracle process ended"))

    def _answer_extdata(self, req: int, provider: str, keys) -> None:
        from ..externaldata import UnknownProviderError, get_system

        system = get_system()
        try:
            if system is None:
                raise RuntimeError(
                    "external_data: no provider system configured")
            out = ("extdata", req, "ok", system.resolve(provider, keys))
        except UnknownProviderError as e:
            out = ("extdata", req, "unknown", str(e.args[0]))
        except Exception as e:
            out = ("extdata", req, "error", repr(e))
        try:
            self._send(out)
        except (OSError, ValueError):
            pass

    def close(self, timeout: float = 5.0) -> None:
        with self._send_lock:
            if self._closed:
                return
            self._closed = True
            try:
                self._conn.send(("stop",))
            except (OSError, ValueError):
                pass
        self._proc.join(timeout)
        if self._proc.is_alive():
            self._proc.terminate()
            self._proc.join(timeout)
        self._conn.close()
        self._reader.join(timeout)


# -- the child ---------------------------------------------------------------


class _ExternalData:
    """The child's `external_data` system: each resolve asks the parent."""

    def __init__(self, inbox: "_Inbox"):
        self.inbox = inbox
        self._n = 0

    def resolve(self, provider_name: str, keys: List[str]) -> Dict[str, Any]:
        from ..externaldata import UnknownProviderError

        self._n += 1
        req = self._n
        self.inbox.conn.send(("extdata", req, provider_name, list(keys)))
        status, value = self.inbox.wait_extdata(req)
        if status == "unknown":
            raise UnknownProviderError(value)
        if status != "ok":
            raise RuntimeError(value)
        return value


class _Inbox:
    """The child's end of the pipe: external-data answers are taken out
    of order, every other message in order."""

    def __init__(self, conn):
        self.conn = conn
        self.queued: deque = deque()

    def next(self):
        if self.queued:
            return self.queued.popleft()
        return self.conn.recv()

    def wait_extdata(self, req: int):
        while True:
            msg = self.conn.recv()
            if msg[0] == "extdata" and msg[1] == req:
                return msg[2], msg[3]
            self.queued.append(msg)


def _digest_rows(results) -> List[Any]:
    """Each verdict cut to the fields `canary.result_digest` reads."""
    from ..constraint.types import Result

    out = []
    for r in results:
        c = r.constraint if isinstance(r.constraint, dict) else {}
        meta = c.get("metadata") or {}
        out.append(Result(
            msg=r.msg, enforcement_action=r.enforcement_action,
            constraint={"kind": c.get("kind", ""),
                        "metadata": {"name": meta.get("name", "")}},
        ))
    return out


def _build_client(templates: Sequence[dict], constraints: Sequence[dict]):
    """An interpreter client over the policy. It registers both targets
    the port serves, so a policy that holds agent-action templates beside
    the K8s ones loads whole; only K8s reviews are sampled."""
    from ..agentaction import AgentActionTarget
    from ..constraint import Backend, K8sValidationTarget
    from ..constraint.driver import RegoDriver

    client = Backend(RegoDriver()).new_client(
        K8sValidationTarget(), AgentActionTarget()
    )
    for t in templates:
        client.add_template(t)
    for c in constraints:
        client.add_constraint(c)
    return client


def _child_main(conn) -> None:
    from ..externaldata import set_system

    inbox = _Inbox(conn)
    set_system(_ExternalData(inbox))
    client = None
    while True:
        try:
            msg = inbox.next()
        except (EOFError, OSError):
            return
        kind = msg[0]
        if kind == "stop":
            return
        seq = msg[1]
        try:
            if kind == "policy":
                client = _build_client(msg[3], msg[4])
                out = ("ok", seq, len(msg[4]))
            else:
                t0 = time.perf_counter()
                resps = client.review_host(msg[2])
                results = [
                    r for resp in resps.by_target.values()
                    for r in resp.results
                ]
                out = ("ok", seq,
                       (_digest_rows(results), t0, time.perf_counter()))
        except Exception as e:
            out = ("error", seq, repr(e))
        try:
            conn.send(out)
        except (OSError, ValueError):
            return
