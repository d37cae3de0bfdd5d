# Copied from gatekeeper_tpu/logs.py; unchanged.
"""Structured JSON logging: the zap-equivalent log plane.

The reference wires zap through controller-runtime (main.go:104-134)
and tags every record with a standard key set
(pkg/logging/logging.go:1-20); violation denials/audits log through it
(--log-denies pkg/webhook/policy.go:240-252, audit logViolation
pkg/audit/manager.go:668-682). This module is the framework's native
counterpart: one JSON object per line on stderr, bound key/value
context via `with_values`, and an injectable sink so tests (and the
webhook's denied_log compatibility surface) can observe records.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional

# standard keys (pkg/logging/logging.go:1-20)
PROCESS = "process"
EVENT_TYPE = "event_type"
TEMPLATE_NAME = "template_name"
CONSTRAINT_NAMESPACE = "constraint_namespace"
CONSTRAINT_NAME = "constraint_name"
CONSTRAINT_KIND = "constraint_kind"
CONSTRAINT_API_VERSION = "constraint_api_version"
CONSTRAINT_STATUS = "constraint_status"
CONSTRAINT_ACTION = "constraint_action"
AUDIT_ID = "audit_id"
CONSTRAINT_VIOLATIONS = "constraint_violations"
RESOURCE_KIND = "resource_kind"
RESOURCE_API_VERSION = "resource_api_version"
RESOURCE_NAMESPACE = "resource_namespace"
RESOURCE_NAME = "resource_name"
# engine-specific: correlates a log record with its request trace in
# /debug/traces (docs/observability.md); bound via with_values by the
# webhook handler so every denial names the trace that explains it
TRACE_ID = "trace_id"

_LEVELS = {"debug": 10, "info": 20, "error": 40, "off": 99}


class StructuredLogger:
    """JSON-line logger with bound values (logr/zap shape).

    `sink`: callable receiving each record dict (after the stream
    write); used by tests and by callers that keep in-memory views.
    """

    def __init__(
        self,
        name: str = "gatekeeper",
        stream=None,
        level: str = "info",
        sink: Optional[Callable[[Dict[str, Any]], None]] = None,
        _bound: Optional[Dict[str, Any]] = None,
    ):
        self.name = name
        self.stream = stream if stream is not None else sys.stderr
        self.level = level
        self.sink = sink
        self._bound = dict(_bound or {})
        self._lock = threading.Lock()

    def with_values(self, **kv) -> "StructuredLogger":
        merged = dict(self._bound)
        merged.update(kv)
        out = StructuredLogger(
            name=self.name,
            stream=self.stream,
            level=self.level,
            sink=self.sink,
            _bound=merged,
        )
        out._lock = self._lock  # share the write lock across children
        return out

    def _emit(self, level: str, msg: str, kv: Dict[str, Any]) -> None:
        if _LEVELS[level] < _LEVELS.get(self.level, 20):
            return
        rec: Dict[str, Any] = {
            "level": level,
            "ts": time.time(),
            "logger": self.name,
            "msg": msg,
        }
        rec.update(self._bound)
        rec.update(kv)
        line = json.dumps(rec, default=str)
        with self._lock:
            try:
                self.stream.write(line + "\n")
            except Exception:
                pass  # a broken log stream must never fail the caller
        if self.sink is not None:
            self.sink(rec)

    def debug(self, msg: str, **kv) -> None:
        self._emit("debug", msg, kv)

    def info(self, msg: str, **kv) -> None:
        self._emit("info", msg, kv)

    def error(self, msg: str, err: Any = None, **kv) -> None:
        if err is not None:
            kv = {"error": str(err), **kv}
        self._emit("error", msg, kv)


class _NullStream:
    def write(self, s) -> None:
        pass


# level "off" short-circuits _emit BEFORE record construction: the
# audit path logs per violation, and a sweep with tens of thousands of
# violations must not pay json.dumps into a void when nothing is wired
_null = StructuredLogger(stream=_NullStream(), level="off")


def null_logger() -> StructuredLogger:
    """A logger that emits nothing (default for components whose caller
    did not wire logging); record construction is skipped entirely."""
    return _null


class CapturingLogger(StructuredLogger):
    """Test helper: keeps every record in `records`."""

    def __init__(self, level: str = "debug"):
        self.records: List[Dict[str, Any]] = []
        super().__init__(
            stream=_NullStream(),
            level=level,
            sink=self.records.append,
        )
