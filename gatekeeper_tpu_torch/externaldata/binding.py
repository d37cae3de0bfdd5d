# Copied from gatekeeper_tpu/externaldata/binding.py; unchanged.
"""Process-level binding from the `external_data` Rego builtin to the
live ExternalDataSystem.

The interpreter's builtin table is stateless functions; external_data
needs the provider registry + cache. The Runner binds its system here
at boot (one system per process, like the faults registry); tests that
need isolation either rebind or use the `use_system` thread-local
override so parallel suites cannot cross-talk.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any, Optional

_lock = threading.Lock()
_system: Optional[Any] = None
_local = threading.local()


def set_system(system: Optional[Any]) -> None:
    """Bind the process-wide system (None unbinds)."""
    global _system
    with _lock:
        _system = system


def get_system() -> Optional[Any]:
    override = getattr(_local, "system", None)
    if override is not None:
        return override
    with _lock:
        return _system


@contextmanager
def use_system(system: Any):
    """Thread-local override for the duration of a with-block."""
    prev = getattr(_local, "system", None)
    _local.system = system
    try:
        yield system
    finally:
        _local.system = prev
