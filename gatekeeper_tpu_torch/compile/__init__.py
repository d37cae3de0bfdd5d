# Copied from gatekeeper_tpu/compile/__init__.py; only this edit differs.
# Edit: the docstring names the port's artifacts (the CUDA kernel
# libraries and the native host libraries) instead of XLA's cache.
"""Compile-artifact store with fingerprint-gated load.

The store keeps the port's compiled libraries with provenance: every
artifact is content-addressed (sha256) and attested with the machine
fingerprint that produced it (platform + CPU feature set + torch and
its CUDA runtime + device name and compute capability + nvcc release).
A foreign or corrupt artifact is skipped and counted
(`program_store_rejected_total{reason}`), never loaded: a store volume
shared across node pools fails closed to a rebuild instead of loading a
library built for another machine.
"""

from .store import (  # noqa: F401
    REJECT_REASONS,
    SCHEMA_VERSION,
    ProgramStore,
    machine_fingerprint,
    store_from_env,
)
