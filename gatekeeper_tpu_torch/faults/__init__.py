"""Deterministic fault injection: the named fault points the audit manager
fires (a subset of gatekeeper_tpu/faults)."""

from .injection import FAULTS, FaultError, FaultRegistry, FaultSpec, fire

__all__ = ["FAULTS", "FaultError", "FaultRegistry", "FaultSpec", "fire"]
