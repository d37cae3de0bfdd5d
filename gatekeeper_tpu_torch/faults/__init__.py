"""Robustness toolkit of the admission plane (a subset of
gatekeeper_tpu/faults): deterministic fault injection (`injection.py`, the
named fault points the driver, the audit manager and the micro-batcher
fire, armed from GATEKEEPER_TPU_FAULTS at import), the
device circuit breaker (`breaker.py`) and the overload/degradation error
taxonomy (`errors.py`)."""

from .breaker import CLOSED, HALF_OPEN, OPEN, CircuitBreaker
from .errors import (
    AdmissionUnavailable,
    DeadlineExceeded,
    EvaluationTimeout,
    EvaluationUnavailable,
    ShedError,
)
from .injection import (
    FAULTS,
    FaultError,
    FaultRegistry,
    FaultSpec,
    configure_from_env,
    device_point,
    fire,
    skew,
)

__all__ = [
    "AdmissionUnavailable",
    "CircuitBreaker",
    "CLOSED",
    "DeadlineExceeded",
    "EvaluationTimeout",
    "EvaluationUnavailable",
    "FAULTS",
    "FaultError",
    "FaultRegistry",
    "FaultSpec",
    "HALF_OPEN",
    "OPEN",
    "ShedError",
    "configure_from_env",
    "device_point",
    "fire",
    "skew",
]
