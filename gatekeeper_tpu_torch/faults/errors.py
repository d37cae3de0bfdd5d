# Copied from gatekeeper_tpu/faults/errors.py; no line below differs.
"""Overload/degradation error taxonomy for the admission plane.

These errors mean "the evaluation DID NOT HAPPEN" — the request was
shed before dispatch, expired before dispatch, or every evaluation
rung was down. They are distinct from evaluation errors (a poisoned
request failing on the interpreter stays a 500): the handler answers
them with the endpoint's configured fail-open/fail-closed envelope
instead, mirroring what the apiserver's failurePolicy would do if the
webhook had simply timed out — but explicitly, countably, and within
the caller's deadline.
"""

from __future__ import annotations


class AdmissionUnavailable(RuntimeError):
    """Base: the request was never evaluated; respond per fail policy."""

    reason = "unavailable"


class ShedError(AdmissionUnavailable):
    """Dropped by the admission scheduler under overload.

    `reason` distinguishes the shed classes (decision records carry it):
    `queue_full` (bounded queue at capacity), `predicted_miss` (the
    scheduler proved the deadline unmakeable — `predicted_slack_ms` is
    the negative slack), `tenant_capped` (per-tenant fair-share quota
    exhausted while the plane is overloaded). `tenant_capped` also
    rides as a boolean alongside the other reasons: whether the tenant
    was over its share when the shed happened."""

    reason = "queue_full"

    def __init__(
        self,
        message: str = "",
        reason: str = None,
        predicted_slack_ms: float = None,
        tenant_capped: bool = False,
    ):
        super().__init__(message)
        if reason is not None:
            self.reason = reason
        self.predicted_slack_ms = predicted_slack_ms
        self.tenant_capped = tenant_capped


class DeadlineExceeded(AdmissionUnavailable):
    """The caller's deadline expired before dispatch — evaluating now
    would burn device time on an answer nobody is waiting for."""

    reason = "deadline"


class EvaluationUnavailable(AdmissionUnavailable):
    """Every evaluation rung was down (device faulted AND the host
    oracle was unavailable) — the bottom of the degradation ladder."""

    reason = "degraded"


class EvaluationTimeout(AdmissionUnavailable):
    """The in-flight evaluation outlived the request timeout (a hung
    device dispatch); the caller gets the policy envelope while the
    worker finishes or dies in the background."""

    reason = "timeout"
