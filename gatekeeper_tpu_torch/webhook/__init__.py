"""Admission webhook layer (a subset of gatekeeper_tpu/webhook).

Counterpart of pkg/webhook/: the validating handler (policy.py, a copy),
the namespace-label guard (namespacelabel.py, a copy) and the
micro-batching bridge that coalesces concurrent AdmissionReviews into one
fused device dispatch (server.py: `MicroBatcher` -> `Client.review_many`
on TorchDriver, served over HTTP by `WebhookServer` and, with
`ingest=True`, over the framed stream of gatekeeper_tpu_torch/ingest), and
the native HTTP front's Python back half (bridge.py: `BridgeStack`, the C++
front of native/bridge_frontend.cpp feeding the same batcher), and TLS
certificates (certs.py: `CertRotator`, `CaBundleInjector`). The mutation
plane is mutate.py; `WebhookServer(agent_review=True)` mounts the agent
plane of gatekeeper_tpu_torch/agentaction at /v1/agent/review.
"""

from .certs import CaBundleInjector, CertRotator
from .policy import AdmissionResponse, TraceConfig, ValidationHandler
from .namespacelabel import IGNORE_LABEL, NamespaceLabelHandler
from .server import MicroBatcher, WebhookServer, review_envelope

__all__ = [
    "AdmissionResponse", "CaBundleInjector", "CertRotator", "IGNORE_LABEL", "MicroBatcher",
    "NamespaceLabelHandler", "TraceConfig", "ValidationHandler",
    "WebhookServer", "review_envelope",
]
