# Copied from gatekeeper_tpu/constraint/__init__.py; only imports and the edits noted in this header differ.
# Edit: source paths in comments point into the upstream Gatekeeper repo (gatekeeper/...).
# Edit: the lazy driver export is TorchDriver.
"""Constraint framework: the engine-agnostic policy orchestration layer.

This is the TPU-native equivalent of the reference's vendored
open-policy-agent/frameworks constraint client
(gatekeeper/vendor/github.com/open-policy-agent/frameworks/constraint/
pkg/client/client.go:70-838). The `Client` is the plugin boundary: controllers,
webhook, and audit only see `Client`; evaluation engines are swappable behind
the `Driver` interface (drivers/interface.go:21-39 in the reference).

Architectural departure from the reference (tpu-first): constraint↔review
matching is NOT an interpreted Rego library installed into the engine
(reference: pkg/target/target_template_source.go). It is implemented natively
in `match.py` — one shared semantics oracle that (a) serves the CPU driver
per-review and (b) compiles to the vectorized [n_constraints, n_resources]
JAX match kernel used by the TPU driver. Only ConstraintTemplate `violation`
rules go through the Rego evaluator (interpreter on CPU, compiled kernels on
TPU).
"""

from .types import Result, Response, Responses  # noqa: F401
from .errors import (  # noqa: F401
    ConstraintFrameworkError,
    MissingTemplateError,
    UnrecognizedConstraintError,
    InvalidTemplateError,
    InvalidConstraintError,
)
from .datastore import DataStore, PathConflictError  # noqa: F401
from .driver import Driver, RegoDriver  # noqa: F401
from .handler import (  # noqa: F401
    TargetHandler,
    WipeData,
    default_handler,
    label_selector_schema,
    validate_label_selector,
)
from .target import (  # noqa: F401
    AdmissionRequest,
    AugmentedReview,
    AugmentedUnstructured,
    K8sValidationTarget,
)
from .templates import ConstraintTemplate, CRD  # noqa: F401
from .client import Client, Backend  # noqa: F401


def __getattr__(name):
    # lazy: torchdriver pulls in the engine package, which itself imports
    # constraint.match — a cycle if resolved during this __init__
    if name == "TorchDriver":
        from .torchdriver import TorchDriver

        return TorchDriver
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
