"""Evaluation engine of the torch port: match specs, the match matrix,
the compiled-template expression DAG and its programs (port of
gatekeeper_tpu/engine)."""

from .matchspec import MatchSpecSet, compile_match_specs  # noqa: F401
from .matchkernel import match_matrix  # noqa: F401
