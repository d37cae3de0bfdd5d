# Copied from gatekeeper_tpu/integrity/__init__.py; no line below differs.
"""Verdict-integrity plane: canary rows, sampled shadow oracle, and
silent-data-corruption quarantine (docs/robustness.md §Verdict
integrity)."""

from .canary import result_digest, split_digests, synth_reviews
from .plane import IntegrityPlane, shadow_sampled

__all__ = [
    "IntegrityPlane",
    "result_digest",
    "shadow_sampled",
    "split_digests",
    "synth_reviews",
]
