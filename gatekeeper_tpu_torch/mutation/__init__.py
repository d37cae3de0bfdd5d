# Copied from gatekeeper_tpu/mutation/__init__.py; unchanged.
"""Mutation subsystem: Assign / AssignMetadata / ModifySet.

The second admission plane (mutate-then-validate), modeled on
Gatekeeper v3's mutation CRDs (pkg/mutation/ in the reference tree —
the survey pins this reproduction at "pre-mutation" v3, so this package
is the capability gap closed natively). Pieces:

  * `path`     — the location-path grammar (`spec.containers[name:*].
                 image`): list globs, key-field addressing, quoting.
  * `mutators` — the three mutator kinds with Gatekeeper's semantics
                 (AssignMetadata never overwrites; Assign honors
                 pathTests + assignIf; ModifySet merges/prunes list
                 members).
  * `system`   — ingestion-order-independent mutator registry with the
                 schema-conflict detector, the kernel-backed batch
                 screen (`match_matrix` reuse), and the fixpoint
                 application engine (hard iteration cap; a
                 non-converged object is NEVER admitted).
  * `patch`    — RFC 6902 JSONPatch rendering (before/after diff) for
                 the `/v1/mutate` webhook responses.
  * `lint`     — offline GK-M0xx diagnostics shared by the analysis
                 CLI's `mutators` mode and the controllers.
"""

from .path import PathError, parse_path, render_path  # noqa: F401
from .mutators import (  # noqa: F401
    MUTATION_GROUP,
    MUTATOR_KINDS,
    ConvergenceError,
    MutationApplyError,
    MutatorError,
    mutator_from_obj,
)
from .patch import json_patch  # noqa: F401
from .system import MutationSystem  # noqa: F401
