"""The batched constraint x resource match matrix (torch).

Port of gatekeeper_tpu/engine/matchkernel.py. `match_matrix` computes the
[C, N] boolean matrix of `matching_constraints`
(pkg/target/target_template_source.go:27-44) in one call: the hand-written
CUDA kernel K1 for CUDA tensors, its plain torch version for CPU tensors
(both in kernels/ops.py). Constraint tensors are [C, ...], review features
[N, ...]; padded slots are -1 and excluded by validity masks.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .. import interop
from ..kernels import ops
from .matchspec import MatchSpecSet


def match_matrix(ms: Dict[str, torch.Tensor], fb: Dict[str, torch.Tensor]):
    """[C, N] bool — matching_constraints for every (constraint, review)."""
    return ops.match_matrix(ms, fb)


def matchspec_to_np(ms: MatchSpecSet) -> Dict[str, np.ndarray]:
    """MatchSpecSet -> plain dict of numpy arrays (the kernel's keys)."""
    return {k: np.asarray(getattr(ms, k)) for k in interop.MATCHSPEC_KEYS}


def features_to_np(fb) -> Dict[str, np.ndarray]:
    """FeatureBatch -> plain dict of numpy arrays (the kernel's keys)."""
    return {k: np.asarray(getattr(fb, k)) for k in interop.FEATURE_KEYS}


def matchspec_to_tensors(ms: MatchSpecSet, device) -> Dict[str, torch.Tensor]:
    return interop.matchspec(matchspec_to_np(ms), device)


def features_to_tensors(fb, device) -> Dict[str, torch.Tensor]:
    return interop.features(features_to_np(fb), device)
