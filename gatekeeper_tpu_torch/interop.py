"""Encoded state from the JAX package, as the port's tensors.

The JAX package (gatekeeper_tpu) and this port encode policy and reviews
into the same arrays. These functions take that state as plain dicts of
numpy arrays — the form the JAX package's host code already uses — check
their keys and types, and return torch tensors on a given device, so both
implementations can be fed identical encoded inputs. 64-bit arrays narrow
to 32 bits on the way, as `jnp.asarray` narrows them when the JAX package
stages them (JAX without x64). Nothing here imports the JAX package;
callers hand over numpy arrays.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping

import numpy as np
import torch

MATCHSPEC_KEYS = (
    "kind_rows", "ns_has", "ns_ids", "excl_has", "excl_ids", "scope",
    "lab_invalid", "lab_ml", "lab_expr", "lab_expr_vals", "nssel_has",
    "nssel_matches_empty", "nssel_invalid", "nssel_ml", "nssel_expr",
    "nssel_expr_vals",
)
FEATURE_KEYS = (
    "group_id", "kind_id", "kind_defined", "is_ns", "has_namespace",
    "ns_name_id", "obj_present", "old_present", "obj_labels", "old_labels",
    "nssel_defined", "nssel_labels", "nssel_empty",
)
TOKEN_KEYS = ("spath", "idx0", "idx1", "kind", "vid", "vnum")

_TYPES = {np.dtype(bool), np.dtype(np.int32), np.dtype(np.float32)}
_NARROW = {np.dtype(np.int64): np.int32, np.dtype(np.float64): np.float32}


def to_tensor(a: Any, device) -> torch.Tensor:
    """A host array as a tensor on `device`, int64/float64 narrowed to
    int32/float32 as the JAX package's staging narrows them (oracle-filled
    string tables can be float64 on the host)."""
    arr = np.asarray(a)
    if arr.dtype in _NARROW:
        arr = arr.astype(_NARROW[arr.dtype])
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def _tensor(name: str, a: Any, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype not in _TYPES and arr.dtype not in _NARROW:
        raise TypeError(f"{name}: dtype {arr.dtype} (want bool/int/float)")
    return to_tensor(arr, device)


def _convert(d: Mapping[str, Any], keys, what: str, device):
    missing = [k for k in keys if k not in d]
    if missing:
        raise KeyError(f"{what}: missing {missing}")
    return {k: _tensor(k, d[k], device) for k in keys}


def matchspec(d: Mapping[str, Any], device) -> Dict[str, torch.Tensor]:
    """`matchspec_to_np` output ([C, ...] per key)."""
    return _convert(d, MATCHSPEC_KEYS, "matchspec", device)


def features(d: Mapping[str, Any], device) -> Dict[str, torch.Tensor]:
    """FeatureBatch fields ([N] / [N, ML, 2] per key)."""
    return _convert(d, FEATURE_KEYS, "features", device)


def tokens(d: Mapping[str, Any], device) -> Dict[str, torch.Tensor]:
    """The token table ([N, L] per column)."""
    return _convert(d, TOKEN_KEYS, "tokens", device)


def tables(d: Mapping[str, Any], device) -> Dict[str, torch.Tensor]:
    """Pattern arrays (`pat_member` [P, V] bool, `pat_capture` [P, V]
    int32) and string tables ({name: [V]}), as EvalCtx takes them."""
    if "pat_member" not in d or "pat_capture" not in d:
        raise KeyError("tables: missing pat_member/pat_capture")
    return {k: _tensor(k, v, device) for k, v in d.items()}


def const_sets(stacked: Mapping[str, Any], device) -> List[Dict[str, torch.Tensor]]:
    """A program group's stacked const sets ({slot: [Ku, ...]}) -> one
    {slot: tensor} dict per const set, the port's per-lane form."""
    arrs = {k: np.asarray(v) for k, v in stacked.items()}
    counts = {a.shape[0] for a in arrs.values()}
    if len(counts) > 1:
        raise ValueError(f"const_sets: uneven leading axes {sorted(counts)}")
    n = counts.pop() if counts else 0
    return [
        {k: _tensor(k, a[i], device) for k, a in arrs.items()}
        for i in range(n)
    ]
