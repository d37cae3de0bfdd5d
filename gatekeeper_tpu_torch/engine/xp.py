"""The array functions compiled template programs emit through.

The JAX package evaluates the expression DAG (engine/exprs.py) through a
numpy-like module (`jax.numpy` under jit, `numpy` for host paths). The port
emits torch directly through these few explicit functions instead. They keep
JAX's 32-bit result types: JAX (without x64) never produces int64 or
float64, while torch widens integer and boolean sums to int64 and
`torch.where`/`torch.full` on Python ints to int64, so every function here
narrows a 64-bit result back to 32 bits. That keeps the values that reach
the hand-written kernels in the types the kernels take.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch

int32 = torch.int32


def x32(v):
    """Narrow an int64/float64 tensor to int32/float32 (JAX x32 types)."""
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.int64:
            return v.to(torch.int32)
        if v.dtype == torch.float64:
            return v.to(torch.float32)
    return v


def where(cond, a, b):
    return x32(torch.where(cond, a, b))


def clip(v, lo, hi):
    return torch.clamp(v, lo, hi)


def full(shape: Sequence[int], value: Any, device) -> torch.Tensor:
    if isinstance(value, bool):
        dtype = torch.bool
    elif isinstance(value, int):
        dtype = torch.int32
    else:
        dtype = torch.float32
    return torch.full(tuple(shape), value, dtype=dtype, device=device)


def repeat(v, n: int, dim: int):
    """np.repeat: each element repeated n times along `dim`."""
    return torch.repeat_interleave(v, n, dim=dim)


def take_along_axis(v, idx, dim: int):
    return torch.gather(v, dim, idx.long())


def take(tab, idx):
    """Row gather `tab[idx]` with an integer index tensor of any width."""
    return tab[idx.long()]


def _as_bool(v):
    return v if v.dtype == torch.bool else v != 0


def any(v, dim: int):
    return torch.any(_as_bool(v), dim=dim)


def all(v, dim: int):
    return torch.all(_as_bool(v), dim=dim)


def sum(v, dim: int):
    """JAX sum types: bool and int32 sum to int32, float32 to float32."""
    if v.dtype == torch.bool or not v.dtype.is_floating_point:
        return torch.sum(v, dim=dim, dtype=torch.int32)
    return x32(torch.sum(v, dim=dim))


def max(v, dim: int):
    """A tensor, never torch's (values, indices) tuple; bool stays bool."""
    if v.dtype == torch.bool:
        return torch.any(v, dim=dim)
    return torch.amax(v, dim=dim)


def astype(v, dtype):
    return v.to(dtype)
