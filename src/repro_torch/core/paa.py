"""Piecewise Aggregate Approximation (PAA) primitives (paper §3.1)."""
from __future__ import annotations

import torch


def paa(x: torch.Tensor, seg_len: int) -> torch.Tensor:
    """PAA of the longest multiple-of-s prefix of x along the last axis.

    x: (..., l). Returns (..., l // seg_len).
    """
    w = x.shape[-1] // seg_len
    x = x[..., : w * seg_len]
    return x.reshape(*x.shape[:-1], w, seg_len).mean(dim=-1)


def znormalize(x: torch.Tensor, dim: int = -1,
               eps: float = 1e-8) -> torch.Tensor:
    """Z-normalize: zero mean, unit (population) std along `dim`."""
    mu = x.mean(dim=dim, keepdim=True)
    sd = x.std(dim=dim, keepdim=True, correction=0)
    return (x - mu) / sd.clamp_min(eps)
