"""iSAX symbolization (paper §3.1) + symbol breakpoint geometry.

The real-value space is cut by `card - 1` breakpoints into `card` regions.
For Z-normalized data the breakpoints are standard-normal quantiles; for
non Z-normalized collections they are affinely calibrated to the
collection's PAA distribution (`calibrate_breakpoints`).
"""
from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import torch

# Standard-normal quantiles ndtri(i / card) for every card in [2, 256]
# and i in [1, card - 1], as float32 bit patterns, cards in order:
# `_TABLE` holds the values the JAX package's float32 `ndtri` produces
# from float32(i) / float32(card) (a Cephes rational approximation
# evaluated with fused multiply-adds and XLA's own float32 log), which
# `torch.special.ndtri` misses by up to a few ulps.  Reading them makes
# the port's breakpoints, and so its iSAX symbols, bit-equal to the
# reference's for every alphabet.
_TABLE = Path(__file__).resolve().parent / "ndtri_breakpoints.npy"
_MAX_CARD = 256


@functools.lru_cache(maxsize=1)
def _quantile_bits() -> np.ndarray:
    bits = np.load(_TABLE)
    bits.flags.writeable = False
    return bits


def gaussian_breakpoints(card: int, device=None) -> torch.Tensor:
    """(card - 1,) standard-normal quantile breakpoints (float32), for
    any card in [2, 256]."""
    if not 2 <= card <= _MAX_CARD:
        raise ValueError(f"card={card} outside [2, {_MAX_CARD}]")
    start = (card - 1) * (card - 2) // 2       # entries of cards 2..card-1
    vals = _quantile_bits()[start:start + card - 1].view(np.float32)
    return torch.from_numpy(vals.copy()).to(device)


def calibrate_breakpoints(card: int, sample_paa: torch.Tensor) -> torch.Tensor:
    """Affine-calibrate Gaussian breakpoints to a sample of PAA coefficients
    (the non Z-normalized index, where coefficients live on the raw scale
    of the data)."""
    bp = gaussian_breakpoints(card, sample_paa.device)
    mu = sample_paa.mean()
    sd = sample_paa.std(correction=0).clamp_min(1e-6)
    return (mu + sd * bp).to(torch.float32)


def symbolize(vals: torch.Tensor, breakpoints: torch.Tensor) -> torch.Tensor:
    """Map real values to symbol indices in [0, card-1].

    symbol k <=> value in [bp[k-1], bp[k])  (bp[-1] = -inf, bp[card-1] = +inf),
    i.e. `searchsorted(side="right")`; -inf maps to 0 and +inf to card-1.
    """
    return torch.searchsorted(breakpoints, vals.contiguous(),
                              right=True).to(torch.int32)


def beta_lower(sym: torch.Tensor, breakpoints: torch.Tensor) -> torch.Tensor:
    """beta_l(symbol): lower breakpoint of the symbol's region (-inf for 0)."""
    pad = torch.full((1,), -float("inf"), dtype=torch.float32,
                     device=breakpoints.device)
    return torch.cat([pad, breakpoints])[sym.long()]


def beta_upper(sym: torch.Tensor, breakpoints: torch.Tensor) -> torch.Tensor:
    """beta_u(symbol): upper breakpoint of the symbol's region (+inf for last)."""
    pad = torch.full((1,), float("inf"), dtype=torch.float32,
                     device=breakpoints.device)
    return torch.cat([breakpoints, pad])[sym.long()]


def argsort_by_isax(sym_lo: torch.Tensor) -> torch.Tensor:
    """Stable lexicographic argsort of envelopes by their iSAX(L) word
    (column 0 most significant): one stable sort per column, least
    significant first, as `jnp.lexsort` orders."""
    order = torch.arange(sym_lo.shape[0], device=sym_lo.device)
    for col in range(sym_lo.shape[1] - 1, -1, -1):
        order = order[torch.argsort(sym_lo[order, col], stable=True)]
    return order
