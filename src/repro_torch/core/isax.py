"""iSAX symbolization (paper §3.1) + symbol breakpoint geometry.

The real-value space is cut by `card - 1` breakpoints into `card` regions.
For Z-normalized data the breakpoints are standard-normal quantiles; for
non Z-normalized collections they are affinely calibrated to the
collection's PAA distribution (`calibrate_breakpoints`).
"""
from __future__ import annotations

import numpy as np
import torch

# Standard-normal quantiles ndtri(i / 256), i = 1..255, as float32 bit
# patterns.  These are the values the JAX package's float32 `ndtri`
# produces (a Cephes rational approximation evaluated with fused
# multiply-adds and XLA's own float32 log); `torch.special.ndtri`
# differs from them by up to a few ulps.  A quantile i / card of a
# power-of-two `card` is the same float32 as (i * 256 / card) / 256, so
# every power-of-two alphabet is a subsample of this table and the
# port's symbols match the reference's bit for bit.
_NDTRI_256_BITS = np.array([
    0xc02a3e8c, 0xc01ab949, 0xc01109dd, 0xc009d915, 0xc00410d7, 0xbffe640a, 0xbff5eed2,
    0xbfee6dff, 0xbfe7aa8d, 0xbfe17e6a, 0xbfdbce22, 0xbfd68530, 0xbfd193e0, 0xbfccedda,
    0xbfc88940, 0xbfc45e10, 0xbfc065ac, 0xbfbc9a94, 0xbfb8f824, 0xbfb57a60, 0xbfb21de6,
    0xbfaedfc4, 0xbfabbd69, 0xbfa8b495, 0xbfa5c34a, 0xbfa2e7cb, 0xbfa0207e, 0xbf9d6c02,
    0xbf9ac912, 0xbf98368a, 0xbf95b360, 0xbf933ea7, 0xbf90d77e, 0xbf8e7d28, 0xbf8c2ee0,
    0xbf89ec07, 0xbf87b3fe, 0xbf858634, 0xbf836229, 0xbf81475b, 0xbf7e6ab9, 0xbf7a577e,
    0xbf765442, 0xbf726049, 0xbf6e7ae6, 0xbf6aa374, 0xbf66d95b, 0xbf631c0a, 0xbf5f6af6,
    0xbf5bc5a4, 0xbf582b96, 0xbf549c5c, 0xbf51178a, 0xbf4d9cb7, 0xbf4a2b84, 0xbf46c393,
    0xbf43648d, 0xbf400e1d, 0xbf3cbff4, 0xbf3979c7, 0xbf363b4a, 0xbf33043b, 0xbf2fd456,
    0xbf2cab5d, 0xbf298910, 0xbf266d38, 0xbf23579d, 0xbf204806, 0xbf1d3e43, 0xbf1a3a21,
    0xbf173b6f, 0xbf144201, 0xbf114daa, 0xbf0e5e3f, 0xbf0b7397, 0xbf088d8a, 0xbf05abf1,
    0xbf02cea7, 0xbeffeb13, 0xbefa40e6, 0xbef49e88, 0xbeef03b4, 0xbee9702c, 0xbee3e3b1,
    0xbede5e08, 0xbed8def6, 0xbed36644, 0xbecdf3b8, 0xbec8871f, 0xbec32041, 0xbebdbeed,
    0xbeb862f2, 0xbeb30c1e, 0xbeadba40, 0xbea86d2d, 0xbea324b3, 0xbe9de0a9, 0xbe98a0e1,
    0xbe936532, 0xbe8e2d71, 0xbe88f975, 0xbe83c916, 0xbe7d3856, 0xbe72e51c, 0xbe689831,
    0xbe5e5149, 0xbe541018, 0xbe49d457, 0xbe3f9dbc, 0xbe356c01, 0xbe2b3ede, 0xbe21160d,
    0xbe16f14a, 0xbe0cd050, 0xbe02b2dc, 0xbdf13155, 0xbddd02f3, 0xbdc8da0e, 0xbdb4b623,
    0xbda096b0, 0xbd8c7b35, 0xbd70c660, 0xbd489c45, 0xbd20771b, 0xbcf0abc2, 0xbca06f39,
    0xbc206d41, 0x00000000, 0x3c206d41, 0x3ca06f39, 0x3cf0abc2, 0x3d20771b, 0x3d489c45,
    0x3d70c660, 0x3d8c7b35, 0x3da096b0, 0x3db4b623, 0x3dc8da0e, 0x3ddd02f3, 0x3df13155,
    0x3e02b2dc, 0x3e0cd050, 0x3e16f14a, 0x3e21160d, 0x3e2b3ede, 0x3e356c01, 0x3e3f9dbc,
    0x3e49d457, 0x3e541018, 0x3e5e5149, 0x3e689831, 0x3e72e51c, 0x3e7d3856, 0x3e83c916,
    0x3e88f975, 0x3e8e2d71, 0x3e936532, 0x3e98a0e1, 0x3e9de0a9, 0x3ea324b3, 0x3ea86d2d,
    0x3eadba40, 0x3eb30c1e, 0x3eb862f2, 0x3ebdbeed, 0x3ec32041, 0x3ec8871f, 0x3ecdf3b8,
    0x3ed36644, 0x3ed8def6, 0x3ede5e08, 0x3ee3e3b1, 0x3ee9702c, 0x3eef03b4, 0x3ef49e88,
    0x3efa40e6, 0x3effeb13, 0x3f02cea7, 0x3f05abf1, 0x3f088d8a, 0x3f0b7397, 0x3f0e5e3f,
    0x3f114daa, 0x3f144201, 0x3f173b6f, 0x3f1a3a21, 0x3f1d3e43, 0x3f204806, 0x3f23579d,
    0x3f266d38, 0x3f298910, 0x3f2cab5d, 0x3f2fd456, 0x3f33043b, 0x3f363b4a, 0x3f3979c7,
    0x3f3cbff4, 0x3f400e1d, 0x3f43648d, 0x3f46c393, 0x3f4a2b84, 0x3f4d9cb7, 0x3f51178a,
    0x3f549c5c, 0x3f582b96, 0x3f5bc5a4, 0x3f5f6af6, 0x3f631c0a, 0x3f66d95b, 0x3f6aa374,
    0x3f6e7ae6, 0x3f726049, 0x3f765442, 0x3f7a577e, 0x3f7e6ab9, 0x3f81475b, 0x3f836229,
    0x3f858634, 0x3f87b3fe, 0x3f89ec07, 0x3f8c2ee0, 0x3f8e7d28, 0x3f90d77e, 0x3f933ea7,
    0x3f95b360, 0x3f98368a, 0x3f9ac912, 0x3f9d6c02, 0x3fa0207e, 0x3fa2e7cb, 0x3fa5c34a,
    0x3fa8b495, 0x3fabbd69, 0x3faedfc4, 0x3fb21de6, 0x3fb57a60, 0x3fb8f824, 0x3fbc9a94,
    0x3fc065ac, 0x3fc45e10, 0x3fc88940, 0x3fccedda, 0x3fd193e0, 0x3fd68530, 0x3fdbce22,
    0x3fe17e6a, 0x3fe7aa8d, 0x3fee6dff, 0x3ff5eed2, 0x3ffe640a, 0x400410d7, 0x4009d915,
    0x401109dd, 0x401ab949, 0x402a3e8c,
], dtype=np.uint32)


def gaussian_breakpoints(card: int, device=None) -> torch.Tensor:
    """(card - 1,) standard-normal quantile breakpoints (float32).

    Power-of-two cardinalities read the reference table above; any other
    cardinality rounds the float64 quantile to float32, which may differ
    from the JAX package's float32 evaluation by an ulp.
    """
    if 256 % card == 0:
        step = 256 // card
        vals = _NDTRI_256_BITS.view(np.float32)[step - 1::step]
        return torch.from_numpy(vals.copy()).to(device)
    qs = torch.arange(1, card, dtype=torch.float64) / card
    return torch.special.ndtri(qs).to(torch.float32).to(device)


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
