"""Dynamic Time Warping: banded DP, query envelopes, LB_Keogh (paper §3, §6.2).

The port's counterpart of `repro/core/dtw.py`, in plain PyTorch.  The
Sakoe-Chiba row recurrence

    D[i,j] = d(q_i, c_j) + min(D[i-1,j], D[i-1,j-1], D[i,j-1])

has a serial in-row (left) dependency.  With M[j] = min(up, diag) it is
x_j = d_j + min(M_j, x_{j-1}), whose closed form is

    x_j = S_j + min_{k<=j} (M_k - S_{k-1}),   S = cumsum(d)

— one cumsum and one cummin per row over a (2r+1)-wide band, batched
over candidates.  This is the DP of the brute-force oracle; its float32
cumsum over the band cancels once the band is wide (ROADMAP Queue 3 P6),
so the kernels' plain version is `kernels/ref.py::wavefront_dtw`, the
kernels' own recurrence.
"""
from __future__ import annotations

import torch

_BIG = 1e30


def dtw_envelope(q: torch.Tensor, r: int):
    """dtwENV_r(Q): running min/max of q over the window [i-r, i+r]
    (paper §6.2), padded with +inf / -inf.  q: (..., l).  Returns (lo, hi)
    each (..., l); min and max only, so the result is exact."""
    lo = torch.nn.functional.pad(q, (r, r), value=float("inf"))
    hi = torch.nn.functional.pad(q, (r, r), value=-float("inf"))
    return (lo.unfold(-1, 2 * r + 1, 1).amin(dim=-1),
            hi.unfold(-1, 2 * r + 1, 1).amax(dim=-1))


def lb_keogh(env_lo: torch.Tensor, env_hi: torch.Tensor, c: torch.Tensor,
             squared: bool = False) -> torch.Tensor:
    """LB_Keogh(dtwENV_r(Q), C) (paper Eq. 6); broadcasts over leading
    dims."""
    over = (c - env_hi).clamp_min(0.0)
    under = (env_lo - c).clamp_min(0.0)
    d2 = (over * over + under * under).sum(dim=-1)
    return d2 if squared else torch.sqrt(d2)


def dtw_band(q: torch.Tensor, c: torch.Tensor, r: int,
             squared: bool = False) -> torch.Tensor:
    """Banded DTW between q (l,) and equal-length candidates c (..., l);
    q may also hold one query per candidate, shaped like c.

    Row i holds the costs of columns j = i-r .. i+r in a (2r+1,) band;
    up and diag come from the previous band at k+1 and k, and the in-row
    left dependency is the cumsum/cummin closed form (module docstring).
    Cells outside the series cost 0 in the cumsum and are forced to BIG,
    as in the JAX package.  A band wider than the row changes nothing
    (its extra cells are all masked), so r is capped at l - 1.  The band
    is laid out band-major, (2r+1, N): each scan then runs along the outer
    dimension, one candidate per lane on the card (a scan along a short
    inner dimension runs ~35x slower there).
    """
    l = q.shape[-1]
    lead = c.shape[:-1]
    c = c.reshape(-1, l)
    qt = q.reshape(-1, l).t()                   # (l, 1 or N)
    r = min(r, l - 1)
    band = 2 * r + 1
    ks = torch.arange(band, device=c.device)[:, None]
    # (l + 2r, N): column j of row i at row i + k of the band
    cp = torch.nn.functional.pad(c, (r, r)).t().contiguous()

    def row_cost(i):
        j = i - r + ks
        in_seq = (j >= 0) & (j < l)
        d = torch.where(in_seq, (qt[i] - cp[i:i + band]) ** 2, 0.0)
        return d, in_seq

    d0, in0 = row_cost(0)
    x = torch.where(in0, torch.cumsum(d0, dim=0), _BIG)
    big = torch.full((1, c.shape[0]), _BIG, dtype=c.dtype, device=c.device)
    zero = torch.zeros_like(big)
    for i in range(1, l):
        d, in_seq = row_cost(i)
        up = torch.cat([x[1:], big], dim=0)                    # D[i-1, j]
        m = torch.where(in_seq, torch.minimum(up, x), _BIG)    # x: diag
        s = torch.cumsum(d, dim=0)
        s_prev = torch.cat([zero, s[:-1]], dim=0)
        x = s + torch.cummin(m - s_prev, dim=0).values
        x = torch.where(in_seq, x.clamp_max(_BIG), _BIG)
    out = x[r].reshape(lead)                     # cell (l-1, l-1) at k = r
    return out if squared else torch.sqrt(out)
