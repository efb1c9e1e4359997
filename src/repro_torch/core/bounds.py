"""Lower bounds for ULISSE search (paper §6.1-6.2, Eq. 5 / Eq. 8).

Both bounds are instances of one interval-vs-interval distance: the query
contributes a per-segment interval [ql, qh] (degenerate ql == qh for ED),
the Envelope contributes [beta_l(iSAX(L)), beta_u(iSAX(U))], and

    gap_i = max(0, e_lo_i - qh_i, ql_i - e_hi_i)
    bound = sqrt(s) * sqrt(sum_i gap_i^2)           (first nseg_q segments)

(with the JAX package's fix of Eq. 5's second branch: beta_l(iSAX(L)) is
the safe breakpoint).  These are the plain tensor versions; the batched
engine path goes through `repro_torch.kernels.mindist`, whose symbol
entry does the lookup of `envelope_breakpoint_bounds` in the kernel (its
plain version, `kernels.ref.mindist_sym_ref`, calls this one).
"""
from __future__ import annotations

import torch

from repro_torch.core import isax


def interval_mindist(q_lo: torch.Tensor, q_hi: torch.Tensor,
                     e_lo: torch.Tensor, e_hi: torch.Tensor,
                     seg_len: int, nseg_q: int, squared: bool = False):
    """Generic interval-vs-interval lower bound.

    q_lo/q_hi: (w,) or (Qb, w) query intervals.
    e_lo/e_hi: (N, w) envelope intervals (real-valued breakpoints or PAA).
    Returns (N,) or (Qb, N).
    """
    q_lo = q_lo[..., None, :nseg_q]
    q_hi = q_hi[..., None, :nseg_q]
    e_lo_t = e_lo[..., :nseg_q]
    e_hi_t = e_hi[..., :nseg_q]
    gap = torch.maximum(torch.maximum(e_lo_t - q_hi, q_lo - e_hi_t),
                        torch.zeros((), dtype=e_lo.dtype, device=e_lo.device))
    # unconstrained segments carry +-inf bounds: zero every non-finite gap
    gap = torch.where(torch.isfinite(gap), gap, 0.0)
    # summed in segment order, as the kernel sums: a float32 sum over
    # thousands of segments rounds differently in any other order
    g2 = gap * gap
    acc = torch.zeros(g2.shape[:-1], dtype=g2.dtype, device=g2.device)
    for i in range(g2.shape[-1]):
        acc = acc + g2[..., i]
    d2 = seg_len * acc
    return d2 if squared else torch.sqrt(d2)


def envelope_breakpoint_bounds(sym_lo: torch.Tensor, sym_hi: torch.Tensor,
                               breakpoints: torch.Tensor):
    """[beta_l(iSAX(L)), beta_u(iSAX(U))] of an EnvelopeSet's symbols
    `sym_lo`/`sym_hi` — what the paper's index stores."""
    return (isax.beta_lower(sym_lo, breakpoints),
            isax.beta_upper(sym_hi, breakpoints))
