"""Plain PyTorch versions of the port's hand-written kernels.

Each function computes exactly what its CUDA kernel computes (same
inputs, same clamping, same float32 formulas); only the order of the
float32 sums differs.  The kernel wrappers run these for CPU tensors,
and the tests and `chip_smoke.py` hold the kernels against them.
"""
from __future__ import annotations

import torch

from repro_torch.core.bounds import (envelope_breakpoint_bounds,
                                     interval_mindist)


def mindist_ref(q_lo: torch.Tensor, q_hi: torch.Tensor, e_lo: torch.Tensor,
                e_hi: torch.Tensor, valid: torch.Tensor, seg_len: int,
                nseg: int) -> torch.Tensor:
    """Interval lower bounds of B query intervals (B, w) against N
    envelope intervals (N, w): (B, N), +inf where `valid` is False."""
    d = interval_mindist(q_lo, q_hi, e_lo, e_hi, seg_len, nseg)
    return torch.where(valid[None, :], d, float("inf"))


def mindist_sym_ref(q_lo, q_hi, sym_lo, sym_hi, breakpoints, valid,
                    seg_len: int, nseg: int) -> torch.Tensor:
    """mindist_ref on the envelopes' iSAX symbols: the intervals are the
    symbols' outer breakpoints [beta_l(sym_lo), beta_u(sym_hi)]."""
    e_lo, e_hi = envelope_breakpoint_bounds(sym_lo, sym_hi, breakpoints)
    return mindist_ref(q_lo, q_hi, e_lo, e_hi, valid, seg_len, nseg)


def fused_gather_ed_ref(data, csum, csum2, csum_lo, csum2_lo, center,
                        sids, anchors, qs, *, g: int, rows: int,
                        znorm: bool) -> torch.Tensor:
    """Squared ED of B queries' candidate chunks: (B * rows, g) float32.

    Row e = b * rows + r gathers the region data[sids[e], anchors[e] :
    anchors[e] + qlen + g - 1] as one flat read clipped to the array
    (a region overrunning its series reads into the next row), and entry
    (e, j) is the dot-identity ED of window j of that region against
    q_b, with window sums from the hi/lo prefix sums at offsets clipped
    to [0, n - qlen].  Windows overrunning their series are garbage; the
    caller masks them.
    """
    s, n = data.shape
    b, qlen = qs.shape
    reg = qlen + g - 1
    dev = data.device
    sid = sids.long()
    anc = anchors.long()
    flat = (sid[:, None] * n + anc[:, None]
            + torch.arange(reg, device=dev)).clamp(0, s * n - 1)
    region = data.reshape(-1)[flat]                          # (E, reg)
    windows = region.unfold(1, qlen, 1)                      # (E, g, qlen)
    q_rows = qs.repeat_interleave(rows, dim=0)               # (E, qlen)
    dots = torch.bmm(windows, q_rows[:, :, None])[..., 0]    # (E, g)

    np1 = n + 1
    last = s * np1 - 1
    offs = (anc[:, None] + torch.arange(g, device=dev)).clamp(0, n - qlen)
    i0 = (sid[:, None] * np1 + offs).clamp(0, last)
    i1 = (sid[:, None] * np1 + offs + qlen).clamp(0, last)

    def wsum(hi, lo):
        hi = hi.reshape(-1)
        lo = lo.reshape(-1)
        return (hi[i1] - hi[i0]) + (lo[i1] - lo[i0])

    s1 = wsum(csum, csum_lo)
    s2 = wsum(csum2, csum2_lo)
    if znorm:
        mu_c = s1 / qlen
        var = s2 / qlen - mu_c * mu_c
        sd = torch.sqrt(var.clamp_min(0.0)).clamp_min(1e-8)
        d2 = 2.0 * qlen - 2.0 * dots / sd
    else:
        c = center[sid][:, None]
        wss = s2 + 2.0 * c * s1 + qlen * c * c   # un-centered sum(w^2)
        qss = (qs * qs).sum(dim=-1).repeat_interleave(rows)[:, None]
        d2 = wss - 2.0 * dots + qss
    return d2.clamp_min(0.0)
