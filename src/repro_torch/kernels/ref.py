"""Plain PyTorch versions of the port's hand-written kernels.

Each function computes exactly what its CUDA kernel computes (same
inputs, same clamping, same float32 formulas); only the order of the
float32 sums differs.  The kernel wrappers run these for CPU tensors,
and the tests and `chip_smoke.py` hold the kernels against them.
"""
from __future__ import annotations

import torch

from repro_torch.core import dtw
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


def _regions(data, sids, anchors, qlen: int, g: int):
    """The (E, qlen + g - 1) region of each row e: data[sids[e],
    anchors[e] : anchors[e] + qlen + g - 1] as one flat read clipped to
    the array (a region overrunning its series reads into the next row)."""
    s, n = data.shape
    flat = (sids.long()[:, None] * n + anchors.long()[:, None]
            + torch.arange(qlen + g - 1, device=data.device)
            ).clamp(0, s * n - 1)
    return data.reshape(-1)[flat]


def _window_sums(csum, csum2, csum_lo, csum2_lo, sids, anchors, qlen: int,
                 g: int):
    """(s1, s2), each (E, g): the centered sum and sum of squares of
    window j of every row, from the hi/lo prefix sums at offsets clipped
    to [0, n - qlen] (flat positions clipped to the array)."""
    s, np1 = csum.shape
    last = s * np1 - 1
    sid = sids.long()[:, None]
    offs = (anchors.long()[:, None] + torch.arange(g, device=csum.device)
            ).clamp(0, np1 - 1 - qlen)
    i0 = (sid * np1 + offs).clamp(0, last)
    i1 = (sid * np1 + offs + qlen).clamp(0, last)

    def wsum(hi, lo):
        hi = hi.reshape(-1)
        lo = lo.reshape(-1)
        return (hi[i1] - hi[i0]) + (lo[i1] - lo[i0])

    return wsum(csum, csum_lo), wsum(csum2, csum2_lo)


def fused_gather_ed_ref(data, csum, csum2, csum_lo, csum2_lo, center,
                        sids, anchors, qs, *, g: int, rows: int,
                        znorm: bool) -> torch.Tensor:
    """Squared ED of B queries' candidate chunks: (B * rows, g) float32.

    Row e = b * rows + r gathers its region (`_regions`), and entry
    (e, j) is the dot-identity ED of window j of that region against
    q_b, with window sums from the prefix sums (`_window_sums`).  Windows
    overrunning their series are garbage; the caller masks them.
    """
    qlen = qs.shape[1]
    windows = _regions(data, sids, anchors, qlen, g).unfold(1, qlen, 1)
    q_rows = qs.repeat_interleave(rows, dim=0)               # (E, qlen)
    dots = torch.bmm(windows, q_rows[:, :, None])[..., 0]    # (E, g)
    s1, s2 = _window_sums(csum, csum2, csum_lo, csum2_lo, sids, anchors,
                          qlen, g)
    if znorm:
        mu_c = s1 / qlen
        var = s2 / qlen - mu_c * mu_c
        sd = torch.sqrt(var.clamp_min(0.0)).clamp_min(1e-8)
        d2 = 2.0 * qlen - 2.0 * dots / sd
    else:
        c = center[sids.long()][:, None]
        wss = s2 + 2.0 * c * s1 + qlen * c * c   # un-centered sum(w^2)
        qss = (qs * qs).sum(dim=-1).repeat_interleave(rows)[:, None]
        d2 = wss - 2.0 * dots + qss
    return d2.clamp_min(0.0)


def fused_gather_lb_keogh_ref(data, csum, csum2, csum_lo, csum2_lo, center,
                              sids, anchors, dtw_lo, dtw_hi, *, g: int,
                              rows: int, znorm: bool):
    """Squared LB_Keogh of B queries' candidate chunks, with the window
    normalization the DP tier reuses: (lb2, mu, sd), each (B * rows, g).

    Same gather and window sums as `fused_gather_ed_ref`; then
    mu = s1 / qlen + center[sid] and sd = max(sqrt(max(s2 / qlen -
    mu_c^2, 0)), 1e-8) (raw mode: mu = 0, sd = 1), window j is
    w = (region[j : j + qlen] - mu_j) / sd_j, and lb2 sums over^2 +
    under^2 against the query's DTW envelope dtw_lo/dtw_hi (B, qlen).
    """
    qlen = dtw_lo.shape[1]
    windows = _regions(data, sids, anchors, qlen, g).unfold(1, qlen, 1)
    if znorm:
        s1, s2 = _window_sums(csum, csum2, csum_lo, csum2_lo, sids,
                              anchors, qlen, g)
        # a true division, as the kernel's: on the card torch divides by
        # a Python number through its reciprocal
        length = torch.tensor(float(qlen), device=data.device)
        mu_c = s1 / length
        var = s2 / length - mu_c * mu_c
        sd = torch.sqrt(var.clamp_min(0.0)).clamp_min(1e-8)
        mu = mu_c + center[sids.long()][:, None]
    else:
        mu = torch.zeros(windows.shape[:2], device=data.device)
        sd = torch.ones_like(mu)
    w = (windows - mu[..., None]) / sd[..., None]            # (E, g, qlen)
    hi = dtw_hi.repeat_interleave(rows, dim=0)[:, None, :]
    lo = dtw_lo.repeat_interleave(rows, dim=0)[:, None, :]
    over = (w - hi).clamp_min(0.0)
    under = (lo - w).clamp_min(0.0)
    return (over * over + under * under).sum(dim=-1), mu, sd


def dtw_band_ref(q: torch.Tensor, candidates: torch.Tensor,
                 r: int) -> torch.Tensor:
    """Squared banded DTW of q (l,) against candidates (N, l): (N,)."""
    return dtw.dtw_band(q, candidates, r, squared=True)


def dtw_survivors_ref(data, qs, sidx, nsurv, cand_sid, cand_off, mu, sd, *,
                      r: int, znorm: bool) -> torch.Tensor:
    """Squared banded DTW of the LB survivors of B queries' chunks.

    sidx (B, M) holds the survivors' candidate positions packed first,
    nsurv (B,) their counts; cand_sid/cand_off/mu/sd (B, M) describe the
    chunk's candidates.  Slot p < nsurv[b] is the DTW of q_b against the
    window data[sid, clip(off, 0, n - qlen) : + qlen] (flat read clipped
    to the array), normalized by that candidate's (mu, sd) when znorm;
    every other slot is +inf.  Returns (B, M) float32.
    """
    s, n = data.shape
    b_sz, m = sidx.shape
    qlen = qs.shape[1]
    live = torch.arange(m, device=sidx.device)[None, :] < nsurv[:, None]
    pick = sidx.long()[live]                                 # (L,)
    rows = torch.arange(b_sz, device=sidx.device)[:, None].expand(
        b_sz, m)[live]
    flat = ((cand_sid.long()[rows, pick] * n
             + cand_off.long()[rows, pick].clamp(0, n - qlen))[:, None]
            + torch.arange(qlen, device=data.device)).clamp(0, s * n - 1)
    wb = data.reshape(-1)[flat]                              # (L, qlen)
    if znorm:
        wb = ((wb - mu[rows, pick][:, None]) / sd[rows, pick][:, None])
    out = torch.full((b_sz, m), float("inf"), device=data.device)
    out[live] = dtw.dtw_band(qs[rows], wb, r, squared=True)
    return out
