"""Plain PyTorch versions of the port's hand-written kernels.

Each function computes exactly what its CUDA kernel computes (same
inputs, same clamping, same float32 formulas); only the order of the
float32 sums differs.  The kernel wrappers run these for CPU tensors,
and the tests and `chip_smoke.py` hold the kernels against them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import dtw
from repro_torch.core.bounds import (envelope_breakpoint_bounds,
                                     interval_mindist)

# the per-master envelope entry's sentinels for cells never valid (the
# TPU kernel's +/-BIG; the build entry finalizes to -inf / +inf instead)
ENVELOPE_BIG = 3.0e38


def ieee_sqrt(x: torch.Tensor) -> torch.Tensor:
    """A correctly rounded float32 square root on every device, as CUDA's
    `sqrtf`: torch's vectorized float32 sqrt on the CPU is not (an ulp
    off for ~13% of uniform inputs with the AVX512 kernels), while the
    float64 root rounded to float32 is (53 >= 2 * 24 + 2 bits)."""
    return torch.sqrt(x.double()).float()


def true_div(x: torch.Tensor, d) -> torch.Tensor:
    """x / d as an IEEE division on every device: torch divides a CUDA
    tensor by a Python number through its reciprocal, so the divisor is
    made a tensor on x's device."""
    return x / torch.tensor(float(d), dtype=x.dtype, device=x.device)


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
        mu_c = true_div(s1, qlen)            # the kernel's IEEE division
        var = true_div(s2, qlen) - mu_c * mu_c
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


def batch_ed_ref(windows: torch.Tensor, queries: torch.Tensor,
                 znorm: bool) -> torch.Tensor:
    """Squared ED of windows (N, L) against queries (Qb, L): (N, Qb).

    The dot identity of `batch_ed_pallas`: Z-normalized (queries already
    normalized) 2L - 2 dot / sd_w with mu = sum(w) * (1/L) and
    sd = max(sqrt(max(sum(w^2) * (1/L) - mu^2, 0)), 1e-8); raw
    sum(w^2) - 2 dot + sum(q^2).  Clamped at 0.
    """
    l = windows.shape[-1]
    dots = windows @ queries.t()                             # (N, Qb)
    if znorm:
        inv_l = float(np.float32(1.0) / np.float32(l))
        mu = windows.sum(dim=-1) * inv_l
        var = (windows * windows).sum(dim=-1) * inv_l - mu * mu
        sd = torch.sqrt(var.clamp_min(0.0)).clamp_min(1e-8)
        d2 = 2.0 * l - (2.0 * dots) / sd[:, None]
    else:
        wss = (windows * windows).sum(dim=-1)
        qss = (queries * queries).sum(dim=-1)
        d2 = wss[:, None] - 2.0 * dots + qss[None, :]
    return d2.clamp_min(0.0)


def lb_keogh_ref(env_lo: torch.Tensor, env_hi: torch.Tensor,
                 windows: torch.Tensor) -> torch.Tensor:
    """Squared LB_Keogh (paper Eq. 6) of windows (N, L) against one
    envelope (L,): (N,)."""
    return dtw.lb_keogh(env_lo, env_hi, windows, squared=True)


def _znorm_stats(s1, s2, lprime: torch.Tensor):
    """(mu, sigma) of windows of length lprime (a float32 tensor on their
    device, so the divisions are IEEE) from their sum s1 and sum of
    squares s2: the JAX build's float32 formulas."""
    mu = s1 / lprime
    var = (s2 / lprime - mu * mu).clamp_min(0.0)
    return mu, ieee_sqrt(var).clamp_min(1e-8)


def envelope_scan_ref(segmean, s1, s2, offsets, *, n: int, lmin: int,
                      seg_len: int):
    """Alg. 2 length reduction per master, materialized (the TPU
    kernel's contract, `envelope_znorm_pallas`).

    segmean (M, w) segment means per master offset, s1/s2 (M, L) window
    sums and sums of squares for lengths lmin .. lmin + L - 1, offsets
    (M,).  Returns (lo, hi) (M, w): the min / max over lengths of
    (segmean - mu) / sigma, over cells with (z+1) * seg_len <= l' and
    offset + l' <= n; where no cell is valid lo stays +ENVELOPE_BIG and
    hi -ENVELOPE_BIG.
    """
    m, w = segmean.shape
    n_len = s1.shape[1]
    dev = segmean.device
    lprime = lmin + torch.arange(n_len, device=dev)
    mu, sigma = _znorm_stats(s1, s2, lprime.to(torch.float32)[None, :])
    vals = (segmean[:, None, :] - mu[..., None]) / sigma[..., None]
    seg_end = (torch.arange(w, device=dev) + 1) * seg_len
    mask = ((seg_end[None, None, :] <= lprime[None, :, None])
            & ((offsets.long()[:, None] + lprime) <= n)[..., None])
    lo = torch.where(mask, vals, ENVELOPE_BIG).amin(dim=1)
    hi = torch.where(mask, vals, -ENVELOPE_BIG).amax(dim=1)
    return lo, hi


def envelope_znorm_ref(csum: torch.Tensor, csum2: torch.Tensor, *,
                       lmin: int, lmax: int, gamma: int, seg_len: int):
    """Z-normalized envelopes (paper Alg. 2) of S series from their
    float32 prefix sums csum / csum2 (S, n+1) of the centered values and
    their squares: (lo, hi) (S, n_env, w).

    The loop over lengths l' = lmin .. lmax of the JAX build: for every
    (anchor, master offset o, segment z) the normalized PAA value
    (segsum(o, z) / s - mu(o, l')) / sigma(o, l') under (z+1) * s <= l'
    and o + l' <= n, min/max-reduced over masters and lengths; segments
    no cell touched get (-inf, +inf).
    """
    s_cnt, np1 = csum.shape
    n = np1 - 1
    dev = csum.device
    g = gamma + 1
    w = lmax // seg_len
    n_env = -(-(n - lmin + 1) // g)
    off = (torch.arange(n_env, device=dev)[:, None] * g
           + torch.arange(g, device=dev))                    # (n_env, g)
    z_end = (torch.arange(w, device=dev) + 1) * seg_len      # (w,)
    start = off[..., None] + z_end - seg_len                 # (n_env, g, w)
    seg_mean = true_div(csum[:, (start + seg_len).clamp(max=n)]
                        - csum[:, start.clamp(max=n)], seg_len)
    o = off.clamp(max=n)
    c_start, c2_start = csum[:, o], csum2[:, o]              # (S, n_env, g)
    lo = torch.full((s_cnt, n_env, w), float("inf"), device=dev)
    hi = torch.full((s_cnt, n_env, w), -float("inf"), device=dev)
    for lprime in range(lmin, lmax + 1):
        end = off + lprime
        end_c = end.clamp(max=n)
        mu, sigma = _znorm_stats(
            csum[:, end_c] - c_start, csum2[:, end_c] - c2_start,
            torch.tensor(float(lprime), device=dev))
        vals = (seg_mean - mu[..., None]) / sigma[..., None]
        mask = (end <= n)[..., None] & (z_end <= lprime)    # (n_env, g, w)
        lo = torch.minimum(lo, torch.where(mask, vals, float("inf"))
                           .amin(dim=2))
        hi = torch.maximum(hi, torch.where(mask, vals, -float("inf"))
                           .amax(dim=2))
    untouched = lo > hi
    return (torch.where(untouched, -float("inf"), lo),
            torch.where(untouched, float("inf"), hi))
