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


def chunk_candidates(csid, canc, cnm, keep, qlen: int, n: int, g: int):
    """Expand a chunk's envelopes into per-offset candidates.

    csid/canc/cnm/keep (B, rows).  Returns (ok, cand_sid, cand_off) each
    (B, rows * g): ok masks offsets that are real masters, fit the
    series, and belong to a kept (unpruned) envelope; position r * g + j
    is offset j of row r.
    """
    b_sz, rows = csid.shape
    joff = torch.arange(g, dtype=torch.int32, device=csid.device)
    offs = canc[:, :, None] + joff                       # (B, rows, g)
    ok = ((joff < cnm[:, :, None]) & (offs + qlen <= n)
          & keep[:, :, None]).reshape(b_sz, rows * g)
    return (ok, csid[:, :, None].expand(b_sz, rows, g).reshape(
        b_sz, rows * g), offs.reshape(b_sz, rows * g))


def scan_active(lbs2, pool_d2, i: int, chunk: int):
    """(B,) bool: query b still scans at chunk i of its LB-sorted plan —
    the chunk's first bound (its best case) is finite and below the
    pool's k-th distance."""
    first = lbs2[:, min(i * chunk, lbs2.shape[1] - 1)]
    return torch.isfinite(first) & (first < pool_d2[:, -1])


def range_active(lbs2, eps2, ovf, i: int, chunk: int):
    """(B,) bool: query b's range scan still runs at chunk i of its packed
    plan — the chunk's first bound is finite and <= eps2, and the hit
    buffer has not overflowed (ovf == the plan's chunk count)."""
    first = lbs2[:, min(i * chunk, lbs2.shape[1] - 1)]
    return (torch.isfinite(first) & (first <= eps2)
            & (ovf == lbs2.shape[1] // chunk))


def _chunk_cut(sids, anchors, n_master, lbs2, active, cut, inclusive: bool,
               i: int, chunk: int, qlen: int, n: int, g: int):
    """Chunk i of the (B, n_pad) plan under a cut: its columns (csid,
    canc, clb2), the kept rows (keep: active and lbs2 < cut, or <= cut
    when inclusive) and `chunk_candidates` of them (ok, cand_sid,
    cand_off)."""
    sl = slice(i * chunk, (i + 1) * chunk)
    csid, canc, cnm, clb2 = (t[:, sl] for t in (sids, anchors, n_master,
                                                  lbs2))
    below = clb2 <= cut[:, None] if inclusive else clb2 < cut[:, None]
    keep = below & active[:, None]
    ok, cand_sid, cand_off = chunk_candidates(csid, canc, cnm, keep, qlen,
                                              n, g)
    return csid, canc, clb2, keep, ok, cand_sid, cand_off


def _add_counts(stats, active, keep, clb2, ok_col: int, n_ok, n_true):
    """Add [active, kept rows, true distances, LB_Keogh, full DPs, pruned
    rows] to the (B, 6) int32 `stats` in place: n_ok in column ok_col
    (ED: true distances; DTW: LB_Keogh), n_true in columns 2 and 4 (DTW's
    survivors) or none; pruned is a finite bound of an active query that
    was not kept."""
    zeros = torch.zeros_like(active, dtype=torch.int32)
    cols = [active.to(torch.int32), keep.sum(dim=1, dtype=torch.int32),
            zeros, zeros, zeros,
            (torch.isfinite(clb2) & active[:, None] & ~keep).sum(
                dim=1, dtype=torch.int32)]
    cols[ok_col] = n_ok
    if n_true is not None:
        cols[2] = cols[4] = n_true
    stats += torch.stack(cols, dim=1)


def _ed_chunk_d2(data, csum, csum2, csum_lo, csum2_lo, center, sids,
                 anchors, n_master, lbs2, qs, stats, active, cut,
                 inclusive: bool, i: int, chunk: int, g: int, znorm: bool,
                 dist):
    """The ED chunk step's shared part: chunk i under the cut, the
    counters added, and the (B, chunk * g) d2 of the ok candidates (+inf
    elsewhere), with their (sid, off)."""
    n = data.shape[1]
    b_sz, qlen = qs.shape
    csid, canc, clb2, keep, ok, cand_sid, cand_off = _chunk_cut(
        sids, anchors, n_master, lbs2, active, cut, inclusive, i, chunk,
        qlen, n, g)
    if dist is None:
        dist = fused_gather_ed_ref(
            data, csum, csum2, csum_lo, csum2_lo, center,
            csid.reshape(-1).contiguous(), canc.reshape(-1).contiguous(), qs,
            g=g, rows=chunk, znorm=znorm)
    d2 = torch.where(ok, dist.reshape(b_sz, chunk * g), float("inf"))
    _add_counts(stats, active, keep, clb2, 2,
                ok.sum(dim=1, dtype=torch.int32), None)
    return d2, cand_sid, cand_off


def fused_gather_ed_chunk_ref(data, csum, csum2, csum_lo, csum2_lo, center,
                              sids, anchors, n_master, lbs2, qs, pool_d2,
                              stats, *, i: int, chunk: int, g: int,
                              znorm: bool, dist=None) -> torch.Tensor:
    """The scan's ED step over chunk i of the (B, n_pad) LB-sorted plan
    (sids, anchors, n_master, lbs2), against the pool's (B, k) d2.

    Query b is active when `scan_active`; row r is kept when active and
    lbs2 < kth = pool_d2[b, k - 1]; candidate (r, j) is ok where
    `chunk_candidates` says so.  Adds [active, kept rows, ok candidates,
    0, 0, pruned rows] to the (B, 6) int32 `stats` in place (pruned: a
    finite bound of an active query that was not kept).  `dist` is the
    chunk's (B * chunk, g) squared ED (default `fused_gather_ed_ref`'s).
    Returns the candidates as (4, B, chunk * g) int32 partials: d2 (+inf
    where not ok, as float32 bits), sid, off and position r * g + j.
    """
    b_sz = qs.shape[0]
    d2, cand_sid, cand_off = _ed_chunk_d2(
        data, csum, csum2, csum_lo, csum2_lo, center, sids, anchors,
        n_master, lbs2, qs, stats, scan_active(lbs2, pool_d2, i, chunk),
        pool_d2[:, -1], False, i, chunk, g, znorm, dist)
    pos = torch.arange(chunk * g, dtype=torch.int32, device=qs.device)
    return torch.stack([d2.view(torch.int32), cand_sid, cand_off,
                        pos.expand(b_sz, chunk * g)])


def fused_gather_ed_range_ref(data, csum, csum2, csum_lo, csum2_lo, center,
                              sids, anchors, n_master, lbs2, qs, eps2, ovf,
                              stats, *, i: int, chunk: int, g: int,
                              znorm: bool, dist=None) -> torch.Tensor:
    """The range mode of `fused_gather_ed_chunk_ref` (the eps-range
    scan's ED step): query b is active when `range_active` (which reads
    the hit buffer's ovf (B,)), row r is kept when active and lbs2 <=
    eps2[b] (inclusive), and the counters are added as in the k-NN mode.
    Returns the dense (B, chunk * g) d2 of the ok candidates, +inf
    wherever not ok."""
    return _ed_chunk_d2(
        data, csum, csum2, csum_lo, csum2_lo, center, sids, anchors,
        n_master, lbs2, qs, stats, range_active(lbs2, eps2, ovf, i, chunk),
        eps2, True, i, chunk, g, znorm, dist)[0]


def range_append_ref(d2, sids, anchors, eps2, buf, cnt, ovf, *, i: int,
                     chunk: int, g: int) -> None:
    """Append chunk i's hits to the range scan's hit buffer, in place.

    d2 (B, chunk * g) is the step's dense distance row (+inf where no
    distance was verified), sids/anchors (B, n_pad) the packed plan
    (position p is plan row i * chunk + p // g, offset p % g), eps2 (B,);
    buf = (d2, sid, off) (B, cap), cnt (B,) int32 its fill counts and ovf
    (B,) int32 the first chunk whose hits were not written (n_pad //
    chunk while none).  A hit is a finite d2 <= eps2.  Where cnt + hits >
    cap none is written and ovf becomes i (if not set); else the hits go
    to slots cnt, cnt + 1, ... in position order and cnt grows by them —
    the reference's buffer, bit for bit."""
    bd2, bsid, boff = buf
    cap = bd2.shape[1]
    n_chunks = sids.shape[1] // chunk
    hit = torch.isfinite(d2) & (d2 <= eps2[:, None])
    nh = hit.sum(dim=1, dtype=torch.int32)
    over = cnt + nh > cap
    ovf.copy_(torch.where(over & (ovf == n_chunks), i, ovf))
    rows, pos = (hit & ~over[:, None]).nonzero(as_tuple=True)
    rank = torch.cumsum(hit, dim=1) - 1
    slot = cnt.long()[rows] + rank[rows, pos]
    col = i * chunk + pos // g
    bd2[rows, slot] = d2[rows, pos]
    bsid[rows, slot] = sids[rows, col]
    boff[rows, slot] = anchors[rows, col] + (pos % g).to(anchors.dtype)
    cnt += torch.where(over, 0, nh)


def pool_merge_ref(pool, cd2, csid, coff):
    """Merge (B, M) candidates into a (B, k) pool sorted by d2: the new
    pool is the stable sort of [pool | candidates] by d2, truncated to
    k — incumbents win ties, then candidates in column order (the tie
    order of the reference's `lax.top_k`).  Returns new (d2, sid, off)."""
    pd2, psid, poff = pool
    k = pd2.shape[1]
    alld = torch.cat([pd2, cd2], dim=1)
    sel = torch.sort(alld, dim=1, stable=True).indices[:, :k]
    return (torch.gather(alld, 1, sel),
            torch.gather(torch.cat([psid, csid], dim=1), 1, sel),
            torch.gather(torch.cat([poff, coff], dim=1), 1, sel))


def pool_merge_partials_ref(pool, part):
    """`pool_merge_ref` of (4, B, P) int32 partials (d2 as float32 bits,
    sid, off, position): the candidates in position order (a position is
    unique within a query's chunk; empty entries are +inf and never enter
    a pool)."""
    order = torch.argsort(part[3], dim=1, stable=True)
    d2, sid, off = (torch.gather(part[c], 1, order) for c in range(3))
    return pool_merge_ref(pool, d2.view(torch.float32), sid, off)


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


def wavefront_dtw(q: torch.Tensor, c: torch.Tensor, r: int) -> torch.Tensor:
    """Squared banded DTW of q (l,), or one query per candidate (N, l),
    against candidates c (N, l): (N,) float32, by the `dtw_band` kernels'
    own arithmetic.

    Each cell is one float32 add of its cost (q_i - c_j)^2 to the min of
    its three neighbours, the row recurrence's rounding, computed along
    anti-diagonals: slot k = i - j + rr (rr = min(r, l - 1)) of diagonal
    t holds cell ((t + k - rr) / 2, (t - k + rr) / 2), and a diagonal
    updates the slots of t + rr's parity from the others (up k - 1, left
    k + 1) and from itself (diag), +inf off the series and past the
    band.  So it gives the kernels' bits.  (`core/dtw.dtw_band`, the
    brute-force oracle's DP, is the closed form, whose float32 cumsum over
    the band cancels once the band is wide: ROADMAP Queue 3 P6.)
    """
    n_cand, l = c.shape
    rr = min(r, l - 1)
    band = 2 * rr + 1
    qq = q.expand(n_cand, l) if q.dim() == 1 else q
    inf = float("inf")
    st = torch.full((band + 2, n_cand), inf, dtype=c.dtype, device=c.device)
    st[rr + 1] = 0.0                      # D[-1, -1] in slot rr
    slots = [torch.arange(p, band, 2, device=c.device) for p in (0, 1)]
    for t in range(2 * l - 1):
        k = slots[(t + rr) % 2]
        i, j = (t + k - rr) // 2, (t - k + rr) // 2
        inside = (i >= 0) & (i < l) & (j >= 0) & (j < l)
        diff = qq[:, i.clamp(0, l - 1)] - c[:, j.clamp(0, l - 1)]
        cost = torch.where(inside[:, None], (diff * diff).t(), inf)
        st[k + 1] = cost + torch.minimum(torch.minimum(st[k + 1], st[k]),
                                         st[k + 2])
    return st[rr + 1].clone()


def dtw_band_ref(q: torch.Tensor, candidates: torch.Tensor,
                 r: int) -> torch.Tensor:
    """Squared banded DTW of q (l,) against candidates (N, l): (N,)."""
    return wavefront_dtw(q, candidates, r)


def _lb_chunk_ref(data, csum, csum2, csum_lo, csum2_lo, center, sids,
                  anchors, n_master, lbs2, dtw_lo, dtw_hi, stats, active,
                  cut, inclusive: bool, i: int, chunk: int, g: int,
                  znorm: bool):
    n = data.shape[1]
    b_sz, qlen = dtw_lo.shape
    csid, canc, clb2, keep, ok, cand_sid, cand_off = _chunk_cut(
        sids, anchors, n_master, lbs2, active, cut, inclusive, i, chunk,
        qlen, n, g)
    lb2, mu, sd = fused_gather_lb_keogh_ref(
        data, csum, csum2, csum_lo, csum2_lo, center,
        csid.reshape(-1).contiguous(), canc.reshape(-1).contiguous(), dtw_lo,
        dtw_hi, g=g, rows=chunk, znorm=znorm)
    lb2 = torch.where(ok.reshape(lb2.shape), lb2, float("inf"))
    flat = lb2.reshape(b_sz, -1)
    surv = ok & (flat <= cut[:, None] if inclusive else flat < cut[:, None])
    slist = torch.argsort((~surv).to(torch.uint8), dim=1, stable=True)
    nsurv = surv.sum(dim=1, dtype=torch.int32)
    _add_counts(stats, active, keep, clb2, 3,
                ok.sum(dim=1, dtype=torch.int32), nsurv)
    d2 = torch.where(surv, float("nan"), float("inf"))
    return (lb2, mu, sd, slist.to(torch.int32), nsurv, d2, cand_sid,
            cand_off)


def fused_gather_lb_keogh_chunk_ref(data, csum, csum2, csum_lo, csum2_lo,
                                    center, sids, anchors, n_master, lbs2,
                                    dtw_lo, dtw_hi, pool_d2, stats, *,
                                    i: int, chunk: int, g: int,
                                    znorm: bool):
    """The scan's LB_Keogh step over chunk i of the (B, n_pad) LB-sorted
    plan (sids, anchors, n_master, lbs2), against the pool's (B, k) d2:
    `fused_gather_lb_keogh_ref` of the chunk's rows, masked, its
    survivors listed, the DP's output prepared and the counters added.

    Query b is active when `scan_active`, a row kept when active and
    lbs2 < kth = pool_d2[b, k - 1], candidate (r, j) ok where
    `chunk_candidates` says so, and a survivor an ok candidate with lb2 <
    kth.  Adds [active, kept rows, survivors, ok candidates, survivors,
    pruned rows] to the (B, 6) int32 `stats` in place.  Returns (lb2,
    mu, sd, slist, nsurv, d2, cand_sid, cand_off): lb2/mu/sd (B * chunk,
    g) with lb2 = +inf where not ok; query b's survivors are the
    positions slist[b, :nsurv[b]] (int32, ascending here; the kernel's
    order varies), followed by the other positions; d2 (B, M = chunk * g)
    float32 is +inf at every non-survivor and NaN at the survivors, which
    the DP fills; cand_sid/cand_off (B, M) int32 every candidate's
    (sid, off).
    """
    return _lb_chunk_ref(
        data, csum, csum2, csum_lo, csum2_lo, center, sids, anchors,
        n_master, lbs2, dtw_lo, dtw_hi, stats,
        scan_active(lbs2, pool_d2, i, chunk), pool_d2[:, -1], False, i,
        chunk, g, znorm)


def fused_gather_lb_keogh_range_ref(data, csum, csum2, csum_lo, csum2_lo,
                                    center, sids, anchors, n_master, lbs2,
                                    dtw_lo, dtw_hi, eps2, ovf, stats, *,
                                    i: int, chunk: int, g: int,
                                    znorm: bool):
    """The range mode of `fused_gather_lb_keogh_chunk_ref` (the eps-range
    scan's DTW step): query b is active when `range_active` (which reads
    the hit buffer's ovf (B,)); rows are kept and candidates survive at
    lbs2 <= eps2[b] and lb2 <= eps2[b] (inclusive: lb <= d, so a boundary
    hit survives).  The same outputs and counters."""
    return _lb_chunk_ref(
        data, csum, csum2, csum_lo, csum2_lo, center, sids, anchors,
        n_master, lbs2, dtw_lo, dtw_hi, stats,
        range_active(lbs2, eps2, ovf, i, chunk), eps2, True, i, chunk, g,
        znorm)


def gather_znorm_ref(data, sids, anchors, mu, sd, *, qlen: int, g: int):
    """The normalized windows of the LB_Keogh and DP tiers: window j of
    row e is (region_e[j : j + qlen] - mu[e, j]) / sd[e, j], an IEEE
    subtract and divide.  Returns (E * g, qlen) float32."""
    windows = _regions(data, sids, anchors, qlen, g).unfold(1, qlen, 1)
    return ((windows - mu[..., None]) / sd[..., None]).reshape(-1, qlen)


def dtw_survivors_ref(data, qs, slist, nsurv, cand_sid, cand_off, mu, sd,
                      d2, *, r: int, znorm: bool) -> torch.Tensor:
    """Squared banded DTW of the LB survivors of B queries' chunks,
    written into d2 (B, M) at their positions (in place; returns d2).

    slist[b, :nsurv[b]] holds query b's survivors' candidate positions (in
    any order); cand_sid/cand_off/mu/sd (B, M) describe the chunk's
    candidates.  Position p gets the DTW of q_b against the window
    data[sid, clip(off, 0, n - qlen) : + qlen] (flat read clipped to the
    array), normalized by the candidate's (mu, sd) when znorm; every
    other position of d2 is left as it is.
    """
    s, n = data.shape
    b_sz, m = slist.shape
    qlen = qs.shape[1]
    live = torch.arange(m, device=slist.device)[None, :] < nsurv[:, None]
    pick = slist.long()[live]                                # (L,)
    rows = torch.arange(b_sz, device=slist.device)[:, None].expand(
        b_sz, m)[live]
    flat = ((cand_sid.long()[rows, pick] * n
             + cand_off.long()[rows, pick].clamp(0, n - qlen))[:, None]
            + torch.arange(qlen, device=data.device)).clamp(0, s * n - 1)
    wb = data.reshape(-1)[flat]                              # (L, qlen)
    if znorm:
        wb = ((wb - mu[rows, pick][:, None]) / sd[rows, pick][:, None])
    d2[rows, pick] = wavefront_dtw(qs[rows], wb, r)
    return d2


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
