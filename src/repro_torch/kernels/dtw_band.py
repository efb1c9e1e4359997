"""Squared Sakoe-Chiba banded DTW: the `dtw_band` kernels.

The port's counterpart of `repro/kernels/dtw_band.py::dtw_band_pallas`,
placed where the reference search runs the same DP in jnp: on the
LB_Keogh survivors of every scan chunk (`repro/core/executor.py::
_survivor_bucket`).  Four wrappers over `csrc/dtw_band.cu`:

  dtw_band       q (l,) against candidates (N, l) -> (N,), the function
                 of `dtw_band_pallas`;
  dtw_survivors  gather + normalize + DP of one chunk's survivors for all
                 B queries in one launch, from the list the LB_Keogh chunk
                 entry made, into the DP output it prepared (the
                 executor's call);
  dtw_band_wide, dtw_survivors_wide
                 the same functions for any band and any l
                 (`wide_plan`): a full band of up to 1,024 rows in row
                 strips, a warp a candidate; any other band in the warp
                 wavefront split over the S warps of a block (C slot
                 pairs a lane), q and the window streamed through
                 registers; past 7,680 band slots a block per candidate
                 with one barrier a diagonal.  `dtw_band` and
                 `dtw_survivors` take the warp entries where the band and
                 the staging fit them (2 min(r, l - 1) + 1 <= 1024 and
                 l <= 6144) and hand every other shape to these; both
                 give the same bits where both apply.

Inputs are checked on every device against what the kernel takes;
then CPU tensors take the plain versions in `ref.py` and CUDA tensors
launch the kernel.  Each wrapper counts its own launches in `.launches`
(a call handed to a wide wrapper counts there).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.kernels import _build, ref

# csrc/dtw_band.cu's warp entries: 32 lanes x 2 kMaxPairs band slots, and
# each warp's padded window and query in the opt-in shared memory
_MAX_BAND = 1024
_MAX_QLEN = 6144


def _check_band(what: str, l: int, r: int) -> None:
    if r < 1:
        raise ValueError(f"{what}: the warping window r must be >= 1")
    if l < 1:
        raise ValueError(f"{what}: qlen={l} must be >= 1")


def _warp_entry(l: int, r: int) -> bool:
    """Whether the warp entries take a DP of length l with window r."""
    return l <= _MAX_QLEN and 2 * min(r, l - 1) + 1 <= _MAX_BAND


# csrc/dtw_band.cu's segmented wide entries: lanes a warp owns when the
# band is split over warps, and the most warps a block takes at C pairs
# a lane (its registers)
_SEG_LANES = 30
_SEG_MAX_WARPS = {1: 32, 2: 32, 4: 32, 8: 16, 16: 8}
# the strip kernels (a full band): the most rows a lane holds
_STRIP_MAX_ROWS = 32


def _live_periods(l: int, rr: int, c: int, lo_slot: int, hi_slot: int
                  ) -> int:
    """Periods of C step pairs in which the owned slots [lo_slot,
    hi_slot] hold a cell inside the series (the kernel's skip test)."""
    off = rr & 1
    rp, top = rr + off, off + 2 * rr
    t0 = 2 * np.arange(0, l, c)
    t1 = t0 + 2 * c - 1
    lo = np.maximum(np.maximum(off, rp - t1), t0 + rp - 2 * l + 2)
    hi = np.minimum(np.minimum(top, t1 + rp), 2 * l - 2 - t0 + rp)
    return int(((lo <= hi) & (lo <= hi_slot) & (hi >= lo_slot)).sum())


@functools.lru_cache(maxsize=None)
def wide_plan(l: int, r: int) -> tuple:
    """The wide entries' kernel at qlen l and window r, as the (pairs,
    segs) they pass: a full band (r >= l - 1) of at most 1,024 rows takes
    the strip kernel, (H, -1): H rows a lane (a multiple of 4, 32H >= l),
    a warp a candidate, every cell computed once.  Any other band takes
    the segmented wavefront, (C, S): C slot pairs a lane and S warps a
    candidate (each owning 60C slots), the split that issues the fewest
    instructions (a step pair ~8C + 12 a warp, an exchange ~4C + 16,
    periods where a warp's slots lie off the series skipped); (0, 0)
    where no split takes the band (more than 7,680 slots: the block
    kernel)."""
    rr = min(r, l - 1)
    if rr >= l - 1 and l <= 32 * _STRIP_MAX_ROWS:
        return (max(4, -(-l // 128) * 4), -1)
    slots = (rr & 1) + 2 * rr + 1
    best = None
    for c in (1, 2, 4, 8, 16):
        own = 2 * _SEG_LANES * c
        s = -(-slots // own)
        if s > _SEG_MAX_WARPS[c] or (s > 1 and c == 1):
            continue
        live = sum(_live_periods(l, rr, c, own * w, own * (w + 1) - 1)
                   for w in range(s))
        cost = (live * c * (8 * c + 12)
                + (s > 1) * s * -(-l // c) * (4 * c + 16))
        best = min(best or (cost, c, s), (cost, c, s))
    return (0, 0) if best is None else best[1:]


def _wide_scratch(lib, dev, l: int, r: int):
    """(scratch, blocks) of the wide entries' block kernel at (l, r):
    none where its buffer fits shared memory, else a global slice for
    each of two blocks an SM."""
    per_block = lib.ulisse_dtw_wide_scratch(l, r)
    if per_block == 0:
        return None, 0
    blocks = 2 * torch.cuda.get_device_properties(dev).multi_processor_count
    return torch.empty(per_block * blocks, dtype=torch.float32,
                       device=dev), blocks


def _check_candidates(what: str, q, candidates, r: int) -> None:
    n_cand, l = candidates.shape
    _check_band(what, l, r)
    _build.check_tensors(what, q.device, (
        ("q", q, torch.float32, (l,)),
        ("candidates", candidates, torch.float32, (n_cand, l))))


def dtw_band(q: torch.Tensor, candidates: torch.Tensor,
             r: int) -> torch.Tensor:
    """Squared banded DTW of q (l,) float32 against candidates (N, l)
    float32 with warping window r >= 1 (r >= l covers the whole row).
    Returns (N,) float32."""
    dev = q.device
    n_cand, l = candidates.shape
    _check_candidates("dtw_band", q, candidates, r)
    if dev.type == "cpu":
        return ref.dtw_band_ref(q, candidates, r)
    if not _warp_entry(l, r):
        return dtw_band_wide(q, candidates, r)
    out = torch.empty(n_cand, dtype=torch.float32, device=dev)
    if n_cand == 0:
        return out
    lib = _build.library("dtw_band")
    code = lib.ulisse_dtw_band(q.data_ptr(), candidates.data_ptr(),
                               out.data_ptr(), n_cand, l, r,
                               torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "dtw_band")
    dtw_band.launches += 1
    return out


dtw_band.launches = 0


def dtw_band_wide(q: torch.Tensor, candidates: torch.Tensor,
                  r: int) -> torch.Tensor:
    """`dtw_band` through the wide entry, at any band and length."""
    dev = q.device
    n_cand, l = candidates.shape
    _check_candidates("dtw_band_wide", q, candidates, r)
    if dev.type == "cpu":
        return ref.dtw_band_ref(q, candidates, r)
    out = torch.empty(n_cand, dtype=torch.float32, device=dev)
    if n_cand == 0:
        return out
    lib = _build.library("dtw_band")
    pairs, segs = wide_plan(l, r)
    scratch, blocks = (None, 0) if segs else _wide_scratch(lib, dev, l, r)
    code = lib.ulisse_dtw_band_wide(
        q.data_ptr(), candidates.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), blocks, n_cand, l,
        r, pairs, segs, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "dtw_band_wide")
    dtw_band_wide.launches += 1
    return out


dtw_band_wide.launches = 0


def dtw_survivors(data: torch.Tensor, qs: torch.Tensor, slist: torch.Tensor,
                  nsurv: torch.Tensor, cand_sid: torch.Tensor,
                  cand_off: torch.Tensor, mu: torch.Tensor, sd: torch.Tensor,
                  d2: torch.Tensor, *, r: int, znorm: bool) -> torch.Tensor:
    """Squared banded DTW of the LB_Keogh survivors of one scan chunk,
    written in place into d2 (returned).

    data (S, n) float32; qs (B, qlen) prepared queries; slist (B, M)
    int32 and nsurv (B,) int32: query b's survivors are the candidate
    positions slist[b, :nsurv[b]], in any order (both from
    `fused_gather_lb_keogh_chunk`, and both stay on the device: no host
    sync); cand_sid/cand_off (B, M) int32 and mu/sd (B, M) float32 (the LB
    kernel's window normalization) describe the chunk's candidates; d2
    (B, M) float32 is the chunk entry's DP output, +inf at every
    non-survivor.  Position p = slist[b, i] gets the DTW^2 of q_b against
    candidate p's window data[sid, clip(off, 0, n - qlen) : + qlen],
    normalized with its (mu, sd) when znorm; other positions are left.
    """
    dev = data.device
    _check_survivors("dtw_survivors", data, qs, slist, nsurv, cand_sid,
                     cand_off, mu, sd, d2, r)
    if dev.type == "cpu":
        return ref.dtw_survivors_ref(data, qs, slist, nsurv, cand_sid,
                                     cand_off, mu, sd, d2, r=r, znorm=znorm)
    s, n = data.shape
    b, qlen = qs.shape
    if not _warp_entry(qlen, r):
        return dtw_survivors_wide(data, qs, slist, nsurv, cand_sid,
                                  cand_off, mu, sd, d2, r=r, znorm=znorm)
    lib = _build.library("dtw_band")
    code = lib.ulisse_dtw_survivors(
        data.data_ptr(), qs.data_ptr(), slist.data_ptr(), nsurv.data_ptr(),
        cand_sid.data_ptr(), cand_off.data_ptr(), mu.data_ptr(),
        sd.data_ptr(), d2.data_ptr(), s, n, b, slist.shape[1], qlen, r,
        int(znorm), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "dtw_survivors")
    dtw_survivors.launches += 1
    return d2


dtw_survivors.launches = 0


def dtw_survivors_wide(data: torch.Tensor, qs: torch.Tensor,
                       slist: torch.Tensor, nsurv: torch.Tensor,
                       cand_sid: torch.Tensor, cand_off: torch.Tensor,
                       mu: torch.Tensor, sd: torch.Tensor, d2: torch.Tensor,
                       *, r: int, znorm: bool) -> torch.Tensor:
    """`dtw_survivors` through the wide entry, at any band and length."""
    dev = data.device
    _check_survivors("dtw_survivors_wide", data, qs, slist, nsurv,
                     cand_sid, cand_off, mu, sd, d2, r)
    if dev.type == "cpu":
        return ref.dtw_survivors_ref(data, qs, slist, nsurv, cand_sid,
                                     cand_off, mu, sd, d2, r=r, znorm=znorm)
    s, n = data.shape
    b, qlen = qs.shape
    lib = _build.library("dtw_band")
    pairs, segs = wide_plan(qlen, r)
    scratch, blocks = ((None, 0) if segs
                       else _wide_scratch(lib, dev, qlen, r))
    code = lib.ulisse_dtw_survivors_wide(
        data.data_ptr(), qs.data_ptr(), slist.data_ptr(), nsurv.data_ptr(),
        cand_sid.data_ptr(), cand_off.data_ptr(), mu.data_ptr(),
        sd.data_ptr(), d2.data_ptr(),
        None if scratch is None else scratch.data_ptr(), blocks, s, n, b,
        slist.shape[1], qlen, r, int(znorm), pairs, segs,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "dtw_survivors_wide")
    dtw_survivors_wide.launches += 1
    return d2


dtw_survivors_wide.launches = 0


def _check_survivors(what, data, qs, slist, nsurv, cand_sid, cand_off, mu,
                     sd, d2, r: int) -> None:
    dev = data.device
    s, n = data.shape
    b, qlen = qs.shape
    m = slist.shape[1]
    _check_band(what, qlen, r)
    if qlen > n:
        raise ValueError(f"{what}: qlen={qlen} > n={n}")
    _build.check_tensors(what, dev, (
        ("data", data, torch.float32, (s, n)),
        ("qs", qs, torch.float32, (b, qlen)),
        ("slist", slist, torch.int32, (b, m)),
        ("nsurv", nsurv, torch.int32, (b,)),
        ("cand_sid", cand_sid, torch.int32, (b, m)),
        ("cand_off", cand_off, torch.int32, (b, m)),
        ("mu", mu, torch.float32, (b, m)),
        ("sd", sd, torch.float32, (b, m)),
        ("d2", d2, torch.float32, (b, m))))
