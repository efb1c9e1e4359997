"""Batched envelope lower bounds (paper Eq. 5): the `mindist` kernels.

The port's counterpart of `repro/kernels/mindist.py::mindist_pallas`,
placed where the reference engine computes the same function in jnp: the
lower bound of every envelope (and every block union) for every query.
Two wrappers over `csrc/mindist.cu`:

  mindist_sym  envelopes given by their iSAX symbols (the default exact
               scan order, `env_lower_bounds_batch(use_paa=False)`);
  mindist_paa  envelopes given by float intervals (`use_paa=True` and
               the block levels of the approximate pass).

Inputs are checked on every device against what the kernel takes;
then CPU tensors take the plain versions in `ref.py` and CUDA tensors
launch the kernel the host's plan picks (`mindist_plan`), or raise.
Each wrapper counts its launches in `.launches`.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

_MAX_BATCH = 8          # csrc/mindist.cu kMaxBatch
_THREADS = 256          # csrc/mindist.cu kThreads: the largest block
_SEG_TILE = 64          # segments a tile of the tile kernel, at most
_SMEM_PLAN = 96 * 1024  # the tile kernel's shared memory, at most


def _tile_smem(te: int, st: int, bp: int, nseg: int) -> int:
    """Bytes of shared memory of a tile-kernel block (csrc launch_tile):
    one or two buffers of te rows of lo and hi (tile_stride(st) floats a
    row: st + 4 or st + 8) and st segments of bp query intervals, and
    the breakpoint table (256 entries at most)."""
    stride = st + 8 if (st // 4) % 2 else st + 4
    nbuf = 2 if nseg > st else 1
    return 4 * (nbuf * (2 * te * stride + 2 * st * bp) + 2 * 256)


@functools.lru_cache(maxsize=None)
def mindist_plan(sym: bool, batch: int, n: int, w: int, nseg: int,
                 sms: int, aligned: bool = True) -> tuple:
    """(vec, qb, te, st) of the mindist kernels for `batch` (<= 8) queries
    against n envelopes of w segments over the first nseg, on a card of
    `sms` SMs.  vec = 1: the vector kernel (one thread an envelope, its
    rows in 16-byte loads), wherever w is a multiple of 4, nseg <= 16 and
    the rows are 16-byte aligned (`aligned`): on the card it ran the PAA
    entry at least as fast as the tile kernel at 31,296 and 2,002,944
    envelopes (`chip_kernels.py --alternatives`).  Else the tile kernel
    (vec = 0): a thread takes an envelope and qb queries, the most of 8,
    4, 2, 1 (at most the batch rounded up to a power of two, bp) that
    still gives every SM 8 warps (timed on the card at [15]'s 8,448
    envelopes: 2 queries a thread ran faster than 4 or 8, which leave
    the SMs 4 and 2 warps); a block takes te envelopes (te bp / qb
    <= 256 threads), halved while the blocks would not cover the SMs;
    the rows stream in tiles of st segments (a power of two from 4: nseg
    rounded up, at most 64, halved while a block would pass
    _SMEM_PLAN)."""
    if aligned and w % 4 == 0 and nseg <= 16:
        return 1, 0, 0, 0
    bp = 1 << (batch - 1).bit_length()
    qb = next((c for c in (8, 4, 2) if c <= bp
               and n * (bp // c) >= 8 * 32 * sms), 1)
    te = _THREADS * qb // bp
    while te > 1 and -(-n // te) < sms:
        te //= 2
    st = min(_SEG_TILE, 1 << (max(nseg, 4) - 1).bit_length())
    while st > 4 and _tile_smem(te, st, bp, nseg) > _SMEM_PLAN:
        st //= 2
    return 0, qb, te, st


def _sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _check(name, q_lo, q_hi, e_lo, e_hi, valid, e_dtype, nseg):
    dev = q_lo.device
    for t, dtype in ((q_lo, torch.float32), (q_hi, torch.float32),
                     (e_lo, e_dtype), (e_hi, e_dtype), (valid, torch.bool)):
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"{name}: expected contiguous {dtype} on {dev}, got "
                f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    # the query PAA may be narrower than the envelopes (qlen // s vs w)
    if q_lo.dim() != 2 or e_lo.dim() != 2 \
            or not 0 < nseg <= min(q_lo.shape[1], e_lo.shape[1]):
        raise ValueError(f"{name}: shapes {tuple(q_lo.shape)} vs "
                         f"{tuple(e_lo.shape)} at nseg={nseg}")
    if q_hi.shape != q_lo.shape or e_hi.shape != e_lo.shape \
            or valid.shape != (e_lo.shape[0],):
        raise ValueError(f"{name}: mismatched interval shapes")


def _launch(wrapper, fn, head, q_lo, q_hi, e_lo, e_hi, valid, seg_len,
            nseg, plan):
    dev = q_lo.device
    b, q_stride = q_lo.shape
    n, w = e_lo.shape
    out = torch.empty((b, n), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    aligned = e_lo.data_ptr() % 16 == 0 and e_hi.data_ptr() % 16 == 0
    for start in range(0, b, _MAX_BATCH):
        stop = min(start + _MAX_BATCH, b)
        pl = plan or mindist_plan(wrapper is mindist_sym, stop - start, n, w,
                                  nseg, _sm_count(dev), aligned)
        code = fn(e_lo.data_ptr(), e_hi.data_ptr(), *head,
                  q_lo[start:stop].data_ptr(), q_hi[start:stop].data_ptr(),
                  q_stride, valid.data_ptr(), out[start:stop].data_ptr(), n,
                  w, nseg, stop - start, float(seg_len), *pl, stream)
        _build.check(code, wrapper.__name__)
        wrapper.launches += 1
    return out


def mindist_sym(q_lo: torch.Tensor, q_hi: torch.Tensor,
                sym_lo: torch.Tensor, sym_hi: torch.Tensor,
                breakpoints: torch.Tensor, valid: torch.Tensor,
                seg_len: int, nseg: int,
                plan: Optional[tuple] = None) -> torch.Tensor:
    """Lower bounds (B, N) of query intervals q_lo/q_hi (B, >= nseg)
    float32 to N envelopes given by int32 symbols sym_lo/sym_hi (N, w),
    over the first `nseg` segments; +inf where `valid` (N,) is False.
    On the card each launch (8 queries at most) runs the kernel
    `mindist_plan` picks; `plan` forces one (a test's)."""
    _check("mindist_sym", q_lo, q_hi, sym_lo, sym_hi, valid, torch.int32,
           nseg)
    if breakpoints.dtype != torch.float32 or breakpoints.device != q_lo.device:
        raise ValueError("mindist_sym: breakpoints must be float32 on "
                         f"{q_lo.device}")
    if q_lo.device.type == "cpu":
        return ref.mindist_sym_ref(q_lo, q_hi, sym_lo, sym_hi, breakpoints,
                                   valid, seg_len, nseg)
    bp = breakpoints.contiguous()
    lib = _build.library("mindist")
    return _launch(mindist_sym, lib.ulisse_mindist_sym,
                   (bp.data_ptr(), bp.numel() + 1), q_lo, q_hi, sym_lo,
                   sym_hi, valid, seg_len, nseg, plan)


mindist_sym.launches = 0


def mindist_paa(q_lo: torch.Tensor, q_hi: torch.Tensor, e_lo: torch.Tensor,
                e_hi: torch.Tensor, valid: torch.Tensor, seg_len: int,
                nseg: int, plan: Optional[tuple] = None) -> torch.Tensor:
    """Lower bounds (B, N) of query intervals (B, >= nseg) to N float32
    envelope intervals e_lo/e_hi (N, w) over the first `nseg` segments;
    +inf where `valid` (N,) is False.  On the card each launch runs the
    kernel `mindist_plan` picks; `plan` forces one (a test's)."""
    _check("mindist_paa", q_lo, q_hi, e_lo, e_hi, valid, torch.float32,
           nseg)
    if q_lo.device.type == "cpu":
        return ref.mindist_ref(q_lo, q_hi, e_lo, e_hi, valid, seg_len,
                               nseg)
    lib = _build.library("mindist")
    return _launch(mindist_paa, lib.ulisse_mindist_paa, (), q_lo, q_hi,
                   e_lo, e_hi, valid, seg_len, nseg, plan)


mindist_paa.launches = 0
