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
launch the kernel.  Each wrapper counts its launches in `.launches`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

_MAX_BATCH = 8          # csrc/mindist.cu kMaxBatch


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
            nseg):
    b, q_stride = q_lo.shape
    n, w = e_lo.shape
    out = torch.empty((b, n), dtype=torch.float32, device=q_lo.device)
    stream = torch.cuda.current_stream(q_lo.device).cuda_stream
    for start in range(0, b, _MAX_BATCH):
        stop = min(start + _MAX_BATCH, b)
        code = fn(e_lo.data_ptr(), e_hi.data_ptr(), *head,
                  q_lo[start:stop].data_ptr(), q_hi[start:stop].data_ptr(),
                  q_stride, valid.data_ptr(), out[start:stop].data_ptr(), n, w, nseg,
                  stop - start, float(seg_len), stream)
        _build.check(code, fn.__name__)
        wrapper.launches += 1
    return out


def mindist_sym(q_lo: torch.Tensor, q_hi: torch.Tensor,
                sym_lo: torch.Tensor, sym_hi: torch.Tensor,
                breakpoints: torch.Tensor, valid: torch.Tensor,
                seg_len: int, nseg: int) -> torch.Tensor:
    """Lower bounds (B, N) of query intervals q_lo/q_hi (B, >= nseg)
    float32 to N envelopes given by int32 symbols sym_lo/sym_hi (N, w),
    over the first `nseg` segments; +inf where `valid` (N,) is False."""
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
                   sym_hi, valid, seg_len, nseg)


mindist_sym.launches = 0


def mindist_paa(q_lo: torch.Tensor, q_hi: torch.Tensor, e_lo: torch.Tensor,
                e_hi: torch.Tensor, valid: torch.Tensor, seg_len: int,
                nseg: int) -> torch.Tensor:
    """Lower bounds (B, N) of query intervals (B, >= nseg) to N float32
    envelope intervals e_lo/e_hi (N, w) over the first `nseg` segments;
    +inf where `valid` (N,) is False."""
    _check("mindist_paa", q_lo, q_hi, e_lo, e_hi, valid, torch.float32,
           nseg)
    if q_lo.device.type == "cpu":
        return ref.mindist_ref(q_lo, q_hi, e_lo, e_hi, valid, seg_len,
                               nseg)
    lib = _build.library("mindist")
    return _launch(mindist_paa, lib.ulisse_mindist_paa, (), q_lo, q_hi,
                   e_lo, e_hi, valid, seg_len, nseg)


mindist_paa.launches = 0
