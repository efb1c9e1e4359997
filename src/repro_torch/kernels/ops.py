"""The kernel layer's function-level entry points (the torch twin of
`repro/kernels/ops.py`).

Each op takes the reference op's arguments and launches the port's CUDA
kernel for CUDA tensors (the kernel's wrapper runs its plain version for
CPU tensors).  `use_kernel=False` is the caller's explicit choice of the
plain version in `ref.py` on any device, where the reference takes
`use_pallas=False`; it is never a fallback.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import batch_ed as _batch_ed
from repro_torch.kernels import dtw_band as _dtw_band
from repro_torch.kernels import envelope as _envelope
from repro_torch.kernels import lb_keogh as _lb_keogh
from repro_torch.kernels import mindist as _mindist
from repro_torch.kernels import ref


def mindist(q_lo, q_hi, e_lo, e_hi, seg_len: int, nseg: int,
            use_kernel: bool = True):
    """Envelope lower bounds (Eq. 5 / Eq. 8) of one query interval (w,)
    to N envelope intervals (N, w): (N,) distances."""
    valid = torch.ones(e_lo.shape[0], dtype=torch.bool, device=e_lo.device)
    if not use_kernel:
        return ref.mindist_ref(q_lo[None], q_hi[None], e_lo, e_hi, valid,
                               seg_len, nseg)[0]
    return _mindist.mindist_paa(q_lo[None].contiguous(),
                                q_hi[None].contiguous(), e_lo, e_hi, valid,
                                seg_len, nseg)[0]


def batch_ed(windows, queries, znorm: bool, use_kernel: bool = True):
    """Squared ED of (N, L) windows vs (Qb, L) queries -> (N, Qb)."""
    if not use_kernel:
        return ref.batch_ed_ref(windows, queries, znorm)
    return _batch_ed.batch_ed(windows, queries, znorm)


def lb_keogh(env_lo, env_hi, windows, use_kernel: bool = True):
    """Squared LB_Keogh of (N, L) windows vs a query DTW envelope -> (N,)."""
    if not use_kernel:
        return ref.lb_keogh_ref(env_lo, env_hi, windows)
    return _lb_keogh.lb_keogh(env_lo, env_hi, windows)


def dtw_band(q, candidates, r: int, use_kernel: bool = True):
    """Squared banded DTW of q (L,) vs candidates (N, L) -> (N,)."""
    if not use_kernel:
        return ref.dtw_band_ref(q, candidates, r)
    return _dtw_band.dtw_band(q, candidates, r)


def envelope_znorm(segmean, s1, s2, offsets, n: int, lmin: int, lmax: int,
                   seg_len: int, use_kernel: bool = True):
    """Alg. 2 length reduction: per-master normalized PAA (lo, hi)."""
    if s1.shape[1] != lmax - lmin + 1:
        raise ValueError(f"envelope_znorm: s1 holds {s1.shape[1]} lengths, "
                         f"[{lmin}, {lmax}] has {lmax - lmin + 1}")
    if not use_kernel:
        return ref.envelope_scan_ref(segmean, s1, s2, offsets, n=n,
                                     lmin=lmin, seg_len=seg_len)
    return _envelope.envelope_znorm_masters(segmean, s1, s2, offsets, n=n,
                                            lmin=lmin, seg_len=seg_len)
