"""Z-normalized envelope construction (paper Alg. 2): the
`envelope_znorm` kernels.

The port's counterpart of `repro/kernels/envelope.py::
envelope_znorm_pallas`, placed where the reference computes the same
function in jnp: the length loop of `repro/core/envelope.py::
build_envelopes_znorm`, run by every Z-normalized index build.  Two
wrappers over `csrc/envelope.cu`:

  envelope_znorm          the index build: finished (lo, hi) bounds of
                          every envelope of S series from their float32
                          prefix sums (the build's call);
  envelope_znorm_masters  per-master bounds from (segmean, s1, s2,
                          offsets), the TPU kernel's own contract.

Inputs are checked on every device against what the kernel takes; then
CPU tensors take the plain versions in `ref.py` and CUDA tensors launch
the kernel.  Kernel and plain version share their arithmetic (IEEE
divisions, no contraction), so they agree bit for bit.  Each wrapper
counts its launches in `.launches`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref


def envelope_znorm(csum: torch.Tensor, csum2: torch.Tensor, *, lmin: int,
                   lmax: int, gamma: int, seg_len: int):
    """Z-normalized envelopes of S series of length n: (lo, hi), each
    (S, n_env, lmax // seg_len) float32, -inf / +inf on segments no
    represented subsequence covers.

    csum / csum2 (S, n+1) float32 are the prefix sums, with a leading 0,
    of the series' centered values and of their squares; envelope e has
    masters e * (gamma + 1) + j, j <= gamma.
    """
    dev = csum.device
    s, np1 = csum.shape
    n = np1 - 1
    w = lmax // seg_len
    if not seg_len <= lmin <= lmax or gamma < 0 or lmin > n:
        raise ValueError(f"envelope_znorm: lmin={lmin}, lmax={lmax}, "
                         f"seg_len={seg_len}, gamma={gamma} at n={n}")
    n_env = -(-(n - lmin + 1) // (gamma + 1))
    _build.check_tensors("envelope_znorm", dev, (
        ("csum", csum, torch.float32, (s, np1)),
        ("csum2", csum2, torch.float32, (s, np1))))
    if dev.type == "cpu":
        return ref.envelope_znorm_ref(csum, csum2, lmin=lmin, lmax=lmax,
                                      gamma=gamma, seg_len=seg_len)
    lo, hi = torch.empty((2, s, n_env, w), dtype=torch.float32, device=dev)
    if s == 0:
        return lo, hi
    lib = _build.library("envelope")
    code = lib.ulisse_envelope_znorm(
        csum.data_ptr(), csum2.data_ptr(), lo.data_ptr(), hi.data_ptr(), s,
        n, n_env, lmin, lmax, gamma, seg_len,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "envelope_znorm")
    envelope_znorm.launches += 1
    return lo, hi


envelope_znorm.launches = 0


def envelope_znorm_masters(segmean: torch.Tensor, s1: torch.Tensor,
                           s2: torch.Tensor, offsets: torch.Tensor, *,
                           n: int, lmin: int, seg_len: int):
    """Per-master normalized PAA bounds (the Alg. 2 length reduction).

    segmean (M, w) float32 segment means per master offset; s1 / s2
    (M, L) float32 window sums / sums of squares for lengths lmin ..
    lmin + L - 1; offsets (M,) int32.  Returns (lo, hi) (M, w) float32;
    where no (length, segment) cell is valid lo stays +3e38 and hi -3e38
    (callers finalize to -inf / +inf).
    """
    dev = segmean.device
    m, w = segmean.shape
    n_len = s1.shape[1]
    _build.check_tensors("envelope_znorm_masters", dev, (
        ("segmean", segmean, torch.float32, (m, w)),
        ("s1", s1, torch.float32, (m, n_len)),
        ("s2", s2, torch.float32, (m, n_len)),
        ("offsets", offsets, torch.int32, (m,))))
    if seg_len < 1 or lmin < 1:
        raise ValueError(f"envelope_znorm_masters: lmin={lmin}, "
                         f"seg_len={seg_len}")
    if dev.type == "cpu":
        return ref.envelope_scan_ref(segmean, s1, s2, offsets, n=n,
                                     lmin=lmin, seg_len=seg_len)
    lo, hi = torch.empty((2, m, w), dtype=torch.float32, device=dev)
    if m == 0 or w == 0:
        return lo, hi
    lib = _build.library("envelope")
    code = lib.ulisse_envelope_znorm_masters(
        segmean.data_ptr(), s1.data_ptr(), s2.data_ptr(), offsets.data_ptr(),
        lo.data_ptr(), hi.data_ptr(), m, w, n_len, n, lmin, seg_len,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "envelope_znorm_masters")
    envelope_znorm_masters.launches += 1
    return lo, hi


envelope_znorm_masters.launches = 0
