"""Squared Sakoe-Chiba banded DTW: the `dtw_band` kernels.

The port's counterpart of `repro/kernels/dtw_band.py::dtw_band_pallas`,
placed where the reference search runs the same DP in jnp: on the
LB_Keogh survivors of every scan chunk (`repro/core/executor.py::
_survivor_bucket`).  Two wrappers over `csrc/dtw_band.cu`:

  dtw_band       q (l,) against candidates (N, l) -> (N,), the function
                 of `dtw_band_pallas`;
  dtw_survivors  gather + normalize + DP of one chunk's survivors for all
                 B queries in one launch (the executor's call).

Inputs are checked on every device against what the kernel takes;
then CPU tensors take the plain versions in `ref.py` and CUDA tensors
launch the kernel.  Each wrapper counts its launches in `.launches`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

# csrc/dtw_band.cu: 32 lanes x kMaxCells band cells, and one warp's
# window plus the query (2 * qlen floats) in 48 KB of shared memory
_MAX_BAND = 1024
_MAX_QLEN = 6144


def _check_band(what: str, l: int, r: int) -> None:
    if r < 1:
        raise ValueError(f"{what}: the warping window r must be >= 1")
    if not 1 <= l <= _MAX_QLEN or 2 * min(r, l - 1) + 1 > _MAX_BAND:
        raise ValueError(
            f"{what}: qlen={l} with r={r} is outside the kernel's range "
            f"(qlen <= {_MAX_QLEN}, 2 * min(r, qlen - 1) + 1 <= "
            f"{_MAX_BAND})")


def dtw_band(q: torch.Tensor, candidates: torch.Tensor,
             r: int) -> torch.Tensor:
    """Squared banded DTW of q (l,) float32 against candidates (N, l)
    float32 with warping window r >= 1 (r >= l covers the whole row).
    Returns (N,) float32."""
    dev = q.device
    n_cand, l = candidates.shape
    _check_band("dtw_band", l, r)
    _build.check_tensors("dtw_band", dev, (
        ("q", q, torch.float32, (l,)),
        ("candidates", candidates, torch.float32, (n_cand, l))))
    if dev.type == "cpu":
        return ref.dtw_band_ref(q, candidates, r)
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


def dtw_survivors(data: torch.Tensor, qs: torch.Tensor, sidx: torch.Tensor,
                  nsurv: torch.Tensor, cand_sid: torch.Tensor,
                  cand_off: torch.Tensor, mu: torch.Tensor, sd: torch.Tensor,
                  *, r: int, znorm: bool) -> torch.Tensor:
    """Squared banded DTW of the LB_Keogh survivors of one scan chunk.

    data (S, n) float32; qs (B, qlen) prepared queries; sidx (B, M)
    int32 the survivors' candidate positions packed first and nsurv (B,)
    int32 their counts (both stay on the device: no host sync);
    cand_sid/cand_off (B, M) int32 and mu/sd (B, M) float32 (the LB
    kernel's window normalization) describe the chunk's candidates.
    Slot p < nsurv[b] is the DTW^2 of q_b against candidate sidx[b, p]'s
    window data[sid, clip(off, 0, n - qlen) : + qlen], normalized with
    its (mu, sd) when znorm; every other slot is +inf.  Returns (B, M)
    float32.
    """
    dev = data.device
    s, n = data.shape
    b, qlen = qs.shape
    m = sidx.shape[1]
    _check_band("dtw_survivors", qlen, r)
    if qlen > n:
        raise ValueError(f"dtw_survivors: qlen={qlen} > n={n}")
    _build.check_tensors("dtw_survivors", dev, (
        ("data", data, torch.float32, (s, n)),
        ("qs", qs, torch.float32, (b, qlen)),
        ("sidx", sidx, torch.int32, (b, m)),
        ("nsurv", nsurv, torch.int32, (b,)),
        ("cand_sid", cand_sid, torch.int32, (b, m)),
        ("cand_off", cand_off, torch.int32, (b, m)),
        ("mu", mu, torch.float32, (b, m)),
        ("sd", sd, torch.float32, (b, m))))
    if dev.type == "cpu":
        return ref.dtw_survivors_ref(data, qs, sidx, nsurv, cand_sid,
                                     cand_off, mu, sd, r=r, znorm=znorm)
    out = torch.empty((b, m), dtype=torch.float32, device=dev)
    lib = _build.library("dtw_band")
    code = lib.ulisse_dtw_survivors(
        data.data_ptr(), qs.data_ptr(), sidx.data_ptr(), nsurv.data_ptr(),
        cand_sid.data_ptr(), cand_off.data_ptr(), mu.data_ptr(),
        sd.data_ptr(), out.data_ptr(), s, n, b, m, qlen, r, int(znorm),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "dtw_survivors")
    dtw_survivors.launches += 1
    return out


dtw_survivors.launches = 0
