"""Batched squared LB_Keogh: the `lb_keogh` kernel.

The port's counterpart of `repro/kernels/lb_keogh.py::lb_keogh_pallas`,
placed where the reference's host backend computes the same function in
jnp: the DTW filter of every chunk's candidate windows
(`repro/core/executor.py::lb_keogh_batch`).  The kernel is
`csrc/lb_keogh.cu`, the plain version `ref.lb_keogh_ref`.

Inputs are checked on every device against what the kernel takes; then
CPU tensors take the plain version and CUDA tensors launch the kernel.
The wrapper counts its launches in `.launches`.  Any L: the kernel
stages the envelope in tiles of L where it is longer than its 48 KB of
shared memory.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref


def lb_keogh(env_lo: torch.Tensor, env_hi: torch.Tensor,
             windows: torch.Tensor) -> torch.Tensor:
    """Squared LB_Keogh (paper Eq. 6) of windows (N, L) float32 against
    the envelope env_lo / env_hi (L,) float32: (N,) float32."""
    dev = windows.device
    n, l = windows.shape
    _build.check_tensors("lb_keogh", dev, (
        ("env_lo", env_lo, torch.float32, (l,)),
        ("env_hi", env_hi, torch.float32, (l,)),
        ("windows", windows, torch.float32, (n, l))))
    if l < 1:
        raise ValueError(f"lb_keogh: window length {l} < 1")
    if dev.type == "cpu":
        return ref.lb_keogh_ref(env_lo, env_hi, windows)
    out = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return out
    lib = _build.library("lb_keogh")
    code = lib.ulisse_lb_keogh(env_lo.data_ptr(), env_hi.data_ptr(),
                               windows.data_ptr(), out.data_ptr(), n, l,
                               torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "lb_keogh")
    lb_keogh.launches += 1
    return out


lb_keogh.launches = 0
