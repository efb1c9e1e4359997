"""Batched squared ED of windows against queries: the `batch_ed` kernel.

The port's counterpart of `repro/kernels/batch_ed.py::batch_ed_pallas`,
placed where the reference's host backend computes the same function in
jnp: the verification of every chunk's candidate windows
(`repro/core/executor.py::ed_batch`, one query).  The kernel is
`csrc/batch_ed.cu`, the plain version `ref.batch_ed_ref`.

Inputs are checked on every device against what the kernel takes; then
CPU tensors take the plain version and CUDA tensors launch the kernel.
The wrapper counts its launches in `.launches`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

# csrc/batch_ed.cu stages the queries and their sums of squares in 48 KB
# of shared memory
_SMEM_FLOATS = 48 * 1024 // 4


def batch_ed(windows: torch.Tensor, queries: torch.Tensor,
             znorm: bool) -> torch.Tensor:
    """Squared ED of every window (N, L) float32 against every query
    (Qb, L) float32 (already Z-normalized when znorm) by the dot
    identity: (N, Qb) float32, clamped at 0."""
    dev = windows.device
    n, l = windows.shape
    qb = queries.shape[0]
    _build.check_tensors("batch_ed", dev, (
        ("windows", windows, torch.float32, (n, l)),
        ("queries", queries, torch.float32, (qb, l))))
    if qb < 1 or l < 1 or qb * (l + 1) > _SMEM_FLOATS:
        raise ValueError(f"batch_ed: {qb} queries of length {l} do not fit "
                         f"the kernel's shared memory (Qb * (L + 1) <= "
                         f"{_SMEM_FLOATS})")
    if dev.type == "cpu":
        return ref.batch_ed_ref(windows, queries, znorm)
    out = torch.empty((n, qb), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    lib = _build.library("batch_ed")
    code = lib.ulisse_batch_ed(windows.data_ptr(), queries.data_ptr(),
                               out.data_ptr(), n, l, qb, int(znorm),
                               torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "batch_ed")
    batch_ed.launches += 1
    return out


batch_ed.launches = 0
