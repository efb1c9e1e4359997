"""Batched squared ED of windows against queries: the `batch_ed` kernel.

The port's counterpart of `repro/kernels/batch_ed.py::batch_ed_pallas`,
placed where the reference's host backend computes the same function in
jnp: the verification of every chunk's candidate windows
(`repro/core/executor.py::ed_batch`, one query).  The kernel is
`csrc/batch_ed.cu`, the plain version `ref.batch_ed_ref`.

Any L and Qb: the queries go in groups whose Qb (L + 1) floats fit the
kernel's 48 KB of staging, one launch a group (each counted); a query
longer than the staging is streamed through it in tiles of L.

Inputs are checked on every device against what the kernel takes; then
CPU tensors take the plain version and CUDA tensors launch the kernel.
The wrapper counts its launches in `.launches`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

# csrc/batch_ed.cu stages a group of queries and their sums of squares in
# 48 KB of shared memory
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
    if qb < 1 or l < 1:
        raise ValueError(f"batch_ed: {qb} queries of length {l}")
    if dev.type == "cpu":
        return ref.batch_ed_ref(windows, queries, znorm)
    out = torch.empty((n, qb), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    lib = _build.library("batch_ed")
    stream = torch.cuda.current_stream(dev).cuda_stream
    group = max(1, _SMEM_FLOATS // (l + 1))
    for q0 in range(0, qb, group):
        q1 = min(q0 + group, qb)
        code = lib.ulisse_batch_ed(windows.data_ptr(),
                                   queries[q0:q1].data_ptr(),
                                   out[:, q0:].data_ptr(), n, l, q1 - q0, qb,
                                   int(znorm), stream)
        _build.check(code, "batch_ed")
        batch_ed.launches += 1
    return out


batch_ed.launches = 0
