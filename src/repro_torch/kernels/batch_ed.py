"""Batched squared ED of windows against queries: the `batch_ed` kernel.

The port's counterpart of `repro/kernels/batch_ed.py::batch_ed_pallas`,
placed where the reference's host backend computes the same function in
jnp: the verification of every chunk's candidate windows
(`repro/core/executor.py::ed_batch`, one query).  The kernel is
`csrc/batch_ed.cu`, the plain version `ref.batch_ed_ref`.

Any L and Qb, in one launch: the kernel streams each row in steps of
128 points and reads the queries in place, in register groups of up to
8 queries (a larger batch takes the rows again, group by group).

Inputs are checked on every device against what the kernel takes; then
CPU tensors take the plain version and CUDA tensors launch the kernel.
The wrapper counts its launches in `.launches`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref


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
    code = _build.library("batch_ed").ulisse_batch_ed(
        windows.data_ptr(), queries.data_ptr(), out.data_ptr(), n, l, qb, qb,
        int(znorm), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "batch_ed")
    batch_ed.launches += 1
    return out


batch_ed.launches = 0
