"""Fused candidate-window gather + squared ED: the `fused_gather_ed` kernel.

The port's counterpart of `repro/kernels/fused_verify.py::fused_gather_ed`,
the kernel that does all of the exact search's true-distance work: for
each of B queries, `rows` candidate envelopes, and each of their g =
gamma + 1 master offsets, the squared ED of the window to the prepared
query, from one gathered (qlen + g - 1) region per envelope and window
statistics from the collection's hi/lo prefix sums.  The kernel is
`csrc/fused_verify.cu`; the plain version is `ref.fused_gather_ed_ref`.

Inputs are checked on every device against what the kernel takes; then
CPU tensors take the plain version and CUDA tensors launch the kernel.
`.launches` counts launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref


def fused_gather_ed(data: torch.Tensor, csum: torch.Tensor,
                    csum2: torch.Tensor, csum_lo: torch.Tensor,
                    csum2_lo: torch.Tensor, center: torch.Tensor,
                    sids: torch.Tensor, anchors: torch.Tensor,
                    qs: torch.Tensor, *, g: int, rows: int,
                    znorm: bool) -> torch.Tensor:
    """Squared ED of B queries' candidate chunks.

    data (S, n) float32 with its Collection prefix sums csum/csum2 and
    residuals csum_lo/csum2_lo (each (S, n+1)) and centers (S,);
    sids/anchors (B * rows,) int32 — query b's chunk is rows
    [b*rows, (b+1)*rows); qs (B, qlen) prepared queries.  Returns
    (B * rows, g) float32; windows overrunning their series are garbage
    (the caller masks them).
    """
    dev = data.device
    s, n = data.shape
    b, qlen = qs.shape
    for name, t, dtype, shape in (
            ("data", data, torch.float32, (s, n)),
            ("csum", csum, torch.float32, (s, n + 1)),
            ("csum2", csum2, torch.float32, (s, n + 1)),
            ("csum_lo", csum_lo, torch.float32, (s, n + 1)),
            ("csum2_lo", csum2_lo, torch.float32, (s, n + 1)),
            ("center", center, torch.float32, (s,)),
            ("sids", sids, torch.int32, (b * rows,)),
            ("anchors", anchors, torch.int32, (b * rows,)),
            ("qs", qs, torch.float32, (b, qlen))):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"fused_gather_ed: {name} must be a contiguous {dtype} "
                f"{shape} on {dev}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    if not 1 <= qlen <= n:
        raise ValueError(f"fused_gather_ed: qlen={qlen} outside [1, {n}]")
    if dev.type == "cpu":
        return ref.fused_gather_ed_ref(data, csum, csum2, csum_lo, csum2_lo,
                                       center, sids, anchors, qs, g=g,
                                       rows=rows, znorm=znorm)
    out = torch.empty((b * rows, g), dtype=torch.float32, device=dev)
    lib = _build.library("fused_verify")
    code = lib.ulisse_fused_gather_ed(
        data.data_ptr(), csum.data_ptr(), csum2.data_ptr(),
        csum_lo.data_ptr(), csum2_lo.data_ptr(), center.data_ptr(),
        sids.data_ptr(), anchors.data_ptr(), qs.data_ptr(), out.data_ptr(),
        s, n, b, rows, qlen, g, int(znorm),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "fused_gather_ed")
    fused_gather_ed.launches += 1
    return out


fused_gather_ed.launches = 0
