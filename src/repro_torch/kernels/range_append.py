"""The eps-range scan's hit append: the `range_append` kernel.

Not the counterpart of a Pallas kernel: it replaces the hit append of
the reference's range scan (`repro/core/executor.py::_device_range_core`,
a cumsum of the hit mask and a searchsorted gather).  One scan step's
dense (B, chunk * g) d2 — from `fused_gather_ed_range`, or the DP's
output behind `fused_gather_lb_keogh_range` — is appended IN PLACE to
the (B, cap) hit buffer: the hits (finite d2 <= eps2) in position
order, all of them or, where they would overflow the buffer, none, with
the chunk recorded in `ovf`.  The kernel is `csrc/range_append.cu`; the
plain version is `ref.range_append_ref`, which CPU tensors take.  The
wrapper counts its launches in `.launches`.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, ref


def range_append(d2: torch.Tensor, sids: torch.Tensor, anchors: torch.Tensor,
                 eps2: torch.Tensor, buf, cnt: torch.Tensor,
                 ovf: torch.Tensor, *, i: int, chunk: int, g: int,
                 i_code: Optional[int] = None,
                 no_ovf: Optional[int] = None) -> None:
    """Append chunk i's hits to the hit buffer, in place.

    d2 (B, chunk * g) float32 is the step's dense distance row (+inf
    wherever no distance was verified); sids/anchors (B, n_pad) int32 the
    packed plan (position p is plan row i * chunk + p // g, offset p % g);
    eps2 (B,) float32; buf = (d2 float32, sid int32, off int32), each (B,
    cap); cnt (B,) int32 the buffer's fill counts and ovf (B,) int32 the
    first chunk whose hits were not written (no_ovf while none; default
    n_pad // chunk).  A hit is a finite d2 <= eps2[b].  Where cnt + hits >
    cap nothing is written and ovf becomes i_code (default i) if unset;
    else the hits go to slots cnt, cnt + 1, ... in position order and cnt
    grows by them (`ref.range_append_ref`, bit for bit).  A paged scan
    hands its one-chunk slab plan's global-id plane as `sids` and the
    whole plan's chunk index and count as i_code and no_ovf.
    """
    dev = d2.device
    b, m = d2.shape
    n_pad = sids.shape[1]
    cap = buf[0].shape[1]
    _build.check_tensors("range_append", dev, (
        ("d2", d2, torch.float32, (b, m)),
        ("sids", sids, torch.int32, (b, n_pad)),
        ("anchors", anchors, torch.int32, (b, n_pad)),
        ("eps2", eps2, torch.float32, (b,)),
        ("buf d2", buf[0], torch.float32, (b, cap)),
        ("buf sid", buf[1], torch.int32, (b, cap)),
        ("buf off", buf[2], torch.int32, (b, cap)),
        ("cnt", cnt, torch.int32, (b,)),
        ("ovf", ovf, torch.int32, (b,))))
    if not (g >= 1 and m == chunk * g and 0 <= i
            and (i + 1) * chunk <= n_pad):
        raise ValueError(f"range_append: d2 of {m} positions is not chunk "
                         f"{i} of {chunk} rows x {g} of the plan's {n_pad}")
    i_code = i if i_code is None else i_code
    no_ovf = n_pad // chunk if no_ovf is None else no_ovf
    if dev.type == "cpu":
        ref.range_append_ref(d2, sids, anchors, eps2, buf, cnt, ovf, i=i,
                             chunk=chunk, g=g, i_code=i_code, no_ovf=no_ovf)
        return
    code = _build.library("range_append").ulisse_range_append(
        d2.data_ptr(), sids.data_ptr(), anchors.data_ptr(), eps2.data_ptr(),
        buf[0].data_ptr(), buf[1].data_ptr(), buf[2].data_ptr(),
        cnt.data_ptr(), ovf.data_ptr(), b, m, n_pad, i * chunk, g, cap,
        i_code, no_ovf, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "range_append")
    range_append.launches += 1


range_append.launches = 0
