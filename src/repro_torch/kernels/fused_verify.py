"""Fused candidate-window gather + squared ED or LB_Keogh: the
`fused_gather_ed` and `fused_gather_lb_keogh` kernels.

The port's counterparts of `repro/kernels/fused_verify.py`: for each of
B queries, `rows` candidate envelopes, and each of their g = gamma + 1
master offsets, a function of the window against the prepared query,
from one gathered (qlen + g - 1) region per envelope and window
statistics from the collection's hi/lo prefix sums.  `fused_gather_ed`
gives the squared ED (all of the ED search's true-distance work);
`fused_gather_lb_keogh` normalizes each window and gives its squared
LB_Keogh against the query's DTW envelope, with the (mu, sd) the DTW
tier reuses; `fused_gather_lb_keogh_chunk` is the scan's entry to the
same kernel, which also masks, lists the survivors and prepares the DP's
output; `gather_znorm` writes the kernels' normalized windows (a check).
The kernels are `csrc/fused_verify.cu`; the plain versions are
`ref.fused_gather_ed_ref`, `ref.fused_gather_lb_keogh_ref`,
`ref.fused_gather_lb_keogh_chunk_ref` and `ref.gather_znorm_ref`.

Inputs are checked on every device against what the kernel takes; then
CPU tensors take the plain version and CUDA tensors launch the kernel.
Each wrapper counts its launches in `.launches`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref


def _check(what, data, csum, csum2, csum_lo, csum2_lo, center, sids,
           anchors, rows, queries):
    """Raise unless every input is what the kernels take: contiguous, of
    the kernel's dtype and shape, on data's device, with 1 <= qlen <= n.
    `queries` are (name, tensor) pairs of shape (B, qlen)."""
    s, n = data.shape
    b, qlen = queries[0][1].shape
    _build.check_tensors(what, data.device, (
        ("data", data, torch.float32, (s, n)),
        ("csum", csum, torch.float32, (s, n + 1)),
        ("csum2", csum2, torch.float32, (s, n + 1)),
        ("csum_lo", csum_lo, torch.float32, (s, n + 1)),
        ("csum2_lo", csum2_lo, torch.float32, (s, n + 1)),
        ("center", center, torch.float32, (s,)),
        ("sids", sids, torch.int32, (b * rows,)),
        ("anchors", anchors, torch.int32, (b * rows,)),
        *((qn, qt, torch.float32, (b, qlen)) for qn, qt in queries)))
    if not 1 <= qlen <= n:
        raise ValueError(f"{what}: qlen={qlen} outside [1, {n}]")


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
    _check("fused_gather_ed", data, csum, csum2, csum_lo, csum2_lo, center,
           sids, anchors, rows, (("qs", qs),))
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


def fused_gather_lb_keogh(data: torch.Tensor, csum: torch.Tensor,
                          csum2: torch.Tensor, csum_lo: torch.Tensor,
                          csum2_lo: torch.Tensor, center: torch.Tensor,
                          sids: torch.Tensor, anchors: torch.Tensor,
                          dtw_lo: torch.Tensor, dtw_hi: torch.Tensor, *,
                          g: int, rows: int, znorm: bool):
    """Squared LB_Keogh of B queries' candidate chunks, and the window
    normalization the DTW tier must reuse.

    Inputs as in `fused_gather_ed`, with the queries' DTW envelopes
    dtw_lo/dtw_hi (B, qlen) in place of the queries.  Returns (lb2, mu,
    sd), each (B * rows, g) float32; raw mode gives mu = 0 and sd = 1.
    Windows overrunning their series are garbage (the caller masks
    them).
    """
    dev = data.device
    s, n = data.shape
    b, qlen = dtw_lo.shape
    _check("fused_gather_lb_keogh", data, csum, csum2, csum_lo, csum2_lo,
           center, sids, anchors, rows, (("dtw_lo", dtw_lo),
                                         ("dtw_hi", dtw_hi)))
    if dev.type == "cpu":
        return ref.fused_gather_lb_keogh_ref(
            data, csum, csum2, csum_lo, csum2_lo, center, sids, anchors,
            dtw_lo, dtw_hi, g=g, rows=rows, znorm=znorm)
    lb, mu, sd = torch.empty((3, b * rows, g), dtype=torch.float32,
                             device=dev)
    lib = _build.library("fused_verify")
    code = lib.ulisse_fused_gather_lb_keogh(
        data.data_ptr(), csum.data_ptr(), csum2.data_ptr(),
        csum_lo.data_ptr(), csum2_lo.data_ptr(), center.data_ptr(),
        sids.data_ptr(), anchors.data_ptr(), dtw_lo.data_ptr(),
        dtw_hi.data_ptr(), lb.data_ptr(), mu.data_ptr(), sd.data_ptr(),
        s, n, b, rows, qlen, g, int(znorm),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "fused_gather_lb_keogh")
    fused_gather_lb_keogh.launches += 1
    return lb, mu, sd


fused_gather_lb_keogh.launches = 0


def fused_gather_lb_keogh_chunk(data: torch.Tensor, csum: torch.Tensor,
                                csum2: torch.Tensor, csum_lo: torch.Tensor,
                                csum2_lo: torch.Tensor, center: torch.Tensor,
                                sids: torch.Tensor, anchors: torch.Tensor,
                                dtw_lo: torch.Tensor, dtw_hi: torch.Tensor,
                                ok: torch.Tensor, kth: torch.Tensor, *,
                                g: int, rows: int, znorm: bool):
    """The scan's LB_Keogh tier of one chunk, in one launch of the
    `fused_gather_lb_keogh` kernel.

    Inputs as in `fused_gather_lb_keogh`, plus the chunk's candidate mask
    ok (B, M = rows * g) bool and the pool's k-th distances kth (B,)
    float32.  Returns (lb2, mu, sd, slist, nsurv, d2): lb2/mu/sd (B *
    rows, g) as the contract entry's with lb2 = +inf where not ok; query
    b's survivors (lb2 < kth[b]) are the positions slist[b, :nsurv[b]]
    (int32; in any order on the card, ascending on the CPU) and nsurv
    (B,) int32 counts them, on the device; d2 (B, M) float32 is +inf at
    every non-survivor, for `dtw_survivors` to fill the rest.
    """
    dev = data.device
    s, n = data.shape
    b, qlen = dtw_lo.shape
    m = rows * g
    _check("fused_gather_lb_keogh_chunk", data, csum, csum2, csum_lo,
           csum2_lo, center, sids, anchors, rows, (("dtw_lo", dtw_lo),
                                                   ("dtw_hi", dtw_hi)))
    _build.check_tensors("fused_gather_lb_keogh_chunk", dev, (
        ("ok", ok, torch.bool, (b, m)),
        ("kth", kth, torch.float32, (b,))))
    if dev.type == "cpu":
        return ref.fused_gather_lb_keogh_chunk_ref(
            data, csum, csum2, csum_lo, csum2_lo, center, sids, anchors,
            dtw_lo, dtw_hi, ok, kth, g=g, rows=rows, znorm=znorm)
    lb, mu, sd = torch.empty((3, b * rows, g), dtype=torch.float32,
                             device=dev)
    slist = torch.empty((b, m), dtype=torch.int32, device=dev)
    nsurv = torch.zeros(b, dtype=torch.int32, device=dev)
    d2 = torch.empty((b, m), dtype=torch.float32, device=dev)
    lib = _build.library("fused_verify")
    code = lib.ulisse_fused_gather_lb_keogh_chunk(
        data.data_ptr(), csum.data_ptr(), csum2.data_ptr(),
        csum_lo.data_ptr(), csum2_lo.data_ptr(), center.data_ptr(),
        sids.data_ptr(), anchors.data_ptr(), dtw_lo.data_ptr(),
        dtw_hi.data_ptr(), ok.data_ptr(), kth.data_ptr(), lb.data_ptr(),
        mu.data_ptr(), sd.data_ptr(), slist.data_ptr(), nsurv.data_ptr(),
        d2.data_ptr(), s, n, b, rows, qlen, g, int(znorm),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "fused_gather_lb_keogh_chunk")
    fused_gather_lb_keogh_chunk.launches += 1
    return lb, mu, sd, slist, nsurv, d2


fused_gather_lb_keogh_chunk.launches = 0


def gather_znorm(data: torch.Tensor, sids: torch.Tensor,
                 anchors: torch.Tensor, mu: torch.Tensor, sd: torch.Tensor,
                 *, qlen: int, g: int) -> torch.Tensor:
    """The normalized windows the LB_Keogh and DP kernels compute, for
    checking them against the IEEE divide: window j of row e is
    (region_e[j : j + qlen] - mu[e, j]) / sd[e, j].  sids/anchors (E,)
    int32, mu/sd (E, g) float32 (the LB tier's).  Returns (E * g, qlen)
    float32.  Not on a search path: a check of the normalization.
    """
    dev = data.device
    s, n = data.shape
    e = sids.shape[0]
    if not 1 <= qlen <= n:
        raise ValueError(f"gather_znorm: qlen={qlen} outside [1, {n}]")
    _build.check_tensors("gather_znorm", dev, (
        ("data", data, torch.float32, (s, n)),
        ("sids", sids, torch.int32, (e,)),
        ("anchors", anchors, torch.int32, (e,)),
        ("mu", mu, torch.float32, (e, g)),
        ("sd", sd, torch.float32, (e, g))))
    if dev.type == "cpu":
        return ref.gather_znorm_ref(data, sids, anchors, mu, sd, qlen=qlen,
                                    g=g)
    out = torch.empty((e * g, qlen), dtype=torch.float32, device=dev)
    if e == 0:
        return out
    lib = _build.library("fused_verify")
    code = lib.ulisse_gather_znorm(
        data.data_ptr(), sids.data_ptr(), anchors.data_ptr(), mu.data_ptr(),
        sd.data_ptr(), out.data_ptr(), s, n, e, qlen, g,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "gather_znorm")
    gather_znorm.launches += 1
    return out


gather_znorm.launches = 0
