"""Fused candidate-window gather + squared ED or LB_Keogh: the
`fused_gather_ed` and `fused_gather_lb_keogh` kernels.

The port's counterparts of `repro/kernels/fused_verify.py`: for each of
B queries, `rows` candidate envelopes, and each of their g = gamma + 1
master offsets, a function of the window against the prepared query,
from one gathered (qlen + g - 1) region per envelope and window
statistics from the collection's hi/lo prefix sums.  `fused_gather_ed`
gives the squared ED (all of the ED search's true-distance work) and
`fused_gather_ed_chunk` is the k-NN scan's entry to the same kernel,
which also decides the active queries and kept rows from the plan, adds
the counters and keeps each block's k best candidates;
`fused_gather_ed_range` is the same entry's range mode (eps2 for the
pool's k-th, inclusive cuts, the hit buffer's ovf read, the dense d2
out for `range_append`); `fused_gather_lb_keogh` normalizes each window
and gives its squared LB_Keogh against the query's DTW envelope, with
the (mu, sd) the DTW tier reuses; `fused_gather_lb_keogh_chunk` (k-NN)
and `fused_gather_lb_keogh_range` (range) are the scans' entries to the
same kernel, which decide active queries, kept rows and ok candidates,
add the counters, list the survivors, prepare the DP's output and give
each candidate's (sid, off); `gather_znorm` writes the kernels'
normalized windows (a check).  Each of the six entries stages the query
(or its DTW envelope) and the rows' regions in shared memory whole where
they fit; where they do not (qlen past 28,768 for ED, 19,304 for
LB_Keogh at g = 49) it hands the call to its long-row variant
(`fused_gather_ed_long`, `fused_gather_ed_chunk_long`,
`fused_gather_ed_range_long`, `fused_gather_lb_keogh_long`,
`fused_gather_lb_keogh_chunk_long`, `fused_gather_lb_keogh_range_long`:
the same contract and the same bits, the query streamed through shared
memory in tiles of points), each a wrapper of its own with its own
count, so any qlen runs on the card.  Past the g one block of a row takes
(18,688), the long-row ED variants split a row's offsets into tiles of
`offset_tile` offsets, a block each; the long-row LB_Keogh variants take
blocks of consecutive windows of a query's chunk, one a thread
(`lb_long_shape`), so any g runs on the card too, with the same
results.  The kernels are `csrc/fused_verify.cu`; the plain versions
are `ref.fused_gather_ed_ref`, `ref.fused_gather_ed_chunk_ref`,
`ref.fused_gather_ed_range_ref`, `ref.fused_gather_lb_keogh_ref`,
`ref.fused_gather_lb_keogh_chunk_ref`,
`ref.fused_gather_lb_keogh_range_ref` and `ref.gather_znorm_ref`.

Inputs are checked on every device against what the kernel takes; then
CPU tensors take the plain version and CUDA tensors launch the kernel.
Each wrapper counts its launches in `.launches`.
"""
from __future__ import annotations

import functools
from typing import Optional

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


@functools.lru_cache(maxsize=None)
def staged(measure: str, qlen: int, g: int) -> bool:
    """Whether the staged kernel of `measure` ("ed" or "dtw") takes
    (qlen, g) on the card: one block stages a row's region and the query
    (or its DTW envelope) in shared memory.  Else the entries hand the
    call to their long-row variants."""
    lib = _build.library("fused_verify")
    tile = (lib.ulisse_fused_gather_ed_chunk_tile if measure == "ed"
            else lib.ulisse_fused_gather_lb_keogh_tile)
    return tile(qlen, g) > 0


@functools.lru_cache(maxsize=None)
def offset_tile(measure: str, qlen: int, g: int, force: int = 0) -> int:
    """The most offsets of a row a block of the long-row entries of
    `measure` ("ed" or "dtw") takes at (qlen, g).  ED: g where one block
    of a row fits shared memory, else the row's offsets split into the
    fewest balanced tiles that fit (a block each).  LB_Keogh: a block
    takes consecutive windows of the chunk (at most _LB_ITEMS[0], or
    `force`).  `force` > 0: a tile of that many offsets (a test's, to
    hold the tiled blocks against the untiled ones at a g both take)."""
    if measure == "dtw":
        return min(g, force or _LB_ITEMS[0])
    lib = _build.library("fused_verify")
    return lib.ulisse_fused_gather_ed_long_otile(qlen, g, force)


# csrc/fused_verify.cu's long-row LB_Keogh kernel: the windows a block
# takes (largest first), the most it takes, the shared memory it plans
# for, and the most the card gives a block
_LB_ITEMS = (256, 128, 64, 32)
_LB_MAX_ITEMS = 1024
_LB_SMEM_PLAN = 32 * 1024
_SMEM_MAX = 227 * 1024


def _lb_smem(g: int, items: int, ptile: int) -> int:
    """Bytes of shared memory of a long-row LB_Keogh block (the kernel's
    lb_flat_smem): two (lo, hi) tiles, two region buffers of items +
    rmax ptile floats (rmax the rows `items` windows span), five ints a
    row."""
    rmax = (items + g - 2) // g + 1
    return 4 * (4 * ptile + 2 * (items + rmax * ptile) + 5 * rmax)


@functools.lru_cache(maxsize=None)
def lb_long_shape(batch: int, rows: int, g: int, sms: int,
                  force: int = 0) -> tuple:
    """(items, ptile) of the long-row LB_Keogh entries for B = batch
    queries of `rows` rows of g windows on a card of `sms` SMs: a block
    takes `items` consecutive windows of a query's chunk, one a thread
    (`force` where given, else the largest of _LB_ITEMS that still gives
    every SM 4 blocks, so that a chunk of few windows fills the card),
    and streams the envelope and its rows' regions in tiles of `ptile`
    points (the most, a multiple of 32 up to 1,024, within
    _LB_SMEM_PLAN).  Raises where no block takes the shape."""
    total = batch * rows * g
    items = force or next((t for t in _LB_ITEMS
                           if -(-total // t) >= 4 * sms), _LB_ITEMS[-1])
    if items > _LB_MAX_ITEMS:
        raise ValueError(f"long-row LB_Keogh: {items} windows a block, at "
                         f"most {_LB_MAX_ITEMS}")
    ptile = 1024
    while ptile > 32 and _lb_smem(g, items, ptile) > _LB_SMEM_PLAN:
        ptile -= 32
    if _lb_smem(g, items, ptile) > _SMEM_MAX:
        raise ValueError(f"long-row LB_Keogh: {items} windows a block at g "
                         f"= {g} need more shared memory than a block has")
    return items, ptile


def _sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _otile(what, otile):
    """A forced offset tile (None: from the shape) as the entries take
    it."""
    if otile is None:
        return 0
    if otile < 1:
        raise ValueError(f"{what}: otile={otile} must be >= 1")
    return int(otile)


def _ed(wrapper, entry, data, csum, csum2, csum_lo, csum2_lo, center,
        sids, anchors, qs, g, rows, znorm, otile=None):
    dev = data.device
    s, n = data.shape
    b, qlen = qs.shape
    _check(wrapper.__name__, data, csum, csum2, csum_lo, csum2_lo, center,
           sids, anchors, rows, (("qs", qs),))
    long = entry.endswith("_long")
    otile = _otile(wrapper.__name__, otile)
    if dev.type == "cpu":
        return ref.fused_gather_ed_ref(data, csum, csum2, csum_lo, csum2_lo,
                                       center, sids, anchors, qs, g=g,
                                       rows=rows, znorm=znorm)
    out = torch.empty((b * rows, g), dtype=torch.float32, device=dev)
    code = getattr(_build.library("fused_verify"), entry)(
        data.data_ptr(), csum.data_ptr(), csum2.data_ptr(),
        csum_lo.data_ptr(), csum2_lo.data_ptr(), center.data_ptr(),
        sids.data_ptr(), anchors.data_ptr(), qs.data_ptr(), out.data_ptr(),
        s, n, b, rows, qlen, g, int(znorm), *((otile,) if long else ()),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, wrapper.__name__)
    wrapper.launches += 1
    return out


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
    (the caller masks them).  On the card a qlen past the staged
    kernel's goes to `fused_gather_ed_long`.
    """
    if qs.device.type == "cuda" and not staged("ed", qs.shape[1], g):
        return fused_gather_ed_long(data, csum, csum2, csum_lo, csum2_lo,
                                    center, sids, anchors, qs, g=g,
                                    rows=rows, znorm=znorm)
    return _ed(fused_gather_ed, "ulisse_fused_gather_ed", data, csum, csum2,
               csum_lo, csum2_lo, center, sids, anchors, qs, g, rows, znorm)


fused_gather_ed.launches = 0


def fused_gather_ed_long(data: torch.Tensor, csum: torch.Tensor,
                         csum2: torch.Tensor, csum_lo: torch.Tensor,
                         csum2_lo: torch.Tensor, center: torch.Tensor,
                         sids: torch.Tensor, anchors: torch.Tensor,
                         qs: torch.Tensor, *, g: int, rows: int,
                         znorm: bool, otile: Optional[int] = None
                         ) -> torch.Tensor:
    """`fused_gather_ed` through the long-row kernel, at any qlen and g:
    the same result, bit for bit where both take the shape.  `otile`
    forces the offsets a block takes (default `offset_tile`)."""
    return _ed(fused_gather_ed_long, "ulisse_fused_gather_ed_long", data,
               csum, csum2, csum_lo, csum2_lo, center, sids, anchors, qs, g,
               rows, znorm, otile)


fused_gather_ed_long.launches = 0


@functools.lru_cache(maxsize=None)
def ed_chunk_tile(qlen: int, g: int, long: bool = False,
                  otile: int = 0) -> int:
    """Rows a block of the ED chunk entry (of its long-row variant where
    `long`, its blocks taking `otile` offsets a row, 0: `offset_tile`'s)
    takes at (qlen, g): its partials are (4, B, ceil(rows / tile) *
    ceil(g / T) * min(k, tile * T)), T the offsets a block takes (g for
    the staged entry)."""
    lib = _build.library("fused_verify")
    tile = (lib.ulisse_fused_gather_ed_chunk_long_tile(qlen, g, otile) if long
            else lib.ulisse_fused_gather_ed_chunk_tile(qlen, g))
    if tile < 1:
        raise ValueError(f"fused_gather_ed_chunk: no block fits qlen={qlen},"
                         f" g={g}")
    return tile


def _check_plan(what, data, csum, csum2, csum_lo, csum2_lo, center, sids,
                anchors, n_master, lbs2, queries, cut, stats, i, chunk,
                ovf=None, gkth=None):
    """Raise unless the chunk entries' inputs are what the kernels take:
    the (B, n_pad) plan with chunk i inside it, the queries (name, tensor)
    (B, qlen), the cut (the pool's (B, k) d2, or eps2 (B,)), the (B, 6)
    counters, for range ovf (B,) and, where given, the sharded scan's
    gkth (B,) float32."""
    b = queries[0][1].shape[0]
    n_pad = sids.shape[1]
    _check(what, data, csum, csum2, csum_lo, csum2_lo, center,
           sids.reshape(-1), anchors.reshape(-1), n_pad, queries)
    _build.check_tensors(what, data.device, (
        ("sids", sids, torch.int32, (b, n_pad)),
        ("anchors", anchors, torch.int32, (b, n_pad)),
        ("n_master", n_master, torch.int32, (b, n_pad)),
        ("lbs2", lbs2, torch.float32, (b, n_pad)),
        ("pool_d2" if ovf is None else "eps2", cut, torch.float32,
         (b, cut.shape[-1]) if ovf is None else (b,)),
        ("stats", stats, torch.int32, (b, 6)),
        *(() if ovf is None else (("ovf", ovf, torch.int32, (b,)),)),
        *(() if gkth is None else (("gkth", gkth, torch.float32, (b,)),))))
    if not (chunk >= 1 and 0 <= i * chunk and (i + 1) * chunk <= n_pad):
        raise ValueError(f"{what}: chunk {i} of {chunk} rows outside the "
                         f"plan's {n_pad} columns")


def _ed_chunk(wrapper, long, data, csum, csum2, csum_lo, csum2_lo, center,
              sids, anchors, n_master, lbs2, qs, pool_d2, stats, i, chunk, g,
              znorm, gkth, otile=None):
    dev = data.device
    s, n = data.shape
    b, qlen = qs.shape
    n_pad = sids.shape[1]
    k = pool_d2.shape[1]
    what = wrapper.__name__
    _check_plan(what, data, csum, csum2, csum_lo, csum2_lo, center, sids,
                anchors, n_master, lbs2, (("qs", qs),), pool_d2, stats, i,
                chunk, gkth=gkth)
    force = _otile(what, otile)
    if dev.type == "cpu":
        return ref.fused_gather_ed_chunk_ref(
            data, csum, csum2, csum_lo, csum2_lo, center, sids, anchors,
            n_master, lbs2, qs, pool_d2, stats, i=i, chunk=chunk, g=g,
            znorm=znorm, gkth=gkth)
    lib = _build.library("fused_verify")
    tile = ed_chunk_tile(qlen, g, long, force)
    t = offset_tile("ed", qlen, g, force) if long else g
    part = torch.empty((4, b, -(-chunk // tile) * -(-g // t)
                        * min(k, tile * t)), dtype=torch.int32, device=dev)
    entry = (lib.ulisse_fused_gather_ed_chunk_long if long
             else lib.ulisse_fused_gather_ed_chunk)
    code = entry(
        data.data_ptr(), csum.data_ptr(), csum2.data_ptr(),
        csum_lo.data_ptr(), csum2_lo.data_ptr(), center.data_ptr(),
        sids.data_ptr(), anchors.data_ptr(), n_master.data_ptr(),
        lbs2.data_ptr(), qs.data_ptr(), pool_d2.data_ptr(),
        None if gkth is None else gkth.data_ptr(), stats.data_ptr(),
        part.data_ptr(), s, n, b, chunk, qlen, g, int(znorm), n_pad,
        i * chunk, k, *((force,) if long else ()),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, what)
    wrapper.launches += 1
    return part


def fused_gather_ed_chunk(data: torch.Tensor, csum: torch.Tensor,
                          csum2: torch.Tensor, csum_lo: torch.Tensor,
                          csum2_lo: torch.Tensor, center: torch.Tensor,
                          sids: torch.Tensor, anchors: torch.Tensor,
                          n_master: torch.Tensor, lbs2: torch.Tensor,
                          qs: torch.Tensor, pool_d2: torch.Tensor,
                          stats: torch.Tensor, *, i: int, chunk: int,
                          g: int, znorm: bool,
                          gkth: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """The scan's ED step over chunk i, in one launch of the
    `fused_gather_ed` kernel.

    sids/anchors/n_master (B, n_pad) int32 and lbs2 (B, n_pad) float32
    are the LB-sorted plan (chunk i is columns [i * chunk, (i + 1) *
    chunk)), qs (B, qlen) the prepared queries, pool_d2 (B, k) the pool's
    ascending d2 and stats the scan's (B, 6) int32 counters, to which the
    step's [active, kept rows, ok candidates, 0, 0, pruned rows] are
    added in place (`ref.fused_gather_ed_chunk_ref` says which).  Returns
    (4, B, P) int32 partials for `pool_merge_partials`: d2 (as float32
    bits), sid, off and candidate position.  On the card each block of
    `ed_chunk_tile` rows keeps its min(k, tile * g) least candidates with
    d2 < the pool's k-th; on the CPU the partials are every candidate
    (+inf where not ok).  On the card a qlen past the staged kernel's
    goes to `fused_gather_ed_chunk_long`.

    `gkth` (B,) float32, the sharded scan's mesh-wide k-th (None on every
    local path): active, keep and pruned then cut at min(pool k-th,
    gkth[b]), while the card's pre-select stays at the pool's own k-th.
    """
    long = qs.device.type == "cuda" and not staged("ed", qs.shape[1], g)
    return _ed_chunk(
        fused_gather_ed_chunk_long if long else fused_gather_ed_chunk, long,
        data, csum, csum2, csum_lo, csum2_lo, center, sids, anchors,
        n_master, lbs2, qs, pool_d2, stats, i, chunk, g, znorm, gkth)


fused_gather_ed_chunk.launches = 0


def fused_gather_ed_chunk_long(data: torch.Tensor, csum: torch.Tensor,
                               csum2: torch.Tensor, csum_lo: torch.Tensor,
                               csum2_lo: torch.Tensor, center: torch.Tensor,
                               sids: torch.Tensor, anchors: torch.Tensor,
                               n_master: torch.Tensor, lbs2: torch.Tensor,
                               qs: torch.Tensor, pool_d2: torch.Tensor,
                               stats: torch.Tensor, *, i: int, chunk: int,
                               g: int, znorm: bool,
                               gkth: Optional[torch.Tensor] = None,
                               otile: Optional[int] = None
                               ) -> torch.Tensor:
    """`fused_gather_ed_chunk` through the long-row kernel, at any qlen
    and g: the same counters and, at a qlen both take, the same partials
    bit for bit (blocks of `ed_chunk_tile(qlen, g, long=True)` rows).
    Past one block's g (or at a forced `otile`) a row's offsets take a
    block each `offset_tile`: a partials list a (row block, offset
    tile), so the pool after `pool_merge_partials` is the untiled one's
    bit for bit."""
    return _ed_chunk(fused_gather_ed_chunk_long, True, data, csum, csum2,
                     csum_lo, csum2_lo, center, sids, anchors, n_master,
                     lbs2, qs, pool_d2, stats, i, chunk, g, znorm, gkth,
                     otile)


fused_gather_ed_chunk_long.launches = 0


def _ed_range(wrapper, long, data, csum, csum2, csum_lo, csum2_lo, center,
              sids, anchors, n_master, lbs2, qs, eps2, ovf, stats, i, chunk,
              g, znorm, no_ovf, otile=None):
    dev = data.device
    s, n = data.shape
    b, qlen = qs.shape
    n_pad = sids.shape[1]
    what = wrapper.__name__
    _check_plan(what, data, csum, csum2, csum_lo, csum2_lo, center, sids,
                anchors, n_master, lbs2, (("qs", qs),), eps2, stats, i,
                chunk, ovf)
    no_ovf = n_pad // chunk if no_ovf is None else no_ovf
    force = _otile(what, otile)
    if dev.type == "cpu":
        return ref.fused_gather_ed_range_ref(
            data, csum, csum2, csum_lo, csum2_lo, center, sids, anchors,
            n_master, lbs2, qs, eps2, ovf, stats, i=i, chunk=chunk, g=g,
            znorm=znorm, no_ovf=no_ovf)
    ed_chunk_tile(qlen, g, long, force)     # raises where no block fits
    out = torch.empty((b, chunk * g), dtype=torch.float32, device=dev)
    lib = _build.library("fused_verify")
    entry = (lib.ulisse_fused_gather_ed_range_long if long
             else lib.ulisse_fused_gather_ed_range)
    code = entry(
        data.data_ptr(), csum.data_ptr(), csum2.data_ptr(),
        csum_lo.data_ptr(), csum2_lo.data_ptr(), center.data_ptr(),
        sids.data_ptr(), anchors.data_ptr(), n_master.data_ptr(),
        lbs2.data_ptr(), qs.data_ptr(), eps2.data_ptr(), ovf.data_ptr(),
        stats.data_ptr(), out.data_ptr(), s, n, b, chunk, qlen, g,
        int(znorm), n_pad, i * chunk, no_ovf, *((force,) if long else ()),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, what)
    wrapper.launches += 1
    return out


def fused_gather_ed_range(data: torch.Tensor, csum: torch.Tensor,
                          csum2: torch.Tensor, csum_lo: torch.Tensor,
                          csum2_lo: torch.Tensor, center: torch.Tensor,
                          sids: torch.Tensor, anchors: torch.Tensor,
                          n_master: torch.Tensor, lbs2: torch.Tensor,
                          qs: torch.Tensor, eps2: torch.Tensor,
                          ovf: torch.Tensor, stats: torch.Tensor, *, i: int,
                          chunk: int, g: int, znorm: bool,
                          no_ovf: Optional[int] = None) -> torch.Tensor:
    """The eps-range scan's ED step over chunk i: the range mode of the
    chunk entry, in one launch of the `fused_gather_ed` kernel.

    The plan, qs and stats as in `fused_gather_ed_chunk`; eps2 (B,)
    float32 the squared radii and ovf (B,) int32 the hit buffer's first
    unwritten chunk, both read on the device; ovf[b] == no_ovf (default
    n_pad // chunk, the plan's chunk count; a paged scan's one-chunk slab
    passes the whole plan's) while it never overflowed.  Query b is active
    while the chunk's first bound is finite and <= eps2[b] and ovf[b] is
    unset; rows with lbs2 <= eps2[b]
    are kept (inclusive); the counters are added as the k-NN mode adds
    them (`ref.fused_gather_ed_range_ref`).  Returns the dense (B, chunk
    * g) float32 d2 of the ok candidates, +inf wherever not ok.  On the
    card a qlen past the staged kernel's goes to
    `fused_gather_ed_range_long`.
    """
    long = qs.device.type == "cuda" and not staged("ed", qs.shape[1], g)
    return _ed_range(
        fused_gather_ed_range_long if long else fused_gather_ed_range, long,
        data, csum, csum2, csum_lo, csum2_lo, center, sids, anchors,
        n_master, lbs2, qs, eps2, ovf, stats, i, chunk, g, znorm, no_ovf)


fused_gather_ed_range.launches = 0


def fused_gather_ed_range_long(data: torch.Tensor, csum: torch.Tensor,
                               csum2: torch.Tensor, csum_lo: torch.Tensor,
                               csum2_lo: torch.Tensor, center: torch.Tensor,
                               sids: torch.Tensor, anchors: torch.Tensor,
                               n_master: torch.Tensor, lbs2: torch.Tensor,
                               qs: torch.Tensor, eps2: torch.Tensor,
                               ovf: torch.Tensor, stats: torch.Tensor, *,
                               i: int, chunk: int, g: int, znorm: bool,
                               no_ovf: Optional[int] = None,
                               otile: Optional[int] = None) -> torch.Tensor:
    """`fused_gather_ed_range` through the long-row kernel, at any qlen
    and g: the same counters and, at a qlen both take, the same d2 bit
    for bit, offset-tiled or not (`otile` forces the tile)."""
    return _ed_range(fused_gather_ed_range_long, True, data, csum, csum2,
                     csum_lo, csum2_lo, center, sids, anchors, n_master,
                     lbs2, qs, eps2, ovf, stats, i, chunk, g, znorm, no_ovf,
                     otile)


fused_gather_ed_range_long.launches = 0


def _lb(wrapper, entry, data, csum, csum2, csum_lo, csum2_lo, center, sids,
        anchors, dtw_lo, dtw_hi, g, rows, znorm, otile=None):
    dev = data.device
    s, n = data.shape
    b, qlen = dtw_lo.shape
    _check(wrapper.__name__, data, csum, csum2, csum_lo, csum2_lo, center,
           sids, anchors, rows, (("dtw_lo", dtw_lo), ("dtw_hi", dtw_hi)))
    long = entry.endswith("_long")
    otile = _otile(wrapper.__name__, otile)
    if dev.type == "cpu":
        return ref.fused_gather_lb_keogh_ref(
            data, csum, csum2, csum_lo, csum2_lo, center, sids, anchors,
            dtw_lo, dtw_hi, g=g, rows=rows, znorm=znorm)
    lib = _build.library("fused_verify")
    shape = lb_long_shape(b, rows, g, _sm_count(dev), otile) if long else ()
    lb, mu, sd = torch.empty((3, b * rows, g), dtype=torch.float32,
                             device=dev)
    code = getattr(lib, entry)(
        data.data_ptr(), csum.data_ptr(), csum2.data_ptr(),
        csum_lo.data_ptr(), csum2_lo.data_ptr(), center.data_ptr(),
        sids.data_ptr(), anchors.data_ptr(), dtw_lo.data_ptr(),
        dtw_hi.data_ptr(), lb.data_ptr(), mu.data_ptr(), sd.data_ptr(),
        s, n, b, rows, qlen, g, int(znorm), *shape,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, wrapper.__name__)
    wrapper.launches += 1
    return lb, mu, sd


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
    them).  On the card a qlen past the staged kernel's goes to
    `fused_gather_lb_keogh_long`.
    """
    if dtw_lo.device.type == "cuda" and not staged("dtw", dtw_lo.shape[1], g):
        return fused_gather_lb_keogh_long(
            data, csum, csum2, csum_lo, csum2_lo, center, sids, anchors,
            dtw_lo, dtw_hi, g=g, rows=rows, znorm=znorm)
    return _lb(fused_gather_lb_keogh, "ulisse_fused_gather_lb_keogh", data,
               csum, csum2, csum_lo, csum2_lo, center, sids, anchors, dtw_lo,
               dtw_hi, g, rows, znorm)


fused_gather_lb_keogh.launches = 0


def fused_gather_lb_keogh_long(data: torch.Tensor, csum: torch.Tensor,
                               csum2: torch.Tensor, csum_lo: torch.Tensor,
                               csum2_lo: torch.Tensor, center: torch.Tensor,
                               sids: torch.Tensor, anchors: torch.Tensor,
                               dtw_lo: torch.Tensor, dtw_hi: torch.Tensor, *,
                               g: int, rows: int, znorm: bool,
                               otile: Optional[int] = None):
    """`fused_gather_lb_keogh` through the long-row kernel, at any qlen
    and g: the same (lb2, mu, sd), bit for bit where both take the shape
    (`otile` forces the windows a block takes, `lb_long_shape`)."""
    return _lb(fused_gather_lb_keogh_long, "ulisse_fused_gather_lb_keogh_long",
               data, csum, csum2, csum_lo, csum2_lo, center, sids, anchors,
               dtw_lo, dtw_hi, g, rows, znorm, otile)


fused_gather_lb_keogh_long.launches = 0


def _lb_chunk(wrapper, long, data, csum, csum2, csum_lo, csum2_lo, center,
              sids, anchors, n_master, lbs2, dtw_lo, dtw_hi, cut, ovf, stats,
              i, chunk, g, znorm, no_ovf=None, gkth=None, otile=None):
    """The LB chunk entries: k-NN (ovf None, cut the pool's (B, k) d2,
    gkth the sharded scan's (B,) or None) or range (cut eps2 (B,), ovf
    (B,), no_ovf its no-overflow value)."""
    dev = data.device
    s, n = data.shape
    b, qlen = dtw_lo.shape
    n_pad = sids.shape[1]
    m = chunk * g
    what = wrapper.__name__
    _check_plan(what, data, csum, csum2, csum_lo, csum2_lo, center, sids,
                anchors, n_master, lbs2, (("dtw_lo", dtw_lo),
                                          ("dtw_hi", dtw_hi)),
                cut, stats, i, chunk, ovf, gkth)
    no_ovf = n_pad // chunk if no_ovf is None else no_ovf
    force = _otile(what, otile)
    if dev.type == "cpu":
        if ovf is None:
            return ref.fused_gather_lb_keogh_chunk_ref(
                data, csum, csum2, csum_lo, csum2_lo, center, sids, anchors,
                n_master, lbs2, dtw_lo, dtw_hi, cut, stats, i=i, chunk=chunk,
                g=g, znorm=znorm, gkth=gkth)
        return ref.fused_gather_lb_keogh_range_ref(
            data, csum, csum2, csum_lo, csum2_lo, center, sids, anchors,
            n_master, lbs2, dtw_lo, dtw_hi, cut, ovf, stats, i=i,
            chunk=chunk, g=g, znorm=znorm, no_ovf=no_ovf)
    lib = _build.library("fused_verify")
    shape = lb_long_shape(b, chunk, g, _sm_count(dev), force) if long else ()
    lb, mu, sd = torch.empty((3, b * chunk, g), dtype=torch.float32,
                             device=dev)
    slist, cand_sid, cand_off = torch.empty((3, b, m), dtype=torch.int32,
                                            device=dev)
    nsurv = torch.empty(b, dtype=torch.int32, device=dev)   # zeroed there
    d2 = torch.empty((b, m), dtype=torch.float32, device=dev)
    entry = (lib.ulisse_fused_gather_lb_keogh_chunk_long if long
             else lib.ulisse_fused_gather_lb_keogh_chunk)
    code = entry(
        data.data_ptr(), csum.data_ptr(), csum2.data_ptr(),
        csum_lo.data_ptr(), csum2_lo.data_ptr(), center.data_ptr(),
        sids.data_ptr(), anchors.data_ptr(), n_master.data_ptr(),
        lbs2.data_ptr(), dtw_lo.data_ptr(), dtw_hi.data_ptr(),
        cut.data_ptr(), None if gkth is None else gkth.data_ptr(),
        None if ovf is None else ovf.data_ptr(),
        stats.data_ptr(), lb.data_ptr(), mu.data_ptr(), sd.data_ptr(),
        slist.data_ptr(), nsurv.data_ptr(), d2.data_ptr(),
        cand_sid.data_ptr(), cand_off.data_ptr(), s, n, b, chunk, qlen, g,
        int(znorm), n_pad, i * chunk, cut.shape[-1] if ovf is None else 1,
        int(ovf is not None), no_ovf, *shape,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, what)
    wrapper.launches += 1
    return lb, mu, sd, slist, nsurv, d2, cand_sid, cand_off


def fused_gather_lb_keogh_chunk(data: torch.Tensor, csum: torch.Tensor,
                                csum2: torch.Tensor, csum_lo: torch.Tensor,
                                csum2_lo: torch.Tensor, center: torch.Tensor,
                                sids: torch.Tensor, anchors: torch.Tensor,
                                n_master: torch.Tensor, lbs2: torch.Tensor,
                                dtw_lo: torch.Tensor, dtw_hi: torch.Tensor,
                                pool_d2: torch.Tensor, stats: torch.Tensor,
                                *, i: int, chunk: int, g: int, znorm: bool,
                                gkth: Optional[torch.Tensor] = None):
    """The scan's LB_Keogh step over chunk i, in one launch of the
    `fused_gather_lb_keogh` kernel.

    sids/anchors/n_master (B, n_pad) int32 and lbs2 (B, n_pad) float32
    are the LB-sorted plan (chunk i is columns [i * chunk, (i + 1) *
    chunk)), dtw_lo/dtw_hi (B, qlen) the queries' DTW envelopes, pool_d2
    (B, k) the pool's ascending d2 and stats the scan's (B, 6) int32
    counters.  The kernel decides which queries are active (the chunk's
    first bound is finite and below the pool's k-th), keeps the rows
    with lbs2 < kth, takes the ok candidates of kept rows (masters that
    fit the series), and adds [active, kept rows, survivors, ok
    candidates, survivors, pruned rows] in place
    (`ref.fused_gather_lb_keogh_chunk_ref` says which).  Returns (lb2,
    mu, sd, slist, nsurv, d2, cand_sid, cand_off): lb2/mu/sd (B * chunk,
    g) as the contract entry's with lb2 = +inf where not ok; query b's
    survivors (ok, lb2 < kth) are the positions slist[b, :nsurv[b]]
    (int32; in any order on the card, ascending on the CPU) and nsurv
    (B,) int32 counts them; d2 (B, M = chunk * g) float32 is +inf at
    every non-survivor, for `dtw_survivors` to fill the rest;
    cand_sid/cand_off (B, M) int32 each candidate's (sid, off).  All on
    the device: no torch op and no host sync around it.  On the card a
    qlen past the staged kernel's goes to
    `fused_gather_lb_keogh_chunk_long`.

    `gkth` (B,) float32, the sharded scan's mesh-wide k-th (None on every
    local path): active, keep, pruned and the survivors then cut at
    min(pool k-th, gkth[b]).
    """
    long = (dtw_lo.device.type == "cuda"
            and not staged("dtw", dtw_lo.shape[1], g))
    return _lb_chunk(
        fused_gather_lb_keogh_chunk_long if long
        else fused_gather_lb_keogh_chunk, long, data, csum, csum2, csum_lo,
        csum2_lo, center, sids, anchors, n_master, lbs2, dtw_lo, dtw_hi,
        pool_d2, None, stats, i, chunk, g, znorm, gkth=gkth)


fused_gather_lb_keogh_chunk.launches = 0


def fused_gather_lb_keogh_chunk_long(
        data: torch.Tensor, csum: torch.Tensor, csum2: torch.Tensor,
        csum_lo: torch.Tensor, csum2_lo: torch.Tensor, center: torch.Tensor,
        sids: torch.Tensor, anchors: torch.Tensor, n_master: torch.Tensor,
        lbs2: torch.Tensor, dtw_lo: torch.Tensor, dtw_hi: torch.Tensor,
        pool_d2: torch.Tensor, stats: torch.Tensor, *, i: int, chunk: int,
        g: int, znorm: bool, gkth: Optional[torch.Tensor] = None,
        otile: Optional[int] = None):
    """`fused_gather_lb_keogh_chunk` through the long-row kernel, at any
    qlen and g: the same outputs and counters, bit for bit where both
    take the shape (the survivor list in any order), whatever the blocks
    (`otile` forces the windows a block takes, `lb_long_shape`)."""
    return _lb_chunk(fused_gather_lb_keogh_chunk_long, True, data, csum,
                     csum2, csum_lo, csum2_lo, center, sids, anchors,
                     n_master, lbs2, dtw_lo, dtw_hi, pool_d2, None, stats, i,
                     chunk, g, znorm, gkth=gkth, otile=otile)


fused_gather_lb_keogh_chunk_long.launches = 0


def fused_gather_lb_keogh_range(data: torch.Tensor, csum: torch.Tensor,
                                csum2: torch.Tensor, csum_lo: torch.Tensor,
                                csum2_lo: torch.Tensor, center: torch.Tensor,
                                sids: torch.Tensor, anchors: torch.Tensor,
                                n_master: torch.Tensor, lbs2: torch.Tensor,
                                dtw_lo: torch.Tensor, dtw_hi: torch.Tensor,
                                eps2: torch.Tensor, ovf: torch.Tensor,
                                stats: torch.Tensor, *, i: int, chunk: int,
                                g: int, znorm: bool,
                                no_ovf: Optional[int] = None):
    """The eps-range scan's LB_Keogh step over chunk i: the range mode of
    `fused_gather_lb_keogh_chunk`, in one launch.  eps2 (B,) float32 and
    ovf (B,) int32 (the hit buffer's first unwritten chunk; no_ovf,
    default n_pad // chunk, while it never overflowed) replace the pool:
    a query is active while the chunk's first bound is finite and <=
    eps2[b] and ovf[b] is unset, and rows and candidates are cut at
    <= eps2 (inclusive).  The same outputs and counters
    (`ref.fused_gather_lb_keogh_range_ref`).  On the card a qlen past the
    staged kernel's goes to `fused_gather_lb_keogh_range_long`."""
    long = (dtw_lo.device.type == "cuda"
            and not staged("dtw", dtw_lo.shape[1], g))
    return _lb_chunk(
        fused_gather_lb_keogh_range_long if long
        else fused_gather_lb_keogh_range, long, data, csum, csum2, csum_lo,
        csum2_lo, center, sids, anchors, n_master, lbs2, dtw_lo, dtw_hi,
        eps2, ovf, stats, i, chunk, g, znorm, no_ovf)


fused_gather_lb_keogh_range.launches = 0


def fused_gather_lb_keogh_range_long(
        data: torch.Tensor, csum: torch.Tensor, csum2: torch.Tensor,
        csum_lo: torch.Tensor, csum2_lo: torch.Tensor, center: torch.Tensor,
        sids: torch.Tensor, anchors: torch.Tensor, n_master: torch.Tensor,
        lbs2: torch.Tensor, dtw_lo: torch.Tensor, dtw_hi: torch.Tensor,
        eps2: torch.Tensor, ovf: torch.Tensor, stats: torch.Tensor, *,
        i: int, chunk: int, g: int, znorm: bool,
        no_ovf: Optional[int] = None, otile: Optional[int] = None):
    """`fused_gather_lb_keogh_range` through the long-row kernel, at any
    qlen and g: the same outputs and counters, bit for bit where both
    take the shape (the survivor list in any order), whatever the blocks
    (`otile` forces the windows a block takes, `lb_long_shape`)."""
    return _lb_chunk(fused_gather_lb_keogh_range_long, True, data, csum,
                     csum2, csum_lo, csum2_lo, center, sids, anchors,
                     n_master, lbs2, dtw_lo, dtw_hi, eps2, ovf, stats, i,
                     chunk, g, znorm, no_ovf, otile=otile)


fused_gather_lb_keogh_range_long.launches = 0


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
