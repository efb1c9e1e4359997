"""Verification for ULISSE search (the *executor* half): k-NN and
eps-range.

Everything that touches raw series data lives here: the chunked,
LB-sorted, bsf-pruned exact scan over packed candidate rows, whose true
distances come from the `fused_gather_ed_chunk` kernel (ED, which also
decides the active queries and kept rows, counts and pre-selects each
block's k best) or from the LB_Keogh tier `fused_gather_lb_keogh_chunk`
(which does the same deciding and counting and lists the survivors) and
the banded DP `dtw_survivors` on them (DTW), the (B, k) device pool that
the `pool_merge` kernels merge into in place; the eps-range scan over
the sortless range pack, whose steps are the same entries' range modes
(`fused_gather_ed_range`; `fused_gather_lb_keogh_range` then
`dtw_survivors`) and the ordered hit append `range_append` into a (B,
cap) hit buffer; the paged out-of-core twins of both scans
(`paged_exact_scan`, `paged_range_scan`: the same steps on slabs
gathered from a `PayloadStore`); and the result/stats containers.  No
step has a torch prologue: the kernels read the plan, the pool or eps2
and the buffer's overflow flags themselves.

The host backend (`scan_backend="host"`, the reference's host-driven
loop) verifies one query's envelopes at a time: `gather_windows` cuts
the candidate windows on the device, `batch_ed` (ED) or `lb_keogh` then
the `dtw_band` entry on the survivors (DTW) give their distances, and a
numpy pool (`TopK`) keeps the best.  It reads back every chunk's bounds
and distances by design; each readback goes through `to_host`, which
counts it.

The JAX package runs the scan as one `lax.while_loop` program.  Eager
PyTorch pays a host sync for every stop test, so the scan here tests
its stop flag only every `STOP_TEST_EVERY` chunks: a chunk in which no
query is active leaves every pool and counter unchanged (no envelope is
kept, every candidate is +inf and loses its tie to the incumbents, and
the `active` column adds 0), so the results and stats are identical to
testing after every chunk.  The range scan's activity is monotone
too (its packed candidates come first, +inf padding after, and an
overflow is final), so the same holds there.
"""
from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.paa import znormalize
from repro_torch.core.types import Collection
from repro_torch.kernels.batch_ed import batch_ed
from repro_torch.kernels.dtw_band import dtw_band, dtw_survivors
from repro_torch.kernels.fused_verify import (fused_gather_ed_chunk,
                                              fused_gather_ed_range,
                                              fused_gather_lb_keogh_chunk,
                                              fused_gather_lb_keogh_range)
from repro_torch.kernels.lb_keogh import lb_keogh
from repro_torch.kernels.pool_merge import pool_merge, pool_merge_partials
from repro_torch.kernels.range_append import range_append

# Per-query device stats columns (the JAX package's order).
STATS_COLUMNS = ("chunks_visited", "envelopes_checked",
                 "true_dist_computations", "dtw_lb_keogh", "dtw_full",
                 "envelopes_pruned")
STATS_WIDTH = 6
assert len(STATS_COLUMNS) == STATS_WIDTH

# Chunks the scan runs between two host-side stop tests.
STOP_TEST_EVERY = 8


@dataclasses.dataclass
class SearchStats:
    """The one per-query stats schema (the JAX package's, field for field).

    `envelopes_pruned` counts envelopes cut by the bsf lower-bound test
    inside visited chunks; `chunks_planned` is the dispatch plan's chunk
    count.
    """
    envelopes_total: int = 0
    envelopes_checked: int = 0       # envelopes whose raw data was read
    envelopes_pruned: int = 0        # LB/bsf cuts inside visited chunks
    lb_computations: int = 0
    true_dist_computations: int = 0  # ED on raw windows
    dtw_lb_keogh: int = 0            # second-tier LB computations
    dtw_full: int = 0                # full banded DPs executed
    leaves_visited: int = 0
    chunks_visited: int = 0
    chunks_planned: int = 0          # chunks in the dispatch plan
    exact_from_approx: bool = False
    escalations: int = 0             # exactness-certificate retries
    range_overflows: int = 0         # device hit-buffer overflows (range)
    shard_chunks: Optional[list] = None  # per-shard chunk counts (sharded)

    @property
    def pruning_power(self) -> float:
        if self.envelopes_total == 0:
            return 0.0
        return 1.0 - self.envelopes_checked / self.envelopes_total

    @property
    def abandoning_power(self) -> float:
        """Fraction of candidate true-distance computations avoided."""
        if self.dtw_lb_keogh > 0:
            return 1.0 - self.dtw_full / max(self.dtw_lb_keogh, 1)
        return 0.0

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["pruning_power"] = self.pruning_power
        d["abandoning_power"] = self.abandoning_power
        return d


@dataclasses.dataclass
class SearchResult:
    dists: np.ndarray      # (k,) sorted true distances
    series: np.ndarray     # (k,) series ids
    offsets: np.ndarray    # (k,) window offsets
    stats: SearchStats


class TopK:
    """Host-side k-best pool over (dist, sid, off) triples (the
    reference's, numpy)."""

    def __init__(self, k: int):
        self.k = k
        self.d = np.full((0,), np.inf, np.float64)
        self.s = np.zeros((0,), np.int64)
        self.o = np.zeros((0,), np.int64)

    def push(self, d, s, o):
        d = np.concatenate([self.d, np.asarray(d, np.float64)])
        s = np.concatenate([self.s, np.asarray(s, np.int64)])
        o = np.concatenate([self.o, np.asarray(o, np.int64)])
        # dedup (sid, off): the approx phase and the exact scan may verify
        # the same envelope; a subsequence must appear in the pool once
        order = np.lexsort((d, o, s))
        d, s, o = d[order], s[order], o[order]
        first = np.ones(len(d), bool)
        first[1:] = (s[1:] != s[:-1]) | (o[1:] != o[:-1])
        d, s, o = d[first], s[first], o[first]
        order = np.argsort(d, kind="stable")[: self.k]
        self.d, self.s, self.o = d[order], s[order], o[order]

    @property
    def kth(self) -> float:
        return float(self.d[-1]) if len(self.d) == self.k else np.inf

    def result(self, stats: SearchStats) -> SearchResult:
        return SearchResult(dists=np.sqrt(np.maximum(self.d, 0.0)),
                            series=self.s, offsets=self.o, stats=stats)


def to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor's values on the host: one device-to-host readback (a
    sync) of the host backend, counted in `to_host.syncs`."""
    to_host.syncs += 1
    return t.cpu().numpy()


to_host.syncs = 0

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64,
              torch.int32: np.int32, torch.int64: np.int64,
              torch.bool: np.bool_, torch.uint8: np.uint8}


def read_back(*tensors: torch.Tensor) -> List[np.ndarray]:
    """The tensors' values on the host in ONE device-to-host copy, so one
    sync: their bytes packed into one device buffer, copied once, split
    on the host.  A device path's result readback (and a paged scan's
    plan readback), counted in `read_back.syncs`."""
    read_back.syncs += 1
    flat = []
    for t in tensors:
        f = t.detach().reshape(-1)
        if f.numel() and f.stride(0) != 1:   # a strided column (or one
            f = torch.empty(f.shape, dtype=f.dtype,      # strided entry)
                            device=f.device).copy_(f)
        flat.append(f.view(torch.uint8))
    host = torch.cat(flat).cpu().numpy()
    out, at = [], 0
    for t, f in zip(tensors, flat):
        n = f.numel()
        out.append(host[at:at + n].view(_NP_DTYPES[t.dtype])
                   .reshape(tuple(t.shape)).copy())
        at += n
    return out


read_back.syncs = 0


def host_envelopes(index) -> dict:
    """Host (numpy) copies of the candidate set's series_id, anchor,
    n_master and valid columns, cached on the index: the host backend
    plans its gathers from them without reading the device."""
    env = index.search_envelopes()
    cached = getattr(index, "_host_envelopes", None)
    if cached is None or cached[0] is not env.series_id:
        cached = (env.series_id, {
            f: getattr(env, f).cpu().numpy()
            for f in ("series_id", "anchor", "n_master", "valid")})
        index._host_envelopes = cached
    return cached[1]


def gather_windows(data: torch.Tensor, sids: np.ndarray,
                   anchors: np.ndarray, n_master: np.ndarray, qlen: int,
                   g: int):
    """Raw candidate windows for a batch of E envelopes.

    Each envelope contributes g = gamma+1 candidate offsets anchor ..
    anchor + g - 1, valid where the master exists (< n_master) and the
    window fits the series; invalid ones read the window at the offset
    clipped into the series.  sids / anchors / n_master are (E,) host
    arrays.  Returns windows (E*g, qlen) on data's device, and the host
    arrays ok (E*g,) and offs (E*g,).
    """
    n = data.shape[1]
    offs = anchors.astype(np.int64)[:, None] + np.arange(g)     # (E, g)
    ok = (np.arange(g)[None, :] < n_master[:, None]) & (offs + qlen <= n)
    at = np.stack([np.repeat(sids.astype(np.int64), g),
                   np.clip(offs, 0, n - qlen).reshape(-1)])
    at = torch.from_numpy(at).to(data.device, non_blocking=True)
    windows = data.unfold(1, qlen, 1)[at[0], at[1]].contiguous()
    return windows, ok.reshape(-1), offs.reshape(-1)


def ed_batch(windows: torch.Tensor, q: torch.Tensor,
             znorm: bool) -> torch.Tensor:
    """Squared ED (M,) of windows (M, l) to one prepared query (l,): the
    `batch_ed` kernel at one query."""
    return batch_ed(windows, q[None], znorm)[:, 0]


def lb_keogh_batch(windows, dtw_lo, dtw_hi, znorm: bool):
    """(squared LB_Keogh (M,), the windows it read): Z-normalized windows
    in plain torch when znorm, then the `lb_keogh` kernel."""
    if znorm:
        windows = znormalize(windows)
    return lb_keogh(dtw_lo, dtw_hi, windows), windows


def dtw_batch(windows, q, r: int):
    """Squared banded DTW (M,) of q against windows (M, l), already
    normalized where the index is: the `dtw_band` kernel."""
    return dtw_band(q, windows, r)


def verify_envelopes(index, pq, env_idx: np.ndarray, pool: TopK,
                     stats: SearchStats, eps2: Optional[float] = None,
                     collector: Optional[list] = None, store=None):
    """Compute true distances for all candidates of the given envelopes
    (indices into the candidate set main ++ delta, host array; the
    collection already holds the appended series' rows).

    Updates the pool (k-NN) or appends (sid, off, d2) rows below eps2 to
    `collector` (range query).  Distances are squared throughout.
    `store`: a paged engine's `PayloadStore` — the envelopes' series rows
    are read through its page cache (`take_rows`) instead of the whole
    collection.
    """
    p = index.params
    g = p.gamma + 1
    host = host_envelopes(index)
    sids = host["series_id"][env_idx]
    if store is None:
        data, rows = index.collection.data, sids
    else:
        uniq, rows = np.unique(sids, return_inverse=True)
        data = torch.from_numpy(store.take_rows(uniq)).to(pq.q.device)
    windows, ok, offs = gather_windows(
        data, rows, host["anchor"][env_idx], host["n_master"][env_idx],
        pq.qlen, g)
    stats.envelopes_checked += len(env_idx)
    verify_windows(windows, np.repeat(sids, g), offs, ok, pq, p.znorm,
                   pool, stats, eps2=eps2, collector=collector)


def verify_windows(windows, all_sids: np.ndarray, offs_np: np.ndarray,
                   ok_np: np.ndarray, pq, znorm: bool, pool: TopK,
                   stats: SearchStats, *, eps2: Optional[float] = None,
                   collector: Optional[list] = None):
    """Distance tiers + pool/collector update for gathered candidate
    windows (B*g, qlen) — one copy of the cut rules for every host-side
    caller.

    ED: the dot-identity distance of every window, read back.  DTW:
    LB_Keogh of every window, read back; the survivors (lb2 < kth for
    k-NN, lb2 <= eps2 for range: lb <= d, so a strict range cut would
    drop boundary hits) get the banded DP on the same normalized windows
    the LB read, read back.  The reference pads the survivors to a power
    of two to bound recompiles; eager torch needs no padding, and the
    counters count the survivors either way.
    """
    if pq.measure == "ed":
        d2 = to_host(ed_batch(windows, pq.q, znorm)).astype(np.float64)
        d2[~ok_np] = np.inf
        stats.true_dist_computations += int(ok_np.sum())
    else:
        lb2, wn = lb_keogh_batch(windows, pq.dtw_lo, pq.dtw_hi, znorm)
        lb2 = to_host(lb2).astype(np.float64)
        lb2[~ok_np] = np.inf
        stats.dtw_lb_keogh += int(ok_np.sum())
        if eps2 is None:
            survivors = np.nonzero(lb2 < pool.kth)[0]
        else:
            survivors = np.nonzero(lb2 <= eps2)[0]
        d2 = np.full(lb2.shape, np.inf)
        if len(survivors) > 0:
            pick = torch.from_numpy(survivors).to(wn.device,
                                                  non_blocking=True)
            d2[survivors] = to_host(dtw_batch(wn[pick], pq.q, pq.r))
            stats.dtw_full += len(survivors)
        stats.true_dist_computations += len(survivors)

    if collector is not None:
        hit = np.nonzero(d2 <= eps2)[0]
        if len(hit):
            collector.append(np.stack([all_sids[hit], offs_np[hit],
                                       d2[hit]], axis=1))
    else:
        pool.push(d2, all_sids, offs_np)


def range_host_tail(index, pq, order, lbs2, pos: int, chunk: int,
                    eps2: float, rows: list, stats: SearchStats,
                    store=None) -> None:
    """Verify one query's range candidates `order` (indices into the
    index's candidate set, with their squared bounds `lbs2`) from row
    `pos` on through the host path, a chunk at a time, into the collected
    (sid, off, d2) rows: every row is a candidate (lb2 <= eps2) and +inf
    marks a padding tail.  The host backend runs all of its candidates;
    a device range scan (a shard's, on the distributed backend) replays
    its packed plan from the chunk where its hit buffer overflowed (a
    paged engine through its store's page cache, `store`)."""
    sink = TopK(1)   # unused: the collector takes the hits
    while pos < len(order):
        keep = np.isfinite(lbs2[pos:pos + chunk])
        if not keep[0]:
            break
        verify_envelopes(index, pq, order[pos:pos + chunk][keep], sink,
                         stats, eps2=eps2, collector=rows, store=store)
        stats.chunks_visited += 1
        pos += chunk


def ed_rescore64(data: np.ndarray, rows: np.ndarray, off: np.ndarray, q,
                 znorm: bool) -> np.ndarray:
    """Direct float64 squared ED of the windows data[rows, off : off +
    len(q)] to q: the polish every ED result path shares (the kernels' dot
    identity cancels near d = 0)."""
    w = data[rows[:, None], off[:, None] + np.arange(len(q))] \
        .astype(np.float64)
    qn = np.asarray(q, np.float64)
    if znorm:
        qn = (qn - qn.mean()) / max(qn.std(), 1e-8)
        mu = w.mean(1, keepdims=True)
        sd = np.maximum(w.std(1, keepdims=True), 1e-8)
        w -= mu
        w /= sd
    w -= qn
    np.square(w, out=w)
    return w.sum(1)


def pow2ceil(x: int) -> int:
    b = 1
    while b < x:
        b <<= 1
    return b


def shard_pack_geometry(n_rows: int, delta_rows: int, chunk_size: int):
    """Chunk geometry of a shard's packed k-NN plan with a delta-first
    region (the JAX package's, line for line).

    The sharded scan packs a shard's `delta_rows` unsorted delta envelopes
    first, padded up to whole chunks, then the LB-sorted main rows, and
    pow2-pads the total.  Returns (n_pad, chunk, nd_pad): the plan's
    width, the scan's chunk size and the padded delta region's width (a
    multiple of chunk; nd_pad // chunk always-visited delta chunks stretch
    the approximate budget).  With delta_rows == 0 this is the classic
    geometry (n_pad = pow2ceil(n_rows), nd_pad = 0).
    """
    chunk = min(pow2ceil(chunk_size), pow2ceil(max(n_rows, 1)))
    nd_pad = -(-delta_rows // chunk) * chunk
    n_pad = pow2ceil((n_rows - delta_rows) + nd_pad)
    return n_pad, chunk, nd_pad


def _scan_chunk_step(coll: Collection, sids, anchors, n_master, lbs2, qs,
                     dtw_lo, dtw_hi, i: int, pool, stats, *, k: int, g: int,
                     chunk: int, znorm: bool, measure: str, r: int,
                     gmap=None, gkth=None):
    """Verify chunk `i` of the packed plan into the (B, k) pool, in place.

    ED: ONE launch of `fused_gather_ed_chunk`, which decides which
    queries are active and which envelopes the bsf cut keeps, adds the
    step's counters, computes the kept candidates' distances and keeps
    each block's k best, and ONE `pool_merge_partials` launch.  DTW: ONE
    launch of the LB_Keogh tier (`fused_gather_lb_keogh_chunk`), which
    decides the same, adds the counters, lists each query's survivors
    (lb2 < kth) on the device, writes +inf into the DP's (B, chunk * g)
    output at every other candidate position and gives every candidate's
    (sid, off); ONE `dtw_survivors` launch over every survivor of the
    chunk, which writes each one's distance at its own position; and ONE
    `pool_merge` of that output.  The reference merges bucket by bucket
    (`lax.while_loop` over buckets of 128 survivors packed in
    candidate-position order); one merge of the position-indexed output
    gives the same pool, because the merge keeps incumbents ahead of
    newcomers on ties and then orders candidates by position, so every
    bucket merge and the single merge pick the k least of the same (d2,
    position) order — whatever order the kernel listed the survivors in —
    and no host sync is needed to size the loop.

    Adds the per-query increments of [chunks, envelopes_checked,
    true_dists, lb_keogh, dtw_full, envelopes_pruned] to the (B,
    STATS_WIDTH) int32 `stats` in place.

    `gmap`: a paged slab's (R + 1,) int32 table from slab-local series
    ids to global ones, -1 last: the entries report the slab plan's own
    ids, which the pool must hold as global ones, so they are mapped
    through it on the device before the merge (an empty partial's -1
    maps to -1).

    `gkth`: the sharded scan's (B,) float32 mesh-wide k-th (None locally):
    both entries then cut active, keep and pruned (and the DTW survivors)
    at min(pool k-th, gkth), the JAX package's `kth` of its sharded step.
    """
    a0 = (coll.data, coll.csum, coll.csum2, coll.csum_lo, coll.csum2_lo,
          coll.center)
    if measure == "ed":
        part = fused_gather_ed_chunk(
            *a0, sids, anchors, n_master, lbs2, qs, pool[0], stats, i=i,
            chunk=chunk, g=g, znorm=znorm, gkth=gkth)
        if gmap is not None:
            part[1] = gmap[part[1].long()]
        pool_merge_partials(pool, part)
        return
    cand_sid, cand_off, db = _dtw_step(
        fused_gather_lb_keogh_chunk(
            *a0, sids, anchors, n_master, lbs2, dtw_lo, dtw_hi, pool[0],
            stats, i=i, chunk=chunk, g=g, znorm=znorm, gkth=gkth),
        coll, qs, r, znorm)
    if gmap is not None:
        cand_sid = gmap[cand_sid.long()]
    pool_merge(pool, db, cand_sid, cand_off)


def _dtw_step(lb_out, coll: Collection, qs, r: int, znorm: bool):
    """The DP behind an LB_Keogh chunk entry's outputs: `dtw_survivors`
    over the survivors it listed, into the DP output it prepared.
    Returns (cand_sid, cand_off, d2)."""
    _, mu, sd, slist, nsurv, db, cand_sid, cand_off = lb_out
    b_sz, m = db.shape
    db = dtw_survivors(coll.data, qs, slist, nsurv, cand_sid, cand_off,
                       mu.view(b_sz, m), sd.view(b_sz, m), db, r=r,
                       znorm=znorm)
    return cand_sid, cand_off, db


def _range_chunk_step(coll: Collection, sids, anchors, n_master, lbs2, qs,
                      dtw_lo, dtw_hi, i: int, eps2, buf, cnt, ovf, stats, *,
                      g: int, chunk: int, znorm: bool, measure: str, r: int,
                      gsids=None, i_code: Optional[int] = None,
                      no_ovf: Optional[int] = None):
    """Verify chunk `i` of the range pack into the hit buffer, in place.

    ED: ONE launch of `fused_gather_ed_range` (the chunk entry's range
    mode: active queries from the chunk's first bound, eps2 and the
    buffer's ovf, inclusive cuts, the counters, the dense d2) and ONE of
    `range_append`.  DTW: ONE launch of `fused_gather_lb_keogh_range`
    (the same deciding and counting; the survivors lb2 <= eps2 listed),
    ONE of `dtw_survivors` and ONE of `range_append`.  `range_append`
    writes the chunk's hits (d2 <= eps2) in position order, or none and
    ovf = i when they would overflow; the next step's entry reads that
    ovf in stream order.

    A paged scan's one-chunk slab passes `gsids`, the (B, chunk) global
    ids of the plan columns (the buffer holds global ids, the slab plan
    local ones), and the whole plan's chunk index and chunk count as
    `i_code` and `no_ovf`, so `ovf` records plan chunks and the host
    continuation resumes at the right plan row.
    """
    a0 = (coll.data, coll.csum, coll.csum2, coll.csum_lo, coll.csum2_lo,
          coll.center)
    if measure == "ed":
        d2 = fused_gather_ed_range(
            *a0, sids, anchors, n_master, lbs2, qs, eps2, ovf, stats, i=i,
            chunk=chunk, g=g, znorm=znorm, no_ovf=no_ovf)
    else:
        d2 = _dtw_step(fused_gather_lb_keogh_range(
            *a0, sids, anchors, n_master, lbs2, dtw_lo, dtw_hi, eps2, ovf,
            stats, i=i, chunk=chunk, g=g, znorm=znorm, no_ovf=no_ovf), coll,
            qs, r, znorm)[-1]
    range_append(d2, sids if gsids is None else gsids, anchors, eps2, buf,
                 cnt, ovf, i=i, chunk=chunk, g=g, i_code=i_code,
                 no_ovf=no_ovf)


def _device_scan_core(coll: Collection, sids, anchors, n_master, lbs2, qs,
                      dtw_lo, dtw_hi, seed, *, k: int, g: int, chunk: int,
                      znorm: bool, measure: str, r: int):
    """The natively batched LB-sorted bsf-pruned scan.

    Every chunk step verifies the i-th chunk of all B queries; queries
    whose scan has converged keep stepping with their candidates masked
    to +inf (merge no-ops) until the whole batch is done.  The pool is
    the scan's own copy of the seed (cloned once), merged in place, so
    the caller's seed is never written.  The stop test `any(active)` runs
    on the host before every group of STOP_TEST_EVERY chunks — one sync
    per group, counted in `device_exact_scan.syncs`.
    """
    n_chunks = sids.shape[1] // chunk
    pool = tuple(t.clone() for t in seed)
    stats = torch.zeros((qs.shape[0], STATS_WIDTH), dtype=torch.int32,
                        device=qs.device)
    i = 0
    while i < n_chunks:
        device_exact_scan.syncs += 1
        # `ref.scan_active` in two launches: first < kth is false for the
        # +inf padding (and for a +inf kth), so it implies a finite first
        first = lbs2[:, min(i * chunk, lbs2.shape[1] - 1)]
        if not bool((first < pool[0][:, -1]).any()):
            break
        for _ in range(min(STOP_TEST_EVERY, n_chunks - i)):
            _scan_chunk_step(
                coll, sids, anchors, n_master, lbs2, qs, dtw_lo, dtw_hi, i,
                pool, stats, k=k, g=g, chunk=chunk, znorm=znorm,
                measure=measure, r=r)
            i += 1
    return pool[0], pool[1], pool[2], stats


def device_exact_scan(collection: Collection, sids, anchors, n_master, lbs2,
                      qs, dtw_lo, dtw_hi, seed_d2, seed_sid, seed_off, *,
                      k: int, g: int, measure: str, r: int, znorm: bool,
                      chunk_size: int):
    """Batched device-resident exact scan (ED or DTW).

    sids/anchors/n_master/lbs2 (B, n_pad) are LB-sorted padded candidate
    rows (`planner.device_scan_pack`, or `device_leaf_pack` for the
    approximate stage), qs/dtw_lo/dtw_hi (B, qlen) the prepared queries
    and their DTW envelopes (ED: pass qs in the dtw slots; they are not
    read), seed_* the (B, k) pools the scan starts from (ascending d2,
    +inf filler).

    Returns device tensors (d2 (B, k) f32 ascending, sid/off (B, k)
    int32, stats (B, STATS_WIDTH) int32); the caller does the readback.
    """
    n_pad = sids.shape[1]
    chunk = min(pow2ceil(chunk_size), n_pad)
    return _device_scan_core(
        collection, sids, anchors, n_master, lbs2, qs, dtw_lo, dtw_hi,
        (seed_d2, seed_sid, seed_off), k=k, g=g, chunk=chunk, znorm=znorm,
        measure=measure, r=r)


device_exact_scan.syncs = 0


_FLT_MAX = float(np.finfo(np.float32).max)


def _device_range_core(coll: Collection, sids, anchors, n_master, lbs2, qs,
                       dtw_lo, dtw_hi, eps2, *, cap: int, g: int, chunk: int,
                       znorm: bool, measure: str, r: int):
    """The natively batched eps-range scan over the sortless range pack.

    Every chunk step verifies the i-th chunk of all B queries into the
    (B, cap) hit buffer (`_range_chunk_step`).  A query is active while
    its chunk's first bound is finite and <= eps2 and its buffer has not
    overflowed; an overflowing chunk writes none of its hits and records
    itself in ovf, after which the query stays inactive — the buffer then
    holds exactly the hits of chunks [0, ovf), and the engine finishes
    chunks [ovf, n_chunks) on the host.  The stop test runs on the host
    before every group of STOP_TEST_EVERY chunks — one sync per group,
    counted in `device_range_scan.syncs`.

    Returns (buf_d2 (B, cap) float32, buf_sid, buf_off (B, cap) int32,
    cnt (B,), ovf (B,) — the first unwritten chunk, n_chunks when the
    buffer never overflowed — and stats (B, STATS_WIDTH) int32).
    """
    b_sz = qs.shape[0]
    dev = qs.device
    n_pad = sids.shape[1]
    n_chunks = n_pad // chunk
    buf = (torch.full((b_sz, cap), float("inf"), device=dev),
           torch.full((b_sz, cap), -1, dtype=torch.int32, device=dev),
           torch.full((b_sz, cap), -1, dtype=torch.int32, device=dev))
    cnt = torch.zeros(b_sz, dtype=torch.int32, device=dev)
    ovf = torch.full((b_sz,), n_chunks, dtype=torch.int32, device=dev)
    stats = torch.zeros((b_sz, STATS_WIDTH), dtype=torch.int32, device=dev)
    # `ref.range_active` in three launches: first <= min(eps2, FLT_MAX) is
    # false for the +inf padding, so it implies a finite first
    eps2_cut = eps2.clamp(max=_FLT_MAX)
    i = 0
    while i < n_chunks:
        device_range_scan.syncs += 1
        first = lbs2[:, min(i * chunk, n_pad - 1)]
        if not bool(((first <= eps2_cut) & (ovf == n_chunks)).any()):
            break
        for _ in range(min(STOP_TEST_EVERY, n_chunks - i)):
            _range_chunk_step(
                coll, sids, anchors, n_master, lbs2, qs, dtw_lo, dtw_hi, i,
                eps2, buf, cnt, ovf, stats, g=g, chunk=chunk, znorm=znorm,
                measure=measure, r=r)
            i += 1
    return buf[0], buf[1], buf[2], cnt, ovf, stats


def device_range_scan(collection: Collection, sids, anchors, n_master, lbs2,
                      qs, dtw_lo, dtw_hi, eps2, *, capacity: int, g: int,
                      measure: str, r: int, znorm: bool, chunk_size: int):
    """Batched device-resident eps-range scan (ED or DTW).

    sids/anchors/n_master/lbs2 (B, n_pad) are the range pack
    (`planner.device_range_pack`), qs/dtw_lo/dtw_hi (B, qlen) the
    prepared queries and their DTW envelopes (ED: pass qs in the dtw
    slots), eps2 (B,) float32 the squared radii; the hit buffer holds
    pow2ceil(capacity) rows a query.

    Returns device tensors (buf_d2, buf_sid, buf_off (B, cap), cnt (B,),
    ovf (B,), stats (B, STATS_WIDTH)) and the chunk size the scan used:
    ovf counts in chunks of that many plan rows, so the host continuation
    of an overflowed query resumes at row ovf * chunk (ovf == n_pad //
    chunk: the buffer held everything).  The caller does the readback.
    """
    n_pad = sids.shape[1]
    chunk = min(pow2ceil(chunk_size), n_pad)
    return _device_range_core(
        collection, sids, anchors, n_master, lbs2, qs, dtw_lo, dtw_hi, eps2,
        cap=pow2ceil(capacity), g=g, chunk=chunk, znorm=znorm,
        measure=measure, r=r) + (chunk,)


device_range_scan.syncs = 0


# -- the paged out-of-core scans -------------------------------------------
#
# A paged engine's payload lives in a `PayloadStore` on the host.  The
# scans run host-driven, one plan chunk a step: the chunk's series rows
# (`planner.chunk_pages`) are gathered out of the store's page cache into
# a slab (the six collection planes of just those rows), the chunk's plan
# columns are remapped slab-local, and the resident path's own step
# (`_scan_chunk_step` / `_range_chunk_step`) runs on the slab as a
# one-chunk plan; global ids go back in through `gmap` (k-NN) or `gsids`
# (range).  Answers and counters are bit-equal to the resident scan: a
# page's prefix sums are the collection's rows bit for bit
# (`types.host_prefix_stats`), the step is the same code, and a chunk the
# resident scan's stop test would have skipped is born inactive and adds
# nothing.
#
# A one-worker thread prefetches: while chunk i's step runs, the worker
# reads chunk i + 1's pages and fills the other of two slab slots.  On
# the card each slot is a pinned host slab and a device slab: the copy
# goes `non_blocking` on a side stream and records an event, the compute
# stream waits on that event before the step reads the slab, and the
# worker refills a slot only after the event the compute stream recorded
# after the slot's last step has completed.  On the CPU the same loop
# runs with no streams (the slab is used where it was filled).  The stop
# test runs every PAGED_SYNC_EVERY chunks from the plan's chunk heads
# (host copies) and one readback of the pool's k-th (or of the buffers'
# overflow chunks).  `PAGED` counts the chunk steps, those readbacks and
# the seconds the scan waited on the worker.

PAGED_SYNC_EVERY = 8

PAGED = {"chunks": 0, "syncs": 0, "prefetch_wait_s": 0.0}

_SLAB_PLANES = ("data", "csum", "csum2", "csum_lo", "csum2_lo", "center")


class _SlabRing:
    """Two slab slots for a paged scan over (B, n_pad) host plan arrays:
    each a host side (pinned on the card) and a device side (the host
    side itself on the CPU).  A slot's row planes hold the rows of the
    largest chunk it has been filled with (`_room`), so the slabs cost
    what the scan's chunks touch; they are not part of the page cache's
    budget."""

    def __init__(self, store, plan, chunk: int, device: torch.device):
        self.store = store
        self.plan = plan                  # host (sids, anchors, nm, lbs2)
        self.chunk = chunk
        self.device = device
        b = plan[0].shape[0]
        self.max_rows = min(b * chunk, store.num_series)
        self.pin = device.type == "cuda"
        self.slots = [self._alloc({"cols": ((4, b, chunk), torch.int32),
                                   "lbs2": ((b, chunk), torch.float32)})
                      for _ in range(2)]
        self.rows = [0, 0]
        self.side = torch.cuda.Stream(device) if self.pin else None
        self.copied = [None, None]
        self.done = [None, None]

    def _alloc(self, shapes):
        host = {f: torch.empty(sh, dtype=dt, pin_memory=self.pin)
                for f, (sh, dt) in shapes.items()}
        dev = ({f: torch.empty(sh, dtype=dt, device=self.device)
                for f, (sh, dt) in shapes.items()} if self.pin else host)
        return host, dev

    def _room(self, j: int, r: int) -> None:
        """Give slot j row planes for r rows (pow2ceil(r), at most the
        most a chunk can touch) when it has fewer; the caller has waited
        for the slot's last step."""
        if r <= self.rows[j]:
            return
        rows = min(pow2ceil(r), self.max_rows)
        n = self.store.series_len
        shapes = {f: ((rows, n + 1), torch.float32)
                  for f in ("csum", "csum2", "csum_lo", "csum2_lo")}
        shapes.update(data=((rows, n), torch.float32),
                      center=((rows,), torch.float32),
                      gmap=((rows + 1,), torch.int32))
        host, dev = self._alloc(shapes)
        self.slots[j][0].update(host)
        self.slots[j][1].update(dev)
        self.rows[j] = rows

    def fill(self, j: int, i: int) -> int:
        """Fill slot j with plan chunk i (on the prefetch worker); returns
        the slab's row count."""
        from repro_torch.core.planner import chunk_pages
        sids, anchors, n_master, lbs2 = self.plan
        sl = slice(i * self.chunk, (i + 1) * self.chunk)
        uniq, local, pages = chunk_pages(sids, i, self.chunk,
                                         self.store.page_rows)
        blocks = [self.store.load_page(int(p)) for p in pages]
        if self.done[j] is not None:
            self.done[j].synchronize()    # the slot's last step finished
        r = len(uniq)
        self._room(j, r)
        host, dev = self.slots[j]
        view = {f: host[f][:r].numpy() for f in _SLAB_PLANES}
        page_of = uniq // self.store.page_rows
        for p, blk in zip(pages, blocks):
            pos = np.flatnonzero(page_of == p)
            idx = uniq[pos] - blk.start
            for f in _SLAB_PLANES:
                view[f][pos] = getattr(blk, f)[idx]
        cols = host["cols"].numpy()
        cols[0] = local
        cols[1] = anchors[:, sl]
        cols[2] = n_master[:, sl]
        cols[3] = sids[:, sl]
        host["lbs2"].numpy()[:] = lbs2[:, sl]
        gmap = host["gmap"].numpy()
        gmap[:r] = uniq
        gmap[r] = -1
        if self.side is not None:
            with torch.cuda.stream(self.side):
                for f in _SLAB_PLANES:
                    dev[f][:r].copy_(host[f][:r], non_blocking=True)
                for f in ("cols", "lbs2"):
                    dev[f].copy_(host[f], non_blocking=True)
                dev["gmap"][:r + 1].copy_(host["gmap"][:r + 1],
                                          non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(self.side)
            self.copied[j] = ev
        return r

    def slab(self, j: int, r: int):
        """Slot j's device slab of r rows, ready for the compute stream:
        (collection, (sids, anchors, n_master, lbs2, global sids), gmap)."""
        if self.copied[j] is not None:
            torch.cuda.current_stream(self.device).wait_event(self.copied[j])
        dev = self.slots[j][1]
        coll = Collection(**{f: dev[f][:r] for f in _SLAB_PLANES})
        cols = dev["cols"]
        return (coll, (cols[0], cols[1], cols[2], dev["lbs2"], cols[3]),
                dev["gmap"][:r + 1])

    def release(self, j: int) -> None:
        """Mark the end of slot j's step on the compute stream."""
        if self.side is not None:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self.done[j] = ev

    def close(self) -> None:
        if self.side is not None:
            self.side.synchronize()


def _paged_loop(store, plan, chunk: int, device, step, converged) -> None:
    """Run `step(slab, i)` over the plan's chunks with the prefetch worker
    one chunk ahead, testing `converged(i)` before every
    PAGED_SYNC_EVERY-th chunk."""
    from repro_torch.obs import span            # obs imports executor
    n_chunks = plan[0].shape[1] // chunk
    ring = _SlabRing(store, plan, chunk, device)
    with ThreadPoolExecutor(max_workers=1) as ex:
        fut = ex.submit(ring.fill, 0, 0)
        for i in range(n_chunks):
            j = i % 2
            with span("page.prefetch", chunk=i):
                t0 = time.perf_counter()
                r = fut.result()
                PAGED["prefetch_wait_s"] += time.perf_counter() - t0
            if i + 1 < n_chunks:
                fut = ex.submit(ring.fill, 1 - j, i + 1)
            step(ring.slab(j, r), i)
            ring.release(j)
            PAGED["chunks"] += 1
            if (i + 1 < n_chunks and (i + 1) % PAGED_SYNC_EVERY == 0
                    and converged(i + 1)):
                fut.cancel()
                break
    ring.close()


def _host_plan(sids, anchors, n_master, lbs2):
    """The plan's host copies (the paged scans' page schedule): one
    planned readback."""
    return tuple(read_back(sids, anchors, n_master, lbs2))


def paged_exact_scan(store, sids, anchors, n_master, lbs2, qs, dtw_lo,
                     dtw_hi, seed_d2, seed_sid, seed_off, *, k: int, g: int,
                     measure: str, r: int, znorm: bool, chunk_size: int):
    """The out-of-core twin of `device_exact_scan` over a PayloadStore:
    the same arguments (the plan read back once as the page schedule) and
    the same returned device tensors (d2, sid, off, stats)."""
    plan = _host_plan(sids, anchors, n_master, lbs2)
    n_pad = plan[0].shape[1]
    chunk = min(pow2ceil(chunk_size), n_pad)
    first = plan[3][:, ::chunk]                    # (B, n_chunks) heads
    pool = tuple(t.clone() for t in (seed_d2, seed_sid, seed_off))
    stats = torch.zeros((qs.shape[0], STATS_WIDTH), dtype=torch.int32,
                        device=qs.device)

    def step(slab, i):
        coll, (csid, canc, cnm, clb2, _), gmap = slab
        _scan_chunk_step(coll, csid, canc, cnm, clb2, qs, dtw_lo, dtw_hi, 0,
                         pool, stats, k=k, g=g, chunk=chunk, znorm=znorm,
                         measure=measure, r=r, gmap=gmap)

    def converged(i):
        # LB-sorted heads never decrease and kth only shrinks, so a
        # converged batch stays converged
        PAGED["syncs"] += 1
        kth = pool[0][:, k - 1].cpu().numpy()
        nf = first[:, i]
        return not np.any(np.isfinite(nf) & (nf < kth))

    _paged_loop(store, plan, chunk, qs.device, step, converged)
    return pool[0], pool[1], pool[2], stats


def paged_range_scan(store, sids, anchors, n_master, lbs2, qs, dtw_lo,
                     dtw_hi, eps2, *, capacity: int, g: int, measure: str,
                     r: int, znorm: bool, chunk_size: int):
    """The out-of-core twin of `device_range_scan` over a PayloadStore:
    the same arguments and the same return (buffers, cnt, ovf, stats and
    the chunk size); `ovf` records plan chunks, so the engine's host
    continuation of an overflowed query is unchanged."""
    plan = _host_plan(sids, anchors, n_master, lbs2)
    b_sz = qs.shape[0]
    dev = qs.device
    n_pad = plan[0].shape[1]
    chunk = min(pow2ceil(chunk_size), n_pad)
    n_chunks = n_pad // chunk
    cap = pow2ceil(capacity)
    first = plan[3][:, ::chunk]
    eps2_np = eps2.cpu().numpy()
    buf = (torch.full((b_sz, cap), float("inf"), device=dev),
           torch.full((b_sz, cap), -1, dtype=torch.int32, device=dev),
           torch.full((b_sz, cap), -1, dtype=torch.int32, device=dev))
    cnt = torch.zeros(b_sz, dtype=torch.int32, device=dev)
    ovf = torch.full((b_sz,), n_chunks, dtype=torch.int32, device=dev)
    stats = torch.zeros((b_sz, STATS_WIDTH), dtype=torch.int32, device=dev)

    def step(slab, i):
        coll, (csid, canc, cnm, clb2, cgsid), _ = slab
        _range_chunk_step(coll, csid, canc, cnm, clb2, qs, dtw_lo, dtw_hi, 0,
                          eps2, buf, cnt, ovf, stats, g=g, chunk=chunk,
                          znorm=znorm, measure=measure, r=r, gsids=cgsid,
                          i_code=i, no_ovf=n_chunks)

    def converged(i):
        # the bound half of the resident stop test is known on the host;
        # the overflow half needs one readback
        nf = first[:, i]
        live = np.isfinite(nf) & (nf <= eps2_np)
        if not live.any():
            return True
        PAGED["syncs"] += 1
        return not np.any(live & (ovf.cpu().numpy() == n_chunks))

    _paged_loop(store, plan, chunk, dev, step, converged)
    return buf[0], buf[1], buf[2], cnt, ovf, stats, chunk
