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
cap) hit buffer; and the result/stats containers.  No step has a torch
prologue: the kernels read the plan, the pool or eps2 and the buffer's
overflow flags themselves.

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
from typing import Optional

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
                     collector: Optional[list] = None):
    """Compute true distances for all candidates of the given envelopes
    (indices into the candidate set, host array).

    Updates the pool (k-NN) or appends (sid, off, d2) rows below eps2 to
    `collector` (range query).  Distances are squared throughout.
    """
    p = index.params
    g = p.gamma + 1
    host = host_envelopes(index)
    sids = host["series_id"][env_idx]
    windows, ok, offs = gather_windows(
        index.collection.data, sids, host["anchor"][env_idx],
        host["n_master"][env_idx], pq.qlen, g)
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


def pow2ceil(x: int) -> int:
    b = 1
    while b < x:
        b <<= 1
    return b


def _scan_chunk_step(coll: Collection, sids, anchors, n_master, lbs2, qs,
                     dtw_lo, dtw_hi, i: int, pool, stats, *, k: int, g: int,
                     chunk: int, znorm: bool, measure: str, r: int):
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
    """
    a0 = (coll.data, coll.csum, coll.csum2, coll.csum_lo, coll.csum2_lo,
          coll.center)
    if measure == "ed":
        part = fused_gather_ed_chunk(
            *a0, sids, anchors, n_master, lbs2, qs, pool[0], stats, i=i,
            chunk=chunk, g=g, znorm=znorm)
        pool_merge_partials(pool, part)
        return
    cand_sid, cand_off, db = _dtw_step(
        fused_gather_lb_keogh_chunk(
            *a0, sids, anchors, n_master, lbs2, dtw_lo, dtw_hi, pool[0],
            stats, i=i, chunk=chunk, g=g, znorm=znorm),
        coll, qs, r, znorm)
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
                      g: int, chunk: int, znorm: bool, measure: str, r: int):
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
    """
    a0 = (coll.data, coll.csum, coll.csum2, coll.csum_lo, coll.csum2_lo,
          coll.center)
    if measure == "ed":
        d2 = fused_gather_ed_range(
            *a0, sids, anchors, n_master, lbs2, qs, eps2, ovf, stats, i=i,
            chunk=chunk, g=g, znorm=znorm)
    else:
        d2 = _dtw_step(fused_gather_lb_keogh_range(
            *a0, sids, anchors, n_master, lbs2, dtw_lo, dtw_hi, eps2, ovf,
            stats, i=i, chunk=chunk, g=g, znorm=znorm), coll, qs, r,
            znorm)[-1]
    range_append(d2, sids, anchors, eps2, buf, cnt, ovf, i=i, chunk=chunk,
                 g=g)


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
