"""`UlisseEngine`: the query facade of the PyTorch port.

    engine = UlisseEngine.from_collection(coll, params)      # on CUDA
    res = engine.search(q, QuerySpec(k=5))                   # one query
    ress = engine.search(q_batch, QuerySpec(k=5))            # many queries

The port serves k-NN and eps-range (`QuerySpec(eps=...)`) on a local
index end to end, under ED (the default query) and DTW
(`QuerySpec(measure="dtw", r=...)`):

  * `scan_backend="device"`, exact (paper Alg. 5 including its line-1
    approximate pass), batched per query length.  Per batch: query prep
    (DTW: the query's warping envelope) -> block lower bounds
    (`mindist_paa`) -> leaf pack -> approximate scan -> envelope lower
    bounds (`mindist_sym`) -> LB-sorted pack -> seeded exact scan (ED:
    `fused_gather_ed`; DTW: `fused_gather_lb_keogh_chunk` then
    `dtw_survivors` on the survivors it lists) -> one result readback -> for ED, a float64 rescore
    of the reported rows on the host (DTW reports the device's DP values,
    as the JAX package does);
  * `mode="approx"` on the device backend: the approximate pass alone
    (paper Alg. 4), one readback per batch;
  * eps-range (`eps` set; tested before `mode`, so an approx spec with
    eps is a range query, as in the reference) on the device backend
    (paper Alg. 5 with bsf := eps), batched per query length: envelope
    lower bounds (`mindist_sym`) -> the sortless range pack -> the range
    scan into a (B, pow2ceil(range_capacity)) hit buffer (ED:
    `fused_gather_ed_range`; DTW: `fused_gather_lb_keogh_range` then
    `dtw_survivors`; both then `range_append`) -> one readback -> a
    query whose hits overflowed its buffer finishes the chunks from the
    overflow on the host (`verify_envelopes`, a sync a chunk) -> ED hits
    rescored in float64 and sorted by distance;
  * `scan_backend="host"`, exact, approx or range: the reference's
    host-driven loop, one query at a time — block and envelope bounds on
    the device, orders and the k-best pool (or the hit list) on the host,
    each chunk verified by `batch_ed` (ED) or `lb_keogh` then the
    `dtw_band` entry (DTW).  It reports float32 dot-identity / DP
    distances unpolished for k-NN, as the reference's host backend does
    (range rescores ED hits in float64, as every range path does).

Paging, ingestion, the distributed backend raise NotImplementedError
naming the ROADMAP item that ports them.  Engines run on CUDA unless
built with device="cpu".
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Union

import numpy as np
import torch
from torch.profiler import record_function as span

from repro_torch.core import executor, planner
from repro_torch.core.executor import SearchResult, SearchStats, TopK
from repro_torch.core.index import UlisseIndex, build_index
from repro_torch.core.types import (Collection, DeviceLike, EnvelopeParams,
                                    resolve_device)
from repro_torch.kernels.fused_verify import card_takes


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP Queue 1 "
        f"item {item})")


@dataclasses.dataclass(frozen=True)
class QuerySpec:
    """Everything about a query except its values (the JAX package's
    fields; see `repro.core.engine.QuerySpec` for each one's meaning).
    The port serves every spec on a local index."""

    measure: str = "ed"
    r: int = 0
    k: int = 1
    eps: Optional[float] = None
    mode: str = "exact"
    approx_first: bool = True
    scan_backend: str = "device"
    chunk_size: int = 512
    verify_top: int = 128
    sync_every: int = 8
    max_leaves: int = 8
    range_capacity: int = 2048
    use_paa_bounds: bool = False

    def __post_init__(self):
        if self.measure not in ("ed", "dtw"):
            raise ValueError(f"unknown measure {self.measure!r}")
        if self.mode not in ("exact", "approx"):
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.scan_backend not in ("device", "host"):
            raise ValueError(
                f"unknown scan_backend {self.scan_backend!r}")
        if self.measure == "dtw" and self.r <= 0:
            raise ValueError("DTW search needs a warping window r > 0")
        if self.k < 1:
            raise ValueError("k must be >= 1")
        if self.eps is not None and self.eps < 0:
            raise ValueError("eps must be >= 0")
        if self.chunk_size < 1:
            raise ValueError("chunk_size must be >= 1")
        if self.verify_top < 1:
            raise ValueError("verify_top must be >= 1")
        if self.sync_every < 1:
            raise ValueError("sync_every must be >= 1")
        if self.range_capacity < 1:
            raise ValueError("range_capacity must be >= 1")

    @property
    def is_range(self) -> bool:
        return self.eps is not None


class UlisseEngine:
    """Query facade over one local ULISSE index on one device."""

    def __init__(self, index: UlisseIndex, max_batch: int = 8):
        self._index = index
        self.params = index.params
        self.max_batch = max_batch

    # ------------------------------------------------------------------
    # constructors
    # ------------------------------------------------------------------

    @classmethod
    def from_index(cls, index: UlisseIndex, max_batch: int = 8,
                   memory_budget_bytes: Optional[int] = None,
                   device: DeviceLike = None) -> "UlisseEngine":
        """Wrap an already-built local index, moved to `device` (default
        CUDA; raises when CUDA is unavailable and device is not "cpu")."""
        if memory_budget_bytes is not None:
            raise _not_ported("memory_budget_bytes (the paged tier)", "2")
        dev = resolve_device(device)
        if index.device != dev:
            index = index.to(dev)
        return cls(index=index, max_batch=max_batch)

    @classmethod
    def from_collection(cls, collection: Collection, params: EnvelopeParams,
                        breakpoints=None, block_size: int = 64,
                        num_levels: int = 2, max_batch: int = 8,
                        memory_budget_bytes: Optional[int] = None,
                        device: DeviceLike = None) -> "UlisseEngine":
        """Build the index on `device` (default CUDA) and the engine."""
        if memory_budget_bytes is not None:
            raise _not_ported("memory_budget_bytes (the paged tier)", "2")
        dev = resolve_device(device)
        if collection.device != dev:
            collection = collection.to(dev)
        return cls(index=build_index(collection, params, breakpoints,
                                     block_size=block_size,
                                     num_levels=num_levels),
                   max_batch=max_batch)

    @classmethod
    def distributed(cls, *args, **kwargs):
        raise _not_ported("the distributed backend", "4")

    def append(self, series) -> None:
        raise _not_ported("append", "2")

    def compact(self) -> None:
        raise _not_ported("compact", "2")

    @property
    def index(self) -> UlisseIndex:
        return self._index

    @property
    def device(self) -> torch.device:
        return self._index.device

    # ------------------------------------------------------------------
    # the one entry point
    # ------------------------------------------------------------------

    def search(self, queries, spec: QuerySpec = QuerySpec()
               ) -> Union[SearchResult, List[SearchResult]]:
        """Answer one query (1-D input -> SearchResult) or a batch (2-D
        array or sequence of 1-D arrays -> list of SearchResult)."""
        single, qs = self._normalize_queries(queries)
        self._check_card_gamma(qs, spec)
        if spec.scan_backend == "host":
            results = [self._search_local(q, spec) for q in qs]
        elif spec.is_range:
            results = self._local_range_device(qs, spec)
        elif spec.mode == "exact":
            results = self._local_exact_device(qs, spec)
        else:
            results = self._local_approx_device(qs, spec)
        return results[0] if single else results

    def _check_card_gamma(self, qs, spec: QuerySpec) -> None:
        """Refuse, before any launch, envelopes of more masters than the
        device scan's chunk entries (k-NN and range) take on the card (g =
        gamma + 1 past 18,688 for ED, 13,760 for DTW: their shared memory
        grows with g; ROADMAP Queue 3 P5).  Every query length runs; the
        host backend and the CPU have no such limit."""
        if self.device.type != "cuda" or spec.scan_backend != "device":
            return
        g = self.params.gamma + 1
        for qlen in sorted({len(q) for q in qs}):
            if not card_takes(spec.measure, qlen, g):
                raise ValueError(
                    f"gamma={self.params.gamma}: the device scan's "
                    f"{spec.measure} chunk entry takes no {g} masters an "
                    f"envelope on the card (its shared memory grows with "
                    f"g); use scan_backend='host'")

    def _normalize_queries(self, queries):
        if isinstance(queries, (list, tuple)):
            qs = [np.asarray(q, np.float32) for q in queries]
        else:
            arr = np.asarray(queries, np.float32)
            if arr.ndim == 1:
                return True, [arr]
            qs = [arr[i] for i in range(arr.shape[0])]
        return False, qs

    # -- the host backend (scan_backend="host") ---------------------------

    def _search_local(self, q, spec: QuerySpec) -> SearchResult:
        """The host-driven reference paths, one query."""
        with span("query.host"):
            if spec.is_range:
                return self._local_range(q, spec)
            if spec.mode == "approx":
                pool, stats = self._local_approx_impl(q, spec)
                return pool.result(stats)
            return self._local_exact(q, spec)

    def _prepare(self, q, spec: QuerySpec) -> planner.PreparedQuery:
        return planner.prepare_query(q, self.params, spec.measure, spec.r,
                                     device=self.device)

    def _local_approx_impl(self, q, spec: QuerySpec,
                           pq: Optional[planner.PreparedQuery] = None):
        """Best-first descent over the block hierarchy (paper Alg. 4).

        Visits fine blocks ("leaves") in lower-bound order; stops when a
        leaf's lower bound reaches the k-th bsf (the answer is then
        exact), capped at max_leaves.  Unlike the paper (Alg. 4 line 22)
        it keeps visiting after a leaf that does not improve, as the
        reference does.

        Returns (pool, stats): the squared-distance pool (the exact scan
        seeds from it) and the counters so far.
        """
        index = self._index
        if pq is None:
            pq = self._prepare(q, spec)
        stats = SearchStats(
            envelopes_total=int(index.search_envelopes().size))
        pool = TopK(spec.k)
        order, blk_lb = planner.plan_leaf_order(index, pq)
        stats.lb_computations += index.levels[-1].size
        block_size = index.envelopes.size // index.levels[-1].size
        valid_all = executor.host_envelopes(index)["valid"]

        n_leaves = min(spec.max_leaves, len(order))
        exhausted = False
        for leaf_rank in range(n_leaves):
            b = int(order[leaf_rank])
            if not np.isfinite(blk_lb[b]):
                # blocks are LB-sorted: everything left is invalid, so
                # every finite-LB leaf has been verified
                exhausted = True
                break
            if blk_lb[b] ** 2 >= pool.kth:
                stats.exact_from_approx = True
                break
            env_idx = np.arange(b * block_size, (b + 1) * block_size)
            env_idx = env_idx[valid_all[env_idx]]
            executor.verify_envelopes(index, pq, env_idx, pool, stats)
            stats.leaves_visited += 1
        else:
            exhausted = (n_leaves == len(order)
                         or not np.isfinite(blk_lb[int(order[n_leaves])]))
        if exhausted:
            # no finite-LB leaf is left unverified: the answer is exact
            stats.exact_from_approx = True
        return pool, stats

    def _local_exact(self, q, spec: QuerySpec) -> SearchResult:
        """Exact k-NN: the approximate pass for a bsf, then the LB-sorted
        chunked scan over the flat envelope list with bsf pruning (paper
        Alg. 5), host-driven."""
        index = self._index
        pq = self._prepare(q, spec)
        if spec.approx_first:
            # the approx pass's squared pool goes straight on: a
            # sqrt -> square round trip would perturb exact-tie pruning
            pool, stats = self._local_approx_impl(q, spec, pq)
            if stats.exact_from_approx:
                return pool.result(stats)
        else:
            stats = SearchStats(
                envelopes_total=int(index.search_envelopes().size))
            pool = TopK(spec.k)

        order, lbs_sorted = planner.plan_scan_order(index, pq,
                                                    spec.use_paa_bounds)
        n = index.search_envelopes().size
        stats.lb_computations += n
        stats.chunks_planned = -(-n // spec.chunk_size)

        pos = 0
        while pos < n:
            if not np.isfinite(lbs_sorted[pos]):
                break
            if lbs_sorted[pos] ** 2 >= pool.kth:
                break  # every remaining envelope is pruned
            end = min(pos + spec.chunk_size, n)
            sel = order[pos:end]
            fin = np.isfinite(lbs_sorted[pos:end])
            keep = fin & ((lbs_sorted[pos:end] ** 2) < pool.kth)
            if keep.any():
                executor.verify_envelopes(index, pq, sel[keep], pool, stats)
            # envelopes cut by the bsf LB test inside a visited chunk
            stats.envelopes_pruned += int((fin & ~keep).sum())
            stats.chunks_visited += 1
            pos = end
        return pool.result(stats)

    def _local_range(self, q, spec: QuerySpec) -> SearchResult:
        """All subsequences within eps of Q (paper Alg. 5 with bsf :=
        eps), host-driven: every envelope with lb2 <= eps2 (inclusive) is
        verified, in candidate-set order, spec.chunk_size at a time."""
        index = self._index
        pq = self._prepare(q, spec)
        env = index.search_envelopes()
        stats = SearchStats(envelopes_total=int(env.size))
        eps2 = float(spec.eps) ** 2
        lbs = executor.to_host(planner.env_lower_bounds(
            pq.paa_lo, pq.paa_hi, env, index.breakpoints,
            self.params.seg_len, pq.nseg, spec.use_paa_bounds)
        ).astype(np.float64)
        stats.lb_computations += env.size
        cand = np.nonzero((lbs ** 2) <= eps2)[0]
        stats.chunks_planned = -(-len(cand) // spec.chunk_size)
        rows: list = []
        self._range_host_tail(pq, cand, lbs[cand] ** 2, 0, spec.chunk_size,
                              eps2, rows, stats)
        return self._range_result_rows(rows, stats, q, spec)

    # -- the device pipeline ---------------------------------------------

    def _group_by_len(self, qs):
        by_len = {}
        for i, q in enumerate(qs):
            by_len.setdefault(len(q), []).append(i)
        return sorted(by_len.items())

    def _device_batches(self, idxs):
        """max_batch-sized sub-batches, padded to a power of two."""
        for start in range(0, len(idxs), self.max_batch):
            sub = idxs[start:start + self.max_batch]
            yield sub, min(planner.length_bucket(len(sub), self.max_batch),
                           self.max_batch)

    def _padded_batches(self, qs, idxs):
        """Sub-batches of one length group, the query list padded to the
        pow2 batch bucket by repeating the last query (scan rows are
        independent, so the padding never changes another row)."""
        for sub, b in self._device_batches(idxs):
            queries = [qs[i] for i in sub]
            queries += [queries[-1]] * (b - len(sub))
            yield sub, queries, b

    def _stack_prepared(self, queries, spec: QuerySpec):
        """Shared per-length-group query prep on the device, no sync."""
        q = torch.from_numpy(np.stack(queries)).to(self.device)
        qn, dlo, dhi, qb, qh = planner.prepare_query_batch(
            q, self.params.seg_len, self.params.znorm, spec.measure,
            spec.r)
        nseg = self.params.query_segments(q.shape[1])
        return nseg, qn, dlo, dhi, qb, qh

    def _device_approx_stage(self, qstack, dlo, dhi, qb, qh, nseg: int,
                             k: int, spec: QuerySpec):
        """Batched device approximate pass (paper Alg. 4).

        Best-first leaf visits run as the scan core over the leaf order
        (planner.device_leaf_pack): each chunk is one leaf carrying its
        block's squared LB, so the core's per-chunk stop reproduces the
        descent's "next leaf cannot improve" break.  Seeds the (B, k) pool
        on the device and derives the exactness certificate there too.

        Returns (pool (d2, sid, off), stats, cert, leaf_v, comb_idx,
        visited_chunks, chunk, nblk, planned) — `planned` is the leaf
        pack's chunk count, the approximate pass's `chunks_planned`.
        """
        index, p = self._index, self.params
        env = index.search_envelopes()
        n_main = index.envelopes.size
        fine = index.levels[-1]
        nblk = fine.size
        block_size = n_main // nblk
        chunk = executor.pow2ceil(block_size)
        n_leaves = min(spec.max_leaves, nblk)
        b = qstack.shape[0]
        dev = qstack.device

        blk_lb = planner.block_lower_bounds_batch(
            qb, qh, fine.paa_lo, fine.paa_hi, fine.valid, p.seg_len, nseg)
        (asids, aanc, anm, albs2, comb_idx,
         blk_sorted) = planner.device_leaf_pack(
            env.series_id, env.anchor, env.n_master, env.valid, blk_lb,
            n_main=n_main, block_size=block_size, chunk=chunk,
            n_leaves=n_leaves)
        neg = torch.full((b, k), -1, dtype=torch.int32, device=dev)
        ad2, asid, aoff, ast = executor.device_exact_scan(
            index.collection, asids, aanc, anm, albs2, qstack, dlo, dhi,
            torch.full((b, k), float("inf"), device=dev), neg, neg,
            k=k, g=p.gamma + 1, measure=spec.measure, r=spec.r,
            znorm=p.znorm, chunk_size=chunk)

        visited = ast[:, 0]
        leaf_v = visited.clamp(0, n_leaves)
        # certificate: the first unvisited leaf cannot improve the pool,
        # or no finite-LB leaf is left
        kth2 = ad2[:, k - 1]
        next_lb = blk_sorted[torch.arange(b, device=dev),
                             leaf_v.clamp(max=nblk - 1).long()]
        cert = ((leaf_v >= nblk) | ~torch.isfinite(next_lb)
                | (next_lb ** 2 >= kth2))
        return ((ad2, asid, aoff), ast, cert, leaf_v, comb_idx, visited,
                chunk, nblk, asids.shape[1] // chunk)

    def _local_host_data(self) -> np.ndarray:
        """Host copy of the collection's raw series (cached), for the f64
        ED polish off the hot path."""
        cached = getattr(self, "_local_host_cache", None)
        data = self._index.collection.data
        if cached is None or cached[0] is not data:
            cached = (data, data.cpu().numpy())
            self._local_host_cache = cached
        return cached[1]

    def _ed_rescore(self, q, sid, off) -> np.ndarray:
        """Direct float64 ED of the reported (sid, off) windows — the
        polish every ED result path shares (the kernel's dot identity
        cancels near d = 0)."""
        data = self._local_host_data()
        w = data[sid[:, None], off[:, None] + np.arange(len(q))] \
            .astype(np.float64)
        qn = np.asarray(q, np.float64)
        if self.params.znorm:
            qn = (qn - qn.mean()) / max(qn.std(), 1e-8)
            mu = w.mean(1, keepdims=True)
            sd = np.maximum(w.std(1, keepdims=True), 1e-8)
            w -= mu
            w /= sd
        w -= qn
        np.square(w, out=w)
        return w.sum(1)

    def _knn_result_rows(self, q, spec: QuerySpec, d2, sid, off,
                         stats) -> SearchResult:
        # drop unfilled pool rows (sid -1): with k > candidates the pool
        # keeps +inf filler, which must not surface as phantom neighbors
        filled = sid >= 0
        d2 = d2[filled].astype(np.float64)
        sid = sid[filled].astype(np.int64)
        off = off[filled].astype(np.int64)
        if spec.measure == "ed" and len(d2):
            d2 = self._ed_rescore(q, sid, off)
            order = np.argsort(d2, kind="stable")
            d2, sid, off = d2[order], sid[order], off[order]
        return SearchResult(dists=np.sqrt(np.maximum(d2, 0.0)),
                            series=sid, offsets=off, stats=stats)

    def _range_result_rows(self, rows, stats, q,
                           spec: QuerySpec) -> SearchResult:
        """A range answer from its collected (sid, off, d2) rows: ED
        distances rescored in float64 (membership was decided on each
        path's own values; the reported distances are the shared polish),
        DTW the device's DP values; sorted stably by distance."""
        if not rows:
            return SearchResult(dists=np.zeros((0,)),
                                series=np.zeros((0,), np.int64),
                                offsets=np.zeros((0,), np.int64),
                                stats=stats)
        out = np.concatenate(rows, axis=0)
        sid = out[:, 0].astype(np.int64)
        off = out[:, 1].astype(np.int64)
        d2 = out[:, 2]
        if spec.measure == "ed":
            d2 = self._ed_rescore(q, sid, off)
        order = np.argsort(d2, kind="stable")
        return SearchResult(dists=np.sqrt(np.maximum(d2[order], 0.0)),
                            series=sid[order], offsets=off[order],
                            stats=stats)

    def _local_range_device(self, qs, spec: QuerySpec):
        """Batched device eps-range (paper Alg. 5 with bsf := eps): one
        result readback per same-length batch where no hit buffer
        overflows.  A query that overflows its buffer (B, pow2ceil(
        range_capacity)) reads its packed order back and finishes chunks
        [ovf, n_chunks) through the host path: the buffer holds exactly
        the hits of the chunks before ovf, so the union is exact with no
        dedup."""
        results: List[Optional[SearchResult]] = [None] * len(qs)
        for qlen, idxs in self._group_by_len(qs):
            for sub, queries, b in self._padded_batches(qs, idxs):
                self._range_device_sub(qs, sub, queries, b, spec, results)
        return results

    def _range_device_sub(self, qs, sub, queries, b: int, spec: QuerySpec,
                          results) -> None:
        """One padded same-length sub-batch of the device range scan."""
        index, p = self._index, self.params
        env = index.search_envelopes()
        n_comb = env.size
        eps2 = float(spec.eps) ** 2
        with span("query.range_device"):
            with span("prepare"):
                nseg, qstack, dlo, dhi, qb, qh = self._stack_prepared(
                    queries, spec)
            eps2_t = torch.full((b,), eps2, dtype=torch.float32,
                                device=self.device)
            with span("pack"):
                lbs = planner.env_lower_bounds_batch(
                    qb, qh, env, index.breakpoints, p.seg_len, nseg,
                    spec.use_paa_bounds)
                n_pad = executor.pow2ceil(n_comb)
                ssids, sanc, snm, slbs2, order = planner.device_range_pack(
                    env.series_id, env.anchor, env.n_master, lbs, eps2_t,
                    n_pad=n_pad)
            with span("device_scan"):
                (bd2, bsid, boff, cnt, ovf, st,
                 chunk) = executor.device_range_scan(
                    index.collection, ssids, sanc, snm, slbs2, qstack, dlo,
                    dhi, eps2_t, capacity=spec.range_capacity,
                    g=p.gamma + 1, measure=spec.measure, r=spec.r,
                    znorm=p.znorm, chunk_size=spec.chunk_size)
                # THE one result readback of the batch (overflow excepted)
                bd2, bsid, boff, cnt, ovf, st = (
                    t.cpu().numpy() for t in (bd2, bsid, boff, cnt, ovf, st))
            n_chunks = n_pad // chunk
            order_h = slbs2_h = None
            for row, i in enumerate(sub):
                stats = SearchStats(
                    envelopes_total=n_comb, lb_computations=n_comb,
                    chunks_visited=int(st[row, 0]), chunks_planned=n_chunks,
                    envelopes_checked=int(st[row, 1]),
                    true_dist_computations=int(st[row, 2]),
                    dtw_lb_keogh=int(st[row, 3]), dtw_full=int(st[row, 4]),
                    envelopes_pruned=int(st[row, 5]))
                c = int(cnt[row])
                rows: list = []
                if c:
                    rows.append(np.stack(
                        [bsid[row, :c].astype(np.float64),
                         boff[row, :c].astype(np.float64),
                         bd2[row, :c].astype(np.float64)], axis=1))
                o = int(ovf[row])
                if o < n_chunks:     # the buffer overflowed: the host tail
                    stats.range_overflows += 1
                    with span("host_continuation"):
                        if order_h is None:     # read back on overflow only
                            order_h = executor.to_host(order)
                            slbs2_h = executor.to_host(slbs2).astype(
                                np.float64)
                        self._range_host_tail(
                            self._prepare(qs[i], spec), order_h[row],
                            slbs2_h[row], o * chunk, chunk, eps2, rows,
                            stats)
                with span("merge"):
                    results[i] = self._range_result_rows(rows, stats, qs[i],
                                                         spec)

    def _range_host_tail(self, pq: planner.PreparedQuery, order, lbs2,
                         pos: int, chunk: int, eps2: float, rows: list,
                         stats: SearchStats) -> None:
        """Verify one query's candidates `order` (with their `lbs2`) from
        row `pos` on through the host path, a chunk at a time, into the
        collected rows: every row is a candidate (lb2 <= eps2) and +inf
        marks a padding tail.  The host backend runs all of its
        candidates; the device scan replays a packed plan from the chunk
        where its hit buffer overflowed."""
        sink = TopK(1)   # unused: the collector takes the hits
        while pos < len(order):
            keep = np.isfinite(lbs2[pos:pos + chunk])
            if not keep[0]:
                break
            executor.verify_envelopes(
                self._index, pq, order[pos:pos + chunk][keep], sink, stats,
                eps2=eps2, collector=rows)
            stats.chunks_visited += 1
            pos += chunk

    def _local_exact_device(self, qs, spec: QuerySpec):
        """Exact k-NN on the device (paper Alg. 5 incl. its line-1
        approximate pass), one result readback per same-length batch.

        Per batch: approximate pass -> its verified rows are
        scatter-excluded from the LB order (planner.device_scan_pack) ->
        the seeded exact scan.  A query whose certificate already proves
        exactness self-skips the scan: its first chunk is born inactive.
        """
        index = self._index
        k, g = spec.k, self.params.gamma + 1
        dev = self.device
        results: List[Optional[SearchResult]] = [None] * len(qs)
        env = index.search_envelopes()
        n_comb = env.size
        for qlen, idxs in self._group_by_len(qs):
            for sub, queries, b in self._padded_batches(qs, idxs):
                with span("query.exact_device"):
                    with span("prepare"):
                        (nseg, qstack, dlo, dhi, qb,
                         qh) = self._stack_prepared(queries, spec)
                    if spec.approx_first:
                        with span("approx_pass"):
                            (seed, ast, cert, leaf_v, comb_idx, visited,
                             achunk, nblk, _) = self._device_approx_stage(
                                qstack, dlo, dhi, qb, qh, nseg, k, spec)
                    else:
                        neg = torch.full((b, k), -1, dtype=torch.int32,
                                         device=dev)
                        seed = (torch.full((b, k), float("inf"),
                                           device=dev), neg, neg)
                        ast = torch.zeros((b, executor.STATS_WIDTH),
                                          dtype=torch.int32, device=dev)
                        cert = torch.zeros((b,), dtype=torch.bool,
                                           device=dev)
                        leaf_v = torch.zeros((b,), dtype=torch.int32,
                                             device=dev)
                        comb_idx = torch.full((b, 1), n_comb,
                                              dtype=torch.int32, device=dev)
                        visited = torch.zeros((b,), dtype=torch.int32,
                                              device=dev)
                        achunk, nblk = 1, 0
                    with span("pack"):
                        lbs = planner.env_lower_bounds_batch(
                            qb, qh, env, index.breakpoints,
                            self.params.seg_len, nseg, spec.use_paa_bounds)
                        n_pad = executor.pow2ceil(n_comb)
                        (ssids, sanc, snm, slbs2,
                         _) = planner.device_scan_pack(
                            env.series_id, env.anchor, env.n_master, lbs,
                            comb_idx, visited, chunk=achunk, n_pad=n_pad)
                    with span("device_scan"):
                        d2, sid, off, st = executor.device_exact_scan(
                            index.collection, ssids, sanc, snm, slbs2,
                            qstack, dlo, dhi, *seed, k=k, g=g,
                            measure=spec.measure, r=spec.r,
                            znorm=self.params.znorm,
                            chunk_size=spec.chunk_size)
                        # THE one result readback of the batch
                        (d2, sid, off, st, ast, cert, leaf_v) = (
                            t.cpu().numpy() for t in
                            (d2, sid, off, st, ast, cert, leaf_v))
                    planned = n_pad // min(
                        executor.pow2ceil(spec.chunk_size), n_pad)
                    with span("merge"):
                        for row, i in enumerate(sub):
                            stats = SearchStats(
                                envelopes_total=n_comb,
                                lb_computations=n_comb
                                + (nblk if spec.approx_first else 0),
                                leaves_visited=int(leaf_v[row]),
                                exact_from_approx=bool(cert[row]),
                                chunks_visited=int(st[row, 0]),
                                chunks_planned=planned,
                                envelopes_checked=(int(ast[row, 1])
                                                   + int(st[row, 1])),
                                true_dist_computations=(
                                    int(ast[row, 2]) + int(st[row, 2])),
                                dtw_lb_keogh=(int(ast[row, 3])
                                              + int(st[row, 3])),
                                dtw_full=(int(ast[row, 4])
                                          + int(st[row, 4])),
                                envelopes_pruned=(int(ast[row, 5])
                                                  + int(st[row, 5])))
                            results[i] = self._knn_result_rows(
                                qs[i], spec, d2[row], sid[row], off[row],
                                stats)
        return results

    def _local_approx_device(self, qs, spec: QuerySpec):
        """Batched device approximate k-NN (paper Alg. 4): the approximate
        stage alone, one result readback per same-length batch."""
        k = spec.k
        results: List[Optional[SearchResult]] = [None] * len(qs)
        n_comb = self._index.search_envelopes().size
        for qlen, idxs in self._group_by_len(qs):
            for sub, queries, b in self._padded_batches(qs, idxs):
                with span("query.approx_device"):
                    with span("prepare"):
                        (nseg, qstack, dlo, dhi, qb,
                         qh) = self._stack_prepared(queries, spec)
                    with span("device_scan"):
                        ((ad2, asid, aoff), ast, cert, leaf_v, _, _, _,
                         nblk, aplan) = self._device_approx_stage(
                            qstack, dlo, dhi, qb, qh, nseg, k, spec)
                        # the one result readback of the batch
                        (ad2, asid, aoff, ast, cert, leaf_v) = (
                            t.cpu().numpy() for t in
                            (ad2, asid, aoff, ast, cert, leaf_v))
                    with span("merge"):
                        for row, i in enumerate(sub):
                            stats = SearchStats(
                                envelopes_total=n_comb,
                                lb_computations=nblk,
                                leaves_visited=int(leaf_v[row]),
                                exact_from_approx=bool(cert[row]),
                                envelopes_checked=int(ast[row, 1]),
                                true_dist_computations=int(ast[row, 2]),
                                dtw_lb_keogh=int(ast[row, 3]),
                                dtw_full=int(ast[row, 4]),
                                envelopes_pruned=int(ast[row, 5]),
                                chunks_visited=int(ast[row, 0]),
                                chunks_planned=aplan)
                            results[i] = self._knn_result_rows(
                                qs[i], spec, ad2[row], asid[row],
                                aoff[row], stats)
        return results
