"""`UlisseEngine`: the query facade of the PyTorch port.

    engine = UlisseEngine.from_collection(coll, params)      # on CUDA
    engine = UlisseEngine.distributed(group, params, data)   # every rank
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

Storage and ingestion (`open`, `save`, `from_writer`, `append`,
`compact`; `repro_torch.storage`) keep the JAX package's on-disk format.
Appended series are searched at once through an unsorted delta envelope
set: every path searches main ++ delta (`UlisseIndex.search_envelopes`;
the approximate pass sweeps the delta before the leaves).  An engine
whose lazily opened payload is larger than `memory_budget_bytes` (or the
`ULISSE_MEMORY_BUDGET_BYTES` environment variable) runs the device
backend's scans out of core (`executor.paged_exact_scan`,
`paged_range_scan`): the plan is read back once as the page schedule and
each chunk's rows are gathered from the store's page cache into a slab
on the device, bit-equal to the resident scan.

The distributed backend (`distributed`, `repro_torch.distributed`) runs
over a `torch.distributed` process group, one shard a rank: every rank
builds the engine from the same data and calls `search` with the same
queries, and every rank returns the same answers.  The device backend
runs the sharded k-NN scan (exact, or mode="approx" at max_leaves chunks
a shard; no approximate pass), pruning every chunk with min(pool k-th,
the mesh-wide k-th of the last round) through the chunk entries' `gkth`
input, and the sharded eps-range scan (an overflowed shard finishes on
its owner's host); `scan_backend="host"` runs the reference's unpruned
per-shard verify with its exactness escalation (exact ED k-NN only, and
only with no delta and no cold sections, as in the reference).  Every
rank also calls the writes with the same arguments: `append` row-shards
a part over the ranks into per-rank delta buffers (their global ids in a
gmap; the k-NN scan packs them first with pinned chunk heads), `compact`
folds them in global id order and re-shards, `save` writes each rank's
shard in the reference's distributed format and `open(path, mesh=group)`
reopens it in O(index) on a group of the saved size (re-sharding
otherwise).  Engines run on CUDA unless built with device="cpu".

The engine's spans (`query.*`, `prepare`, `approx_pass`, `pack`,
`device_scan`, `merge`, `host_continuation`) are `repro_torch.obs` spans
with the reference's names and attributes: free until the tracer is
enabled.  `warmup` pays a traffic mix's first-use costs ahead of serving
(`repro_torch.serve`).
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core import executor, planner
from repro_torch.core.executor import SearchResult, SearchStats, TopK
from repro_torch.core.index import UlisseIndex, build_index
from repro_torch.core.types import (Collection, DeviceLike, EnvelopeParams,
                                    resolve_device)
from repro_torch.kernels import _build
from repro_torch.obs import span
from repro_torch.storage import delta as _delta
from repro_torch.storage import store as _store


@dataclasses.dataclass(frozen=True)
class QuerySpec:
    """Everything about a query except its values (the JAX package's
    fields; see `repro.core.engine.QuerySpec` for each one's meaning).
    The port serves every spec on a local index and on a distributed
    one (`UlisseEngine.distributed`)."""

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
    """Query facade over one ULISSE index: a local one on one device, or
    (`distributed`) this rank's shard of one over a process group."""

    def __init__(self, index: Optional[UlisseIndex] = None,
                 max_batch: int = 8,
                 memory_budget_bytes: Optional[int] = None, shard=None):
        self._index = index
        self._shard = shard       # a `distributed.ulisse.Shard`, or None
        self.params = index.params if index is not None else shard.params
        self.max_batch = max_batch
        if memory_budget_bytes is None:
            env = os.environ.get("ULISSE_MEMORY_BUDGET_BYTES", "")
            memory_budget_bytes = int(env) if env else None
        # host-memory budget for the raw payload: when a lazily opened
        # collection's payload exceeds it, the device backend's scans run
        # out of core with the store's page cache capped to this many
        # bytes; None (or a budget the payload fits) keeps the payload
        # whole on the device.  Answers are bit-equal either way.
        self.memory_budget_bytes = memory_budget_bytes

    # ------------------------------------------------------------------
    # constructors
    # ------------------------------------------------------------------

    @classmethod
    def from_index(cls, index: UlisseIndex, max_batch: int = 8,
                   memory_budget_bytes: Optional[int] = None,
                   device: DeviceLike = None) -> "UlisseEngine":
        """Wrap an already-built local index, moved to `device` (default
        CUDA; raises when CUDA is unavailable and device is not "cpu").  A
        lazily opened collection stays lazy."""
        dev = resolve_device(device)
        if index.device != dev:
            index = index.to(dev)
        return cls(index=index, max_batch=max_batch,
                   memory_budget_bytes=memory_budget_bytes)

    @classmethod
    def from_collection(cls, collection: Collection, params: EnvelopeParams,
                        breakpoints=None, block_size: int = 64,
                        num_levels: int = 2, max_batch: int = 8,
                        memory_budget_bytes: Optional[int] = None,
                        device: DeviceLike = None) -> "UlisseEngine":
        """Build the index on `device` (default CUDA) and the engine."""
        dev = resolve_device(device)
        if collection.device != dev:
            collection = collection.to(dev)
        return cls(index=build_index(collection, params, breakpoints,
                                     block_size=block_size,
                                     num_levels=num_levels),
                   max_batch=max_batch,
                   memory_budget_bytes=memory_budget_bytes)

    @classmethod
    def distributed(cls, mesh, params: EnvelopeParams, data,
                    breakpoints=None, max_batch: int = 8,
                    device: DeviceLike = None,
                    axes=("data",)) -> "UlisseEngine":
        """This rank's engine over a `torch.distributed` process group
        (`mesh`; None: the default group), one shard a rank, or over a
        rank grid: a `torch.distributed.device_mesh.DeviceMesh` with named
        dims whose rows shard over the dims `axes` (the shard index
        row-major over them); ranks that differ only in the other dims are
        replicas, holding and searching the same shard
        (`distributed.ulisse.grid_groups`).

        Every rank calls it with the same full (S, n) `data` and then
        `search` with the same queries and spec, and every rank returns
        the same results.  A rank keeps only its own rows [rank * S / P,
        (rank + 1) * S / P) on `device` (default cuda:{current device};
        raises without CUDA unless "cpu"), with their prefix sums and
        envelope set; the breakpoints come from the whole collection.  A
        non-divisible S and series shorter than lmax are refused first.
        The collectives move tensors as the group's backend takes them
        (NCCL: one GPU a rank; gloo: host copies)."""
        from repro_torch.distributed.ulisse import build_shard, grid_groups
        grid = grid_groups(mesh, axes)
        return cls(max_batch=max_batch, shard=build_shard(
            grid.group, params, data, breakpoints=breakpoints, device=device,
            grid=grid))

    # -- persistence (repro_torch.storage) ---------------------------------

    @classmethod
    def open(cls, path: str, *, params: Optional[EnvelopeParams] = None,
             mesh=None, max_batch: Optional[int] = None,
             mmap: bool = True, memory_budget_bytes: Optional[int] = None,
             device: DeviceLike = None, axes=("data",)) -> "UlisseEngine":
        """Open a saved index (either package's) on `device` (default
        CUDA).

        Without `mesh`: a local save; the sorted envelopes and block
        levels are read, the raw series mmap'd lazily, so a cold open
        reads O(index), not O(raw data).  With `mesh` (a process group,
        as `distributed` takes it; `dist.group.WORLD` for the default
        one), every rank of it calls `open` and gets its shard
        (`distributed.ulisse.open_shard`): a distributed save with index
        sections whose shard count is the group's reopens in O(index)
        (each rank mmaps its own shard, nothing is summarized, the payload
        reaches the device at the first search); any other save (another
        shard count, a local save, one without sections) is re-sharded
        from its raw series and rebuilt, appended rows kept.  `params`:
        the expected EnvelopeParams; a mismatch raises
        IndexCompatibilityError.  `max_batch` defaults to the save's.  On
        a DeviceMesh the rows shard over the save's recorded `axes` (else
        the given ones), as the reference reopens: O(index) where the
        product of their sizes is the saved shard count."""
        if mesh is not None:
            from repro_torch.distributed.ulisse import open_shard
            shard, saved_batch = open_shard(mesh, path, params=params,
                                            device=device, axes=axes)
            return cls(max_batch=saved_batch if max_batch is None
                       else max_batch, shard=shard)
        return cls.from_index(
            _store.open_index(path, params=params, mmap=mmap, device=device),
            max_batch=8 if max_batch is None else max_batch,
            memory_budget_bytes=memory_budget_bytes, device=device)

    def save(self, path: str) -> str:
        """Persist the index to `path` (atomic commit).  Local: sorted
        envelopes, levels, breakpoints, raw shards and the delta, if
        series were appended and not compacted.  Distributed (every rank
        calls it): each rank's main rows, delta rows with their global
        ids, and index sections over its [main; delta] block, so that
        `open(path, mesh=...)` on a group of this size reads O(index)."""
        if self.is_distributed:
            from repro_torch.distributed.ulisse import save_shard
            return save_shard(self._shard, path, self.max_batch)
        return _store.save_index(path, self._index)

    @classmethod
    def from_writer(cls, writer, *, mmap: bool = True, mesh=None,
                    memory_budget_bytes: Optional[int] = None,
                    device: DeviceLike = None) -> "UlisseEngine":
        """Finalize a `storage.Writer` bulk build and open it (on the
        writer's device unless `device` is given).  With `mesh`, every
        rank calls it and rank 0 alone holds the Writer (the others pass
        None): rank 0 finalizes, every rank learns the path and opens it
        on the group."""
        if mesh is None:
            return cls.open(writer.finalize(), mmap=mmap,
                            memory_budget_bytes=memory_budget_bytes,
                            device=writer.device if device is None
                            else device)
        from repro_torch.distributed import collectives
        from repro_torch.distributed.ulisse import grid_groups
        if device is None and writer is not None:
            device = writer.device
        path = collectives.broadcast_object(
            None if writer is None else writer.finalize(),
            group=grid_groups(mesh).mesh_group, device=device)
        return cls.open(path, mesh=mesh, device=device)

    # -- incremental ingestion (storage.delta) ------------------------------

    def validate_append(self, series) -> int:
        """Check, without changing anything, that `series` — one (n,)
        series or an (S, n) batch — can be appended; raises the
        ValueError `append` would and returns the row count.  A
        distributed engine also refuses a part that does not divide by
        the rank count."""
        if not self.is_distributed:
            return _delta.as_series_rows(
                series, self._index.collection.series_len).shape[0]
        from repro_torch.distributed.ulisse import require_part
        arr = _delta.as_series_rows(series, self._shard.series_len)
        require_part(arr.shape[0], self._shard.shards)
        return arr.shape[0]

    def append(self, series) -> None:
        """Ingest new series, searchable at once through the delta set:
        O(new series) work, no re-sort, no block rebuild.  Distributed
        (every rank calls it with the same part): the part row-shards
        over the group as the build does, rank r taking rows [r * q, (r +
        1) * q) with their global ids (`distributed.ulisse.append_part`).
        Call `compact()` once appends have accumulated."""
        if self.is_distributed:
            from repro_torch.distributed.ulisse import append_part
            self.validate_append(series)
            append_part(self._shard, _delta.as_series_rows(
                series, self._shard.series_len))
            return
        self._index = _delta.extend_index(self._index, series)

    def compact(self) -> None:
        """Merge the delta into the main sorted set and rebuild the block
        levels: equal to a from-scratch build in every field and level.
        Distributed (every rank calls it): the deltas fold in in global id
        order and the collection re-shards evenly, equal in every shard
        field to `distributed` over the concatenated data with the same
        breakpoints; a cold shard's sections are dropped."""
        if self.is_distributed:
            from repro_torch.distributed.ulisse import compact_shard
            self._shard = compact_shard(self._shard)
            return
        self._index = _delta.compact_index(self._index)

    @property
    def delta_size(self) -> int:
        """Envelopes waiting in the ingestion delta (0 when compacted);
        on a distributed engine the count over every rank."""
        if self.is_distributed:
            return (self.params.num_envelopes(self._shard.series_len)
                    * self._shard.delta_total)
        if self._index.delta is None:
            return 0
        return self._index.delta.size

    def _paged_store(self):
        """The PayloadStore behind the paged scans, or None.

        Paging engages when a `memory_budget_bytes` is set, the collection
        is a still-lazy PayloadStore, and its payload does not fit the
        budget; a payload that fits is materialized whole on the device as
        before.  Keeps the store's cache limit at the budget.  The budget
        caps the page cache only: a paged scan's two slab slots (pinned
        host and card) hold the rows of a chunk each on top of it, at most
        B x chunk series (`executor._SlabRing`).
        """
        if self.is_distributed:
            return None
        coll = self._index.collection
        if (self.memory_budget_bytes is None
                or not isinstance(coll, _store.PayloadStore)
                or coll.is_materialized
                or coll.payload_bytes <= self.memory_budget_bytes):
            return None
        if coll.cache_limit_bytes != self.memory_budget_bytes:
            coll.cache_limit_bytes = self.memory_budget_bytes
        return coll

    def page_cache_stats(self) -> Optional[dict]:
        """The paged store's page-cache counters (hits, misses,
        evicted_bytes, cache_bytes, cached_pages), or None when the engine
        is not paging."""
        store = self._paged_store()
        return None if store is None else store.stats()

    @property
    def is_distributed(self) -> bool:
        return self._shard is not None

    @property
    def raw_data(self) -> np.ndarray:
        """The (S, n) raw series the engine serves, on the host (appended
        but uncompacted series included, in global id order; a
        distributed engine all-gathers every rank's rows and scatters the
        delta rows to their ids: a collective, on request only)."""
        if self.is_distributed:
            from repro_torch.distributed.ulisse import gather_data
            return gather_data(self._shard)
        return self._index.collection.data.cpu().numpy()

    @property
    def index(self) -> Optional[UlisseIndex]:
        """The local index (None for a distributed engine)."""
        return self._index

    @property
    def device(self) -> torch.device:
        if self.is_distributed:
            return self._shard.device
        return self._index.device

    @property
    def group(self):
        """A distributed engine's process group over all its ranks,
        replicas included (None: the default group)."""
        return self._shard.mesh_group if self.is_distributed else None

    @property
    def rank(self) -> int:
        """This process's rank in a distributed engine's group (0 for a
        local engine)."""
        if not self.is_distributed:
            return 0
        from repro_torch.distributed import collectives
        return collectives.world(self._shard.mesh_group)[1]

    # ------------------------------------------------------------------
    # the one entry point
    # ------------------------------------------------------------------

    def search(self, queries, spec: QuerySpec = QuerySpec()
               ) -> Union[SearchResult, List[SearchResult]]:
        """Answer one query (1-D input -> SearchResult) or a batch (2-D
        array or sequence of 1-D arrays -> list of SearchResult)."""
        single, qs = self._normalize_queries(queries)
        if self.is_distributed:
            if spec.scan_backend == "host":
                results = self._search_distributed(qs, spec)
            elif spec.is_range:
                results = self._distributed_range_device(qs, spec)
            else:
                results = self._distributed_knn_device(qs, spec)
        elif spec.scan_backend == "host":
            results = [self._search_local(q, spec) for q in qs]
        elif spec.is_range:
            results = self._local_range_device(qs, spec)
        elif spec.mode == "exact":
            results = self._local_exact_device(qs, spec)
        else:
            results = self._local_approx_device(qs, spec)
        return results[0] if single else results

    def warmup(self, lengths: Sequence[int],
               batch_sizes: Sequence[int] = (1,),
               spec: QuerySpec = QuerySpec()) -> int:
        """Pay every first-use cost of a traffic mix before the first real
        request: on a CUDA engine the kernels' build and load
        (`_build.load_all`, first), then one throwaway search per (length,
        batch size) pair on a deterministic query, so that the launches,
        allocations and host copies of those shapes have happened.  Batch
        sizes round up to their pow2 bucket as real dispatches do, so
        warming `(1, max_batch)` covers the common fills.  Returns the
        number of (length, batch) shapes exercised."""
        if self.device.type == "cuda":
            _build.load_all()
        p = self.params
        traced = 0
        for qlen in sorted({int(x) for x in lengths}):
            if not p.lmin <= qlen <= p.lmax:
                raise ValueError(
                    f"query length {qlen} outside [{p.lmin}, {p.lmax}]")
            # non-degenerate values: znormalize needs a nonzero std
            q = np.sin(np.linspace(0.0, 6.0, qlen)).astype(np.float32)
            for bsz in sorted({int(x) for x in batch_sizes}):
                if bsz < 1:
                    raise ValueError("batch sizes must be >= 1")
                self.search([q] * bsz, spec)
                traced += 1
        return traced

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
        with span("query.host", qlen=len(q),
                  shape="range" if spec.is_range else spec.mode):
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
        if index.delta is not None:
            # the delta has no block cover: sweep it first, chunk by chunk
            # (it primes the bsf, and keeps the exactness certificate
            # honest: every envelope outside the blocks has been verified)
            dvalid = index.envelopes.size + np.nonzero(
                executor.host_envelopes(index)["valid"][
                    index.envelopes.size:])[0]
            for start in range(0, len(dvalid), spec.chunk_size):
                executor.verify_envelopes(
                    index, pq, dvalid[start:start + spec.chunk_size], pool,
                    stats)
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
        executor.range_host_tail(index, pq, cand, lbs[cand] ** 2, 0,
                                 spec.chunk_size, eps2, rows, stats)
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
        """Shared per-length-group query prep on the device, no sync (the
        queries go up non-blocking)."""
        q = torch.from_numpy(np.stack(queries)).to(self.device,
                                                   non_blocking=True)
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
        ad2, asid, aoff, ast = self._exact_scan(
            (asids, aanc, anm, albs2), qstack, dlo, dhi,
            (torch.full((b, k), float("inf"), device=dev), neg, neg), k,
            spec, chunk)

        nd_chunks = -(-(env.size - n_main) // chunk)   # the delta's chunks
        visited = ast[:, 0]
        leaf_v = (visited - nd_chunks).clamp(0, n_leaves)
        # certificate: the first unvisited leaf cannot improve the pool,
        # or no finite-LB leaf is left
        kth2 = ad2[:, k - 1]
        next_lb = blk_sorted[torch.arange(b, device=dev),
                             leaf_v.clamp(max=nblk - 1).long()]
        cert = ((leaf_v >= nblk) | ~torch.isfinite(next_lb)
                | (next_lb ** 2 >= kth2))
        return ((ad2, asid, aoff), ast, cert, leaf_v, comb_idx, visited,
                chunk, nblk, asids.shape[1] // chunk)

    def _exact_scan(self, plan, qstack, dlo, dhi, seed, k: int,
                    spec: QuerySpec, chunk_size: int):
        """The seeded k-NN scan over a packed plan: resident
        (`device_exact_scan`) or, on a paged engine, out of core
        (`paged_exact_scan`, the same results)."""
        kw = dict(k=k, g=self.params.gamma + 1, measure=spec.measure,
                  r=spec.r, znorm=self.params.znorm, chunk_size=chunk_size)
        store = self._paged_store()
        if store is None:
            return executor.device_exact_scan(
                self._index.collection, *plan, qstack, dlo, dhi, *seed, **kw)
        return executor.paged_exact_scan(store, *plan, qstack, dlo, dhi,
                                         *seed, **kw)

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
        cancels near d = 0).  A paged engine reads only the reported rows,
        through the page cache."""
        store = self._paged_store()
        if store is None:
            data, rows = self._local_host_data(), sid
        else:
            data, rows = store.take_rows(sid), np.arange(len(sid))
        return executor.ed_rescore64(data, rows, off, q, self.params.znorm)

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
        overflows = 0
        with span("query.range_device", qlen=len(queries[0]),
                  batch=b) as qsp:
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
                store = self._paged_store()
                kw = dict(capacity=spec.range_capacity, g=p.gamma + 1,
                          measure=spec.measure, r=spec.r, znorm=p.znorm,
                          chunk_size=spec.chunk_size)
                if store is None:
                    scan = executor.device_range_scan(
                        index.collection, ssids, sanc, snm, slbs2, qstack,
                        dlo, dhi, eps2_t, **kw)
                else:
                    scan = executor.paged_range_scan(
                        store, ssids, sanc, snm, slbs2, qstack, dlo, dhi,
                        eps2_t, **kw)
                bd2, bsid, boff, cnt, ovf, st, chunk = scan
                # THE one result readback of the batch (overflow excepted)
                bd2, bsid, boff, cnt, ovf, st = executor.read_back(
                    bd2, bsid, boff, cnt, ovf, st)
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
                    overflows += 1
                    with span("host_continuation", query=i):
                        if order_h is None:     # read back on overflow only
                            order_h = executor.to_host(order)
                            slbs2_h = executor.to_host(slbs2).astype(
                                np.float64)
                        executor.range_host_tail(
                            index, self._prepare(qs[i], spec), order_h[row],
                            slbs2_h[row], o * chunk, chunk, eps2, rows,
                            stats, store=store)
                with span("merge", query=i):
                    results[i] = self._range_result_rows(rows, stats, qs[i],
                                                         spec)
            qsp.set(overflows=overflows)

    def _local_exact_device(self, qs, spec: QuerySpec):
        """Exact k-NN on the device (paper Alg. 5 incl. its line-1
        approximate pass), one result readback per same-length batch.

        Per batch: approximate pass -> its verified rows are
        scatter-excluded from the LB order (planner.device_scan_pack) ->
        the seeded exact scan.  A query whose certificate already proves
        exactness self-skips the scan: its first chunk is born inactive.
        """
        index = self._index
        k = spec.k
        dev = self.device
        results: List[Optional[SearchResult]] = [None] * len(qs)
        env = index.search_envelopes()
        n_comb = env.size
        for qlen, idxs in self._group_by_len(qs):
            for sub, queries, b in self._padded_batches(qs, idxs):
                with span("query.exact_device", qlen=qlen, batch=b) as sp:
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
                        d2, sid, off, st = self._exact_scan(
                            (ssids, sanc, snm, slbs2), qstack, dlo, dhi,
                            seed, k, spec, spec.chunk_size)
                        # THE one result readback of the batch
                        (d2, sid, off, st, ast, cert,
                         leaf_v) = executor.read_back(
                            d2, sid, off, st, ast, cert, leaf_v)
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
                    sp.set(chunks=int(st[:, 0].sum()))
        return results

    def _local_approx_device(self, qs, spec: QuerySpec):
        """Batched device approximate k-NN (paper Alg. 4): the approximate
        stage alone, one result readback per same-length batch."""
        k = spec.k
        results: List[Optional[SearchResult]] = [None] * len(qs)
        n_comb = self._index.search_envelopes().size
        for qlen, idxs in self._group_by_len(qs):
            for sub, queries, b in self._padded_batches(qs, idxs):
                with span("query.approx_device", qlen=qlen, batch=b):
                    with span("prepare"):
                        (nseg, qstack, dlo, dhi, qb,
                         qh) = self._stack_prepared(queries, spec)
                    with span("device_scan"):
                        ((ad2, asid, aoff), ast, cert, leaf_v, _, _, _,
                         nblk, aplan) = self._device_approx_stage(
                            qstack, dlo, dhi, qb, qh, nseg, k, spec)
                        # the one result readback of the batch
                        (ad2, asid, aoff, ast, cert,
                         leaf_v) = executor.read_back(
                            ad2, asid, aoff, ast, cert, leaf_v)
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

    # -- the distributed backend (this rank's half of every search) --------

    def _check_lengths(self, qs) -> None:
        p = self.params
        for qlen in sorted({len(q) for q in qs}):
            if not p.lmin <= qlen <= p.lmax:
                raise ValueError(
                    f"query length {qlen} outside [{p.lmin}, {p.lmax}]")

    def _shard_batches(self, qs, idxs):
        """Sub-batches of one length group padded to the pow2 bucket by
        repeating the first query, as the reference's sharded paths pad."""
        for sub, b in self._device_batches(idxs):
            queries = [qs[i] for i in sub]
            yield sub, queries + [queries[0]] * (b - len(sub)), b

    def _shard_lower_bounds(self, qb, qh, nseg: int, spec: QuerySpec):
        index = self._shard.index
        return planner.env_lower_bounds_batch(
            qb, qh, index.envelopes, index.breakpoints, self.params.seg_len,
            nseg, spec.use_paa_bounds)

    def _distributed_knn_device(self, qs, spec: QuerySpec):
        """Sharded k-NN, exact or (mode="approx") budget-capped at
        max_leaves chunks a shard, from empty pools (no approximate pass,
        as in the reference): `distributed.ulisse.sharded_knn` a padded
        same-length batch, its rounds' one all-gather each, one final
        all-gather.  Exactness is structural; approximate mode reads the
        certificate.  ED rows carry their owner's float64 rescore."""
        from repro_torch.distributed import ulisse as dist_ulisse
        shard, p = self._shard, self.params
        budget = spec.max_leaves if spec.mode == "approx" else 0
        n_env = self.delta_size + p.num_envelopes(shard.series_len) \
            * shard.num_series
        self._check_lengths(qs)
        results: List[Optional[SearchResult]] = [None] * len(qs)
        for qlen, idxs in self._group_by_len(qs):
            for sub, queries, b in self._shard_batches(qs, idxs):
                with span("query.sharded_knn", qlen=qlen, batch=b,
                          shards=shard.shards):
                    with span("prepare"):
                        (nseg, qstack, dlo, dhi, qb,
                         qh) = self._stack_prepared(queries, spec)
                    with span("device_scan"):
                        out = dist_ulisse.sharded_knn(
                            shard, queries, qstack, dlo, dhi,
                            self._shard_lower_bounds(qb, qh, nseg, spec),
                            k=spec.k, measure=spec.measure, r=spec.r,
                            chunk_size=spec.chunk_size,
                            sync_every=spec.sync_every, budget_chunks=budget)
                    with span("merge"):
                        for row, i in enumerate(sub):
                            stats = dist_ulisse.fold_knn_stats(
                                out.stats, row, n_env,
                                shard.shards * out.n_chunks)
                            if budget:
                                stats.exact_from_approx = bool(out.cert[row])
                            filled = out.sid[row] >= 0
                            d2 = (out.d2_64 if spec.measure == "ed"
                                  else out.d2)[row][filled].astype(np.float64)
                            order = np.argsort(d2, kind="stable")
                            results[i] = SearchResult(
                                dists=np.sqrt(np.maximum(d2[order], 0.0)),
                                series=out.sid[row][filled][order],
                                offsets=out.off[row][filled][order],
                                stats=stats)
        return results

    def _distributed_range_device(self, qs, spec: QuerySpec):
        """Sharded eps-range: `distributed.ulisse.sharded_range` a padded
        same-length batch (each rank's own hit buffer, an overflowed
        (query, shard) pair finished on its owner's host), hits in shard
        order, ED distances their owner's float64 rescore, sorted stably
        by distance."""
        from repro_torch.distributed import ulisse as dist_ulisse
        shard, p = self._shard, self.params
        eps2 = float(spec.eps) ** 2
        n_env = self.delta_size + p.num_envelopes(shard.series_len) \
            * shard.num_series
        self._check_lengths(qs)
        results: List[Optional[SearchResult]] = [None] * len(qs)
        for qlen, idxs in self._group_by_len(qs):
            for sub, queries, b in self._shard_batches(qs, idxs):
                with span("query.sharded_range", qlen=qlen, batch=b,
                          shards=shard.shards):
                    with span("prepare"):
                        (nseg, qstack, dlo, dhi, qb,
                         qh) = self._stack_prepared(queries, spec)
                    with span("device_scan"):
                        counters, hits, n_chunks = dist_ulisse.sharded_range(
                            shard, queries, len(sub), qstack, dlo, dhi,
                            self._shard_lower_bounds(qb, qh, nseg, spec),
                            eps2=eps2, measure=spec.measure, r=spec.r,
                            capacity=spec.range_capacity,
                            chunk_size=spec.chunk_size)
                    for row, i in enumerate(sub):
                        stats = dist_ulisse.fold_range_stats(
                            counters, row, n_env, shard.shards * n_chunks)
                        with span("merge", query=i):
                            got = np.concatenate(
                                [h[h[:, 0] == row, 1:] for h in hits])
                            order = np.argsort(got[:, 2], kind="stable")
                            results[i] = SearchResult(
                                dists=np.sqrt(np.maximum(got[order, 2], 0.0)),
                                series=got[order, 0].astype(np.int64),
                                offsets=got[order, 1].astype(np.int64),
                                stats=stats)
        return results

    def _search_distributed(self, qs, spec: QuerySpec) -> List[SearchResult]:
        """The distributed host backend (the reference's unpruned
        per-shard verify): exact ED k-NN, by length bucket, max_batch
        queries a chunk, each chunk's escalation loop in `_run_chunk`."""
        if (spec.measure != "ed" or spec.is_range or spec.mode != "exact"
                or spec.use_paa_bounds):
            raise NotImplementedError(
                "the legacy distributed host backend answers exact ED "
                "k-NN with quantized breakpoint bounds only; use "
                "scan_backend='device' (the default) for distributed "
                "DTW / range / approximate / use_paa_bounds queries")
        if self._shard.delta_active:
            raise NotImplementedError(
                "the legacy distributed host backend predates per-"
                "shard delta buffers and cold-opened index sections; "
                "compact() first, or use scan_backend='device' (the "
                "default), which searches the delta in-graph")
        self._check_lengths(qs)
        results: List[Optional[SearchResult]] = [None] * len(qs)
        by_bucket = {}
        for i, q in enumerate(qs):
            by_bucket.setdefault(
                planner.length_bucket(len(q), self.params.lmax), []).append(i)
        for _, idxs in sorted(by_bucket.items()):
            for start in range(0, len(idxs), self.max_batch):
                chunk = idxs[start:start + self.max_batch]
                for i, res in zip(chunk, self._run_chunk(qs, chunk, spec)):
                    results[i] = res
        return results

    def _run_chunk(self, qs, chunk, spec: QuerySpec) -> List[SearchResult]:
        """One chunk of the host backend with its exactness escalation:
        queries whose certificate fails are retried with doubled
        verify_top until it holds or the whole shard is verified
        (`escalations` counts the chunk's retries so far)."""
        from repro_torch.distributed import ulisse as dist_ulisse
        shard = self._shard
        out: List[Optional[SearchResult]] = [None] * len(chunk)
        pending = list(range(len(chunk)))
        vt, escalations, cap = spec.verify_top, 0, shard.env_rows
        while pending:
            d, codes, exact = dist_ulisse.sharded_host_knn(
                shard, [qs[chunk[ci]] for ci in pending], spec.k,
                min(vt, cap))
            exact = exact | (vt >= cap)
            still = []
            for row, ci in enumerate(pending):
                if exact[row]:
                    out[ci] = SearchResult(
                        dists=d[row].astype(np.float64),
                        series=codes[row, :, 0], offsets=codes[row, :, 1],
                        stats=dist_ulisse.host_result_stats(
                            shard, escalations, min(vt, cap)))
                else:
                    still.append(ci)
            pending = still
            if pending:
                vt *= 2
                escalations += 1
        return out
