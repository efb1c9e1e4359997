"""Verification for ULISSE search (the *executor* half), exact k-NN part.

Everything that touches raw series data lives here: the chunked,
LB-sorted, bsf-pruned exact scan over packed candidate rows, whose true
distances come from the `fused_gather_ed` kernel (ED) or from the
LB_Keogh tier `fused_gather_lb_keogh` and the banded DP `dtw_survivors`
on its survivors (DTW), the (B, k) device pool, and the result/stats
containers.

The JAX package runs the scan as one `lax.while_loop` program.  Eager
PyTorch pays a host sync for every stop test, so the scan here tests
its stop flag only every `STOP_TEST_EVERY` chunks: a chunk in which no
query is active leaves every pool and counter unchanged (no envelope is
kept, every candidate is +inf and loses its tie to the incumbents, and
the `active` column adds 0), so the results and stats are identical to
testing after every chunk.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.types import Collection
from repro_torch.kernels.dtw_band import dtw_survivors
from repro_torch.kernels.fused_verify import (fused_gather_ed,
                                              fused_gather_lb_keogh)

_INF = float("inf")

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


def pow2ceil(x: int) -> int:
    b = 1
    while b < x:
        b <<= 1
    return b


def _chunk_slice(sids, anchors, n_master, lbs2, i: int, chunk: int):
    """Chunk i of the packed (B, n_pad) plan arrays."""
    sl = slice(i * chunk, (i + 1) * chunk)
    return sids[:, sl], anchors[:, sl], n_master[:, sl], lbs2[:, sl]


def _chunk_candidates(csid, canc, cnm, keep, qlen: int, n: int, g: int):
    """Expand a chunk's envelopes into per-offset candidates.

    Returns (ok, cand_sid, cand_off) each (B, chunk*g): ok masks offsets
    that are real masters, fit the series, and belong to a kept
    (unpruned) envelope.
    """
    b_sz, chunk = csid.shape
    joff = torch.arange(g, dtype=torch.int32, device=csid.device)
    offs = canc[:, :, None] + joff                       # (B, chunk, g)
    ok = ((joff < cnm[:, :, None]) & (offs + qlen <= n)
          & keep[:, :, None]).reshape(b_sz, chunk * g)
    return (ok, csid.repeat_interleave(g, dim=1),
            offs.reshape(b_sz, chunk * g))


def _survivors_first(surv):
    """Stable survivors-first position pack of a (B, M) mask.

    Position j of the result is the j-th True column of its row;
    positions >= nsurv hold M - 1, which every consumer masks by
    `pos < nsurv` — the reference's `_survivors_first` (searchsorted over
    the mask cumsum), here as one scatter: no nonzero, no boolean
    indexing, no host sync.
    """
    b_sz, m = surv.shape
    rank = torch.cumsum(surv, dim=1) - 1
    # index m is the sink of the non-survivors
    dest = torch.where(surv, rank, m)
    packed = torch.full((b_sz, m + 1), m - 1, dtype=torch.int32,
                        device=surv.device)
    cols = torch.arange(m, dtype=torch.int32, device=surv.device)
    packed.scatter_(1, dest, cols.expand(b_sz, m))
    return packed[:, :m].contiguous()


def _pool_merge(pool, cd2, csid, coff, k: int):
    """Merge (B, M) candidates into a (B, k) pool sorted by d2.

    Incumbents win ties (they come first in the concatenation and the
    sort is stable) — the tie order of the reference's `lax.top_k`.
    """
    pd2, psid, poff = pool
    alld = torch.cat([pd2, cd2], dim=1)
    sel = torch.sort(alld, dim=1, stable=True).indices[:, :k]
    return (torch.gather(alld, 1, sel),
            torch.gather(torch.cat([psid, csid], dim=1), 1, sel),
            torch.gather(torch.cat([poff, coff], dim=1), 1, sel))


def _first_lb2(lbs2, i: int, chunk: int):
    """The (B,) squared lower bound heading chunk i of the packed plan —
    the LB-sorted order makes it the chunk's (and every later chunk's)
    best case, so it alone decides the scan's stop/skip tests."""
    return lbs2[:, min(i * chunk, lbs2.shape[1] - 1)]


def _scan_chunk_step(coll: Collection, sids, anchors, n_master, lbs2, qs,
                     dtw_lo, dtw_hi, i: int, pool, kth, active, *, k: int,
                     g: int, chunk: int, znorm: bool, measure: str, r: int):
    """Verify chunk `i` of the packed plan into the (B, k) pool.

    ED: one `fused_gather_ed` launch and one merge.  DTW: the LB_Keogh
    tier (`fused_gather_lb_keogh`), the survivors (lb2 < kth) packed
    first on the device, ONE `dtw_survivors` launch over every survivor
    of the chunk, and ONE merge of the (B, chunk * g) packed distances.
    The reference merges bucket by bucket (`lax.while_loop` over
    buckets of 128 survivors); one merge gives the same pool, because
    the survivors are packed in candidate-position order, the merge keeps
    incumbents ahead of newcomers on ties, and the sort is stable, so
    every bucket merge and the single merge pick the k least of the same
    (d2, position) order — and no host sync is needed to size the loop.

    Returns (pool, dstats) where dstats (B, STATS_WIDTH) holds the
    per-query increments of [chunks, envelopes_checked, true_dists,
    lb_keogh, dtw_full, envelopes_pruned].
    """
    n = coll.series_len
    b_sz, qlen = qs.shape
    csid, canc, cnm, clb2 = _chunk_slice(sids, anchors, n_master, lbs2, i,
                                         chunk)
    keep = (clb2 < kth[:, None]) & active[:, None]  # bsf pruning
    ok, cand_sid, cand_off = _chunk_candidates(csid, canc, cnm, keep, qlen,
                                               n, g)
    checked = keep.sum(dim=1, dtype=torch.int32)
    # envelopes cut by the bsf LB test in this visited chunk (padding rows
    # carry lbs2 = +inf and are excluded by the isfinite test)
    pruned = (torch.isfinite(clb2) & active[:, None] & ~keep).sum(
        dim=1, dtype=torch.int32)
    flat_sid = csid.reshape(-1).contiguous()
    flat_anc = canc.reshape(-1).contiguous()
    zeros = torch.zeros_like(checked)
    if measure == "ed":
        d2 = fused_gather_ed(coll.data, coll.csum, coll.csum2, coll.csum_lo,
                             coll.csum2_lo, coll.center, flat_sid, flat_anc,
                             qs, g=g, rows=chunk, znorm=znorm)
        d2 = torch.where(ok, d2.reshape(b_sz, chunk * g), _INF)
        pool = _pool_merge(pool, d2, cand_sid, cand_off, k)
        tdist = ok.sum(dim=1, dtype=torch.int32)
        nlbk = ndtw = zeros
    else:
        lb2, mu, sd = fused_gather_lb_keogh(
            coll.data, coll.csum, coll.csum2, coll.csum_lo, coll.csum2_lo,
            coll.center, flat_sid, flat_anc, dtw_lo, dtw_hi, g=g,
            rows=chunk, znorm=znorm)
        lb2 = torch.where(ok, lb2.reshape(b_sz, chunk * g), _INF)
        nlbk = ok.sum(dim=1, dtype=torch.int32)
        surv = lb2 < kth[:, None]
        tdist = ndtw = surv.sum(dim=1, dtype=torch.int32)
        sidx = _survivors_first(surv)
        db = dtw_survivors(coll.data, qs, sidx, ndtw, cand_sid, cand_off,
                           mu.reshape(b_sz, chunk * g),
                           sd.reshape(b_sz, chunk * g), r=r, znorm=znorm)
        sl = sidx.long()
        pool = _pool_merge(pool, db, torch.gather(cand_sid, 1, sl),
                           torch.gather(cand_off, 1, sl), k)
    return pool, torch.stack([active.to(torch.int32), checked, tdist,
                              nlbk, ndtw, pruned], dim=1)


def _device_scan_core(coll: Collection, sids, anchors, n_master, lbs2, qs,
                      dtw_lo, dtw_hi, seed, *, k: int, g: int, chunk: int,
                      znorm: bool, measure: str, r: int):
    """The natively batched LB-sorted bsf-pruned scan.

    Every chunk step verifies the i-th chunk of all B queries through one
    kernel launch; queries whose scan has converged keep stepping with
    their candidates masked to +inf (merge no-ops) until the whole batch
    is done.  The stop test `any(active)` runs on the host before every
    group of STOP_TEST_EVERY chunks — one sync per group, counted in
    `device_exact_scan.syncs`.
    """
    n_chunks = sids.shape[1] // chunk

    def active_at(i, pool):
        first = _first_lb2(lbs2, i, chunk)
        return torch.isfinite(first) & (first < pool[0][:, k - 1])

    pool = seed
    stats = torch.zeros((qs.shape[0], STATS_WIDTH), dtype=torch.int32,
                        device=qs.device)
    i = 0
    while i < n_chunks:
        device_exact_scan.syncs += 1
        if not bool(active_at(i, pool).any()):
            break
        for _ in range(min(STOP_TEST_EVERY, n_chunks - i)):
            active = active_at(i, pool)
            pool, ds = _scan_chunk_step(
                coll, sids, anchors, n_master, lbs2, qs, dtw_lo, dtw_hi, i,
                pool, pool[0][:, k - 1], active, k=k, g=g, chunk=chunk,
                znorm=znorm, measure=measure, r=r)
            stats = stats + ds
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
