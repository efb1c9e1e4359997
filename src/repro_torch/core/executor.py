"""Verification for ULISSE search (the *executor* half), k-NN part.

Everything that touches raw series data lives here: the chunked,
LB-sorted, bsf-pruned exact scan over packed candidate rows, whose true
distances come from the `fused_gather_ed` kernel (ED) or from the
LB_Keogh tier `fused_gather_lb_keogh_chunk` and the banded DP
`dtw_survivors` on the survivors it lists (DTW), the (B, k) device
pool, and the result/stats containers.

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
testing after every chunk.
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
from repro_torch.kernels.fused_verify import (fused_gather_ed,
                                              fused_gather_lb_keogh_chunk)
from repro_torch.kernels.lb_keogh import lb_keogh

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
    return (ok, csid[:, :, None].expand(b_sz, chunk, g).reshape(
        b_sz, chunk * g), offs.reshape(b_sz, chunk * g))


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

    ED: one `fused_gather_ed` launch and one merge.  DTW: ONE launch of
    the LB_Keogh tier (`fused_gather_lb_keogh_chunk`), which masks the
    bounds, lists each query's survivors (lb2 < kth) on the device and
    writes +inf into the DP's (B, chunk * g) output at every other
    candidate position; ONE `dtw_survivors` launch over every survivor of
    the chunk, which writes each one's distance at its own position; and
    ONE merge of that output, as the ED branch's.  The reference merges
    bucket by bucket (`lax.while_loop` over buckets of 128 survivors
    packed in candidate-position order); one merge of the
    position-indexed output gives the same pool, because the merge keeps
    incumbents ahead of newcomers on ties and the sort is stable, so
    every bucket merge and the single merge pick the k least of the same
    (d2, position) order — whatever order the kernel listed the
    survivors in — and no host sync is needed to size the loop.

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
        _, mu, sd, slist, ndtw, db = fused_gather_lb_keogh_chunk(
            coll.data, coll.csum, coll.csum2, coll.csum_lo, coll.csum2_lo,
            coll.center, flat_sid, flat_anc, dtw_lo, dtw_hi, ok,
            kth.contiguous(), g=g, rows=chunk, znorm=znorm)
        nlbk = ok.sum(dim=1, dtype=torch.int32)
        tdist = ndtw
        db = dtw_survivors(coll.data, qs, slist, ndtw, cand_sid, cand_off,
                           mu.reshape(b_sz, chunk * g),
                           sd.reshape(b_sz, chunk * g), db, r=r, znorm=znorm)
        pool = _pool_merge(pool, db, cand_sid, cand_off, k)
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
