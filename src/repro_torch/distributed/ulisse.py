"""Distributed ULISSE on a `torch.distributed` process group: the rank's
shard of the index, its ingestion delta and persistence, and the sharded
k-NN (exact and approximate), eps-range and host-backend searches.

The JAX package runs one controller over a `shard_map` mesh.  Here every
rank is a process holding one shard (SPMD): every rank passes the same
(S, n) collection and the same queries, keeps only its own rows [rank *
S / P, (rank + 1) * S / P) on its device with their prefix sums and
their envelope set (a shard's build equals the same rows of a global
build: every step is per series), and returns the same answers as every
other rank.  The ranks meet only in `collectives`.

The sharded k-NN scan (`sharded_knn`, the reference's
`_sharded_knn_scan` and `make_sharded_knn_query`) is a host-driven loop
over `executor._scan_chunk_step`, round by round as the reference's
`while_loop` runs: a round is `sync_every` chunk steps, every one pruning
with min(pool k-th, gkth) through the chunk entries' `gkth` input, gkth
frozen until the round ends; a rank none of whose queries is active at
the start of a round launches nothing in it (an inactive step adds
nothing, and the cut only shrinks); the round ends in one all-gather of
every rank's pool d2 and chunk-head bound, from which every rank derives
the new gkth (the k-th of the union) and whether any rank is still
active: the round's one host sync.  The first round runs only if some
rank is active at chunk 0.  `mode="approx"` caps each rank at budget =
min(max_leaves, n_chunks) chunks; the exactness certificate (the head of
each rank's first unvisited chunk against the final cut) rides the final
all-gather, with the pools, the counters and, for ED, each rank's float64
rescore of its own pool rows (a rank reads only its own rows).  The final
(B, k) merge replays the reference's ring order.

The sharded range scan (`sharded_range`) needs no collective until its
end: each rank packs (`device_range_pack`) and scans its own rows into
its own hit buffer; a rank whose buffer overflowed finishes its own plan
tail through the host path; then the hits (ED ones rescored in float64 by
their owner) and the counters are gathered in shard order.

Ingestion (the reference's per-shard delta buffers): an appended part
row-shards over the ranks as the build does (`append_part`: rank r takes
rows [r * q, (r + 1) * q) with their global ids, their envelopes built on
its device at once, series ids local to its [main; delta] block).  A
shard with a delta, or opened cold, runs the reference's delta/gmap
family: the k-NN pack puts the delta's rows first with pinned chunk
heads (`planner.device_shard_pack(n_delta=...)`, the approximate budget
stretched by those chunks), the chunk step maps the pool's ids through
the rank's gmap, and range hits leave through it too.  `compact_shard`
gathers every rank's rows in global id order and rebuilds its shard with
the same breakpoints: `build_shard` of the grown collection, bit for
bit.  `save_shard` / `open_shard` write and reopen a rank's shard in the
reference's distributed format (`storage.store`).

The host backend (`sharded_host_knn`, the reference's
`make_batched_distributed_query`) verifies each rank's `verify_top`
least-bound envelopes, every offset, through the contract entry of
`fused_gather_ed`, reports raw float32 distances, and gathers each
rank's k best and its largest verified bound, from which the engine's
escalation loop reads the certificate.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import executor, planner
from repro_torch.core.envelope import build_envelope_set
from repro_torch.core.executor import STATS_WIDTH, SearchStats
from repro_torch.core.index import UlisseIndex, default_breakpoints
from repro_torch.core.types import (Collection, DeviceLike, EnvelopeParams,
                                    EnvelopeSet, concat_collections,
                                    concat_envelope_sets, resolve_device)
from repro_torch.distributed import collectives
from repro_torch.kernels.fused_verify import fused_gather_ed
from repro_torch.obs import span
from repro_torch.storage import format as fmt
from repro_torch.storage import store as _store

# the reference's sharded index fields, in its order
SHARDED_INDEX_FIELDS = (
    "data", "csum", "csum2", "csum_lo", "csum2_lo", "center",
    "paa_lo", "paa_hi", "sym_lo", "sym_hi",
    "series_id", "anchor", "n_master", "valid",
)

# the non-data fields: what build_host_index returns per block of series
INDEX_SECTION_FIELDS = SHARDED_INDEX_FIELDS[1:]

_INF = float("inf")


def decode_id(code):
    """codes are (sid, off) int pairs stacked on the last axis."""
    return code[..., 0], code[..., 1]


def require_divisible(num_series: int, shards: int) -> None:
    """Refuse a group that does not divide the collection evenly (a
    truncated rows-per-shard table would let the host backend's
    escalation declare a shard fully verified while rows were never
    checked)."""
    if num_series % shards != 0:
        raise ValueError(
            f"num_series={num_series} is not divisible by the {shards}-rank "
            "process group; pad the collection to a multiple of the rank "
            "count (or pick a divisible group) before "
            "UlisseEngine.distributed")


def shard_rows(num_series: int, shards: int, rank: int):
    """The [lo, hi) series rows of `rank` (the reference's
    `shard_collection` row split)."""
    per = num_series // shards
    return rank * per, (rank + 1) * per


def build_host_index(p: EnvelopeParams, breakpoints, data) -> dict:
    """The 13 non-data fields of SHARDED_INDEX_FIELDS for one block of
    series, as numpy arrays (series_id local to the block), built on the
    CPU: the collection's prefix sums (the host float64 code, bit-equal to
    the reference's) and the envelope set.  Every step is per series, so
    a block's build equals the same rows of a build over the whole
    collection."""
    coll = Collection.from_array(np.asarray(data, np.float32), device="cpu")
    env = build_envelope_set(
        coll, p, torch.tensor(np.asarray(breakpoints, np.float32)))
    out = {f: getattr(coll, f) for f in SHARDED_INDEX_FIELDS[1:6]}
    out.update({f: getattr(env, f) for f in SHARDED_INDEX_FIELDS[6:]})
    return {f: out[f].numpy() for f in INDEX_SECTION_FIELDS}


@dataclasses.dataclass
class Shard:
    """One rank's share of a distributed engine: its rows' index (the
    collection and the unsorted envelope set over its [main; delta]
    block, series ids local to the block, as a block-free
    `UlisseIndex`), its raw rows on the host (the float64 polish and the
    overflow tail read them), its ingestion delta and where it sits in
    the group.

    The delta (the reference's `_shard_delta`, `_delta_gmaps`,
    `_delta_total`): the rows of every appended part this rank took
    (`append_part`), after its main rows, with their global series ids
    (`delta_gmap`; append parts interleave the ranks, so the map is not
    affine).  A cold-opened shard (`open_shard`) holds its saved index
    `sections` (host arrays, mmap'd) and builds no index until the first
    search reads `index`; parts appended before that wait in `pending`,
    their envelopes already built on the device."""

    group: object
    rank: int
    shards: int
    params: EnvelopeParams
    breakpoints: torch.Tensor   # (card - 1,) on `device`
    device: torch.device
    main_rows: np.ndarray       # (S / P, n) main rows (mmap'd when cold)
    num_series: int             # the whole collection's main series
    series_len: int
    delta_rows: np.ndarray      # (d, n) this rank's appended rows
    delta_gmap: np.ndarray      # (d,) int64, their global series ids
    delta_total: int = 0        # series appended over the whole group
    sections: Optional[dict] = None   # cold: INDEX_SECTION_FIELDS arrays
    pending: list = dataclasses.field(default_factory=list)
    built: Optional[UlisseIndex] = None

    @property
    def index(self) -> UlisseIndex:
        """The device index over the [main; delta] block, assembled at
        first use on a cold shard (its sections copied to the device,
        nothing summarized) and after an append (the pending parts'
        collections and envelopes concatenated)."""
        if self.built is None:
            self.built = _index_from_sections(self)
        if self.pending:
            colls = [self.built.collection] + [c for c, _ in self.pending]
            coll = functools.reduce(concat_collections, colls)
            env = concat_envelope_sets([self.built.envelopes]
                                       + [e for _, e in self.pending])
            self.built = UlisseIndex(envelopes=env, levels=[],
                                     collection=coll,
                                     breakpoints=self.breakpoints,
                                     params=self.params)
            self.pending = []
        return self.built

    @property
    def row0(self) -> int:
        """The global id of this rank's first main series."""
        return self.rank * self.main_rows.shape[0]

    @property
    def delta_env_rows(self) -> int:
        """Envelope rows of this rank's delta (the trailing rows of its
        envelope set: the k-NN pack's unsorted delta region)."""
        return self.params.num_envelopes(self.series_len) * len(
            self.delta_rows)

    @property
    def delta_active(self) -> bool:
        """Whether searches run the reference's delta/gmap families: rows
        were appended, or the shard was opened cold (with no delta the
        two families compute the same)."""
        return self.delta_total > 0 or self.sections is not None

    @property
    def gmap(self) -> np.ndarray:
        """(S / P + d,) int64: local row -> global series id, ascending
        (the main rows' ids are below every appended id, and parts arrive
        in id order)."""
        r_m = self.main_rows.shape[0]
        return np.concatenate([np.arange(self.row0, self.row0 + r_m),
                               self.delta_gmap])

    @property
    def env_rows(self) -> int:
        """Envelope rows of the shard (the host backend's verify cap)."""
        return self.index.envelopes.size

    def take_rows(self, local) -> np.ndarray:
        """Host rows of local series ids (main, then delta)."""
        local = np.asarray(local, np.int64)
        r_m = self.main_rows.shape[0]
        out = np.empty((len(local), self.series_len), np.float32)
        main = local < r_m
        out[main] = self.main_rows[local[main]]
        out[~main] = self.delta_rows[local[~main] - r_m]
        return out

    def to_local(self, gsid) -> np.ndarray:
        """Local rows of global series ids this rank holds."""
        return np.searchsorted(self.gmap, np.asarray(gsid, np.int64))


def _index_from_sections(shard: Shard) -> UlisseIndex:
    """A cold shard's device index from its sections: the prefix sums
    and envelope rows as saved, the raw rows they cover read from the
    mmap'd payload (the first bytes of it the shard reads)."""
    sec = shard.sections
    dev = shard.device
    cov = int(sec["center"].shape[0])
    r_m = shard.main_rows.shape[0]
    rows = np.empty((cov, shard.series_len), np.float32)
    rows[:r_m] = shard.main_rows            # sections cover main, then
    rows[r_m:] = shard.delta_rows[:cov - r_m]   # the delta as saved

    def put(x):
        return torch.from_numpy(np.array(x)).to(dev)

    coll = Collection(data=put(rows), **{f: put(sec[f]) for f in
                                         SHARDED_INDEX_FIELDS[1:6]})
    env = EnvelopeSet(**{f: put(sec[f]) for f in SHARDED_INDEX_FIELDS[6:]})
    return UlisseIndex(envelopes=env, levels=[], collection=coll,
                       breakpoints=shard.breakpoints, params=shard.params)


def _resolve(device: DeviceLike) -> torch.device:
    if device is None and torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    return resolve_device(device)


def build_shard(group, p: EnvelopeParams, data, breakpoints=None,
                device: DeviceLike = None) -> Shard:
    """This rank's shard of `data` (S, n), the same on every rank: its
    rows [rank * S / P, (rank + 1) * S / P) on `device` (default
    cuda:{current device}; raises without CUDA unless "cpu"), their
    prefix sums, and their envelope set built there (`envelope_znorm` on
    the card).  The breakpoints come from the whole collection (or are
    given), so they are the same on every rank.  Refuses a non-divisible
    S and series shorter than lmax before any other work."""
    arr = np.asarray(data)
    shards, rank = collectives.world(group)
    s, n = arr.shape
    require_divisible(s, shards)
    if n < p.lmax:
        raise ValueError("series shorter than lmax")
    dev = _resolve(device)
    if breakpoints is None:
        head = np.array(arr[:min(1024, s)], np.float32)
        bp = default_breakpoints(p, torch.from_numpy(head).to(dev))
    else:
        bp = torch.as_tensor(breakpoints, dtype=torch.float32).to(dev)
    lo, hi = shard_rows(s, shards, rank)
    rows = np.array(arr[lo:hi], np.float32)     # a copy of its rows alone
    coll = Collection.from_array(rows, device=dev)
    env = build_envelope_set(coll, p, bp)
    index = UlisseIndex(envelopes=env, levels=[], collection=coll,
                        breakpoints=bp, params=p)
    return Shard(group=group, rank=rank, shards=shards, params=p,
                 breakpoints=bp, device=dev, main_rows=rows, num_series=s,
                 series_len=n, delta_rows=np.zeros((0, n), np.float32),
                 delta_gmap=np.zeros((0,), np.int64), built=index)


def require_part(rows: int, shards: int) -> None:
    """Refuse an appended part that does not divide by the rank count
    (the reference's words: its mesh is this group)."""
    if rows % shards != 0:
        raise ValueError(
            f"appended part of {rows} series is not divisible by the "
            f"{shards}-shard mesh; pad the part to a multiple of the shard "
            "count (row-sharded delta placement follows the build layout)")


def append_part(shard: Shard, part: np.ndarray) -> None:
    """Append a validated (S', n) part, the same on every rank: this rank
    takes rows [rank * q, (rank + 1) * q) of it (q = S' / P), with global
    ids base + rank * q + arange(q), base = S + the series appended
    before (the ids a local engine gives the same stream).  Their prefix
    sums and envelopes are built at once on the device (`envelope_znorm`
    on the card), series ids local to the rank's [main; delta] block;
    the envelope set grows at the next search.  O(part) work."""
    q = part.shape[0] // shard.shards
    base = shard.num_series + shard.delta_total
    shard.delta_total += part.shape[0]
    if q == 0:
        return
    rows = np.array(part[shard.rank * q:(shard.rank + 1) * q], np.float32)
    coll = Collection.from_array(rows, device=shard.device)
    env = build_envelope_set(coll, shard.params, shard.breakpoints)
    local0 = shard.main_rows.shape[0] + len(shard.delta_rows)
    shard.pending.append((coll, dataclasses.replace(
        env, series_id=env.series_id + local0)))
    shard.delta_rows = np.concatenate([shard.delta_rows, rows])
    shard.delta_gmap = np.concatenate(
        [shard.delta_gmap,
         base + shard.rank * q + np.arange(q, dtype=np.int64)])


def gather_data(shard: Shard) -> np.ndarray:
    """The whole (S + appended, n) collection on the host, in global id
    order: one all-gather of every rank's [main; delta] rows and one of
    their delta ids, the delta rows scattered to their ids (on request
    only)."""
    r_m, d = shard.main_rows.shape[0], len(shard.delta_rows)
    rows = np.concatenate([shard.main_rows, shard.delta_rows]) if d \
        else np.asarray(shard.main_rows)
    allr = collectives.all_gather(
        torch.from_numpy(np.ascontiguousarray(rows, np.float32)).to(
            shard.device), shard.group).cpu().numpy()
    out = np.empty((shard.num_series + shard.delta_total, shard.series_len),
                   np.float32)
    out[:shard.num_series] = allr[:, :r_m].reshape(-1, shard.series_len)
    if d:
        gmaps = collectives.all_gather(
            torch.from_numpy(shard.delta_gmap).to(shard.device),
            shard.group).cpu().numpy()
        out[gmaps.reshape(-1)] = allr[:, r_m:].reshape(-1, shard.series_len)
    return out


def compact_shard(shard: Shard) -> Shard:
    """The mesh-wide compaction (the reference's `compact`): every rank's
    delta folds into the main rows in global id order and the collection
    re-shards evenly (rows move between ranks): one `gather_data`, then
    each rank builds its new shard on the device with the existing
    breakpoints, which is exactly `build_shard` of the concatenated data
    (bit for bit).  Drops a cold shard's sections.

    Where no row moves (a group of one, or nothing appended) every rank
    already holds its new rows in global id order, with their prefix sums
    and envelopes (series ids local to the block), and keeps them: every
    step of a build is per series, so they are the build's bits too.
    Every rank takes the same branch."""
    if shard.delta_total == 0 and shard.sections is None:
        return shard
    if shard.shards > 1 and shard.delta_total > 0:
        return build_shard(shard.group, shard.params, gather_data(shard),
                           breakpoints=shard.breakpoints,
                           device=shard.device)
    index = shard.index
    rows = (np.concatenate([shard.main_rows, shard.delta_rows])
            if len(shard.delta_rows) else shard.main_rows)
    return Shard(group=shard.group, rank=shard.rank, shards=shard.shards,
                 params=shard.params, breakpoints=shard.breakpoints,
                 device=shard.device, main_rows=rows,
                 num_series=shard.num_series + shard.delta_total,
                 series_len=shard.series_len,
                 delta_rows=np.zeros((0, shard.series_len), np.float32),
                 delta_gmap=np.zeros((0,), np.int64), built=index)


def shard_sections(shard: Shard) -> dict:
    """The host INDEX_SECTION_FIELDS arrays of the rank's [main; delta]
    block (what a distributed save stores, so that the next open on a
    group of this size reads them instead of summarizing)."""
    idx = shard.index
    src = {f: idx.collection for f in SHARDED_INDEX_FIELDS[1:6]}
    src.update({f: idx.envelopes for f in SHARDED_INDEX_FIELDS[6:]})
    return {f: getattr(src[f], f).cpu().numpy()
            for f in INDEX_SECTION_FIELDS}


def save_shard(shard: Shard, path: str, max_batch: int) -> str:
    """Every rank's half of a distributed save (`store.save_distributed`):
    this rank writes its main rows, its delta and their ids, and its
    index sections."""
    return _store.save_distributed(
        path, shard.params, shard.breakpoints.cpu().numpy(),
        shard.main_rows, group=shard.group, device=shard.device,
        max_batch=max_batch, delta_rows=shard.delta_rows,
        delta_gmap=shard.delta_gmap, section=shard_sections(shard))


def open_shard(group, path: str, params: Optional[EnvelopeParams] = None,
               device: DeviceLike = None):
    """This rank's shard of a saved index (either package's), and the
    manifest's max_batch.  Rank 0 first recovers a crashed commit
    (`gc_stale_tmp`), and every rank waits for it.  A distributed save
    with sections whose shard count is the group's opens in O(index):
    the rank mmaps its own shard's payload, delta and sections and reads
    its delta ids and the breakpoints, nothing more, and summarizes
    nothing.  Any other save (another shard count, a local save, a save
    without sections) is read whole (`store.load_raw_data`, delta rows
    back at their ids), re-sharded and rebuilt."""
    shards, rank = collectives.world(group)
    dev = _resolve(device)
    err = None
    if rank == 0:
        try:
            fmt.gc_stale_tmp(path)
        except OSError as e:       # every rank waits for rank 0 first
            err = e
    if not collectives.agree(err is None, group, device=dev):
        raise err if err is not None else fmt.IndexFormatError(
            f"rank 0 could not recover {path!r}")
    manifest = fmt.read_manifest(path)
    max_batch = manifest.get("max_batch", 8)
    if (manifest["kind"] == fmt.KIND_DISTRIBUTED
            and manifest.get("index_sections")
            and len(manifest["collection_shards"]) == shards):
        (stored, bp, manifest, main, delta, gmap,
         section) = _store.load_distributed_sections(path, rank, params)
        return Shard(
            group=group, rank=rank, shards=shards, params=stored,
            breakpoints=torch.from_numpy(np.array(bp, np.float32)).to(dev),
            device=dev, main_rows=main,
            num_series=int(manifest["num_series"]),
            series_len=int(manifest["series_len"]), delta_rows=delta,
            delta_gmap=gmap, delta_total=len(gmap) * shards,
            sections=section), max_batch
    stored, bp, data, _ = _store.load_raw_data(path, params)
    return build_shard(group, stored, data, breakpoints=bp,
                       device=dev), max_batch


def distributed_index_stats(shards: int, p: EnvelopeParams,
                            num_series: int, series_len: int,
                            delta_envelopes: int = 0) -> dict:
    """Analytic size/balance report of the sharded index over `shards`
    ranks (the reference's, with the rank count for its mesh size):
    envelopes in all, in the delta, per device, bytes per device, and the
    k-NN merge's wire bytes a query."""
    n_env = p.num_envelopes(series_len) * num_series + delta_envelopes
    per = -(-n_env // shards)
    return {
        "envelopes_total": n_env,
        "envelopes_delta": delta_envelopes,
        "envelopes_per_device": per,
        "bytes_per_device": per * (2 * p.w + 8),
        "query_wire_bytes": shards * 8 * 2,
    }


# -- the sharded k-NN scan ----------------------------------------------------

@dataclasses.dataclass
class KnnOut:
    """A sharded k-NN batch's answer, the same on every rank, on the
    host: the merged (B, k) pool (d2 float32 ascending, global sid, off),
    each row's float64 rescore (ED; zeros for DTW), the (P, B, 6) counter
    stack, the (B,) exactness certificates, and the plan's chunks a
    shard."""

    d2: np.ndarray
    sid: np.ndarray
    off: np.ndarray
    d2_64: np.ndarray
    stats: np.ndarray
    cert: np.ndarray
    n_chunks: int


def _round_end(pool_d2, head, k: int, group):
    """The round's one collective: every rank's pool d2 (B, k) and
    chunk-head bound (B,) (+inf past the budget) gathered; returns (gkth
    (B,) on the host, this rank active, any rank active), exactly as the
    reference's global_kth and pmax over local_active."""
    allp = collectives.all_gather(torch.cat([pool_d2, head[:, None]], 1),
                                  group).cpu()
    d2, f = allp[:, :, :k], allp[:, :, k]
    gkth = collectives.kth_of_union(d2, k)
    rem = torch.isfinite(f) & (f < torch.minimum(d2[:, :, k - 1], gkth))
    rank = collectives.world(group)[1]
    return gkth, bool(rem[rank].any()), bool(rem.any())


def sharded_knn(shard: Shard, queries, qstack, dlo, dhi, lbs, *, k: int,
                measure: str, r: int, chunk_size: int, sync_every: int,
                budget_chunks: int = 0) -> KnnOut:
    """One rank's half of the globally pruned k-NN scan over a padded
    batch (paper Alg. 5 on a group of ranks).

    queries: the batch's B host queries (the float64 polish reads them);
    qstack/dlo/dhi (B, qlen) the prepared queries and their DTW
    envelopes; lbs (B, N) this shard's envelope lower bounds.
    `budget_chunks` > 0 is the approximate mode's chunk budget a shard.
    A shard with a delta (or opened cold) packs the delta first and maps
    the pool's ids through its gmap in every step.  Counts its rounds and
    chunk steps in `sharded_knn.rounds` / `.steps`, and the steps with a
    gmap in `.gmap_steps`.
    """
    p = shard.params
    coll, env, group = shard.index.collection, shard.index.envelopes, \
        shard.group
    b, dev = qstack.shape[0], qstack.device
    d_rows = shard.delta_env_rows
    n_pad, chunk, nd_pad = executor.shard_pack_geometry(env.size, d_rows,
                                                        chunk_size)
    sids, anc, nm, lbs2 = planner.device_shard_pack(
        env.series_id, env.anchor, env.n_master, lbs, n_pad=n_pad,
        n_delta=d_rows, chunk=chunk)
    # the delta/gmap family: the step maps the pool's ids to global ones
    # (a (R + 1,) table, -1 last for empty entries)
    gmap = (torch.from_numpy(np.append(shard.gmap, -1).astype(np.int32))
            .to(dev) if shard.delta_active else None)
    n_chunks = n_pad // chunk
    budget = (min(budget_chunks + nd_pad // chunk, n_chunks)
              if budget_chunks else n_chunks)
    heads = lbs2[:, ::chunk]                          # (B, n_chunks)
    none = torch.full((b,), _INF, device=dev)

    def head_at(i):
        return heads[:, i] if i < budget else none

    pool = (torch.full((b, k), _INF, device=dev),
            torch.full((b, k), -1, dtype=torch.int32, device=dev),
            torch.full((b, k), -1, dtype=torch.int32, device=dev))
    stats = torch.zeros((b, STATS_WIDTH), dtype=torch.int32, device=dev)
    gkth, mine, cont = _round_end(pool[0], head_at(0), k, group)
    i = 0
    while cont:
        if mine:
            gk = gkth.to(dev, non_blocking=True)
            for j in range(i, min(i + sync_every, budget)):
                executor._scan_chunk_step(
                    coll, sids, anc, nm, lbs2, qstack, dlo, dhi, j, pool,
                    stats, k=k, g=p.gamma + 1, chunk=chunk, znorm=p.znorm,
                    measure=measure, r=r, gmap=gmap, gkth=gk)
                sharded_knn.steps += 1
                sharded_knn.gmap_steps += gmap is not None
        i += sync_every
        sharded_knn.rounds += 1
        gkth, mine, cont = _round_end(pool[0], head_at(i), k, group)

    # the final gather: pools (global ids), the certificate's head (the
    # first unvisited chunk's, budget < n_chunks only), the counters and
    # the owner's float64 rescore of its own rows (ED)
    psid = pool[1]
    gsid = psid if gmap is not None else torch.where(psid >= 0,
                                                     psid + shard.row0, -1)
    resc = torch.zeros((b, k), dtype=torch.float64)
    if measure == "ed":
        sid_h, off_h = gsid.cpu().numpy(), pool[2].cpu().numpy()
        for row in range(b):
            live = sid_h[row] >= 0
            if live.any():
                rows = shard.take_rows(shard.to_local(sid_h[row, live]))
                resc[row, live] = torch.from_numpy(executor.ed_rescore64(
                    rows, np.arange(len(rows)), off_h[row, live],
                    queries[row], p.znorm))
    payload = torch.cat([pool[0].double(), gsid.double(), pool[2].double(),
                         (heads[:, budget] if budget < n_chunks else none)
                         [:, None].double(), stats.double(),
                         resc.to(dev)], 1)
    allp = collectives.all_gather(payload, group).cpu()
    d2s = allp[..., :k].float()
    fb = allp[..., 3 * k].float()
    gk = collectives.kth_of_union(d2s, k)
    rem = torch.isfinite(fb) & (fb < torch.minimum(d2s[:, :, k - 1], gk))
    md2, msid, moff, m64 = collectives.ring_order_merge(
        (d2s, allp[..., k:2 * k].long(), allp[..., 2 * k:3 * k].long(),
         allp[..., 3 * k + 7:]), k)
    return KnnOut(d2=md2.numpy(), sid=msid.numpy(), off=moff.numpy(),
                  d2_64=m64.numpy(),
                  stats=allp[..., 3 * k + 1:3 * k + 7].long().numpy(),
                  cert=(~rem.any(0)).numpy(), n_chunks=n_chunks)


sharded_knn.rounds = 0
sharded_knn.steps = 0
sharded_knn.gmap_steps = 0


# -- the sharded eps-range scan -------------------------------------------

# a rank's per-query counter row in the range gather: the device scan's
# six columns, the host tail's six SearchStats increments, the overflow
_TAIL = ("chunks_visited", "envelopes_checked", "true_dist_computations",
         "dtw_lb_keogh", "dtw_full", "envelopes_pruned")


def sharded_range(shard: Shard, queries, n_real: int, qstack, dlo, dhi,
                  lbs, *, eps2: float, measure: str, r: int, capacity: int,
                  chunk_size: int):
    """One rank's half of the sharded eps-range scan over a padded batch
    whose first `n_real` rows are real queries.

    Returns (counters (P, n_real, 13) int64, hits, n_chunks): every
    rank's counters for each real query ([device scan's six, host tail's
    six, overflowed]) and `hits` a list over ranks of (m, 4) float64 rows
    (query row, global sid, off, d2), each rank's buffer hits then its
    host tail's, query by query; ED d2 are their owner's float64 rescore.
    """
    p = shard.params
    index, group = shard.index, shard.group
    env = index.envelopes
    b, dev = qstack.shape[0], qstack.device
    eps2_t = torch.full((b,), eps2, dtype=torch.float32, device=dev)
    n_pad = executor.pow2ceil(env.size)
    sids, anc, nm, lbs2, src = planner.device_range_pack(
        env.series_id, env.anchor, env.n_master, lbs, eps2_t, n_pad=n_pad)
    bd2, bsid, boff, cnt, ovf, st, chunk = executor.device_range_scan(
        index.collection, sids, anc, nm, lbs2, qstack, dlo, dhi, eps2_t,
        capacity=capacity, g=p.gamma + 1, measure=measure, r=r,
        znorm=p.znorm, chunk_size=chunk_size)
    bd2, bsid, boff, cnt, ovf, st = (
        t.cpu().numpy() for t in (bd2, bsid, boff, cnt, ovf, st))
    n_chunks = n_pad // chunk
    counters = np.zeros((n_real, 13), np.int64)
    hits: List[np.ndarray] = []
    gmap = shard.gmap
    src_h = lbs2_h = None
    for row in range(n_real):
        counters[row, :6] = st[row]
        c = int(cnt[row])
        rows = []
        if c:
            rows.append(np.stack([bsid[row, :c], boff[row, :c],
                                  bd2[row, :c]], axis=1).astype(np.float64))
        o = int(ovf[row])
        if o < n_chunks:        # the buffer overflowed: this rank's tail
            if src_h is None:   # read back on overflow only
                src_h = executor.to_host(src)
                lbs2_h = executor.to_host(lbs2).astype(np.float64)
            tail = SearchStats()
            with span("host_continuation", query=row, shard=shard.rank):
                pq = planner.prepare_query(queries[row], p, measure, r,
                                           device=dev)
                executor.range_host_tail(index, pq, src_h[row], lbs2_h[row],
                                         o * chunk, chunk, eps2, rows, tail)
            counters[row, 6:12] = [getattr(tail, f) for f in _TAIL]
            counters[row, 12] = 1
        if rows:
            got = np.concatenate(rows, axis=0)
            lsid = got[:, 0].astype(np.int64)
            if measure == "ed":
                got[:, 2] = executor.ed_rescore64(
                    shard.take_rows(lsid), np.arange(len(lsid)),
                    got[:, 1].astype(np.int64), queries[row], p.znorm)
            got[:, 0] = gmap[lsid]
            hits.append(np.concatenate(
                [np.full((len(got), 1), row, np.float64), got], axis=1))
    mine = (np.concatenate(hits) if hits else np.zeros((0, 4)))
    all_counters = collectives.all_gather(
        torch.from_numpy(counters).to(dev), group).cpu().numpy()
    all_hits = collectives.all_gather_rows(
        torch.from_numpy(mine).to(dev), group)
    return all_counters, [h.cpu().numpy() for h in all_hits], n_chunks


def fold_range_stats(counters, row: int, n_env: int,
                     chunks_planned: int) -> SearchStats:
    """A real query's SearchStats from every rank's range counters (sums
    over ranks; `shard_chunks` the device scan's chunks a rank)."""
    c = counters[:, row]
    return SearchStats(
        envelopes_total=n_env, lb_computations=n_env,
        chunks_visited=int(c[:, 0].sum() + c[:, 6].sum()),
        chunks_planned=chunks_planned,
        envelopes_checked=int(c[:, 1].sum() + c[:, 7].sum()),
        true_dist_computations=int(c[:, 2].sum() + c[:, 8].sum()),
        dtw_lb_keogh=int(c[:, 3].sum() + c[:, 9].sum()),
        dtw_full=int(c[:, 4].sum() + c[:, 10].sum()),
        envelopes_pruned=int(c[:, 5].sum() + c[:, 11].sum()),
        range_overflows=int(c[:, 12].sum()),
        shard_chunks=[int(x) for x in c[:, 0]])


def fold_knn_stats(stats, row: int, n_env: int,
                   chunks_planned: int) -> SearchStats:
    """A query's SearchStats from the (P, B, 6) counter stack (the
    reference's `_sharded_stats`)."""
    st = stats[:, row]
    return SearchStats(
        envelopes_total=n_env, lb_computations=n_env,
        chunks_visited=int(st[:, 0].sum()), chunks_planned=chunks_planned,
        envelopes_checked=int(st[:, 1].sum()),
        true_dist_computations=int(st[:, 2].sum()),
        dtw_lb_keogh=int(st[:, 3].sum()), dtw_full=int(st[:, 4].sum()),
        envelopes_pruned=int(st[:, 5].sum()),
        shard_chunks=[int(x) for x in st[:, 0]])


# -- the host backend (the reference's unpruned per-shard verify) ----------

def sharded_host_knn(shard: Shard, queries, k: int, verify_top: int):
    """Exact-ED k-NN candidates of same-bucket queries by the reference's
    per-shard verify: each rank takes its `verify_top` envelopes of least
    lower bound (`mindist_sym` over the query's segments, the lower index
    first on ties), verifies every offset of them through the contract
    entry of `fused_gather_ed` (float32, the dot identity), keeps its k
    best by distance, and all are gathered and merged.

    Returns (dists (n, k) float32 ascending, codes (n, k, 2) int64 global
    (sid, off), exact (n,) bool: the k-th distance <= the least, over
    ranks, of the largest verified bound).  Fewer gathered candidates than
    k pad with +inf and (0, 0), failing the certificate.
    """
    p = shard.params
    index, group, dev = shard.index, shard.group, shard.device
    env, coll = index.envelopes, index.collection
    g = p.gamma + 1
    n = shard.series_len
    vt = min(verify_top, env.size)
    kk = min(k, vt * g)
    payload = []
    for q in queries:
        pq = planner.prepare_query(q, p, "ed", 0, device=dev)
        lbs = planner.env_lower_bounds(pq.paa_lo, pq.paa_hi, env,
                                       index.breakpoints, p.seg_len,
                                       pq.nseg, False)
        cand = collectives.smallest(lbs, vt)
        csid, canc = env.series_id[cand], env.anchor[cand]
        d2 = fused_gather_ed(coll.data, coll.csum, coll.csum2, coll.csum_lo,
                             coll.csum2_lo, coll.center, csid, canc,
                             pq.q[None].contiguous(), g=g, rows=vt,
                             znorm=p.znorm)
        j = torch.arange(g, dtype=torch.int32, device=dev)
        offs = canc[:, None] + j
        ok = (j < env.n_master[cand][:, None]) & (offs + pq.qlen <= n)
        d = torch.sqrt(torch.where(ok, d2, _INF).clamp_min(0.0)).reshape(-1)
        sel = collectives.smallest(d, kk)
        gsid = (csid.long() + shard.row0).repeat_interleave(g)
        payload.append(torch.cat([
            d[sel].double(), gsid[sel].double(),
            offs.reshape(-1)[sel].double(), lbs[cand].max()[None].double()]))
    allp = collectives.all_gather(torch.stack(payload), group).cpu()
    all_d = collectives.tiled(allp[..., :kk].float())     # (n, P * kk)
    all_s = collectives.tiled(allp[..., kk:2 * kk].long())
    all_o = collectives.tiled(allp[..., 2 * kk:3 * kk].long())
    km = min(k, all_d.shape[1])
    sel = collectives.smallest(all_d, km)
    md = torch.full((len(queries), k), _INF)
    codes = torch.zeros((len(queries), k, 2), dtype=torch.int64)
    md[:, :km] = torch.gather(all_d, 1, sel)
    codes[:, :km, 0] = torch.gather(all_s, 1, sel)
    codes[:, :km, 1] = torch.gather(all_o, 1, sel)
    exact = md[:, -1] <= allp[..., 3 * kk].float().amin(0)
    return md.numpy(), codes.numpy(), exact.numpy()


def host_result_stats(shard: Shard, escalations: int,
                      verified_rows: int) -> SearchStats:
    """The host backend's SearchStats (the reference's
    `_distributed_result`)."""
    return SearchStats(
        envelopes_total=(shard.params.num_envelopes(shard.series_len)
                         * shard.num_series),
        envelopes_checked=verified_rows * shard.shards,
        escalations=escalations)

