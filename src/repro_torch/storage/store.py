"""Save / open whole local indexes (the storage subsystem's reader half).

`save_index` serializes a built `UlisseIndex` — main sorted envelopes,
block levels, breakpoints, row-sharded raw series, and the delta buffer
if one exists — under the atomic commit protocol of `format.py`, in the
JAX package's layout and dtypes (`ENV_FIELDS`, `LEVEL_FIELDS`), so each
package opens the other's saves.

`open_index` is the cold-open path: it reads the manifest and the
envelope and level payloads (the first lower bounds need them) onto the
engine's device, but wraps the raw series in a `PayloadStore`, so an open
costs O(index) I/O, not O(raw data); the series shards are mmap'd and
read only when verification first needs windows.

The distributed format (`save_distributed`, `load_distributed_sections`,
`load_raw_data`): per-shard main rows, delta rows with their global ids
and index sections, written by every rank of a process group for its own
shard and committed by rank 0; a group of the saved size reopens from
the sections, any other from the raw rows.
"""
from __future__ import annotations

import os
import shutil
import threading
import warnings
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.index import BlockLevel, UlisseIndex
from repro_torch.core.types import (ENVELOPE_FIELDS, Collection, DeviceLike,
                                    EnvelopeParams, EnvelopeSet, PageBlock,
                                    resolve_device)
from repro_torch.storage import format as fmt

# struct-of-arrays fields of an EnvelopeSet, in constructor order
ENV_FIELDS = ENVELOPE_FIELDS
LEVEL_FIELDS = ("paa_lo", "paa_hi", "valid")
SORT_ORDER = "isax_lo_lex_stable"   # (invalid, sym_lo[0..w)) stable lexsort

DEFAULT_PAGE_ROWS = 256             # series rows per payload page


class PayloadStore:
    """The tiered payload: fixed-size series-row pages over the stored
    shards, with an LRU page cache under byte accounting.

    Stands in for a `Collection` two ways:

      * whole-resident (`materialize()` / `.data` / `.csum` / ...): builds
        the real Collection on `device` at first touch — the one-page
        special case the engine uses when the payload fits
        `memory_budget_bytes`;
      * paged (`load_page` / `take_rows` / `read_rows`): `page_rows`-row
        `PageBlock`s on the host whose prefix sums come from the same
        `host_prefix_stats` as `Collection.from_array`'s, so paged answers
        are bit-equal to whole-resident ones.  Pages go through an LRU
        cache bounded by `cache_limit_bytes`; `stats()` gives monotone
        hit / miss / evicted-bytes counters.

    Sizes (`num_series`, `series_len`) and `device` need no I/O, and
    `to(device)` moves nothing: the store only remembers where to
    materialize.  `with_appended` queues appended rows on the host —
    O(new series), no shard read — and pages fold them in, so cold-open
    -> append -> search never reads the whole payload.

    `load_page` and `take_rows` are thread-safe: the paged scan's
    prefetch worker loads chunk t + 1's pages while chunk t runs.
    """

    def __init__(self, path: Optional[str], shards: List[dict],
                 num_series: int, series_len: int,
                 pending: Optional[list] = None,
                 page_rows: int = DEFAULT_PAGE_ROWS,
                 cache_limit_bytes: Optional[int] = None,
                 mem: Optional[np.ndarray] = None,
                 device: DeviceLike = None):
        self._path = path
        self._shards = list(shards)
        self._mem = mem
        self._num_stored = num_series
        self._series_len = series_len
        self._pending: list = list(pending or [])
        self._page_rows = int(page_rows)
        if self._page_rows < 1:
            raise ValueError("page_rows must be >= 1")
        self._device = resolve_device(device)
        self._coll: Optional[Collection] = None
        self._sources: Optional[list] = None
        self._lock = threading.RLock()
        self._cache: "OrderedDict[int, PageBlock]" = OrderedDict()
        self._cache_bytes = 0
        self._limit = cache_limit_bytes
        self._hits = 0
        self._misses = 0
        self._evicted_bytes = 0

    @classmethod
    def from_arrays(cls, data, page_rows: int = DEFAULT_PAGE_ROWS,
                    cache_limit_bytes: Optional[int] = None,
                    device: DeviceLike = None) -> "PayloadStore":
        """An in-memory paged store (tests): the same page and cache
        semantics, over one host array instead of shards."""
        arr = np.ascontiguousarray(data, np.float32)
        if arr.ndim == 1:
            arr = arr[None]
        return cls(None, [], arr.shape[0], arr.shape[1],
                   page_rows=page_rows, cache_limit_bytes=cache_limit_bytes,
                   mem=arr, device=device)

    def _replace(self, **kw) -> "PayloadStore":
        args = dict(path=self._path, shards=self._shards,
                    num_series=self._num_stored,
                    series_len=self._series_len, pending=self._pending,
                    page_rows=self._page_rows,
                    cache_limit_bytes=self._limit, mem=self._mem,
                    device=self._device)
        args.update(kw)
        return PayloadStore(**args)

    # -- shape and place (no I/O) ----------------------------------------

    @property
    def num_series(self) -> int:
        return self._num_stored + sum(p.shape[0] for p in self._pending)

    @property
    def series_len(self) -> int:
        return self._series_len

    @property
    def device(self) -> torch.device:
        return self._device

    def to(self, device: DeviceLike):
        """The store materializing on `device` (the Collection itself once
        materialized); nothing is read or moved."""
        dev = resolve_device(device)
        if self._coll is not None:
            return self._coll.to(dev)
        return self if dev == self._device else self._replace(device=dev)

    @property
    def is_materialized(self) -> bool:
        return self._coll is not None

    @property
    def page_rows(self) -> int:
        return self._page_rows

    @property
    def num_pages(self) -> int:
        return -(-self.num_series // self._page_rows)

    @property
    def payload_bytes(self) -> int:
        """Bytes of the whole paged payload (raw rows + the four (n + 1)
        prefix-sum planes + centers, all float32): what the engine holds
        against `memory_budget_bytes`."""
        s, n = self.num_series, self._series_len
        return 4 * (s * n + 4 * s * (n + 1) + s)

    # -- ingestion -------------------------------------------------------

    def with_appended(self, rows) -> "PayloadStore":
        """A new store with `rows` (S, n) appended on the host (O(new)).
        Its page cache starts empty: the boundary page changes when the
        pending rows fold into it."""
        rows = np.ascontiguousarray(rows, np.float32)
        if rows.ndim != 2 or rows.shape[1] != self._series_len:
            raise ValueError(
                f"appended series_len {rows.shape[-1]} != stored "
                f"series_len {self._series_len}")
        return self._replace(pending=self._pending + [rows])

    # -- row extents over shards + pending ---------------------------------

    def _extents(self) -> list:
        """[(start_row, rows_array)] covering [0, num_series): the mmap'd
        shards (opened once, lazily), then the pending parts."""
        if self._sources is None:
            exts: list = []
            start = 0
            if self._mem is not None:
                exts.append((0, self._mem))
                start = self._mem.shape[0]
            else:
                for e in self._shards:
                    exts.append((start, fmt.load_array(self._path, e,
                                                       mmap=True)))
                    start += int(e["shape"][0])
            for p in self._pending:
                exts.append((start, p))
                start += p.shape[0]
            self._sources = exts
        return self._sources

    def read_rows(self, lo: int, hi: int) -> np.ndarray:
        """Raw rows [lo, hi) as one (hi - lo, n) float32 block: a view when
        one extent holds them, else one preallocated copy (never a
        concatenation)."""
        exts = self._extents()
        for start, arr in exts:
            if start <= lo and hi <= start + arr.shape[0]:
                return arr[lo - start:hi - start]
        out = np.empty((hi - lo, self._series_len), np.float32)
        for start, arr in exts:
            a = max(lo, start)
            b = min(hi, start + arr.shape[0])
            if a < b:
                out[a - lo:b - lo] = arr[a - start:b - start]
        return out

    # -- the page cache ----------------------------------------------------

    def load_page(self, p: int) -> PageBlock:
        """Page `p` (rows [p * R, (p + 1) * R)), through the LRU cache.

        The block is built (shard read + prefix sums) outside the lock, so
        a prefetch worker's load overlaps the consumer's hits.  A block
        larger than the whole budget is returned uncached: `cache_bytes`
        never exceeds the limit.
        """
        with self._lock:
            blk = self._cache.get(p)
            if blk is not None:
                self._hits += 1
                self._cache.move_to_end(p)
                return blk
        lo = p * self._page_rows
        hi = min(lo + self._page_rows, self.num_series)
        if not 0 <= lo < hi:
            raise IndexError(f"page {p} outside [0, {self.num_pages})")
        blk = PageBlock.from_rows(lo, self.read_rows(lo, hi))
        with self._lock:
            self._misses += 1
            raced = self._cache.get(p)
            if raced is not None:
                return raced
            if self._limit is None or blk.nbytes <= self._limit:
                while (self._limit is not None and self._cache
                       and self._cache_bytes + blk.nbytes > self._limit):
                    _, old = self._cache.popitem(last=False)
                    self._cache_bytes -= old.nbytes
                    self._evicted_bytes += old.nbytes
                self._cache[p] = blk
                self._cache_bytes += blk.nbytes
            return blk

    def take_rows(self, sids) -> np.ndarray:
        """Raw rows of (possibly unsorted) global series ids, through the
        page cache: (len(sids), n) float32 on the host."""
        sids = np.asarray(sids, np.int64).ravel()
        out = np.empty((sids.size, self._series_len), np.float32)
        pages = sids // self._page_rows
        for p in np.unique(pages):
            blk = self.load_page(int(p))
            m = pages == p
            out[m] = blk.data[sids[m] - blk.start]
        return out

    @property
    def cache_bytes(self) -> int:
        with self._lock:
            return self._cache_bytes

    @property
    def cache_limit_bytes(self) -> Optional[int]:
        return self._limit

    @cache_limit_bytes.setter
    def cache_limit_bytes(self, limit: Optional[int]) -> None:
        with self._lock:
            self._limit = limit
            while (limit is not None and self._cache
                   and self._cache_bytes > limit):
                _, old = self._cache.popitem(last=False)
                self._cache_bytes -= old.nbytes
                self._evicted_bytes += old.nbytes

    def reset_cache(self) -> None:
        """Drop every cached page; the monotone counters stay."""
        with self._lock:
            self._cache.clear()
            self._cache_bytes = 0

    def stats(self) -> Dict[str, int]:
        """{hits, misses, evicted_bytes, cache_bytes, cached_pages}: the
        first three monotone, the rest gauges."""
        with self._lock:
            return {"hits": self._hits, "misses": self._misses,
                    "evicted_bytes": self._evicted_bytes,
                    "cache_bytes": self._cache_bytes,
                    "cached_pages": len(self._cache)}

    # -- whole-resident special case (the Collection stand-in) -------------

    def materialize(self) -> Collection:
        """The full Collection on `device`, built at first touch.  Rows are
        copied extent by extent into one preallocated array; one extent is
        handed over with no host copy (on the CPU the Collection's `data`
        then shares the mmap)."""
        if self._coll is None:
            exts = self._extents()
            if len(exts) == 1:
                data = exts[0][1]
            else:
                data = np.empty((self.num_series, self._series_len),
                                np.float32)
                for start, arr in exts:
                    data[start:start + arr.shape[0]] = arr
            with warnings.catch_warnings():
                # an mmap'd shard is read-only; the Collection never
                # writes its data
                warnings.filterwarnings("ignore", message=".*not writable")
                self._coll = Collection.from_array(data, device=self._device)
        return self._coll

    @property
    def data(self):
        return self.materialize().data

    @property
    def csum(self):
        return self.materialize().csum

    @property
    def csum2(self):
        return self.materialize().csum2

    @property
    def csum_lo(self):
        return self.materialize().csum_lo

    @property
    def csum2_lo(self):
        return self.materialize().csum2_lo

    @property
    def center(self):
        return self.materialize().center


# the JAX package's older name, which it still exports
LazyCollection = PayloadStore


def _host(t) -> np.ndarray:
    return t.cpu().numpy()


def _save_envelope_set(tmp: str, group: str, env: EnvelopeSet,
                       arrays: dict) -> None:
    for field in ENV_FIELDS:
        rel = f"{group}/{field}"
        arrays[rel] = fmt.save_array(tmp, rel, _host(getattr(env, field)))


def _load(path: str, entry: dict, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(fmt.load_array(path, entry)).to(dev)


def _load_envelope_set(path: str, group: str, arrays: dict,
                       dev: torch.device) -> EnvelopeSet:
    return EnvelopeSet(**{field: _load(path, arrays[f"{group}/{field}"], dev)
                          for field in ENV_FIELDS})


def save_index(path: str, index: UlisseIndex, shard_rows: int = 4096,
               page_rows: int = DEFAULT_PAGE_ROWS) -> str:
    """Serialize a local index to `path` (atomically); returns `path`.

    An unmaterialized `PayloadStore` is streamed shard block by shard
    block through `read_rows`: saving a paged index never materializes
    the payload.  The manifest records the page table (`page_rows`).
    """
    p: EnvelopeParams = index.params
    tmp = fmt.stage_dir(path, "envelopes", "levels", "collection")
    arrays: dict = {}

    _save_envelope_set(tmp, "envelopes", index.envelopes, arrays)
    for k, lvl in enumerate(index.levels):
        for field in LEVEL_FIELDS:
            rel = f"levels/L{k}_{field}"
            arrays[rel] = fmt.save_array(tmp, rel, _host(getattr(lvl, field)))
    arrays["breakpoints"] = fmt.save_array(tmp, "breakpoints",
                                           _host(index.breakpoints))
    if index.delta is not None:
        os.makedirs(os.path.join(tmp, "delta"), exist_ok=True)
        _save_envelope_set(tmp, "delta", index.delta, arrays)

    coll = index.collection
    if isinstance(coll, PayloadStore) and not coll.is_materialized:
        total, series_len = coll.num_series, coll.series_len
        blocks = (coll.read_rows(start, min(start + shard_rows, total))
                  for start in range(0, total, shard_rows))
    else:
        data = _host(coll.data)
        total, series_len = data.shape
        blocks = (data[start:start + shard_rows]
                  for start in range(0, total, shard_rows))
    shards = []
    for block in blocks:
        rel = f"collection/shard_{len(shards):05d}"
        shards.append(fmt.save_array(tmp, rel, block))

    fmt.write_manifest(tmp, {
        "kind": fmt.KIND_LOCAL,
        "params": fmt.params_to_dict(p),
        "sort_order": SORT_ORDER,
        "block_size": index.block_size,
        "num_levels": index.num_levels,
        "num_envelopes": index.envelopes.size,
        "num_series": int(total),
        "series_len": int(series_len),
        "has_delta": index.delta is not None,
        "arrays": arrays,
        "collection_shards": shards,
        "page_table": {"page_rows": int(page_rows),
                       "num_pages": -(-int(total) // int(page_rows))},
    })
    return fmt.commit(path)


def open_index(path: str, params: Optional[EnvelopeParams] = None,
               mmap: bool = True, device: DeviceLike = None) -> UlisseIndex:
    """Open a saved local index on `device` (default CUDA); the raw series
    load lazily (see the module docstring), or at once when `mmap` is
    False.

    params: when given, validated against the stored EnvelopeParams — a
    mismatch raises IndexCompatibilityError instead of returning an
    engine that computes wrong distances.
    """
    dev = resolve_device(device)
    fmt.gc_stale_tmp(path)
    manifest = fmt.read_manifest(path)
    if manifest["kind"] != fmt.KIND_LOCAL:
        raise fmt.IndexFormatError(
            f"{path!r} holds a {manifest['kind']!r} index; open it with "
            "UlisseEngine.open(path, mesh=...)")
    stored = fmt.params_from_dict(manifest["params"])
    fmt.validate_params(stored, params)
    arrays = manifest["arrays"]

    env = _load_envelope_set(path, "envelopes", arrays, dev)
    if env.w != stored.w:
        raise fmt.IndexFormatError(
            f"envelope payload has {env.w} PAA segments, params imply "
            f"{stored.w} — index is corrupt")
    levels = [BlockLevel(*(_load(path, arrays[f"levels/L{k}_{field}"], dev)
                           for field in LEVEL_FIELDS))
              for k in range(manifest["num_levels"])]
    delta = (_load_envelope_set(path, "delta", arrays, dev)
             if manifest.get("has_delta") else None)
    page_rows = (manifest.get("page_table") or {}).get(
        "page_rows", DEFAULT_PAGE_ROWS)
    collection = PayloadStore(path, manifest["collection_shards"],
                              manifest["num_series"], manifest["series_len"],
                              page_rows=page_rows, device=dev)
    if not mmap:
        collection = collection.materialize()
    return UlisseIndex(
        envelopes=env, levels=levels, collection=collection,
        breakpoints=_load(path, arrays["breakpoints"], dev),
        params=stored, delta=delta)


# --------------------------------------------------------------------------
# distributed indexes (per-shard raw payloads, one shard a rank)
# --------------------------------------------------------------------------

def _fail_all(errors: list, path: str, mine) -> None:
    """Raise on every rank once any rank failed a step of a save: the
    failing rank its own error, the others one naming it."""
    if mine is not None:
        raise mine
    rank, msg = next((r, m) for r, m in enumerate(errors) if m is not None)
    raise OSError(f"distributed save to {path!r} failed on rank {rank}: "
                  f"{msg}")


def save_distributed(path: str, params: EnvelopeParams, breakpoints,
                     main_rows, *, group=None, device: DeviceLike = None,
                     axes=("data",), max_batch: int = 8, delta_rows=None,
                     delta_gmap=None, section: Optional[dict] = None) -> str:
    """A distributed engine's save, in the JAX package's layout: every
    rank of `group` calls it with its own shard's arrays (SPMD) and writes
    only its own files.

      shards/shard_{s:05d}            the rank's (S / P, n) MAIN rows;
      delta/shard_{s:05d}, ..._gmap   its uncompacted delta rows and their
                                      GLOBAL ids (append parts interleave
                                      the ranks: the map is not affine);
      index/shard_{s:05d}_{field}     its INDEX_SECTION_FIELDS over the
                                      [main; delta] block (envelope rows
                                      and prefix sums, series ids local):
                                      the next open on a group of this
                                      size reads them, summarizing nothing.

    The protocol: rank 0 stages `<path>.tmp/`; every rank waits for it;
    each writes its files; an all-reduce of every rank's success flag (a
    failure anywhere fails the save on every rank and commits nothing:
    rank 0 removes the staging); rank 0 writes the manifest from every
    rank's file table and commits (`fmt.commit`, the atomic rename); a
    last all-reduce of rank 0's outcome, so every rank returns or raises
    together.  Every rank sees the same file system.
    """
    from repro_torch.distributed import collectives
    from repro_torch.distributed.ulisse import INDEX_SECTION_FIELDS
    shards, rank = collectives.world(group)
    delta_rows = (np.zeros((0, main_rows.shape[1]), np.float32)
                  if delta_rows is None else delta_rows)
    has_delta = len(delta_rows) > 0        # the same on every rank
    dirs = ["shards"] + (["delta"] if has_delta else []) \
        + (["index"] if section is not None else [])
    tmp = fmt.tmp_path(path)

    def step(fn):
        """Run `fn` and agree on the outcome with every rank."""
        err = out = None
        try:
            out = fn()
        except Exception as e:  # noqa: BLE001 — every rank must hear it
            err = e
        if not collectives.agree(err is None, group, device):
            errors = collectives.all_gather_object(
                None if err is None else repr(err), group, device)
            if rank == 0:
                shutil.rmtree(tmp, ignore_errors=True)
            _fail_all(errors, path, err)
        return out

    step(lambda: fmt.stage_dir(path, *dirs) if rank == 0 else None)

    def write_mine():
        rel = f"shards/shard_{rank:05d}"
        shard = fmt.save_array(tmp, rel, np.asarray(main_rows, np.float32))
        arrays = {}
        if has_delta:
            rel = f"delta/shard_{rank:05d}"
            arrays[rel] = fmt.save_array(tmp, rel, np.asarray(delta_rows,
                                                              np.float32))
            arrays[rel + "_gmap"] = fmt.save_array(
                tmp, rel + "_gmap", np.asarray(delta_gmap, np.int64))
        if section is not None:
            for field in INDEX_SECTION_FIELDS:
                rel = f"index/shard_{rank:05d}_{field}"
                arrays[rel] = fmt.save_array(tmp, rel, section[field])
        return shard, arrays

    mine = step(write_mine)
    tables = collectives.all_gather_object(mine, group, device)

    def commit():
        if rank != 0:
            return None
        arrays = {"breakpoints": fmt.save_array(tmp, "breakpoints",
                                                np.asarray(breakpoints))}
        for _, a in tables:
            arrays.update(a)
        fmt.write_manifest(tmp, {
            "kind": fmt.KIND_DISTRIBUTED,
            "params": fmt.params_to_dict(params),
            "num_series": int(sum(t[0]["shape"][0] for t in tables)),
            "series_len": int(tables[0][0]["shape"][1]),
            "axes": list(axes),
            "max_batch": max_batch,
            "delta_rows_per_shard": int(len(delta_rows)),
            "index_sections": section is not None,
            "arrays": arrays,
            "collection_shards": [t[0] for t in tables],
        })
        return fmt.commit(path)

    step(commit)
    return path


def load_distributed_sections(path: str, shard: int,
                              params: Optional[EnvelopeParams] = None):
    """The O(index) cold-open payload of shard `shard` of a distributed
    save, or None.

    Returns (params, breakpoints, manifest, main, delta, delta_gmap,
    section): main and delta mmap handles (no payload byte read), the
    delta ids read, section a dict of mmap'd INDEX_SECTION_FIELDS arrays.
    None when `path` holds a local index or a distributed save without
    sections (callers then fall back to `load_raw_data`).  The caller
    runs the crash recovery (`fmt.gc_stale_tmp`) first: a group's rank 0
    alone, while the others wait.
    """
    from repro_torch.distributed.ulisse import INDEX_SECTION_FIELDS
    manifest = fmt.read_manifest(path)
    if (manifest["kind"] != fmt.KIND_DISTRIBUTED
            or not manifest.get("index_sections")):
        return None
    stored = fmt.params_from_dict(manifest["params"])
    fmt.validate_params(stored, params)
    arrays = manifest["arrays"]
    main = fmt.load_array(path, manifest["collection_shards"][shard],
                          mmap=True)
    key = f"delta/shard_{shard:05d}"
    if key in arrays:
        delta = fmt.load_array(path, arrays[key], mmap=True)
        gmap = np.asarray(fmt.load_array(path, arrays[f"{key}_gmap"]),
                          np.int64)
    else:
        delta = np.zeros((0, int(manifest["series_len"])), np.float32)
        gmap = np.zeros((0,), np.int64)
    section = {f: fmt.load_array(
        path, arrays[f"index/shard_{shard:05d}_{f}"], mmap=True)
        for f in INDEX_SECTION_FIELDS}
    bp = fmt.load_array(path, arrays["breakpoints"])
    return stored, bp, manifest, main, delta, gmap, section


def load_raw_data(path: str, params: Optional[EnvelopeParams] = None):
    """Raw series + params + breakpoints from an index of EITHER kind:
    the re-sharding entry point (a distributed engine restored on a group
    of any size, or a local index promoted to a distributed one).
    Uncompacted delta rows of a distributed save fold back in at their
    recorded GLOBAL ids, so re-sharding keeps every appended series.
    Returns (params, breakpoints, data, manifest); the caller runs the
    crash recovery first, as for `load_distributed_sections`."""
    manifest = fmt.read_manifest(path)
    stored = fmt.params_from_dict(manifest["params"])
    fmt.validate_params(stored, params)
    arrays = manifest["arrays"]
    parts = [fmt.load_array(path, e, mmap=True)
             for e in manifest["collection_shards"]]
    d = int(manifest.get("delta_rows_per_shard", 0))
    total = sum(p.shape[0] for p in parts) + d * len(parts)
    data = np.empty((total, int(manifest["series_len"])), np.float32)
    start = 0
    for part in parts:
        data[start:start + part.shape[0]] = part
        start += part.shape[0]
    for s in range(len(parts) if d else 0):
        key = f"delta/shard_{s:05d}"
        gmap = np.asarray(fmt.load_array(path, arrays[f"{key}_gmap"]))
        data[gmap] = fmt.load_array(path, arrays[key], mmap=True)
    bp = fmt.load_array(path, arrays["breakpoints"])
    return stored, bp, data, manifest
