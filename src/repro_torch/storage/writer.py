"""Out-of-core index construction: the accelerator analogue of the
paper's one-pass bulk loader (§5.2), in the JAX package's on-disk format.

`Writer` streams series through chunked envelope extraction with bounded
memory: every `chunk_series` appended series become one *iSAX-sorted
run*, built on the writer's device (CUDA unless it is given
device="cpu"; on the card the envelopes come from `envelope_znorm`) and
spilled to disk (the raw rows are spilled too, and become the final
collection shards verbatim — bulk data is written exactly once).
`finalize()` merge-sorts the runs by iSAX(L) key and commits the index
directory atomically.

The merge is key-driven, not a heap walk: the (small) sort keys of all
runs — `(invalid, sym_lo[0..w))`, a few bytes per envelope — are
concatenated and stably lexsorted on the host, then the (large) float
payloads are gathered from the mmap'd runs into the final layout in
bounded chunks.  Each run was itself stably sorted and runs are
concatenated in ingestion order, so the stable global sort of the runs
equals the stable sort of the raw ingestion order: given the same
breakpoints the Writer's output equals `build_index` over the same
series (tested in tests/test_torch_storage.py).  Breakpoints match
automatically in Z-normalized mode (data-independent Gaussian quantiles)
or when passed explicitly; in raw (znorm=False) mode the Writer
calibrates on the FIRST chunk only — pin `breakpoints=` for raw builds
that must be reproducible.  Peak memory is O(total envelopes * key
bytes + merge chunk), never O(raw series).
"""
from __future__ import annotations

import dataclasses
import os
import shutil
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.envelope import build_envelope_set
from repro_torch.core.index import (PAD_FILL, _sort_envelopes,
                                    default_breakpoints)
from repro_torch.core.types import (Collection, DeviceLike, EnvelopeParams,
                                    resolve_device)
from repro_torch.storage import format as fmt
from repro_torch.storage.store import ENV_FIELDS, SORT_ORDER


class Writer:
    """Streaming bulk build of a persistent index (bounded memory).

        w = Writer(path, params)
        for chunk in series_source:     # any number of series / chunks
            w.append(chunk)
        engine = UlisseEngine.from_writer(w)    # finalize + open

    All staging happens inside `<path>.tmp/`; the index appears at
    `<path>` only on a successful `finalize()` (atomic rename).  A
    crashed Writer leaves a `*.tmp/` husk that the next Writer or
    `open` GCs.  Incremental ingestion into an already-open engine goes
    through `engine.append` / `engine.compact` (storage/delta.py)
    instead — the delta path is in-memory and immediately searchable.
    """

    def __init__(self, path: str, params: EnvelopeParams, *,
                 breakpoints=None, block_size: int = 64,
                 num_levels: int = 2, chunk_series: int = 256,
                 merge_rows: int = 1 << 16, device: DeviceLike = None):
        self.path = path
        self.params = params
        self.block_size = block_size
        self.num_levels = num_levels
        self.chunk_series = chunk_series
        self.merge_rows = merge_rows
        self.device = resolve_device(device)
        self._breakpoints = (None if breakpoints is None
                             else torch.as_tensor(breakpoints,
                                                  dtype=torch.float32,
                                                  device=self.device))
        fmt.gc_stale_tmp(path)
        self._tmp = fmt.stage_dir(path, "runs", "envelopes", "levels",
                                  "collection")
        self._buffer: List[np.ndarray] = []
        self._buffered = 0
        self._series_len: Optional[int] = None
        self._num_series = 0
        self._run_rows: List[int] = []
        self._shards: List[dict] = []
        self._finalized = False

    @property
    def num_series(self) -> int:
        """Series accepted so far (buffered + spilled)."""
        return self._num_series + self._buffered

    def append(self, series) -> int:
        """Stream one series (n,) or a batch (S, n) into the build.

        Returns the number of series accepted.  Spills a sorted run to
        disk whenever `chunk_series` rows have accumulated.
        """
        if self._finalized:
            raise RuntimeError("Writer already finalized; open the index "
                               "and use engine.append for ingestion")
        arr = np.asarray(series, np.float32)
        if arr.ndim == 1:
            arr = arr[None]
        if arr.ndim != 2:
            raise ValueError(f"expected (n,) or (S, n) series, got "
                             f"shape {arr.shape}")
        if self._series_len is None:
            if arr.shape[1] < self.params.lmin:
                raise ValueError(
                    f"series_len={arr.shape[1]} shorter than "
                    f"lmin={self.params.lmin}")
            self._series_len = arr.shape[1]
        elif arr.shape[1] != self._series_len:
            raise ValueError(
                f"series_len {arr.shape[1]} != first chunk's "
                f"{self._series_len} (collections are fixed-width)")
        self._buffer.append(arr)
        self._buffered += arr.shape[0]
        while self._buffered >= self.chunk_series:
            self._spill()
        return arr.shape[0]

    def _take_chunk(self) -> np.ndarray:
        rows = np.concatenate(self._buffer) if len(self._buffer) > 1 \
            else self._buffer[0]
        chunk, rest = rows[:self.chunk_series], rows[self.chunk_series:]
        self._buffer = [rest] if rest.shape[0] else []
        self._buffered = rest.shape[0]
        return chunk

    def _spill(self) -> None:
        """One sorted run + one collection shard from the buffered rows."""
        chunk = self._take_chunk()
        coll = Collection.from_array(chunk, device=self.device)
        if self._breakpoints is None:
            # raw (non-Z-norm) mode calibrates on the first chunk — the
            # streaming deviation from default_breakpoints' whole-
            # collection sample; pass breakpoints= to pin them exactly.
            self._breakpoints = default_breakpoints(self.params, coll.data)
        env = build_envelope_set(coll, self.params, self._breakpoints)
        env = dataclasses.replace(
            env, series_id=env.series_id + self._num_series)
        env = _sort_envelopes(env)
        run = len(self._run_rows)
        for field in ENV_FIELDS:
            np.save(os.path.join(self._tmp, "runs",
                                 f"run_{run:05d}.{field}.npy"),
                    getattr(env, field).cpu().numpy())
        rel = f"collection/shard_{run:05d}"
        self._shards.append(fmt.save_array(self._tmp, rel, chunk))
        self._run_rows.append(env.size)
        self._num_series += chunk.shape[0]

    # ------------------------------------------------------------------
    # finalize: k-way merge of sorted runs by iSAX key
    # ------------------------------------------------------------------

    def _run_mmap(self, run: int, field: str):
        return np.load(os.path.join(self._tmp, "runs",
                                    f"run_{run:05d}.{field}.npy"),
                       mmap_mode="r")

    def _merge_order(self) -> np.ndarray:
        """Stable global order over the concatenated runs' sort keys."""
        keys = [np.concatenate([
            (~np.asarray(self._run_mmap(r, "valid"))).astype(np.int32)
            for r in range(len(self._run_rows))])]
        w = self.params.w
        for c in range(w):
            keys.append(np.concatenate([
                np.asarray(self._run_mmap(r, "sym_lo")[:, c])
                for r in range(len(self._run_rows))]))
        # np.lexsort: last key is primary -> reverse so the invalid flag
        # leads, then sym_lo[0..w) — the exact key _sort_envelopes uses
        return np.lexsort(tuple(reversed(keys)))

    def _gather(self, field: str, idxs: np.ndarray,
                run_offsets: np.ndarray) -> np.ndarray:
        """Rows `idxs` (global positions) of a field across all runs."""
        rid = np.searchsorted(run_offsets, idxs, side="right") - 1
        local = idxs - run_offsets[rid]
        out = None
        for r in np.unique(rid):
            m = rid == r
            vals = np.asarray(self._run_mmap(r, field)[local[m]])
            if out is None:
                out = np.empty((len(idxs),) + vals.shape[1:], vals.dtype)
            out[m] = vals
        return out

    def finalize(self) -> str:
        """Merge runs, build block levels, commit atomically."""
        if self._finalized:
            return self.path
        if self._buffered:
            self._spill()
        if not self._run_rows:
            raise ValueError("cannot finalize an empty Writer — append "
                             "at least one series first")
        order = self._merge_order()
        total = len(order)
        multiple = self.block_size ** max(self.num_levels, 1)
        padded = -(-total // multiple) * multiple
        run_offsets = np.concatenate(
            [[0], np.cumsum(self._run_rows)[:-1]]).astype(np.int64)

        arrays: dict = {}
        outs = {}
        for field in ENV_FIELDS:
            sample = self._run_mmap(0, field)
            shape = (padded,) + sample.shape[1:]
            out = np.lib.format.open_memmap(
                os.path.join(self._tmp, "envelopes", f"{field}.npy"),
                mode="w+", dtype=sample.dtype, shape=shape)
            if padded > total:
                out[total:] = PAD_FILL[field]
            for start in range(0, total, self.merge_rows):
                sel = order[start:start + self.merge_rows]
                out[start:start + len(sel)] = self._gather(
                    field, sel, run_offsets)
            arrays[f"envelopes/{field}"] = {
                "file": f"envelopes/{field}.npy",
                "shape": list(shape), "dtype": str(sample.dtype)}
            outs[field] = out

        self._write_levels(outs, padded, arrays)
        arrays["breakpoints"] = fmt.save_array(
            self._tmp, "breakpoints", self._breakpoints.cpu().numpy())
        fmt.write_manifest(self._tmp, {
            "kind": fmt.KIND_LOCAL,
            "params": fmt.params_to_dict(self.params),
            "sort_order": SORT_ORDER,
            "block_size": self.block_size,
            "num_levels": self.num_levels,
            "num_envelopes": padded,
            "num_series": self._num_series,
            "series_len": self._series_len,
            "has_delta": False,
            "arrays": arrays,
            "collection_shards": self._shards,
        })
        for f in outs.values():      # flush memmaps before the rename
            f.flush()
        del outs
        shutil.rmtree(os.path.join(self._tmp, "runs"))
        fmt.commit(self.path)
        self._finalized = True
        return self.path

    def _write_levels(self, env_out: dict, padded: int,
                      arrays: dict) -> None:
        """Block levels, finest first from the on-disk envelope memmaps
        (chunked — never loads the full float payload), coarser levels
        from the (small) previous level in memory."""
        bs = self.block_size
        lo, hi, valid = env_out["paa_lo"], env_out["paa_hi"], \
            env_out["valid"]
        fine_to_coarse = []
        for _ in range(self.num_levels):
            nb = lo.shape[0] // bs
            w = lo.shape[1]
            nlo = np.empty((nb, w), np.float32)
            nhi = np.empty((nb, w), np.float32)
            nva = np.empty((nb,), bool)
            step = max(self.merge_rows // bs, 1)
            for b0 in range(0, nb, step):
                b1 = min(b0 + step, nb)
                sl = slice(b0 * bs, b1 * bs)
                nlo[b0:b1] = np.asarray(lo[sl]).reshape(-1, bs, w).min(1)
                nhi[b0:b1] = np.asarray(hi[sl]).reshape(-1, bs, w).max(1)
                nva[b0:b1] = np.asarray(valid[sl]).reshape(-1, bs).any(1)
            fine_to_coarse.append((nlo, nhi, nva))
            lo, hi, valid = nlo, nhi, nva
        for k, (nlo, nhi, nva) in enumerate(reversed(fine_to_coarse)):
            for field, val in zip(("paa_lo", "paa_hi", "valid"),
                                  (nlo, nhi, nva)):
                rel = f"levels/L{k}_{field}"
                arrays[rel] = fmt.save_array(self._tmp, rel, val)

    def abort(self) -> None:
        """Drop the staged build (removes `<path>.tmp/`)."""
        fmt.gc_stale_tmp(self.path)
        self._finalized = True
