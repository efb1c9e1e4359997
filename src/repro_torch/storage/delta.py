"""Incremental ingestion: the delta + compaction model.

New series land in two places:

  * their raw rows extend the collection at once (verification must be
    able to gather their windows);
  * their envelopes land in `index.delta`, an unsorted EnvelopeSet
    appended with `concat_envelope_sets` — O(new), no re-sort, no block
    rebuild.  The engine searches main ++ delta as one candidate set
    (`UlisseIndex.search_envelopes`), so appended series are searchable
    the moment `append` returns.

The delta envelopes come from the port's `build_envelope_set` with the
index's breakpoints (on the card: the `envelope_znorm` kernel).
`compact_index` folds the delta into the main sorted set and rebuilds
the block levels.  The main set was sorted stably (equal iSAX keys in
(series, anchor) order) and delta series ids are larger than every main
id, so re-sorting `main_valid ++ delta` stably equals `build_index` over
the concatenated collection in every field and level (tested in
tests/test_torch_storage.py).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.envelope import build_envelope_set
from repro_torch.core.index import UlisseIndex, index_from_envelopes
from repro_torch.core.types import (Collection, concat_collections,
                                    concat_envelope_sets)
from repro_torch.storage.store import PayloadStore


def as_series_rows(series, series_len: int) -> np.ndarray:
    """`series` — one (n,) series or an (S, n) batch — as an (S, n)
    float32 array; raises ValueError unless n equals `series_len`."""
    arr = np.asarray(series, np.float32)
    if arr.ndim == 1:
        arr = arr[None]
    if arr.ndim != 2:
        raise ValueError(f"expected (n,) or (S, n) series, got {arr.shape}")
    if arr.shape[1] != series_len:
        raise ValueError(
            f"appended series_len {arr.shape[1]} != index series_len "
            f"{series_len} (collections are fixed-width)")
    return arr


def extend_index(index: UlisseIndex, series) -> UlisseIndex:
    """Append new series: the extended collection + delta envelopes.

    Returns a new UlisseIndex (the main envelopes and levels are shared,
    not copied); the input index is unchanged.
    """
    coll = index.collection
    arr = as_series_rows(series, coll.series_len)
    new_part = Collection.from_array(arr, device=index.device)
    env_new = build_envelope_set(new_part, index.params, index.breakpoints)
    env_new = dataclasses.replace(
        env_new, series_id=env_new.series_id + coll.num_series)
    delta = env_new if index.delta is None else \
        concat_envelope_sets([index.delta, env_new])
    if isinstance(coll, PayloadStore) and not coll.is_materialized:
        # cold-open index: queue the rows without touching the payload on
        # disk, so append stays O(new series)
        coll = coll.with_appended(arr)
    else:
        coll = concat_collections(coll, new_part)
    return dataclasses.replace(index, collection=coll, delta=delta)


def compact_index(index: UlisseIndex) -> UlisseIndex:
    """Merge the delta into the main sorted set and rebuild the levels
    (a no-op without a delta): equal to `build_index` over the whole
    collection with the index's breakpoints (module docstring)."""
    if index.delta is None:
        return index
    nvalid = int(index.envelopes.valid.sum())
    # the stable sort pushed invalid and padding rows past the valid prefix
    main = index.envelopes.map(lambda x: x[:nvalid])
    env_all = concat_envelope_sets([main, index.delta])
    return index_from_envelopes(
        env_all, index.collection, index.params, index.breakpoints,
        block_size=index.block_size, num_levels=index.num_levels)
