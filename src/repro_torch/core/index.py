"""The ULISSE index (paper §5) — accelerator layout, as in the JAX package.

  level 0:  the flat EnvelopeSet, lexicographically sorted by iSAX(L),
            padded to a multiple of block_size ** num_levels;
  level 1+: dense *block* levels: block b at level k is the elementwise
            union (min-L / max-U) of its children — the envelope-union
            invariant a ULISSE inner node maintains on its subtree.

Best-first tree descent becomes batched ordering over block lower bounds;
union(envelopes) only widens intervals, so mindist(block) <=
mindist(member).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from repro_torch.core import isax
from repro_torch.core.envelope import build_envelope_set
from repro_torch.core.paa import paa
from repro_torch.core.types import (DeviceLike, Collection, EnvelopeParams,
                                    EnvelopeSet, concat_envelope_sets,
                                    resolve_device)


@dataclasses.dataclass
class BlockLevel:
    """One dense inner level: (Nb, w) envelope unions over child ranges."""

    paa_lo: torch.Tensor   # (Nb, w)
    paa_hi: torch.Tensor   # (Nb, w)
    valid: torch.Tensor    # (Nb,) any child valid

    @property
    def size(self) -> int:
        return self.paa_lo.shape[0]

    def to(self, device) -> "BlockLevel":
        return BlockLevel(self.paa_lo.to(device), self.paa_hi.to(device),
                          self.valid.to(device))


@dataclasses.dataclass
class UlisseIndex:
    """Sorted envelope array + block hierarchy + the raw collection.

    `delta` is the unsorted ingestion buffer (`repro_torch.storage`):
    envelopes of series appended since the last build or `compact`.  The
    search treats main ++ delta as one candidate set
    (`search_envelopes`); the block hierarchy covers main only, so the
    approximate pass sweeps the delta whole.  `collection` is a
    `Collection` or a lazy `storage.PayloadStore` standing in for one.
    """

    envelopes: EnvelopeSet            # sorted by iSAX(L), padded
    levels: List[BlockLevel]          # coarse -> fine (levels[-1] is finest)
    collection: Collection
    breakpoints: torch.Tensor         # (card-1,)
    params: EnvelopeParams = None
    delta: Optional[EnvelopeSet] = None   # unsorted ingestion buffer

    @property
    def num_envelopes(self) -> int:
        return self.envelopes.size

    @property
    def block_size(self) -> int:
        """Children per block (uniform across levels)."""
        if not self.levels:
            return self.envelopes.size
        return self.envelopes.size // self.levels[-1].size

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    @property
    def device(self) -> torch.device:
        return self.collection.device

    def search_envelopes(self) -> EnvelopeSet:
        """The full candidate set: the main sorted envelopes ++ the delta.

        Rows [0, envelopes.size) are the sorted (padded) main set — block
        b covers rows [b * block_size, (b + 1) * block_size) of this set
        too — and rows [envelopes.size, ...) the unsorted delta.  The
        concatenation is cached until the delta is replaced.
        """
        if self.delta is None:
            return self.envelopes
        cached = getattr(self, "_combined_cache", None)
        if cached is None or cached[0] is not self.delta:
            cached = (self.delta,
                      concat_envelope_sets([self.envelopes, self.delta]))
            self._combined_cache = cached
        return cached[1]

    def to(self, device: DeviceLike) -> "UlisseIndex":
        """The index on `device`; a lazy collection stays lazy."""
        dev = resolve_device(device)
        return UlisseIndex(
            envelopes=self.envelopes.map(lambda x: x.to(dev)),
            levels=[lvl.to(dev) for lvl in self.levels],
            collection=self.collection.to(dev),
            breakpoints=self.breakpoints.to(dev), params=self.params,
            delta=(None if self.delta is None
                   else self.delta.map(lambda x: x.to(dev))))


# Padding-row fill per EnvelopeSet field.  +inf lo / -inf hi make padding
# rows unreachable by every lower bound.  The storage Writer pads its
# on-disk set from this table too.
PAD_FILL = {"paa_lo": float("inf"), "paa_hi": -float("inf"), "sym_lo": 0,
            "sym_hi": 0, "series_id": 0, "anchor": 0, "n_master": 0,
            "valid": False}


def _pad_envelopes(env: EnvelopeSet, multiple: int) -> EnvelopeSet:
    pad = (-env.size) % multiple
    if pad == 0:
        return env

    def pad_arr(x, fill):
        tail = torch.full((pad,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                          device=x.device)
        return torch.cat([x, tail])

    return EnvelopeSet(**{field: pad_arr(getattr(env, field), fill)
                          for field, fill in PAD_FILL.items()})


def _sort_envelopes(env: EnvelopeSet) -> EnvelopeSet:
    # push padding/invalid rows to the end, then lexicographic by iSAX(L)
    keys = torch.cat([(~env.valid[:, None]).to(env.sym_lo.dtype),
                      env.sym_lo], dim=1)
    order = isax.argsort_by_isax(keys)
    return env.map(lambda x: x[order])


def _block_reduce(paa_lo, paa_hi, valid, block: int) -> BlockLevel:
    nb = paa_lo.shape[0] // block
    w = paa_lo.shape[1]
    # union over children (invalid rows carry +inf/-inf already)
    return BlockLevel(
        paa_lo=paa_lo.reshape(nb, block, w).amin(dim=1),
        paa_hi=paa_hi.reshape(nb, block, w).amax(dim=1),
        valid=valid.reshape(nb, block).any(dim=1))


def default_breakpoints(p: EnvelopeParams, data: torch.Tensor) -> torch.Tensor:
    """Default iSAX breakpoints: N(0,1) quantiles (Z-normalized mode) or
    quantiles calibrated on a PAA sample of the collection (raw mode)."""
    if p.znorm:
        return isax.gaussian_breakpoints(p.card, data.device)
    sample = paa(data[: min(1024, data.shape[0])], p.seg_len)
    return isax.calibrate_breakpoints(p.card, sample)


def build_block_levels(env: EnvelopeSet, block_size: int,
                       num_levels: int) -> List[BlockLevel]:
    """Dense block hierarchy (coarse -> fine) over a sorted, padded set."""
    levels: List[BlockLevel] = []
    lo, hi, valid = env.paa_lo, env.paa_hi, env.valid
    for _ in range(num_levels):
        lvl = _block_reduce(lo, hi, valid, block_size)
        levels.append(lvl)
        lo, hi, valid = lvl.paa_lo, lvl.paa_hi, lvl.valid
    levels.reverse()  # coarse -> fine
    return levels


def index_from_envelopes(env: EnvelopeSet, collection: Collection,
                         p: EnvelopeParams, breakpoints: torch.Tensor,
                         block_size: int = 64,
                         num_levels: int = 2) -> UlisseIndex:
    """Sort (stably) / pad an EnvelopeSet and build the block hierarchy."""
    env = _sort_envelopes(env)
    env = _pad_envelopes(env, block_size ** max(num_levels, 1))
    levels = build_block_levels(env, block_size, num_levels)
    return UlisseIndex(envelopes=env, levels=levels, collection=collection,
                       breakpoints=breakpoints, params=p)


def build_index(collection: Collection, p: EnvelopeParams,
                breakpoints: Optional[torch.Tensor] = None,
                block_size: int = 64, num_levels: int = 2) -> UlisseIndex:
    """ULISSE index computation (paper Alg. 3) on the whole collection,
    on the collection's device."""
    if breakpoints is None:
        breakpoints = default_breakpoints(p, collection.data)
    breakpoints = breakpoints.to(collection.device)
    env = build_envelope_set(collection, p, breakpoints)
    return index_from_envelopes(env, collection, p, breakpoints,
                                block_size=block_size,
                                num_levels=num_levels)
