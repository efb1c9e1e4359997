"""Core parameter and data types for the ULISSE framework (PyTorch port).

All series-level conventions are 0-based, as in the JAX package:
  - a subsequence (o, l) of series D is D[o : o + l];
  - a *master series* at offset o is D[o : o + min(|D| - o, lmax)];
  - an Envelope anchored at `a` represents every subsequence (o, l) with
    o in [a, a + gamma] and l in [lmin, lmax] that fits inside D.

Containers are plain dataclasses of tensors; every constructor takes an
explicit `device`.  `resolve_device` is the one place that decides
where the port runs: CUDA unless the caller asks for the CPU, and an
error (never a silent CPU run) when CUDA is asked for and absent.
"""
from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device to run on: "cuda" by default; raises when CUDA is
    requested and unavailable (the port never falls back to the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@dataclasses.dataclass(frozen=True)
class EnvelopeParams:
    """Static parameters of the ULISSE summarization (paper §4).

    Attributes:
      lmin / lmax: query length range [l_min, l_max].
      gamma: number of *additional* master series per Envelope; one Envelope
        represents masters at offsets a .. a + gamma (paper's gamma).
      seg_len: PAA segment length `s`.
      card: iSAX alphabet cardinality (paper uses 256 = 8 bits).
      znorm: whether the index represents Z-normalized subsequences.
    """

    lmin: int
    lmax: int
    gamma: int
    seg_len: int
    card: int = 256
    znorm: bool = True

    def __post_init__(self):
        if self.lmin > self.lmax:
            raise ValueError(f"lmin={self.lmin} > lmax={self.lmax}")
        if self.lmin < self.seg_len:
            raise ValueError("lmin must be >= seg_len (need >= 1 PAA segment)")
        if self.gamma < 0:
            raise ValueError("gamma must be >= 0")
        if self.card < 2 or self.card > 256:
            raise ValueError("card must be in [2, 256]")

    @property
    def w(self) -> int:
        """Number of PAA segments covering the longest subsequence."""
        return self.lmax // self.seg_len

    @property
    def n_master(self) -> int:
        """Max number of master series represented by one Envelope."""
        return self.gamma + 1

    def num_envelopes(self, series_len: int) -> int:
        """Number of Envelopes extracted from one series of length n.

        Anchors are a_j = j * (gamma + 1) while a_j + lmin <= n.
        """
        if series_len < self.lmin:
            return 0
        n_start = series_len - self.lmin + 1  # valid master start positions
        return -(-n_start // (self.gamma + 1))  # ceil division

    def query_segments(self, qlen: int) -> int:
        """Number of PAA segments of the longest multiple-of-s query prefix."""
        if not (self.lmin <= qlen <= self.lmax):
            raise ValueError(f"query length {qlen} outside [{self.lmin}, {self.lmax}]")
        return qlen // self.seg_len


def host_prefix_stats(rows: np.ndarray):
    """Per-row f64-accumulated hi/lo split prefix sums, on host.

    The same numpy computation as the JAX package's, so every field is
    bit-equal to the reference's.  Every field is purely row-wise, so
    computing it in row blocks (as `Collection.from_array` does to bound
    host memory) is bit-identical to one whole-array pass.

    Returns np float32 arrays
    (center (R,), csum (R, n+1), csum_lo, csum2, csum2_lo).
    """
    host = np.asarray(rows, np.float64)
    center64 = host.mean(axis=-1)
    centered = host - center64[:, None]
    zeros = np.zeros((host.shape[0], 1), np.float64)
    csum64 = np.concatenate(
        [zeros, np.cumsum(centered, axis=-1)], axis=-1)
    csum2_64 = np.concatenate(
        [zeros, np.cumsum(centered * centered, axis=-1)], axis=-1)

    def split(x64):
        hi = x64.astype(np.float32)
        lo = (x64 - hi.astype(np.float64)).astype(np.float32)
        return hi, lo

    csum, csum_lo = split(csum64)
    csum2, csum2_lo = split(csum2_64)
    return (center64.astype(np.float32), csum, csum_lo, csum2, csum2_lo)


@dataclasses.dataclass(frozen=True)
class PageBlock:
    """One cached page of a paged payload store (`storage.store`): a
    fixed-size block of series rows with their prefix-sum statistics,
    all host numpy float32.  The paged scan assembles pages into slabs
    on the device; pages themselves stay on the host.

    `start` is the first global series id of the page: row r of the page
    holds series `start + r`.  `from_rows` goes through
    `host_prefix_stats`, as `Collection.from_array` does, so a page's
    planes equal the resident collection's rows bit for bit.
    """

    start: int                 # first global series id
    data: np.ndarray           # (R, n) raw values
    csum: np.ndarray           # (R, n + 1) centered cumsum, hi part
    csum_lo: np.ndarray        # (R, n + 1) residual
    csum2: np.ndarray          # (R, n + 1) squared-centered cumsum, hi
    csum2_lo: np.ndarray       # (R, n + 1) residual
    center: np.ndarray         # (R,)

    @classmethod
    def from_rows(cls, start: int, rows: np.ndarray) -> "PageBlock":
        rows = np.ascontiguousarray(rows, np.float32)
        center, csum, csum_lo, csum2, csum2_lo = host_prefix_stats(rows)
        return cls(start=start, data=rows, csum=csum, csum_lo=csum_lo,
                   csum2=csum2, csum2_lo=csum2_lo, center=center)

    @property
    def num_rows(self) -> int:
        return self.data.shape[0]

    @property
    def nbytes(self) -> int:
        return (self.data.nbytes + self.csum.nbytes + self.csum_lo.nbytes
                + self.csum2.nbytes + self.csum2_lo.nbytes
                + self.center.nbytes)


# rows per host_prefix_stats call: ~2 GB of float64 temporaries at n=256
_STATS_BLOCK_ROWS = 1 << 16

_COLLECTION_FIELDS = ("data", "csum", "csum2", "center", "csum_lo",
                      "csum2_lo")


@dataclasses.dataclass
class Collection:
    """A data series collection: fixed-length series stacked in one tensor.

    `data` is (num_series, series_len) float32.  The centered prefix sums
    are accumulated in float64 on the host and stored as a two-float
    (hi, lo) split: a window sum recovered as (hi[e]-hi[s]) + (lo[e]-lo[s])
    has error ~eps_f32 * |window sum|, so device window statistics track
    a direct mean/var at any offset.
    """

    data: torch.Tensor          # (S, n) raw values
    csum: torch.Tensor          # (S, n + 1) centered cumsum, f32 hi part
    csum2: torch.Tensor         # (S, n + 1) squared-centered cumsum, hi part
    center: torch.Tensor        # (S,) per-series mean removed before csum/csum2
    csum_lo: torch.Tensor       # (S, n + 1) f32 residual of csum
    csum2_lo: torch.Tensor      # (S, n + 1) f32 residual of csum2

    @classmethod
    def from_array(cls, data, device: DeviceLike = None) -> "Collection":
        dev = resolve_device(device)
        host = np.ascontiguousarray(np.asarray(data, np.float32))
        if host.ndim == 1:
            host = host[None]
        s, n = host.shape
        out = {"data": torch.from_numpy(host).to(dev)}
        stats = {f: torch.empty((s, n + 1) if f != "center" else (s,),
                                dtype=torch.float32, device=dev)
                 for f in ("center", "csum", "csum_lo", "csum2", "csum2_lo")}
        for start in range(0, s, _STATS_BLOCK_ROWS):
            stop = min(start + _STATS_BLOCK_ROWS, s)
            block = host_prefix_stats(host[start:stop])
            for f, arr in zip(("center", "csum", "csum_lo", "csum2",
                               "csum2_lo"), block):
                stats[f][start:stop].copy_(torch.from_numpy(arr))
        out.update(stats)
        return cls(**out)

    @property
    def num_series(self) -> int:
        return self.data.shape[0]

    @property
    def series_len(self) -> int:
        return self.data.shape[1]

    @property
    def device(self) -> torch.device:
        return self.data.device

    def to(self, device: DeviceLike) -> "Collection":
        dev = resolve_device(device)
        return Collection(**{f: getattr(self, f).to(dev)
                             for f in _COLLECTION_FIELDS})


ENVELOPE_FIELDS = ("paa_lo", "paa_hi", "sym_lo", "sym_hi", "series_id",
                   "anchor", "n_master", "valid")


@dataclasses.dataclass
class EnvelopeSet:
    """A flat struct-of-arrays set of ULISSE Envelopes.

    Shapes: N = number of envelopes, w = PAA segments.
      paa_lo / paa_hi : (N, w) float32 — real-valued L / U PAA bounds.
      sym_lo / sym_hi : (N, w) int32   — iSAX(L) / iSAX(U) symbols.
      series_id       : (N,)  int32    — source series in the Collection.
      anchor          : (N,)  int32    — first master offset `a`.
      n_master        : (N,)  int32    — number of valid masters (<= gamma+1).
      valid           : (N,)  bool     — padding mask (False = padding row).

    Segments never touched by any represented subsequence carry
    paa_lo=-inf / paa_hi=+inf so they contribute zero to every lower bound.
    """

    paa_lo: torch.Tensor
    paa_hi: torch.Tensor
    sym_lo: torch.Tensor
    sym_hi: torch.Tensor
    series_id: torch.Tensor
    anchor: torch.Tensor
    n_master: torch.Tensor
    valid: torch.Tensor

    @property
    def size(self) -> int:
        return self.paa_lo.shape[0]

    @property
    def w(self) -> int:
        return self.paa_lo.shape[1]

    def map(self, fn) -> "EnvelopeSet":
        """Apply `fn` to every field (the pytree `tree_map` of the JAX
        package)."""
        return EnvelopeSet(**{f: fn(getattr(self, f))
                              for f in ENVELOPE_FIELDS})


def concat_envelope_sets(sets) -> EnvelopeSet:
    """The envelopes of `sets`, one after another (field by field)."""
    return EnvelopeSet(**{f: torch.cat([getattr(e, f) for e in sets])
                          for f in ENVELOPE_FIELDS})


def concat_collections(a, b) -> Collection:
    """Stack two same-length collections along the series axis.

    Every field is row-wise, so this equals `Collection.from_array` of
    the concatenated raw series — the invariant ingestion relies on.
    """
    if a.series_len != b.series_len:
        raise ValueError(
            f"cannot concat collections of series_len {a.series_len} "
            f"and {b.series_len}")
    return Collection(**{f: torch.cat([getattr(a, f), getattr(b, f)])
                         for f in _COLLECTION_FIELDS})
