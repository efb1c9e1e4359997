"""Brute-force k-NN and eps-range: the exhaustive oracles, in plain
PyTorch.

Runs on the collection's device over every subsequence of length |Q|:
ED with the dot-product identity of the JAX package's `ed_batch`, DTW
with the plain banded DP (`core/dtw.dtw_band`) over windows Z-normalized
by their direct mean and std.  Series go in blocks, so the work of one
block stays within a fixed element budget.  The oracle is independent
of the index, the planner and the kernels.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import dtw
from repro_torch.core.executor import SearchResult, SearchStats
from repro_torch.core.paa import znormalize
from repro_torch.core.types import Collection

# elements of one block of series: block_series * n_off * (qlen for ED,
# qlen plus ~8 band-wide DP temporaries for DTW)
_BRUTE_BLOCK_ELEMS = 1 << 27


def ed_batch(windows: torch.Tensor, q: torch.Tensor, znorm: bool):
    """Squared ED of windows (..., l) to one prepared query (l,) by the
    dot-product identity."""
    l = windows.shape[-1]
    dots = windows @ q
    if znorm:
        mu = windows.mean(dim=-1)
        var = (windows * windows).mean(dim=-1) - mu * mu
        sd = torch.sqrt(var.clamp_min(0.0)).clamp_min(1e-8)
        d2 = 2.0 * l - 2.0 * dots / sd
    else:
        d2 = (windows * windows).sum(dim=-1) - 2.0 * dots + (q * q).sum()
    return d2.clamp_min(0.0)


def _d2_blocks(collection: Collection, q, znorm: bool, measure: str,
               r: int):
    """(n_off, blocks): the squared distance of q to every subsequence of
    length |q|, as (first flat index, (rows * n_off,) float32 d2) blocks
    in (series, offset) order; flat index = series * n_off + offset."""
    dev = collection.device
    q = torch.as_tensor(np.asarray(q, np.float32), device=dev)
    qlen = q.shape[-1]
    qn = znormalize(q) if znorm else q
    s, n = collection.data.shape
    n_off = n - qlen + 1
    if measure == "ed":
        per_window = qlen

        def d2_of(windows):
            return ed_batch(windows, qn, znorm)
    elif measure == "dtw":
        if r <= 0:
            raise ValueError("DTW search needs a warping window r > 0")
        per_window = qlen + 8 * (2 * min(r, qlen - 1) + 1)

        def d2_of(windows):
            wn = znormalize(windows) if znorm else windows
            return dtw.dtw_band(qn, wn, r, squared=True)
    else:
        raise ValueError(f"unknown measure {measure!r}")
    block = max(1, _BRUTE_BLOCK_ELEMS // (n_off * per_window))

    def blocks():
        for start in range(0, s, block):
            rows = collection.data[start:start + block]
            yield start * n_off, d2_of(rows.unfold(1, qlen, 1)).reshape(-1)
    return n_off, blocks()


def brute_force_knn(collection: Collection, q, k: int, znorm: bool,
                    measure: str = "ed", r: int = 0) -> SearchResult:
    """Exhaustive k-NN over every subsequence of length |Q| (oracle)."""
    n_off, blocks = _d2_blocks(collection, q, znorm, measure, r)
    best_d2, best_idx = [], []
    for start, d2 in blocks:
        top = torch.topk(d2, min(k, d2.numel()), largest=False)
        best_d2.append(top.values)
        best_idx.append(top.indices + start)
    d2 = torch.cat(best_d2).double().cpu().numpy()
    idx = torch.cat(best_idx).cpu().numpy()
    order = np.lexsort((idx, d2))[:k]
    return SearchResult(
        dists=np.sqrt(np.maximum(d2[order], 0.0)),
        series=(idx[order] // n_off).astype(np.int64),
        offsets=(idx[order] % n_off).astype(np.int64),
        stats=SearchStats(envelopes_total=0))


def brute_force_range(collection: Collection, q, eps: float, znorm: bool,
                      measure: str = "ed", r: int = 0) -> SearchResult:
    """Exhaustive eps-range oracle: every subsequence with d <= eps (the
    float32 d2 against eps^2 in float64, as the JAX package compares),
    sorted ascending by distance, ties in (series, offset) order."""
    n_off, blocks = _d2_blocks(collection, q, znorm, measure, r)
    eps2 = float(eps) ** 2
    hit_d2, hit_idx = [], []
    for start, d2 in blocks:
        d2 = d2.double()
        hit = torch.nonzero(d2 <= eps2)[:, 0]
        hit_d2.append(d2[hit])
        hit_idx.append(hit + start)
    d2 = torch.cat(hit_d2).cpu().numpy()
    idx = torch.cat(hit_idx).cpu().numpy()
    order = np.argsort(d2, kind="stable")
    return SearchResult(
        dists=np.sqrt(np.maximum(d2[order], 0.0)),
        series=(idx[order] // n_off).astype(np.int64),
        offsets=(idx[order] % n_off).astype(np.int64),
        stats=SearchStats(envelopes_total=0))
