"""Brute-force k-NN: the exhaustive oracle, in plain PyTorch.

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


def brute_force_knn(collection: Collection, q, k: int, znorm: bool,
                    measure: str = "ed", r: int = 0) -> SearchResult:
    """Exhaustive k-NN over every subsequence of length |Q| (oracle)."""
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
    best_d2, best_idx = [], []
    for start in range(0, s, block):
        rows = collection.data[start:start + block]
        d2 = d2_of(rows.unfold(1, qlen, 1)).reshape(-1)
        top = torch.topk(d2, min(k, d2.numel()), largest=False)
        best_d2.append(top.values)
        best_idx.append(top.indices + start * n_off)
    d2 = torch.cat(best_d2).double().cpu().numpy()
    idx = torch.cat(best_idx).cpu().numpy()
    order = np.lexsort((idx, d2))[:k]
    return SearchResult(
        dists=np.sqrt(np.maximum(d2[order], 0.0)),
        series=(idx[order] // n_off).astype(np.int64),
        offsets=(idx[order] % n_off).astype(np.int64),
        stats=SearchStats(envelopes_total=0))
