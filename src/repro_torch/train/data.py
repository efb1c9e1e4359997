"""Synthetic data-series generation (a copy of the JAX package's
`repro.train.data.series_batches`, so the port makes the same data from
the same seed)."""
from __future__ import annotations

import numpy as np


def series_batches(num_series: int, series_len: int, seed: int = 0,
                   kind: str = "randomwalk") -> np.ndarray:
    """Synthetic data-series generator matching the paper's workload:
    cumulative sums of N(0,1) steps (random-walk; models financial
    series per Faloutsos et al.), plus periodic/seismic-ish variants
    for the real-data-flavored benchmarks."""
    rng = np.random.default_rng(seed)
    steps = rng.normal(size=(num_series, series_len)).astype(np.float32)
    if kind == "randomwalk":
        return np.cumsum(steps, axis=-1)
    if kind == "periodic":        # ECG/GAP-flavored: cycles + noise
        t = np.arange(series_len, dtype=np.float32)
        f = rng.uniform(0.01, 0.1, size=(num_series, 1))
        ph = rng.uniform(0, 2 * np.pi, size=(num_series, 1))
        return (np.sin(2 * np.pi * f * t + ph)
                + 0.1 * steps).astype(np.float32)
    if kind == "bursty":          # SEISMIC-flavored: sparse bursts
        base = 0.05 * steps
        mask = rng.random(size=(num_series, series_len)) < 0.02
        return (base + mask * rng.normal(
            size=(num_series, series_len)) * 5).astype(np.float32)
    raise ValueError(kind)
