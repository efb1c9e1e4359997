"""Port parity, the DTW slice past the card's warp entries (a band wider
than 1,024 slots): the long-query cases, apart from test_torch_dtw.py so
that a parallel run can give them a worker of their own.

  * `dtw_band` and its wide entry at qlen 600, r 600 (their plain
    versions here) against the Pallas kernel in interpret mode and the
    reference's DP, rtol / atol 1e-4 (the DP is summed in another order);
  * the engine on an index of 560-point series (lmin 520, lmax 544),
    carried over from the reference with `convert.index_from_arrays`,
    answering qlen 520-540 queries at r 520 and 600: far queries as the
    reference does, near matches as a float64 brute force does (the
    reference's float32 closed form cancels there: see the tests).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import Collection as JCollection  # noqa: E402
from repro.core import EnvelopeParams as JParams  # noqa: E402
from repro.core import QuerySpec as JQuerySpec  # noqa: E402
from repro.core import UlisseEngine as JEngine  # noqa: E402
from repro.core import dtw as jdtw  # noqa: E402
from repro.core.types import EnvelopeSet as JEnvelopeSet  # noqa: E402
from repro.kernels.dtw_band import dtw_band_pallas  # noqa: E402
from repro_torch.convert import index_from_arrays  # noqa: E402
from repro_torch.core import (EnvelopeParams, QuerySpec,  # noqa: E402
                              UlisseEngine, dtw)
from repro_torch.kernels.dtw_band import dtw_band, dtw_band_wide  # noqa: E402


def _t(x):
    return torch.from_numpy(np.array(x))


def _arrays(index):
    """A reference index flattened to the convert.py schema."""
    out = {f"envelopes.{f.name}": np.asarray(getattr(index.envelopes, f.name))
           for f in dataclasses.fields(JEnvelopeSet)}
    for i, lvl in enumerate(index.levels):
        for f in ("paa_lo", "paa_hi", "valid"):
            out[f"levels.{i}.{f}"] = np.asarray(getattr(lvl, f))
    for f in ("data", "csum", "csum2", "center", "csum_lo", "csum2_lo"):
        out[f"collection.{f}"] = np.asarray(getattr(index.collection, f))
    out["breakpoints"] = np.asarray(index.breakpoints)
    return out


def _queries(data, spec, seed):
    """Data windows (series, start, length) plus N(0, 0.05) noise."""
    rng = np.random.default_rng(seed)
    return [data[s, o:o + l] + rng.normal(size=l).astype(np.float32) * 0.05
            for s, o, l in spec]


def test_dtw_band_wide_band_matches_pallas_and_reference():
    """qlen 600 with r 600: a band of 1199 slots, past the warp entries'
    1024, through `dtw_band` and the wide entry's wrapper (both the plain
    version here) against the Pallas kernel (interpret mode, ~16 s) and
    the reference's DP, rtol / atol 1e-4."""
    rng = np.random.default_rng(600)
    q = rng.normal(size=600).astype(np.float32)
    c = rng.normal(size=(3, 600)).astype(np.float32)
    pallas = np.asarray(dtw_band_pallas(jnp.asarray(q), jnp.asarray(c), 600,
                                        interpret=True))
    core = np.asarray(jdtw.dtw_band(jnp.asarray(q), jnp.asarray(c), 600,
                                    squared=True))
    for fn in (dtw_band, dtw_band_wide):
        got = fn(_t(q), _t(c), 600).numpy()
        assert got.shape == (3,) and got.dtype == np.float32
        for want in (pallas, core):
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


LONG_PARAMS = dict(lmin=520, lmax=544, seg_len=16, card=64, gamma=8)


def _brute64(data, q, k, r, znorm):
    """The exact k-NN oracle of the long-query test: every window's DTW
    in float64 (the closed form, whose cancellation is ~1e-16 of the band
    sums there).  Returns (series, offsets, dists)."""
    qlen = len(q)
    n_off = data.shape[1] - qlen + 1
    w = np.lib.stride_tricks.sliding_window_view(
        data.astype(np.float64), qlen, axis=1).reshape(-1, qlen)
    q = q.astype(np.float64)
    if znorm:
        w = (w - w.mean(1, keepdims=True)) / np.maximum(
            w.std(1, keepdims=True), 1e-8)
        q = (q - q.mean()) / max(q.std(), 1e-8)
    d2 = dtw.dtw_band(torch.from_numpy(q), torch.from_numpy(w), r,
                      squared=True).numpy()
    top = np.argsort(d2, kind="stable")[:k]
    return top // n_off, top % n_off, np.sqrt(d2[top])


@pytest.fixture(scope="module", params=[True, False], ids=["znorm", "raw"])
def long_engines(request):
    """(znorm, data, reference engine, port engine) on three 560-point
    series at lmin 520, lmax 544 (w = 34 segments)."""
    znorm = request.param
    data = np.cumsum(np.random.default_rng(7).normal(size=(3, 560)),
                     -1).astype(np.float32)
    ref = JEngine.from_collection(JCollection.from_array(data),
                                  JParams(znorm=znorm, **LONG_PARAMS),
                                  block_size=4, num_levels=1)
    idx = index_from_arrays(_arrays(ref.index),
                            EnvelopeParams(znorm=znorm, **LONG_PARAMS),
                            device="cpu")
    return znorm, data, ref, UlisseEngine.from_index(idx, device="cpu")


def test_port_dtw_engine_long_queries_equal_reference(long_engines):
    """DTW k-NN past the card's warp entries (qlen >= 513 with r >= 512;
    before the wide entries the port raised mid-scan): queries of length
    530 and 520 at r = 520, independent random walks.  `SearchStats`
    equal the reference's and distances agree within rtol 1e-4 / atol
    1e-5; the answers equal a float64 brute force, with distances within
    rtol 1e-4 / atol 1e-5 of the float64 DP.  (The reference's answers
    may differ at a near tie: its float32 closed form rounds by ~3e-5
    relative over such a band, ROADMAP Queue 3 F4.)"""
    znorm, data, ref, port = long_engines
    rng = np.random.default_rng(8)
    far = [np.cumsum(rng.normal(size=l)).astype(np.float32)
           for l in (530, 520)]
    spec_kw = dict(k=3, measure="dtw", r=520)
    want = ref.search(far, JQuerySpec(**spec_kw))
    got = port.search(far, QuerySpec(**spec_kw))
    for q, a, b in zip(far, got, want):
        assert dataclasses.asdict(a.stats) == dataclasses.asdict(b.stats)
        assert a.stats.dtw_full > 0
        np.testing.assert_allclose(a.dists, b.dists, rtol=1e-4, atol=1e-5)
        series, offsets, dists = _brute64(data, q, 3, 520, znorm)
        np.testing.assert_array_equal(a.series, series)
        np.testing.assert_array_equal(a.offsets, offsets)
        np.testing.assert_allclose(a.dists, dists, rtol=1e-4, atol=1e-5)


def test_port_dtw_engine_long_near_matches_are_exact(long_engines):
    """Near matches (data windows + noise) of length 530 and 540 at
    r = 600 (a band as wide as the row): the port's answers equal a
    float64 brute force and its distances the float64 DP within rtol
    1e-4 / atol 1e-5.  The reference is not held here: its DP, the
    float32 closed form, cancels over such a band on near matches
    (ROADMAP Queue 3 F4: up to 10% off the float64 DP, and its answers
    and counters follow its rounding)."""
    znorm, data, _, port = long_engines
    near = _queries(data, [(0, 10, 530), (2, 3, 540)], seed=9)
    got = port.search(near, QuerySpec(k=3, measure="dtw", r=600))
    for q, a in zip(near, got):
        series, offsets, dists = _brute64(data, q, 3, 600, znorm)
        np.testing.assert_array_equal(a.series, series)
        np.testing.assert_array_equal(a.offsets, offsets)
        np.testing.assert_allclose(a.dists, dists, rtol=1e-4, atol=1e-5)
        assert a.stats.dtw_lb_keogh >= a.stats.dtw_full > 0
