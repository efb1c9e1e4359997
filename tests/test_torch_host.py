"""Port parity, the host backend and approx-only search:
`repro_torch.UlisseEngine(device="cpu")` against `repro.UlisseEngine` on
the SAME index (the reference's index carried over with
`convert.index_from_arrays`, so both engines plan identically).

  * `scan_backend="host"` exact k-NN (and approx-only), ED and DTW, znorm
    and raw, one query and a batch of 8 of mixed lengths: identical
    (series, offsets) and `SearchStats`.  Both host backends report
    float32 distances unpolished (the reference's F1), the port's from
    the `batch_ed` / `lb_keogh` + `dtw_band` kernels' plain versions, so
    distances agree to a float32 tolerance: ED atol 5e-3 (the dot
    identity cancels; measured <= 2.6e-3 on raw random walks), DTW
    rtol 1e-4 / atol 1e-4 (the two closed-form DPs' float32 cumsums over
    the band round differently; measured <= 5e-5).  Exact answers are
    also held against the port's brute force (ED 5e-3, DTW 1e-3).
  * `mode="approx"` on the device backend: identical answers and
    `SearchStats`; ED distances to 1e-9 (both rescore in float64), DTW
    to rtol 1e-4 / atol 1e-4.  An approximate k-th distance is never
    below the exact one, and equals the brute force wherever
    `exact_from_approx` is set.

Queries are data windows plus N(0, 0.05) noise (see test_torch_engine).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import Collection as JCollection  # noqa: E402
from repro.core import EnvelopeParams as JParams  # noqa: E402
from repro.core import QuerySpec as JQuerySpec  # noqa: E402
from repro.core import UlisseEngine as JEngine  # noqa: E402
from repro.core.types import EnvelopeSet as JEnvelopeSet  # noqa: E402
from repro_torch.convert import index_from_arrays  # noqa: E402
from repro_torch.core import (EnvelopeParams, QuerySpec,  # noqa: E402
                              UlisseEngine, executor)
from repro_torch.core.search import brute_force_knn  # noqa: E402

PARAMS = dict(lmin=64, lmax=128, seg_len=16, card=64, gamma=8)
R = 9
# (rtol, atol) on distances, per measure and backend (module docstring)
TOL = {("ed", "host"): (0, 5e-3), ("dtw", "host"): (1e-4, 1e-4),
       ("ed", "device"): (0, 1e-9), ("dtw", "device"): (1e-4, 1e-4)}
BRUTE_TOL = {"ed": 5e-3, "dtw": 1e-3}
QUERIES = {
    "b1": [(3, 20, 96)],
    # 8 queries of three lengths in one call
    "b8_mixed": [(i, 3 * i, 96) for i in range(6)] + [(9, 7, 64),
                                                       (11, 40, 128)],
}


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


@pytest.fixture(scope="module", params=[True, False], ids=["znorm", "raw"])
def engines(request):
    """(znorm, data, reference engine, port engine on the converted
    index, port collection)."""
    znorm = request.param
    rng = np.random.default_rng(12345)
    data = np.cumsum(rng.normal(size=(16, 192)), -1).astype(np.float32)
    ref = JEngine.from_collection(JCollection.from_array(data),
                                  JParams(znorm=znorm, **PARAMS),
                                  block_size=16, num_levels=2)
    idx = index_from_arrays(_arrays(ref.index),
                            EnvelopeParams(znorm=znorm, **PARAMS),
                            device="cpu")
    return (znorm, data, ref, UlisseEngine.from_index(idx, device="cpu"),
            idx.collection)


def _queries(data, spec, seed):
    """Data windows (series, start, length) plus N(0, 0.05) noise."""
    rng = np.random.default_rng(seed)
    return [data[s, o:o + l] + rng.normal(size=l).astype(np.float32) * 0.05
            for s, o, l in spec]


def _spec_kw(measure, **kw):
    return dict(kw, k=5, measure=measure, r=R if measure == "dtw" else 0)


def _same_as_reference(ref, port, qs, spec_kw, tol):
    want = ref.search(qs, JQuerySpec(**spec_kw))
    got = port.search(qs, QuerySpec(**spec_kw))
    assert len(got) == len(want) == len(qs)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.series, b.series)
        np.testing.assert_array_equal(a.offsets, b.offsets)
        np.testing.assert_allclose(a.dists, b.dists, rtol=tol[0],
                                   atol=tol[1])
        assert dataclasses.asdict(a.stats) == dataclasses.asdict(b.stats)
        assert len(a.dists) == spec_kw["k"] and np.isfinite(a.dists).all()
    return got


def _brute(coll, q, znorm, measure):
    return brute_force_knn(coll, q, k=5, znorm=znorm, measure=measure,
                           r=R if measure == "dtw" else 0)


@pytest.mark.parametrize("batch", sorted(QUERIES))
@pytest.mark.parametrize("measure", ["ed", "dtw"])
def test_port_host_backend_equals_reference(engines, measure, batch):
    znorm, data, ref, port, coll = engines
    qs = _queries(data, QUERIES[batch], seed=len(batch))
    syncs = executor.to_host.syncs
    got = _same_as_reference(ref, port, qs,
                             _spec_kw(measure, scan_backend="host"),
                             TOL[(measure, "host")])
    # at least the two plan readbacks and one chunk's distances a query
    assert executor.to_host.syncs - syncs >= 3 * len(qs)
    for a, q in zip(got, qs):
        oracle = _brute(coll, q, znorm, measure)
        np.testing.assert_allclose(a.dists, oracle.dists, rtol=0,
                                   atol=BRUTE_TOL[measure])


@pytest.mark.parametrize("backend", ["device", "host"])
@pytest.mark.parametrize("measure", ["ed", "dtw"])
def test_port_approx_equals_reference(engines, measure, backend):
    znorm, data, ref, port, coll = engines
    qs = _queries(data, QUERIES["b8_mixed"], seed=11)
    got = _same_as_reference(
        ref, port, qs, _spec_kw(measure, mode="approx",
                                scan_backend=backend),
        TOL[(measure, backend)])
    for a, q in zip(got, qs):
        oracle = _brute(coll, q, znorm, measure)
        tol = BRUTE_TOL[measure]
        assert a.dists[-1] >= oracle.dists[-1] - tol
        if a.stats.exact_from_approx:
            np.testing.assert_allclose(a.dists, oracle.dists, rtol=0,
                                       atol=tol)


def test_port_host_backend_no_approx_first(engines):
    """The pure host scan: the pool starts empty."""
    znorm, data, ref, port, coll = engines
    qs = _queries(data, [(2, 0, 112), (7, 50, 112)], seed=4)
    _same_as_reference(ref, port, qs,
                       _spec_kw("ed", scan_backend="host",
                                approx_first=False),
                       TOL[("ed", "host")])


@pytest.mark.parametrize("measure", ["ed", "dtw"])
def test_verify_envelopes_range_cut_matches_reference(engines, measure):
    """The host verification's range cut (`eps2`, `collector`), which the
    range slice reuses: at a cut between two hits, the same (series,
    offset) hits as the reference's `verify_envelopes`, d2 to the
    float32 tolerance, the same counters; and the cut is inclusive (a hit
    at exactly eps2 is kept)."""
    from repro.core import executor as jexecutor
    from repro.core import planner as jplanner
    from repro_torch.core import planner
    znorm, data, ref, port, _ = engines
    q = _queries(data, [(5, 30, 96)], seed=7)[0]
    kw = _spec_kw(measure)
    pq = planner.prepare_query(q, port.params, kw["measure"], kw["r"],
                               device="cpu")
    jpq = jplanner.prepare_query(q, ref.params, kw["measure"], kw["r"])
    env_idx = np.nonzero(np.asarray(ref.index.envelopes.valid))[0][:64]
    pool = executor.TopK(6)
    executor.verify_envelopes(port.index, pq, env_idx, pool,
                              executor.SearchStats())
    on_cut = []
    executor.verify_envelopes(port.index, pq, env_idx, None,
                              executor.SearchStats(), eps2=float(pool.d[4]),
                              collector=on_cut)
    assert (np.concatenate(on_cut)[:, 2] == pool.d[4]).any()
    eps2 = float(pool.d[4] + pool.d[5]) / 2
    got, want = [], []
    stats, jstats = executor.SearchStats(), jexecutor.SearchStats()
    executor.verify_envelopes(port.index, pq, env_idx, None, stats,
                              eps2=eps2, collector=got)
    jexecutor.verify_envelopes(ref.index, jpq, env_idx, None, jstats,
                               eps2=eps2, collector=want)
    got, want = np.concatenate(got), np.concatenate(want)
    assert dataclasses.asdict(stats) == dataclasses.asdict(jstats)
    assert len(got) >= 5 and (got[:, 2] <= eps2).all()
    order = np.lexsort((got[:, 1], got[:, 0]))
    jorder = np.lexsort((want[:, 1], want[:, 0]))
    np.testing.assert_array_equal(got[order, :2], want[jorder, :2])
    rtol, atol = TOL[(measure, "host")]
    np.testing.assert_allclose(got[order, 2], want[jorder, 2],
                               rtol=rtol, atol=atol)
