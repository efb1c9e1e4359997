"""Port parity, the eps-range slice: `repro_torch` (CPU) against the JAX
package on the same numpy inputs and the same index (the reference's,
carried over with `convert.index_from_arrays`).

  * the engines on `tests/test_device_range.py`'s matrix (compacted
    half): znorm/raw x ED/DTW (r = 9) x device/host backend — the same
    (series, offset) hits in the same order, identical `SearchStats`
    (including `range_overflows`), ED distances within 1e-9 (both rescore
    their hits in float64); DTW distances (both engines report their
    float32 DP values) within rtol 1e-4 / atol 1e-5 of a float64 DP of
    each reported window, and within rtol 1e-3 of the reference's, whose
    float32 closed-form DP cancels on near matches (ROADMAP Queue 3 F4:
    8.7e-5 off the float64 DP at d = 0.42 here, the port 1e-7); the hits
    equal the reference's brute force;
  * boundary ties, lb == d == eps exactly (constant series), at capacity
    2,048 and 8 (the overflow continuation takes the tail); guaranteed
    overflow at capacity 4; a batch of mixed lengths;
  * the plain pieces: `brute_force_range` against the reference's (the
    same hits in the same order; distances within the k-NN oracles'
    atol, 5e-3 for ED and 1e-3 for DTW: both compute float32 distances
    summed in other orders, which cancel near d = 0, and the DTW closed
    form over the band), `device_range_pack` bit for bit, and the
    range scan (`executor._device_range_core`, on the CPU the plain
    versions of its kernels) against the reference's chunk by chunk — the
    hit buffer's ids, counts, overflow chunks and counters equal, its
    distances within the kernels' tolerances (ED rtol 1e-4 / atol 1e-3,
    DTW rtol 1e-4 / atol 1e-4);
  * the hit append's all-or-nothing rule at the buffer's edge.

Queries are data windows plus N(0, 0.05) noise (see test_torch_engine).
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
from repro.core import executor as jexecutor  # noqa: E402
from repro.core import planner as jplanner  # noqa: E402
from repro.core.search import brute_force_knn as j_brute_knn  # noqa: E402
from repro.core.search import brute_force_range as j_brute  # noqa: E402
from repro.core.types import EnvelopeSet as JEnvelopeSet  # noqa: E402
from repro_torch.convert import index_from_arrays  # noqa: E402
from repro_torch.core import (EnvelopeParams, QuerySpec,  # noqa: E402
                              UlisseEngine, executor, planner)
from repro_torch.core.search import brute_force_range  # noqa: E402
from repro_torch.kernels.range_append import range_append  # noqa: E402

PARAMS = dict(lmin=64, lmax=128, seg_len=16, card=64, gamma=8)
MEASURES = [("ed", 0), ("dtw", 9)]
CAP = 16     # the chunk-by-chunk test's hit buffer (a power of two)


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


def _pair(data, params, **build):
    """(reference engine, port engine on the converted index)."""
    ref = JEngine.from_collection(JCollection.from_array(data),
                                  JParams(**params), **build)
    idx = index_from_arrays(_arrays(ref.index), EnvelopeParams(**params),
                            device="cpu")
    return ref, UlisseEngine.from_index(idx, device="cpu")


@pytest.fixture(scope="module", params=[True, False], ids=["znorm", "raw"])
def engines(request):
    """(znorm, data, reference engine, port engine)."""
    rng = np.random.default_rng(12345)
    data = np.cumsum(rng.normal(size=(16, 192)), -1).astype(np.float32)
    return (request.param, data) + _pair(
        data, dict(PARAMS, znorm=request.param), block_size=16,
        num_levels=2)


def _noised(data, seed, sid=3, lo=20, hi=116, scale=0.05):
    rng = np.random.default_rng(seed)
    return data[sid, lo:hi] + rng.normal(size=hi - lo).astype(
        np.float32) * scale


def _eps(data, q, znorm, measure, r, k, scale):
    """A radius just past the k-th nearest distance (the reference's
    brute force)."""
    knn = j_brute_knn(JCollection.from_array(data), q, k=k, znorm=znorm,
                      measure=measure, r=r)
    return float(knn.dists[-1]) * scale


def _dtw64(data, q, series, offsets, r, znorm):
    """The banded DTW distance of q to each (series, offset) window, in
    float64 (the textbook DP)."""
    def norm(x):
        return (x - x.mean()) / max(x.std(), 1e-8) if znorm else x
    q = norm(np.asarray(q, np.float64))
    l = len(q)
    out = []
    for s_, o in zip(series, offsets):
        c = norm(data[s_, o:o + l].astype(np.float64))
        d = np.full((l + 1, l + 1), np.inf)
        d[0, 0] = 0.0
        for i in range(1, l + 1):
            for j in range(max(1, i - r), min(l, i + r) + 1):
                d[i, j] = (q[i - 1] - c[j - 1]) ** 2 + min(
                    d[i - 1, j], d[i, j - 1], d[i - 1, j - 1])
        out.append(np.sqrt(d[l, l]))
    return np.asarray(out)


def _same(got, want, measure, q=None, data=None, r=0, znorm=False):
    """Identical hits in the same order, identical stats, distances
    within the stated tolerances (DTW: also against a float64 DP of each
    reported window, when q and data are given)."""
    np.testing.assert_array_equal(got.series, want.series)
    np.testing.assert_array_equal(got.offsets, want.offsets)
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(want.stats)
    if measure == "ed":
        np.testing.assert_allclose(got.dists, want.dists, rtol=0, atol=1e-9)
        return
    np.testing.assert_allclose(got.dists, want.dists, rtol=1e-3, atol=1e-5)
    if q is not None:
        np.testing.assert_allclose(
            got.dists, _dtw64(data, q, got.series, got.offsets, r, znorm),
            rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("backend", ["device", "host"])
@pytest.mark.parametrize("measure,r", MEASURES)
def test_port_range_equals_reference(engines, measure, r, backend):
    znorm, data, ref, port = engines
    q = _noised(data, seed=7)
    eps = _eps(data, q, znorm, measure, r, k=8, scale=1.1)
    spec = dict(eps=eps, measure=measure, r=r, scan_backend=backend)
    got = port.search(q, QuerySpec(**spec))
    want = ref.search(q, JQuerySpec(**spec))
    _same(got, want, measure, q, data, r, znorm)
    assert len(got.dists) >= 8 and got.stats.range_overflows == 0
    assert (np.diff(got.dists) >= 0).all() and (got.dists <= eps).all()
    brute = j_brute(JCollection.from_array(data), q, eps, znorm=znorm,
                    measure=measure, r=r)
    assert set(zip(got.series, got.offsets)) == set(zip(brute.series,
                                                        brute.offsets))


@pytest.mark.parametrize("measure,r", MEASURES)
def test_port_range_overflow_equals_reference(engines, measure, r):
    """A 4-row hit buffer against a query with a dozen hits or more: the
    device scan overflows, the host continuation replays the chunks it
    never wrote, and the port equals the reference and its own uncapped
    answer (no duplicates, no drops)."""
    znorm, data, ref, port = engines
    q = _noised(data, seed=8)
    eps = _eps(data, q, znorm, measure, r, k=16, scale=1.05)
    spec = dict(eps=eps, measure=measure, r=r, range_capacity=4)
    got = port.search(q, QuerySpec(**spec))
    _same(got, ref.search(q, JQuerySpec(**spec)), measure, q, data, r,
          znorm)
    assert got.stats.range_overflows == 1
    full = port.search(q, QuerySpec(eps=eps, measure=measure, r=r))
    assert full.stats.range_overflows == 0 and len(full.dists) >= 16
    assert sorted(zip(got.series, got.offsets)) == sorted(
        zip(full.series, full.offsets))


def test_port_range_batched_mixed_lengths(engines):
    """A batch of range queries of two lengths (a padded sub-batch each)
    answers as the reference's batch and as one-at-a-time host runs."""
    znorm, data, ref, port = engines
    qs = [data[0, 0:96], data[1, 5:69], data[2, 0:96], data[4, 10:106]]
    qs = [q + 0.03 * np.sin(np.arange(len(q)), dtype=np.float32)
          for q in qs]
    eps = _eps(data, qs[0], znorm, "ed", 0, k=6, scale=1.2)
    got = port.search(qs, QuerySpec(eps=eps))
    want = ref.search(qs, JQuerySpec(eps=eps))
    assert len(got) == len(want) == 4
    for q, a, b in zip(qs, got, want):
        _same(a, b, "ed")
        host = port.search(q, QuerySpec(eps=eps, scan_backend="host"))
        assert sorted(zip(a.series, a.offsets)) == sorted(
            zip(host.series, host.offsets))


@pytest.mark.parametrize("backend", ["device", "host"])
@pytest.mark.parametrize("measure,r", [("ed", 0), ("dtw", 2)])
def test_port_range_boundary_ties(measure, r, backend):
    """lb == d == eps exactly (constant series: exactly representable
    distances): every cut is inclusive, so all boundary hits survive, also
    when the buffer overflows and the host continuation takes the tail;
    the port equals the reference throughout."""
    data = np.tile(np.float32([1.5, 4.0, -3.0, 8.0])[:, None], (1, 64))
    params = dict(lmin=16, lmax=32, seg_len=8, gamma=2, card=8,
                  znorm=False)
    ref, port = _pair(data, params, block_size=16, num_levels=2)
    q = np.full(16, 1.0, np.float32)      # series 0 at d2 = 16 * 0.25 = 4
    n_windows = data.shape[1] - len(q) + 1
    for cap in (2048, 8):
        spec = dict(eps=2.0, measure=measure, r=r, range_capacity=cap,
                    scan_backend=backend)
        got = port.search(q, QuerySpec(**spec))
        _same(got, ref.search(q, JQuerySpec(**spec)), measure, q, data, r)
        assert len(got.dists) == n_windows
        np.testing.assert_array_equal(got.series, np.zeros(n_windows))
        np.testing.assert_array_equal(got.dists, 2.0)
        assert got.stats.range_overflows == int(backend == "device"
                                                and cap == 8)


def test_range_spec_routes_before_mode(engines):
    """`eps` is tested before `mode`: an approx spec with eps is a range
    query, as in the reference."""
    znorm, data, ref, port = engines
    q = _noised(data, seed=9)
    eps = _eps(data, q, znorm, "ed", 0, k=4, scale=1.1)
    spec = dict(eps=eps, mode="approx")
    _same(port.search(q, QuerySpec(**spec)),
          ref.search(q, JQuerySpec(**spec)), "ed")


@pytest.mark.parametrize("measure,r", MEASURES)
@pytest.mark.parametrize("znorm", [True, False], ids=["znorm", "raw"])
def test_brute_force_range_matches_reference(znorm, measure, r):
    rng = np.random.default_rng(3)
    data = np.cumsum(rng.normal(size=(6, 150)), -1).astype(np.float32)
    q = data[2, 30:110] + rng.normal(size=80).astype(np.float32) * 0.05
    eps = _eps(data, q, znorm, measure, r, k=12, scale=1.05)
    want = j_brute(JCollection.from_array(data), q, eps, znorm=znorm,
                   measure=measure, r=r)
    coll = index_from_arrays(
        _arrays(JEngine.from_collection(
            JCollection.from_array(data), JParams(znorm=znorm, **PARAMS),
            block_size=16, num_levels=2).index),
        EnvelopeParams(znorm=znorm, **PARAMS), device="cpu").collection
    got = brute_force_range(coll, q, eps, znorm=znorm, measure=measure, r=r)
    assert len(want.dists) >= 11
    np.testing.assert_array_equal(got.series, want.series)
    np.testing.assert_array_equal(got.offsets, want.offsets)
    np.testing.assert_allclose(got.dists, want.dists, rtol=0,
                               atol=5e-3 if measure == "ed" else 1e-3)


def _plan_inputs(engines, measure, r, seeds=(10, 11, 12, 13)):
    """Four queries' prepared tensors and lower bounds over the reference
    index (numpy), and eps2 per query: the radius past its 6th, 10th,
    20th and 28th neighbour (so a CAP-row buffer holds the first two
    queries' hits and not the last two's)."""
    znorm, data, ref, port = engines
    qs = [_noised(data, seed=s, sid=s % 16) for s in seeds]
    spec = JQuerySpec(measure=measure, r=r)
    nseg, qn, dlo, dhi, qb, qh = ref._stack_prepared(qs, spec)
    env = ref.index.search_envelopes()
    lbs = np.array(jplanner.env_lower_bounds_batch(
        qb, qh, env, ref.index.breakpoints, ref.params.seg_len, nseg,
        False))
    eps2 = np.float32([_eps(data, q, znorm, measure, r, k=k, scale=1.05)
                       ** 2 for q, k in zip(qs, (6, 10, 20, 28))])
    return (np.array(qn), np.array(dlo), np.array(dhi), lbs, eps2, env)


@pytest.mark.parametrize("measure,r", MEASURES)
def test_device_range_pack_matches_reference(engines, measure, r):
    """The sortless pack, bit for bit, with some bounds +inf (invalid
    rows), a query with radius 0 (only bounds of 0 pass) and one with no
    finite bound (no candidate)."""
    _, _, _, port = engines
    _, _, _, lbs, eps2, env = _plan_inputs(engines, measure, r)
    lbs[1, ::7] = np.inf
    eps2[2] = 0.0
    lbs[3] = np.inf
    n_pad = executor.pow2ceil(lbs.shape[1])
    want = jplanner.device_range_pack(env.series_id, env.anchor, env.n_master,
                                      jnp.asarray(lbs), jnp.asarray(eps2),
                                      n_pad=n_pad)
    penv = port.index.search_envelopes()
    got = planner.device_range_pack(penv.series_id, penv.anchor,
                                    penv.n_master, torch.from_numpy(lbs),
                                    torch.from_numpy(eps2), n_pad=n_pad)
    for x, y in zip(got, want):
        assert x.dtype in (torch.int32, torch.float32)
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert np.isinf(got[3][3].numpy()).all()


@pytest.mark.parametrize("measure,r", MEASURES)
def test_range_scan_matches_reference_chunk_by_chunk(engines, measure, r):
    """The port's range scan (its plain steps, on the CPU) against the
    reference's `_device_range_core`, after every chunk: the reference is
    run on the plan with every bound past chunk i set to +inf (its scan
    then stops after chunk i with the state the full scan has there).  A
    CAP-row buffer overflows part of the batch midway."""
    znorm, data, ref, port = engines
    qn, dlo, dhi, lbs, eps2, env = _plan_inputs(engines, measure, r)
    n_pad = executor.pow2ceil(lbs.shape[1])
    plan = [np.array(x) for x in jplanner.device_range_pack(
        env.series_id, env.anchor, env.n_master, jnp.asarray(lbs),
        jnp.asarray(eps2), n_pad=n_pad)[:4]]
    chunk, cap, g = 16, CAP, ref.params.gamma + 1
    coll = port.index.collection
    jcoll = ref.index.collection
    pt = [torch.from_numpy(x) for x in plan]
    q_t, lo_t, hi_t, eps_t = (torch.from_numpy(x)
                              for x in (qn, dlo, dhi, eps2))
    b = qn.shape[0]
    n_chunks = n_pad // chunk
    buf = (torch.full((b, cap), float("inf")),
           torch.full((b, cap), -1, dtype=torch.int32),
           torch.full((b, cap), -1, dtype=torch.int32))
    cnt = torch.zeros(b, dtype=torch.int32)
    ovf = torch.full((b,), n_chunks, dtype=torch.int32)
    stats = torch.zeros((b, 6), dtype=torch.int32)
    last = int(np.isfinite(plan[3]).sum(1).max()) // chunk + 1
    for i in range(last):
        executor._range_chunk_step(
            coll, *pt, q_t, lo_t, hi_t, i, eps_t, buf, cnt, ovf, stats, g=g,
            chunk=chunk, znorm=znorm, measure=measure, r=r)
        cut = plan[3].copy()
        cut[:, (i + 1) * chunk:] = np.inf
        want = jexecutor.device_range_scan(
            jcoll, plan[0], plan[1], plan[2], cut, qn, dlo, dhi, eps2,
            capacity=cap, g=g, measure=measure, r=r, znorm=znorm,
            chunk_size=chunk)
        w_d2, w_sid, w_off, w_cnt, w_ovf, w_st = (np.asarray(x)
                                                  for x in want[:6])
        np.testing.assert_array_equal(cnt.numpy(), w_cnt)
        np.testing.assert_array_equal(ovf.numpy(), w_ovf)
        np.testing.assert_array_equal(stats.numpy(), w_st)
        np.testing.assert_array_equal(buf[1].numpy(), w_sid)
        np.testing.assert_array_equal(buf[2].numpy(), w_off)
        atol = 1e-3 if measure == "ed" else 1e-4
        np.testing.assert_allclose(buf[0].numpy(), w_d2, rtol=1e-4,
                                   atol=atol)
    assert (ovf < n_chunks).any() and (ovf == n_chunks).any()


def test_range_append_all_or_nothing_at_the_edge():
    """The plain append: a chunk whose hits exactly fill the buffer is
    written (cnt + hits == cap); one more hit and none is written, ovf
    records the chunk once, and later chunks leave it."""
    b, chunk, g, cap = 2, 2, 3, 4
    sids = torch.tensor([[5, 6, 7, 8], [1, 2, 3, 4]], dtype=torch.int32)
    anchors = torch.tensor([[0, 10, 20, 30], [3, 6, 9, 12]],
                           dtype=torch.int32)
    eps2 = torch.tensor([1.0, 1.0])
    buf = (torch.full((b, cap), float("inf")),
           torch.full((b, cap), -1, dtype=torch.int32),
           torch.full((b, cap), -1, dtype=torch.int32))
    cnt = torch.tensor([1, 1], dtype=torch.int32)
    ovf = torch.tensor([2, 2], dtype=torch.int32)
    inf = float("inf")
    # query 0: 3 hits (1 + 3 == cap, written); query 1: 4 hits (refused)
    d2 = torch.tensor([[0.5, inf, 1.0, 2.0, 0.0, inf],
                       [0.1, 0.2, 0.3, 1.0, inf, 5.0]])
    range_append(d2, sids, anchors, eps2, buf, cnt, ovf, i=0, chunk=chunk,
                 g=g)
    assert cnt.tolist() == [4, 1] and ovf.tolist() == [2, 0]
    assert buf[0][0].tolist() == [inf, 0.5, 1.0, 0.0]
    assert buf[1][0].tolist() == [-1, 5, 5, 6]
    assert buf[2][0].tolist() == [-1, 0, 2, 11]
    assert buf[1][1].tolist() == [-1, -1, -1, -1]
    range_append(d2, sids, anchors, eps2, buf, cnt, ovf, i=1, chunk=chunk,
                 g=g)
    assert cnt.tolist() == [4, 1] and ovf.tolist() == [1, 0]
