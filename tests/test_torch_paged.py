"""Port parity, the paged tier: out-of-core answers of `repro_torch`
(CPU) must be BIT-EQUAL to whole-resident ones, and its paged scans equal
the JAX package's.

  * paged against resident with the page cache capped at 25% of the
    payload (evictions forced): znorm/raw x ED/DTW x k-NN/range (exact,
    pure scan, approx-only, overflow), on saved-then-opened indexes whose
    pages straddle shard boundaries — the same answers and `SearchStats`;
  * the range overflow continuation under paging (through `take_rows`)
    recovers the hit set of a large buffer;
  * cold-open -> append -> search stays paged and unmaterialized;
  * the cache accounting: `cache_bytes` never exceeds the budget,
    `reset_cache` zeroes it, the counters stay monotone;
  * `materialize()` copies into one destination (no row concatenation)
    and hands a single extent over with no copy;
  * a budget above the payload keeps the engine resident;
  * the pieces against the reference: `device_leaf_pack` with an
    ingestion delta bit for bit, and the paged scans
    (`paged_exact_scan`, `paged_range_scan`) against the reference's on
    the same plans and stores, chunk by chunk (the plan cut to +inf past
    chunk i, at the first, middle and last chunks): the same pool ids,
    hit buffer ids, counts, `ovf` chunks and counters, distances within
    the kernels' tolerances.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import Collection as JCollection  # noqa: E402
from repro.core import EnvelopeParams as JParams  # noqa: E402
from repro.core import UlisseEngine as JEngine  # noqa: E402
from repro.core import executor as jexecutor  # noqa: E402
from repro.core import planner as jplanner  # noqa: E402
from repro.storage.store import PayloadStore as JStore  # noqa: E402
from repro_torch.convert import index_from_arrays  # noqa: E402
from repro_torch.core import (Collection, EnvelopeParams,  # noqa: E402
                              QuerySpec, UlisseEngine, executor, planner)
from repro_torch.storage.store import (PayloadStore, open_index,  # noqa: E402
                                       save_index)

PARAMS = dict(lmin=64, lmax=128, gamma=8, seg_len=16, card=64)
BUILD = dict(block_size=16, num_levels=2)
# page_rows=4 over shard_rows=7: pages straddle shard boundaries, so
# read_rows' multi-extent copy is on the tested path too
PAGE, SHARD = 4, 7

SPECS = [
    QuerySpec(k=5),
    QuerySpec(k=3, measure="dtw", r=9),
    QuerySpec(k=5, approx_first=False),
    QuerySpec(mode="approx", k=3),
    QuerySpec(eps=8.0),
    QuerySpec(eps=8.0, measure="dtw", r=9),
    QuerySpec(eps=40.0, range_capacity=4),     # forces the overflow tail
]
SPEC_IDS = ["ed_knn", "dtw_knn", "ed_pure_scan", "ed_approx", "ed_range",
            "dtw_range", "range_overflow"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Run this module's small tensors on one torch thread: the tier-1 run
    has six workers on the same cores, and torch's default thread pool
    in each oversubscribes them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def walk():
    rng = np.random.default_rng(12345)
    return np.cumsum(rng.normal(size=(24, 192)), -1).astype(np.float32)


def _assert_same_result(a, b):
    np.testing.assert_array_equal(a.dists, b.dists)
    np.testing.assert_array_equal(a.series, b.series)
    np.testing.assert_array_equal(a.offsets, b.offsets)
    assert a.stats == b.stats


def _build(data, znorm=True):
    return UlisseEngine.from_collection(
        Collection.from_array(data, device="cpu"),
        EnvelopeParams(znorm=znorm, **PARAMS), device="cpu", **BUILD)


def _saved(engine, root, name="idx"):
    path = str(root / name)
    save_index(path, engine.index, shard_rows=SHARD, page_rows=PAGE)
    return path


def _paged_pair(path):
    """(resident, paged, budget) over one saved index, the paged side
    capped at 25% of the payload so that pages are evicted."""
    budget = open_index(path, device="cpu").collection.payload_bytes // 4
    resident = UlisseEngine.open(path, device="cpu")
    paged = UlisseEngine.open(path, memory_budget_bytes=budget,
                              device="cpu")
    assert paged.page_cache_stats() is not None
    return resident, paged, budget


@pytest.fixture(scope="module", params=[True, False], ids=["znorm", "raw"])
def saved_path(request, walk, tmp_path_factory):
    root = tmp_path_factory.mktemp(f"paged_{request.param}")
    return _saved(_build(walk, request.param), root)


@pytest.mark.parametrize("spec", SPECS, ids=SPEC_IDS)
def test_paged_bit_equal_vs_resident(saved_path, walk, spec):
    resident, paged, budget = _paged_pair(saved_path)
    store = paged.index.collection
    rng = np.random.default_rng(7)
    for q in (walk[3, 20:116], walk[11, 0:64],
              rng.normal(size=96).astype(np.float32)):
        _assert_same_result(resident.search(q, spec), paged.search(q, spec))
    st = store.stats()
    assert st["misses"] > 0
    assert st["evicted_bytes"] > 0, "a 25% budget must evict"
    assert st["cache_bytes"] <= budget
    assert not store.is_materialized, \
        "the paged path must never read the whole payload"


def test_cache_accounting_invariants(saved_path, walk):
    _, paged, budget = _paged_pair(saved_path)
    store = paged.index.collection
    orig = store.load_page
    loads = []

    def checked(p):
        blk = orig(p)
        assert store.cache_bytes <= budget
        loads.append(p)
        return blk

    store.load_page = checked
    try:
        paged.search(walk[5, 10:106], QuerySpec(k=5))
        paged.search(walk[9, 0:80], QuerySpec(eps=8.0))
    finally:
        del store.load_page
    assert loads, "paged searches read through load_page"
    before = store.stats()
    store.reset_cache()
    after = store.stats()
    assert after["cache_bytes"] == 0 and after["cached_pages"] == 0
    for key in ("hits", "misses", "evicted_bytes"):
        assert after[key] == before[key]


def test_cold_open_append_search_stays_paged(walk, tmp_path):
    """cold-open -> append -> search: the appended rows fold into pages,
    answers equal a resident engine's over the same state, and nothing
    is materialized."""
    path = _saved(_build(walk[:16]), tmp_path)
    resident, paged, _ = _paged_pair(path)
    resident.append(walk[16:])
    paged.append(walk[16:])
    assert not paged.index.collection.is_materialized
    q_app, q_main = walk[18, 30:126], walk[2, 5:101]
    for spec in (QuerySpec(k=5), QuerySpec(eps=8.0),
                 QuerySpec(k=3, measure="dtw", r=9)):
        for q in (q_app, q_main):
            _assert_same_result(resident.search(q, spec),
                                paged.search(q, spec))
    assert int(paged.search(q_app, QuerySpec(k=1)).series[0]) == 18
    assert not paged.index.collection.is_materialized


def test_range_overflow_continuation_matches_large_capacity(saved_path,
                                                            walk):
    """A 4-row hit buffer overflows; the paged host continuation (page
    cache reads from the recorded plan chunk on) recovers the hit set a
    2,048-row buffer collects in one pass."""
    _, paged, _ = _paged_pair(saved_path)
    _, paged_big, _ = _paged_pair(saved_path)
    q = walk[7, 15:111]
    small = paged.search(q, QuerySpec(eps=40.0, range_capacity=4))
    big = paged_big.search(q, QuerySpec(eps=40.0, range_capacity=2048))
    assert small.stats.range_overflows == 1
    o, ob = (np.lexsort((r.offsets, r.series)) for r in (small, big))
    np.testing.assert_array_equal(small.series[o], big.series[ob])
    np.testing.assert_array_equal(small.offsets[o], big.offsets[ob])
    np.testing.assert_allclose(small.dists[o], big.dists[ob], rtol=1e-5,
                               atol=1e-4)
    assert not paged.index.collection.is_materialized


def test_materialize_no_concatenate_and_zero_copy(walk, tmp_path,
                                                  monkeypatch):
    """materialize() copies shard by shard into one preallocated array
    (never a row-wise concatenation), and a single-shard payload becomes
    the CPU Collection's data with no copy."""
    eng = _build(walk)
    multi = _saved(eng, tmp_path, "multi")
    single = str(tmp_path / "single")
    save_index(single, eng.index, shard_rows=walk.shape[0], page_rows=PAGE)
    orig_cat = np.concatenate

    def boom(arrs, axis=0, *a, **k):
        if axis in (0, None):
            raise AssertionError("materialize must not concatenate rows")
        return orig_cat(arrs, axis, *a, **k)

    monkeypatch.setattr(np, "concatenate", boom)
    store_m = open_index(multi, device="cpu").collection
    np.testing.assert_array_equal(store_m.materialize().data.numpy(), walk)
    store_s = open_index(single, device="cpu").collection
    exts = store_s._extents()
    assert len(exts) == 1
    got = store_s.materialize().data.numpy()
    np.testing.assert_array_equal(got, walk)
    assert np.shares_memory(got, exts[0][1])


def test_budget_above_payload_stays_resident(saved_path, walk):
    store = open_index(saved_path, device="cpu").collection
    eng = UlisseEngine.open(saved_path, device="cpu",
                            memory_budget_bytes=store.payload_bytes * 2)
    assert eng.page_cache_stats() is None
    eng.search(walk[0, 0:96], QuerySpec(k=1))
    assert eng.index.collection.is_materialized


def test_budget_from_the_environment(saved_path, walk, monkeypatch):
    """ULISSE_MEMORY_BUDGET_BYTES is the default budget."""
    monkeypatch.setenv("ULISSE_MEMORY_BUDGET_BYTES", "4096")
    eng = UlisseEngine.open(saved_path, device="cpu")
    assert eng.memory_budget_bytes == 4096
    assert eng.page_cache_stats() is not None


# -- the pieces against the JAX package ----------------------------------


def _arrays(index):
    """A reference index flattened to the convert.py schema (its delta
    included)."""
    out = {f"envelopes.{f.name}": np.asarray(getattr(index.envelopes, f.name))
           for f in dataclasses.fields(index.envelopes)}
    if index.delta is not None:
        out.update({f"delta.{f.name}": np.asarray(getattr(index.delta,
                                                          f.name))
                    for f in dataclasses.fields(index.delta)})
    for i, lvl in enumerate(index.levels):
        for f in ("paa_lo", "paa_hi", "valid"):
            out[f"levels.{i}.{f}"] = np.asarray(getattr(lvl, f))
    for f in ("data", "csum", "csum2", "center", "csum_lo", "csum2_lo"):
        out[f"collection.{f}"] = np.asarray(getattr(index.collection, f))
    out["breakpoints"] = np.asarray(index.breakpoints)
    return out


def _ref_pair_with_delta(walk, n_main=16):
    """A reference engine over walk[:n_main] with walk[n_main:] appended
    (an uncompacted delta) and the port's engine over the same index."""
    ref = JEngine.from_collection(JCollection.from_array(walk[:n_main]),
                                  JParams(**PARAMS), **BUILD)
    ref.append(walk[n_main:])
    return ref, UlisseEngine.from_index(
        index_from_arrays(_arrays(ref.index), EnvelopeParams(**PARAMS),
                          device="cpu"), device="cpu")


def test_device_leaf_pack_with_delta_matches_reference(walk):
    ref, port = _ref_pair_with_delta(walk)
    env, penv = ref.index.search_envelopes(), port.index.search_envelopes()
    n_main = ref.index.envelopes.size
    assert penv.size > n_main
    nblk = ref.index.levels[-1].size
    rng = np.random.default_rng(3)
    blk = rng.random((4, nblk)).astype(np.float32)
    blk[1, ::3] = np.inf
    blk[2, :5] = 0.0                       # ties at 0 keep the stable order
    for chunk, n_leaves in ((16, 4), (32, nblk)):
        want = jplanner.device_leaf_pack(
            env.series_id, env.anchor, env.n_master, env.valid,
            jnp.asarray(blk), n_main=n_main, block_size=16, chunk=chunk,
            n_leaves=n_leaves)
        got = planner.device_leaf_pack(
            penv.series_id, penv.anchor, penv.n_master, penv.valid,
            torch.from_numpy(blk), n_main=n_main, block_size=16,
            chunk=chunk, n_leaves=n_leaves)
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def _scan_inputs(ref, measure, r, seed=11):
    """A batch of 4 noisy queries, their prep and bounds on both sides."""
    rng = np.random.default_rng(seed)
    data = np.asarray(ref.index.collection.data)
    qs = np.stack([data[s, o:o + 80] + rng.normal(size=80).astype(
        np.float32) * 0.05 for s, o in ((3, 10), (18, 40), (20, 0),
                                        (7, 90))])
    p = ref.params
    qn, dlo, dhi, qb, qh = (np.asarray(x) for x in
                            jplanner.prepare_query_batch(
                                jnp.asarray(qs), p.seg_len, p.znorm,
                                measure, r))
    env = ref.index.search_envelopes()
    lbs = np.asarray(jplanner.env_lower_bounds_batch(
        jnp.asarray(qb), jnp.asarray(qh), env, ref.index.breakpoints,
        p.seg_len, p.query_segments(80), False))
    return qn, dlo, dhi, lbs, env


def _stores(ref, cache):
    data = np.asarray(ref.index.collection.data)
    return (JStore.from_arrays(data, page_rows=PAGE,
                               cache_limit_bytes=cache),
            PayloadStore.from_arrays(data, page_rows=PAGE,
                                     cache_limit_bytes=cache, device="cpu"))


@pytest.mark.parametrize("measure,r", [("ed", 0), ("dtw", 9)])
def test_paged_exact_scan_matches_reference_chunk_by_chunk(walk, measure, r):
    """`paged_exact_scan` against the reference's on the LB-sorted plan of
    main ++ delta, cut to +inf past chunk i for every i: the same pool
    ids and counters, d2 within the kernels' tolerance."""
    ref, _ = _ref_pair_with_delta(walk)
    qn, dlo, dhi, lbs, env = _scan_inputs(ref, measure, r)
    b, k, chunk, g = qn.shape[0], 3, 16, ref.params.gamma + 1
    n_pad = jexecutor.pow2ceil(lbs.shape[1])
    none = jnp.full((b, 1), lbs.shape[1], jnp.int32)
    plan = [np.array(x) for x in jplanner.device_scan_pack(
        env.series_id, env.anchor, env.n_master, jnp.asarray(lbs), none,
        jnp.zeros((b,), jnp.int32), chunk=1, n_pad=n_pad)[:4]]
    jstore, pstore = _stores(ref, 3 * 4 * 4 * 193 * 4)
    seed = (np.full((b, k), np.inf, np.float32),
            np.full((b, k), -1, np.int32), np.full((b, k), -1, np.int32))
    last = int(np.isfinite(plan[3]).sum(1).max()) // chunk + 1
    for i in sorted({0, last // 2, last - 1}):
        cut = plan[3].copy()
        cut[:, (i + 1) * chunk:] = np.inf
        want = jexecutor.paged_exact_scan(
            jstore, plan[0], plan[1], plan[2], cut, qn, dlo, dhi, *seed,
            k=k, g=g, measure=measure, r=r, znorm=True, chunk_size=chunk)
        got = executor.paged_exact_scan(
            pstore, *(torch.from_numpy(x) for x in (*plan[:3], cut, qn,
                                                     dlo, dhi, *seed)),
            k=k, g=g, measure=measure, r=r, znorm=True, chunk_size=chunk)
        w = [np.asarray(x) for x in want]
        np.testing.assert_array_equal(got[1].numpy(), w[1])
        np.testing.assert_array_equal(got[2].numpy(), w[2])
        np.testing.assert_array_equal(got[3].numpy(), w[3])
        np.testing.assert_allclose(got[0].numpy(), w[0], rtol=1e-4,
                                   atol=1e-3 if measure == "ed" else 1e-4)
    assert pstore.stats()["evicted_bytes"] > 0


@pytest.mark.parametrize("measure,r,quantile", [("ed", 0, 0.3),
                                                ("dtw", 9, 0.5)])
def test_paged_range_scan_matches_reference_chunk_by_chunk(walk, measure, r,
                                                           quantile):
    """`paged_range_scan` against the reference's on the range pack of
    main ++ delta, cut past chunk i for every i, with a hit buffer that
    overflows part of the batch midway (eps2 a quantile of the bounds):
    the same hit ids, counts, `ovf` plan chunks and counters, d2 within
    the kernels' tolerance."""
    ref, _ = _ref_pair_with_delta(walk)
    qn, dlo, dhi, lbs, env = _scan_inputs(ref, measure, r, seed=5)
    b, chunk, g, cap = qn.shape[0], 16, ref.params.gamma + 1, 16
    eps2 = np.quantile(lbs.astype(np.float64) ** 2, quantile,
                       axis=1).astype(np.float32)
    n_pad = jexecutor.pow2ceil(lbs.shape[1])
    plan = [np.array(x) for x in jplanner.device_range_pack(
        env.series_id, env.anchor, env.n_master, jnp.asarray(lbs),
        jnp.asarray(eps2), n_pad=n_pad)[:4]]
    jstore, pstore = _stores(ref, 3 * 4 * 4 * 193 * 4)
    last = int(np.isfinite(plan[3]).sum(1).max()) // chunk + 1
    ovf_seen = []
    for i in sorted({0, last // 3, 2 * last // 3, last - 1}):
        cut = plan[3].copy()
        cut[:, (i + 1) * chunk:] = np.inf
        want = jexecutor.paged_range_scan(
            jstore, plan[0], plan[1], plan[2], cut, qn, dlo, dhi, eps2,
            capacity=cap, g=g, measure=measure, r=r, znorm=True,
            chunk_size=chunk)
        got = executor.paged_range_scan(
            pstore, *(torch.from_numpy(x) for x in (*plan[:3], cut, qn,
                                                     dlo, dhi, eps2)),
            capacity=cap, g=g, measure=measure, r=r, znorm=True,
            chunk_size=chunk)
        assert got[6] == want[6] == chunk
        for c in (1, 2, 3, 4, 5):
            np.testing.assert_array_equal(got[c].numpy(),
                                          np.asarray(want[c]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=1e-4,
                                   atol=1e-3 if measure == "ed" else 1e-4)
        ovf_seen.append(got[4].numpy())
    n_chunks = n_pad // chunk
    assert (ovf_seen[-1] < n_chunks).any() and (ovf_seen[-1] == n_chunks).any()


def test_chunk_page_schedule_matches_reference():
    rng = np.random.default_rng(2)
    sids = rng.integers(0, 24, size=(3, 64)).astype(np.int32)
    for i in range(4):
        for x, y in zip(planner.chunk_pages(sids, i, 16, PAGE),
                        jplanner.chunk_pages(sids, i, 16, PAGE)):
            np.testing.assert_array_equal(x, y)
    for x, y in zip(planner.chunk_page_schedule(sids, PAGE, 16),
                    jplanner.chunk_page_schedule(sids, PAGE, 16)):
        np.testing.assert_array_equal(x, y)
