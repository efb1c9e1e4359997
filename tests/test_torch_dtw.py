"""Port parity, the DTW slice: `repro_torch` (CPU) against the JAX package
on the same numpy inputs.

  * `dtw_envelope` is exact (min and max only): equal to the reference;
  * `fused_gather_lb_keogh` (its plain version, what the wrapper runs for
    CPU tensors) against the Pallas kernel in interpret mode, within the
    tolerances of the reference's own kernel test (lb2 rtol 2e-4 /
    atol 2e-3, mu 1e-4 / 1e-4, sd 1e-3 / 1e-4);
  * `dtw_band` against `dtw_band_pallas` (interpret mode), the
    reference's `core/dtw.dtw_band` and a numpy triple loop, rtol/atol
    1e-4 — the DP is summed in another order;
  * the LB chunk entry's survivor list and `dtw_survivors`' values at
    the survivors' positions against the reference's `_survivors_first`
    / `_survivor_bucket`, and against the composition they replaced
    (plain LB, mask, pack, plain DP, unpack), value for value;
  * the engine on the reference's index carried over with
    `convert.index_from_arrays`: DTW exact k-NN gives identical (series,
    offset) and identical `SearchStats`, and distances within rtol 1e-4 /
    atol 1e-5 — both engines report their float32 DP values unpolished,
    and the two DPs round differently; both agree with the reference's
    brute force within 1e-3.

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
from repro.core import dtw as jdtw  # noqa: E402
from repro.core import executor as jexecutor  # noqa: E402
from repro.core.search import brute_force_knn as j_brute  # noqa: E402
from repro.core.types import EnvelopeSet as JEnvelopeSet  # noqa: E402
from repro.kernels.dtw_band import dtw_band_pallas  # noqa: E402
from repro.kernels.fused_verify import \
    fused_gather_lb_keogh as j_fused_lb  # noqa: E402
from repro_torch.convert import index_from_arrays  # noqa: E402
from repro_torch.core import (Collection, EnvelopeParams,  # noqa: E402
                              QuerySpec, UlisseEngine, dtw)
from repro_torch.core.search import brute_force_knn  # noqa: E402
from repro_torch.kernels.dtw_band import dtw_band, dtw_survivors  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.fused_verify import (  # noqa: E402
    fused_gather_lb_keogh, fused_gather_lb_keogh_chunk, gather_znorm)

PARAMS = dict(lmin=64, lmax=128, seg_len=16, card=64, gamma=8)


def _t(x):
    return torch.from_numpy(np.array(x))


def _numpy_dtw(q, c, r):
    """The textbook banded DP in float64 (the reference test's oracle)."""
    l = len(q)
    big = 1e30
    D = np.full((l, l), big)
    for i in range(l):
        for j in range(max(0, i - r), min(l, i + r + 1)):
            best = (0 if i == j == 0 else
                    min(D[i - 1, j] if i else big,
                        D[i - 1, j - 1] if i and j else big,
                        D[i, j - 1] if j else big))
            D[i, j] = (float(q[i]) - float(c[j])) ** 2 + best
    return D[l - 1, l - 1]


@pytest.mark.parametrize("shape,r", [((3, 50), 1), ((2, 4, 33), 5),
                                     ((64,), 31), ((5, 20), 20),
                                     ((2, 17), 80)])
def test_dtw_envelope_equals_reference(shape, r):
    q = np.random.default_rng(r).normal(size=shape).astype(np.float32)
    lo, hi = dtw.dtw_envelope(_t(q), r)
    jlo, jhi = jdtw.dtw_envelope(jnp.asarray(q), r)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))


def test_lb_keogh_matches_reference():
    rng = np.random.default_rng(3)
    q = rng.normal(size=(4, 48)).astype(np.float32)
    c = rng.normal(size=(4, 7, 48)).astype(np.float32)
    lo, hi = dtw.dtw_envelope(_t(q), 4)
    jlo, jhi = jdtw.dtw_envelope(jnp.asarray(q), 4)
    for squared in (True, False):
        got = dtw.lb_keogh(lo[:, None], hi[:, None], _t(c), squared)
        want = jdtw.lb_keogh(jlo[:, None], jhi[:, None], jnp.asarray(c),
                             squared)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)


def _fused_inputs(s, n, qlen, g, rows, b, seed):
    """Gather targets biased to the end-of-series overrun, DTW envelopes
    of random queries (true intervals), and the validity mask."""
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(s, n)).astype(np.float32) * 2 + 1
    sids = rng.integers(0, s, b * rows).astype(np.int32)
    anchors = rng.integers(0, n - qlen + 1, b * rows).astype(np.int32)
    anchors[0] = n - qlen                    # worst-case overrun
    q = rng.normal(size=(b, qlen)).astype(np.float32)
    lo, hi = (np.asarray(x) for x in jdtw.dtw_envelope(jnp.asarray(q), 5))
    valid = anchors[:, None] + np.arange(g) + qlen <= n
    return data, sids, anchors, lo, hi, valid


@pytest.mark.parametrize("s,n,qlen,g,rows,b", [(4, 96, 32, 1, 8, 1),
                                               (6, 128, 64, 9, 13, 1),
                                               (3, 192, 96, 5, 16, 3),
                                               (5, 256, 160, 49, 4, 2)])
@pytest.mark.parametrize("znorm", [False, True], ids=["raw", "znorm"])
def test_fused_gather_lb_keogh_matches_pallas(s, n, qlen, g, rows, b,
                                              znorm):
    data, sids, anchors, lo, hi, valid = _fused_inputs(s, n, qlen, g, rows,
                                                       b, seed=qlen + g)
    jc = JCollection.from_array(data)
    want = [np.asarray(x) for x in j_fused_lb(
        jc.data, jc.csum, jc.csum2, jc.csum_lo, jc.csum2_lo, jc.center,
        jnp.asarray(sids), jnp.asarray(anchors), jnp.asarray(lo),
        jnp.asarray(hi), g=g, rows=rows, znorm=znorm, interpret=True)]
    c = Collection.from_array(data, device="cpu")
    got = fused_gather_lb_keogh(c.data, c.csum, c.csum2, c.csum_lo,
                                c.csum2_lo, c.center, _t(sids),
                                _t(anchors), _t(lo), _t(hi), g=g,
                                rows=rows, znorm=znorm)
    for x in got:
        assert x.shape == (b * rows, g) and x.dtype == torch.float32
    for x, y, (rtol, atol) in zip(got, want, ((2e-4, 2e-3), (1e-4, 1e-4),
                                              (1e-3, 1e-4))):
        np.testing.assert_allclose(x.numpy()[valid], y[valid], rtol=rtol,
                                   atol=atol)
    if not znorm:
        assert (got[1].numpy() == 0).all() and (got[2].numpy() == 1).all()


@pytest.mark.parametrize("l,r,n", [(24, 3, 5), (64, 9, 7), (40, 40, 4),
                                   (33, 100, 3), (2, 1, 3)])
def test_dtw_band_matches_pallas_and_reference(l, r, n):
    rng = np.random.default_rng(l * 1000 + r)
    q = rng.normal(size=l).astype(np.float32)
    c = rng.normal(size=(n, l)).astype(np.float32)
    got = dtw_band(_t(q), _t(c), r).numpy()
    assert got.shape == (n,) and got.dtype == np.float32
    oracle = np.array([_numpy_dtw(q, cc, r) for cc in c])
    pallas = np.asarray(dtw_band_pallas(jnp.asarray(q), jnp.asarray(c), r,
                                        interpret=True))
    core = np.asarray(jdtw.dtw_band(jnp.asarray(q), jnp.asarray(c), r,
                                    squared=True))
    for want in (oracle, pallas, core):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_dtw_band_single_point_and_bad_window():
    q = _t(np.float32([1.5]))
    np.testing.assert_allclose(
        dtw_band(q, _t(np.float32([[0.5], [2.0]])), 3).numpy(), [1.0, 0.25])
    with pytest.raises(ValueError):
        dtw_band(q, _t(np.float32([[0.5]])), 0)


def _chunk_inputs(seed, *, s=6, n=120, qlen=48, b=3, rows=5, g=9):
    """One scan chunk of B queries: a random-walk collection, rows
    envelope rows per query (two rows of query 2 on the same (sid,
    anchor), so its candidates repeat), DTW envelopes of random queries
    (r = 6), and a candidate mask with about a tenth of the windows off
    (overrunning windows included, so the DP's clip is exercised)."""
    rng = np.random.default_rng(seed)
    data = np.cumsum(rng.normal(size=(s, n)), -1).astype(np.float32)
    sids = rng.integers(0, s, b * rows).astype(np.int32)
    anchors = rng.integers(0, n - qlen - g + 2, b * rows).astype(np.int32)
    anchors[0] = n - qlen                   # overruns past the series
    sids[2 * rows + 1], anchors[2 * rows + 1] = sids[2 * rows], \
        anchors[2 * rows]                   # duplicate candidates
    qs = rng.normal(size=(b, qlen)).astype(np.float32)
    lo, hi = (np.asarray(x) for x in jdtw.dtw_envelope(jnp.asarray(qs), 6))
    ok = rng.random((b, rows * g)) > 0.1
    ok[2, g:2 * g] = ok[2, :g]
    return data, sids, anchors, qs, lo, hi, ok, rows, g


def _chunk(data, sids, anchors, lo, hi, ok, kth, rows, g, znorm):
    c = Collection.from_array(data, device="cpu")
    return fused_gather_lb_keogh_chunk(
        c.data, c.csum, c.csum2, c.csum_lo, c.csum2_lo, c.center, _t(sids),
        _t(anchors), _t(lo), _t(hi), _t(ok), _t(kth), g=g, rows=rows,
        znorm=znorm)


@pytest.mark.parametrize("znorm", [False, True], ids=["raw", "znorm"])
def test_survivor_pack_and_dp_match_reference(znorm):
    """The chunk entry lists the reference's survivors (those its
    `_survivors_first` packs: none, some, all ok), and `dtw_survivors`
    writes at each survivor's position the reference's bucket-by-bucket
    DP value (`_survivor_bucket` over the packed list), +inf elsewhere."""
    data, sids, anchors, qs, lo, hi, ok, rows, g = _chunk_inputs(11)
    b, m, r, sb = qs.shape[0], rows * g, 6, 16
    c = Collection.from_array(data, device="cpu")
    lb2_all = fused_gather_lb_keogh(
        c.data, c.csum, c.csum2, c.csum_lo, c.csum2_lo, c.center, _t(sids),
        _t(anchors), _t(lo), _t(hi), g=g, rows=rows, znorm=znorm)[0]
    lbm = np.where(ok, lb2_all.numpy().reshape(b, m), np.inf)
    kth = np.float32([-np.inf, np.median(lbm[1][ok[1]]), np.inf])
    lb2, mu, sd, slist, nsurv, d2 = _chunk(data, sids, anchors, lo, hi, ok,
                                           kth, rows, g, znorm)
    surv = lbm < kth[:, None]
    np.testing.assert_array_equal(lb2.numpy().reshape(b, m), lbm)
    np.testing.assert_array_equal(nsurv.numpy(), surv.sum(1))
    assert list(nsurv.numpy()[[0, 2]]) == [0, ok[2].sum()]
    want_sidx = np.asarray(jexecutor._survivors_first(jnp.asarray(surv)))
    for i in range(b):
        np.testing.assert_array_equal(
            np.sort(slist.numpy()[i, :nsurv[i]]), want_sidx[i, :nsurv[i]])

    cand_sid = np.repeat(sids.reshape(b, rows), g, axis=1)
    cand_off = (anchors.reshape(b, rows)[:, :, None]
                + np.arange(g)).reshape(b, m).astype(np.int32)
    mu_b = mu.numpy().reshape(b, m)
    sd_b = sd.numpy().reshape(b, m)
    got = dtw_survivors(_t(data), _t(qs), slist, nsurv, _t(cand_sid),
                        _t(cand_off), _t(mu_b), _t(sd_b), d2, r=r,
                        znorm=znorm).numpy()
    want = np.full((b, m), np.inf, np.float32)
    for j in range(-(-m // sb)):
        pos, _, _, _, db = jexecutor._survivor_bucket(
            jnp.asarray(data), jnp.asarray(qs), jnp.asarray(cand_sid),
            jnp.asarray(cand_off), jnp.asarray(want_sidx), jnp.asarray(mu_b),
            jnp.asarray(sd_b), j, sb=sb, r=r, znorm=znorm)
        pos = np.asarray(pos)
        for i in range(b):
            live = pos < nsurv[i].item()
            want[i, want_sidx[i, pos[live]]] = np.asarray(db)[i, live]
    assert np.isinf(got[~surv]).all()
    np.testing.assert_allclose(got[surv], want[surv], rtol=1e-4, atol=1e-4)


def _old_composition(data, sids, anchors, qs, lo, hi, ok, kth, rows, g, r,
                     znorm):
    """The scan step before the chunk entry: plain LB, mask, survivors
    packed first (a stable argsort), the plain DP on the packed windows,
    and the values unpacked to their candidate positions."""
    b, m = ok.shape
    c = Collection.from_array(data, device="cpu")
    lb2, mu, sd = (x.numpy().reshape(b, m)
                   for x in ref.fused_gather_lb_keogh_ref(
                       c.data, c.csum, c.csum2, c.csum_lo, c.csum2_lo,
                       c.center, _t(sids), _t(anchors), _t(lo), _t(hi),
                       g=g, rows=rows, znorm=znorm))
    surv = np.where(ok, lb2, np.inf) < kth[:, None]
    n, qlen = data.shape[1], qs.shape[1]
    d2 = np.full((b, m), np.inf, np.float32)
    for i in range(b):
        pos = np.argsort(~surv[i], kind="stable")[:surv[i].sum()]
        if len(pos) == 0:
            continue
        e = i * rows + pos // g
        off = np.clip(anchors[e] + pos % g, 0, n - qlen)
        w = np.stack([data[sids[x], o:o + qlen] for x, o in zip(e, off)]
                     ).reshape(-1, qlen)
        if znorm:
            w = (_t(w) - _t(mu[i, pos])[:, None]) / _t(sd[i, pos])[:, None]
        d2[i, pos] = ref.dtw_band_ref(_t(qs[i]), _t(w), r).numpy()
    return surv, d2


@pytest.mark.parametrize("case", ["empty", "full", "one", "duplicates"])
@pytest.mark.parametrize("znorm", [False, True], ids=["raw", "znorm"])
def test_chunk_entry_equals_old_composition(case, znorm):
    """The plain chunk entry + plain DP against the composition they
    replace, value for value: no survivor, every candidate a survivor,
    one survivor per query, and a query whose survivors repeat
    (sid, off)."""
    data, sids, anchors, qs, lo, hi, ok, rows, g = _chunk_inputs(
        len(case) + znorm)
    b, m, r = qs.shape[0], rows * g, 6
    if case == "full":
        ok[:] = True
    c = Collection.from_array(data, device="cpu")
    lbm = np.where(ok, ref.fused_gather_lb_keogh_ref(
        c.data, c.csum, c.csum2, c.csum_lo, c.csum2_lo, c.center, _t(sids),
        _t(anchors), _t(lo), _t(hi), g=g, rows=rows, znorm=znorm)[0].numpy()
        .reshape(b, m), np.inf)
    kth = {"empty": np.full(b, -np.inf),
           "full": np.full(b, np.inf),
           "one": np.nextafter(lbm.min(1), np.inf),
           "duplicates": np.sort(lbm, 1)[:, m // 3]}[case].astype(np.float32)
    _, mu, sd, slist, nsurv, d2 = _chunk(data, sids, anchors, lo, hi, ok,
                                         kth, rows, g, znorm)
    cand_sid = np.repeat(sids.reshape(b, rows), g, axis=1)
    cand_off = (anchors.reshape(b, rows)[:, :, None]
                + np.arange(g)).reshape(b, m).astype(np.int32)
    got = dtw_survivors(_t(data), _t(qs), slist, nsurv, _t(cand_sid),
                        _t(cand_off), mu.reshape(b, m), sd.reshape(b, m),
                        d2, r=r, znorm=znorm).numpy()
    surv, want = _old_composition(data, sids, anchors, qs, lo, hi, ok, kth,
                                  rows, g, r, znorm)
    np.testing.assert_array_equal(nsurv.numpy(), surv.sum(1))
    # query 2's least bound may sit on its repeated candidates
    expect = {"empty": [0] * b, "full": list(ok.sum(1)),
              "one": [1, 1, int((lbm[2] == lbm[2].min()).sum())]}
    if case in expect:
        assert list(nsurv.numpy()) == expect[case]
    else:   # rows 2 * rows and 2 * rows + 1 hold the same candidates
        dup = np.arange(g)
        assert surv[2, dup].any()
        np.testing.assert_array_equal(got[2, dup + g][surv[2, dup]],
                                      got[2, dup][surv[2, dup]])
    np.testing.assert_array_equal(got, want)


# -- the engine -------------------------------------------------------------

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


CASES = {
    # one query, B = 1, a narrow window
    "single_r2": (dict(k=5, r=2), [(3, 20, 96)]),
    # 8 queries of one length (B = 8) plus 3 of other lengths (batches of
    # 2, padded, and 1): mixed lengths in one call
    "b8_mixed_r9": (dict(k=5, r=9), [(i, 3 * i, 96) for i in range(8)]
                    + [(9, 7, 64), (11, 40, 128), (12, 0, 64)]),
    # the pure scan: the pool starts empty, every early LB survives
    "no_approx_r9": (dict(k=3, r=9, approx_first=False),
                     [(2, 0, 112), (7, 50, 112)]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_dtw_engine_equals_reference(engines, case):
    znorm, data, ref, port, coll = engines
    spec_kw, windows = CASES[case]
    spec_kw = dict(spec_kw, measure="dtw")
    qs = _queries(data, windows, seed=len(case))
    want = ref.search(qs, JQuerySpec(**spec_kw))
    got = port.search(qs, QuerySpec(**spec_kw))
    assert len(got) == len(want) == len(qs)
    jcoll = JCollection.from_array(data)
    for i, (q, a, b) in enumerate(zip(qs, got, want)):
        np.testing.assert_array_equal(a.series, b.series)
        np.testing.assert_array_equal(a.offsets, b.offsets)
        np.testing.assert_allclose(a.dists, b.dists, rtol=1e-4, atol=1e-5)
        assert dataclasses.asdict(a.stats) == dataclasses.asdict(b.stats)
        assert a.stats.dtw_full == a.stats.true_dist_computations > 0
        assert a.stats.dtw_lb_keogh >= a.stats.dtw_full
        assert len(a.dists) == spec_kw["k"]
        assert np.isfinite(a.dists).all()
        if i < 2:       # the reference oracle compiles per query: two
            oracle = j_brute(jcoll, q, k=spec_kw["k"], znorm=znorm,
                             measure="dtw", r=spec_kw["r"])
            np.testing.assert_allclose(a.dists, oracle.dists, rtol=0,
                                       atol=1e-3)
        mine = brute_force_knn(coll, q, k=spec_kw["k"], znorm=znorm,
                               measure="dtw", r=spec_kw["r"])
        np.testing.assert_allclose(a.dists, mine.dists, rtol=0, atol=1e-3)


def test_port_dtw_brute_force_matches_reference(engines):
    """Both oracles run the closed form, whose float32 cumsum over the
    band cancels: the disagreement grows with r (measured ~4e-5 at
    r = 3..10, ~2e-4 at r = 40, ~1e-3 once the band covers the row), so
    the window here stays below the row and the tolerance is the
    brute-force check's 1e-3."""
    znorm, data, _, _, coll = engines
    q = _queries(data, [(4, 17, 100)], seed=5)[0]
    for r in (3, 40):
        got = brute_force_knn(coll, q, k=6, znorm=znorm, measure="dtw", r=r)
        want = j_brute(JCollection.from_array(data), q, k=6, znorm=znorm,
                       measure="dtw", r=r)
        np.testing.assert_array_equal(got.series, want.series)
        np.testing.assert_array_equal(got.offsets, want.offsets)
        np.testing.assert_allclose(got.dists, want.dists, rtol=0,
                                   atol=1e-3)


def test_dtw_range_and_approx_still_raise(engines):
    """DTW range still raises (ROADMAP item 8); DTW approx-only is ported
    (item 9) and answers with k finite ascending distances."""
    _, data, _, port, _ = engines
    q = data[0, :96]
    with pytest.raises(NotImplementedError, match="item 8"):
        port.search(q, QuerySpec(measure="dtw", r=4, eps=1.0))
    res = port.search(q, QuerySpec(measure="dtw", r=4, k=3, mode="approx"))
    assert len(res.dists) == 3 and np.isfinite(res.dists).all()
    assert (np.diff(res.dists) >= 0).all()


def test_dtw_kernels_never_take_the_plain_path_off_cpu():
    """A tensor off the CPU goes to the CUDA kernel or raises — here,
    with no card and no nvcc, the build raises (meta tensors stand in for
    device tensors; nothing is launched)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the kernel would run")
    meta = dict(device="meta")
    data = torch.empty((4, 64), **meta)
    sums = torch.empty((4, 65), **meta)
    idx = torch.zeros(8, dtype=torch.int32, **meta)
    env = torch.empty((1, 32), **meta)
    with pytest.raises(RuntimeError):
        fused_gather_lb_keogh(data, sums, sums, sums, sums,
                              torch.empty(4, **meta), idx, idx, env, env,
                              g=3, rows=8, znorm=True)
    with pytest.raises(RuntimeError):
        dtw_band(torch.empty(32, **meta), torch.empty((5, 32), **meta), 3)
    ok = torch.zeros((1, 24), dtype=torch.bool, **meta)
    kth = torch.empty(1, **meta)
    with pytest.raises(RuntimeError):
        fused_gather_lb_keogh_chunk(data, sums, sums, sums, sums,
                                    torch.empty(4, **meta), idx, idx, env,
                                    env, ok, kth, g=3, rows=8, znorm=True)
    vals = torch.empty((4, 3), **meta)
    with pytest.raises(RuntimeError):
        gather_znorm(data, idx[:4], idx[:4], vals, vals, qlen=32, g=3)
    pos = torch.zeros((2, 6), dtype=torch.int32, **meta)
    val = torch.empty((2, 6), **meta)
    with pytest.raises(RuntimeError):
        dtw_survivors(data, torch.empty((2, 32), **meta), pos,
                      torch.zeros(2, dtype=torch.int32, **meta), pos, pos,
                      val, val, val, r=3, znorm=True)
    assert fused_gather_lb_keogh.launches == dtw_band.launches == \
        dtw_survivors.launches == fused_gather_lb_keogh_chunk.launches == \
        gather_znorm.launches == 0
