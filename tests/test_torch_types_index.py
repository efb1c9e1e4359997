"""Port parity, types through index: repro_torch (CPU) against the JAX
package on the same numpy inputs.

  * Collection prefix sums are bit-equal (the same host float64 code,
    computed block by block);
  * breakpoints, symbols and the stable iSAX sort are equal, ties
    included;
  * the port's own index build agrees with the reference's on >= 99.9%
    of the iSAX symbols (both accumulate float32 cumsums, whose rounding
    may differ), its lower bounds never exceed the true distance, and it
    answers k-NN queries like the reference;
  * `index_from_arrays` carries a reference index over unchanged.
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
from repro.core import isax as jisax  # noqa: E402
from repro.core import paa as jpaa  # noqa: E402
from repro.core.envelope import build_envelope_set as j_build_set  # noqa: E402
from repro.core.index import build_index as j_build_index  # noqa: E402
from repro.core.types import EnvelopeSet as JEnvelopeSet  # noqa: E402
from repro.core.types import host_prefix_stats as j_host_stats  # noqa: E402
from repro_torch.convert import index_from_arrays  # noqa: E402
from repro_torch.core import (Collection, EnvelopeParams,  # noqa: E402
                              QuerySpec, UlisseEngine)
from repro_torch.core import isax, paa, planner, types  # noqa: E402
from repro_torch.core.envelope import build_envelope_set  # noqa: E402
from repro_torch.core.index import build_index  # noqa: E402
from repro_torch.core.types import ENVELOPE_FIELDS  # noqa: E402

PARAMS = dict(lmin=64, lmax=128, seg_len=16, card=64, gamma=8)
COLL_FIELDS = ("data", "csum", "csum2", "center", "csum_lo", "csum2_lo")


def _walk(seed, s=16, n=192):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.normal(size=(s, n)), axis=-1).astype(np.float32)


def _index_arrays(index, fields=ENVELOPE_FIELDS):
    """Any index (either package) flattened to the convert.py schema."""
    out = {f"envelopes.{f}": np.asarray(getattr(index.envelopes, f))
           for f in fields}
    for i, lvl in enumerate(index.levels):
        for f in ("paa_lo", "paa_hi", "valid"):
            out[f"levels.{i}.{f}"] = np.asarray(getattr(lvl, f))
    for f in COLL_FIELDS:
        out[f"collection.{f}"] = np.asarray(getattr(index.collection, f))
    out["breakpoints"] = np.asarray(index.breakpoints)
    return out


def test_collection_fields_bit_equal(monkeypatch):
    data = _walk(1, s=37, n=150) * 3.0 + 7.0
    ref = JCollection.from_array(data)
    # small stats blocks: the port computes the prefix sums block by block
    monkeypatch.setattr(types, "_STATS_BLOCK_ROWS", 8)
    port = Collection.from_array(data, device="cpu")
    for f in COLL_FIELDS:
        np.testing.assert_array_equal(getattr(port, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    for got, want in zip(types.host_prefix_stats(data[:5]),
                         j_host_stats(data[:5])):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("card", [2, 4, 8, 16, 32, 64, 128, 256])
def test_gaussian_breakpoints_equal_reference(card):
    want = np.asarray(jisax.gaussian_breakpoints(card))
    got = isax.gaussian_breakpoints(card).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32


def test_gaussian_breakpoints_every_card_equal_reference():
    """Every alphabet the index accepts, card in [2, 256]: the port's
    breakpoints equal the reference's bit for bit.  The reference side is
    `repro.core.isax.gaussian_breakpoints`'s own computation — float32
    quantiles float32(i) / card through JAX's float32 ndtri — in one
    vectorized call over all 32,640 quantiles."""
    from jax.scipy.special import ndtri
    cards = range(2, 257)
    qs = np.concatenate([np.arange(1, c, dtype=np.float32) / np.float32(c)
                         for c in cards])
    want = np.asarray(ndtri(jnp.asarray(qs)).astype(jnp.float32))
    got = np.concatenate([isax.gaussian_breakpoints(c).numpy()
                          for c in cards])
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    for card in (3, 100, 255):       # the vectorized call is the per-card one
        np.testing.assert_array_equal(
            isax.gaussian_breakpoints(card).numpy(),
            np.asarray(jisax.gaussian_breakpoints(card)))
    for card in (1, 257):
        with pytest.raises(ValueError):
            isax.gaussian_breakpoints(card)


@pytest.mark.parametrize("znorm", [True, False], ids=["znorm", "raw"])
def test_card_100_index_answers_like_reference(znorm):
    """A non-power-of-two alphabet: the reference's index carried over by
    `index_from_arrays` (raw and znorm) and, for znorm, the port's own
    build answer like the reference engine — identical (series,
    offsets), distances to 1e-9 (float64 rescore), identical
    SearchStats; the own build's breakpoints and symbols equal the
    reference's.  (A raw build calibrates the breakpoints on its own
    float32 PAA statistics, which may move an ulp: ROADMAP P2.)"""
    data = _walk(21)
    params = dict(PARAMS, card=100)
    jp = JParams(znorm=znorm, **params)
    p = EnvelopeParams(znorm=znorm, **params)
    jidx = j_build_index(JCollection.from_array(data), jp, block_size=16,
                         num_levels=2)
    indexes = []
    if znorm:
        own = build_index(Collection.from_array(data, device="cpu"), p,
                          block_size=16, num_levels=2)
        np.testing.assert_array_equal(own.breakpoints.numpy(),
                                      np.asarray(jidx.breakpoints))
        for f in ("sym_lo", "sym_hi"):
            np.testing.assert_array_equal(
                getattr(own.envelopes, f).numpy(),
                np.asarray(getattr(jidx.envelopes, f)), err_msg=f)
        indexes.append(own)
    converted = index_from_arrays(_index_arrays(
        jidx, fields=[f.name for f in dataclasses.fields(JEnvelopeSet)]),
        p, device="cpu")
    rng = np.random.default_rng(8)
    qs = [data[i, 7:7 + qlen] + rng.normal(size=qlen).astype(np.float32)
          * 0.05 for i, qlen in ((1, 96), (4, 96), (10, 128))]
    want = JEngine.from_index(jidx).search(qs, JQuerySpec(k=4))
    for idx in [converted] + indexes:
        got = UlisseEngine.from_index(idx, device="cpu").search(
            qs, QuerySpec(k=4))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.series, b.series)
            np.testing.assert_array_equal(a.offsets, b.offsets)
            np.testing.assert_allclose(a.dists, b.dists, rtol=0, atol=1e-9)
            assert dataclasses.asdict(a.stats) == dataclasses.asdict(b.stats)


def test_torch_ndtri_differs_from_reference():
    """Why the port stores the reference's quantiles: torch's float32
    ndtri rounds differently (so a computed table would move symbols)."""
    qs = torch.arange(1, 256, dtype=torch.float32) / 256
    computed = torch.special.ndtri(qs).numpy()
    want = np.asarray(jisax.gaussian_breakpoints(256))
    assert (computed != want).any()
    np.testing.assert_allclose(computed, want, rtol=0, atol=1e-6)


def test_non_pow2_breakpoints_within_an_ulp():
    got = isax.gaussian_breakpoints(10).numpy()
    want = np.asarray(jisax.gaussian_breakpoints(10))
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-7)


def test_symbolize_equal_on_ties():
    bp = np.array(jisax.gaussian_breakpoints(16))
    rng = np.random.default_rng(2)
    # the neighbours of the zero breakpoint are denormals, which XLA on
    # the CPU flushes to zero and torch does not: left out
    nz = bp[bp != 0]
    vals = np.concatenate([bp, np.nextafter(nz, -np.inf),
                           np.nextafter(nz, np.inf), [-np.inf, np.inf],
                           rng.normal(size=203) * 2]).astype(np.float32)
    vals = vals.reshape(-1, 4)
    got = isax.symbolize(torch.from_numpy(vals), torch.from_numpy(bp))
    want = np.asarray(jisax.symbolize(jnp.asarray(vals), jnp.asarray(bp)))
    np.testing.assert_array_equal(got.numpy(), want)
    sym = got
    for fn_t, fn_j in ((isax.beta_lower, jisax.beta_lower),
                       (isax.beta_upper, jisax.beta_upper)):
        np.testing.assert_array_equal(
            fn_t(sym, torch.from_numpy(bp)).numpy(),
            np.asarray(fn_j(jnp.asarray(sym.numpy()), jnp.asarray(bp))))


def test_argsort_by_isax_stable_on_ties():
    rng = np.random.default_rng(3)
    # a 3-letter alphabet over 3 segments: many fully tied words
    sym = rng.integers(0, 3, size=(300, 3)).astype(np.int32)
    got = isax.argsort_by_isax(torch.from_numpy(sym)).numpy()
    want = np.asarray(jisax.argsort_by_isax(jnp.asarray(sym)))
    np.testing.assert_array_equal(got, want)


def test_paa_and_znormalize_match_reference():
    x = _walk(4, s=5, n=100)
    np.testing.assert_allclose(paa.paa(torch.from_numpy(x), 16).numpy(),
                               np.asarray(jpaa.paa(jnp.asarray(x), 16)),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(
        paa.znormalize(torch.from_numpy(x)).numpy(),
        np.asarray(jpaa.znormalize(jnp.asarray(x))), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", params=[True, False], ids=["znorm", "raw"])
def own_build(request):
    """(params, data, reference index, port index built by the port)."""
    znorm = request.param
    data = _walk(5)
    jp = JParams(znorm=znorm, **PARAMS)
    p = EnvelopeParams(znorm=znorm, **PARAMS)
    jidx = j_build_index(JCollection.from_array(data), jp, block_size=16,
                         num_levels=2)
    idx = build_index(Collection.from_array(data, device="cpu"), p,
                      block_size=16, num_levels=2)
    return p, data, jidx, idx


def test_own_build_symbol_agreement(own_build):
    p, data, jidx, idx = own_build
    jp = JParams(**dataclasses.asdict(p))
    # the unsorted sets: agreement is per (series, anchor) envelope
    ref = j_build_set(JCollection.from_array(data), jp, jidx.breakpoints)
    got = build_envelope_set(idx.collection, p, idx.breakpoints)
    # znorm: the stored reference quantiles; raw: calibrated on the
    # port's own float32 mean/std of a PAA sample (an ulp may move)
    np.testing.assert_allclose(idx.breakpoints.numpy(),
                               np.asarray(jidx.breakpoints),
                               rtol=0 if p.znorm else 1e-6, atol=0)
    for f in ("series_id", "anchor", "n_master", "valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)))
    for f in ("sym_lo", "sym_hi"):
        agree = (getattr(got, f).numpy()
                 == np.asarray(getattr(ref, f))).mean()
        assert agree >= 0.999, (f, agree)
    for f in ("paa_lo", "paa_hi"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)),
                                   rtol=1e-5, atol=1e-5)
    assert idx.envelopes.size == jidx.envelopes.size
    assert [lvl.size for lvl in idx.levels] == \
        [lvl.size for lvl in jidx.levels]


def test_own_build_lower_bounds_never_exceed_distance(own_build):
    p, data, _, idx = own_build
    env = idx.envelopes
    n = data.shape[1]
    rng = np.random.default_rng(6)
    sid = env.series_id.numpy()[:, None]
    off = env.anchor.numpy()[:, None] + np.arange(p.gamma + 1)   # (N, g)
    for qlen in (64, 100, 128):
        q = data[rng.integers(16), 10:10 + qlen] \
            + rng.normal(size=qlen).astype(np.float32) * 0.3
        qn, _, _, qb, qh = planner.prepare_query_batch(
            torch.from_numpy(q)[None], p.seg_len, p.znorm)
        # every candidate window of every envelope, float64 distances
        ok = ((np.arange(p.gamma + 1) < env.n_master.numpy()[:, None])
              & (off + qlen <= n) & env.valid.numpy()[:, None])
        w = data[sid[..., None], np.clip(off, 0, n - qlen)[..., None]
                 + np.arange(qlen)].astype(np.float64)      # (N, g, qlen)
        if p.znorm:
            w = (w - w.mean(-1, keepdims=True)) \
                / np.maximum(w.std(-1, keepdims=True), 1e-8)
        d = np.sqrt(((w - qn[0].double().numpy()) ** 2).sum(-1))
        d_min = np.where(ok, d, np.inf).min(axis=1)         # (N,)
        for use_paa in (False, True):
            lb = planner.env_lower_bounds_batch(
                qb, qh, env, idx.breakpoints, p.seg_len,
                p.query_segments(qlen), use_paa)[0].double().numpy()
            assert (lb <= d_min + 1e-4).all(), (qlen, use_paa)
            assert np.isfinite(d_min).sum() > 0


def test_own_build_answers_like_reference(own_build):
    p, data, jidx, idx = own_build
    rng = np.random.default_rng(7)
    qs = [data[i, 5:5 + qlen] + rng.normal(size=qlen).astype(np.float32)
          * 0.05 for i, qlen in ((0, 96), (3, 64), (9, 128))]
    want = JEngine.from_index(jidx).search(qs, JQuerySpec(k=3))
    got = UlisseEngine.from_index(idx, device="cpu").search(
        qs, QuerySpec(k=3))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.series, b.series)
        np.testing.assert_array_equal(a.offsets, b.offsets)
        np.testing.assert_allclose(a.dists, b.dists, rtol=0, atol=1e-9)


def test_envelope_breakpoint_bounds_match_reference(own_build):
    from repro.core import bounds as jbounds
    from repro_torch.core import bounds
    _, _, jidx, _ = own_build
    idx = index_from_arrays(_index_arrays(
        jidx, fields=[f.name for f in dataclasses.fields(JEnvelopeSet)]),
        own_build[0], device="cpu")
    got = bounds.envelope_breakpoint_bounds(
        idx.envelopes.sym_lo, idx.envelopes.sym_hi, idx.breakpoints)
    want = jbounds.envelope_breakpoint_bounds(jidx.envelopes,
                                              jidx.breakpoints)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_index_from_arrays_round_trip(own_build):
    p, _, jidx, _ = own_build
    arrays = _index_arrays(jidx, fields=[f.name for f in
                                         dataclasses.fields(JEnvelopeSet)])
    idx = index_from_arrays(arrays, p, device="cpu")
    back = _index_arrays(idx)
    assert back.keys() == arrays.keys()
    for key, want in arrays.items():
        np.testing.assert_array_equal(back[key], want, err_msg=key)
        assert back[key].dtype == want.dtype, key
