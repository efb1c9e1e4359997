"""Port parity at the long query lengths the card's long-row kernels
open: each plain version (what the port's wrappers run for CPU tensors,
and what the card holds its kernels against) against the JAX package on
the same numpy inputs, and the port's engine on the CPU against the
reference engine on an index whose queries have more than 736 segments.

Tolerances, each with its reason:
  * mindist (B = 8, nseg 1,000): rtol 1e-6 / atol 1e-6 — the same
    float32 gaps, summed over 1,000 segments in the same order;
  * fused_gather_ed at qlen ~20,000: rtol 1e-4 / atol 1e-3 on valid
    windows, the slice's kernel-test tolerance (a float32 dot identity
    whose dot is summed in another order; its error stays ~1e-7 of d2);
  * fused_gather_lb_keogh at qlen ~20,000: lb2 rtol 2e-4 / atol 2e-3,
    mu rtol 1e-4 / atol 1e-4, sd rtol 1e-3 / atol 1e-4 (the slice's
    kernel-test tolerances; lb2 is a sum of 20,000 squares taken in
    another order);
  * the engines: identical answers and `SearchStats`, ED distances within
    1e-9 (both rescore their reported rows in float64).
The long-row kernels themselves are held against the same plain
versions, and against the staged kernels, on the card
(test_torch_cuda.py).
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
from repro.kernels.fused_verify import \
    fused_gather_ed as j_fused_ed  # noqa: E402
from repro.kernels.fused_verify import \
    fused_gather_lb_keogh as j_fused_lb  # noqa: E402
from repro.kernels.mindist import mindist_pallas  # noqa: E402
from repro_torch.convert import index_from_arrays  # noqa: E402
from repro_torch.core import (Collection, EnvelopeParams,  # noqa: E402
                              QuerySpec, UlisseEngine)
from repro_torch.kernels.fused_verify import (  # noqa: E402
    fused_gather_ed, fused_gather_ed_chunk, fused_gather_ed_chunk_long,
    fused_gather_ed_long, fused_gather_lb_keogh, fused_gather_lb_keogh_chunk,
    fused_gather_lb_keogh_chunk_long, fused_gather_lb_keogh_long)
from repro_torch.kernels.mindist import mindist_paa, mindist_sym  # noqa: E402


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("sym", [False, True], ids=["paa", "sym"])
def test_mindist_long_queries_match_pallas(sym):
    """B = 8 queries of 1,000 segments (qlen 16,000 at seg_len 16): past
    the 736 segments whose query intervals the card's scalar entry staged
    in 48 KB."""
    rng = np.random.default_rng(1000 + sym)
    n, w, nseg, b, seg_len, card = 96, 1_000, 1_000, 8, 16, 256
    lo = rng.normal(size=(n, w)).astype(np.float32)
    hi = lo + np.abs(rng.normal(size=(n, w))).astype(np.float32)
    lo[0, :3], hi[0, :3] = -np.inf, np.inf
    valid = rng.random(n) > 0.1
    valid[1] = False
    qlo = rng.normal(size=(b, w)).astype(np.float32)
    qhi = qlo + np.abs(rng.normal(size=(b, w))).astype(np.float32)
    if sym:
        bp = np.sort(rng.normal(size=card - 1)).astype(np.float32)
        sym_lo = np.searchsorted(bp, lo, side="right").astype(np.int32)
        sym_hi = np.searchsorted(bp, hi, side="right").astype(np.int32)
        beta = np.concatenate([[-np.inf], bp, [np.inf]]).astype(np.float32)
        lo, hi = beta[sym_lo], beta[sym_hi + 1]
        got = mindist_sym(_t(qlo), _t(qhi), _t(sym_lo), _t(sym_hi), _t(bp),
                          _t(valid), seg_len, nseg).numpy()
    else:
        got = mindist_paa(_t(qlo), _t(qhi), _t(lo), _t(hi), _t(valid),
                          seg_len, nseg).numpy()
    assert got.shape == (b, n)
    for i in range(b):
        want = np.asarray(mindist_pallas(
            jnp.asarray(qlo[i]), jnp.asarray(qhi[i]), jnp.asarray(lo),
            jnp.asarray(hi), seg_len, nseg, interpret=True))
        want = np.where(valid, want, np.inf)
        np.testing.assert_allclose(got[i], want, rtol=1e-6, atol=1e-6)


def _long_inputs(qlen, seed, s=3, g=49, rows=4, b=2):
    """Regions over 2-3 long series, one overrunning its series."""
    rng = np.random.default_rng(seed)
    n = qlen + 3 * g
    data = np.cumsum(rng.normal(size=(s, n)), -1).astype(np.float32)
    sids = rng.integers(0, s, b * rows).astype(np.int32)
    anchors = rng.integers(0, n - qlen + 1, b * rows).astype(np.int32)
    anchors[0] = n - qlen
    valid = anchors[:, None] + np.arange(g) + qlen <= n
    return rng, data, sids, anchors, valid, g, rows, b


@pytest.mark.parametrize("znorm", [False, True], ids=["raw", "znorm"])
def test_fused_gather_ed_long_query_matches_pallas(znorm):
    qlen = 20_000
    rng, data, sids, anchors, valid, g, rows, b = _long_inputs(qlen, 7)
    qs = rng.normal(size=(b, qlen)).astype(np.float32)
    jc = JCollection.from_array(data)
    want = np.asarray(j_fused_ed(
        jc.data, jc.csum, jc.csum2, jc.csum_lo, jc.csum2_lo, jc.center,
        jnp.asarray(sids), jnp.asarray(anchors), jnp.asarray(qs), g=g,
        rows=rows, znorm=znorm, interpret=True))
    c = Collection.from_array(data, device="cpu")
    args = (c.data, c.csum, c.csum2, c.csum_lo, c.csum2_lo, c.center,
            _t(sids), _t(anchors), _t(qs))
    got = fused_gather_ed(*args, g=g, rows=rows, znorm=znorm)
    # the long-row wrapper runs the same plain version on the CPU
    assert torch.equal(fused_gather_ed_long(*args, g=g, rows=rows,
                                            znorm=znorm), got)
    np.testing.assert_allclose(got.numpy()[valid], want[valid], rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize("znorm", [False, True], ids=["raw", "znorm"])
def test_fused_gather_lb_keogh_long_query_matches_pallas(znorm):
    qlen, r = 20_000, 200
    rng, data, sids, anchors, valid, g, rows, b = _long_inputs(qlen, 8)
    q = rng.normal(size=(b, qlen)).astype(np.float32)
    lo, hi = (np.asarray(x) for x in jdtw.dtw_envelope(jnp.asarray(q), r))
    jc = JCollection.from_array(data)
    want = [np.asarray(x) for x in j_fused_lb(
        jc.data, jc.csum, jc.csum2, jc.csum_lo, jc.csum2_lo, jc.center,
        jnp.asarray(sids), jnp.asarray(anchors), jnp.asarray(lo),
        jnp.asarray(hi), g=g, rows=rows, znorm=znorm, interpret=True)]
    c = Collection.from_array(data, device="cpu")
    args = (c.data, c.csum, c.csum2, c.csum_lo, c.csum2_lo, c.center,
            _t(sids), _t(anchors), _t(lo), _t(hi))
    got = fused_gather_lb_keogh(*args, g=g, rows=rows, znorm=znorm)
    for x, y in zip(fused_gather_lb_keogh_long(*args, g=g, rows=rows,
                                               znorm=znorm), got):
        assert torch.equal(x, y)
    for x, y, (rtol, atol) in zip(got, want, ((2e-4, 2e-3), (1e-4, 1e-4),
                                              (1e-3, 1e-4))):
        np.testing.assert_allclose(x.numpy()[valid], y[valid], rtol=rtol,
                                   atol=atol)


def test_long_chunk_wrappers_run_the_plain_step_on_cpu():
    """On the CPU the long-row chunk entries run the same plain step as
    the staged ones: the same partials, counters, survivors and DP
    output, and no launch is counted."""
    qlen = 3_000
    rng, data, sids, anchors, valid, g, rows, b = _long_inputs(qlen, 9)
    c = Collection.from_array(data, device="cpu")
    coll = (c.data, c.csum, c.csum2, c.csum_lo, c.csum2_lo, c.center)
    n_pad = rows
    plan = (_t(sids.reshape(b, n_pad)), _t(anchors.reshape(b, n_pad)),
            _t(np.full((b, n_pad), g, np.int32)),
            _t(np.sort(rng.random((b, n_pad)).astype(np.float32), axis=1)))
    qs = _t(rng.normal(size=(b, qlen)).astype(np.float32))
    pool = _t(np.full((b, 3), np.inf, np.float32))
    outs = []
    for fn in (fused_gather_ed_chunk, fused_gather_ed_chunk_long):
        stats = torch.zeros((b, 6), dtype=torch.int32)
        outs.append((fn(*coll, *plan, qs, pool, stats, i=0, chunk=rows, g=g,
                        znorm=True), stats))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    assert int(outs[0][1][:, 2].sum()) == int(valid.sum())
    env = _t(rng.normal(size=(b, qlen)).astype(np.float32))
    ok = _t(valid.reshape(b, rows * g))
    kth = _t(np.full(b, 1e9, np.float32))
    got = [fn(*coll, _t(sids), _t(anchors), env - 1, env + 1, ok, kth, g=g,
              rows=rows, znorm=True)
           for fn in (fused_gather_lb_keogh_chunk,
                      fused_gather_lb_keogh_chunk_long)]
    for x, y in zip(*got):
        assert torch.equal(x.nan_to_num(7.0), y.nan_to_num(7.0))
    assert fused_gather_ed_chunk.launches == \
        fused_gather_ed_chunk_long.launches == \
        fused_gather_lb_keogh_chunk.launches == \
        fused_gather_lb_keogh_chunk_long.launches == 0


def test_long_wrappers_never_take_the_plain_path_off_cpu():
    """A tensor off the CPU goes to the long-row kernel or raises: with
    no card and no nvcc here the build raises (meta tensors stand in for
    device tensors; nothing is launched)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the kernel would run")
    meta = dict(device="meta")
    data = torch.empty((4, 64), **meta)
    sums = torch.empty((4, 65), **meta)
    center = torch.empty(4, **meta)
    idx = torch.zeros(8, dtype=torch.int32, **meta)
    q = torch.empty((1, 32), **meta)
    plan = torch.zeros((1, 8), dtype=torch.int32, **meta)
    ok = torch.zeros((1, 24), dtype=torch.bool, **meta)
    one = torch.empty(1, **meta)
    calls = (
        lambda: fused_gather_ed_long(data, sums, sums, sums, sums, center,
                                     idx, idx, q, g=3, rows=8, znorm=True),
        lambda: fused_gather_ed_chunk_long(
            data, sums, sums, sums, sums, center, plan, plan, plan,
            torch.empty((1, 8), **meta), q, torch.empty((1, 2), **meta),
            torch.zeros((1, 6), dtype=torch.int32, **meta), i=0, chunk=8,
            g=3, znorm=True),
        lambda: fused_gather_lb_keogh_long(data, sums, sums, sums, sums,
                                           center, idx, idx, q, q, g=3,
                                           rows=8, znorm=True),
        lambda: fused_gather_lb_keogh_chunk_long(
            data, sums, sums, sums, sums, center, idx, idx, q, q, ok, one,
            g=3, rows=8, znorm=True))
    for call in calls:
        with pytest.raises(RuntimeError):
            call()
    assert fused_gather_ed_long.launches == \
        fused_gather_ed_chunk_long.launches == \
        fused_gather_lb_keogh_long.launches == \
        fused_gather_lb_keogh_chunk_long.launches == 0


# -- the engine past 736 query segments --------------------------------------

LONG_PARAMS = dict(lmin=11_840, lmax=12_000, seg_len=16, card=64, gamma=48)


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


@pytest.mark.parametrize("znorm", [True, False], ids=["znorm", "raw"])
def test_port_engine_long_queries_equal_reference(znorm):
    """A batch of 8 ED queries of 11,900 points (743 segments) on 3 series
    of 12,100 points: the port's engine on the CPU gives the reference
    engine's answers and counters on the same index."""
    rng = np.random.default_rng(743)
    data = np.cumsum(rng.normal(size=(3, 12_100)), -1).astype(np.float32)
    ref = JEngine.from_collection(JCollection.from_array(data),
                                  JParams(znorm=znorm, **LONG_PARAMS),
                                  block_size=4, num_levels=1)
    idx = index_from_arrays(_arrays(ref.index),
                            EnvelopeParams(znorm=znorm, **LONG_PARAMS),
                            device="cpu")
    port = UlisseEngine.from_index(idx, device="cpu")
    qlen = 11_900
    qs = [data[s, o:o + qlen] + rng.normal(size=qlen).astype(np.float32)
          * 0.05 for s, o in zip(rng.integers(0, 3, 8),
                                 rng.integers(0, 12_100 - qlen + 1, 8))]
    want = ref.search(qs, JQuerySpec(k=3))
    got = port.search(qs, QuerySpec(k=3))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.series, b.series)
        np.testing.assert_array_equal(a.offsets, b.offsets)
        np.testing.assert_allclose(a.dists, b.dists, rtol=0, atol=1e-9)
        assert dataclasses.asdict(a.stats) == dataclasses.asdict(b.stats)
        assert np.isfinite(a.dists).all()
