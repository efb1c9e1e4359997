"""Port parity, kernels: each kernel's plain PyTorch version (what the
port's wrapper runs for CPU tensors) against the JAX package's function
on the same numpy inputs — the Pallas kernels in interpret mode, and the
reference planner's lower-bound functions.

Tolerances:
  * fused_gather_ed: rtol 1e-4 / atol 1e-3 on valid windows — a
    float32 dot-product identity whose dot is summed in another order
    (the reference multiplies by a banded Toeplitz matrix);
  * mindist: rtol 1e-6 / atol 1e-6 — the same float32 gaps, summed over
    at most w segments;
  * batch_ed: rtol 2e-4 / atol 2e-3 and lb_keogh: rtol 1e-5 / atol 1e-5,
    the reference kernel tests' (sums taken in another order);
  * envelope_znorm_masters: rtol 1e-5 / atol 1e-5 against the Pallas
    kernel (the reference test's: it multiplies by 1/l' where the port
    divides) and 1e-6 against `repro.kernels.ref.envelope_scan_ref`;
  * the build entry `envelope_znorm` against the JAX build
    (`repro.kernels.ref.envelope_znorm_ref`): rtol 1e-5 / atol 1e-5 and
    the same unconstrained (+-inf) segments — the float32 prefix sums are
    cumsums taken in another order.

The CUDA kernels themselves are held against the same plain versions on
the card, in test_torch_cuda.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import Collection as JCollection  # noqa: E402
from repro.core import planner as jplanner  # noqa: E402
from repro.core.types import EnvelopeSet as JEnvelopeSet  # noqa: E402
from repro.kernels.fused_verify import \
    fused_gather_ed as j_fused_gather_ed  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.batch_ed import batch_ed_pallas  # noqa: E402
from repro.kernels.envelope import envelope_znorm_pallas  # noqa: E402
from repro.kernels.lb_keogh import lb_keogh_pallas  # noqa: E402
from repro.kernels.mindist import mindist_pallas  # noqa: E402
from repro_torch.core import Collection, planner  # noqa: E402
from repro_torch.core.envelope import _prefix  # noqa: E402
from repro_torch.core.types import EnvelopeSet  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.batch_ed import batch_ed  # noqa: E402
from repro_torch.kernels.envelope import (envelope_znorm,  # noqa: E402
                                          envelope_znorm_masters)
from repro_torch.kernels.fused_verify import (  # noqa: E402
    fused_gather_ed, fused_gather_ed_chunk)
from repro_torch.kernels.lb_keogh import lb_keogh  # noqa: E402
from repro_torch.kernels.mindist import mindist_paa, mindist_sym  # noqa: E402
from repro_torch.kernels.pool_merge import (pool_merge,  # noqa: E402
                                            pool_merge_partials)

RNG = np.random.default_rng(0)


def _t(x):
    return torch.from_numpy(np.array(x))


def _fused_inputs(s, n, qlen, g, rows, b, seed):
    """Gather targets for a B-query slab biased to the end-of-series
    overrun, plus the validity mask of every (row, offset)."""
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(s, n)).astype(np.float32) * 2 + 1
    sids = rng.integers(0, s, b * rows).astype(np.int32)
    anchors = rng.integers(0, n - qlen + 1, b * rows).astype(np.int32)
    anchors[0] = n - qlen                    # worst-case overrun
    qs = rng.normal(size=(b, qlen)).astype(np.float32)
    valid = anchors[:, None] + np.arange(g) + qlen <= n
    return data, sids, anchors, qs, valid


@pytest.mark.parametrize("s,n,qlen,g,rows,b", [(4, 96, 32, 1, 8, 1),
                                               (6, 128, 64, 9, 13, 1),
                                               (3, 192, 96, 5, 16, 3),
                                               (5, 256, 160, 49, 4, 2)])
@pytest.mark.parametrize("znorm", [False, True], ids=["raw", "znorm"])
def test_fused_gather_ed_matches_pallas(s, n, qlen, g, rows, b, znorm):
    data, sids, anchors, qs, valid = _fused_inputs(s, n, qlen, g, rows, b,
                                                   seed=qlen + g)
    jc = JCollection.from_array(data)
    want = np.asarray(j_fused_gather_ed(
        jc.data, jc.csum, jc.csum2, jc.csum_lo, jc.csum2_lo, jc.center,
        jnp.asarray(sids), jnp.asarray(anchors), jnp.asarray(qs), g=g,
        rows=rows, znorm=znorm, interpret=True))
    c = Collection.from_array(data, device="cpu")
    got = fused_gather_ed(c.data, c.csum, c.csum2, c.csum_lo, c.csum2_lo,
                          c.center, _t(sids), _t(anchors), _t(qs), g=g,
                          rows=rows, znorm=znorm)
    assert got.shape == (b * rows, g) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy()[valid], want[valid], rtol=1e-4,
                               atol=1e-3)


def _env_inputs(n, w, card, seed):
    rng = np.random.default_rng(seed)
    lo = rng.normal(size=(n, w)).astype(np.float32)
    hi = lo + np.abs(rng.normal(size=(n, w))).astype(np.float32)
    lo[0, 0], hi[0, 0] = -np.inf, np.inf          # unconstrained segment
    lo[1], hi[1] = np.inf, -np.inf                # a padding row
    bp = np.sort(rng.normal(size=card - 1)).astype(np.float32)
    sym_lo = np.searchsorted(bp, lo, side="right").astype(np.int32)
    sym_hi = np.searchsorted(bp, hi, side="right").astype(np.int32)
    valid = rng.random(n) > 0.1
    valid[1] = False
    return lo, hi, sym_lo, sym_hi, bp, valid


@pytest.mark.parametrize("n,w,nseg,b", [(17, 8, 8, 1), (200, 16, 11, 3),
                                        (1025, 16, 16, 8), (64, 12, 5, 9)])
@pytest.mark.parametrize("seg_len", [8, 16])
def test_mindist_matches_pallas(n, w, nseg, b, seg_len):
    lo, hi, _, _, _, valid = _env_inputs(n, w, 16, seed=n + w)
    qlo = RNG.normal(size=(b, w)).astype(np.float32)
    qhi = qlo + np.abs(RNG.normal(size=(b, w))).astype(np.float32)
    got = mindist_paa(_t(qlo), _t(qhi), _t(lo), _t(hi), _t(valid), seg_len,
                      nseg).numpy()
    assert got.shape == (b, n)
    for i in range(b):
        want = np.asarray(mindist_pallas(
            jnp.asarray(qlo[i]), jnp.asarray(qhi[i]), jnp.asarray(lo),
            jnp.asarray(hi), seg_len, nseg, interpret=True))
        want = np.where(valid, want, np.inf)
        np.testing.assert_allclose(got[i], want, rtol=1e-6, atol=1e-6)


def _env_sets(lo, hi, sym_lo, sym_hi, valid):
    n = lo.shape[0]
    cols = dict(paa_lo=lo, paa_hi=hi, sym_lo=sym_lo, sym_hi=sym_hi,
                series_id=np.zeros(n, np.int32), anchor=np.zeros(n, np.int32),
                n_master=np.ones(n, np.int32), valid=valid)
    return (EnvelopeSet(**{k: _t(v) for k, v in cols.items()}),
            JEnvelopeSet(**{k: jnp.asarray(v) for k, v in cols.items()}))


@pytest.mark.parametrize("use_paa", [False, True], ids=["sym", "paa"])
@pytest.mark.parametrize("card", [16, 256])
def test_env_lower_bounds_batch_matches_reference(use_paa, card):
    w, nseg, seg_len, b = 16, 13, 16, 8
    lo, hi, sym_lo, sym_hi, bp, valid = _env_inputs(4096, w, card, seed=card)
    env, jenv = _env_sets(lo, hi, sym_lo, sym_hi, valid)
    qp = RNG.normal(size=(b, w)).astype(np.float32)
    got = planner.env_lower_bounds_batch(_t(qp), _t(qp), env, _t(bp),
                                         seg_len, nseg, use_paa).numpy()
    want = np.asarray(jplanner.env_lower_bounds_batch(
        jnp.asarray(qp), jnp.asarray(qp), jenv, jnp.asarray(bp), seg_len,
        nseg, use_paa))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.isinf(got[:, ~valid]).all()


def test_block_lower_bounds_batch_matches_reference():
    w, nseg, seg_len, b = 16, 10, 16, 4
    lo, hi, _, _, _, valid = _env_inputs(512, w, 16, seed=9)
    qp = RNG.normal(size=(b, w)).astype(np.float32)
    got = planner.block_lower_bounds_batch(_t(qp), _t(qp), _t(lo), _t(hi),
                                           _t(valid), seg_len, nseg).numpy()
    want = np.asarray(jplanner.block_lower_bounds_batch(
        jnp.asarray(qp), jnp.asarray(qp), jnp.asarray(lo), jnp.asarray(hi),
        jnp.asarray(valid), seg_len, nseg))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_mindist_query_paa_narrower_than_envelopes():
    """A query of length l has l // seg_len PAA segments, fewer than the
    envelopes' w: the wrappers take it (the kernel reads it with its own
    row stride) and refuse an nseg wider than either side."""
    lo, hi, sym_lo, sym_hi, bp, valid = _env_inputs(300, 16, 16, seed=4)
    q10 = RNG.normal(size=(3, 10)).astype(np.float32)
    q16 = np.concatenate([q10, np.zeros((3, 6), np.float32)], axis=1)
    for fn, args in ((mindist_paa, (_t(lo), _t(hi), _t(valid))),
                     (mindist_sym, (_t(sym_lo), _t(sym_hi), _t(bp),
                                    _t(valid)))):
        got = fn(_t(q10), _t(q10), *args, 16, 10)
        want = fn(_t(q16), _t(q16), *args, 16, 10)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        with pytest.raises(ValueError):
            fn(_t(q10), _t(q10), *args, 16, 11)


def test_non_cpu_tensors_never_take_the_plain_path():
    """A tensor off the CPU goes to the CUDA kernel or raises — here,
    with no card and no nvcc, the build raises (meta tensors stand in for
    device tensors; nothing is launched)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the kernel would run")
    meta = dict(device="meta")
    data = torch.empty((4, 64), **meta)
    sums = torch.empty((4, 65), **meta)
    idx = torch.zeros(8, dtype=torch.int32, **meta)
    with pytest.raises(RuntimeError):
        fused_gather_ed(data, sums, sums, sums, sums,
                        torch.empty(4, **meta), idx, idx,
                        torch.empty((1, 32), **meta), g=3, rows=8,
                        znorm=True)
    q = torch.empty((2, 8), **meta)
    e = torch.empty((16, 8), **meta)
    with pytest.raises(RuntimeError):
        mindist_paa(q, q, e, e, torch.empty(16, dtype=torch.bool, **meta),
                    16, 8)
    assert fused_gather_ed.launches == 0 and mindist_paa.launches == 0


# -- the host backend's kernels and the index build's ----------------------

@pytest.mark.parametrize("n,l,qb", [(33, 96, 1), (257, 160, 4),
                                    (64, 256, 7)])
@pytest.mark.parametrize("znorm", [False, True], ids=["raw", "znorm"])
def test_batch_ed_matches_pallas(n, l, qb, znorm):
    rng = np.random.default_rng(n + l + qb)
    w = (rng.normal(size=(n, l)) * 3 + 1).astype(np.float32)
    q = rng.normal(size=(qb, l)).astype(np.float32)
    if znorm:
        q = (q - q.mean(-1, keepdims=True)) / q.std(-1, keepdims=True)
    got = batch_ed(_t(w), _t(q), znorm)
    assert got.shape == (n, qb) and got.dtype == torch.float32
    for want in (batch_ed_pallas(jnp.asarray(w), jnp.asarray(q), znorm,
                                 interpret=True),
                 jref.batch_ed_ref(jnp.asarray(w), jnp.asarray(q), znorm)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("n,l", [(13, 64), (140, 200), (65, 256)])
def test_lb_keogh_matches_pallas(n, l):
    rng = np.random.default_rng(n + l)
    lo = (rng.normal(size=l) - 1).astype(np.float32)
    hi = lo + np.float32(2.0)
    w = (rng.normal(size=(n, l)) * 2).astype(np.float32)
    got = lb_keogh(_t(lo), _t(hi), _t(w))
    assert got.shape == (n,)
    for want in (lb_keogh_pallas(jnp.asarray(lo), jnp.asarray(hi),
                                 jnp.asarray(w), interpret=True),
                 jref.lb_keogh_ref(jnp.asarray(lo), jnp.asarray(hi),
                                   jnp.asarray(w))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,l,qb", [(9, 12_300, 1), (17, 2_048, 8)])
@pytest.mark.parametrize("znorm", [False, True], ids=["raw", "znorm"])
def test_batch_ed_long_rows_match_pallas(n, l, qb, znorm):
    """Shapes past the kernel's 48 KB of staging: a query longer than it
    (streamed in tiles of L on the card) and 8 queries of 2,048 points
    (two launches of query groups)."""
    rng = np.random.default_rng(n + l + qb)
    w = (rng.normal(size=(n, l)) * 3 + 1).astype(np.float32)
    q = rng.normal(size=(qb, l)).astype(np.float32)
    if znorm:
        q = (q - q.mean(-1, keepdims=True)) / q.std(-1, keepdims=True)
    got = batch_ed(_t(w), _t(q), znorm)
    assert got.shape == (n, qb)
    want = batch_ed_pallas(jnp.asarray(w), jnp.asarray(q), znorm,
                           interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-3)


def test_lb_keogh_long_rows_match_pallas():
    """An envelope of 6,200 points, past the kernel's 48 KB of staging
    (tiles of L on the card)."""
    n, l = 11, 6_200
    rng = np.random.default_rng(l)
    lo = (rng.normal(size=l) - 1).astype(np.float32)
    hi = lo + np.float32(2.0)
    w = (rng.normal(size=(n, l)) * 2).astype(np.float32)
    got = lb_keogh(_t(lo), _t(hi), _t(w))
    want = lb_keogh_pallas(jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(w),
                           interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _master_inputs(n, lmin, lmax, seg, seed):
    """The reference kernel test's inputs (segment means, window sums of
    every length, offsets of every master of one random walk), as numpy."""
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.normal(size=n).astype(np.float32).cumsum())
    csum = jnp.concatenate([jnp.zeros(1), jnp.cumsum(x)])
    csum2 = jnp.concatenate([jnp.zeros(1), jnp.cumsum(x * x)])
    w = lmax // seg
    offs = jnp.arange(n - lmin + 1, dtype=jnp.int32)
    starts = offs[:, None] + jnp.arange(w)[None, :] * seg
    segmean = (jnp.take(csum, jnp.clip(starts + seg, 0, n))
               - jnp.take(csum, jnp.clip(starts, 0, n))) / seg
    lens = lmin + jnp.arange(lmax - lmin + 1)
    e2 = jnp.clip(offs[:, None] + lens[None, :], 0, n)
    s1 = jnp.take(csum, e2) - csum[offs][:, None]
    s2 = jnp.take(csum2, e2) - csum2[offs][:, None]
    return tuple(np.asarray(a) for a in (segmean, s1, s2, offs))


@pytest.mark.parametrize("n,lmin,lmax,seg", [(80, 24, 40, 8),
                                             (120, 32, 64, 16),
                                             (64, 48, 64, 8)])
def test_envelope_znorm_masters_matches_pallas(n, lmin, lmax, seg):
    args = _master_inputs(n, lmin, lmax, seg, seed=n + lmin)
    lo, hi = envelope_znorm_masters(*map(_t, args), n=n, lmin=lmin,
                                    seg_len=seg)
    jargs = tuple(map(jnp.asarray, args))
    k_lo, k_hi = envelope_znorm_pallas(*jargs, n, lmin, lmax, seg,
                                       interpret=True)
    r_lo, r_hi = jref.envelope_scan_ref(*jargs, n, lmin, lmax, seg)
    for got, kern, want in ((lo, k_lo, r_lo), (hi, k_hi, r_hi)):
        np.testing.assert_allclose(got.numpy(), np.asarray(kern),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
    # the last master takes only l' = lmin: its later segments keep the
    # sentinels
    assert (lo.numpy()[-1] == np.float32(3e38)).any()
    assert (hi.numpy()[-1] == np.float32(-3e38)).any()


@pytest.mark.parametrize("n,lmin,lmax,gamma,seg", [
    (192, 64, 128, 8, 16),      # the engine tests' parameters
    (256, 160, 256, 48, 16),    # the bench parameters
    (100, 24, 40, 3, 8),        # w * seg < lmax, a short tail envelope
    (70, 64, 64, 0, 16)])       # one length, one master per envelope
def test_envelope_build_matches_reference(n, lmin, lmax, gamma, seg):
    rng = np.random.default_rng(n + gamma)
    data = np.cumsum(rng.normal(size=(5, n)), -1).astype(np.float32)
    x = _t(data)
    xc = x - x.mean(dim=-1, keepdim=True)
    lo, hi = envelope_znorm(_prefix(xc), _prefix(xc * xc), lmin=lmin,
                            lmax=lmax, gamma=gamma, seg_len=seg)
    w_lo, w_hi = jref.envelope_znorm_ref(jnp.asarray(data), lmin, lmax,
                                         gamma, seg)
    for got, want in ((lo, w_lo), (hi, w_hi)):
        want = np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(want))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_ops_match_reference_ops():
    """kernels/ops.py: each op (kernel wrapper, and use_kernel=False) on
    the reference op's arguments against the reference op's plain
    version (use_pallas=False)."""
    rng = np.random.default_rng(3)
    w = rng.normal(size=(40, 64)).astype(np.float32)
    q = rng.normal(size=(3, 64)).astype(np.float32)
    lo = (rng.normal(size=64) - 1).astype(np.float32)
    hi = lo + np.float32(2.0)
    e_lo = rng.normal(size=(50, 8)).astype(np.float32)
    e_hi = e_lo + np.abs(rng.normal(size=(50, 8))).astype(np.float32)
    seg_args = _master_inputs(80, 24, 40, 8, seed=5)
    cases = [
        ("batch_ed", (w, q, True), {}),
        ("lb_keogh", (lo, hi, w), {}),
        ("dtw_band", (w[0], w, 5), {}),
        ("mindist", (e_lo[0], e_hi[0], e_lo, e_hi, 16, 6), {}),
        ("envelope_znorm", seg_args + (80, 24, 40, 8), {})]
    for name, args, tol in cases:
        targs = tuple(_t(a) if isinstance(a, np.ndarray) else a
                      for a in args)
        jargs = tuple(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                      for a in args)
        want = getattr(jops, name)(*jargs, use_pallas=False)
        for use_kernel in (True, False):
            got = getattr(ops, name)(*targs, use_kernel=use_kernel)
            for g, wv in zip(got if isinstance(got, tuple) else (got,),
                             want if isinstance(want, tuple) else (want,)):
                np.testing.assert_allclose(g.numpy(), np.asarray(wv),
                                           rtol=1e-4, atol=1e-4,
                                           err_msg=name)


def test_new_kernels_never_take_the_plain_path_off_cpu():
    """batch_ed, lb_keogh, both envelope entries, the ED chunk entry and
    both pool merges: a tensor off the CPU goes to the CUDA kernel or
    raises (no card and no nvcc here: the build raises; meta tensors
    stand in for device tensors)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the kernel would run")
    meta = dict(device="meta")
    w = torch.empty((10, 64), **meta)
    e = torch.empty(64, **meta)
    sums = torch.empty((3, 193), **meta)
    seg, s12 = torch.empty((20, 4), **meta), torch.empty((20, 9), **meta)
    offs = torch.zeros(20, dtype=torch.int32, **meta)
    # a (3, 96) collection and a (2, 32) plan of 4 chunks of 8 rows
    col = (torch.empty((3, 96), **meta),
           *(torch.empty((3, 97), **meta) for _ in range(4)),
           torch.empty(3, **meta))
    plan = torch.zeros((2, 32), dtype=torch.int32, **meta)
    lbs2 = torch.empty((2, 32), **meta)
    pool = (torch.empty((2, 5), **meta),
            *(torch.zeros((2, 5), dtype=torch.int32, **meta)
              for _ in range(2)))
    stats = torch.zeros((2, 6), dtype=torch.int32, **meta)
    for call in (lambda: batch_ed(w, torch.empty((2, 64), **meta), True),
                 lambda: lb_keogh(e, e, w),
                 lambda: envelope_znorm(sums, sums, lmin=64, lmax=128,
                                        gamma=8, seg_len=16),
                 lambda: envelope_znorm_masters(seg, s12, s12, offs, n=80,
                                                lmin=24, seg_len=8),
                 lambda: fused_gather_ed_chunk(
                     *col, plan, plan, plan, lbs2, torch.empty((2, 64),
                                                               **meta),
                     pool[0], stats, i=1, chunk=8, g=5, znorm=True),
                 lambda: pool_merge(pool, lbs2, plan, plan),
                 lambda: pool_merge_partials(pool, torch.zeros(
                     (4, 2, 30), dtype=torch.int32, **meta))):
        with pytest.raises(RuntimeError):
            call()
    assert batch_ed.launches == lb_keogh.launches == \
        envelope_znorm.launches == envelope_znorm_masters.launches == \
        fused_gather_ed_chunk.launches == pool_merge.launches == \
        pool_merge_partials.launches == 0
