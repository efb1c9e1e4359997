"""Port parity, kernels: each kernel's plain PyTorch version (what the
port's wrapper runs for CPU tensors) against the JAX package's function
on the same numpy inputs — the Pallas kernels in interpret mode, and the
reference planner's lower-bound functions.

Tolerances:
  * fused_gather_ed: rtol 1e-4 / atol 1e-3 on valid windows — a
    float32 dot-product identity whose dot is summed in another order
    (the reference multiplies by a banded Toeplitz matrix);
  * mindist: rtol 1e-6 / atol 1e-6 — the same float32 gaps, summed over
    at most w segments.

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
from repro.kernels.mindist import mindist_pallas  # noqa: E402
from repro_torch.core import Collection, planner  # noqa: E402
from repro_torch.core.types import EnvelopeSet  # noqa: E402
from repro_torch.kernels.fused_verify import fused_gather_ed  # noqa: E402
from repro_torch.kernels.mindist import mindist_paa, mindist_sym  # noqa: E402

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
