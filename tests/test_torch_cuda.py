"""The port on the card: each CUDA kernel against its plain PyTorch
version, and the engine on CUDA against the same engine on the CPU.

Needs a CUDA device and nvcc; imports neither jax nor repro, so it runs
on the GPU machine (`python -m pytest -m cuda tests/test_torch_cuda.py`)
and skips everywhere else.  Tolerances as in test_torch_kernels.py:
fused_gather_ed rtol 1e-4 / atol 1e-3 (the float32 dot is summed in
another order), mindist rtol 1e-6 / atol 1e-6.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (Collection, EnvelopeParams,  # noqa: E402
                              QuerySpec, UlisseEngine)
from repro_torch.core.index import build_index  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.fused_verify import fused_gather_ed  # noqa: E402
from repro_torch.kernels.mindist import mindist_paa, mindist_sym  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def _t(x, dev):
    return torch.from_numpy(np.array(x)).to(dev)


@pytest.mark.parametrize("rows", [64, 512])
@pytest.mark.parametrize("qlen", [160, 256])
@pytest.mark.parametrize("znorm", [False, True], ids=["raw", "znorm"])
def test_fused_gather_ed_matches_plain(dev, rows, qlen, znorm):
    rng = np.random.default_rng(rows + qlen)
    s, n, g, b = 512, 256, 49, 8
    data = rng.normal(size=(s, n)).astype(np.float32) * 2 + 1
    sids = rng.integers(0, s, b * rows).astype(np.int32)
    anchors = rng.integers(0, n - qlen + 1, b * rows).astype(np.int32)
    anchors[0] = n - qlen
    qs = rng.normal(size=(b, qlen)).astype(np.float32)
    c = Collection.from_array(data, device=dev)
    args = (c.data, c.csum, c.csum2, c.csum_lo, c.csum2_lo, c.center,
            _t(sids, dev), _t(anchors, dev), _t(qs, dev))
    before = fused_gather_ed.launches
    got = fused_gather_ed(*args, g=g, rows=rows, znorm=znorm)
    want = ref.fused_gather_ed_ref(*args, g=g, rows=rows, znorm=znorm)
    torch.cuda.synchronize()
    assert fused_gather_ed.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("b", [1, 8, 11])
def test_mindist_matches_plain(dev, b):
    rng = np.random.default_rng(b)
    n, w = 100_003, 16
    lo = rng.normal(size=(n, w)).astype(np.float32)
    hi = lo + np.abs(rng.normal(size=(n, w))).astype(np.float32)
    lo[0, 0], hi[0, 0] = -np.inf, np.inf
    lo[1], hi[1] = np.inf, -np.inf
    bp = np.sort(rng.normal(size=255)).astype(np.float32)
    sym_lo = np.searchsorted(bp, lo, side="right").astype(np.int32)
    sym_hi = np.searchsorted(bp, hi, side="right").astype(np.int32)
    valid = rng.random(n) > 0.1
    valid[1] = False
    q = rng.normal(size=(b, w)).astype(np.float32)
    ql = _t(q, dev)
    e_lo, e_hi, v = _t(lo, dev), _t(hi, dev), _t(valid, dev)
    s_lo, s_hi, bpt = _t(sym_lo, dev), _t(sym_hi, dev), _t(bp, dev)
    # a point query (ED) and a true interval (q_hi > q_lo), so that a
    # kernel mixing up the two query bounds cannot pass
    for qh in (ql, _t(q + rng.random((b, w)).astype(np.float32), dev)):
        for got, want in (
                (mindist_sym(ql, qh, s_lo, s_hi, bpt, v, 16, 12),
                 ref.mindist_sym_ref(ql, qh, s_lo, s_hi, bpt, v, 16, 12)),
                (mindist_paa(ql, qh, e_lo, e_hi, v, 16, 16),
                 ref.mindist_ref(ql, qh, e_lo, e_hi, v, 16, 16))):
            torch.cuda.synchronize()
            np.testing.assert_allclose(got.cpu().numpy(),
                                       want.cpu().numpy(), rtol=1e-6,
                                       atol=1e-6)


@pytest.mark.parametrize("znorm", [True, False], ids=["znorm", "raw"])
def test_engine_on_cuda_equals_engine_on_cpu(dev, znorm):
    """One index, two devices: the CUDA kernels and the plain versions
    give the same answers and the same counters."""
    rng = np.random.default_rng(7)
    data = np.cumsum(rng.normal(size=(64, 256)), -1).astype(np.float32)
    p = EnvelopeParams(lmin=160, lmax=256, seg_len=16, card=256, gamma=48,
                       znorm=znorm)
    idx = build_index(Collection.from_array(data, device="cpu"), p,
                      block_size=16, num_levels=2)
    cpu = UlisseEngine.from_index(idx, device="cpu")
    gpu = UlisseEngine.from_index(idx, device=dev)
    windows = [(i, 3 * i, 200) for i in range(5)] + [(5, 0, 256),
                                                      (6, 0, 256)]
    qs = [data[s, o:o + qlen] + rng.normal(size=qlen).astype(np.float32)
          * 0.05 for s, o, qlen in windows]
    before = (fused_gather_ed.launches, mindist_sym.launches,
              mindist_paa.launches)
    got = gpu.search(qs, QuerySpec(k=5))
    after = (fused_gather_ed.launches, mindist_sym.launches,
             mindist_paa.launches)
    assert all(a > b for a, b in zip(after, before))
    want = cpu.search(qs, QuerySpec(k=5))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.series, b.series)
        np.testing.assert_array_equal(a.offsets, b.offsets)
        np.testing.assert_allclose(a.dists, b.dists, rtol=0, atol=1e-9)
        assert dataclasses.asdict(a.stats) == dataclasses.asdict(b.stats)
