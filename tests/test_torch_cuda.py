"""The port on the card: each CUDA kernel against its plain PyTorch
version, and the engine on CUDA against the same engine on the CPU.

Needs a CUDA device and nvcc; imports neither jax nor repro, so it runs
on the GPU machine (`python -m pytest -m cuda tests/test_torch_cuda.py`)
and skips everywhere else.  Tolerances as in test_torch_kernels.py and
test_torch_dtw.py: fused_gather_ed rtol 1e-4 / atol 1e-3 (the float32
dot is summed in another order), mindist rtol 1e-6 / atol 1e-6,
fused_gather_lb_keogh lb2 rtol 2e-4 / atol 2e-3, mu 1e-4 / 1e-4 and
sd 1e-3 / 1e-4 (the reference kernel test's: sd cancels when |mu| >>
sd), the DTW kernels rtol 1e-4 / atol 1e-3
(the kernel runs the recurrence; the plain closed form's cumsum over the
band cancels in float32 by up to ~1e-3 at these lengths), batch_ed
rtol 2e-4 / atol 2e-3 and lb_keogh rtol 1e-5 / atol 1e-5 (the reference
kernel tests'); envelope_znorm bit for bit (kernel and plain version
share their arithmetic: IEEE divisions, no contraction).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (Collection, EnvelopeParams,  # noqa: E402
                              QuerySpec, UlisseEngine)
from repro_torch.core import dtw, executor  # noqa: E402
from repro_torch.core import isax  # noqa: E402
from repro_torch.core.envelope import _prefix, build_envelope_set  # noqa: E402
from repro_torch.core.index import build_index  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.batch_ed import batch_ed  # noqa: E402
from repro_torch.kernels.dtw_band import dtw_band, dtw_survivors  # noqa: E402
from repro_torch.kernels.envelope import (envelope_znorm,  # noqa: E402
                                          envelope_znorm_masters)
from repro_torch.kernels.lb_keogh import lb_keogh  # noqa: E402
from repro_torch.kernels.fused_verify import (  # noqa: E402
    fused_gather_ed, fused_gather_lb_keogh)
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


def _close(got, want, rtol, atol):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=atol)


@pytest.mark.parametrize("rows", [64, 512])
@pytest.mark.parametrize("qlen,r", [(160, 16), (256, 25)])
@pytest.mark.parametrize("znorm", [False, True], ids=["raw", "znorm"])
def test_fused_gather_lb_keogh_matches_plain(dev, rows, qlen, r, znorm):
    rng = np.random.default_rng(rows + qlen + znorm)
    s, n, g, b = 512, 256, 49, 8
    data = rng.normal(size=(s, n)).astype(np.float32) * 2 + 1
    sids = rng.integers(0, s, b * rows).astype(np.int32)
    anchors = rng.integers(0, n - qlen + 1, b * rows).astype(np.int32)
    anchors[0] = n - qlen
    lo, hi = dtw.dtw_envelope(_t(rng.normal(size=(b, qlen)).astype(
        np.float32), dev), r)
    c = Collection.from_array(data, device=dev)
    args = (c.data, c.csum, c.csum2, c.csum_lo, c.csum2_lo, c.center,
            _t(sids, dev), _t(anchors, dev), lo.contiguous(),
            hi.contiguous())
    before = fused_gather_lb_keogh.launches
    got = fused_gather_lb_keogh(*args, g=g, rows=rows, znorm=znorm)
    want = ref.fused_gather_lb_keogh_ref(*args, g=g, rows=rows, znorm=znorm)
    torch.cuda.synchronize()
    assert fused_gather_lb_keogh.launches == before + 1
    for x, y, tol in zip(got, want, ((2e-4, 2e-3), (1e-4, 1e-4),
                                     (1e-3, 1e-4))):
        _close(x, y, *tol)


@pytest.mark.parametrize("l,r,n", [(256, 25, 700), (160, 16, 700),
                                   (64, 64, 90), (100, 300, 40),
                                   (600, 300, 12), (40, 1, 300), (1, 3, 5)])
def test_dtw_band_matches_plain(dev, l, r, n):
    """Path shapes (r = 16, 25), a band covering the row (r >= l), the
    widest band the kernel keeps in registers (32 cells a lane), r = 1
    and a single point."""
    rng = np.random.default_rng(l + r)
    q = _t(rng.normal(size=l).astype(np.float32), dev)
    c = _t(rng.normal(size=(n, l)).astype(np.float32), dev)
    before = dtw_band.launches
    got = dtw_band(q, c, r)
    torch.cuda.synchronize()
    assert dtw_band.launches == before + 1
    _close(got, ref.dtw_band_ref(q, c, r), 1e-4, 1e-3)


@pytest.mark.parametrize("qlen,r", [(160, 16), (256, 25), (64, 100)])
@pytest.mark.parametrize("znorm", [False, True], ids=["raw", "znorm"])
def test_dtw_survivors_matches_plain(dev, qlen, r, znorm):
    """One launch over a chunk of B = 8 queries: survivors from none
    (nsurv = 0) to all, offsets past both ends of the series (clipped)."""
    rng = np.random.default_rng(qlen + r)
    s, n, b, m = 300, 256, 8, 512 * 49
    data = _t(np.cumsum(rng.normal(size=(s, n)), -1).astype(np.float32),
              dev)
    surv = _t(rng.random((b, m)) < np.linspace(0, 1, b)[:, None], dev)
    nsurv = surv.sum(1, dtype=torch.int32)
    sidx = executor._survivors_first(surv)
    cand_sid = _t(rng.integers(0, s, (b, m)).astype(np.int32), dev)
    cand_off = _t(rng.integers(-5, n - qlen + 6, (b, m)).astype(np.int32),
                  dev)
    mu = _t(rng.normal(size=(b, m)).astype(np.float32), dev)
    sd = _t((rng.random((b, m)) + 0.5).astype(np.float32), dev)
    qs = _t(rng.normal(size=(b, qlen)).astype(np.float32), dev)
    args = (data, qs, sidx, nsurv, cand_sid, cand_off, mu, sd)
    before = dtw_survivors.launches
    got = dtw_survivors(*args, r=r, znorm=znorm)
    torch.cuda.synchronize()
    assert dtw_survivors.launches == before + 1
    assert int(nsurv[0]) == 0 and torch.isinf(got[0]).all()
    _close(got, ref.dtw_survivors_ref(*args, r=r, znorm=znorm), 1e-4, 1e-3)


@pytest.mark.parametrize("znorm", [True, False], ids=["znorm", "raw"])
def test_dtw_engine_on_cuda_equals_engine_on_cpu(dev, znorm):
    """DTW exact k-NN on one index, two devices: the same answers and
    counters; distances to rtol 1e-3 (the card's DP is the recurrence,
    the CPU's the closed form)."""
    rng = np.random.default_rng(8)
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
    for r in (16, 25):
        spec = QuerySpec(k=5, measure="dtw", r=r)
        before = (fused_gather_lb_keogh.launches, dtw_survivors.launches)
        got = gpu.search(qs, spec)
        after = (fused_gather_lb_keogh.launches, dtw_survivors.launches)
        assert all(a > b for a, b in zip(after, before))
        want = cpu.search(qs, spec)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.series, b.series)
            np.testing.assert_array_equal(a.offsets, b.offsets)
            np.testing.assert_allclose(a.dists, b.dists, rtol=1e-3,
                                       atol=1e-4)
            assert dataclasses.asdict(a.stats) == \
                dataclasses.asdict(b.stats)


# -- slice 3: the index build's and the host backend's kernels -------------

@pytest.mark.parametrize("qlen,qb", [(160, 1), (256, 1), (160, 8),
                                     (256, 8), (97, 3), (64, 11)])
@pytest.mark.parametrize("znorm", [False, True], ids=["raw", "znorm"])
def test_batch_ed_matches_plain(dev, qlen, qb, znorm):
    """The host chunk's 25,088 windows at the path's lengths, a length
    that is not a multiple of 4 (scalar loads) and 11 queries (two
    register groups)."""
    rng = np.random.default_rng(qlen + qb)
    w = _t((rng.normal(size=(25_088, qlen)) * 3 + 1).astype(np.float32), dev)
    q = _t(rng.normal(size=(qb, qlen)).astype(np.float32), dev)
    if znorm:
        q = ((q - q.mean(-1, keepdim=True))
             / q.std(-1, keepdim=True, correction=0)).contiguous()
    before = batch_ed.launches
    got = batch_ed(w, q, znorm)
    torch.cuda.synchronize()
    assert batch_ed.launches == before + 1
    _close(got, ref.batch_ed_ref(w, q, znorm), 2e-4, 2e-3)


@pytest.mark.parametrize("qlen", [160, 256, 97])
def test_lb_keogh_matches_plain(dev, qlen):
    rng = np.random.default_rng(qlen)
    w = _t(rng.normal(size=(25_088, qlen)).astype(np.float32), dev)
    lo, hi = dtw.dtw_envelope(_t(rng.normal(size=qlen).astype(np.float32),
                                 dev), max(1, qlen // 10))
    before = lb_keogh.launches
    got = lb_keogh(lo.contiguous(), hi.contiguous(), w)
    torch.cuda.synchronize()
    assert lb_keogh.launches == before + 1
    _close(got, ref.lb_keogh_ref(lo, hi, w), 1e-5, 1e-5)


@pytest.mark.parametrize("n,lmin,lmax,gamma,seg", [
    (256, 160, 256, 48, 16), (192, 64, 128, 8, 16), (100, 24, 40, 3, 8),
    (300, 96, 160, 255, 16)])
def test_envelope_znorm_bit_equal_to_plain(dev, n, lmin, lmax, gamma, seg):
    """The build entry from one pair of prefix sums (made on the card):
    the kernel, the plain version on the card and the plain version on
    the CPU give the same values; so do the per-master entry and its
    plain version."""
    rng = np.random.default_rng(n + gamma)
    x = _t(np.cumsum(rng.normal(size=(300, n)), -1).astype(np.float32), dev)
    xc = x - x.mean(dim=-1, keepdim=True)
    csum, csum2 = _prefix(xc), _prefix(xc * xc)
    kw = dict(lmin=lmin, lmax=lmax, gamma=gamma, seg_len=seg)
    before = envelope_znorm.launches
    got = envelope_znorm(csum, csum2, **kw)
    torch.cuda.synchronize()
    assert envelope_znorm.launches == before + 1
    card = ref.envelope_znorm_ref(csum, csum2, **kw)
    cpu = ref.envelope_znorm_ref(csum.cpu(), csum2.cpu(), **kw)
    for k, c, h in zip(got, card, cpu):
        assert torch.equal(k, c) and torch.equal(k.cpu(), h)
        assert torch.isfinite(k).any()
    # per master: every master of the first series, all lengths
    m = n - lmin + 1
    offs = torch.arange(m, device=dev)
    w = lmax // seg
    start = offs[:, None] + torch.arange(w, device=dev) * seg
    segmean = ref.true_div(csum[0, (start + seg).clamp(max=n)]
                           - csum[0, start.clamp(max=n)], seg)
    ends = (offs[:, None] + torch.arange(lmin, lmax + 1, device=dev)
            ).clamp(max=n)
    s1 = (csum[0, ends] - csum[0, offs][:, None]).contiguous()
    s2 = (csum2[0, ends] - csum2[0, offs][:, None]).contiguous()
    args = (segmean.contiguous(), s1, s2, offs.to(torch.int32))
    got = envelope_znorm_masters(*args, n=n, lmin=lmin, seg_len=seg)
    want = ref.envelope_scan_ref(*args, n=n, lmin=lmin, seg_len=seg)
    torch.cuda.synchronize()
    for k, c in zip(got, want):
        assert torch.equal(k, c)


def _host_engines(znorm, dev):
    rng = np.random.default_rng(9)
    data = np.cumsum(rng.normal(size=(64, 256)), -1).astype(np.float32)
    p = EnvelopeParams(lmin=160, lmax=256, seg_len=16, card=256, gamma=48,
                       znorm=znorm)
    idx = build_index(Collection.from_array(data, device="cpu"), p,
                      block_size=16, num_levels=2)
    windows = [(i, 3 * i, 200) for i in range(3)] + [(5, 0, 256)]
    qs = [data[s, o:o + qlen] + rng.normal(size=qlen).astype(np.float32)
          * 0.05 for s, o, qlen in windows]
    return (UlisseEngine.from_index(idx, device="cpu"),
            UlisseEngine.from_index(idx, device=dev), qs)


@pytest.mark.parametrize("measure", ["ed", "dtw"])
@pytest.mark.parametrize("znorm", [True, False], ids=["znorm", "raw"])
def test_host_backend_on_cuda_equals_cpu(dev, znorm, measure):
    """scan_backend="host" on one index, two devices: the same answers
    and counters through batch_ed (ED) or lb_keogh + dtw_band (DTW);
    distances are float32 on both (ED atol 5e-3, DTW rtol 1e-3)."""
    cpu, gpu, qs = _host_engines(znorm, dev)
    spec = QuerySpec(k=5, measure=measure, r=20 if measure == "dtw" else 0,
                     scan_backend="host")
    wrappers = (batch_ed,) if measure == "ed" else (lb_keogh, dtw_band)
    before = [w.launches for w in wrappers]
    got = gpu.search(qs, spec)
    assert all(w.launches > b for w, b in zip(wrappers, before))
    want = cpu.search(qs, spec)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.series, b.series)
        np.testing.assert_array_equal(a.offsets, b.offsets)
        if measure == "ed":
            np.testing.assert_allclose(a.dists, b.dists, rtol=0, atol=5e-3)
        else:
            np.testing.assert_allclose(a.dists, b.dists, rtol=1e-3,
                                       atol=1e-4)
        assert dataclasses.asdict(a.stats) == dataclasses.asdict(b.stats)


@pytest.mark.parametrize("measure", ["ed", "dtw"])
def test_approx_on_cuda_equals_cpu(dev, measure):
    """mode="approx" (device backend) on one index, two devices."""
    cpu, gpu, qs = _host_engines(True, dev)
    spec = QuerySpec(k=5, measure=measure, r=20 if measure == "dtw" else 0,
                     mode="approx")
    got, want = gpu.search(qs, spec), cpu.search(qs, spec)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.series, b.series)
        np.testing.assert_array_equal(a.offsets, b.offsets)
        np.testing.assert_allclose(a.dists, b.dists, rtol=1e-3,
                                   atol=1e-9 if measure == "ed" else 1e-4)
        assert dataclasses.asdict(a.stats) == dataclasses.asdict(b.stats)


def test_index_build_on_cuda(dev):
    """The Z-normalized build on the card goes through envelope_znorm and
    gives the CPU build's envelopes (the float32 prefix sums are cumsums
    of another order: bounds to 1e-5, symbols to 99.9%)."""
    rng = np.random.default_rng(10)
    data = np.cumsum(rng.normal(size=(200, 256)), -1).astype(np.float32)
    p = EnvelopeParams(lmin=160, lmax=256, seg_len=16, card=256, gamma=48)
    bp = isax.gaussian_breakpoints(p.card, "cpu")
    before = envelope_znorm.launches
    gpu = build_envelope_set(Collection.from_array(data, device=dev), p,
                             bp.to(dev))
    assert envelope_znorm.launches > before
    cpu = build_envelope_set(Collection.from_array(data, device="cpu"), p,
                             bp)
    for f in ("paa_lo", "paa_hi"):
        np.testing.assert_allclose(getattr(gpu, f).cpu().numpy(),
                                   getattr(cpu, f).numpy(), rtol=1e-5,
                                   atol=1e-5)
    for f in ("sym_lo", "sym_hi"):
        agree = (getattr(gpu, f).cpu() == getattr(cpu, f)).float().mean()
        assert float(agree) >= 0.999
