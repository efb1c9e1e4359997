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
(kernel and plain version run the same float32 recurrence; the tolerance
is the one set when the plain version was the closed form), batch_ed
rtol 2e-4 / atol 2e-3 and lb_keogh rtol 1e-5 / atol 1e-5 (the reference
kernel tests'); envelope_znorm bit for bit (kernel and plain version
share their arithmetic: IEEE divisions, no contraction); the LB and DP
kernels' window normalization bit for bit against the IEEE divide
(`gather_znorm`), and the LB's mu and sd bit for bit; the ED chunk entry
and both pool merges bit for bit (pool and counters) against the plain
step fed the contract entry's distances (the two entries share one
device function); the LB chunk entries' (k-NN and range) masks,
counters, survivor sets and candidate ids exactly, their lb2 within the
LB tolerance; the ED range entry's dense d2 bit for bit against the
plain step fed the contract entry's distances; `range_append` bit for
bit (buffer, counts, overflow chunks).  The paged scans (slabs through
pinned memory and a side stream, the slab ids mapped back to global
ones, the range steps' `i_code` / `no_ovf`) bit for bit against the
resident scans, a paged engine against a resident one over one saved
index, the build's prefix sums the same bits in blocks of any size, and
append -> compact on the card against `build_index` on the card.  The
serving tier over a CUDA engine: bursts from client threads bit-equal to
serial searches (also over a paging engine, against the resident one), a
refused dispatch failing its ticket, and nothing left to build or load
after `warmup`.  The sharded scan: the chunk entries with a mesh-wide
k-th (`gkth`), also with a rank's gmap over a delta-first plan with
pinned chunk heads (the delta family's step), and the distributed engine
in worlds of 1 (NCCL) and 2 (gloo) against the local engine.  The
long-row entries past the g one block of a row takes (g = 20,480): a
row's offsets tiled across blocks, against their plain versions (the
chunk-entry checks above), a forced small tile bit for bit against the
untiled entries at g = 49, and the engine answering such an index on
the device backend (ED and DTW, k-NN and range) as a float64 brute
force and the host backend do.
"""
import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (Collection, EnvelopeParams,  # noqa: E402
                              QuerySpec, UlisseEngine)
from repro_torch.core import dtw  # noqa: E402
from repro_torch.core import isax  # noqa: E402
from repro_torch.core.envelope import _prefix, build_envelope_set  # noqa: E402
from repro_torch.core.index import build_index  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.batch_ed import batch_ed  # noqa: E402
from repro_torch.kernels.dtw_band import (dtw_band,  # noqa: E402
                                          dtw_band_wide, dtw_survivors,
                                          dtw_survivors_wide)
from repro_torch.kernels.envelope import (envelope_znorm,  # noqa: E402
                                          envelope_znorm_masters)
from repro_torch.kernels.lb_keogh import lb_keogh  # noqa: E402
from repro_torch.kernels.fused_verify import (  # noqa: E402
    fused_gather_ed, fused_gather_ed_chunk, fused_gather_ed_chunk_long,
    fused_gather_ed_long, fused_gather_ed_range, fused_gather_ed_range_long,
    fused_gather_lb_keogh, fused_gather_lb_keogh_chunk,
    fused_gather_lb_keogh_chunk_long, fused_gather_lb_keogh_long,
    fused_gather_lb_keogh_range, fused_gather_lb_keogh_range_long,
    gather_znorm)
from repro_torch.kernels.mindist import mindist_paa, mindist_sym  # noqa: E402
from repro_torch.kernels.pool_merge import (  # noqa: E402
    pool_merge, pool_merge_partials)
from repro_torch.kernels.range_append import range_append  # noqa: E402

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


def _ed_plan(rng, dev, b, n_pad, qlen, s=512, n=256, g=49):
    """A (B, n_pad) LB-sorted plan over a random collection: anchors on
    the envelope grid (some windows overrun the series), random n_master,
    every fifth row a copy of its neighbour (equal d2 at two positions),
    query 0 all padding (never active), query 1 with almost no real
    master (fewer finite candidates than a large k).  lbs2 rises from 0
    to about the median distance, so the bsf cut prunes as the pool
    fills."""
    data = rng.normal(size=(s, n)).astype(np.float32) * 2 + 1
    sids = rng.integers(0, s, (b, n_pad)).astype(np.int32)
    anchors = (rng.integers(0, 4, (b, n_pad)) * g).astype(np.int32)
    n_master = rng.integers(0, g + 1, (b, n_pad)).astype(np.int32)
    copy = np.arange(1, n_pad, 5)
    sids[:, copy], anchors[:, copy] = sids[:, copy - 1], anchors[:, copy - 1]
    n_master[1] = 0
    n_master[1, ::40] = 3
    qs = rng.normal(size=(b, qlen)).astype(np.float32)
    c = Collection.from_array(data, device=dev)
    return c, _t(sids, dev), _t(anchors, dev), _t(n_master, dev), qs


def _ed_bounds(rng, dev, d2_all, n_pad):
    """Ascending lbs2 from 0 to ~1.2x each query's median finite d2
    (query 0: +inf padding only)."""
    b = d2_all.shape[0]
    med = np.array([np.median(r[np.isfinite(r)]) for r in d2_all])
    lbs2 = np.sort(rng.random((b, n_pad)), axis=1) * 1.2 * med[:, None]
    lbs2[0] = np.inf
    return _t(lbs2.astype(np.float32), dev)


def _seed_pool(rng, dev, d2_all, k):
    """A sorted (B, k) seed: about half of it exact copies of candidate
    distances (ties with newcomers), the rest +inf filler (sid -1)."""
    b = d2_all.shape[0]
    d2 = np.full((b, k), np.inf, np.float32)
    sid = np.full((b, k), -1, np.int32)
    for q in range(b):
        fin = d2_all[q][np.isfinite(d2_all[q])]
        m = min(k // 2, len(fin))
        d2[q, :m] = np.sort(rng.choice(fin, m, replace=False))
        sid[q, :m] = 100_000 + np.arange(m)
    return [_t(d2, dev), _t(sid, dev), _t(sid.copy(), dev)]


def _ed_chunk_walk(dev, k, qlen, znorm, chunk, n_chunks=3, seed=0,
                   entry=fused_gather_ed_chunk, counted=fused_gather_ed_chunk,
                   n=256, gkth=False, g=49, s=512):
    """Every chunk of a plan through (chunk entry + partials merge) and
    through the plain step (the contract entry's distances masked, the
    counters, the stable-sort merge) from one seed: the pools and
    counters must be equal bit for bit after every step.  `entry` is
    the chunk wrapper called, `counted` the one whose launch it counts;
    n the series length.  `gkth`: both steps also take a sharded scan's
    mesh-wide k-th, a quarter of each query's median candidate d2 (+inf
    for query 3, 0 for query 4: never active)."""
    rng = np.random.default_rng(seed + k + qlen + znorm + chunk)
    b = 8
    n_pad = chunk * n_chunks
    c, sids, anchors, n_master, qs_np = _ed_plan(rng, dev, b, n_pad, qlen,
                                                 n=n, g=g, s=s)
    qs = _t(qs_np, dev)
    a0 = (c.data, c.csum, c.csum2, c.csum_lo, c.csum2_lo, c.center)
    d2_all = fused_gather_ed(*a0, sids.reshape(-1), anchors.reshape(-1), qs,
                             g=g, rows=n_pad, znorm=znorm)
    d2_all = d2_all.reshape(b, -1).cpu().numpy()
    lbs2 = _ed_bounds(rng, dev, d2_all, n_pad)
    pool = _seed_pool(rng, dev, d2_all, k)
    gk = None
    if gkth:
        med = np.array([np.median(r[np.isfinite(r)]) for r in d2_all])
        gk_np = (0.25 * med).astype(np.float32)
        gk_np[3], gk_np[4] = np.inf, 0.0
        gk = _t(gk_np, dev)
    plain = [t.clone() for t in pool]
    st = torch.zeros((b, 6), dtype=torch.int32, device=dev)
    st_plain = st.clone()
    for i in range(n_chunks):
        cols = slice(i * chunk, (i + 1) * chunk)
        dist = fused_gather_ed(*a0, sids[:, cols].reshape(-1).contiguous(),
                               anchors[:, cols].reshape(-1).contiguous(), qs,
                               g=g, rows=chunk, znorm=znorm)
        part = ref.fused_gather_ed_chunk_ref(
            *a0, sids, anchors, n_master, lbs2, qs, plain[0], st_plain, i=i,
            chunk=chunk, g=g, znorm=znorm, dist=dist, gkth=gk)
        for t, v in zip(plain, ref.pool_merge_partials_ref(plain, part)):
            t.copy_(v)
        before = (counted.launches, pool_merge_partials.launches)
        part = entry(*a0, sids, anchors, n_master, lbs2, qs, pool[0], st,
                     i=i, chunk=chunk, g=g, znorm=znorm,
                     **({} if gk is None else {"gkth": gk}))
        pool_merge_partials(pool, part)
        torch.cuda.synchronize()
        assert (counted.launches, pool_merge_partials.launches) == \
            (before[0] + 1, before[1] + 1)
        for x, y in zip(pool, plain):
            assert torch.equal(x, y), f"step {i}: pools differ"
        assert torch.equal(st, st_plain), f"step {i}: counters differ"
    return pool, st


@pytest.mark.parametrize("k", [1, 5, 64, 500])
@pytest.mark.parametrize("qlen", [160, 256])
@pytest.mark.parametrize("znorm", [False, True], ids=["raw", "znorm"])
def test_fused_gather_ed_chunk_and_merge_equal_plain_step(dev, k, qlen,
                                                          znorm):
    """100-row chunks (not a multiple of the block's rows): query 0 is
    never active (pool and counters unchanged), query 1 ends with +inf
    rows when k exceeds its finite candidates, and ties (equal rows,
    seeds copied from candidates) are broken as the stable sort breaks
    them."""
    pool, st = _ed_chunk_walk(dev, k, qlen, znorm, chunk=100)
    assert int(st[0].abs().sum()) == 0
    assert bool(torch.isinf(pool[0][0, k // 2:]).all())
    assert int(st[2:, 0].min()) >= 1
    if k == 500:
        assert bool(torch.isinf(pool[0][1, -1]))


@pytest.mark.parametrize("chunk", [64, 512])
def test_fused_gather_ed_chunk_main_path_rows(dev, chunk):
    """The main path's chunk rows (the approximate pass's 64, the exact
    scan's 512) at k = 5."""
    _ed_chunk_walk(dev, 5, 256, True, chunk=chunk, seed=1)


@pytest.mark.parametrize("k", [1, 5, 64, 500])
def test_pool_merge_dense_equals_stable_sort(dev, k):
    """The dense entry over (B, 25,088) rows, mostly +inf, with ties
    among candidates and with the incumbents, several rounds: equal to
    the stable-sort merge in all three pool tensors."""
    rng = np.random.default_rng(k)
    b, m = 8, 512 * 49
    pool = [torch.full((b, k), float("inf"), device=dev),
            torch.full((b, k), -1, dtype=torch.int32, device=dev),
            torch.full((b, k), -1, dtype=torch.int32, device=dev)]
    plain = [t.clone() for t in pool]
    for rnd in range(4):
        d2 = np.full((b, m), np.inf, np.float32)
        live = rng.random((b, m)) < (0.3 if rnd == 0 else 0.02)
        d2[live] = rng.integers(0, 400, int(live.sum())).astype(np.float32)
        if rnd:      # exact ties with the incumbents
            cur = plain[0].cpu().numpy()
            d2[:, :k] = np.where(np.isfinite(cur), cur, d2[:, :k])
        d2[2] = np.inf                       # a query with no candidate
        sid = _t(rng.integers(0, 10 ** 6, (b, m)).astype(np.int32), dev)
        off = _t(rng.integers(0, 256, (b, m)).astype(np.int32), dev)
        d2 = _t(d2, dev)
        for t, v in zip(plain, ref.pool_merge_ref(plain, d2, sid, off)):
            t.copy_(v)
        before = pool_merge.launches
        pool_merge(pool, d2, sid, off)
        torch.cuda.synchronize()
        assert pool_merge.launches == before + 1
        for x, y in zip(pool, plain):
            assert torch.equal(x, y), f"round {rnd}: pools differ"


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
    # the scan's ED step: the chunk entry and the partials merge
    counted = (fused_gather_ed_chunk, pool_merge_partials, mindist_sym,
               mindist_paa)
    before = [w.launches for w in counted]
    got = gpu.search(qs, QuerySpec(k=5))
    after = [w.launches for w in counted]
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
                                   (255, 16, 300), (97, 25, 200),
                                   (64, 64, 90), (100, 300, 40),
                                   (97, 96, 60), (64, 63, 60),
                                   (300, 200, 20), (600, 300, 12),
                                   (700, 511, 6),
                                   (40, 1, 300), (41, 1, 300), (2, 1, 9),
                                   (1, 3, 5)])
def test_dtw_band_matches_plain(dev, l, r, n):
    """Path shapes (r = 16, 25) at even and odd qlen, r = qlen - 1 (odd
    and even), a band covering the row (r >= qlen), bands of 2, 4, 8 and
    16 slot pairs a lane up to the limit 2r + 1 = 1023 < 1024, r = 1 at
    even and odd qlen, qlen = 2 and a single point."""
    rng = np.random.default_rng(l + r)
    q = _t(rng.normal(size=l).astype(np.float32), dev)
    c = _t(rng.normal(size=(n, l)).astype(np.float32), dev)
    before = dtw_band.launches
    got = dtw_band(q, c, r)
    torch.cuda.synchronize()
    assert dtw_band.launches == before + 1
    _close(got, ref.dtw_band_ref(q, c, r), 1e-4, 1e-3)


@pytest.mark.parametrize("qlen,r", [(160, 16), (256, 25), (64, 100),
                                    (256, 255)])
@pytest.mark.parametrize("znorm", [False, True], ids=["raw", "znorm"])
def test_dtw_survivors_matches_plain(dev, qlen, r, znorm):
    """One launch over a chunk of B = 8 queries: survivors from none
    (nsurv = 0) to all, listed in a shuffled order, offsets past both
    ends of the series (clipped); the other positions stay +inf.  Bands
    of 1, 2 and 8 slot pairs a lane; the last (2r + 1 = 511) needs more
    than 48 KB of shared memory a block (the opt-in launch)."""
    rng = np.random.default_rng(qlen + r)
    s, n, b, m = 300, 256, 8, 512 * 49
    data = _t(np.cumsum(rng.normal(size=(s, n)), -1).astype(np.float32),
              dev)
    surv = rng.random((b, m)) < np.linspace(0, 1, b)[:, None]
    nsurv = _t(surv.sum(1).astype(np.int32), dev)
    slist = np.zeros((b, m), np.int32)
    for i in range(b):
        pos = rng.permutation(np.nonzero(surv[i])[0])
        slist[i, :len(pos)] = pos
    slist = _t(slist, dev)
    cand_sid = _t(rng.integers(0, s, (b, m)).astype(np.int32), dev)
    cand_off = _t(rng.integers(-5, n - qlen + 6, (b, m)).astype(np.int32),
                  dev)
    mu = _t(rng.normal(size=(b, m)).astype(np.float32), dev)
    sd = _t((rng.random((b, m)) + 0.5).astype(np.float32), dev)
    qs = _t(rng.normal(size=(b, qlen)).astype(np.float32), dev)
    d2 = _t(np.where(surv, np.nan, np.inf).astype(np.float32), dev)
    args = (data, qs, slist, nsurv, cand_sid, cand_off, mu, sd)
    before = dtw_survivors.launches
    got = dtw_survivors(*args, d2.clone(), r=r, znorm=znorm)
    torch.cuda.synchronize()
    assert dtw_survivors.launches == before + 1
    assert torch.isinf(got[0]).all() and not got.isnan().any()
    _close(got, ref.dtw_survivors_ref(*args, d2.clone(), r=r, znorm=znorm),
           1e-4, 1e-3)


def _chunk_args(dev, rng, rows, qlen, r, b=8, s=512, n=256, g=49):
    data = rng.normal(size=(s, n)).astype(np.float32) * 2 + 1
    sids = rng.integers(0, s, b * rows).astype(np.int32)
    anchors = rng.integers(0, n - qlen + 1, b * rows).astype(np.int32)
    anchors[0] = n - qlen
    lo, hi = dtw.dtw_envelope(_t(rng.normal(size=(b, qlen)).astype(
        np.float32), dev), r)
    c = Collection.from_array(data, device=dev)
    return (c.data, c.csum, c.csum2, c.csum_lo, c.csum2_lo, c.center,
            _t(sids, dev), _t(anchors, dev), lo.contiguous(),
            hi.contiguous())


@pytest.mark.parametrize("rows", [64, 512])
@pytest.mark.parametrize("qlen,r", [(160, 16), (256, 25), (97, 9)])
@pytest.mark.parametrize("znorm", [False, True], ids=["raw", "znorm"])
def test_fused_gather_lb_keogh_chunk_matches_plain(dev, rows, qlen, r,
                                                   znorm):
    """The chunk entry in one launch, k-NN and range cuts: lb2 (+inf off
    the candidates it takes) within the LB tolerance, mu, sd and every
    candidate's (sid, off) bit-equal, the counters the plain version's
    (the survivor columns the kernel's own count), the same survivor set
    and count as the plain entry (k-NN: none for query 0, all ok for
    query 7; range: query 0 at eps2 = 0, query 1 overflowed), +inf in the
    DP's output at every non-survivor."""
    rng = np.random.default_rng(rows + qlen + znorm)
    args = _chunk_args(dev, rng, rows, qlen, r)
    for range_mode in (False, True):
        _lb_chunk_check(dev, rng, args, rows, znorm, range_mode=range_mode)


def _lb_plan(dev, rng, args, rows, b, g):
    """The chunk entries' inputs from contract-entry args (flat B * rows
    sids/anchors): a (B, 2 rows) plan whose chunk 1 holds those rows
    (chunk 0 a shuffled copy), random master counts (a fifth of the rows
    short of g), bounds 0 but every seventh row 1e30 (cut by a finite
    cut).  Returns (a0, plan, (dtw_lo, dtw_hi))."""
    sids, anchors = (x.reshape(b, rows) for x in args[6:8])
    perm = torch.randperm(rows, device=dev)
    sids = torch.cat([sids[:, perm], sids], 1).contiguous()
    anchors = torch.cat([anchors[:, perm], anchors], 1).contiguous()
    nm = np.where(rng.random((b, 2 * rows)) < 0.2,
                  rng.integers(0, g, (b, 2 * rows)), g).astype(np.int32)
    lbs2 = np.zeros((b, 2 * rows), np.float32)
    lbs2[:, 1::7] = 1e30
    lbs2[:, rows] = 0.0                 # chunk 1's first bound
    return (args[:6], (sids, anchors, _t(nm, dev), _t(lbs2, dev)),
            args[8:10])


def _lb_chunk_check(dev, rng, args, rows, znorm, counted=None, b=8, g=49,
                    range_mode=False, gkth=False):
    """The LB chunk entry over chunk 1 of `_lb_plan`'s plan (one launch
    counted by `counted`: default the staged entry of the mode) against
    its plain version: see test_fused_gather_lb_keogh_chunk_matches_plain.
    The cut is each query's 10% quantile of its lb2; `gkth` (k-NN): both
    also take a sharded scan's mesh-wide k-th, half the cut (+inf for the
    last query), so the effective cut is the min of the two."""
    a0, plan, env = _lb_plan(dev, rng, args, rows, b, g)
    lb_all = ref.fused_gather_lb_keogh_ref(*args, g=g, rows=rows,
                                           znorm=znorm)[0].reshape(b, -1)
    cut = lb_all.sort(dim=1).values[:, rows * g // 10].contiguous()
    cut[0] = 0.0 if range_mode else -float("inf")
    cut[b - 1] = float("inf")
    extra, eff = {}, cut
    if gkth:
        gk = (cut * 0.5).contiguous()
        gk[b - 1] = float("inf")
        extra, eff = {"gkth": gk}, torch.minimum(cut, gk)
    st = torch.zeros((b, 6), dtype=torch.int32, device=dev)
    st_plain = st.clone()
    kw = dict(i=1, chunk=rows, g=g, znorm=znorm)
    if range_mode:
        ovf = torch.full((b,), 2, dtype=torch.int32, device=dev)
        ovf[1] = 0                      # overflowed at chunk 0: inactive
        entry, tail = fused_gather_lb_keogh_range, (cut, ovf)
        plain = ref.fused_gather_lb_keogh_range_ref
    else:
        entry, tail = fused_gather_lb_keogh_chunk, (cut[:, None].contiguous(),)
        plain = ref.fused_gather_lb_keogh_chunk_ref
    counted = counted or entry
    before = counted.launches
    got = entry(*a0, *plan, *env, *tail, st, **kw, **extra)
    want = plain(*a0, *plan, *env, *tail, st_plain, **kw, **extra)
    torch.cuda.synchronize()
    assert counted.launches == before + 1
    _close(got[0], want[0], 2e-4, 2e-3)
    for x, y in zip(got[1:3] + got[6:8], want[1:3] + want[6:8]):
        assert torch.equal(x, y)
    # the survivor set: the plain version's, from the kernel's own lb2
    # (an lb2 within rounding of the cut may fall on either side)
    ok = torch.isfinite(want[0].reshape(b, -1))
    lb = got[0].reshape(b, -1)
    below = lb <= eff[:, None] if range_mode else lb < eff[:, None]
    surv = ok & below
    assert torch.equal(got[4], surv.sum(dim=1, dtype=torch.int32))
    assert int(got[4][1 if range_mode else 0]) == 0
    assert int(got[4][-1]) == int(ok[-1].sum()) > 0
    for i in range(b):
        listed = got[3][i, :int(got[4][i])].sort().values
        assert torch.equal(listed.long(), surv[i].nonzero()[:, 0])
    assert torch.isinf(got[5][~surv]).all()
    cols = [0, 1, 3, 5]
    assert torch.equal(st[:, cols], st_plain[:, cols])
    assert torch.equal(st[:, 2], got[4]) and torch.equal(st[:, 4], got[4])
    # against the plain version's set: they differ only where the plain
    # lb2 lies within the LB tolerance of the cut
    plain_lb = want[0].reshape(b, -1)
    plain_below = (plain_lb <= eff[:, None] if range_mode
                   else plain_lb < eff[:, None])
    differ = surv != (ok & plain_below)
    near = (plain_lb - eff[:, None]).abs() <= 2e-3 + 2e-4 * eff.abs()[:, None]
    assert bool((near | ~differ).all())


@pytest.mark.parametrize("rows", [64, 512])
@pytest.mark.parametrize("qlen", [160, 256])
@pytest.mark.parametrize("znorm", [False, True], ids=["raw", "znorm"])
def test_fused_gather_ed_range_matches_plain(dev, rows, qlen, znorm):
    """The ED chunk entry's range mode over three chunks of a plan: the
    dense d2 bit-equal to the plain step fed the contract entry's
    distances (the same device function), and the counters equal; query
    0 all padding (never active), query 2 overflowed at chunk 1, eps2 the
    median finite distance (query 3: 0, so only the cut's inclusive
    edge)."""
    rng = np.random.default_rng(rows + qlen + znorm + 5)
    b, g, n_pad = 8, 49, 3 * rows
    coll, sids, anchors, nm, qs = _ed_plan(rng, dev, b, n_pad, qlen)
    a0 = (coll.data, coll.csum, coll.csum2, coll.csum_lo, coll.csum2_lo,
          coll.center)
    q = _t(qs, dev)
    d2_all = fused_gather_ed(*a0, sids.reshape(-1), anchors.reshape(-1), q,
                             g=g, rows=n_pad, znorm=znorm).reshape(b, -1)
    lbs2 = _ed_bounds(rng, dev, d2_all.cpu().numpy(), n_pad)
    eps2 = d2_all.median(dim=1).values.contiguous()
    eps2[3] = 0.0
    ovf = torch.full((b,), 3, dtype=torch.int32, device=dev)
    st = torch.zeros((b, 6), dtype=torch.int32, device=dev)
    st_plain = st.clone()
    for i in range(3):
        ovf[2] = 1 if i >= 2 else 3
        cols = slice(i * rows, (i + 1) * rows)
        dist = fused_gather_ed(*a0, sids[:, cols].reshape(-1).contiguous(),
                               anchors[:, cols].reshape(-1).contiguous(), q,
                               g=g, rows=rows, znorm=znorm)
        want = ref.fused_gather_ed_range_ref(
            *a0, sids, anchors, nm, lbs2, q, eps2, ovf, st_plain, i=i,
            chunk=rows, g=g, znorm=znorm, dist=dist)
        before = fused_gather_ed_range.launches
        got = fused_gather_ed_range(*a0, sids, anchors, nm, lbs2, q, eps2,
                                    ovf, st, i=i, chunk=rows, g=g,
                                    znorm=znorm)
        torch.cuda.synchronize()
        assert fused_gather_ed_range.launches == before + 1
        assert torch.equal(got, want)
        assert torch.equal(st, st_plain)
        assert torch.isinf(got[0]).all()
        if i >= 2:
            assert torch.isinf(got[2]).all()


@pytest.mark.parametrize("m", [25_088, 3_000, 1])
def test_range_append_matches_plain(dev, m):
    """The ordered append, bit for bit against the plain version over
    four chunks: hits (finite d2 <= eps2, inclusive) in position order,
    the all-or-nothing rule at the edge — query 1's chunk that fills its
    buffer exactly (cnt + hits == cap) is written, query 2's one more is
    refused and ovf records the chunk once — and queries with no hits."""
    rng = np.random.default_rng(m)
    b, g = 8, 49 if m > 1 else 1
    chunk = max(1, m // g)
    m = chunk * g
    n_pad, cap = 4 * chunk, 64
    sids = _t(rng.integers(0, 1000, (b, n_pad)).astype(np.int32), dev)
    anchors = _t(rng.integers(0, 200, (b, n_pad)).astype(np.int32), dev)
    eps2 = _t(rng.random(b).astype(np.float32) * 0.01, dev)
    eps2[1:3] = 0.01
    eps2[5] = 0.0
    buf = [torch.full((b, cap), float("inf"), device=dev),
           torch.full((b, cap), -1, dtype=torch.int32, device=dev),
           torch.full((b, cap), -1, dtype=torch.int32, device=dev)]
    cnt = _t(np.array([0, cap - 5, cap - 5, 0, 0, 0, 0, 0], np.int32), dev)
    ovf = torch.full((b,), 4, dtype=torch.int32, device=dev)
    plain = [t.clone() for t in buf] + [cnt.clone(), ovf.clone()]
    for i in range(4):
        d2 = _t(rng.random((b, m)).astype(np.float32), dev)
        d2[rng.random((b, m)) < 0.3] = float("inf")
        d2[4] = float("inf")                   # no hit at all
        d2[5, : min(m, 3)] = 0.0               # exactly at eps2 = 0
        if i == 0:                             # 5 hits: fills query 1's
            d2[1:3] = float("inf")
            d2[1, :min(m, 5)] = 0.001
            d2[2, :min(m, 6)] = 0.0            # 6 hits: one too many
        else:                                  # inactive once overflowed
            d2[2] = float("inf")
        before = range_append.launches
        range_append(d2, sids, anchors, eps2, buf, cnt, ovf, i=i,
                     chunk=chunk, g=g)
        ref.range_append_ref(d2, sids, anchors, eps2, plain[:3], plain[3],
                             plain[4], i=i, chunk=chunk, g=g)
        torch.cuda.synchronize()
        assert range_append.launches == before + 1
        for x, y in zip(buf + [cnt, ovf], plain):
            assert torch.equal(x, y)
    if m >= 6:
        assert int(cnt[1]) == cap and int(ovf[1]) == 1
        assert int(ovf[2]) == 0 and int(cnt[2]) == cap - 5
    assert int(cnt[4]) == 0 and int(ovf[4]) == 4


@pytest.mark.parametrize("qlen,r", [(160, 16), (256, 25), (97, 9)])
@pytest.mark.parametrize("znorm", [False, True], ids=["raw", "znorm"])
def test_gather_znorm_bit_equal_to_divide(dev, qlen, r, znorm):
    """The LB and DP kernels' normalization (one reciprocal a window and
    a corrected product a point) equals the IEEE subtract and divide of
    the plain version bit for bit, at every point of 512 x 8 rows."""
    rng = np.random.default_rng(qlen + znorm)
    g, rows = 49, 512
    args = _chunk_args(dev, rng, rows, qlen, r)
    _, mu, sd = fused_gather_lb_keogh(*args, g=g, rows=rows, znorm=znorm)
    before = gather_znorm.launches
    got = gather_znorm(args[0], args[6], args[7], mu, sd, qlen=qlen, g=g)
    want = ref.gather_znorm_ref(args[0], args[6], args[7], mu, sd,
                                qlen=qlen, g=g)
    torch.cuda.synchronize()
    assert gather_znorm.launches == before + 1
    assert int((got.view(torch.int32) != want.view(torch.int32)).sum()) == 0


@pytest.mark.parametrize("znorm", [True, False], ids=["znorm", "raw"])
def test_dtw_engine_on_cuda_equals_engine_on_cpu(dev, znorm):
    """DTW exact k-NN on one index, two devices: the same answers and
    counters; distances to rtol 1e-3 (the kernels' DP on the card, its
    plain version on the CPU)."""
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
        before = (fused_gather_lb_keogh_chunk.launches,
                  dtw_survivors.launches)
        got = gpu.search(qs, spec)
        after = (fused_gather_lb_keogh_chunk.launches,
                 dtw_survivors.launches)
        assert all(a > b for a, b in zip(after, before))
        want = cpu.search(qs, spec)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.series, b.series)
            np.testing.assert_array_equal(a.offsets, b.offsets)
            np.testing.assert_allclose(a.dists, b.dists, rtol=1e-3,
                                       atol=1e-4)
            assert dataclasses.asdict(a.stats) == \
                dataclasses.asdict(b.stats)


@pytest.mark.parametrize("znorm", [True, False], ids=["znorm", "raw"])
def test_range_engine_on_cuda_equals_engine_on_cpu(dev, znorm):
    """eps-range, ED and DTW, on one index on two devices, at capacity
    2,048 and 16 (the latter overflows: the host continuation): the same
    hits in the same order and the same counters (`range_overflows`
    too); ED distances within 1e-9 (both rescored in float64), DTW rtol
    1e-3 / atol 1e-4 (the kernels' DP on the card, its plain version on
    the CPU).  The card path launches the range entries and
    `range_append`, never the k-NN entries."""
    rng = np.random.default_rng(9)
    data = np.cumsum(rng.normal(size=(64, 256)), -1).astype(np.float32)
    p = EnvelopeParams(lmin=160, lmax=256, seg_len=16, card=256, gamma=48,
                       znorm=znorm)
    idx = build_index(Collection.from_array(data, device="cpu"), p,
                      block_size=16, num_levels=2)
    cpu = UlisseEngine.from_index(idx, device="cpu")
    gpu = UlisseEngine.from_index(idx, device=dev)
    qs = [data[s, o:o + 200] + rng.normal(size=200).astype(np.float32)
          * 0.05 for s, o in [(1, 3), (5, 40), (9, 20)]]
    overflowed = 0
    for measure, r, entry in (("ed", 0, fused_gather_ed_range),
                              ("dtw", 16, fused_gather_lb_keogh_range)):
        # past the middle query's 40th neighbour, so that no window sits
        # at the radius within rounding
        eps = 1.02 * float(np.median([cpu.search(q, QuerySpec(
            k=40, measure=measure, r=r)).dists[-1] for q in qs]))
        for cap in (2048, 16):
            spec = QuerySpec(eps=eps, measure=measure, r=r,
                             range_capacity=cap)
            before = (entry.launches, range_append.launches,
                      fused_gather_ed_chunk.launches,
                      fused_gather_lb_keogh_chunk.launches)
            got = gpu.search(qs, spec)
            after = (entry.launches, range_append.launches,
                     fused_gather_ed_chunk.launches,
                     fused_gather_lb_keogh_chunk.launches)
            assert after[0] > before[0] and after[1] > before[1]
            assert after[2:] == before[2:]
            want = cpu.search(qs, spec)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a.series, b.series)
                np.testing.assert_array_equal(a.offsets, b.offsets)
                if measure == "ed":
                    np.testing.assert_allclose(a.dists, b.dists, rtol=0,
                                               atol=1e-9)
                else:
                    np.testing.assert_allclose(a.dists, b.dists, rtol=1e-3,
                                               atol=1e-4)
                assert dataclasses.asdict(a.stats) == \
                    dataclasses.asdict(b.stats)
                overflowed += a.stats.range_overflows
    assert overflowed > 0


# -- slice 3: the index build's and the host backend's kernels -------------

@pytest.mark.parametrize("n,qlen,qb,at", [
    (25_088, 160, 1, 0), (25_088, 256, 1, 0), (25_088, 160, 8, 0),
    (25_088, 256, 8, 0), (25_088, 97, 3, 0), (25_088, 64, 11, 0),
    (25_088, 256, 2, 0), (25_088, 256, 5, 0), (25_088, 160, 9, 0),
    (25_088, 97, 2, 1), (1, 256, 1, 0), (1, 160, 9, 0), (7, 97, 5, 1),
    (7, 256, 3, 0)])
@pytest.mark.parametrize("znorm", [False, True], ids=["raw", "znorm"])
def test_batch_ed_matches_plain(dev, n, qlen, qb, at, znorm):
    """The host chunk's 25,088 windows (and 1 and 7) at the path's
    lengths, every query group (Qb 1, 2, 3, 5, 8, and 9 and 11: two
    register groups), a length that is not a multiple of 4 (scalar
    loads), and windows that start 4 bytes into their buffer (`at`: a
    slice at row offset 1 of an odd L, not 16-byte aligned); one launch
    each."""
    rng = np.random.default_rng(n + qlen + qb + at)
    buf = _t((rng.normal(size=(n + at, qlen)) * 3 + 1).astype(np.float32),
             dev)
    w = buf[at:]
    assert w.is_contiguous() and (w.data_ptr() % 16 != 0) == (at > 0)
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


# -- slice 6: any band and length, the redesigned build and bound --------

def _survivor_args(dev, rng, qlen, b=4, m=64, s=24, n=None):
    """A chunk's DP inputs: B queries, M candidates (offsets past both
    ends of the series, clipped), survivors from none to all in a
    shuffled order."""
    n = n or qlen + 40
    data = _t(np.cumsum(rng.normal(size=(s, n)), -1).astype(np.float32), dev)
    surv = rng.random((b, m)) < np.linspace(0, 1, b)[:, None]
    slist = np.zeros((b, m), np.int32)
    for i in range(b):
        pos = rng.permutation(np.nonzero(surv[i])[0])
        slist[i, :len(pos)] = pos
    d2 = np.where(surv, np.nan, np.inf).astype(np.float32)
    return (data, _t(rng.normal(size=(b, qlen)).astype(np.float32), dev),
            _t(slist, dev), _t(surv.sum(1).astype(np.int32), dev),
            _t(rng.integers(0, s, (b, m)).astype(np.int32), dev),
            _t(rng.integers(-5, n - qlen + 6, (b, m)).astype(np.int32), dev),
            _t(rng.normal(size=(b, m)).astype(np.float32), dev),
            _t((rng.random((b, m)) + 0.5).astype(np.float32), dev)), d2


@pytest.mark.parametrize("l,r,n", [(600, 512, 6), (600, 600, 6),
                                   (1536, 1535, 3), (8192, 819, 3),
                                   (7000, 20, 3)])
def test_dtw_wide_entries_match_plain(dev, l, r, n):
    """Bands past the warp entries' 1024 slots (W = 1025, 1199, 3071 and
    1639 at qlen 8192) and a qlen past their 6144 with a narrow band:
    `dtw_band` hands each to the wide entry (its count, not its own, goes
    up); both DP entries against their plain versions, rtol 1e-4 / atol
    1e-3."""
    rng = np.random.default_rng(l + r)
    q = _t(rng.normal(size=l).astype(np.float32), dev)
    c = _t(rng.normal(size=(n, l)).astype(np.float32), dev)
    before = (dtw_band.launches, dtw_band_wide.launches)
    got = dtw_band(q, c, r)
    torch.cuda.synchronize()
    assert (dtw_band.launches, dtw_band_wide.launches) == \
        (before[0], before[1] + 1)
    _close(got, ref.dtw_band_ref(q, c, r), 1e-4, 1e-3)
    args, d2 = _survivor_args(dev, rng, l)
    before = (dtw_survivors.launches, dtw_survivors_wide.launches)
    got = dtw_survivors(*args, _t(d2, dev), r=r, znorm=True)
    torch.cuda.synchronize()
    assert (dtw_survivors.launches, dtw_survivors_wide.launches) == \
        (before[0], before[1] + 1)
    assert not got.isnan().any()
    _close(got, ref.dtw_survivors_ref(*args, _t(d2, dev), r=r, znorm=True),
           1e-4, 1e-3)


@pytest.mark.parametrize("r", [1, 3])
def test_dtw_wide_entry_global_scratch_matches_plain(dev, r):
    """qlen 29,100: the wide entry's buffer (2 rr + 3 + 2 qlen floats)
    no longer fits shared memory and lives in global scratch; against
    the plain version on the CPU (one call there is ~58k steps)."""
    rng = np.random.default_rng(r)
    l = 29_100
    q = rng.normal(size=l).astype(np.float32)
    c = rng.normal(size=(3, l)).astype(np.float32)
    got = dtw_band_wide(_t(q, dev), _t(c, dev), r)
    torch.cuda.synchronize()
    _close(got, ref.dtw_band_ref(_t(q, "cpu"), _t(c, "cpu"), r), 1e-4, 1e-3)


@pytest.mark.parametrize("znorm", [False, True], ids=["raw", "znorm"])
def test_dtw_narrow_and_wide_entries_bit_equal(dev, znorm):
    """W = 1023 (qlen 700, r 511; qlen 600, r 511 for the survivors),
    which both entries take: the same bits."""
    rng = np.random.default_rng(1023)
    q = _t(rng.normal(size=700).astype(np.float32), dev)
    c = _t(rng.normal(size=(9, 700)).astype(np.float32), dev)
    narrow, wide = dtw_band(q, c, 511), dtw_band_wide(q, c, 511)
    torch.cuda.synchronize()
    assert torch.equal(narrow, wide)
    args, d2 = _survivor_args(dev, rng, 600)
    narrow = dtw_survivors(*args, _t(d2, dev), r=511, znorm=znorm)
    wide = dtw_survivors_wide(*args, _t(d2, dev), r=511, znorm=znorm)
    torch.cuda.synchronize()
    assert torch.equal(narrow, wide)


@pytest.mark.parametrize("l,qb,launches", [(12_300, 1, 1), (12_301, 1, 1),
                                           (2_048, 8, 1), (2_048, 11, 1),
                                           (12_301, 3, 1), (2_049, 9, 1)])
@pytest.mark.parametrize("znorm", [False, True], ids=["raw", "znorm"])
def test_batch_ed_long_rows_match_plain(dev, l, qb, launches, znorm):
    """Long rows, streamed in steps of 128 points (12,301 and 2,049 take
    scalar loads), and batches past one register group of 8 queries: one
    launch each; rtol 2e-4 / atol 2e-3."""
    rng = np.random.default_rng(l + qb)
    w = _t((rng.normal(size=(1_000, l)) * 3 + 1).astype(np.float32), dev)
    q = _t(rng.normal(size=(qb, l)).astype(np.float32), dev)
    if znorm:
        q = ((q - q.mean(-1, keepdim=True))
             / q.std(-1, keepdim=True, correction=0)).contiguous()
    before = batch_ed.launches
    got = batch_ed(w, q, znorm)
    torch.cuda.synchronize()
    assert batch_ed.launches == before + launches
    _close(got, ref.batch_ed_ref(w, q, znorm), 2e-4, 2e-3)


@pytest.mark.parametrize("l", [6_200, 6_201, 20_000])
def test_lb_keogh_long_rows_match_plain(dev, l):
    """Envelopes past the 48 KB of staging (tiles of L; 6,201 takes
    scalar loads); rtol 1e-5 / atol 1e-5."""
    rng = np.random.default_rng(l)
    w = _t(rng.normal(size=(2_000, l)).astype(np.float32), dev)
    lo, hi = dtw.dtw_envelope(_t(rng.normal(size=l).astype(np.float32),
                                 dev), l // 10)
    before = lb_keogh.launches
    got = lb_keogh(lo.contiguous(), hi.contiguous(), w)
    torch.cuda.synchronize()
    assert lb_keogh.launches == before + 1
    _close(got, ref.lb_keogh_ref(lo, hi, w), 1e-5, 1e-5)


@pytest.mark.parametrize("n,lmin,lmax,gamma,seg", [
    (256, 160, 256, 48, 16), (192, 64, 128, 8, 16), (100, 24, 40, 3, 8),
    (300, 96, 160, 255, 16), (256, 160, 256, 48, 160),
    (256, 200, 200, 48, 16), (256, 160, 256, 0, 16), (258, 160, 256, 48, 16),
    (600, 520, 544, 8, 16)])
def test_envelope_build_bit_equal_to_plain(dev, n, lmin, lmax, gamma, seg):
    """The redesigned build entry, bit for bit against its plain version
    (on the card and on the CPU): today's four shapes, seg_len = lmin,
    lmin = lmax, gamma = 0, n = 258 (the last envelope holds one master)
    and w = 34 segments (three passes of 16)."""
    rng = np.random.default_rng(n + lmin + gamma + seg)
    x = _t(np.cumsum(rng.normal(size=(200, n)), -1).astype(np.float32), dev)
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


@pytest.mark.parametrize("nseg", [10, 16])
@pytest.mark.parametrize("b,launches", [(1, 1), (8, 1), (9, 2)])
def test_mindist_sym_vector_loads_match_plain(dev, nseg, b, launches):
    """The symbol entry's 16-byte row loads at the path's w = 16 (nseg 10
    and 16), B = 1, 8 and 9 (two launches); rtol 1e-6 / atol 1e-6."""
    rng = np.random.default_rng(nseg + b)
    n, w = 200_003, 16
    lo = rng.normal(size=(n, w)).astype(np.float32)
    hi = lo + np.abs(rng.normal(size=(n, w))).astype(np.float32)
    lo[0, 0], hi[0, 0] = -np.inf, np.inf
    bp = np.sort(rng.normal(size=255)).astype(np.float32)
    sym_lo = _t(np.searchsorted(bp, lo, side="right").astype(np.int32), dev)
    sym_hi = _t(np.searchsorted(bp, hi, side="right").astype(np.int32), dev)
    valid = rng.random(n) > 0.1
    valid[1] = False
    v, bpt = _t(valid, dev), _t(bp, dev)
    q = rng.normal(size=(b, w)).astype(np.float32)
    ql = _t(q, dev)
    qh = _t(q + rng.random((b, w)).astype(np.float32), dev)
    before = mindist_sym.launches
    got = mindist_sym(ql, qh, sym_lo, sym_hi, bpt, v, 16, nseg)
    torch.cuda.synchronize()
    assert mindist_sym.launches == before + launches
    want = ref.mindist_sym_ref(ql, qh, sym_lo, sym_hi, bpt, v, 16, nseg)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("znorm", [True, False], ids=["znorm", "raw"])
def test_dtw_engine_long_queries_on_cuda_equal_cpu(dev, znorm):
    """DTW k-NN at qlen 530 / 540 with r = 520 and 600 on an index of
    560-point series (lmin 520, lmax 544): the device scan goes through
    the wide survivors entry and the host backend through the wide band
    entry; both equal the CPU engine (answers, counters, distances)."""
    rng = np.random.default_rng(11)
    data = np.cumsum(rng.normal(size=(6, 560)), -1).astype(np.float32)
    p = EnvelopeParams(lmin=520, lmax=544, seg_len=16, card=64, gamma=8,
                       znorm=znorm)
    idx = build_index(Collection.from_array(data, device="cpu"), p,
                      block_size=4, num_levels=1)
    cpu = UlisseEngine.from_index(idx, device="cpu")
    gpu = UlisseEngine.from_index(idx, device=dev)
    qs = [data[s, o:o + qlen] + rng.normal(size=qlen).astype(np.float32)
          * 0.05 for s, o, qlen in [(0, 10, 530), (3, 2, 540)]]
    for r, backend, wrapper in ((520, "device", dtw_survivors_wide),
                                (600, "host", dtw_band_wide)):
        spec = QuerySpec(k=3, measure="dtw", r=r, scan_backend=backend)
        before = wrapper.launches
        got = gpu.search(qs, spec)
        assert wrapper.launches > before
        want = cpu.search(qs, spec)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.series, b.series)
            np.testing.assert_array_equal(a.offsets, b.offsets)
            np.testing.assert_allclose(a.dists, b.dists, rtol=1e-4,
                                       atol=1e-5)
            assert dataclasses.asdict(a.stats) == \
                dataclasses.asdict(b.stats)


def test_device_backend_answers_queries_past_the_staged_lb_entry(dev):
    """A DTW query longer than the LB_Keogh chunk entry stages (qlen
    20,032 at gamma = 0, past ~19,370) runs on the device backend through
    the entry's long-row variant and gives the host backend's answer
    (`lb_keogh` in steps of L, the wide DP entry)."""
    from repro_torch.kernels.fused_verify import staged
    seg, qlen = 64, 20_032
    assert not staged("dtw", qlen, 1) and staged("ed", qlen, 1)
    rng = np.random.default_rng(qlen)
    data = np.cumsum(rng.normal(size=(2, qlen + 8)), -1).astype(np.float32)
    p = EnvelopeParams(lmin=qlen, lmax=qlen, seg_len=seg, card=64, gamma=0)
    gpu = UlisseEngine.from_collection(
        Collection.from_array(data, device=dev), p, block_size=4,
        num_levels=1, device=dev)
    q = data[1, 3:3 + qlen] + rng.normal(size=qlen).astype(np.float32) * 0.05
    spec = dict(k=2, measure="dtw", r=8)
    before = (fused_gather_lb_keogh_chunk.launches,
              fused_gather_lb_keogh_chunk_long.launches)
    got = gpu.search(q, QuerySpec(**spec))
    assert fused_gather_lb_keogh_chunk.launches == before[0]
    assert fused_gather_lb_keogh_chunk_long.launches > before[1]
    before = dtw_band_wide.launches
    want = gpu.search(q, QuerySpec(scan_backend="host", **spec))
    assert dtw_band_wide.launches > before
    assert (got.series[0], got.offsets[0]) == (1, 3)
    np.testing.assert_array_equal(got.series, want.series)
    np.testing.assert_array_equal(got.offsets, want.offsets)
    np.testing.assert_allclose(got.dists, want.dists, rtol=1e-4, atol=1e-5)


# -- slice 7: every query length on the card ---------------------------------

@pytest.mark.parametrize("nseg", [737, 1_500, 6_000])
@pytest.mark.parametrize("b", [1, 4, 8])
def test_mindist_long_queries_match_plain(dev, b, nseg):
    """Queries of 737-6,000 segments: past the 736 whose intervals the
    scalar entry staged in 48 KB at B = 8 (opt-in shared memory), and at
    6,000 past the 227 KB (the intervals read in place); both entries,
    one launch each; rtol 1e-6 / atol 1e-6."""
    rng = np.random.default_rng(b + nseg)
    n, w = 3_001, nseg
    lo = rng.normal(size=(n, w)).astype(np.float32)
    hi = lo + np.abs(rng.normal(size=(n, w))).astype(np.float32)
    lo[0, :5], hi[0, :5] = -np.inf, np.inf
    bp = np.sort(rng.normal(size=255)).astype(np.float32)
    sym_lo = _t(np.searchsorted(bp, lo, side="right").astype(np.int32), dev)
    sym_hi = _t(np.searchsorted(bp, hi, side="right").astype(np.int32), dev)
    valid = rng.random(n) > 0.1
    valid[1] = False
    v, bpt, e_lo, e_hi = _t(valid, dev), _t(bp, dev), _t(lo, dev), _t(hi, dev)
    q = rng.normal(size=(b, w)).astype(np.float32)
    ql = _t(q, dev)
    qh = _t(q + rng.random((b, w)).astype(np.float32), dev)
    for fn, args, plain in (
            (mindist_sym, (ql, qh, sym_lo, sym_hi, bpt, v, 16, nseg),
             ref.mindist_sym_ref),
            (mindist_paa, (ql, qh, e_lo, e_hi, v, 16, nseg),
             ref.mindist_ref)):
        before = fn.launches
        got = fn(*args)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        np.testing.assert_allclose(got.cpu().numpy(),
                                   plain(*args).cpu().numpy(), rtol=1e-6,
                                   atol=1e-6)


def _long_args(dev, rng, qlen, b, rows, s=4, g=49, dtw_r=None, n=None):
    """Regions of B * rows rows over s series of n (default qlen + 200)
    points (row 0 overruns its series) and B queries (or, with dtw_r,
    their DTW envelopes)."""
    n = qlen + 200 if n is None else n
    data = np.cumsum(rng.normal(size=(s, n)), -1).astype(np.float32)
    sids = rng.integers(0, s, b * rows).astype(np.int32)
    anchors = rng.integers(0, n - qlen + 1, b * rows).astype(np.int32)
    anchors[0] = n - qlen
    q = _t(rng.normal(size=(b, qlen)).astype(np.float32), dev)
    c = Collection.from_array(data, device=dev)
    head = (c.data, c.csum, c.csum2, c.csum_lo, c.csum2_lo, c.center,
            _t(sids, dev), _t(anchors, dev))
    if dtw_r is None:
        return head + (q,)
    lo, hi = dtw.dtw_envelope(q, dtw_r)
    return head + (lo.contiguous(), hi.contiguous())


@pytest.mark.parametrize("qlen", [28_769, 40_000])
@pytest.mark.parametrize("znorm", [False, True], ids=["raw", "znorm"])
def test_fused_gather_ed_long_queries_match_plain(dev, qlen, znorm):
    """Past the staged ED entries (qlen <= 28,768 at g = 49): the contract
    entry hands the call to its long-row variant (rtol 1e-4 / atol 1e-3
    against the plain version), and the chunk entry and the partials
    merge equal the plain step bit for bit over three chunks."""
    from repro_torch.kernels.fused_verify import staged
    assert not staged("ed", qlen, 49)
    rng = np.random.default_rng(qlen + znorm)
    g, rows = 49, 16
    args = _long_args(dev, rng, qlen, 3, rows)
    before = (fused_gather_ed.launches, fused_gather_ed_long.launches)
    got = fused_gather_ed(*args, g=g, rows=rows, znorm=znorm)
    want = ref.fused_gather_ed_ref(*args, g=g, rows=rows, znorm=znorm)
    torch.cuda.synchronize()
    assert (fused_gather_ed.launches, fused_gather_ed_long.launches) == \
        (before[0], before[1] + 1)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4, atol=1e-3)
    _ed_chunk_walk(dev, 5, qlen, znorm, chunk=16,
                   counted=fused_gather_ed_chunk_long, n=qlen + 200)


@pytest.mark.parametrize("qlen", [256, 4_000])
@pytest.mark.parametrize("znorm", [False, True], ids=["raw", "znorm"])
def test_fused_gather_ed_long_variant_equals_staged(dev, qlen, znorm):
    """At a qlen both take, the long-row kernels give the staged ones'
    bits: the contract entries' d2, and the chunk entry's pools and
    counters equal the plain step fed the staged contract entry's d2."""
    from repro_torch.kernels.fused_verify import staged
    assert staged("ed", qlen, 49)
    rng = np.random.default_rng(qlen + znorm)
    args = _long_args(dev, rng, qlen, 3, 24)
    staged_d2 = fused_gather_ed(*args, g=49, rows=24, znorm=znorm)
    long_d2 = fused_gather_ed_long(*args, g=49, rows=24, znorm=znorm)
    torch.cuda.synchronize()
    assert torch.equal(staged_d2, long_d2)
    _ed_chunk_walk(dev, 5, qlen, znorm, chunk=40,
                   entry=fused_gather_ed_chunk_long,
                   counted=fused_gather_ed_chunk_long, n=qlen + 200)


@pytest.mark.parametrize("qlen", [19_305, 40_000])
@pytest.mark.parametrize("znorm", [False, True], ids=["raw", "znorm"])
def test_fused_gather_lb_keogh_long_queries_match_plain(dev, qlen, znorm):
    """Past the staged LB_Keogh entries (qlen <= 19,304 at g = 49), r = 1%
    of qlen: the contract entry's long-row variant (lb2 rtol 2e-4 / atol
    2e-3, mu and sd bit-equal to the plain version) and the chunk
    entries' in both cuts (the chunk test's checks: survivors, counts,
    the DP's output)."""
    from repro_torch.kernels.fused_verify import staged
    assert not staged("dtw", qlen, 49)
    rng = np.random.default_rng(qlen + znorm)
    g, rows, b = 49, 8, 3
    args = _long_args(dev, rng, qlen, b, rows, dtw_r=qlen // 100)
    before = (fused_gather_lb_keogh.launches,
              fused_gather_lb_keogh_long.launches)
    got = fused_gather_lb_keogh(*args, g=g, rows=rows, znorm=znorm)
    want = ref.fused_gather_lb_keogh_ref(*args, g=g, rows=rows, znorm=znorm)
    torch.cuda.synchronize()
    assert (fused_gather_lb_keogh.launches,
            fused_gather_lb_keogh_long.launches) == (before[0], before[1] + 1)
    _close(got[0], want[0], 2e-4, 2e-3)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    _lb_chunk_check(dev, rng, args, rows, znorm,
                    counted=fused_gather_lb_keogh_chunk_long, b=b)
    _lb_chunk_check(dev, rng, args, rows, znorm,
                    counted=fused_gather_lb_keogh_range_long, b=b,
                    range_mode=True)


@pytest.mark.parametrize("qlen", [256, 4_000])
@pytest.mark.parametrize("znorm", [False, True], ids=["raw", "znorm"])
def test_fused_gather_lb_keogh_long_variant_equals_staged(dev, qlen, znorm):
    """At a qlen both take, the long-row kernels give the staged ones'
    bits: (lb2, mu, sd) of the contract entries, and the chunk entries'
    outputs and counters, k-NN and range (the survivor lists as
    sets)."""
    from repro_torch.kernels.fused_verify import staged
    assert staged("dtw", qlen, 49)
    rng = np.random.default_rng(qlen + znorm)
    g, rows, b = 49, 24, 3
    args = _long_args(dev, rng, qlen, b, rows, dtw_r=max(1, qlen // 10))
    for x, y in zip(fused_gather_lb_keogh(*args, g=g, rows=rows,
                                          znorm=znorm),
                    fused_gather_lb_keogh_long(*args, g=g, rows=rows,
                                               znorm=znorm)):
        assert torch.equal(x, y)
    a0, plan, env = _lb_plan(dev, rng, args, rows, b, g)
    cut = _t(np.full(b, np.inf, np.float32), dev)
    cut[0] = 0.0
    cut[1] = float(ref.fused_gather_lb_keogh_ref(
        *args, g=g, rows=rows, znorm=znorm)[0][rows:2 * rows].median())
    ovf = torch.full((b,), 2, dtype=torch.int32, device=dev)
    for entries, tail in (
            ((fused_gather_lb_keogh_chunk, fused_gather_lb_keogh_chunk_long),
             (cut[:, None].contiguous(),)),
            ((fused_gather_lb_keogh_range, fused_gather_lb_keogh_range_long),
             (cut, ovf))):
        st = [torch.zeros((b, 6), dtype=torch.int32, device=dev)
              for _ in entries]
        a, z = (fn(*a0, *plan, *env, *tail, s_, i=1, chunk=rows, g=g,
                   znorm=znorm) for fn, s_ in zip(entries, st))
        torch.cuda.synchronize()
        for i in (0, 1, 2, 4, 6, 7):
            assert torch.equal(a[i], z[i])
        assert torch.equal(st[0], st[1])
        surv = torch.zeros_like(a[5], dtype=torch.bool)
        for q in range(b):
            n_q = int(a[4][q])
            assert torch.equal(a[3][q, :n_q].sort().values,
                               z[3][q, :n_q].sort().values)
            surv[q, a[3][q, :n_q].long()] = True
        # the DP's output: +inf at every non-survivor (the DP fills the
        # rest)
        assert torch.isinf(a[5][~surv]).all()
        assert torch.isinf(z[5][~surv]).all()


@pytest.mark.parametrize("s,n,lmin,lmax,seg", [
    (2, 14_100, 1_000, 14_000, 64), (3, 30_100, 29_000, 30_000, 16)])
def test_envelope_build_long_spans_bit_equal_to_plain(dev, s, n, lmin, lmax,
                                                      seg):
    """Builds whose staging passes the card's 227 KB: 13,001 lengths up to
    14,000 (59,108 floats at g = 49), and lmax 30,000; the build entry
    reads the prefix sums in place and gives the plain version's bits."""
    rng = np.random.default_rng(n + lmin)
    x = _t(np.cumsum(rng.normal(size=(s, n)), -1).astype(np.float32), dev)
    xc = x - x.mean(dim=-1, keepdim=True)
    csum, csum2 = _prefix(xc), _prefix(xc * xc)
    kw = dict(lmin=lmin, lmax=lmax, gamma=48, seg_len=seg)
    before = envelope_znorm.launches
    got = envelope_znorm(csum, csum2, **kw)
    torch.cuda.synchronize()
    assert envelope_znorm.launches == before + 1
    for k, c in zip(got, ref.envelope_znorm_ref(csum, csum2, **kw)):
        assert torch.equal(k, c)
        assert torch.isfinite(k).any()


@pytest.mark.parametrize("otile", [8, 16, 24])
@pytest.mark.parametrize("znorm", [False, True], ids=["raw", "znorm"])
def test_offset_tiled_ed_entries_equal_untiled(dev, otile, znorm):
    """The long-row ED entries with a row's 49 offsets forced into tiles
    of `otile` (a block each): the contract entry's d2 bit-equal to the
    untiled and staged entries', the k-NN chunk entry's pools (after the
    partials merge) and counters bit-equal to the plain step fed the
    staged d2 over three chunks, and the range entry's dense d2 and
    counters bit-equal to the staged range entry's."""
    import functools
    rng = np.random.default_rng(otile + znorm)
    args = _long_args(dev, rng, 256, 3, 24)
    tiled = fused_gather_ed_long(*args, g=49, rows=24, znorm=znorm,
                                 otile=otile)
    assert torch.equal(tiled, fused_gather_ed_long(*args, g=49, rows=24,
                                                   znorm=znorm))
    assert torch.equal(tiled, fused_gather_ed(*args, g=49, rows=24,
                                              znorm=znorm))
    _ed_chunk_walk(dev, 5, 256, znorm, chunk=40,
                   entry=functools.partial(fused_gather_ed_chunk_long,
                                           otile=otile),
                   counted=fused_gather_ed_chunk_long)
    b, g, rows = 8, 49, 64
    coll, sids, anchors, nm, qs = _ed_plan(rng, dev, b, 3 * rows, 256)
    a0 = (coll.data, coll.csum, coll.csum2, coll.csum_lo, coll.csum2_lo,
          coll.center)
    q = _t(qs, dev)
    d2_all = fused_gather_ed(*a0, sids.reshape(-1), anchors.reshape(-1), q,
                             g=g, rows=3 * rows, znorm=znorm).reshape(b, -1)
    lbs2 = _ed_bounds(rng, dev, d2_all.cpu().numpy(), 3 * rows)
    eps2 = d2_all.median(dim=1).values.contiguous()
    ovf = torch.full((b,), 3, dtype=torch.int32, device=dev)
    st = [torch.zeros((b, 6), dtype=torch.int32, device=dev)
          for _ in range(2)]
    for i in range(3):
        want = fused_gather_ed_range(*a0, sids, anchors, nm, lbs2, q, eps2,
                                     ovf, st[0], i=i, chunk=rows, g=g,
                                     znorm=znorm)
        got = fused_gather_ed_range_long(*a0, sids, anchors, nm, lbs2, q,
                                         eps2, ovf, st[1], i=i, chunk=rows,
                                         g=g, znorm=znorm, otile=otile)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert torch.equal(st[0], st[1])


@pytest.mark.parametrize("otile", [2, 16, 30])
@pytest.mark.parametrize("znorm", [False, True], ids=["raw", "znorm"])
def test_offset_tiled_lb_keogh_entries_equal_untiled(dev, otile, znorm):
    """The long-row LB_Keogh entries with a row's 49 offsets forced into
    tiles of `otile`: (lb2, mu, sd) of the contract entry, and the chunk
    entries' outputs and counters, k-NN and range, bit-equal to the
    untiled long entries' (the survivor lists as sets)."""
    rng = np.random.default_rng(otile + znorm + 7)
    g, rows, b = 49, 24, 3
    args = _long_args(dev, rng, 256, b, rows, dtw_r=25)
    for x, y in zip(fused_gather_lb_keogh_long(*args, g=g, rows=rows,
                                               znorm=znorm),
                    fused_gather_lb_keogh_long(*args, g=g, rows=rows,
                                               znorm=znorm, otile=otile)):
        assert torch.equal(x, y)
    a0, plan, env = _lb_plan(dev, rng, args, rows, b, g)
    cut = _t(np.full(b, np.inf, np.float32), dev)
    cut[0] = 0.0
    cut[1] = float(ref.fused_gather_lb_keogh_ref(
        *args, g=g, rows=rows, znorm=znorm)[0][rows:2 * rows].median())
    ovf = torch.full((b,), 2, dtype=torch.int32, device=dev)
    for entry, tail in ((fused_gather_lb_keogh_chunk_long,
                         (cut[:, None].contiguous(),)),
                        (fused_gather_lb_keogh_range_long, (cut, ovf))):
        st = [torch.zeros((b, 6), dtype=torch.int32, device=dev)
              for _ in range(2)]
        a = entry(*a0, *plan, *env, *tail, st[0], i=1, chunk=rows, g=g,
                  znorm=znorm)
        z = entry(*a0, *plan, *env, *tail, st[1], i=1, chunk=rows, g=g,
                  znorm=znorm, otile=otile)
        torch.cuda.synchronize()
        for i in (0, 1, 2, 4, 6, 7):
            assert torch.equal(a[i], z[i])
        assert torch.equal(st[0], st[1])
        surv = torch.zeros_like(a[5], dtype=torch.bool)
        for q in range(b):
            n_q = int(a[4][q])
            assert torch.equal(a[3][q, :n_q].sort().values,
                               z[3][q, :n_q].sort().values)
            surv[q, a[3][q, :n_q].long()] = True
        assert torch.isinf(a[5][~surv]).all()
        assert torch.isinf(z[5][~surv]).all()


@pytest.mark.parametrize("znorm", [False, True], ids=["raw", "znorm"])
def test_long_entries_past_one_block_g_match_plain(dev, znorm):
    """g = 20,480, past the g one block of a row takes (18,688 ED, 13,760
    LB_Keogh): the long-row entries split each row's offsets into tiles
    (`offset_tile`) and match their plain versions: the ED contract
    entry within rtol 1e-4 / atol 1e-3, its k-NN chunk entry and the
    partials merge bit-equal to the plain step over two chunks, its
    range entry bit-equal to the plain step fed the contract entry's d2;
    the LB_Keogh contract entry (lb2 within rtol 2e-4 / atol 2e-3, mu and
    sd bit-equal) and its chunk entries in both cuts (the chunk test's
    checks)."""
    from repro_torch.kernels.fused_verify import offset_tile, staged
    g, qlen, rows, b = 20_480, 128, 4, 3
    assert not staged("ed", qlen, g) and not staged("dtw", qlen, g)
    assert offset_tile("ed", qlen, g) < g and offset_tile("dtw", qlen, g) < g
    rng = np.random.default_rng(g + znorm)
    n = qlen + g + 300
    args = _long_args(dev, rng, qlen, b, rows, g=g, n=n)
    got = fused_gather_ed(*args, g=g, rows=rows, znorm=znorm)
    want = ref.fused_gather_ed_ref(*args, g=g, rows=rows, znorm=znorm)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4, atol=1e-3)
    _ed_chunk_walk(dev, 5, qlen, znorm, chunk=4, n_chunks=2,
                   counted=fused_gather_ed_chunk_long, g=g,
                   n=qlen + 4 * g, s=8)
    b8, n_pad = 8, 8
    coll, sids, anchors, nm, qs = _ed_plan(rng, dev, b8, n_pad, qlen, s=8,
                                           n=qlen + 4 * g, g=g)
    a0 = (coll.data, coll.csum, coll.csum2, coll.csum_lo, coll.csum2_lo,
          coll.center)
    q = _t(qs, dev)
    d2_all = fused_gather_ed(*a0, sids.reshape(-1), anchors.reshape(-1), q,
                             g=g, rows=n_pad, znorm=znorm).reshape(b8, -1)
    lbs2 = _ed_bounds(rng, dev, d2_all.cpu().numpy(), n_pad)
    eps2 = d2_all.median(dim=1).values.contiguous()
    ovf = torch.full((b8,), 2, dtype=torch.int32, device=dev)
    st = torch.zeros((b8, 6), dtype=torch.int32, device=dev)
    st_plain = st.clone()
    for i in range(2):
        cols = slice(i * 4, (i + 1) * 4)
        dist = fused_gather_ed(*a0, sids[:, cols].reshape(-1).contiguous(),
                               anchors[:, cols].reshape(-1).contiguous(), q,
                               g=g, rows=4, znorm=znorm)
        want = ref.fused_gather_ed_range_ref(
            *a0, sids, anchors, nm, lbs2, q, eps2, ovf, st_plain, i=i,
            chunk=4, g=g, znorm=znorm, dist=dist)
        before = fused_gather_ed_range_long.launches
        got = fused_gather_ed_range(*a0, sids, anchors, nm, lbs2, q, eps2,
                                    ovf, st, i=i, chunk=4, g=g, znorm=znorm)
        torch.cuda.synchronize()
        assert fused_gather_ed_range_long.launches == before + 1
        assert torch.equal(got, want) and torch.equal(st, st_plain)
    args = _long_args(dev, rng, qlen, b, rows, g=g, n=n, dtw_r=12)
    got = fused_gather_lb_keogh(*args, g=g, rows=rows, znorm=znorm)
    want = ref.fused_gather_lb_keogh_ref(*args, g=g, rows=rows, znorm=znorm)
    _close(got[0], want[0], 2e-4, 2e-3)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    _lb_chunk_check(dev, rng, args, rows, znorm,
                    counted=fused_gather_lb_keogh_chunk_long, b=b, g=g)
    _lb_chunk_check(dev, rng, args, rows, znorm,
                    counted=fused_gather_lb_keogh_range_long, b=b, g=g,
                    range_mode=True)


def test_engine_takes_gamma_past_one_block_on_the_card(dev):
    """Envelopes of 20,480 masters (past the g one block of a row takes:
    18,688 ED, 13,760 LB_Keogh) run on the device scan, ED and DTW, k-NN
    and range, through the offset-tiled long-row chunk entries: the
    answers equal a float64 brute force (ED) and the host backend
    (DTW); nothing is refused and the host backend is not used in the
    device scan's place."""
    from repro_torch.kernels.dtw_band import dtw_survivors as surv_entry
    rng = np.random.default_rng(20_480)
    data = np.cumsum(rng.normal(size=(4, 41_000)), -1).astype(np.float32)
    p = EnvelopeParams(lmin=128, lmax=256, seg_len=16, card=64,
                       gamma=20_479)
    gpu = UlisseEngine.from_collection(
        Collection.from_array(data, device=dev), p, num_levels=1,
        device=dev)
    q = data[2, 9_000:9_160] + rng.normal(size=160).astype(np.float32) * 0.05
    before = (fused_gather_ed_chunk_long.launches,
              fused_gather_lb_keogh_chunk_long.launches,
              fused_gather_ed_range_long.launches,
              fused_gather_lb_keogh_range_long.launches,
              surv_entry.launches)
    ed = gpu.search(q, QuerySpec(k=3))
    win = np.lib.stride_tricks.sliding_window_view(
        data.astype(np.float64), 160, axis=1)
    qn = (q - q.mean()) / q.std()
    mu, sd = win.mean(-1), win.std(-1)
    d2 = (((win - mu[..., None]) / np.maximum(sd, 1e-8)[..., None]
           - qn) ** 2).sum(-1)
    best = np.sort(d2.ravel())[:3]
    np.testing.assert_allclose(np.asarray(ed.dists) ** 2, best,
                               rtol=1e-3, atol=5e-3)
    dspec = dict(k=3, measure="dtw", r=16)
    dt = gpu.search(q, QuerySpec(**dspec))
    host = gpu.search(q, QuerySpec(scan_backend="host", **dspec))
    assert (list(dt.series), list(dt.offsets)) == \
        (list(host.series), list(host.offsets))
    np.testing.assert_allclose(dt.dists, host.dists, rtol=1e-4,
                               atol=1e-5)
    eps = float(ed.dists[-1]) * 1.5
    er = gpu.search(q, QuerySpec(eps=eps))
    # the float64 hit set, but for windows within 5e-3 of eps^2
    near = np.abs(d2 - eps * eps) <= 5e-3
    want = set(map(tuple, np.argwhere((d2 <= eps * eps) & ~near).tolist()))
    got = set(zip(er.series.tolist(), er.offsets.tolist()))
    assert want <= got <= want | set(map(tuple, np.argwhere(near).tolist()))
    drr = gpu.search(q, QuerySpec(eps=float(dt.dists[-1]), **dspec))
    drh = gpu.search(q, QuerySpec(eps=float(dt.dists[-1]),
                                  scan_backend="host", **dspec))
    assert sorted(zip(drr.series, drr.offsets)) == \
        sorted(zip(drh.series, drh.offsets))
    torch.cuda.synchronize()
    after = (fused_gather_ed_chunk_long.launches,
             fused_gather_lb_keogh_chunk_long.launches,
             fused_gather_ed_range_long.launches,
             fused_gather_lb_keogh_range_long.launches, surv_entry.launches)
    assert all(a > b for a, b in zip(after, before))


def _paged_inputs(dev, measure, seed, s=512, n=256, b=8, n_pad=1024, qlen=160):
    """A collection, its store, an LB-sorted plan over it and prepared
    queries, on the card (the bench parameters' g = 49)."""
    from repro_torch.core import planner
    from repro_torch.storage.store import PayloadStore
    rng = np.random.default_rng(seed)
    data = np.cumsum(rng.normal(size=(s, n)), -1).astype(np.float32)
    coll = Collection.from_array(data, device=dev)
    store = PayloadStore.from_arrays(data, page_rows=16,
                                     cache_limit_bytes=8 * 16 * 1285 * 4,
                                     device=dev)
    g = 49
    sids = rng.integers(0, s, (b, n_pad)).astype(np.int32)
    anc = rng.integers(0, n - qlen + 1, (b, n_pad)).astype(np.int32)
    nm = rng.integers(0, g + 1, (b, n_pad)).astype(np.int32)
    lbs2 = np.sort(rng.random((b, n_pad)).astype(np.float32) * 30, axis=1)
    lbs2[:, n_pad - 100:] = np.inf
    q = np.stack([data[i, 40:40 + qlen] + rng.normal(size=qlen).astype(
        np.float32) * 0.1 for i in range(b)])
    qs, dlo, dhi, _, _ = planner.prepare_query_batch(
        torch.from_numpy(q).to(dev), 16, True, measure, 16 if measure ==
        "dtw" else 0)
    plan = tuple(_t(x, dev) for x in (sids, anc, nm, lbs2))
    return coll, store, plan, qs, dlo, dhi, g


@pytest.mark.parametrize("measure", ["ed", "dtw"])
def test_paged_scans_on_cuda_equal_resident(dev, measure):
    """The paged scans on the card (slabs through pinned memory and a side
    stream, the slab ids mapped back to global ones, `i_code` / `no_ovf`
    on the range steps) against the resident scans on the card: pools,
    hit buffers, counts, overflow chunks and counters bit for bit; 64
    back-to-back chunks with no early stop reuse each pinned slot 32
    times."""
    from repro_torch.core import executor
    coll, store, plan, qs, dlo, dhi, g = _paged_inputs(dev, measure, 3)
    b, k = qs.shape[0], 5
    seed = (torch.full((b, k), float("inf"), device=dev),
            torch.full((b, k), -1, dtype=torch.int32, device=dev),
            torch.full((b, k), -1, dtype=torch.int32, device=dev))
    kw = dict(k=k, g=g, measure=measure, r=16, znorm=True, chunk_size=16)
    want = executor.device_exact_scan(coll, *plan, qs, dlo, dhi, *seed, **kw)
    got = executor.paged_exact_scan(store, *plan, qs, dlo, dhi, *seed, **kw)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    # every chunk active: a zero bound everywhere and no pool to prune
    zero = (plan[0], plan[1], plan[2], torch.zeros_like(plan[3]))
    executor.PAGED["chunks"] = 0
    want = executor.device_exact_scan(coll, *zero, qs, dlo, dhi, *seed, **kw)
    got = executor.paged_exact_scan(store, *zero, qs, dlo, dhi, *seed, **kw)
    assert executor.PAGED["chunks"] == 64
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert store.stats()["evicted_bytes"] > 0
    eps2 = torch.full((b,), 200.0, device=dev)
    for cap in (2048, 16):
        rkw = dict(capacity=cap, g=g, measure=measure, r=16, znorm=True,
                   chunk_size=16)
        want = executor.device_range_scan(coll, *plan, qs, dlo, dhi, eps2,
                                          **rkw)
        got = executor.paged_range_scan(store, *plan, qs, dlo, dhi, eps2,
                                        **rkw)
        assert got[6] == want[6]
        for x, y in zip(got[:6], want[:6]):
            assert torch.equal(x, y)
    assert (got[4] < 64).any(), "the small buffer overflows"


@pytest.mark.parametrize("znorm", [False, True], ids=["raw", "znorm"])
def test_paged_engine_on_cuda_equals_resident(dev, znorm, tmp_path):
    """A saved index opened on the card twice, resident and under a budget
    of a quarter of its payload: the same answers and SearchStats on
    every path (k-NN ED/DTW, approx, range with an overflow)."""
    rng = np.random.default_rng(9)
    data = np.cumsum(rng.normal(size=(300, 256)), -1).astype(np.float32)
    p = EnvelopeParams(lmin=160, lmax=256, seg_len=16, gamma=48, card=256,
                       znorm=znorm)
    UlisseEngine.from_collection(Collection.from_array(data, device=dev), p,
                                 device=dev).save(str(tmp_path / "idx"))
    from repro_torch.storage import open_index
    budget = open_index(str(tmp_path / "idx"),
                        device=dev).collection.payload_bytes // 4
    res = UlisseEngine.open(str(tmp_path / "idx"), device=dev)
    pag = UlisseEngine.open(str(tmp_path / "idx"), device=dev,
                            memory_budget_bytes=budget)
    qs = [data[i, o:o + qlen] + rng.normal(size=qlen).astype(np.float32)
          * 0.1 for i, o, qlen in ((3, 30, 160), (50, 90, 160),
                                   (120, 50, 200), (7, 0, 256))]
    for spec in (QuerySpec(k=5), QuerySpec(k=5, measure="dtw", r=16),
                 QuerySpec(k=5, mode="approx"), QuerySpec(eps=6.0),
                 QuerySpec(eps=8.0, measure="dtw", r=16,
                           range_capacity=16)):
        for a, b in zip(res.search(qs, spec), pag.search(qs, spec)):
            np.testing.assert_array_equal(a.dists, b.dists)
            np.testing.assert_array_equal(a.series, b.series)
            np.testing.assert_array_equal(a.offsets, b.offsets)
            assert a.stats == b.stats
    assert not pag.index.collection.is_materialized
    assert pag.page_cache_stats()["misses"] > 0



@pytest.mark.parametrize("n", [256, 1000, 2048])
def test_build_prefixes_independent_of_block_on_cuda(dev, n):
    """The card build's prefix sums of a series (Z-normalized and raw) are
    the same bits whatever block it is built in: blocks of 1 to 70,000
    series against one block of 140,000 (torch's row scans would pick
    another thread layout at each of these counts)."""
    from repro_torch.core.envelope import centered_prefixes, series_prefix
    rng = np.random.default_rng(n)
    x = torch.from_numpy(np.cumsum(rng.normal(size=(140_000, n)), -1)
                         .astype(np.float32)).to(dev)
    whole = centered_prefixes(x) + (series_prefix(x),)
    for b in (1, 2, 7, 16, 50, 700, 70_000):
        part = x[13:13 + b]
        for got, want in zip(centered_prefixes(part) + (series_prefix(part),),
                             whole):
            assert torch.equal(got, want[13:13 + b]), b


def test_append_compact_on_cuda_equals_build(dev):
    """append (the delta's envelopes from envelope_znorm, one launch a
    part of 50, 1 and 49 series) -> compact on the card equals build_index
    on the card over the whole collection (one launch over every series)
    in every field and level — each series' envelopes are the same
    whatever block it is built in; the appended series answer their own
    windows before and after compaction."""
    rng = np.random.default_rng(4)
    data = np.cumsum(rng.normal(size=(700, 256)), -1).astype(np.float32)
    p = EnvelopeParams(lmin=160, lmax=256, seg_len=16, gamma=48, card=256,
                       znorm=True)
    eng = UlisseEngine.from_collection(
        Collection.from_array(data[:600], device=dev), p, device=dev)
    eng.append(data[600:650])
    eng.append(data[650])                 # one series
    eng.append(data[651:])
    assert eng.delta_size == 100 * p.num_envelopes(256)
    q = data[660, 20:200] + rng.normal(size=180).astype(np.float32) * 0.05
    before = eng.search(q, QuerySpec(k=3))
    assert int(before.series[0]) == 660
    eng.compact()
    want = build_index(Collection.from_array(data, device=dev), p,
                       eng.index.breakpoints)
    for f in ("paa_lo", "paa_hi", "sym_lo", "sym_hi", "series_id", "anchor",
              "n_master", "valid"):
        assert torch.equal(getattr(eng.index.envelopes, f),
                           getattr(want.envelopes, f)), f
    for la, lb in zip(eng.index.levels, want.levels):
        for f in ("paa_lo", "paa_hi", "valid"):
            assert torch.equal(getattr(la, f), getattr(lb, f)), f
    after = eng.search(q, QuerySpec(k=3))
    np.testing.assert_array_equal(after.series, before.series)
    np.testing.assert_array_equal(after.dists, before.dists)


# -- the serving tier on the card ---------------------------------------------

def _serve_engine(dev, seed=20):
    from repro_torch.train.data import series_batches
    data = series_batches(64, 256, seed=seed)
    p = EnvelopeParams(lmin=160, lmax=256, seg_len=16, card=256, gamma=48,
                       znorm=True)
    return data, UlisseEngine.from_collection(
        Collection.from_array(data, device=dev), p, device=dev)


@pytest.mark.parametrize("measure", ["ed", "dtw"])
def test_server_on_cuda_answers_bursts_bit_equal_to_serial(dev, measure):
    """Four client threads send 16 requests of lengths 160, 208 and 256
    (one bucket) to a server over a CUDA engine: every answer is bit-equal
    to a serial engine.search of the same query, none fails, and the
    dispatcher thread launched the path's chunk entry and merge."""
    from repro_torch.serve import ServeConfig, UlisseServer
    data, eng = _serve_engine(dev)
    spec = (QuerySpec(k=5) if measure == "ed"
            else QuerySpec(k=5, measure="dtw", r=25))
    rng = np.random.default_rng(21)
    qs = []
    for i in range(16):
        qlen = (160, 208, 256)[i % 3]
        s, o = int(rng.integers(0, 64)), int(rng.integers(0, 257 - qlen))
        qs.append(data[s, o:o + qlen]
                  + rng.normal(size=qlen).astype(np.float32) * 0.1)
    server = UlisseServer(eng, spec, ServeConfig(window_ms=2.0,
                                                 max_batch=8))
    server.warmup([160, 208, 256])
    counted = ((fused_gather_ed_chunk, pool_merge_partials)
               if measure == "ed" else
               (fused_gather_lb_keogh_chunk, dtw_survivors, pool_merge))
    before = [w.launches for w in counted]
    out = [None] * len(qs)

    def client(c):
        for i in range(c, len(qs), 4):
            out[i] = server.search(qs[i], timeout=300)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    server.close()
    torch.cuda.synchronize()
    assert all(w.launches > b for w, b in zip(counted, before))
    total = server.metrics.snapshot()["total"]
    assert total["completed"] == len(qs) and total["failed"] == 0
    for q, res in zip(qs, out):
        want = eng.search(q, spec)
        np.testing.assert_array_equal(res.dists, want.dists)
        np.testing.assert_array_equal(res.series, want.series)
        np.testing.assert_array_equal(res.offsets, want.offsets)


def test_failing_dispatch_on_cuda_surfaces_through_ticket(dev):
    """A dispatch the card refuses (g = 14,500 past the LB_Keogh chunk
    entries, as in the refusal test above) fails its ticket with the
    engine's ValueError, is counted as failed, and the dispatcher keeps
    serving: the next request is dispatched and fails the same way."""
    from repro_torch.serve import ServeConfig, UlisseServer
    rng = np.random.default_rng(14_500)
    data = np.cumsum(rng.normal(size=(2, 14_700)), -1).astype(np.float32)
    p = EnvelopeParams(lmin=64, lmax=128, seg_len=16, card=64,
                       gamma=14_499)
    gpu = UlisseEngine.from_collection(
        Collection.from_array(data, device=dev), p, block_size=2,
        num_levels=1, device=dev)
    q = data[1, 30:130] + rng.normal(size=100).astype(np.float32) * 0.05
    server = UlisseServer(gpu, QuerySpec(k=2, measure="dtw", r=5),
                          ServeConfig(window_ms=0.0, max_batch=4))
    for _ in range(2):
        with pytest.raises(ValueError, match="gamma=14499"):
            server.submit(q).result(timeout=300)
    server.close()
    total = server.metrics.snapshot()["total"]
    assert total["failed"] == 2 and total["completed"] == 0


def test_server_over_paged_engine_on_cuda_equals_resident(dev, tmp_path):
    """The dispatcher thread drives the paged scans (pinned slabs copied on
    a side stream by the prefetch worker, the compute on the dispatcher's
    stream): four client threads' ED k-NN and range answers equal the
    resident engine's bit for bit, with SearchStats."""
    from repro_torch.serve import ServeConfig, UlisseServer
    rng = np.random.default_rng(23)
    data = np.cumsum(rng.normal(size=(300, 256)), -1).astype(np.float32)
    p = EnvelopeParams(lmin=160, lmax=256, seg_len=16, gamma=48, card=256,
                       znorm=True)
    UlisseEngine.from_collection(Collection.from_array(data, device=dev), p,
                                 device=dev).save(str(tmp_path / "idx"))
    from repro_torch.storage import open_index
    budget = open_index(str(tmp_path / "idx"),
                        device=dev).collection.payload_bytes // 4
    res = UlisseEngine.open(str(tmp_path / "idx"), device=dev)
    pag = UlisseEngine.open(str(tmp_path / "idx"), device=dev,
                            memory_budget_bytes=budget)
    qs = [data[i, o:o + qlen] + rng.normal(size=qlen).astype(np.float32)
          * 0.1 for i, o, qlen in ((3, 30, 160), (50, 40, 208),
                                   (120, 0, 256), (7, 0, 160),
                                   (200, 10, 208), (299, 0, 256))]
    for spec in (QuerySpec(k=5), QuerySpec(eps=6.0)):
        server = UlisseServer(pag, spec, ServeConfig(window_ms=2.0,
                                                     max_batch=8))
        out = [None] * len(qs)

        def client(c):
            for i in range(c, len(qs), 4):
                out[i] = server.search(qs[i], timeout=300)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
        server.close()
        for q, got in zip(qs, out):
            want = res.search(q, spec)
            np.testing.assert_array_equal(got.dists, want.dists)
            np.testing.assert_array_equal(got.series, want.series)
            np.testing.assert_array_equal(got.offsets, want.offsets)
            assert got.stats == want.stats
    assert not pag.index.collection.is_materialized
    assert pag.page_cache_stats()["misses"] > 0


def test_warmup_on_cuda_leaves_nothing_to_build_or_load(dev):
    """After server.warmup() every kernel library is loaded, and the first
    served request builds and loads none."""
    from repro_torch.kernels import _build
    from repro_torch.serve import ServeConfig, UlisseServer
    data, eng = _serve_engine(dev, seed=22)
    server = UlisseServer(eng, QuerySpec(k=5),
                          ServeConfig(window_ms=0.0, max_batch=8))
    assert server.warmup([200]) == 4              # fills 1, 2, 4, 8
    assert set(_build._LIBS) == set(_build.SIGNATURES)
    before = dict(_build.COUNTS)
    res = server.search(data[3, 10:210].copy(), timeout=300)
    server.close()
    assert _build.COUNTS == before
    assert (res.series[0], res.offsets[0]) == (3, 10)


# -- the sharded scan's mesh-wide k-th, and the distributed engine --------

@pytest.mark.parametrize("k", [5, 64])
@pytest.mark.parametrize("long", [False, True], ids=["staged", "long"])
def test_fused_gather_ed_chunk_with_gkth_equals_plain_step(dev, k, long):
    """The ED chunk entries with the sharded scan's gkth: active, keep and
    pruned cut at min(pool k-th, gkth), the pre-select at the pool's own
    k-th; pools and counters bit-equal to the plain step's; query 4
    (gkth 0) never active."""
    entry = fused_gather_ed_chunk_long if long else fused_gather_ed_chunk
    _, st = _ed_chunk_walk(dev, k, 256, True, chunk=100, entry=entry,
                           counted=entry, n=456 if long else 256, gkth=True)
    assert int(st[4].abs().sum()) == 0 and int(st[2:4, 5].sum()) > 0


@pytest.mark.parametrize("znorm", [False, True], ids=["raw", "znorm"])
def test_fused_gather_lb_keogh_chunk_with_gkth_matches_plain(dev, znorm):
    """The LB chunk entries (staged at qlen 256, the long-row variant at
    19,305) with the sharded scan's gkth against their plain versions:
    the chunk test's checks at the effective cut min(cut, gkth)."""
    rng = np.random.default_rng(21 + znorm)
    _lb_chunk_check(dev, rng, _chunk_args(dev, rng, 512, 256, 25), 512,
                    znorm, gkth=True)
    _lb_chunk_check(dev, rng, _long_args(dev, rng, 19_305, 3, 8, dtw_r=193),
                    8, znorm, counted=fused_gather_lb_keogh_chunk_long, b=3,
                    gkth=True)


@pytest.mark.parametrize("world,backend", [(1, "nccl"), (2, "gloo")])
def test_distributed_engine_on_cuda_equals_local(dev, world, backend):
    """`UlisseEngine.distributed` on the card (each rank's default device,
    cuda:0): a world of 1 over NCCL and of 2 over gloo (host copies)
    answer as the local CUDA engine does — ED and DTW k-NN the same (sid,
    off) in the same order, ED within 1e-9, DTW rtol 1e-4; range the same
    hit sets — and the sharded steps launched the gkth chunk entries."""
    import torch_worlds
    rng = np.random.default_rng(31)
    data = np.cumsum(rng.normal(size=(64, 256)), -1).astype(np.float32)
    params = dict(lmin=160, lmax=256, seg_len=16, gamma=48, card=256,
                  znorm=True)
    qs = [data[s, o:o + 200] + rng.normal(size=200).astype(np.float32) * .1
          for s, o in ((3, 10), (40, 50), (17, 0))]
    p = EnvelopeParams(**params)
    local = UlisseEngine.from_collection(Collection.from_array(data, dev), p,
                                         device=dev)
    bp = local.index.breakpoints.cpu().numpy()
    # eps halfway between the 20th and 21st neighbours: no window on the
    # boundary, where the host continuation's rounding may differ
    d = local.search(qs[0], QuerySpec(k=21)).dists
    eps = float(d[19] + d[20]) / 2
    specs = {"ed": dict(k=5), "dtw": dict(k=5, measure="dtw", r=20),
             "range": dict(eps=eps), "range-16": dict(eps=eps,
                                                      range_capacity=16)}
    cases = {name: ("e", qs, spec) for name, spec in specs.items()}
    out = torch_worlds.run_world(world, torch_worlds.engine_matrix_job,
                                 {"e": (data, params, bp, 4)}, cases, None,
                                 backend=backend, timeout=300)
    arrays, _, launches = out[0]
    assert launches["fused_gather_ed_chunk"] > 0
    assert launches["fused_gather_lb_keogh_chunk"] > 0
    for name, spec in specs.items():
        want = local.search(qs, QuerySpec(**spec))
        for j, b in enumerate(want):
            key = f"{world}/{name}/{j}/"
            got = {f: arrays[key + f] for f in ("dists", "series",
                                                "offsets")}
            if name.startswith("range"):
                assert set(zip(got["series"], got["offsets"])) == \
                    set(zip(b.series, b.offsets))
                continue
            np.testing.assert_array_equal(got["series"], b.series)
            np.testing.assert_array_equal(got["offsets"], b.offsets)
            np.testing.assert_allclose(got["dists"], b.dists,
                                       rtol=1e-4 if name == "dtw" else 0,
                                       atol=0 if name == "dtw" else 1e-9)


@pytest.mark.parametrize("measure", ["ed", "dtw"])
def test_chunk_step_with_gkth_gmap_and_delta_heads(dev, measure):
    """The sharded scan's delta family on the card: one rank's [main;
    delta] block (48 main series, rows 48-95 of the collection; 16
    appended ones with global ids 1,000 + 3j), its envelope set packed
    delta-first with pinned chunk heads (`device_shard_pack`, n_delta >
    0), every chunk through `executor._scan_chunk_step` with the rank's
    gmap and a mesh-wide k-th (`gkth`; +inf for query 0).  ED: pools
    (global ids) and counters bit-equal after every chunk to the plain
    step (the plain chunk entry fed the contract entry's distances, the
    ids mapped through the same gmap, the stable-sort merge).  DTW: the
    same walk on the CPU (the plain versions): counters, ids and offsets
    equal, d2 rtol 1e-4.  Every query visits the pinned delta chunks."""
    from repro_torch.core import executor, planner
    rng = np.random.default_rng(41)
    p = EnvelopeParams(lmin=160, lmax=256, seg_len=16, gamma=48, card=256,
                       znorm=True)
    main = np.cumsum(rng.normal(size=(48, 256)), -1).astype(np.float32)
    delta = np.cumsum(rng.normal(size=(16, 256)), -1).astype(np.float32)
    rows = np.concatenate([main, delta])
    c = Collection.from_array(rows, device=dev)
    env = build_envelope_set(c, p, isax.gaussian_breakpoints(p.card, dev))
    d_rows = 16 * p.num_envelopes(256)
    gmap = _t(np.concatenate([np.arange(48, 96), 1000 + 3 * np.arange(16),
                              [-1]]).astype(np.int32), dev)
    qs = np.stack([rows[s, o:o + 200] + rng.normal(size=200).astype(
        np.float32) * .1 for s, o in zip(rng.integers(0, 64, 8),
                                         rng.integers(0, 57, 8))])
    r = 20 if measure == "dtw" else 0
    qn, dlo, dhi, qb, qh = planner.prepare_query_batch(
        _t(qs, dev), p.seg_len, p.znorm, measure, r)
    lbs = planner.env_lower_bounds_batch(
        qb, qh, env, isax.gaussian_breakpoints(p.card, dev), p.seg_len,
        p.query_segments(200), False)
    n_pad, chunk, nd_pad = executor.shard_pack_geometry(env.size, d_rows, 64)
    plan = planner.device_shard_pack(env.series_id, env.anchor,
                                     env.n_master, lbs, n_pad=n_pad,
                                     n_delta=d_rows, chunk=chunk)
    assert nd_pad > 0 and float(plan[3][:, 0].max()) == 0.0  # pinned head
    # gkth: each query's lower quartile of its positive main-row bounds
    lb = plan[3][:, nd_pad:].cpu().numpy()
    gk_np = np.array([np.quantile(x[np.isfinite(x) & (x > 0)], 0.25)
                      for x in lb], np.float32)
    gk_np[0] = np.inf
    gk = _t(gk_np, dev)
    k, g, b = 5, p.gamma + 1, len(qs)
    a0 = (c.data, c.csum, c.csum2, c.csum_lo, c.csum2_lo, c.center)

    def empty(d):
        return [torch.full((b, k), float("inf"), device=d),
                torch.full((b, k), -1, dtype=torch.int32, device=d),
                torch.full((b, k), -1, dtype=torch.int32, device=d)]

    pool, st = empty(dev), torch.zeros((b, 6), dtype=torch.int32,
                                       device=dev)
    if measure == "ed":
        plain = empty(dev)
        st_plain = st.clone()
    else:
        cpu = torch.device("cpu")
        plain, st_plain = empty(cpu), st.cpu()
        c_cpu = Collection(**{f: getattr(c, f).cpu() for f in (
            "data", "csum", "csum2", "center", "csum_lo", "csum2_lo")})
        args_cpu = [x.cpu() for x in (*plan, qn, dlo, dhi)]
    for i in range(n_pad // chunk):
        executor._scan_chunk_step(c, *plan, qn, dlo, dhi, i, pool, st, k=k,
                                  g=g, chunk=chunk, znorm=p.znorm,
                                  measure=measure, r=r, gmap=gmap, gkth=gk)
        if measure == "dtw":
            executor._scan_chunk_step(c_cpu, *args_cpu, i, plain, st_plain,
                                      k=k, g=g, chunk=chunk, znorm=p.znorm,
                                      measure=measure, r=r, gmap=gmap.cpu(),
                                      gkth=gk.cpu())
            continue
        cols = slice(i * chunk, (i + 1) * chunk)
        dist = fused_gather_ed(*a0, plan[0][:, cols].reshape(-1).contiguous(),
                               plan[1][:, cols].reshape(-1).contiguous(), qn,
                               g=g, rows=chunk, znorm=p.znorm)
        part = ref.fused_gather_ed_chunk_ref(
            *a0, *plan, qn, plain[0], st_plain, i=i, chunk=chunk, g=g,
            znorm=p.znorm, dist=dist, gkth=gk)
        part[1] = gmap[part[1].long()]
        for t, v in zip(plain, ref.pool_merge_partials_ref(plain, part)):
            t.copy_(v)
        torch.cuda.synchronize()
        for x, y in zip(pool, plain):
            assert torch.equal(x, y), f"step {i}: pools differ"
        assert torch.equal(st, st_plain), f"step {i}: counters differ"
    if measure == "dtw":
        assert torch.equal(st.cpu(), st_plain)
        for x, y in zip(pool[1:], plain[1:]):
            assert torch.equal(x.cpu(), y)
        torch.testing.assert_close(pool[0].cpu(), plain[0], rtol=1e-4,
                                   atol=0)
    sid = pool[1].cpu().numpy()
    assert set(sid[sid >= 0].tolist()) <= set(gmap.cpu().numpy().tolist())
    assert bool((st[:, 0] >= nd_pad // chunk).all())
    assert int(st[1:, 5].sum()) > 0                # the gkth cut prunes


# -- slice 14: the long-query DTW path's kernels, redesigned --------------

def _survivor_counts(dev, rng, qlen, counts, m, s=6, n=None):
    """A chunk's DP inputs whose queries list exactly `counts` survivors
    (in a shuffled order; offsets past both ends of the series, clipped)."""
    b = len(counts)
    n = n or qlen + 40
    data = _t(np.cumsum(rng.normal(size=(s, n)), -1).astype(np.float32), dev)
    slist = np.zeros((b, m), np.int32)
    surv = np.zeros((b, m), bool)
    for i, k in enumerate(counts):
        pos = rng.permutation(m)[:k]
        slist[i, :k] = pos
        surv[i, pos] = True
    d2 = np.where(surv, np.nan, np.inf).astype(np.float32)
    return (data, _t(rng.normal(size=(b, qlen)).astype(np.float32), dev),
            _t(slist, dev), _t(np.array(counts, np.int32), dev),
            _t(rng.integers(0, s, (b, m)).astype(np.int32), dev),
            _t(rng.integers(-5, n - qlen + 6, (b, m)).astype(np.int32), dev),
            _t(rng.normal(size=(b, m)).astype(np.float32), dev),
            _t((rng.random((b, m)) + 0.5).astype(np.float32), dev)), d2


@pytest.mark.parametrize("l,r,n,m", [
    (600, 600, 8, 16),          # a full band: the strip kernel
    (600, 512, 8, 16),          # W = 1,025 + 1: 3 warps of 8 pairs
    (1_100, 1_099, 3, 8),       # a full band past 1,024 rows: 5 warps
    (20_000, 200, 3, 4),        # W = 401 at l past 6,144: one warp
    (29_100, 3, 2, 3),          # q and w past 227 KB, streamed
    (16_000, 16_000, 2, 3)])    # past 7,680 slots: the block kernel and
                                # its global scratch (buffer past 227 KB)
def test_dtw_wide_entries_bit_equal_to_plain(dev, l, r, n, m):
    """The wide DP entries against the plain wavefront on the card, bit
    for bit, through each of their kernels (`wide_plan`): `dtw_band_wide`
    and `dtw_survivors_wide` (z-normalized windows; survivor lists
    empty, of one, and of every candidate), positions off the list left
    as they were."""
    from repro_torch.kernels.dtw_band import wide_plan
    assert (wide_plan(l, r)[1] == 0) == (l == 16_000)
    rng = np.random.default_rng(l + r)
    q = _t(rng.normal(size=l).astype(np.float32), dev)
    c = _t(rng.normal(size=(n, l)).astype(np.float32), dev)
    before = dtw_band_wide.launches
    got = dtw_band_wide(q, c, r)
    torch.cuda.synchronize()
    assert dtw_band_wide.launches == before + 1
    assert torch.equal(got, ref.dtw_band_ref(q, c, r))
    args, d2 = _survivor_counts(dev, rng, l, (0, 1, m), m)
    before = dtw_survivors_wide.launches
    got = dtw_survivors_wide(*args, _t(d2, dev), r=r, znorm=True)
    torch.cuda.synchronize()
    assert dtw_survivors_wide.launches == before + 1
    want = ref.dtw_survivors_ref(*args, _t(d2, dev), r=r, znorm=True)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(), want.nan_to_num())
    assert int((~got.isnan() & torch.isfinite(got)).sum()) == 1 + m


@pytest.mark.parametrize("rows", [128, 37])
@pytest.mark.parametrize("otile", [None, 16])
@pytest.mark.parametrize("znorm", [False, True], ids=["raw", "znorm"])
def test_long_lb_entries_bit_equal_to_staged(dev, rows, otile, znorm):
    """The long-row LB_Keogh entries at qlen 4,000 (both kernels take it)
    on a plan whose queries keep no row (inactive), some rows (a finite
    cut, every seventh bound 1e30) and every row: the contract entry's
    (lb2, mu, sd) and the k-NN and range entries' outputs and counters
    bit-equal to the staged entries' (the survivor lists as sets), at the
    default block and a forced one of 16 windows; and against the plain
    versions: mu, sd, each candidate's (sid, off) and the counters but
    the survivors exactly, lb2 within the LB tolerance."""
    rng = np.random.default_rng(rows + (otile or 0) + znorm)
    g, b, qlen = 49, 3, 4_000
    kw = {} if otile is None else {"otile": otile}
    args = _long_args(dev, rng, qlen, b, rows, dtw_r=400)
    for x, y in zip(fused_gather_lb_keogh(*args, g=g, rows=rows, znorm=znorm),
                    fused_gather_lb_keogh_long(*args, g=g, rows=rows,
                                               znorm=znorm, **kw)):
        assert torch.equal(x, y)
    a0, plan, env = _lb_plan(dev, rng, args, rows, b, g)
    plan[3][2] = 0.0                    # query 2: every row kept
    cut = _t(np.full(b, np.inf, np.float32), dev)
    cut[0] = 0.0                        # query 0: inactive (k-NN)
    # query 1: active, its rows with a bound of 1e30 pruned, and the
    # windows with lb2 up to its median + 1 survivors
    cut[1] = float(ref.fused_gather_lb_keogh_ref(
        *args, g=g, rows=rows, znorm=znorm)[0][rows:2 * rows].median()) + 1
    ovf = torch.full((b,), 2, dtype=torch.int32, device=dev)
    ovf[0] = 0                          # query 0: inactive (range)
    for staged_e, long_e, plain_e, tail in (
            (fused_gather_lb_keogh_chunk, fused_gather_lb_keogh_chunk_long,
             ref.fused_gather_lb_keogh_chunk_ref,
             (cut[:, None].contiguous(),)),
            (fused_gather_lb_keogh_range, fused_gather_lb_keogh_range_long,
             ref.fused_gather_lb_keogh_range_ref, (cut, ovf))):
        st = [torch.zeros((b, 6), dtype=torch.int32, device=dev)
              for _ in range(3)]
        before = long_e.launches
        a = staged_e(*a0, *plan, *env, *tail, st[0], i=1, chunk=rows, g=g,
                     znorm=znorm)
        z = long_e(*a0, *plan, *env, *tail, st[1], i=1, chunk=rows, g=g,
                   znorm=znorm, **kw)
        p = plain_e(*a0, *plan, *env, *tail, st[2], i=1, chunk=rows, g=g,
                    znorm=znorm)
        torch.cuda.synchronize()
        assert long_e.launches == before + 1
        for i in (0, 1, 2, 4, 6, 7):
            assert torch.equal(a[i], z[i])
        assert torch.equal(st[0], st[1])
        surv = torch.zeros_like(a[5], dtype=torch.bool)
        for q in range(b):
            n_q = int(a[4][q])
            assert torch.equal(a[3][q, :n_q].sort().values,
                               z[3][q, :n_q].sort().values)
            surv[q, a[3][q, :n_q].long()] = True
        assert torch.isinf(z[5][~surv]).all()
        assert int(z[4][0]) == 0 and int(st[1][0, 1]) == 0
        assert int(st[1][2, 1]) == rows and int(st[1][2, 5]) == 0
        assert 0 < int(st[1][1, 1]) < rows
        _close(z[0], p[0], 2e-4, 2e-3)
        for i in (1, 2, 6, 7):
            assert torch.equal(z[i], p[i])
        cols = [0, 1, 3, 5]
        assert torch.equal(st[1][:, cols], st[2][:, cols])
