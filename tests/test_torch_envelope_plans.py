"""The index build's host-side choices, as pure functions: the plan of the
`envelope_znorm` build (`envelope.envelope_plan`: the one-pass kernel up
to 32 segments (two passes of 16), else the slab kernel with its lengths
a tile and warps a block), an emulation of the slab kernel's work split
(every valid (master, l', segment) cell visited once, no invalid one),
the rule that the wrapper handed a tensor off the CPU launches with that
plan or raises, never falling back to the plain version (meta tensors
stand in for device tensors; the library is faked, so nothing is built
or launched), and the plain build against the JAX build past 16
segments."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import envelope as ev  # noqa: E402
from repro_torch.core.envelope import _prefix  # noqa: E402

SMEM = 227 * 1024

# (n, lmin, lmax, gamma, seg_len) of the paths' builds
BENCH = (256, 160, 256, 48, 16)            # [3], [13], [17]'s appends
LONG_DTW = (1_024, 512, 1_024, 48, 32)     # [14]
LONG_QUERY = (32_768, 20_000, 30_000, 48, 16)  # [15]
LARGE_G = (40_960, 128, 256, 20_479, 16)   # [21]


@pytest.mark.parametrize("shape,want", [
    (BENCH, (0, 0, 4)),                  # [3]/[13], [17]'s and [18]'s appends
    (LARGE_G, (0, 0, 4)),
    (LONG_DTW, (0, 0, 4)),
    (LONG_QUERY, (1, 512, 4)),
    ((30_100, 29_000, 30_000, 48, 16), (1, 512, 4)),
    ((1_024, 512, 1_024, 48, 21), (1, 288, 3)),
    ((14_100, 1_000, 14_000, 48, 450), (0, 0, 4))])
def test_envelope_plan_at_the_paths_shapes(shape, want):
    """Up to 32 segments ([3]/[13], [17]'s and [18]'s appends, [21]'s
    20,480 masters unstaged, [14]'s 32 in two passes, 31 segments past
    the staging) the one-pass kernel; [15]'s 1,875 segments (235 slabs:
    2 groups of 128 slots in 4 warps, one phase) tiles of 512 of its
    10,001 lengths, as for 1,001 lengths; 48 segments (6 slabs) 3 warps
    of 16 phases."""
    assert ev.envelope_plan(*shape) == want
    assert ev.check_plan(want, *shape) == want


@pytest.mark.parametrize("gamma", [None, 0, 255, 4_095])
@pytest.mark.parametrize("shape", [
    BENCH, LONG_DTW, LONG_QUERY, LARGE_G, (600, 520, 544, 8, 16),
    (14_100, 1_000, 14_000, 48, 64), (30_100, 29_000, 30_000, 48, 16),
    (300, 272, 272, 5, 16), (256, 160, 256, 48, 160), (258, 160, 256, 0, 16),
    (200_000, 1_000, 150_000, 48, 2), (70, 64, 64, 0, 16),
    (14_100, 1_000, 14_000, 48, 450), (13_100, 12_000, 13_000, 48, 450)])
def test_envelope_plan_is_one_the_kernels_take(shape, gamma):
    """At the shape's gamma and others, every plan is one a kernel takes:
    the one-pass kernel wherever w <= 32 (staged or not: its shared
    memory is its own); a slab plan fits 227 KB, its slots cover w over
    its groups, its phases use at most the block's threads, a warp past
    32 slots holds one phase, and its tile is a multiple of 32 lengths
    of at most 512 (the fewest tiles of the range)."""
    if gamma is not None:
        shape = (*shape[:3], gamma, shape[4])
    n, lmin, lmax, gamma, seg = shape
    kind, tile, warps = ev.check_plan(ev.envelope_plan(*shape), *shape)
    w = lmax // seg
    assert kind == (0 if w <= 32 else 1)
    if kind == 0:
        assert (tile, warps) == (0, 4)
        return
    assert 1 <= warps <= 4
    assert ev._slab_smem(tile, warps) <= SMEM
    nslab, nph, groups = ev.slab_shape(w, warps)
    assert nslab * nph <= 32 * warps and nslab * groups * 8 >= w
    assert nslab <= 32 or nslab % 32 == 0
    assert (nslab * (groups - 1)) * 8 < w
    n_len = lmax - lmin + 1
    assert tile % 32 == 0 and tile <= 512
    assert -(-n_len // tile) == -(-n_len // 512)


@pytest.mark.parametrize("plan", [
    (0, 512, 4), (0, 0, 8),         # the one-pass kernel's own shape only
    (1, 6_000, 4),                  # 240,000 bytes of tiles
    (1, 512, 9),                    # 288 threads
    (1, 0, 4), (2, 512, 4), (-1, 0, 4)])
def test_check_plan_refuses_what_no_kernel_takes(plan):
    """Refused: any shape of the one-pass kernel but (0, 0, 4), tiles
    past 227 KB, more than 8 warps, an empty tile, an unknown kernel.
    The one-pass kernel takes any w (in passes of 16 segments: two up to
    32, which the plan picks; more only by a forced plan)."""
    with pytest.raises(ValueError, match="no kernel takes"):
        ev.check_plan(plan, *LONG_QUERY)
    assert ev.check_plan((0, 0, 4), *LONG_QUERY) == (0, 0, 4)


def _steps_to(x, d):
    return (x + d - 1) // d if x > 0 else 0


def _emulate(shape, plan, envelopes, masters=None):
    """The cells the slab kernel folds into an output (lo, hi), as
    csrc/envelope.cu `envelope_slab_kernel` and `slab_sweep` split them:
    visits[e][j] counts each (t, z) of master j of envelope e (lengths
    l' = lmin + t).  Only active lanes' slots below w count (the others
    are never written out)."""
    n, lmin, lmax, gamma, seg = shape
    _, tile, warps = plan
    zt = 8
    g, w, n_len = gamma + 1, lmax // seg, lmax - lmin + 1
    nslab, nph, groups = ev.slab_shape(w, warps)
    threads = 32 * warps
    big = np.iinfo(np.int32).max
    out = {}
    for e in envelopes:
        a = e * g
        c_first = min(n_len, n - a - lmin + 1)
        visits = {j: np.zeros((n_len, w), np.int8) for j in range(g)
                  if masters is None or j in masters}
        for y in range(groups):
            tid = np.arange(threads)
            slab, ph_raw = tid % nslab, tid // nslab
            zbase = (y * nslab + slab) * zt
            active = (ph_raw < nph) & (zbase < w)
            ph = np.where(active, ph_raw, 0)
            l_any = (zbase + 1) * seg
            l_full = np.minimum(zbase + zt, w) * seg
            for t0 in range(0, c_first, tile):
                for j in range(g):
                    cj = min(n_len, n - a - j - lmin + 1)
                    if cj <= t0:
                        break
                    if j not in visits:
                        continue
                    tn = min(tile, cj - t0)
                    steps = np.array([_steps_to(tn - p, nph) if act else 0
                                      for p, act in zip(ph, active)])
                    k_any = np.array([
                        _steps_to(la - lmin - t0 - p, nph) if act else big
                        for p, la, act in zip(ph, l_any, active)])
                    k_full = np.array([
                        _steps_to(lf - lmin - t0 - p, nph) if act else 0
                        for p, lf, act in zip(ph, l_full, active)])
                    for wp in range(warps):
                        ln = slice(32 * wp, 32 * wp + 32)
                        k_a = int(k_any[ln].min())
                        k_t = int(steps[ln].max())
                        k_f = max(int(k_full[ln].max()), k_a)
                        k_e = max(int(np.where(active[ln], steps[ln],
                                               big).min()), k_f)
                        for lane in range(32 * wp, 32 * wp + 32):
                            if not active[lane]:
                                continue
                            zb, p = int(zbase[lane]), int(ph[lane])
                            zs = slice(zb, min(zb + zt, w))
                            v = visits[j]
                            # unmasked steps: every slot below w
                            if k_e > k_f:
                                i0, i1 = p + k_f * nph, p + k_e * nph
                                v[t0 + i0:t0 + i1:nph, zs] += 1
                            for k0, k1 in ((k_a, min(k_f, k_t)),
                                           (max(k_e, k_f), k_t)):
                                if k1 <= k0:
                                    continue
                                i = p + nph * np.arange(k0, k1)
                                i = i[i < tn]
                                zc = np.clip((lmin + t0 + i) // seg - zb, 0,
                                             zt)
                                q = np.arange(zs.stop - zb)
                                hit = q[None, :] < zc[:, None]
                                v[t0 + i, zs] += hit.astype(np.int8)
        out[e] = visits
    return out


def _valid(shape, e, j):
    n, lmin, lmax, gamma, seg = shape
    n_len, w = lmax - lmin + 1, lmax // seg
    cj = min(n_len, n - e * (gamma + 1) - j - lmin + 1)
    t = np.arange(n_len)[:, None]
    z = np.arange(w)[None, :]
    return (t < cj) & (z < (lmin + t) // seg)


@pytest.mark.parametrize("shape,plan", [
    ((600, 520, 544, 8, 16), (1, 32, 4)),         # w 34: 5 slabs, 25 phases
    ((600, 520, 544, 8, 16), (1, 64, 1)),         # 5 slabs, 6 phases
    ((300, 200, 272, 5, 16), (1, 32, 4)),         # w 17
    ((400, 320, 320, 3, 8), (1, 32, 2)),          # w 40, one length
    ((400, 300, 320, 3, 8), (1, 32, 4)),          # w 40
    ((256, 160, 256, 48, 16), (1, 96, 4)),        # w 16 forced
    ((256, 160, 256, 48, 160), (1, 32, 1)),       # seg_len = lmin
    ((256, 160, 256, 0, 16), (1, 32, 4)),         # gamma 0
    ((258, 160, 256, 48, 16), (1, 64, 4)),        # last envelope: 1 master
    ((1_024, 512, 1_024, 48, 32), (1, 288, 4)),   # [14]
    ((700, 300, 550, 40, 1), (1, 96, 1)),         # 550 segments, 3 groups
    ((700, 300, 550, 40, 1), (1, 96, 4))])        # 69 slabs in 96 slots
def test_slab_split_visits_every_valid_cell_once(shape, plan):
    """At small shapes (every master of the first, the last and two
    middle envelopes) the emulated split folds each valid (master, l',
    segment) cell into its segment's bounds exactly once and no invalid
    cell: across tiles (a tile boundary inside a master's lengths and
    inside a segment count), slabs whose segments become valid inside a
    tile, phases past the tile's end, the last slab's slots past w, idle
    threads and segment groups."""
    n, lmin, lmax, gamma, seg = shape
    n_env = -(-(n - lmin + 1) // (gamma + 1))
    envs = sorted({0, n_env // 3, 2 * n_env // 3, n_env - 1})
    got = _emulate(shape, ev.check_plan(plan, *shape), envs)
    for e, visits in got.items():
        for j, v in visits.items():
            np.testing.assert_array_equal(v, _valid(shape, e, j))


def test_slab_split_at_the_long_query_lengths():
    """[15]'s plan on a few masters of the first, a middle and the last
    envelope of a series (10,001 lengths, 1,875 segments: 118 slabs of
    16, tiles of 512): every valid cell once, no invalid one."""
    plan = ev.envelope_plan(*LONG_QUERY)
    got = _emulate(LONG_QUERY, plan, (0, 130, 260), masters=(0, 17, 48))
    for e, visits in got.items():
        for j, v in visits.items():
            np.testing.assert_array_equal(v, _valid(LONG_QUERY, e, j))
    assert got[260][0].sum() == _valid(LONG_QUERY, 260, 0).sum() > 0


class _FakeLib:
    """A kernel library whose build entry refuses its launch (a nonzero
    CUDA error), or, with `ok`, accepts it (0) without running."""

    def __init__(self, ok=False):
        self.calls = []
        self.ok = ok

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0 if self.ok else 1
        return entry


def _fake(monkeypatch, ok=False):
    lib = _FakeLib(ok)
    monkeypatch.setattr(ev.envelope_znorm, "launches",
                        ev.envelope_znorm.launches)
    monkeypatch.setattr(_build, "library", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    return lib


def _sums(s, n, device="meta"):
    return (torch.zeros((s, n + 1), device=device),
            torch.zeros((s, n + 1), device=device))


def _kw(shape):
    _, lmin, lmax, gamma, seg = shape
    return dict(lmin=lmin, lmax=lmax, gamma=gamma, seg_len=seg)


@pytest.mark.parametrize("shape,s,plan", [
    (BENCH, 64, None), (LONG_DTW, 128, None), (LONG_QUERY, 32, None),
    (LONG_QUERY, 2, (1, 256, 8)), (BENCH, 5, (1, 96, 2))])
def test_envelope_wrapper_raises_rather_than_falls_back(monkeypatch, shape,
                                                        s, plan):
    """Off the CPU the build passes its plan (`envelope_plan`'s, or the
    forced one) as the three arguments before the stream and raises on a refused launch, counting nothing; an accepted
    launch counts one and returns (S, n_env, w) bounds."""
    n = shape[0]
    lib = _fake(monkeypatch)
    before = ev.envelope_znorm.launches
    with pytest.raises(RuntimeError, match="envelope_znorm"):
        ev.envelope_znorm(*_sums(s, n), plan=plan, **_kw(shape))
    assert ev.envelope_znorm.launches == before
    (name, args), = lib.calls
    assert name == "ulisse_envelope_znorm"
    want = plan or ev.envelope_plan(*shape)
    assert tuple(args[-4:-1]) == want and args[4] == s
    lib.ok = True
    lo, hi = ev.envelope_znorm(*_sums(s, n), plan=plan, **_kw(shape))
    assert ev.envelope_znorm.launches == before + 1
    n_env = -(-(n - shape[1] + 1) // (shape[3] + 1))
    assert lo.shape == hi.shape == (s, n_env, shape[2] // shape[4])


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_envelope_wrapper_refuses_a_plan_no_kernel_takes(monkeypatch,
                                                         device):
    """A forced plan no kernel takes raises ValueError before any
    library call, on the CPU as well (where a plan a kernel takes is
    checked and the plain version runs)."""
    lib = _fake(monkeypatch, ok=True)
    with pytest.raises(ValueError, match="no kernel takes"):
        ev.envelope_znorm(*_sums(2, 32_768, device), plan=(0, 0, 8),
                          **_kw(LONG_QUERY))
    with pytest.raises(ValueError, match="no kernel takes"):
        ev.envelope_znorm(*_sums(2, 256, device), plan=(1, 8_192, 8),
                          **_kw(BENCH))
    assert lib.calls == []


@pytest.mark.parametrize("n,lmin,lmax,gamma,seg", [
    (300, 200, 272, 5, 16),         # w 17
    (600, 520, 544, 8, 16),         # w 34
    (400, 300, 320, 3, 8)])         # w 40
def test_plain_build_past_16_segments_matches_reference(n, lmin, lmax, gamma,
                                                        seg):
    """The plain build (the CPU's path, and the card kernels' oracle)
    against the JAX build past 16 segments: rtol 1e-5 / atol 1e-5 and
    the same unconstrained (+-inf) segments; a forced slab plan on the
    CPU gives the same values."""
    rng = np.random.default_rng(n + lmin + seg)
    data = np.cumsum(rng.normal(size=(3, n)), -1).astype(np.float32)
    x = torch.from_numpy(data)
    xc = x - x.mean(dim=-1, keepdim=True)
    sums = (_prefix(xc), _prefix(xc * xc))
    kw = dict(lmin=lmin, lmax=lmax, gamma=gamma, seg_len=seg)
    lo, hi = ev.envelope_znorm(*sums, **kw)
    w_lo, w_hi = jref.envelope_znorm_ref(jnp.asarray(data), lmin, lmax,
                                         gamma, seg)
    for got, want in ((lo, w_lo), (hi, w_hi)):
        want = np.asarray(want)
        assert got.shape == want.shape and got.shape[-1] == lmax // seg > 16
        np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(want))
        assert np.isinf(want).any() and np.isfinite(want).any()
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    forced = ev.envelope_znorm(*sums, plan=(1, 32, 4), **kw)
    assert torch.equal(forced[0], lo) and torch.equal(forced[1], hi)
