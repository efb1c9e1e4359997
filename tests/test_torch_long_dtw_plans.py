"""The host-side choices of the long-query DTW path's kernels, as pure
functions: the DP wrappers' dispatch between the warp and wide entries
(`dtw_band._warp_entry`), the wide entries' split of a band over warps
(`dtw_band.wide_plan`: C slot pairs a lane, S warps a candidate), and
the long-row LB_Keogh entries' block and tile (`fused_verify.
lb_long_shape`: windows a block from the SM count, points a tile from
the shared memory).  And the rule that a wrapper handed a tensor off the
CPU launches its kernel or raises, never falling back to the plain
version (meta tensors stand in for device tensors; the library is
faked, so nothing is built or launched)."""
import types

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import dtw_band as dtw_mod  # noqa: E402
from repro_torch.kernels import fused_verify as fv  # noqa: E402

# the band's slots in the wide entries' numbering (slot 0 off the band
# when rr is odd), the lanes a warp owns when split, the most warps a
# block takes at C pairs a lane: csrc/dtw_band.cu
SEG_LANES = 30
MAX_WARPS = {1: 32, 2: 32, 4: 32, 8: 16, 16: 8}


def _slots(l, r):
    rr = min(r, l - 1)
    return (rr & 1) + 2 * rr + 1


@pytest.mark.parametrize("l,r,warp", [
    (256, 25, True), (6144, 511, True), (700, 511, True),
    (6145, 20, False), (7000, 20, False), (700, 512, False),
    (600, 600, False), (20_000, 200, False), (1, 1, True)])
def test_dp_wrappers_send_the_warp_entries_what_fits_them(l, r, warp):
    """The warp entries take a band of at most 1,024 slots and l up to
    6,144; every other shape goes to the wide entries."""
    assert dtw_mod._warp_entry(l, r) is warp


@pytest.mark.parametrize("l,r,plan", [
    (600, 600, (20, -1)), (1_024, 5_000, (32, -1)), (100, 99, (4, -1)),
    (600, 512, (8, 3)), (20_000, 200, (8, 1)), (7_000, 20, (1, 1)),
    (8_192, 819, (16, 2)), (1_536, 1_535, (8, 7)), (29_100, 3, (1, 1)),
    (700, 511, (8, 3)), (1_025, 1_024, (8, 5)), (4_000, 3_839, (16, 8)),
    (4_000, 3_840, (0, 0)), (16_000, 16_000, (0, 0)), (2, 1, (4, -1))])
def test_wide_plan_at_the_paths_shapes(l, r, plan):
    """[13]/[14]'s full band (qlen 600, r 600) takes the strip kernel at
    20 rows a lane (up to 1,024 rows); a band short of full splits over
    warps (600 / 512: 3 warps of 8 pairs a lane, the corners skipped);
    [15]'s 401 slots at qlen 20,000 fit one warp of 8 pairs; past 7,680
    slots the block kernel takes the band ((0, 0))."""
    assert dtw_mod.wide_plan(l, r) == plan


@pytest.mark.parametrize("l", [2, 33, 600, 1_000, 6_145, 20_000])
@pytest.mark.parametrize("frac", [0.01, 0.1, 0.5, 1.0, 2.0])
def test_wide_plan_covers_the_band_within_a_block(l, frac):
    """Every plan holds every band slot (one warp: 64C slots; split: 60C
    owned a warp, each warp owning one), within the block's most warps;
    a band of at most 7,680 slots always gets one."""
    r = max(1, int(frac * l))
    c, s = dtw_mod.wide_plan(l, r)
    slots = _slots(l, r)
    if s == -1:                          # the strip kernel: a full band
        assert r >= l - 1 and c % 4 == 0 and 32 * c >= l > 32 * (c - 4)
        return
    if s == 0:
        assert slots > 2 * SEG_LANES * 16 * MAX_WARPS[16]
        return
    assert c in MAX_WARPS and 1 <= s <= MAX_WARPS[c]
    if s == 1:
        assert 64 * c >= slots
    else:
        own = 2 * SEG_LANES * c
        assert own * s >= slots > own * (s - 1)
        assert c >= 2


def test_wide_plan_skips_the_bands_corners():
    """Past 1,024 rows a full band splits over warps, and the owned slots
    of the outer warps hold no cell of the series for part of the
    diagonals: fewer live periods than periods, and the centre warp is
    live throughout."""
    l, r = 1_500, 1_499
    c, s = dtw_mod.wide_plan(l, r)
    assert s > 2
    own = 2 * SEG_LANES * c
    live = [dtw_mod._live_periods(l, min(r, l - 1), c, own * w,
                                  own * (w + 1) - 1) for w in range(s)]
    periods = -(-l // c)
    assert live[s // 2] == periods
    assert live[0] < periods and live[-1] < periods
    assert sum(live) < 0.75 * s * periods


@pytest.mark.parametrize("batch,rows,g,sms,shape", [
    (8, 128, 49, 132, (64, 800)),           # [15]'s chunk
    (8, 8, 20_480, 132, (256, 928)),        # [21]'s offsets
    (8, 512, 49, 132, (256, 416)),
    (3, 24, 49, 132, (32, 992)),
    (3, 24, 49, 132, None)])
def test_lb_long_shape_fills_the_card(batch, rows, g, sms, shape):
    """A block takes the most windows (256, 128, 64, else 32) that still
    leave 4 blocks an SM, and the longest tile (a multiple of 32 up to
    1,024 points) within 32 KB of shared memory."""
    items, ptile = fv.lb_long_shape(batch, rows, g, sms)
    if shape is not None:
        assert (items, ptile) == shape
    total = batch * rows * g
    assert items in fv._LB_ITEMS
    assert items == fv._LB_ITEMS[-1] or -(-total // items) >= 4 * sms
    assert ptile % 32 == 0 and 32 <= ptile <= 1024
    assert fv._lb_smem(g, items, ptile) <= fv._LB_SMEM_PLAN
    if ptile < 1024:
        assert fv._lb_smem(g, items, ptile + 32) > fv._LB_SMEM_PLAN


def test_lb_long_shape_takes_smaller_blocks_on_a_bigger_card():
    """The windows a block takes fall as the SM count grows, so that a
    chunk of few windows still spreads over the card."""
    items = [fv.lb_long_shape(8, 128, 49, sms)[0]
             for sms in (8, 32, 100, 132, 400)]
    assert items == sorted(items, reverse=True)
    assert items[0] == 256 and items[-1] == 32


@pytest.mark.parametrize("force", [1, 2, 16, 30, 1024])
def test_lb_long_shape_honours_a_forced_block(force):
    """`otile` forces the windows a block takes (the card tests hold
    such blocks against the default ones); past 1,024, or past a block's
    shared memory, it raises."""
    items, ptile = fv.lb_long_shape(3, 24, 49, 132, force)
    assert items == force
    assert fv._lb_smem(49, items, ptile) <= 227 * 1024
    with pytest.raises(ValueError):
        fv.lb_long_shape(3, 24, 49, 132, 1025)
    with pytest.raises(ValueError):
        fv.lb_long_shape(3, 24, 1, 132, 1024)


def test_offset_tile_of_the_lb_entries_is_a_blocks_windows():
    """The LB_Keogh long-row entries take consecutive windows: the most
    offsets of a row a block takes is min(g, its windows)."""
    assert fv.offset_tile("dtw", 256, 49) == 49
    assert fv.offset_tile("dtw", 256, 20_480) == fv._LB_ITEMS[0]
    assert fv.offset_tile("dtw", 256, 49, 16) == 16


class _FakeLib:
    """A kernel library whose every entry refuses its launch (a nonzero
    CUDA error, as the card gives for a shape it cannot take)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            # the block kernel's scratch query: its buffer fits shared
            # memory (no scratch); every launch: refused
            return 0 if name == "ulisse_dtw_wide_scratch" else 1
        return entry


@pytest.fixture
def fake_lib(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(_build, "library", lambda name: lib)
    monkeypatch.setattr(fv, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    return lib


def _meta(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device="meta")


def _survivor_meta(b, m, s, n, qlen):
    i32 = torch.int32
    return (_meta(s, n), _meta(b, qlen), _meta(b, m, dtype=i32),
            _meta(b, dtype=i32), _meta(b, m, dtype=i32),
            _meta(b, m, dtype=i32), _meta(b, m), _meta(b, m), _meta(b, m))


@pytest.mark.parametrize("l,r", [(600, 600), (600, 512), (20_000, 200)])
def test_dp_wrappers_raise_rather_than_fall_back(fake_lib, l, r):
    """Off the CPU a shape past the warp entries goes to the wide entry,
    with the plan's (C, S); a refused launch raises and counts nothing:
    there is no plain fallback."""
    before = (dtw_mod.dtw_band.launches, dtw_mod.dtw_band_wide.launches,
              dtw_mod.dtw_survivors.launches,
              dtw_mod.dtw_survivors_wide.launches)
    with pytest.raises(RuntimeError, match="dtw_band_wide"):
        dtw_mod.dtw_band(_meta(l), _meta(5, l), r)
    with pytest.raises(RuntimeError, match="dtw_survivors_wide"):
        dtw_mod.dtw_survivors(*_survivor_meta(2, 8, 3, l + 10, l), r=r,
                              znorm=True)
    after = (dtw_mod.dtw_band.launches, dtw_mod.dtw_band_wide.launches,
             dtw_mod.dtw_survivors.launches,
             dtw_mod.dtw_survivors_wide.launches)
    assert after == before
    names = [name for name, _ in fake_lib.calls]
    assert names == ["ulisse_dtw_band_wide", "ulisse_dtw_survivors_wide"]
    plan = dtw_mod.wide_plan(l, r)
    for _, args in fake_lib.calls:
        assert tuple(args[-3:-1]) == plan


def test_dp_wrappers_pass_the_block_kernels_scratch_past_the_split(fake_lib):
    """A band past 7,680 slots runs the block kernel (S = 0) with the
    scratch its buffer needs (here none: the fake library says it fits
    shared memory)."""
    with pytest.raises(RuntimeError, match="dtw_band_wide"):
        dtw_mod.dtw_band_wide(_meta(16_000), _meta(2, 16_000), 16_000)
    name, args = fake_lib.calls[-1]
    assert name == "ulisse_dtw_band_wide"
    assert args[3] is None and args[4] == 0 and tuple(args[-3:-1]) == (0, 0)


def test_long_lb_wrappers_raise_rather_than_fall_back(fake_lib):
    """The long-row LB_Keogh entries pass their (items, ptile) and raise
    on a refused launch, counting nothing."""
    data, sums, center = _meta(4, 64), _meta(4, 65), _meta(4)
    i32 = torch.int32
    plan = _meta(2, 16, dtype=i32)
    q = _meta(2, 40)
    stats = _meta(2, 6, dtype=i32)
    before = (fv.fused_gather_lb_keogh_long.launches,
              fv.fused_gather_lb_keogh_chunk_long.launches,
              fv.fused_gather_lb_keogh_range_long.launches)
    with pytest.raises(RuntimeError):
        fv.fused_gather_lb_keogh_long(data, sums, sums, sums, sums, center,
                                      _meta(16, dtype=i32),
                                      _meta(16, dtype=i32), q, q, g=5,
                                      rows=8, znorm=True, otile=16)
    with pytest.raises(RuntimeError):
        fv.fused_gather_lb_keogh_chunk_long(
            data, sums, sums, sums, sums, center, plan, plan, plan,
            _meta(2, 16), q, q, _meta(2, 3), stats, i=1, chunk=8, g=5,
            znorm=True)
    with pytest.raises(RuntimeError):
        fv.fused_gather_lb_keogh_range_long(
            data, sums, sums, sums, sums, center, plan, plan, plan,
            _meta(2, 16), q, q, _meta(2), _meta(2, dtype=i32), stats, i=1,
            chunk=8, g=5, znorm=True)
    assert (fv.fused_gather_lb_keogh_long.launches,
            fv.fused_gather_lb_keogh_chunk_long.launches,
            fv.fused_gather_lb_keogh_range_long.launches) == before
    shapes = [tuple(args[-3:-1]) for _, args in fake_lib.calls]
    assert shapes[0] == (16, fv.lb_long_shape(2, 8, 5, 132, 16)[1])
    assert shapes[1] == shapes[2] == fv.lb_long_shape(2, 8, 5, 132)
