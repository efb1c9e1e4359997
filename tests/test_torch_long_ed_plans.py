"""The host-side choices of the long-query ED path's kernels, as pure
functions: the long-row ED entries' block (`fused_verify.ed_long_shape`:
rows a block and offsets a block from the batch, the rows, g and the SM
count, points a tile from the shared memory; `offset_tile`, the region
rows' stride) and the mindist kernels' plan (`mindist.mindist_plan`:
the vector or the tile kernel, queries a thread, envelopes a block,
segments a tile).  And the rule that a wrapper handed a tensor off the
CPU launches its kernel with that plan or raises, never falling back to
the plain version (meta tensors stand in for device tensors; the
library is faked, so nothing is built or launched)."""
import types

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import fused_verify as fv  # noqa: E402
from repro_torch.kernels import mindist as md  # noqa: E402

SMS = 132                      # an H100's SMs


def _items(batch, rows, g, otile):
    """Threads of a long-row ED call: one a (row, group of 4 offsets of
    an offset tile, the first group starting up to 3 offsets early)."""
    n_ot, last = divmod(g, otile)
    per_row = n_ot * fv._ed_groups(otile) + (fv._ed_groups(last) if last
                                             else 0)
    return batch * rows * per_row


def _blocks(batch, rows, g, shape):
    tile, otile, _ = shape
    return batch * -(-rows // tile) * -(-g // otile)


def _warps(batch, rows, g, shape):
    tile, otile, _ = shape
    return _blocks(batch, rows, g, shape) * -(-(tile * fv._ed_groups(otile))
                                               // 32)


@pytest.mark.parametrize("batch,rows,g,qlen,shape", [
    (8, 128, 49, 29_000, (4, 49, 2_048)),        # [15]'s timing shape
    (8, 8, 20_480, 256, (1, 976, 256)),          # [21]'s offsets
    (8, 16, 20_480, 128, (1, 976, 128)),
    (3, 24, 49, 256, (1, 49, 256)),
    (8, 512, 49, 256, (16, 49, 256)),
    (1, 1, 49, 40_000, (1, 49, 2_048))])
def test_ed_long_shape_fills_the_card(batch, rows, g, qlen, shape):
    """A block takes the most rows (a power of two up to 32 and up to
    `rows`) whose threads, one a row and 4 offsets, fit 256, halved while
    the blocks would not cover the SMs; at [15]'s shape that puts a warp
    on every scheduler the work can fill (416 warps of work on 528), at
    [21]'s 21 offset tiles of 976 a row give 1,344 blocks of 8 warps."""
    got = fv.ed_long_shape(batch, rows, g, qlen, SMS)
    assert got == shape
    tile, otile, ptile = got
    work_warps = -(-_items(batch, rows, g, otile) // 32)
    assert _warps(batch, rows, g, got) >= min(4 * SMS, work_warps)
    if tile > 1:
        assert _blocks(batch, rows, g, got) >= SMS
    assert tile * fv._ed_groups(otile) <= fv._ED_MAX_THREADS
    assert ptile % 8 == 0 and ptile <= min(2_048, -(-qlen // 8) * 8)
    assert fv._ed_smem(*got) <= fv._ED_SMEM_PLAN


def test_ed_long_shape_at_15_takes_four_offsets_a_thread():
    """[15]'s shape: 50,176 in-order dot chains of 29,000 points.  At 4
    offsets a thread (13 groups cover a row's 49 offsets from any of the
    4 starts) they are 13,312 threads: 416 warps of work, under one a
    scheduler (528), so each warp runs alone on its scheduler and the
    call takes one warp's chain; the block shape puts them on every SM
    (256 blocks of 2 warps)."""
    tile, otile, ptile = fv.ed_long_shape(8, 128, 49, 29_000, SMS)
    assert (tile, otile) == (4, 49)
    assert _items(8, 128, 49, otile) == 13_312
    assert _blocks(8, 128, 49, (tile, otile, ptile)) == 256
    assert _warps(8, 128, 49, (tile, otile, ptile)) <= 4 * SMS


def test_ed_long_shape_takes_smaller_blocks_on_a_bigger_card():
    """The rows a block takes fall as the SM count grows, so that a
    chunk of few rows still spreads over the card."""
    tiles = [fv.ed_long_shape(8, 128, 49, 29_000, sms)[0]
             for sms in (8, 64, 132, 400, 1_000)]
    assert tiles == sorted(tiles, reverse=True)
    assert tiles[0] == 16 and tiles[-1] == 1


@pytest.mark.parametrize("g,want", [(49, 49), (1_020, 1_020), (1_024, 512),
                                    (1_025, 516), (1_500, 752),
                                    (20_480, 976), (18_689, 984)])
def test_offset_tile_of_the_ed_entries(g, want):
    """Past 1,020 offsets a row's offsets split into the fewest balanced
    tiles of at most 1,020, each a multiple of 4 (the offsets a thread
    takes); a forced tile is taken as it is (up to g)."""
    t = fv.offset_tile("ed", 256, g)
    assert t == want
    assert t <= fv._ED_MAX_OTILE and (t == g or t % 4 == 0)
    assert -(-g // t) == -(-g // fv._ED_MAX_OTILE)
    assert fv.offset_tile("ed", 256, g, 16) == min(16, g)
    assert fv.offset_tile("ed", 256, g, 5_000) == min(5_000, g)


@pytest.mark.parametrize("force,block", [(8, None), (16, (32, 64)),
                                         (24, (2, 1_024)), (None, (1, 8))])
def test_ed_long_shape_honours_a_forced_shape(force, block):
    """`otile` (the offsets a block takes) and `block` (rows a block,
    points a tile) are taken as given where a block takes them."""
    tile, ptile = block or (0, 0)
    got = fv.ed_long_shape(3, 24, 49, 4_000, SMS, force or 0, tile, ptile)
    assert got[1] == (force or 49)
    if block is not None:
        assert (got[0], got[2]) == block


@pytest.mark.parametrize("force,block", [(1_028, None), (None, (32, 64)),
                                         (None, (33, 64)), (8, (1, 12)),
                                         (8, (1, 60_000))])
def test_ed_long_shape_raises_where_no_block_takes_it(force, block):
    """More than 1,020 offsets a block (258 threads a row), more threads
    than 256, more than 32 rows, points a tile not a multiple of 8, or a
    block past the card's 227 KB of shared memory: refused."""
    tile, ptile = block or (0, 0)
    with pytest.raises(ValueError):
        fv.ed_long_shape(3, 24, 1_500, 4_000, SMS, force or 0, tile, ptile)


@pytest.mark.parametrize("otile", [1, 5, 49, 100, 752, 1_020])
@pytest.mark.parametrize("ptile", [8, 256, 1_024])
def test_ed_region_rows_read_in_distinct_banks(otile, ptile):
    """The region rows' stride holds what a row's threads read (ngrp 4 +
    ptile + 8 words) in 16-byte words s4 = ngrp (mod 8): the 8 threads
    of any quarter warp (consecutive flat items le ngrp + grp) read 8
    distinct 16-byte bank groups at every step, also across a row's
    end."""
    ngrp = fv._ed_groups(otile)
    stride = fv._ed_stride(ngrp, ptile)
    assert stride % 4 == 0 and stride >= ngrp * 4 + ptile + 8
    s4 = stride // 4
    for base in range(0, 8 * ngrp, 3):
        words = {((f // ngrp) * s4 + f % ngrp) % 8
                 for f in range(base, base + 8)}
        assert len(words) == 8


def test_mindist_plan_at_the_paths_shapes():
    """[15]'s long phase: the symbol entry over 8,448 envelopes at 1,812
    segments takes 2 queries a thread and 64 envelopes a block (132
    blocks of 8 warps, tiles of 64 segments); the PAA entry over 528
    block unions one query a thread and 4 envelopes a block (132 blocks,
    tiles of 64); at nseg 16 over rows of 16 both entries the vector
    kernel (the exact scan's symbols, a batch's 31,296 block unions and
    the 2,002,944 envelopes' PAA bounds)."""
    assert md.mindist_plan(True, 8, 8_448, 1_875, 1_812, SMS) == \
        (0, 2, 64, 64)
    assert md.mindist_plan(False, 8, 528, 1_875, 1_812, SMS) == \
        (0, 1, 4, 64)
    assert md.mindist_plan(True, 8, 2_002_944, 16, 16, SMS) == (1, 0, 0, 0)
    assert md.mindist_plan(True, 8, 2_002_944, 16, 16, SMS,
                           aligned=False)[0] == 0
    assert md.mindist_plan(False, 8, 31_296, 16, 16, SMS) == (1, 0, 0, 0)
    assert md.mindist_plan(False, 8, 2_002_944, 16, 16, SMS) == \
        (1, 0, 0, 0)


@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("batch", [1, 3, 8])
@pytest.mark.parametrize("n", [1, 528, 8_448, 31_296, 2_002_944])
@pytest.mark.parametrize("nseg", [10, 16, 1_812, 6_000])
def test_mindist_plan_is_one_the_kernels_take(sym, batch, n, nseg):
    """Every plan is one the kernels take (csrc/mindist.cu `launch`):
    the vector kernel only at nseg <= 16 over rows of a multiple of 4
    segments; else qb in (1, 2, 4, 8) at most the batch rounded up to a
    power of two, te a power of two with te bp / qb <= 256 threads, st a
    power of two from 4 to 64 covering nseg where it can within the
    plan's shared memory; the most queries a thread that leaves every SM
    4 warps, and the blocks covering the SMs unless a block is one
    envelope."""
    w = max(16, -(-nseg // 4) * 4)
    vec, qb, te, st = md.mindist_plan(sym, batch, n, w, nseg, SMS)
    if vec:
        assert nseg <= 16 and w % 4 == 0
        return
    bp = 1 << (batch - 1).bit_length()
    assert qb in (1, 2, 4, 8) and qb <= bp
    assert te >= 1 and te & (te - 1) == 0 and te * bp // qb <= 256
    assert st & (st - 1) == 0 and 4 <= st <= 64
    assert md._tile_smem(te, st, bp, nseg) <= md._SMEM_PLAN
    assert st >= min(nseg, 64) or md._tile_smem(te, 2 * st, bp, nseg) > \
        md._SMEM_PLAN
    if qb > 1:
        assert n * (bp // qb) >= 8 * 32 * SMS
    if qb < bp:
        assert n * (bp // (2 * qb)) < 8 * 32 * SMS
    assert te == 1 or -(-n // te) >= SMS


class _FakeLib:
    """A kernel library whose every entry refuses its launch (a nonzero
    CUDA error, as the card gives for a shape it cannot take), or, with
    `ok`, accepts it (0) without running anything."""

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
    # an accepted fake launch counts: keep other tests' counters as they
    # were
    for w in (fv.fused_gather_ed_long, fv.fused_gather_ed_chunk_long,
              fv.fused_gather_ed_range_long, md.mindist_sym, md.mindist_paa):
        monkeypatch.setattr(w, "launches", w.launches)
    monkeypatch.setattr(_build, "library", lambda name: lib)
    monkeypatch.setattr(fv, "_sm_count", lambda dev: SMS)
    monkeypatch.setattr(md, "_sm_count", lambda dev: SMS)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    return lib


@pytest.fixture
def fake_lib(monkeypatch):
    return _fake(monkeypatch)


def _meta(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device="meta")


def _ed_inputs(b, chunk, n_chunks=2, qlen=40, s=4, n=400):
    i32 = torch.int32
    head = (_meta(s, n), _meta(s, n + 1), _meta(s, n + 1), _meta(s, n + 1),
            _meta(s, n + 1), _meta(s))
    plan = _meta(b, chunk * n_chunks, dtype=i32)
    return head, plan, _meta(b, chunk * n_chunks), _meta(b, qlen)


def _ed_calls(b, chunk, g, k=5, **kw):
    """The three long-row ED wrappers on meta tensors: contract, k-NN
    chunk, range chunk."""
    head, plan, lbs2, q = _ed_inputs(b, chunk)
    stats = _meta(b, 6, dtype=torch.int32)
    flat = _meta(b * chunk, dtype=torch.int32)
    return (
        lambda: fv.fused_gather_ed_long(*head, flat, flat, q, g=g,
                                        rows=chunk, znorm=True, **kw),
        lambda: fv.fused_gather_ed_chunk_long(
            *head, plan, plan, plan, lbs2, q, _meta(b, k), stats, i=1,
            chunk=chunk, g=g, znorm=True, **kw),
        lambda: fv.fused_gather_ed_range_long(
            *head, plan, plan, plan, lbs2, q, _meta(b),
            _meta(b, dtype=torch.int32), stats, i=1, chunk=chunk, g=g,
            znorm=True, **kw))


_ED_WRAPPERS = (fv.fused_gather_ed_long, fv.fused_gather_ed_chunk_long,
                fv.fused_gather_ed_range_long)
_ED_ENTRIES = ("ulisse_fused_gather_ed_long",
               "ulisse_fused_gather_ed_chunk_long",
               "ulisse_fused_gather_ed_range_long")


@pytest.mark.parametrize("b,chunk,g,kw", [
    (2, 16, 5, {}), (8, 8, 1_500, {}), (3, 24, 49, {"otile": 16}),
    (3, 24, 49, {"otile": 8, "block": (32, 64)})])
def test_long_ed_wrappers_raise_rather_than_fall_back(fake_lib, b, chunk, g,
                                                      kw):
    """The long-row ED entries pass their (tile, otile, ptile) as the
    last three arguments before the stream and raise on a refused
    launch, counting nothing."""
    before = [w.launches for w in _ED_WRAPPERS]
    for call in _ed_calls(b, chunk, g, **kw):
        with pytest.raises(RuntimeError):
            call()
    assert [w.launches for w in _ED_WRAPPERS] == before
    assert [name for name, _ in fake_lib.calls] == list(_ED_ENTRIES)
    block = kw.get("block") or (0, 0)
    shape = fv.ed_long_shape(b, chunk, g, 40, SMS, kw.get("otile", 0),
                             *block)
    for _, args in fake_lib.calls:
        assert tuple(args[-4:-1]) == shape


@pytest.mark.parametrize("b,chunk,g,k,kw", [
    (8, 128, 49, 5, {}), (8, 8, 20_480, 5, {}), (3, 24, 49, 500, {}),
    (3, 24, 49, 5, {"otile": 8, "block": (32, 64)}),
    (2, 37, 1_500, 64, {"otile": 100, "block": (2, 8)})])
def test_long_ed_partials_are_what_the_entries_write(monkeypatch, b, chunk,
                                                     g, k, kw):
    """The k-NN entry's partials: a list of min(k, tile otile) entries a
    (row block, offset tile) of each query, as the kernel's grid (x:
    ceil(chunk / tile) row blocks, z: ceil(g / otile) offset tiles)
    writes them; the range entry's dense d2 (B, chunk g)."""
    lib = _fake(monkeypatch, ok=True)
    head, plan, lbs2, q = _ed_inputs(b, chunk)
    stats = _meta(b, 6, dtype=torch.int32)
    before = fv.fused_gather_ed_chunk_long.launches
    part = fv.fused_gather_ed_chunk_long(
        *head, plan, plan, plan, lbs2, q, _meta(b, k), stats, i=1,
        chunk=chunk, g=g, znorm=True, **kw)
    assert fv.fused_gather_ed_chunk_long.launches == before + 1
    tile, otile, ptile = lib.calls[-1][1][-4:-1]
    grid_x, grid_z = -(-chunk // tile), -(-g // otile)
    assert part.shape == (4, b, grid_x * grid_z * min(k, tile * otile))
    assert part.dtype == torch.int32
    if "block" not in kw:
        assert fv.ed_chunk_tile(40, g, True, kw.get("otile", 0), batch=b,
                                rows=chunk, sms=SMS) == tile
    out = fv.fused_gather_ed_range_long(
        *head, plan, plan, plan, lbs2, q, _meta(b),
        _meta(b, dtype=torch.int32), stats, i=1, chunk=chunk, g=g,
        znorm=True, **kw)
    assert out.shape == (b, chunk * g)


def _mindist_calls(b, n, w, nseg, **kw):
    q = _meta(b, w)
    valid = _meta(n, dtype=torch.bool)
    sym = _meta(n, w, dtype=torch.int32)
    return (lambda: md.mindist_sym(q, q, sym, sym, _meta(255), valid, 16,
                                   nseg, **kw),
            lambda: md.mindist_paa(q, q, _meta(n, w), _meta(n, w), valid, 16,
                                   nseg, **kw))


@pytest.mark.parametrize("b,n,w,nseg,kw", [
    (8, 8_448, 1_875, 1_812, {}), (8, 528, 1_875, 1_812, {}),
    (8, 2_002_944, 16, 16, {}), (3, 31_296, 16, 10, {}),
    (8, 3_001, 6_000, 6_000, {"plan": (0, 2, 1, 4)})])
def test_mindist_wrappers_raise_rather_than_fall_back(fake_lib, b, n, w,
                                                      nseg, kw):
    """Both mindist entries pass their plan (vec, qb, te, st) as the last
    four arguments before the stream, `mindist_plan`'s unless forced, and
    raise on a refused launch, counting nothing."""
    before = (md.mindist_sym.launches, md.mindist_paa.launches)
    for call in _mindist_calls(b, n, w, nseg, **kw):
        with pytest.raises(RuntimeError, match="mindist_"):
            call()
    assert (md.mindist_sym.launches, md.mindist_paa.launches) == before
    names = [name for name, _ in fake_lib.calls]
    assert names == ["ulisse_mindist_sym", "ulisse_mindist_paa"]
    for sym, (_, args) in zip((True, False), fake_lib.calls):
        want = kw.get("plan") or md.mindist_plan(sym, b, n, w, nseg, SMS)
        assert tuple(args[-5:-1]) == want


def test_mindist_splits_a_batch_past_eight_into_launches(monkeypatch):
    """Past 8 queries the wrappers launch once a slice of at most 8, each
    at the plan of its own slice's batch."""
    lib = _fake(monkeypatch, ok=True)
    before = md.mindist_paa.launches
    q = _meta(11, 16)
    out = md.mindist_paa(q, q, _meta(9_000, 16), _meta(9_000, 16),
                         _meta(9_000, dtype=torch.bool), 16, 16)
    assert out.shape == (11, 9_000)
    assert md.mindist_paa.launches == before + 2
    plans = [tuple(args[-5:-1]) for _, args in lib.calls]
    assert plans == [md.mindist_plan(False, 8, 9_000, 16, 16, SMS),
                     md.mindist_plan(False, 3, 9_000, 16, 16, SMS)]
    assert [args[-7] for _, args in lib.calls] == [8, 3]
