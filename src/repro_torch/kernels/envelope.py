"""Z-normalized envelope construction (paper Alg. 2): the
`envelope_znorm` kernels.

The port's counterpart of `repro/kernels/envelope.py::
envelope_znorm_pallas`, placed where the reference computes the same
function in jnp: the length loop of `repro/core/envelope.py::
build_envelopes_znorm`, run by every Z-normalized index build.  Two
wrappers over `csrc/envelope.cu`:

  envelope_znorm          the index build: finished (lo, hi) bounds of
                          every envelope of S series from their float32
                          prefix sums (the build's call);
  envelope_znorm_masters  per-master bounds from (segmean, s1, s2,
                          offsets), the TPU kernel's own contract.

Inputs are checked on every device against what the kernel takes; then
CPU tensors take the plain versions in `ref.py` and CUDA tensors launch
the kernel.  Kernel and plain version share their arithmetic (IEEE
divisions, no contraction), so they agree bit for bit.  Each wrapper
counts its launches in `.launches`.

The build runs one of two kernels, as `envelope_plan` picks: the
one-pass kernel up to 32 segments (a warp a master, a lane a length, 16
segments a pass in registers), else the slab kernel (a thread a slab of
8 segments, each (master, l')'s statistics computed once a tile of
lengths and swept across the slabs); both give the same bits.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, ref

# the one-pass kernel: segments a lane a pass and warps a block
_ONE_PASS_Z = 16
_ONE_PASS_WARPS = 4
# the slab kernel: segments a thread, warps a block and lengths a tile at
# most
_SLAB_ZT = 8
_SLAB_MAX_WARPS = 8
_SLAB_TILE = 512
_SMEM_LIMIT = 227 * 1024


def _slab_smem(tile: int, warps: int) -> int:
    """Shared bytes of a slab block: two tiles of (mu, sigma, 1 / sigma,
    segment count) and the tile's (1 / l', segment count) table, or at
    the end every thread's padded (lo, hi)."""
    return max(40 * tile, 8 * 32 * warps * (_SLAB_ZT + 1))


def slab_shape(w: int, warps: int) -> tuple:
    """(nslab, nph, groups) of the slab kernel: slab slots a phase (the
    slabs of 8 segments, past 32 rounded up to whole warps so that a
    warp holds one phase; at most the block's threads), phases of the
    lengths (threads // nslab: thread = phase * nslab + slot; slots from
    w on and threads past the phases idle), and blocks an envelope (grid
    y) for the slabs past one block's."""
    threads = 32 * warps
    slabs = -(-w // _SLAB_ZT)
    nslab = min(slabs if slabs <= 32 else -(-slabs // 32) * 32, threads)
    return nslab, threads // nslab, -(-slabs // nslab)


def envelope_plan(n: int, lmin: int, lmax: int, gamma: int,
                  seg_len: int) -> tuple:
    """(kind, tile, warps) of the build over series of n points.

    Kind 0 up to 32 segments: the one-pass kernel (its own fixed shape,
    (0, 0, 4): 16 segments a lane, 4 warps, one or two passes; staged or
    not by its shared memory).  Past 32, kind 1: the slab kernel (8
    segments a thread) at warps a block up to 4 and at most half the
    slabs (so that a thread's phase takes at least a sixteenth of a
    tile's lengths), tiles of at most 512 lengths, the length range
    split evenly, rounded up to a warp.  Timed on the card
    (`chip_kernels.py --envelope --alternatives`): at 513 lengths the
    one-pass kernel's two passes beat every slab plan at 32 segments,
    the slab kernel won from 48-64 on and at [15]'s 1,875, where 8
    segments a thread beat 12 and 16 (fewer registers) and 4 warps beat
    1, 2 and 8; at 16 segments the one-pass kernel beat every slab plan
    timed, staged ([13]) and unstaged ([21]'s 20,480 masters)."""
    w = lmax // seg_len
    if w <= 2 * _ONE_PASS_Z:
        return 0, 0, _ONE_PASS_WARPS
    warps = min(4, max(1, -(-w // _SLAB_ZT) // 2))
    n_len = lmax - lmin + 1
    per = -(-n_len // -(-n_len // _SLAB_TILE))
    return 1, -(-per // 32) * 32, warps


def check_plan(plan, n: int, lmin: int, lmax: int, gamma: int,
               seg_len: int) -> tuple:
    """`plan` as a tuple of ints if a build kernel takes it at this shape,
    else ValueError: (0, 0, 4), the one-pass kernel (at any w, in passes
    of 16 segments; staged or not), or kind 1, the slab kernel, at 1-8
    warps, a tile of at least one length and a block within 227 KB, its
    segment groups within the grid's 65,535."""
    kind, tile, warps = (int(v) for v in plan)
    w = lmax // seg_len
    if kind == 0:
        ok = tile == 0 and warps == _ONE_PASS_WARPS
    else:
        ok = (kind == 1 and 1 <= warps <= _SLAB_MAX_WARPS and tile >= 1
              and _slab_smem(tile, warps) <= _SMEM_LIMIT
              and slab_shape(w, warps)[2] <= 65_535)
    if not ok:
        raise ValueError(f"envelope_znorm: no kernel takes plan {plan} at "
                         f"n={n}, lmin={lmin}, lmax={lmax}, gamma={gamma}, "
                         f"seg_len={seg_len} (w={w})")
    return kind, tile, warps


def envelope_znorm(csum: torch.Tensor, csum2: torch.Tensor, *, lmin: int,
                   lmax: int, gamma: int, seg_len: int,
                   plan: Optional[tuple] = None):
    """Z-normalized envelopes of S series of length n: (lo, hi), each
    (S, n_env, lmax // seg_len) float32, -inf / +inf on segments no
    represented subsequence covers.

    csum / csum2 (S, n+1) float32 are the prefix sums, with a leading 0,
    of the series' centered values and of their squares; envelope e has
    masters e * (gamma + 1) + j, j <= gamma.  `plan` forces the
    kernel's (kind, tile, warps) (default `envelope_plan`'s); a plan
    no kernel takes raises ValueError, on the CPU too.
    """
    dev = csum.device
    s, np1 = csum.shape
    n = np1 - 1
    w = lmax // seg_len
    if not seg_len <= lmin <= lmax or gamma < 0 or lmin > n:
        raise ValueError(f"envelope_znorm: lmin={lmin}, lmax={lmax}, "
                         f"seg_len={seg_len}, gamma={gamma} at n={n}")
    n_env = -(-(n - lmin + 1) // (gamma + 1))
    _build.check_tensors("envelope_znorm", dev, (
        ("csum", csum, torch.float32, (s, np1)),
        ("csum2", csum2, torch.float32, (s, np1))))
    if plan is not None:
        plan = check_plan(plan, n, lmin, lmax, gamma, seg_len)
    if dev.type == "cpu":
        return ref.envelope_znorm_ref(csum, csum2, lmin=lmin, lmax=lmax,
                                      gamma=gamma, seg_len=seg_len)
    lo, hi = torch.empty((2, s, n_env, w), dtype=torch.float32, device=dev)
    if s == 0:
        return lo, hi
    lib = _build.library("envelope")
    if plan is None:
        plan = envelope_plan(n, lmin, lmax, gamma, seg_len)
    code = lib.ulisse_envelope_znorm(
        csum.data_ptr(), csum2.data_ptr(), lo.data_ptr(), hi.data_ptr(), s,
        n, n_env, lmin, lmax, gamma, seg_len, *plan,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "envelope_znorm")
    envelope_znorm.launches += 1
    return lo, hi


envelope_znorm.launches = 0


def envelope_znorm_masters(segmean: torch.Tensor, s1: torch.Tensor,
                           s2: torch.Tensor, offsets: torch.Tensor, *,
                           n: int, lmin: int, seg_len: int):
    """Per-master normalized PAA bounds (the Alg. 2 length reduction).

    segmean (M, w) float32 segment means per master offset; s1 / s2
    (M, L) float32 window sums / sums of squares for lengths lmin ..
    lmin + L - 1; offsets (M,) int32.  Returns (lo, hi) (M, w) float32;
    where no (length, segment) cell is valid lo stays +3e38 and hi -3e38
    (callers finalize to -inf / +inf).
    """
    dev = segmean.device
    m, w = segmean.shape
    n_len = s1.shape[1]
    _build.check_tensors("envelope_znorm_masters", dev, (
        ("segmean", segmean, torch.float32, (m, w)),
        ("s1", s1, torch.float32, (m, n_len)),
        ("s2", s2, torch.float32, (m, n_len)),
        ("offsets", offsets, torch.int32, (m,))))
    if seg_len < 1 or lmin < 1:
        raise ValueError(f"envelope_znorm_masters: lmin={lmin}, "
                         f"seg_len={seg_len}")
    if dev.type == "cpu":
        return ref.envelope_scan_ref(segmean, s1, s2, offsets, n=n,
                                     lmin=lmin, seg_len=seg_len)
    lo, hi = torch.empty((2, m, w), dtype=torch.float32, device=dev)
    if m == 0 or w == 0:
        return lo, hi
    lib = _build.library("envelope")
    code = lib.ulisse_envelope_znorm_masters(
        segmean.data_ptr(), s1.data_ptr(), s2.data_ptr(), offsets.data_ptr(),
        lo.data_ptr(), hi.data_ptr(), m, w, n_len, n, lmin, seg_len,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "envelope_znorm_masters")
    envelope_znorm_masters.launches += 1
    return lo, hi


envelope_znorm_masters.launches = 0
