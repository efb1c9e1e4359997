"""ULISSE Envelope construction (paper §4, Algorithms 1 and 2).

The JAX package vmaps a per-series function; here the series axis is a
batch dimension of every tensor, and the build walks the collection in
blocks of series so that the (series, anchor, master, segment) grid of
one block stays within a fixed element budget on the device.  The
Z-normalized build on the card never makes that grid (the kernel reduces
it as it goes): its blocks are sized by what it does hold, the centred
copy, its square and the two prefix sums, within a byte budget.

  non-normalized (Alg. 1):  a (S, n_env, gamma+1, w) grid of master-series
    PAA coefficients, min/max-reduced over the master axis (plain torch:
    the JAX package has no kernel for it);
  Z-normalized (Alg. 2):    the length reduction over l' in [lmin, lmax]
    of every master's normalized segment means, one `envelope_znorm`
    kernel launch per block of series (its plain version is the JAX
    build's loop over lengths).

Segments not covered by any represented subsequence get (-inf, +inf)
bounds so they contribute zero to every lower bound.  Every division is
an IEEE division on every device, as in the JAX build (torch divides a
CUDA tensor by a Python number through its reciprocal).

The prefix sums here are float32 cumsums, as in the reference; their
rounding may differ from XLA's, so an iSAX symbol of the port's own build
can flip at a breakpoint (the tests bound the agreement rate).  On the
card every mean and scan of the build sums one series in order
(`_columns`), so a series' envelopes do not depend on the block it is
built in: envelopes built at `append` equal a rebuild's.
"""
from __future__ import annotations

import torch

from repro_torch.core import isax
from repro_torch.core.types import Collection, EnvelopeParams, EnvelopeSet
from repro_torch.kernels.envelope import envelope_znorm
from repro_torch.kernels.ref import true_div

_INF = float("inf")

# elements of one block's (S, n_env, g, w) grid
_BUILD_BLOCK_ELEMS = 1 << 25
# bytes of one block's temporaries in the Z-normalized build on the card
# (at 1M series x 256 points: 6 launches, below the index's sort peak)
_CARD_BUILD_BYTES = 1 << 30


def _anchors(series_len: int, p: EnvelopeParams, device) -> torch.Tensor:
    n_env = p.num_envelopes(series_len)
    return torch.arange(n_env, dtype=torch.int32, device=device) * (p.gamma + 1)


def _master_offsets(series_len: int, p: EnvelopeParams, device):
    """(n_env, g) master offsets and validity (master fits lmin)."""
    a = _anchors(series_len, p, device)
    g = torch.arange(p.gamma + 1, dtype=torch.int32, device=device)
    off = a[:, None] + g[None, :]
    return off, off + p.lmin <= series_len


def _prefix(x: torch.Tensor) -> torch.Tensor:
    """(S, n) -> (S, n + 1) float32 cumsum with a leading zero."""
    zero = torch.zeros((x.shape[0], 1), dtype=torch.float32, device=x.device)
    return torch.cat([zero, torch.cumsum(x, dim=-1)], dim=-1)


def _columns(x: torch.Tensor) -> torch.Tensor:
    """x (S, n) on the card as a new (n, max(S, 2)) block, one series a
    column (a lone series beside a zero column).

    torch's CUDA scan along a dimension that is not the innermost runs one
    thread a column, in order (ATen `scan_outer_dim`), so a column's sums
    round the same whatever the columns beside it; a single column would
    go to a parallel scan instead, hence the second column."""
    s, n = x.shape
    xt = x.new_zeros((n, max(s, 2)))
    xt[:, :s] = x.t()
    return xt


def _column_prefix(xt: torch.Tensor, s: int) -> torch.Tensor:
    """The in-order scan down the first s columns of xt (n, S') as (s,
    n + 1) prefix sums with a leading zero."""
    c = torch.cumsum(xt, dim=0)
    zero = c.new_zeros((1, c.shape[1]))
    return torch.cat([zero, c])[:, :s].t().contiguous()


def series_prefix(x: torch.Tensor) -> torch.Tensor:
    """(S, n) -> (S, n + 1) prefix sums with a leading zero, each row's
    independent of the rows beside it (on the card: `_columns`)."""
    if x.device.type != "cuda":
        return _prefix(x)
    return _column_prefix(_columns(x), x.shape[0])


def centered_prefixes(x: torch.Tensor):
    """The Z-normalized build's inputs: the prefix sums (S, n + 1) of the
    centred series and of their squares.  On the card every mean and scan
    sums one series in order (`_columns`), so a series' envelopes do not
    depend on the block it is built in: an append equals a rebuild."""
    if x.device.type != "cuda":
        xc = x - x.mean(dim=-1, keepdim=True)
        return _prefix(xc), _prefix(xc * xc)
    s, n = x.shape
    xc = _columns(x)
    xc -= torch.cumsum(xc, dim=0)[-1] / n
    csum = _column_prefix(xc, s)
    xc *= xc
    return csum, _column_prefix(xc, s)


def _segment_sums(csum: torch.Tensor, off: torch.Tensor, p: EnvelopeParams):
    """Segment sums for each master offset: (S, n_env, g, w) + mask."""
    n = csum.shape[-1] - 1
    z = torch.arange(p.w, dtype=torch.int32, device=csum.device)
    start = off[..., None] + z * p.seg_len                  # (n_env, g, w)
    end = start + p.seg_len
    seg_ok = end <= n
    sums = (csum[:, end.clamp(0, n).long()]
            - csum[:, start.clamp(0, n).long()])
    return sums, seg_ok


def _masked_minmax(vals, mask, dim: int):
    lo = torch.where(mask, vals, _INF).amin(dim=dim)
    hi = torch.where(mask, vals, -_INF).amax(dim=dim)
    return lo, hi


def _finalize(lo, hi):
    """Mark never-touched segments as unconstrained (-inf, +inf)."""
    untouched = lo > hi
    return (torch.where(untouched, -_INF, lo),
            torch.where(untouched, _INF, hi))


def build_envelopes_raw(series: torch.Tensor, p: EnvelopeParams):
    """Alg. 1 — non Z-normalized Envelopes for a block of series.

    series: (S, n) float32.  Returns (paa_lo, paa_hi) (S, n_env, w) and
    n_master (n_env,).
    """
    n = series.shape[-1]
    csum = series_prefix(series.to(torch.float32))
    off, master_ok = _master_offsets(n, p, series.device)
    sums, seg_ok = _segment_sums(csum, off, p)
    mask = master_ok[..., None] & seg_ok
    lo, hi = _masked_minmax(true_div(sums, p.seg_len), mask, dim=2)
    lo, hi = _finalize(lo, hi)
    return lo, hi, master_ok.sum(dim=1, dtype=torch.int32)


def build_envelopes_znorm(series: torch.Tensor, p: EnvelopeParams):
    """Alg. 2 — Z-normalized Envelopes for a block of series.

    Evaluates Eq. 2 for every (series, anchor, master, segment) and
    length l' = lmin..lmax (the paper's second loop),

        paaNorm(o, l', z) = (segsum(o, z)/s - mu(o, l')) / sigma(o, l')

    subject to (z+1)*s <= l' and o + l' <= n, and min/max-reduces it
    (the `envelope_znorm` kernel, from the float32 prefix sums of the
    centered series).  Returns (paa_lo, paa_hi) (S, n_env, w) and
    n_master (n_env,).
    """
    n = series.shape[-1]
    lo, hi = envelope_znorm(*centered_prefixes(series.to(torch.float32)),
                            lmin=p.lmin, lmax=p.lmax, gamma=p.gamma,
                            seg_len=p.seg_len)
    _, master_ok = _master_offsets(n, p, series.device)
    return lo, hi, master_ok.sum(dim=1, dtype=torch.int32)


def build_block_series(n: int, p: EnvelopeParams, device) -> int:
    """Series per block of the build.  The Z-normalized build on the card
    holds, per series, the centred copy (squared in place), a column
    scan, its copy with the leading zero and two prefix sums ((n + 1)
    floats each at most) and its (lo, hi) output; every other build holds
    the (n_env, g, w) grid."""
    n_env = p.num_envelopes(n)
    if p.znorm and torch.device(device).type == "cuda":
        return _CARD_BUILD_BYTES // (4 * (5 * (n + 1) + 2 * n_env * p.w))
    return _BUILD_BLOCK_ELEMS // (n_env * (p.gamma + 1) * p.w)


def build_envelope_set(collection: Collection, p: EnvelopeParams,
                       breakpoints: torch.Tensor) -> EnvelopeSet:
    """Build the full (unsorted) EnvelopeSet of a collection (paper Alg. 3):
    per-block envelope bounds, flattened series-major, symbolized with
    iSAX."""
    n = collection.series_len
    n_env = p.num_envelopes(n)
    if n_env == 0:
        raise ValueError(f"series_len={n} shorter than lmin={p.lmin}")
    dev = collection.device
    s = collection.num_series
    build_fn = build_envelopes_znorm if p.znorm else build_envelopes_raw
    block = max(1, build_block_series(n, p, dev))
    lo = torch.empty((s, n_env, p.w), dtype=torch.float32, device=dev)
    hi = torch.empty_like(lo)
    n_master = None
    for start in range(0, s, block):
        stop = min(start + block, s)
        blo, bhi, n_master = build_fn(collection.data[start:stop], p)
        lo[start:stop] = blo
        hi[start:stop] = bhi
    lo = lo.reshape(s * n_env, p.w)
    hi = hi.reshape(s * n_env, p.w)
    n_master = n_master.repeat(s)
    return EnvelopeSet(
        paa_lo=lo, paa_hi=hi,
        sym_lo=isax.symbolize(lo, breakpoints),
        sym_hi=isax.symbolize(hi, breakpoints),
        series_id=torch.arange(s, dtype=torch.int32,
                               device=dev).repeat_interleave(n_env),
        anchor=_anchors(n, p, dev).repeat(s),
        n_master=n_master, valid=n_master > 0)
