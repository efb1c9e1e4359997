"""Query planning for ULISSE search (the *planner* half of the engine).

A plan is everything derivable from (query, index params) before any raw
data is touched: the (possibly Z-normalized) query, its PAA interval,
lower bounds of blocks and envelopes, and the LB-sorted candidate packs
or orders the executor scans.

The k-NN and eps-range parts of `repro/core/planner.py` (ED and DTW):
the lower bounds go through the `mindist` kernels.  Two flavours, as in
the reference:

  * the device pipeline (`prepare_query_batch`, `*_lower_bounds_batch`,
    `device_leaf_pack`, `device_scan_pack`, the sharded scan's
    `device_shard_pack`, and for range the sortless `device_range_pack`):
    batched, every argsort stable as `jnp.argsort` is, nothing read back
    (the only host syncs of a device search are the executor's stop tests
    and the engine's one result readback; a paged engine also reads the
    plan back once, as its page schedule:
    `chunk_pages`);
  * the host backend (`prepare_query`, `env_lower_bounds`,
    `block_lower_bounds`, `plan_leaf_order`, `plan_scan_order`): one
    query; the orders are computed on the host by the reference's own
    numpy call (`np.argsort`, its default kind) over float64 copies of
    the bounds, so ties at 0 break the same way and the scan visits the
    same chunks.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import dtw
from repro_torch.core.executor import to_host
from repro_torch.core.paa import paa, znormalize
from repro_torch.core.types import EnvelopeParams, EnvelopeSet
from repro_torch.kernels.mindist import mindist_paa, mindist_sym

_INF = float("inf")


@dataclasses.dataclass
class PreparedQuery:
    """Everything derived from Q once per query (paper Alg. 4 lines 1-2),
    as tensors on the search's device."""

    q: torch.Tensor           # (possibly Z-normalized) query values (l,)
    qlen: int
    nseg: int                 # floor(|Q| / s)
    paa_lo: torch.Tensor      # (l // s,) query interval in PAA space
    paa_hi: torch.Tensor
    dtw_lo: Optional[torch.Tensor] = None   # (l,) dtwENV for LB_Keogh
    dtw_hi: Optional[torch.Tensor] = None
    measure: str = "ed"
    r: int = 0


def prepare_query(q, p: EnvelopeParams, measure: str = "ed", r: int = 0, *,
                  device) -> PreparedQuery:
    """One query's prep on `device` (`prepare_query_batch` at B = 1)."""
    q = torch.as_tensor(np.asarray(q, np.float32), device=device)
    qlen = int(q.shape[-1])
    nseg = p.query_segments(qlen)
    qn, dlo, dhi, qb, qh = prepare_query_batch(q[None], p.seg_len, p.znorm,
                                               measure, r)
    if measure == "ed":
        return PreparedQuery(q=qn[0], qlen=qlen, nseg=nseg, paa_lo=qb[0],
                             paa_hi=qh[0])
    return PreparedQuery(q=qn[0], qlen=qlen, nseg=nseg, paa_lo=qb[0],
                         paa_hi=qh[0], dtw_lo=dlo[0], dtw_hi=dhi[0],
                         measure="dtw", r=r)


def prepare_query_batch(q: torch.Tensor, seg_len: int, znorm: bool,
                        measure: str = "ed", r: int = 0):
    """Query prep for a (B, qlen) same-length batch.

    Returns (qn, dtw_lo, dtw_hi, paa_lo, paa_hi), each (B, ...); for ED
    the dtw slots alias qn and the PAA interval is degenerate; for DTW
    they hold the query's warping envelope and the PAA of its two sides.
    """
    qn = znormalize(q) if znorm else q
    if measure == "ed":
        qp = paa(qn, seg_len).contiguous()
        return qn, qn, qn, qp, qp
    if measure != "dtw":
        raise ValueError(f"unknown measure {measure!r}")
    if r <= 0:
        raise ValueError("DTW search needs a warping window r > 0")
    dlo, dhi = dtw.dtw_envelope(qn, r)
    return (qn, dlo.contiguous(), dhi.contiguous(),
            paa(dlo, seg_len).contiguous(), paa(dhi, seg_len).contiguous())


def length_bucket(qlen: int, cap: int) -> int:
    """The pow2 length bucket (capped at `cap`, normally lmax)."""
    return min(1 << max(qlen - 1, 0).bit_length(), cap)


def admit_query(q, p: EnvelopeParams) -> Tuple[np.ndarray, int]:
    """Admission-time planning for one request: validate + route.

    Returns (query as float32 ndarray, bucket); malformed requests raise
    ValueError.
    """
    arr = np.asarray(q, np.float32)
    if arr.ndim != 1:
        raise ValueError(
            f"a request is one 1-D query (got shape {arr.shape}); "
            "submit batch members individually — the serving tier does "
            "the batching")
    if arr.size == 0 or not np.all(np.isfinite(arr)):
        raise ValueError("query values must be finite and non-empty")
    if not (p.lmin <= arr.size <= p.lmax):
        raise ValueError(
            f"query length {arr.size} outside the index's "
            f"[{p.lmin}, {p.lmax}]")
    return arr, length_bucket(arr.size, p.lmax)


def env_lower_bounds_batch(paa_lo, paa_hi, env: EnvelopeSet, breakpoints,
                           seg_len: int, nseg: int, use_paa: bool):
    """Lower bounds (B, N) of a stacked (B, w) query batch to every
    envelope (Eq. 5): the iSAX breakpoint intervals, or the raw PAA
    bounds when `use_paa`; +inf for invalid (padding) rows."""
    if use_paa:
        return mindist_paa(paa_lo, paa_hi, env.paa_lo, env.paa_hi,
                           env.valid, seg_len, nseg)
    return mindist_sym(paa_lo, paa_hi, env.sym_lo, env.sym_hi, breakpoints,
                       env.valid, seg_len, nseg)


def block_lower_bounds_batch(paa_lo, paa_hi, blk_lo, blk_hi, blk_valid,
                             seg_len: int, nseg: int):
    """Lower bounds (B, Nb) to block-level envelope unions (always
    PAA-valued: block unions are built from raw L/U PAA bounds)."""
    return mindist_paa(paa_lo, paa_hi, blk_lo, blk_hi, blk_valid, seg_len,
                       nseg)


def env_lower_bounds(paa_lo, paa_hi, env: EnvelopeSet, breakpoints,
                     seg_len: int, nseg: int, use_paa: bool):
    """Lower bounds (N,) of one query interval to every envelope
    (`env_lower_bounds_batch` at B = 1)."""
    return env_lower_bounds_batch(paa_lo[None], paa_hi[None], env,
                                  breakpoints, seg_len, nseg, use_paa)[0]


def block_lower_bounds(paa_lo, paa_hi, blk_lo, blk_hi, blk_valid,
                       seg_len: int, nseg: int):
    """Lower bounds (Nb,) of one query interval to the block unions
    (`block_lower_bounds_batch` at B = 1)."""
    return block_lower_bounds_batch(paa_lo[None], paa_hi[None], blk_lo,
                                    blk_hi, blk_valid, seg_len, nseg)[0]


def plan_leaf_order(index, pq: PreparedQuery
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Best-first order over the finest block level: (order, block_lbs),
    on the host."""
    fine = index.levels[-1]
    blk_lb = to_host(block_lower_bounds(
        pq.paa_lo, pq.paa_hi, fine.paa_lo, fine.paa_hi, fine.valid,
        index.params.seg_len, pq.nseg)).astype(np.float64)
    return np.argsort(blk_lb), blk_lb


def plan_scan_order(index, pq: PreparedQuery, use_paa_bounds: bool = False
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """LB-sorted envelope order for the host exact scan: (order,
    sorted_lbs), on the host."""
    lbs = to_host(env_lower_bounds(
        pq.paa_lo, pq.paa_hi, index.search_envelopes(), index.breakpoints,
        index.params.seg_len, pq.nseg, use_paa_bounds)).astype(np.float64)
    order = np.argsort(lbs)
    return order, lbs[order]


def device_leaf_pack(env_sid, env_anchor, env_nm, env_valid, blk_lb,
                     n_main: int, block_size: int, chunk: int,
                     n_leaves: int):
    """Pack the approximate pass's candidates (paper Alg. 4, batched).

    First the ingestion delta (rows [n_main, N) of the combined set),
    padded to a multiple of `chunk`, with lbs2 = 0 for real rows (the
    delta has no block cover: it is always swept, which primes the bsf as
    the host path does); then the `n_leaves` best leaves in ascending
    block-LB order, each leaf padded to `chunk` rows (chunk =
    pow2ceil(block_size)), every row carrying its BLOCK's squared lower
    bound — so the scan core's per-chunk stop IS Alg. 4's "next leaf
    cannot improve" stop.

    Returns (sids, anchors, n_master, lbs2, comb_idx, blk_lb_sorted):
    all (B, n_pad) except blk_lb_sorted (B, Nb); comb_idx maps each
    packed row back to its combined-set envelope index (N for padding).
    """
    b_sz, _ = blk_lb.shape
    n_comb = env_sid.shape[0]
    n_delta = n_comb - n_main
    nd_pad = -(-n_delta // chunk) * chunk
    dev = blk_lb.device

    order = torch.argsort(blk_lb, dim=1, stable=True)       # (B, Nb)
    blk_sorted = torch.gather(blk_lb, 1, order)
    leaf_lb2 = blk_sorted[:, :n_leaves] ** 2

    member = torch.arange(chunk, dtype=torch.int64, device=dev)
    lidx = order[:, :n_leaves, None] * block_size + member  # (B, L, chunk)
    lidx = torch.where(member < block_size, lidx, n_comb)
    drow = torch.arange(nd_pad, dtype=torch.int64, device=dev)
    didx = torch.where(drow < n_delta, n_main + drow, n_comb)
    comb_idx = torch.cat([didx.expand(b_sz, nd_pad),
                          lidx.reshape(b_sz, n_leaves * chunk)], dim=1)

    real = comb_idx < n_comb
    safe = comb_idx.clamp(max=n_comb - 1)
    sids = torch.where(real, env_sid[safe], 0).to(torch.int32)
    anchors = torch.where(real, env_anchor[safe], 0).to(torch.int32)
    nm = torch.where(real & env_valid[safe], env_nm[safe],
                     0).to(torch.int32)
    row_lb2 = torch.cat([leaf_lb2.new_zeros((b_sz, nd_pad)),
                         leaf_lb2.repeat_interleave(chunk, dim=1)], dim=1)
    lbs2 = torch.where(real & (nm > 0), row_lb2, _INF)
    # each chunk's FIRST row decides the scan core's stop test: within a
    # delta chunk the first row is real (padding is a tail), and within a
    # leaf chunk the sorted main set puts valid rows first — so re-pin the
    # first row of every chunk to its block (or delta) bound even when
    # that row is individually invalid
    first = (torch.arange(comb_idx.shape[1], device=dev) % chunk) == 0
    any_valid = torch.cat([
        torch.full((b_sz, nd_pad), n_delta > 0, dtype=torch.bool,
                   device=dev),
        torch.isfinite(leaf_lb2).repeat_interleave(chunk, dim=1)], dim=1)
    lbs2 = torch.where(first[None, :] & any_valid, row_lb2, lbs2)
    return (sids.contiguous(), anchors.contiguous(), nm.contiguous(),
            lbs2.contiguous(), comb_idx.to(torch.int32), blk_sorted)


def device_scan_pack(env_sid, env_anchor, env_nm, lbs, comb_idx,
                     visited_chunks, chunk: int, n_pad: int):
    """LB-sort + pack the exact scan's candidate rows on the device.

    `lbs` (B, N) are the candidate set's lower bounds; rows the
    approximate pass already verified — packed positions
    `< visited_chunks * chunk` of `comb_idx` (see device_leaf_pack) — are
    excluded by scatter-setting their bound to +inf (the device pool has
    no dedup).  Candidates are stably argsorted per query and
    right-padded to `n_pad` columns.

    Returns (sids, anchors, n_master, lbs2, order).
    """
    b_sz, n = lbs.shape
    dev = lbs.device
    pos = torch.arange(comb_idx.shape[1], device=dev)
    verified = pos[None, :] < (visited_chunks[:, None] * chunk)
    # index n is the padding sink (the "drop" of the reference scatter)
    hits = torch.zeros((b_sz, n + 1), dtype=torch.int32, device=dev)
    hits.scatter_add_(1, comb_idx.long(), verified.to(torch.int32))
    lbs = torch.where(hits[:, :n] > 0, _INF, lbs)
    order = torch.argsort(lbs, dim=1, stable=True)
    lbs_sorted = torch.gather(lbs, 1, order)

    pad = n_pad - n

    def pack(col, fill):
        out = col[order].to(torch.int32)
        return torch.nn.functional.pad(out, (0, pad), value=fill)

    lbs2 = torch.nn.functional.pad(lbs_sorted ** 2, (0, pad), value=_INF)
    return (pack(env_sid, 0), pack(env_anchor, 0), pack(env_nm, 0),
            lbs2, order)


def device_shard_pack(env_sid, env_anchor, env_nm, lbs, n_pad: int,
                      n_delta: int = 0, chunk: int = 1):
    """LB-sort + pack one shard's candidate rows on the device (the
    sharded scan's plan; the JAX package's, step for step).

    `lbs` (B, N) are the shard's lower bounds and env_* its envelope
    columns (series ids local to the shard).  There is no approximate
    pass on the sharded path, so nothing is excluded: the rows are
    stably argsorted per query and right-padded to `n_pad` (zeros, +inf
    bounds).  The last `n_delta` rows are a per-shard ingestion delta:
    they are packed first, in their own order, chunk-padded, with their
    real squared bounds except each delta chunk's head, pinned to 0 so
    the scan's chunk-head stop test never skips an unsorted delta chunk
    (invalid delta rows get n_master 0); the LB-sorted main rows follow.
    `n_pad`, `chunk` and the delta width come from
    `executor.shard_pack_geometry`.

    Returns (sids, anchors, n_master, lbs2), each (B, n_pad).
    """
    b_sz, n = lbs.shape
    dev = lbs.device
    pad = torch.nn.functional.pad
    if n_delta == 0:
        order = torch.argsort(lbs, dim=1, stable=True)
        lbs_sorted = torch.gather(lbs, 1, order)

        def pack(col):
            return pad(col[order].to(torch.int32), (0, n_pad - n))

        return (pack(env_sid), pack(env_anchor), pack(env_nm),
                pad(lbs_sorted ** 2, (0, n_pad - n), value=_INF))
    n_main = n - n_delta
    nd_pad = -(-n_delta // chunk) * chunk
    didx = torch.arange(nd_pad, dtype=torch.int64, device=dev)
    dreal = didx < n_delta
    dsafe = n_main + didx.clamp(max=n_delta - 1)

    def dpack(col):
        out = torch.where(dreal, col[dsafe], 0).to(torch.int32)
        return out[None, :].expand(b_sz, nd_pad)

    d_lb2 = pad(lbs[:, n_main:] ** 2, (0, nd_pad - n_delta), value=_INF)
    d_nm = torch.where(torch.isfinite(d_lb2), dpack(env_nm), 0)
    head = ((didx % chunk) == 0) & dreal
    d_lb2 = torch.where(head[None, :], 0.0, d_lb2)
    m_pad = n_pad - nd_pad
    order = torch.argsort(lbs[:, :n_main], dim=1, stable=True)
    lbs_sorted = torch.gather(lbs[:, :n_main], 1, order)

    def mpack(col):
        return pad(col[:n_main][order].to(torch.int32), (0, m_pad - n_main))

    m_lb2 = pad(lbs_sorted ** 2, (0, m_pad - n_main), value=_INF)
    return tuple(torch.cat([a, b], dim=1).contiguous() for a, b in (
        (dpack(env_sid), mpack(env_sid)),
        (dpack(env_anchor), mpack(env_anchor)),
        (d_nm.to(torch.int32), mpack(env_nm)), (d_lb2, m_lb2)))


def device_range_pack(env_sid, env_anchor, env_nm, lbs, eps2, n_pad: int):
    """Pack the eps-range scan's candidates on the device, with no sort.

    A range query's cut never moves (bsf == eps), so the scan order does
    not matter: every envelope with lb2 <= eps2 must be verified and no
    other ever can be.  The candidates (finite lb2 <= eps2[b], inclusive,
    so a boundary hit with lb == d == eps stays) are packed to the front
    in candidate-set order by a binary-search gather over the candidate
    mask's cumsum, as the reference packs them; nothing is read back.

    lbs (B, N) are the candidate set's lower bounds, eps2 (B,) float32.
    Returns (sids, anchors, n_master, lbs2, src): plan arrays (B, n_pad)
    with lbs2 = +inf past each query's candidate count (and zeros in the
    int columns), and `src` (B, n_pad) int32, the candidate-set index of
    every packed row (what the host continuation of an overflowed query
    replays).
    """
    b_sz, n = lbs.shape
    lbs2 = lbs ** 2
    cand = (lbs2 <= eps2[:, None]) & torch.isfinite(lbs2)
    nc = cand.sum(dim=1)
    cc = torch.cumsum(cand, dim=1)
    ranks = torch.arange(1, n_pad + 1, device=lbs.device)
    src = torch.searchsorted(cc, ranks.expand(b_sz, n_pad).contiguous())
    src = src.clamp(max=n - 1)
    real = ranks[None, :] <= nc[:, None]

    def pack(col):
        return torch.where(real, col[src], 0).to(torch.int32)

    lbs2p = torch.where(real, torch.gather(lbs2, 1, src), _INF)
    return (pack(env_sid), pack(env_anchor), pack(env_nm),
            lbs2p.contiguous(), src.to(torch.int32))


# -- paged access scheduling (host side) ---------------------------------
#
# On the paged out-of-core path the packed plan doubles as a page access
# schedule: the candidate order fixes which series rows chunk i gathers,
# so chunk i + 1's slab (and the pages behind it) can be read and copied
# while chunk i computes.


def chunk_pages(sids: np.ndarray, i: int, chunk: int, page_rows: int):
    """Resolve plan chunk i's slab: which series rows, which pages.

    `sids` is the packed (B, n_pad) global series-id plan (host numpy).
    Returns (uniq, local, pages): the chunk's sorted-unique global series
    ids, the (B, chunk) slab-local remap of the plan columns (uniq[local]
    == the original sids), and the sorted-unique page indices those rows
    live on under `page_rows`-row pages.
    """
    cols = np.ascontiguousarray(sids[:, i * chunk:(i + 1) * chunk])
    uniq = np.unique(cols)
    local = np.searchsorted(uniq, cols).astype(np.int32)
    pages = np.unique(uniq // page_rows)
    return uniq, local, pages


def chunk_page_schedule(sids: np.ndarray, page_rows: int, chunk: int):
    """The full chunk -> page access schedule of a packed plan: a list over
    chunks of sorted-unique page-index arrays — what a paged scan would
    read, in visit order, if it ran every chunk (an early stop only
    truncates it)."""
    sids = np.asarray(sids)
    n_chunks = sids.shape[1] // chunk
    return [chunk_pages(sids, i, chunk, page_rows)[2]
            for i in range(n_chunks)]
