"""Port parity, the scan's ED chunk step and pool merge: the port's plain
versions (what its wrappers run for CPU tensors) against the JAX
package's `_pool_merge` and `_scan_chunk_step` on the same numpy inputs.

The inputs are chosen so that every float32 operation of both sides is
exact: raw series of small integers with mean 0, and Z-normalized series
tiled from balanced period-4 patterns of +-a (every window of a length
divisible by 4 has mean 0 and sd a), with integer queries.  The distances
are then integers that both sides compute exactly, whatever the order of
their sums, and repeat often — so the pools must agree bit for bit,
ties included, and the counters exactly.

The partials path (each block's k best, then a merge: what the card
runs) is held against the plain merge with the kernel's block selection
written out in numpy.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import Collection as JCollection  # noqa: E402
from repro.core import executor as jexecutor  # noqa: E402
from repro_torch.core import Collection, executor  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.fused_verify import fused_gather_ed_chunk  # noqa: E402
from repro_torch.kernels.pool_merge import (pool_merge,  # noqa: E402
                                            pool_merge_partials)


def _exact_data(rng, s, n, znorm):
    """(S, n) float32 series whose windows' statistics are exact."""
    if znorm:
        pats = np.array([[1, 1, -1, -1], [1, -1, 1, -1], [1, -1, -1, 1],
                         [-1, 1, 1, -1]], np.float32)
        rows = [np.tile(pats[rng.integers(4)], n // 4) * rng.integers(1, 3)
                for _ in range(s)]
        return np.stack(rows).astype(np.float32)
    half = rng.integers(-3, 4, (s, n // 2))
    data = np.concatenate([half, -half], axis=1)
    return rng.permuted(data, axis=1).astype(np.float32)


def _plan(rng, b, n_pad, s, g, n_anchor):
    """A (B, n_pad) plan: anchors on the envelope grid (some windows
    overrun the series), random n_master, query 0 all padding (never
    active), query 1 with almost no real master."""
    sids = rng.integers(0, s, (b, n_pad)).astype(np.int32)
    anchors = (rng.integers(0, n_anchor, (b, n_pad)) * g).astype(np.int32)
    n_master = rng.integers(0, g + 1, (b, n_pad)).astype(np.int32)
    n_master[1] = 0
    n_master[1, ::7] = 2
    return sids, anchors, n_master


def _seed(rng, b, k, values):
    """A sorted (B, k) pool: about half of it drawn from `values` (ties
    with the candidates), the rest +inf filler with sid/off -1."""
    d2 = np.full((b, k), np.inf, np.float32)
    sid = np.full((b, k), -1, np.int32)
    m = min(k // 2, len(values))
    for q in range(b):
        d2[q, :m] = np.sort(rng.choice(values, m, replace=False))
        sid[q, :m] = 1000 + np.arange(m)
    return d2, sid, sid.copy()


def _jax_pool(pool):
    return tuple(jnp.asarray(x) for x in pool)


@pytest.mark.parametrize("k", [1, 5, 64, 500])
@pytest.mark.parametrize("m", [7, 300])
def test_pool_merge_ref_matches_reference(k, m):
    """Integer distances (many ties, also with the incumbents), +inf
    candidates and filler: the stable-sort merge equals lax.top_k's."""
    rng = np.random.default_rng(k * 1000 + m)
    b = 4
    pool = _seed(rng, b, k, np.arange(40, dtype=np.float32))
    for rnd in range(3):
        cd2 = rng.integers(0, 40, (b, m)).astype(np.float32)
        cd2[rng.random((b, m)) < 0.3] = np.inf
        cd2[2] = np.inf                          # no candidate at all
        csid = rng.integers(0, 100, (b, m)).astype(np.int32)
        coff = rng.integers(0, 100, (b, m)).astype(np.int32)
        want = jexecutor._pool_merge(_jax_pool(pool), jnp.asarray(cd2),
                                     jnp.asarray(csid), jnp.asarray(coff), k)
        got = ref.pool_merge_ref(tuple(torch.from_numpy(x) for x in pool),
                                 torch.from_numpy(cd2),
                                 torch.from_numpy(csid),
                                 torch.from_numpy(coff))
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
        pool = tuple(x.numpy() for x in got)


def _block_partials(cd2, csid, coff, kth, block, kp):
    """The card's partials, in numpy: each block of `block` positions
    keeps its kp least candidates below kth by (d2, position), sorted,
    then empty entries (+inf, -1, -1, 2^31 - 1)."""
    b, m = cd2.shape
    nblk = -(-m // block)
    part = np.zeros((4, b, nblk, kp), np.int32)
    d2v = part[0].view(np.float32)
    d2v[:] = np.inf
    part[1:3] = -1
    part[3] = 2 ** 31 - 1
    for q in range(b):
        for blk in range(nblk):
            pos = np.arange(blk * block, min((blk + 1) * block, m))
            pos = pos[cd2[q, pos] < kth[q]]
            pos = pos[np.lexsort((pos, cd2[q, pos]))][:kp]
            n = len(pos)
            d2v[q, blk, :n] = cd2[q, pos]
            part[1, q, blk, :n] = csid[q, pos]
            part[2, q, blk, :n] = coff[q, pos]
            part[3, q, blk, :n] = pos
    return torch.from_numpy(part.reshape(4, b, nblk * kp))


@pytest.mark.parametrize("k,block", [(1, 8), (5, 49), (5, 392),
                                     (64, 100), (500, 392)])
def test_pool_merge_partials_equal_the_dense_merge(k, block):
    """Keeping only each block's kp = min(k, block) least candidates below
    kth, in any block order, and merging those gives the dense merge's
    pool exactly: the kernels' pre-selection loses nothing."""
    rng = np.random.default_rng(k + block)
    b, m = 4, 3000
    pool = _seed(rng, b, k, np.arange(30, dtype=np.float32))
    for _ in range(3):
        cd2 = rng.integers(0, 60, (b, m)).astype(np.float32)
        cd2[rng.random((b, m)) < 0.5] = np.inf
        csid = rng.integers(0, 100, (b, m)).astype(np.int32)
        coff = rng.integers(0, 100, (b, m)).astype(np.int32)
        tpool = tuple(torch.from_numpy(x) for x in pool)
        want = ref.pool_merge_ref(tpool, *(torch.from_numpy(x)
                                           for x in (cd2, csid, coff)))
        part = _block_partials(cd2, csid, coff, pool[0][:, -1], block,
                               min(k, block))
        # the blocks' order in the buffer is not the merge's order
        perm = torch.from_numpy(rng.permutation(part.shape[2]))
        got = ref.pool_merge_partials_ref(tpool, part[:, :, perm])
        for x, y in zip(got, want):
            assert torch.equal(x, y)
        pool = tuple(x.numpy() for x in want)


def test_pool_merge_wrappers_write_in_place():
    """On the CPU both wrappers run the plain merge into the caller's
    tensors, and count no launch."""
    rng = np.random.default_rng(5)
    pool = [torch.from_numpy(x) for x in _seed(rng, 3, 6, np.arange(
        20, dtype=np.float32))]
    ptrs = [t.data_ptr() for t in pool]
    cd2 = torch.from_numpy(rng.integers(0, 20, (3, 50)).astype(np.float32))
    cs = torch.from_numpy(rng.integers(0, 9, (3, 50)).astype(np.int32))
    want = ref.pool_merge_ref(pool, cd2, cs, cs)
    before = pool_merge.launches, pool_merge_partials.launches
    pool_merge(pool, cd2, cs, cs)
    for x, y in zip(pool, want):
        assert torch.equal(x, y)
    pos = torch.arange(50, dtype=torch.int32).expand(3, 50)
    part = torch.stack([cd2.view(torch.int32), cs, cs, pos])
    pool2 = [t.clone() for t in pool]
    want = ref.pool_merge_ref(pool2, cd2, cs, cs)
    pool_merge_partials(pool2, part)
    for x, y in zip(pool2, want):
        assert torch.equal(x, y)
    assert [t.data_ptr() for t in pool] == ptrs
    assert (pool_merge.launches, pool_merge_partials.launches) == before


def _chunk_inputs(znorm, k, chunk, seed):
    rng = np.random.default_rng(seed)
    s, n, qlen, g, b = 6, 64, 32, 9, 5
    n_pad = 4 * chunk
    data = _exact_data(rng, s, n, znorm)
    sids, anchors, n_master = _plan(rng, b, n_pad, s, g, 4)
    qs = rng.integers(-2, 3, (b, qlen)).astype(np.float32)
    # the exact distances of every window: lbs2 rises to their median,
    # the seed pool ties with them
    win = np.lib.stride_tricks.sliding_window_view(data, qlen, axis=1)
    if znorm:
        d_all = (2 * qlen - 2 * np.einsum("swl,bl->bsw", win, qs)
                 / np.abs(data[:, :1])[None]).reshape(-1)
    else:
        d_all = (((win[None] - qs[:, None, None]) ** 2).sum(-1)).reshape(-1)
    d_all = np.maximum(d_all, 0)
    lbs2 = np.sort(rng.random((b, n_pad)), axis=1) * np.median(d_all)
    lbs2 = lbs2.astype(np.float32)
    lbs2[0] = np.inf
    lbs2[4, :chunk] = np.inf       # query 4: padding ahead of real rows
    pool = _seed(rng, b, k, d_all.astype(np.float32))
    return data, sids, anchors, n_master, lbs2, qs, pool, g, n_pad // chunk


@pytest.mark.parametrize("znorm", [False, True], ids=["raw", "znorm"])
@pytest.mark.parametrize("k,chunk", [(1, 13), (5, 13), (5, 64), (64, 13),
                                     (500, 24)])
def test_ed_chunk_step_matches_reference(znorm, k, chunk):
    """Every chunk of a plan through the port's ED chunk step (the chunk
    entry's plain version and the partials merge) and through the JAX
    package's `_scan_chunk_step` (its Pallas kernel in interpret mode and
    its lax.top_k merge): the same pool bit for bit, ties and +inf rows
    included, and the same counter increments, including a query that is
    never active and chunks in which no query is."""
    data, sids, anchors, n_master, lbs2, qs, pool, g, n_chunks = \
        _chunk_inputs(znorm, k, chunk, seed=k + chunk + znorm)
    jc = JCollection.from_array(data)
    coll = Collection.from_array(data, device="cpu")
    jplan = tuple(jnp.asarray(x) for x in (sids, anchors, n_master, lbs2,
                                           qs))
    tplan = tuple(torch.from_numpy(x) for x in (sids, anchors, n_master,
                                                lbs2, qs))
    jpool = _jax_pool(pool)
    tpool = [torch.from_numpy(x.copy()) for x in pool]
    stats = torch.zeros((len(qs), executor.STATS_WIDTH), dtype=torch.int32)
    for i in range(n_chunks):
        first = jnp.asarray(lbs2[:, min(i * chunk, lbs2.shape[1] - 1)])
        kth = jpool[0][:, k - 1]
        active = jnp.isfinite(first) & (first < kth)
        jpool, dst = jexecutor._scan_chunk_step(
            jc.data, jc.csum, jc.csum2, jc.csum_lo, jc.csum2_lo, jc.center,
            *jplan[:4], jplan[4], jplan[4], jplan[4], i, jpool, kth, active,
            k=k, g=g, chunk=chunk, znorm=znorm, measure="ed", r=0, sb=128,
            interpret=True)
        before = stats.clone()
        executor._scan_chunk_step(coll, *tplan, tplan[4], tplan[4], i,
                                  tpool, stats, k=k, g=g, chunk=chunk,
                                  znorm=znorm, measure="ed", r=0)
        for x, y in zip(tpool, jpool):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y),
                                          err_msg=f"chunk {i}")
        np.testing.assert_array_equal((stats - before).numpy(),
                                      np.asarray(dst), err_msg=f"chunk {i}")
    st = stats.numpy()
    assert st[0].sum() == 0                       # never active
    assert st[:, 2].sum() > 0
    if k == 500:
        assert np.isinf(tpool[0][1, -1])          # +inf rows stay
    else:
        assert st[:, 5].sum() > 0                 # the bsf cut prunes


def test_ed_chunk_entry_plain_version_counts_and_masks():
    """The chunk entry's CPU path: partials are every candidate in
    position order (+inf where not ok), the counters are added in place,
    and an inactive query adds nothing."""
    data, sids, anchors, n_master, lbs2, qs, pool, g, _ = _chunk_inputs(
        False, 5, 13, seed=3)
    coll = Collection.from_array(data, device="cpu")
    t = [torch.from_numpy(x) for x in (sids, anchors, n_master, lbs2, qs,
                                       pool[0])]
    stats = torch.zeros((len(qs), 6), dtype=torch.int32)
    part = fused_gather_ed_chunk(coll.data, coll.csum, coll.csum2,
                                 coll.csum_lo, coll.csum2_lo, coll.center,
                                 *t, stats, i=1, chunk=13, g=g, znorm=False)
    assert part.shape == (4, len(qs), 13 * g)
    d2 = part[0].view(torch.float32)
    assert torch.equal(part[3][0], torch.arange(13 * g, dtype=torch.int32))
    assert torch.isinf(d2[0]).all() and int(stats[0].sum()) == 0
    # ok candidates are the finite ones, and counted
    assert torch.equal(torch.isfinite(d2).sum(1, dtype=torch.int32),
                       stats[:, 2])
    assert torch.equal(part[1].reshape(len(qs), 13, g)[:, :, 0],
                       t[0][:, 13:26])
    with pytest.raises(ValueError):
        fused_gather_ed_chunk(coll.data, coll.csum, coll.csum2,
                              coll.csum_lo, coll.csum2_lo, coll.center, *t,
                              stats, i=4, chunk=13, g=g, znorm=False)


@pytest.mark.parametrize("znorm", [False, True], ids=["raw", "znorm"])
def test_ed_chunk_step_all_inactive_leaves_pool_unchanged(znorm):
    """A chunk in which no query is active (every first bound at or above
    its pool's k-th distance): both steps leave the pool as it was and
    add no counter."""
    data, sids, anchors, n_master, lbs2, qs, pool, g, _ = _chunk_inputs(
        znorm, 5, 13, seed=11)
    d2 = np.sort(np.random.default_rng(1).random((len(qs), 5)), axis=1)
    pool = (d2.astype(np.float32), pool[1], pool[2])
    lbs2 = np.maximum(lbs2, np.float32(1.0))      # >= every pool's k-th
    jc = JCollection.from_array(data)
    coll = Collection.from_array(data, device="cpu")
    jpool = _jax_pool(pool)
    kth = jpool[0][:, -1]
    first = jnp.asarray(lbs2[:, 13])
    active = jnp.isfinite(first) & (first < kth)
    assert not bool(active.any())
    jpool, dst = jexecutor._scan_chunk_step(
        jc.data, jc.csum, jc.csum2, jc.csum_lo, jc.csum2_lo, jc.center,
        *(jnp.asarray(x) for x in (sids, anchors, n_master, lbs2)),
        jnp.asarray(qs), jnp.asarray(qs), jnp.asarray(qs), 1, jpool, kth,
        active, k=5, g=g, chunk=13, znorm=znorm, measure="ed", r=0, sb=128,
        interpret=True)
    tpool = [torch.from_numpy(x.copy()) for x in pool]
    stats = torch.zeros((len(qs), executor.STATS_WIDTH), dtype=torch.int32)
    q = torch.from_numpy(qs)
    executor._scan_chunk_step(
        coll, *(torch.from_numpy(x) for x in (sids, anchors, n_master,
                                              lbs2)),
        q, q, q, 1, tpool, stats, k=5, g=g, chunk=13, znorm=znorm,
        measure="ed", r=0)
    for x, y, z in zip(tpool, jpool, pool):
        np.testing.assert_array_equal(x.numpy(), z)
        np.testing.assert_array_equal(np.asarray(y), z)
    assert int(stats.abs().sum()) == 0 and int(np.abs(dst).sum()) == 0
