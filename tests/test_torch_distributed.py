"""Port parity, the distributed backend's pieces and its range and host
searches: `repro_torch.distributed` against the JAX package's
`repro.distributed` on the same numpy inputs.

In process (the plain versions, bit for bit unless said):
  * `executor.shard_pack_geometry` and `planner.device_shard_pack`
    (n_delta 0 and > 0: the delta-first pack with pinned chunk heads);
  * `build_host_index`: the prefix sums and the envelopes' ids, anchors,
    masters, valid flags and symbols bit-equal to the reference's, the
    PAA bounds within rtol 1e-5 / atol 1e-5 (the port's own build, as
    test_torch_types_index holds it), and a block's build bit-equal to
    the same rows of a build over every series;
  * `distributed_index_stats`, `decode_id`;
  * the k-NN chunk step with the mesh-wide k-th (`gkth`) against the
    reference's `_scan_chunk_step(..., kth=min(pool k-th, gkth),
    active)` on exact inputs (see test_torch_merge): ED pools and
    counters bit for bit; DTW counters and (sid, off) equal, d2 within
    rtol 1e-5 (the reference's closed-form DP).

In gloo worlds of 2 and 4 ranks (tests/torch_worlds.py, one start a
size), against the reference in subprocesses on 4 forced host devices:
  * every collective (`topk_merge`, `bsf_allreduce`, `global_kth`,
    `allgather_topk_merge`, `ring_topk_merge`) in a world of 4 against
    the reference's inside a `shard_map`, bit for bit, with ties across
    shards (the ring's replicated output is shard 0's accumulation);
  * the host backend (verify_top 2, so it escalates) in worlds of 2 and
    4: the reference's answers and `escalations` / `envelopes_checked`,
    distances within 5e-3 of the reference's and of a brute force;
  * the engine's surface: a non-divisible S ("not divisible") and
    series shorter than lmax refused, the default device refused without
    CUDA, the shard's rows and local ids, `raw_data`, the write surface
    (a part that does not divide refused, validate_append, append, save,
    `open(path, mesh=...)`, compact), warmup.
The k-NN and range halves of the reference's engine matrix are in
tests/test_torch_distributed_scan.py and test_torch_distributed_range.py.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_worlds  # noqa: E402
from repro.core import Collection as JCollection  # noqa: E402
from repro.core import EnvelopeParams as JParams  # noqa: E402
from repro.core import dtw as jdtw  # noqa: E402
from repro.core import executor as jexecutor  # noqa: E402
from repro.core import planner as jplanner  # noqa: E402
from repro.core.index import default_breakpoints  # noqa: E402
from repro.distributed import ulisse as julisse  # noqa: E402
from repro_torch.core import (Collection, EnvelopeParams,  # noqa: E402
                              executor, planner)
from repro_torch.core.search import brute_force_knn  # noqa: E402
from repro_torch.distributed import ulisse  # noqa: E402

PARAMS = dict(lmin=32, lmax=48, gamma=4, seg_len=8, card=64)
HOST_WORLDS = (2, 4)
ZNORMS = (True, False)


# -- in process: geometry, pack, build ----------------------------------------

@pytest.mark.parametrize("n_rows,delta_rows,chunk_size", [
    (100, 0, 16), (100, 0, 512), (1, 0, 4), (288, 37, 16), (288, 5, 64),
    (1000, 200, 100)])
def test_shard_pack_geometry_equals_reference(n_rows, delta_rows,
                                              chunk_size):
    assert executor.shard_pack_geometry(n_rows, delta_rows, chunk_size) == \
        jexecutor.shard_pack_geometry(n_rows, delta_rows, chunk_size)


@pytest.mark.parametrize("n_delta", [0, 5, 37])
def test_device_shard_pack_equals_reference(n_delta):
    """Ties (bounds on a coarse grid), +inf (invalid) rows in the main
    and the delta region, the delta's pinned chunk heads and zeroed
    masters."""
    rng = np.random.default_rng(n_delta)
    b, n = 3, 120
    lbs = (rng.integers(0, 9, (b, n)) * 0.5).astype(np.float32)
    lbs[rng.random((b, n)) < 0.15] = np.inf
    sid = rng.integers(0, 30, n).astype(np.int32)
    anc = rng.integers(0, 50, n).astype(np.int32)
    nm = rng.integers(1, 5, n).astype(np.int32)
    n_pad, chunk, _ = executor.shard_pack_geometry(n, n_delta, 16)
    want = jplanner.device_shard_pack(
        jnp.asarray(sid), jnp.asarray(anc), jnp.asarray(nm), jnp.asarray(lbs),
        n_pad=n_pad, n_delta=n_delta, chunk=chunk)
    got = planner.device_shard_pack(
        torch.from_numpy(sid), torch.from_numpy(anc), torch.from_numpy(nm),
        torch.from_numpy(lbs), n_pad=n_pad, n_delta=n_delta, chunk=chunk)
    for x, y in zip(got, want):
        assert x.numpy().dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def _walk(seed, s=16, n=96):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.normal(size=(s, n)), -1).astype(np.float32)


@pytest.mark.parametrize("znorm", ZNORMS, ids=["znorm", "raw"])
def test_build_host_index_against_reference(znorm):
    data = _walk(7)
    jp = JParams(znorm=znorm, **PARAMS)
    p = EnvelopeParams(znorm=znorm, **PARAMS)
    bp = np.asarray(default_breakpoints(jp, jnp.asarray(data)))
    got = ulisse.build_host_index(p, bp, data)
    want = julisse.build_host_index(jp, jnp.asarray(bp), data)
    assert set(got) == set(want) == set(ulisse.INDEX_SECTION_FIELDS)
    for f in ulisse.INDEX_SECTION_FIELDS:
        assert got[f].dtype == want[f].dtype, f
        if f in ("paa_lo", "paa_hi"):
            np.testing.assert_allclose(got[f], want[f], rtol=1e-5,
                                       atol=1e-5, err_msg=f)
        else:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    # a block's build is the same rows of the whole build, bit for bit
    n_env = p.num_envelopes(data.shape[1])
    block = ulisse.build_host_index(p, bp, data[4:8])
    for f in ulisse.INDEX_SECTION_FIELDS:
        rows = slice(4, 8) if f in ulisse.SHARDED_INDEX_FIELDS[1:6] \
            else slice(4 * n_env, 8 * n_env)
        whole = got[f][rows] - (4 if f == "series_id" else 0)
        np.testing.assert_array_equal(block[f], whole, err_msg=f)


def test_distributed_index_stats_and_decode_id():
    p = EnvelopeParams(**PARAMS)
    mesh = jax.make_mesh((1,), ("data",))
    for delta in (0, 7):
        assert ulisse.distributed_index_stats(1, p, 16, 96, delta) == \
            julisse.distributed_index_stats(mesh, JParams(**PARAMS), 16, 96,
                                            delta)
    four = ulisse.distributed_index_stats(4, p, 16, 96)
    assert four["envelopes_per_device"] == -(-four["envelopes_total"] // 4)
    assert four["query_wire_bytes"] == 4 * 16
    code = np.arange(12).reshape(2, 3, 2)
    for x, y in zip(ulisse.decode_id(code), julisse.decode_id(code)):
        np.testing.assert_array_equal(x, y)


# -- in process: the chunk step with the mesh-wide k-th ----------------------

def _exact_inputs(znorm, seed, k, chunk, s=6, n=64, qlen=32, g=9, b=5):
    """Series whose windows' statistics are exact in float32 (see
    test_torch_merge), a 3-chunk LB-sorted plan (query 0 all padding),
    integer queries and a seed pool tied with candidate distances."""
    rng = np.random.default_rng(seed)
    if znorm:
        pats = np.array([[1, 1, -1, -1], [1, -1, 1, -1], [1, -1, -1, 1],
                         [-1, 1, 1, -1]], np.float32)
        data = np.stack([np.tile(pats[rng.integers(4)], n // 4)
                         * rng.integers(1, 3) for _ in range(s)])
    else:
        half = rng.integers(-3, 4, (s, n // 2))
        data = rng.permuted(np.concatenate([half, -half], 1), axis=1)
    data = data.astype(np.float32)
    n_pad = 3 * chunk
    sids = rng.integers(0, s, (b, n_pad)).astype(np.int32)
    anchors = (rng.integers(0, 4, (b, n_pad)) * g).astype(np.int32)
    n_master = rng.integers(0, g + 1, (b, n_pad)).astype(np.int32)
    qs = rng.integers(-2, 3, (b, qlen)).astype(np.float32)
    lbs2 = np.sort(rng.random((b, n_pad)), axis=1).astype(np.float32) * 60
    lbs2[0] = np.inf
    d2 = np.full((b, k), np.inf, np.float32)
    psid = np.full((b, k), -1, np.int32)
    m = k // 2
    d2[:, :m] = np.sort(rng.integers(0, 80, (b, m)), axis=1)
    psid[:, :m] = 1000 + np.arange(m)
    # gkth below the pool's k-th (query 1 and 3), +inf (query 2), at it
    gkth = np.array([5, 20, np.inf, 3, 40], np.float32)
    return data, sids, anchors, n_master, lbs2, qs, (d2, psid, psid.copy()), \
        gkth, g


@pytest.mark.parametrize("measure", ["ed", "dtw"])
@pytest.mark.parametrize("znorm", [False, True], ids=["raw", "znorm"])
@pytest.mark.parametrize("k,chunk", [(5, 13), (64, 24)])
def test_chunk_step_with_gkth_matches_reference(measure, znorm, k, chunk):
    """Every chunk of a plan through the port's step with `gkth` (the
    chunk entries' plain versions and the merges) and through the
    reference's `_scan_chunk_step` at kth = min(pool k-th, gkth): the
    same pool and counters after every chunk."""
    (data, sids, anchors, n_master, lbs2, qs, pool, gkth,
     g) = _exact_inputs(znorm, k + chunk + znorm, k, chunk)
    r = 2
    jc = JCollection.from_array(data)
    coll = Collection.from_array(data, device="cpu")
    if measure == "dtw":
        lo, hi = (np.asarray(x) for x in jdtw.dtw_envelope(jnp.asarray(qs),
                                                           r))
    else:
        lo = hi = qs
    jpool = tuple(jnp.asarray(x) for x in pool)
    tpool = [torch.from_numpy(x.copy()) for x in pool]
    stats = torch.zeros((len(qs), executor.STATS_WIDTH), dtype=torch.int32)
    tplan = [torch.from_numpy(x) for x in (sids, anchors, n_master, lbs2, qs,
                                           lo, hi)]
    for i in range(3):
        first = jnp.asarray(lbs2[:, i * chunk])
        kth = jnp.minimum(jpool[0][:, k - 1], jnp.asarray(gkth))
        active = jnp.isfinite(first) & (first < kth)
        jpool, dst = jexecutor._scan_chunk_step(
            jc.data, jc.csum, jc.csum2, jc.csum_lo, jc.csum2_lo, jc.center,
            *(jnp.asarray(x) for x in (sids, anchors, n_master, lbs2, qs, lo,
                                       hi)),
            i, jpool, kth, active, k=k, g=g, chunk=chunk, znorm=znorm,
            measure=measure, r=r, sb=128, interpret=True)
        before = stats.clone()
        executor._scan_chunk_step(coll, *tplan, i, tpool, stats, k=k, g=g,
                                  chunk=chunk, znorm=znorm, measure=measure,
                                  r=r, gkth=torch.from_numpy(gkth))
        np.testing.assert_array_equal((stats - before).numpy(),
                                      np.asarray(dst), err_msg=f"chunk {i}")
        for j, (x, y) in enumerate(zip(tpool, jpool)):
            if j == 0 and measure == "dtw":
                np.testing.assert_allclose(x.numpy(), np.asarray(y),
                                           rtol=1e-5, err_msg=f"chunk {i}")
            else:
                np.testing.assert_array_equal(x.numpy(), np.asarray(y),
                                              err_msg=f"chunk {i}")
    st = stats.numpy()
    assert st[0].sum() == 0 and st[1:, 0].sum() > 0
    assert st[:, 5].sum() > 0          # the min(kth, gkth) cut prunes


def test_gkth_inf_is_the_local_step():
    """gkth = +inf everywhere leaves the step what it is without it."""
    (data, sids, anchors, n_master, lbs2, qs, pool, _,
     g) = _exact_inputs(False, 3, 5, 13)
    coll = Collection.from_array(data, device="cpu")
    plan = [torch.from_numpy(x) for x in (sids, anchors, n_master, lbs2, qs,
                                          qs, qs)]
    out = []
    for gkth in (None, torch.full((len(qs),), float("inf"))):
        tpool = [torch.from_numpy(x.copy()) for x in pool]
        stats = torch.zeros((len(qs), 6), dtype=torch.int32)
        for i in range(3):
            executor._scan_chunk_step(coll, *plan, i, tpool, stats, k=5, g=g,
                                      chunk=13, znorm=False, measure="ed",
                                      r=0, gkth=gkth)
        out.append((tpool, stats))
    for x, y in zip(out[0][0] + [out[0][1]], out[1][0] + [out[1][1]]):
        assert torch.equal(x, y)


# -- worlds: the collectives, the range matrix, the host backend -------------

# the reference's collectives inside a shard_map on 4 forced host devices;
# argv[1] the inputs' .npz, argv[2] the outputs'
COLLECTIVES = textwrap.dedent("""
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.distributed import collectives as C
    from repro.distributed.compat import shard_map
    z = dict(np.load(sys.argv[1]))
    k = int(z.pop("k"))

    def f(d2, sid, off, bsf, ids):
        d2, sid, off, bsf, ids = d2[0], sid[0], off[0], bsf[0], ids[0]
        td, ti = C.topk_merge(d2[0], ids, k, "data")
        return (td, ti, C.bsf_allreduce(bsf, "data"),
                C.global_kth(d2, k, "data"),
                *C.allgather_topk_merge(d2, sid, off, k, "data"),
                *C.ring_topk_merge(d2, sid, off, k, "data", 4))

    mesh = jax.make_mesh((4,), ("data",))
    out = jax.jit(shard_map(f, mesh=mesh, in_specs=(P("data"),) * 5,
                            out_specs=(P(),) * 10, check=False))(
        *(jnp.asarray(z[n]) for n in ("d2", "sid", "off", "bsf", "ids")))
    np.savez(sys.argv[2], *[np.asarray(x) for x in out])
""")

COLLECTIVE_OUTS = ("topk_merge", 2), ("bsf_allreduce", 1), \
    ("global_kth", 1), ("allgather_topk_merge", 3), ("ring_topk_merge", 3)


def _collective_inputs(k=4, b=3):
    """Four ranks' ascending (B, k) pools on a coarse grid: equal d2
    within and across ranks, +inf filler; disjoint (sid, off)."""
    rng = np.random.default_rng(11)
    d2 = np.sort(rng.integers(0, 5, (4, b, k)).astype(np.float32), axis=-1)
    d2[1, 0, -2:] = np.inf
    d2[3, 2, :] = np.inf
    sid = (np.arange(4)[:, None, None] * 1000
           + np.arange(b * k).reshape(1, b, k)).astype(np.int32)
    off = (sid % 97).astype(np.int32)
    bsf = np.array([3.5, 1.25, 1.25, 7.0], np.float32)
    ids = sid[:, 0, :].copy()
    return d2, sid, off, bsf, ids, k


def _inputs():
    data = _walk(7)
    rng = np.random.default_rng(7)
    rng.normal(size=(16, 96))
    qs = [data[s, o:o + l] + rng.normal(size=l).astype(np.float32) * .02
          for s, o, l in ((1, 5, 40), (9, 11, 40), (4, 40, 48))]
    bps = {z: np.asarray(default_breakpoints(JParams(znorm=z, **PARAMS),
                                             jnp.asarray(data)))
           for z in ZNORMS}
    return data, qs, bps


def _job():
    data, qs, bps = _inputs()
    job = []
    for world in HOST_WORLDS:
        engines = {f"z{z}": (data, dict(PARAMS, znorm=z), bps[z], 4)
                   for z in ZNORMS}
        cases = {f"host-{z}": (f"z{z}", qs, dict(
            k=5, scan_backend="host", verify_top=2)) for z in ZNORMS}
        job.append((world, engines, cases))
    return job


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(job, port {world: [rank results]}, reference arrays, reference
    collectives): the reference's subprocesses run while the port's
    worlds do."""
    job = _job()
    tmp = str(tmp_path_factory.mktemp("reference"))
    d2, sid, off, bsf, ids, k = _collective_inputs()
    np.savez(os.path.join(tmp, "coll_in.npz"), d2=d2, sid=sid, off=off,
             bsf=bsf, ids=ids, k=k)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    coll = subprocess.Popen(
        [sys.executable, "-c", COLLECTIVES, os.path.join(tmp, "coll_in.npz"),
         os.path.join(tmp, "coll_out.npz")],
        env=dict(os.environ, JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=4",
                 PYTHONPATH=os.path.join(root, "src")),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    proc, path = torch_worlds.start_reference(job, tmp)
    data, _, bps = _inputs()
    try:
        port = {}
        for world, engines, cases in job:
            jobs = [(torch_worlds.engine_matrix_job, (engines, cases))]
            if world == 4:
                jobs += [(torch_worlds.collectives_job,
                          (d2, sid, off, bsf, ids, k)),
                         (torch_worlds.engine_basics_job,
                          (data, dict(PARAMS, znorm=True), bps[True],
                           os.path.join(tmp, "basics")))]
            port[world] = torch_worlds.run_world(
                world, torch_worlds.multi_job, jobs)
    except BaseException:
        proc.kill()
        coll.kill()
        raise
    ref = torch_worlds.reference_results(proc, path)
    _, err = coll.communicate(timeout=120)
    assert coll.returncode == 0, err[-4000:]
    with np.load(os.path.join(tmp, "coll_out.npz")) as z:
        ref_coll = [z[f"arr_{i}"] for i in range(len(z.files))]
    return job, port, ref, ref_coll


def test_collectives_match_reference_shard_map(runs):
    """A world of 4 against the reference inside a shard_map: every
    collective bit for bit on every rank, ties across ranks broken as
    lax.top_k breaks them, the ring's result shard 0's accumulation."""
    _, port, _, ref_coll = runs
    want = iter(ref_coll)
    expect = {name: [next(want) for _ in range(n)]
              for name, n in COLLECTIVE_OUTS}
    for rank, res in enumerate(port[4]):
        got = res[1]
        assert got["world"] == (4, rank)
        for name, n in COLLECTIVE_OUTS:
            vals = got[name] if n > 1 else (got[name],)
            for x, y in zip(vals, expect[name]):
                np.testing.assert_array_equal(x, y, err_msg=name)
        assert [len(x) for x in got["all_gather_rows"]] == [0, 1, 2, 3]
        np.testing.assert_array_equal(got["all_gather_rows"][3],
                                      np.arange(9.0).reshape(3, 3))


def test_ring_merge_differs_from_allgather_on_ties(runs):
    """The inputs tie across ranks where the two merge orders disagree:
    the ring replay is not the all-gather merge in disguise."""
    _, port, _, _ = runs
    got = port[4][0][1]
    assert not np.array_equal(got["ring_topk_merge"][1],
                              got["allgather_topk_merge"][1])
    np.testing.assert_array_equal(got["ring_topk_merge"][0],
                                  got["allgather_topk_merge"][0])


@pytest.mark.parametrize("znorm", ZNORMS, ids=["znorm", "raw"])
@pytest.mark.parametrize("world", HOST_WORLDS)
def test_host_backend_equals_reference(runs, world, znorm):
    """The unpruned per-shard verify at verify_top 2 escalates as the
    reference's does; float32 distances (F1 class) within 5e-3 of the
    reference's and of a brute force."""
    _, port, ref, _ = runs
    case = f"host-{znorm}"
    got = torch_worlds.results(port[world][0][0][0], world, case)
    torch_worlds.assert_same(got, torch_worlds.results(ref, world, case),
                             "ed", case, dist_atol=5e-3)
    assert max(torch_worlds.stat(x, "escalations") for x in got) >= 1
    data, qs, _ = _inputs()
    coll = Collection.from_array(data, device="cpu")
    for res, q in zip(got, qs):
        oracle = brute_force_knn(coll, q, k=5, znorm=znorm)
        np.testing.assert_allclose(res["dists"], oracle.dists, atol=5e-3)


def test_every_rank_returns_the_same(runs):
    _, port, _, _ = runs
    for world in HOST_WORLDS:
        first = port[world][0][0]
        for other in port[world][1:]:
            assert other[0][0].keys() == first[0].keys()
            for key, v in first[0].items():
                np.testing.assert_array_equal(other[0][0][key], v,
                                              err_msg=key)


def test_engine_surface(runs):
    """Refusals first, the shard's rows and local ids, raw_data's
    all-gather, the write surface (validate_append, append, save, open
    on the group, compact), warmup."""
    _, port, _, _ = runs
    data = _inputs()[0]
    p = EnvelopeParams(znorm=True, **PARAMS)
    n_env = p.num_envelopes(data.shape[1])
    for rank, res in enumerate(port[4]):
        got = res[2]
        assert "not divisible" in got["divisible"]
        assert "series shorter than lmax" in got["lmax"]
        if "default_device" in got:
            assert "CUDA" in got["default_device"]
        r, shards, row0, rows, env = got["shard"]
        assert (r, shards, row0) == (rank, 4, rank * 4)
        np.testing.assert_array_equal(rows, data[row0:row0 + 4])
        np.testing.assert_array_equal(
            env["series_id"], np.repeat(np.arange(4), n_env))
        assert got["flags"] == (True, True, 0, "cpu", None)
        np.testing.assert_array_equal(got["raw_data"], data)
        # the write surface works on a world of 4: a part of 5 refused in
        # the reference's words, one of 4 appended, saved, opened on the
        # group (the delta kept), compacted
        w = got["writes"]
        assert "not divisible by the 4-shard mesh" in w["refused"]
        assert w["validate_append"] == 4
        grown = np.concatenate([data, data[:4]])
        for key, delta in (("appended", 4 * n_env), ("opened", 4 * n_env),
                           ("compacted", 0)):
            assert w[key][0] == delta, key
            np.testing.assert_array_equal(w[key][1], grown, err_msg=key)
        assert got["warmup"] == 4
