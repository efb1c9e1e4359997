"""Port parity, the sharded k-NN search: `UlisseEngine.distributed` of
`repro_torch` in gloo worlds of 1, 2 and 4 ranks (on the CPU, the
kernels' plain versions) against the JAX package's
`UlisseEngine.distributed` on meshes of 1, 2 and 4 forced host devices
(a subprocess, as its own distributed tests run), on the same numpy
inputs and breakpoints:

  * the k-NN half of the reference's matrix
    (tests/test_distributed_scan.py:28-100): shards {1, 2, 4} x znorm/raw
    x ED/DTW (r 3), three noisy windows (N(0, 0.02), ROADMAP P3) of two
    lengths at max_batch 4 — identical answers in the same order and
    every SearchStats counter, shard_chunks included; ED distances within
    1e-9 (both rescore in float64), DTW within rtol 1e-4 / atol 1e-5 (the
    reference's float32 closed-form DP cancels near matches, F4); the
    answers equal to the port's local engine's; every rank's answers
    identical;
  * the pruning property of :102-150: sharing the mesh-wide k-th every
    chunk (sync_every 1) visits no more chunks a shard than the local
    scan visits in all, and never more than sharing it every 64 chunks;
    more rounds at sync_every 1;
  * approximate mode (:155-195): max_leaves 64 certifies the exact
    answer, max_leaves 1 never claims exactness falsely, both equal to
    the reference's (the certificate included).

The range half of the matrix is in tests/test_torch_distributed_range.py;
the host backend, the collectives and the shard's pieces are in
tests/test_torch_distributed.py.  The worlds start
once per size (tests/torch_worlds.py); the reference runs alongside.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import torch_worlds  # noqa: E402
from repro.core import EnvelopeParams as JParams  # noqa: E402
from repro.core.index import default_breakpoints  # noqa: E402
from repro_torch.core import (Collection, EnvelopeParams,  # noqa: E402
                              QuerySpec, UlisseEngine)

PARAMS = dict(lmin=32, lmax=48, gamma=4, seg_len=8, card=64)
WORLDS = (1, 2, 4)
MEASURES = (("ed", 0), ("dtw", 3))
ZNORMS = (True, False)


def _noisy(rng, data, at):
    return [data[s, o:o + l] + rng.normal(size=l).astype(np.float32) * .02
            for s, o, l in at]


def _bp(data, znorm):
    """The reference's default breakpoints, given to both sides (raw
    mode calibrates them in float32; the port's own may differ by an
    ulp, which would move a bound)."""
    return np.asarray(default_breakpoints(JParams(znorm=znorm, **PARAMS),
                                          jnp.asarray(data)))


def _inputs():
    rng = np.random.default_rng(7)
    data = np.cumsum(rng.normal(size=(16, 96)), -1).astype(np.float32)
    qs = _noisy(rng, data, ((1, 5, 40), (9, 11, 40), (4, 40, 48)))
    # the pruning workload: shard 0 of 4 holds near-copies of the query,
    # the other shards structurally different series
    rng = np.random.default_rng(3)
    base = np.sin(np.arange(128, dtype=np.float32) / 7).astype(np.float32)
    prune = np.stack([np.cumsum(rng.normal(size=128)).astype(np.float32) * 3
                      for _ in range(16)])
    for s in range(4):
        prune[s] = base + rng.normal(size=128).astype(np.float32) * .01
    pq = base[20:60] + rng.normal(size=40).astype(np.float32) * .005
    rng = np.random.default_rng(5)
    adata = np.cumsum(rng.normal(size=(16, 96)), -1).astype(np.float32)
    aqs = _noisy(rng, adata, ((1, 5, 40), (4, 40, 48)))
    return data, qs, prune, pq, adata, aqs


def _job():
    data, qs, prune, pq, adata, aqs = _inputs()
    job = []
    for world in WORLDS:
        engines, cases = {}, {}
        for z in ZNORMS:
            engines[f"z{z}"] = (data, dict(PARAMS, znorm=z), _bp(data, z), 4)
            for m, r in MEASURES:
                cases[f"knn-{z}-{m}"] = (f"z{z}", qs, dict(
                    k=5, measure=m, r=r, chunk_size=16))
        if world == 4:
            engines["prune"] = (prune, dict(PARAMS, znorm=True),
                                _bp(prune, True), 4)
            for every in (1, 64):
                cases[f"sync-{every}"] = ("prune", pq, dict(
                    k=3, chunk_size=8, sync_every=every))
            engines["approx"] = (adata, dict(PARAMS, znorm=True),
                                 _bp(adata, True), 4)
            cases["exact"] = ("approx", aqs, dict(k=3, chunk_size=16))
            for leaves in (64, 1):
                cases[f"approx-{leaves}"] = ("approx", aqs[0], dict(
                    k=3, mode="approx", chunk_size=16, max_leaves=leaves))
        job.append((world, engines, cases))
    return job


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(job, port {world: [rank results]}, reference arrays): the
    reference's subprocess runs while the port's worlds do."""
    job = _job()
    proc, path = torch_worlds.start_reference(
        job, str(tmp_path_factory.mktemp("reference")))
    try:
        port = {world: torch_worlds.run_world(
            world, torch_worlds.engine_matrix_job, engines, cases)
            for world, engines, cases in job}
    except BaseException:
        proc.kill()
        raise
    return job, port, torch_worlds.reference_results(proc, path)


_results = torch_worlds.results
_stat = torch_worlds.stat
_same = torch_worlds.assert_same


@pytest.mark.parametrize("measure,r", MEASURES)
@pytest.mark.parametrize("znorm", ZNORMS, ids=["znorm", "raw"])
@pytest.mark.parametrize("world", WORLDS)
def test_knn_matrix_equals_reference(runs, world, znorm, measure, r):
    _, port, ref = runs
    case = f"knn-{znorm}-{measure}"
    got = _results(port[world][0][0], world, case)
    _same(got, _results(ref, world, case), measure, f"{world} {case}")
    assert all(len(x["shard_chunks"]) == world for x in got)


@pytest.mark.parametrize("measure,r", MEASURES)
@pytest.mark.parametrize("znorm", ZNORMS, ids=["znorm", "raw"])
@pytest.mark.parametrize("world", WORLDS)
def test_knn_matrix_equals_local_engine(runs, world, znorm, measure, r):
    """The sharded answers are the local engine's (its own approximate
    pass and scan; the same breakpoints)."""
    _, port, _ = runs
    data, qs = _inputs()[:2]
    local = UlisseEngine.from_collection(
        Collection.from_array(data, device="cpu"),
        EnvelopeParams(znorm=znorm, **PARAMS),
        breakpoints=torch.tensor(_bp(data, znorm)), device="cpu")
    want = local.search(qs, QuerySpec(k=5, measure=measure, r=r,
                                      chunk_size=16))
    got = _results(port[world][0][0], world, f"knn-{znorm}-{measure}")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["series"], b.series)
        np.testing.assert_array_equal(a["offsets"], b.offsets)
        np.testing.assert_allclose(a["dists"], b.dists, rtol=0,
                                   atol=1e-9 if measure == "ed" else 1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_returns_the_same(runs, world):
    _, port, _ = runs
    first = port[world][0]
    for other in port[world][1:]:
        assert other[1] == first[1]
        assert other[0].keys() == first[0].keys()
        for key, v in first[0].items():
            np.testing.assert_array_equal(other[0][key], v, err_msg=key)


def test_global_bsf_prunes_sharded_scan(runs):
    """Sharing the mesh-wide k-th every chunk lets the far shards prune:
    no shard scans deeper than the local single-device scan had to, the
    sharing never adds chunks, and the counters are the reference's."""
    _, port, ref = runs
    arrays, rounds, _ = port[4][0]
    on = _results(arrays, 4, "sync-1")[0]
    off = _results(arrays, 4, "sync-64")[0]
    for case, res in (("sync-1", on), ("sync-64", off)):
        _same([res], _results(ref, 4, case), "ed", case)
    prune, pq = _inputs()[2:4]
    local = UlisseEngine.from_collection(
        Collection.from_array(prune, device="cpu"),
        EnvelopeParams(znorm=True, **PARAMS),
        breakpoints=torch.tensor(_bp(prune, True)), device="cpu")
    want = local.search(pq, QuerySpec(k=3, chunk_size=8, approx_first=False))
    assert max(on["shard_chunks"]) <= want.stats.chunks_visited
    assert _stat(on, "chunks_visited") <= _stat(off, "chunks_visited")
    assert _stat(on, "envelopes_checked") < _stat(on, "envelopes_total")
    np.testing.assert_allclose(on["dists"], off["dists"], atol=1e-9)
    np.testing.assert_allclose(on["dists"], want.dists, atol=1e-9)
    assert rounds["sync-1"] >= rounds["sync-64"] >= 1


def test_approx_mode_and_certificate(runs):
    """The budget-capped sharded scan: a generous budget covers every
    chunk and certifies the exact answer; a one-chunk budget claims
    exactness only where it holds; all as the reference answers."""
    _, port, ref = runs
    arrays = port[4][0][0]
    for case in ("exact", "approx-64", "approx-1"):
        _same(_results(arrays, 4, case), _results(ref, 4, case), "ed", case)
    exact = _results(arrays, 4, "exact")[0]
    wide = _results(arrays, 4, "approx-64")[0]
    assert _stat(wide, "exact_from_approx") == 1
    np.testing.assert_array_equal(wide["series"], exact["series"])
    np.testing.assert_allclose(wide["dists"], exact["dists"], atol=1e-9)
    one = _results(arrays, 4, "approx-1")[0]
    assert max(one["shard_chunks"]) <= 1
    if _stat(one, "exact_from_approx"):
        np.testing.assert_allclose(one["dists"], exact["dists"], atol=1e-9)
    else:
        assert one["dists"][-1] >= exact["dists"][-1]
