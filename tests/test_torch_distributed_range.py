"""Port parity, the sharded eps-range search: `UlisseEngine.distributed`
of `repro_torch` in gloo worlds of 1, 2 and 4 ranks (on the CPU, the
kernels' plain versions) against the JAX package's
`UlisseEngine.distributed` on meshes of 1, 2 and 4 forced host devices
(a subprocess), on the same numpy inputs and breakpoints: the range half
of the reference's matrix (tests/test_distributed_scan.py:28-100),
shards {1, 2, 4} x znorm/raw x ED/DTW (r 3) x capacity 2,048 and 2
(every shard whose hits exceed 2 finishes on its owner's host), eps the
local engine's third neighbour of the query + 1e-3, and eps 1e4 at
capacity 2 (every shard overflows: range_overflows == 4, the union is
every window of the length).  Required: the same hits in the same order
and every SearchStats counter, shard_chunks included; ED distances
within 1e-9, DTW rtol 1e-4 / atol 1e-5 (ROADMAP F4); the port's local
engine's hit sets; every rank's answers identical.  Queries are noisy
windows (N(0, 0.02), ROADMAP P3).
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
CAPS = (2048, 2)


def _inputs():
    rng = np.random.default_rng(7)
    data = np.cumsum(rng.normal(size=(16, 96)), -1).astype(np.float32)
    qs = [data[s, o:o + l] + rng.normal(size=l).astype(np.float32) * .02
          for s, o, l in ((1, 5, 40), (9, 11, 40), (4, 40, 48))]
    bps = {z: np.asarray(default_breakpoints(JParams(znorm=z, **PARAMS),
                                             jnp.asarray(data)))
           for z in ZNORMS}
    return data, qs, bps


def _local(data, znorm, bp):
    return UlisseEngine.from_collection(
        Collection.from_array(data, device="cpu"),
        EnvelopeParams(znorm=znorm, **PARAMS), breakpoints=torch.tensor(bp),
        device="cpu")


def _eps(local, q, measure, r):
    """The local engine's third neighbour of q, + 1e-3."""
    res = local.search(q, QuerySpec(k=5, measure=measure, r=r,
                                    chunk_size=16))
    return float(res.dists[2]) + 1e-3


def _job():
    data, qs, bps = _inputs()
    eps = {}
    for z in ZNORMS:
        local = _local(data, z, bps[z])
        for m, r in MEASURES:
            eps[(z, m)] = _eps(local, qs[0], m, r)
    job = []
    for world in WORLDS:
        engines = {f"z{z}": (data, dict(PARAMS, znorm=z), bps[z], 4)
                   for z in ZNORMS}
        cases = {}
        for z in ZNORMS:
            for m, r in MEASURES:
                for cap in CAPS:
                    cases[f"range-{z}-{m}-{cap}"] = (f"z{z}", qs[0], dict(
                        eps=eps[(z, m)], measure=m, r=r, chunk_size=16,
                        range_capacity=cap))
            if world == 4:
                cases[f"overflow-{z}"] = (f"z{z}", qs[0], dict(
                    eps=1e4, chunk_size=16, range_capacity=2))
        job.append((world, engines, cases))
    return job, eps


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(eps, port {world: [rank results]}, reference arrays): the
    reference's subprocess runs while the port's worlds do."""
    job, eps = _job()
    proc, path = torch_worlds.start_reference(
        job, str(tmp_path_factory.mktemp("reference")))
    try:
        port = {world: torch_worlds.run_world(
            world, torch_worlds.engine_matrix_job, engines, cases)
            for world, engines, cases in job}
    except BaseException:
        proc.kill()
        raise
    return eps, port, torch_worlds.reference_results(proc, path)


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("measure,r", MEASURES)
@pytest.mark.parametrize("znorm", ZNORMS, ids=["znorm", "raw"])
@pytest.mark.parametrize("world", WORLDS)
def test_range_matrix_equals_reference(runs, world, znorm, measure, r, cap):
    _, port, ref = runs
    case = f"range-{znorm}-{measure}-{cap}"
    got = torch_worlds.results(port[world][0][0], world, case)
    torch_worlds.assert_same(got, torch_worlds.results(ref, world, case),
                             measure, f"{world} {case}")
    assert len(got[0]["series"]) > 1
    if cap == 2 and world == 1:       # > 2 hits: the buffer spills
        assert torch_worlds.stat(got[0], "range_overflows") == 1


@pytest.mark.parametrize("measure,r", MEASURES)
@pytest.mark.parametrize("znorm", ZNORMS, ids=["znorm", "raw"])
def test_range_matrix_equals_local_engine(runs, znorm, measure, r):
    """Every world and capacity gives the local engine's hit set."""
    eps, port, _ = runs
    data, qs, bps = _inputs()
    want = _local(data, znorm, bps[znorm]).search(
        qs[0], QuerySpec(eps=eps[(znorm, measure)], measure=measure, r=r,
                         chunk_size=16))
    want_set = set(zip(want.series.tolist(), want.offsets.tolist()))
    for world in WORLDS:
        for cap in CAPS:
            got = torch_worlds.results(port[world][0][0], world,
                                       f"range-{znorm}-{measure}-{cap}")[0]
            assert set(zip(got["series"].tolist(),
                           got["offsets"].tolist())) == want_set


@pytest.mark.parametrize("znorm", ZNORMS, ids=["znorm", "raw"])
def test_range_overflow_on_every_shard(runs, znorm):
    """eps 1e4 at capacity 2: every shard's buffer spills and its owner
    finishes the tail; the union is every subsequence of the length."""
    _, port, ref = runs
    case = f"overflow-{znorm}"
    got = torch_worlds.results(port[4][0][0], 4, case)
    torch_worlds.assert_same(got, torch_worlds.results(ref, 4, case), "ed",
                             case)
    assert torch_worlds.stat(got[0], "range_overflows") == 4
    data = _inputs()[0]
    assert len(got[0]["series"]) == data.shape[0] * (data.shape[1] - 40 + 1)


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_returns_the_same(runs, world):
    _, port, _ = runs
    first = port[world][0][0]
    for other in port[world][1:]:
        assert other[0].keys() == first.keys()
        for key, v in first.items():
            np.testing.assert_array_equal(other[0][key], v, err_msg=key)
