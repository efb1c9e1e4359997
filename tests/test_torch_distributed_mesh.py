"""Port parity, rank grids: `UlisseEngine.distributed(mesh, ..., axes=...)`
and `open(path, mesh=..., axes=...)` over a 2 x 2
`torch.distributed.device_mesh.DeviceMesh` ("data", "model") in a gloo
world of 4, against the JAX package's engine on `jax.make_mesh((2, 2),
("data", "model"))` (4 forced host devices, a subprocess).

  * axes ("data", "model"): 4 shards, one a rank; axes ("data",): 2
    shards, each held by the 2 ranks that differ in "model" (replicas).
    ED and DTW k-NN, approximate k-NN and ED range: the reference's
    answers and `SearchStats`, on every rank alike;
  * each grid's save (one file set a shard, from replica 0) opened under
    either grid's axes (the save's recorded axes win, as the reference
    reopens: O(index), the sections read) and on the whole group as a
    one-axis grid of 4 (a 2-shard save re-sharded): the fresh engine's
    answers;
  * a server over the 4-shard grid: rank 0 leads, the other three
    follow; served answers equal the serial ones.

Distances: ED within 1e-9 (both rescore in float64), DTW rtol 1e-4 /
atol 1e-5 (the reference's float32 closed-form DP, ROADMAP F4).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_worlds  # noqa: E402
from repro_torch.core import (Collection, EnvelopeParams,  # noqa: E402
                              QuerySpec, UlisseEngine)

PARAMS = dict(lmin=32, lmax=48, gamma=4, seg_len=8, card=64, znorm=True)
GRIDS = {"dm": ("data", "model"), "d": ("data",)}


def _inputs():
    """16 random walks of 96 points, four noisy windows (two lengths)
    and the cases: ED, DTW (r 3), approximate ED k-NN and ED range."""
    rng = np.random.default_rng(23)
    data = np.cumsum(rng.normal(size=(16, 96)), -1).astype(np.float32)
    qs = [data[s, o:o + n] + rng.normal(size=n).astype(np.float32) * .05
          for s, o, n in ((3, 5, 40), (11, 30, 40), (6, 12, 48),
                          (14, 40, 48))]
    p = EnvelopeParams(**PARAMS)
    local = UlisseEngine.from_collection(
        Collection.from_array(data, device="cpu"), p, device="cpu")
    eps = float(local.search(qs[0], QuerySpec(k=4, chunk_size=16))
                .dists[2]) + 1e-3
    cases = {"ed": (qs, dict(k=4, chunk_size=16)),
             "dtw": (qs, dict(k=4, measure="dtw", r=3, chunk_size=16)),
             "approx": (qs, dict(k=4, mode="approx", chunk_size=16)),
             "range": (qs[:2], dict(eps=eps, chunk_size=16))}
    bp = np.asarray(local.index.breakpoints.numpy())
    return data, bp, cases


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the world's [rank (arrays, info)], the reference's arrays)."""
    data, bp, cases = _inputs()
    proc, out = torch_worlds.start_reference(
        (data, PARAMS, bp, GRIDS, cases),
        str(tmp_path_factory.mktemp("ref")),
        script=torch_worlds.REFERENCE_GRID)
    try:
        ranks = torch_worlds.run_world(
            4, torch_worlds.grid_job, data, PARAMS, bp, GRIDS, cases,
            str(tmp_path_factory.mktemp("saves")), timeout=240)
    finally:
        ref = torch_worlds.reference_results(proc, out, timeout=240)
    return ranks, ref, cases


def _measure(spec):
    return spec.get("measure", "ed")


@pytest.mark.parametrize("label", list(GRIDS))
@pytest.mark.parametrize("case", ["ed", "dtw", "approx", "range"])
def test_grid_engine_equals_reference_mesh(runs, label, case):
    """Each grid's engine answers as the reference's engine on the same
    2 x 2 mesh and axes (answers, every counter, shard_chunks), on every
    rank alike."""
    ranks, ref, cases = runs
    want = torch_worlds.results(ref, label, case)
    for arrays, _ in ranks:
        torch_worlds.assert_same(torch_worlds.results(arrays, label, case),
                                 want, _measure(cases[case][1]),
                                 f"{label} {case}")


def test_grid_shards_and_replicas(runs):
    """("data", "model"): 4 shards, rank r holds shard r; ("data",): 2
    shards, rank r holds shard r // 2 as replica r % 2 (the mesh numbers
    its ranks row-major); the saves open cold under their own shard
    count whatever axes the caller names (the manifest's win), and a
    2-shard save on the whole group of 4 is re-sharded."""
    ranks, _, _ = runs
    for r, (_, info) in enumerate(ranks):
        assert info["dm"] == (4, r, 0, False)
        assert info["d"] == (2, r // 2, r % 2, False)
        for other in GRIDS:
            assert info[f"dm>{other}"] == (4, r, 0, True)
            assert info[f"d>{other}"] == (2, r // 2, r % 2, True)
        assert info["dm>world"] == (4, r, 0, True)
        assert info["d>world"] == (4, r, 0, False)


@pytest.mark.parametrize("label", list(GRIDS))
@pytest.mark.parametrize("opened", list(GRIDS) + ["world"])
def test_grid_save_opens_under_each_grid(runs, label, opened):
    """A grid's save opened under either grid's axes, or on the whole
    group, answers every case as the fresh engine did, bit for bit."""
    ranks, _, cases = runs
    for arrays, _ in ranks:
        for case in cases:
            got = torch_worlds.results(arrays, f"{label}>{opened}", case)
            want = torch_worlds.results(arrays, label, case)
            fields = ("dists", "series", "offsets")
            if opened != "world" or label == "dm":
                fields += ("stats", "shard_chunks")
            for a, b in zip(got, want):
                for f in fields:
                    np.testing.assert_array_equal(
                        a[f], b[f], err_msg=f"{label}>{opened} {case} {f}")
            assert len(got) == len(want) > 0


def test_server_over_grid_leads_from_rank_zero(runs):
    """A server over the 4-shard grid: rank 0 serves the ED case's
    queries while ranks 1-3 replay its searches (`serve.follow`); the
    served answers equal the serial ones."""
    ranks, _, cases = runs
    arrays, info = ranks[0]
    served = torch_worlds.results(arrays, "served", "ed")
    serial = torch_worlds.results(arrays, "dm", "ed")
    assert len(served) == len(serial) == len(cases["ed"][0])
    for a, b in zip(served, serial):
        for f in ("dists", "series", "offsets"):
            np.testing.assert_array_equal(a[f], b[f])
    assert info["served"] == len(cases["ed"][0])
    for _, other in ranks[1:]:
        assert other["replayed"] >= 1
