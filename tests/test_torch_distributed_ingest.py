"""Port parity, the distributed engine's ingestion: `append` into
per-rank delta buffers searched through the delta-first shard pack (the
chunk step mapping ids through a gmap, with the mesh-wide k-th),
`compact` over the group, `validate_append`, and `UlisseServer` over a
distributed engine, in gloo worlds of 1, 2 and 4 ranks (on the CPU, the
kernels' plain versions) against the JAX package's mesh engine fed the
same stream (a subprocess on 4 forced host devices), a local port engine
fed the same stream, and a brute force over the final collection.  The
reference's own tests are tests/test_distributed_ingest.py:39, :115 and
:258.

  * the matrix: worlds {1, 2, 4} x znorm/raw x ED/DTW (r 3) x k-NN (three
    noisy windows of two lengths, k 5) / range (eps just past the local
    engine's third-nearest distance of the first query), after two
    appended parts (8 then 4 series, so a rank's delta ids are not
    contiguous): the reference's answers in the same order and every
    SearchStats counter, shard_chunks included (ED distances within
    1e-9 of the reference's; DTW ones within rtol 1e-5 of a float64 DP
    of the reported windows, ROADMAP F4); the local engine's answers; the
    brute force's (sid, off) sets, distances within 2e-2 (the reference
    test's tolerance);
  * approximate mode with a delta (world 4, max_leaves 1 and 64): the
    reference's budget stretch and certificate (`exact_from_approx`,
    `shard_chunks`);
  * `compact` equals `UlisseEngine.distributed` over the concatenated
    data with the same breakpoints in every shard field, bit for bit,
    and answers as before it (a world of 1 keeps its rows in place, the
    others re-shard); `delta_size` and `raw_data` before it;
  * `validate_append` refuses a part that does not divide by the world
    and a series of another width, in the reference's words;
  * a world of 2 behind `UlisseServer` (rank 0 leads, rank 1 follows):
    served answers bit-equal to serial searches, an append and a compact
    through the writer lane visible to the next dispatch, on every rank.
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
from repro_torch.core.search import (brute_force_knn,  # noqa: E402
                                     brute_force_range)

PARAMS = dict(lmin=32, lmax=48, gamma=4, seg_len=8, card=64)
WORLDS = (1, 2, 4)
MEASURES = (("ed", 0), ("dtw", 3))
ZNORMS = (True, False)

# the reference's side: REFERENCE's matrix (appended parts included),
# then the first engine's validate_append messages for each refused part
# in the world of 4, written as "messages" into the same .npz
INGEST_REFERENCE = torch_worlds.REFERENCE.replace(
    "job = pickle.load(f)", "job, refusals = pickle.load(f)").replace(
    "np.savez(sys.argv[2], **out)", """
messages = []
for bad in refusals:
    try:
        next(iter(built.values())).validate_append(bad)
        messages.append("")
    except ValueError as e:
        messages.append(str(e))
np.savez(sys.argv[2], messages=np.array(messages), **out)
""")


def _walk(rng, s, n=96):
    return np.cumsum(rng.normal(size=(s, n)), -1).astype(np.float32)


def _inputs():
    """The reference test's stream: 16 series, then parts of 8 and 4;
    three noisy windows of the final collection (one in each part)."""
    rng = np.random.default_rng(7)
    base, ex1, ex2 = _walk(rng, 16), _walk(rng, 8), _walk(rng, 4)
    full = np.concatenate([base, ex1, ex2])
    qs = [full[s, o:o + n] + rng.normal(size=n).astype(np.float32) * .02
          for s, o, n in ((1, 5, 40), (17, 11, 40), (25, 40, 48))]
    return base, (ex1, ex2), full, qs


def _bp(base, znorm):
    return np.asarray(default_breakpoints(JParams(znorm=znorm, **PARAMS),
                                          jnp.asarray(base)))


def _local(znorm):
    base, parts, _, _ = _inputs()
    eng = UlisseEngine.from_collection(
        Collection.from_array(base, device="cpu"),
        EnvelopeParams(znorm=znorm, **PARAMS),
        breakpoints=torch.tensor(_bp(base, znorm)), max_batch=4,
        device="cpu")
    for part in parts:
        eng.append(part)
    return eng


def _eps(znorm, measure, r):
    """Just past the local engine's third-nearest distance of query 0."""
    qs = _inputs()[3]
    res = _local(znorm).search(qs[0], QuerySpec(k=5, measure=measure, r=r,
                                                chunk_size=16))
    return float(res.dists[2]) + 1e-3


def _job():
    base, parts, _, qs = _inputs()
    job = []
    for world in WORLDS:
        engines, cases = {}, {}
        for z in ZNORMS:
            engines[f"z{z}"] = (base, dict(PARAMS, znorm=z), _bp(base, z), 4,
                                parts)
            for m, r in MEASURES:
                cases[f"knn-{z}-{m}"] = (f"z{z}", qs, dict(
                    k=5, measure=m, r=r, chunk_size=16))
                cases[f"range-{z}-{m}"] = (f"z{z}", qs[0], dict(
                    eps=_eps(z, m, r), measure=m, r=r, chunk_size=16))
        if world == 4:
            for leaves in (1, 64):
                cases[f"approx-{leaves}"] = ("zTrue", qs[:2], dict(
                    k=3, mode="approx", chunk_size=16, max_leaves=leaves))
        job.append((world, engines, cases))
    return job


def _refusals():
    base = _inputs()[0]
    return [base[:3], np.zeros((4, 64), np.float32)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(port {world: [rank results]}, reference arrays, the serving
    world's [rank results]): the reference's subprocess runs while the
    port's worlds do."""
    job = _job()
    proc, path = torch_worlds.start_reference(
        (job, _refusals()), str(tmp_path_factory.mktemp("reference")),
        script=INGEST_REFERENCE)
    base, parts, full, qs = _inputs()
    serve = (torch_worlds.serve_job, (
        base, dict(PARAMS, znorm=True), _bp(base, True),
        [q for q in qs[:2] for _ in range(3)] + [qs[2]] * 2,
        dict(k=3, chunk_size=16), parts[0],
        full[20, 30:70] + np.float32(0.01)))
    try:
        port = {}
        for world, engines, cases in job:
            jobs = [(torch_worlds.ingest_job, (engines, cases,
                                               _refusals()))]
            if world == 2:
                jobs.append(serve)
            port[world] = torch_worlds.run_world(
                world, torch_worlds.multi_job, jobs, timeout=240)
    except BaseException:
        proc.kill()
        raise
    return port, torch_worlds.reference_results(proc, path, timeout=300)


_results = torch_worlds.results


def _codes(res):
    return set(zip(np.asarray(res["series"]).tolist(),
                   np.asarray(res["offsets"]).tolist()))


@pytest.mark.parametrize("kind", ["knn", "range"])
@pytest.mark.parametrize("measure,r", MEASURES)
@pytest.mark.parametrize("znorm", ZNORMS, ids=["znorm", "raw"])
@pytest.mark.parametrize("world", WORLDS)
def test_appended_matrix_equals_reference(runs, world, znorm, measure, r,
                                          kind):
    """Answers, order and every counter of the reference's mesh engine fed
    the same stream; ED distances within 1e-9 of the reference's, DTW
    ones within rtol 1e-5 of a float64 DP of the same windows (the
    reference's float32 closed-form DP cancels on this stream's near
    matches, ROADMAP F4: 0.114287 for a float64 0.114312); every rank
    alike."""
    port, ref = runs
    case = f"{kind}-{znorm}-{measure}"
    got = _results(port[world][0][0][0], world, case)
    want = _results(ref, world, case)
    if measure == "ed":
        torch_worlds.assert_same(got, want, measure, f"{world} {case}")
    else:
        full, qs = _inputs()[2:]
        torch_worlds.assert_same_dtw64(got, want, qs, full, r, znorm,
                                       f"{world} {case}")
    for other in port[world][1:]:
        for a, b in zip(_results(other[0][0], world, case), got):
            for f in a:
                np.testing.assert_array_equal(a[f], b[f], err_msg=f)


@pytest.mark.parametrize("measure,r", MEASURES)
@pytest.mark.parametrize("znorm", ZNORMS, ids=["znorm", "raw"])
@pytest.mark.parametrize("world", WORLDS)
def test_appended_matrix_equals_local_and_brute_force(runs, world, znorm,
                                                      measure, r):
    """The local port engine fed the same stream answers alike; the brute
    force over the final collection finds the same windows."""
    port, _ = runs
    _, _, full, qs = _inputs()
    local = _local(znorm)
    coll = Collection.from_array(full, device="cpu")
    spec = QuerySpec(k=5, measure=measure, r=r, chunk_size=16)
    got = _results(port[world][0][0][0], world, f"knn-{znorm}-{measure}")
    for a, b, q in zip(got, local.search(qs, spec), qs):
        np.testing.assert_array_equal(a["series"], b.series)
        np.testing.assert_array_equal(a["offsets"], b.offsets)
        np.testing.assert_allclose(a["dists"], b.dists, rtol=0,
                                   atol=1e-9 if measure == "ed" else 1e-6)
        bf = brute_force_knn(coll, q, k=5, znorm=znorm, measure=measure,
                             r=r)
        assert _codes(a) == set(zip(bf.series.tolist(),
                                    bf.offsets.tolist()))
        np.testing.assert_allclose(a["dists"], bf.dists, atol=2e-2)
    eps = _eps(znorm, measure, r)
    rng = _results(port[world][0][0][0], world, f"range-{znorm}-{measure}")
    want = local.search(qs[0], QuerySpec(eps=eps, measure=measure, r=r,
                                         chunk_size=16))
    bf = brute_force_range(coll, qs[0], eps, znorm=znorm, measure=measure,
                           r=r)
    assert _codes(rng[0]) == set(zip(want.series.tolist(),
                                     want.offsets.tolist())) == set(
        zip(bf.series.tolist(), bf.offsets.tolist()))
    # appended series are found: ids past the first 16
    assert any(s >= 16 for s in got[1]["series"])


def test_approx_mode_with_delta_equals_reference(runs):
    """The budget stretches by the delta's chunks and the certificate is
    the reference's, at one leaf and at 64."""
    port, ref = runs
    arrays = port[4][0][0][0]
    for case in ("approx-1", "approx-64"):
        torch_worlds.assert_same(_results(arrays, 4, case),
                                 _results(ref, 4, case), "ed", case)
    wide = _results(arrays, 4, "approx-64")
    assert all(torch_worlds.stat(x, "exact_from_approx") == 1 for x in wide)
    one = _results(arrays, 4, "approx-1")
    # the delta's chunks are swept first, then the one-chunk budget
    assert max(max(x["shard_chunks"]) for x in one) >= 2


@pytest.mark.parametrize("world", WORLDS)
def test_compact_bit_identical_to_fresh_build(runs, world):
    port, _ = runs
    _, parts, full, _ = _inputs()
    p = EnvelopeParams(**PARAMS)
    n_env = p.num_envelopes(full.shape[1])
    for res in port[world]:
        arrays, _, compacted, _ = res[0]
        for name, (delta, raw, after, diff) in compacted.items():
            assert delta == n_env * sum(len(x) for x in parts), name
            np.testing.assert_array_equal(raw, full, err_msg=name)
            assert after == 0 and diff == [], (name, diff)
        for key in [k for k in arrays if k.startswith(f"{world}/knn-")]:
            if key.endswith(("/series", "/offsets", "/dists")):
                np.testing.assert_array_equal(
                    arrays[key.replace("/knn-", "/compacted-knn-")],
                    arrays[key], err_msg=key)


def test_delta_searches_ran_the_gmap_family(runs):
    """Every chunk step after the appends mapped its ids through the
    rank's gmap."""
    port, _ = runs
    for world in WORLDS:
        for res in port[world]:
            assert res[0][3] > 0


def test_validate_append_refusals_carry_reference_messages(runs):
    port, ref = runs
    want = [str(m) for m in ref["messages"]]
    assert "not divisible by the 4-shard mesh" in want[0]
    assert "fixed-width" in want[1]
    for res in port[4]:
        assert res[0][1] == want
    two = port[2][0][0][1]
    assert two[0] is not None and "2-shard mesh" in two[0]
    assert two[1] == want[1]


def test_served_answers_bit_equal_and_writer_lane_visible(runs):
    """Rank 0 serves, rank 1 replays: coalesced answers are the serial
    ones bit for bit (every counter too); the append is found by the next
    dispatch, the compact keeps the answer, and both ranks end alike."""
    port, _ = runs
    (arrays, info), (arrays1, info1) = (r[1] for r in port[2])
    serial = _results(arrays, 2, "serial")
    served = _results(arrays, 2, "served")
    assert len(served) == len(serial) == 8
    for a, b in zip(served, serial):
        for f in a:
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    assert info["versions"] == (1, 2)
    assert info["dispatches"]["completed"] == 10
    assert info1["replayed"] >= 4        # dispatches, append, compact
    probe = _results(arrays, 2, "probe")
    assert probe[0]["series"][0] == 20   # the appended series
    for f in ("series", "offsets", "dists"):
        np.testing.assert_array_equal(probe[0][f], probe[1][f])
    after0, after1 = (_results(a, 2, "after")[0] for a in (arrays, arrays1))
    for f in after0:
        np.testing.assert_array_equal(after0[f], after1[f])
        np.testing.assert_array_equal(after0[f], probe[1][f])
    assert info["final"] == info1["final"] == (0, 24)
