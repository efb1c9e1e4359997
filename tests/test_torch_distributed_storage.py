"""Port parity, the distributed engine's persistence: `save` over a
process group (each rank writes its own shard: main rows, delta rows
and their global ids, index sections; rank 0 commits) and
`UlisseEngine.open(path, mesh=group)` (O(index) on a group of the saved
size, re-sharded from the raw rows otherwise), in gloo worlds of 4 and 2
ranks against the JAX package's mesh engine on 4 forced host devices (a
subprocess), in the reference's on-disk format.  The reference's own
tests are tests/test_distributed_ingest.py:164 and :310 and
tests/test_storage.py:334.

  * a cold open of a delta-carrying save on a world of 4 answers
    bit-equal to the warm engine; inside each rank `build_envelope_set`
    and `host_prefix_stats` are poisoned across the open and
    `format.load_array` is metered: no summarization, the index left
    unbuilt, eager reads under a quarter of the rank's own payload; the
    manifest's max_batch and the delta kept;
  * append and compact after a cold open;
  * the commit's crash window: a save whose promoting rename fails
    raises on every rank and commits nothing, the next open rolls the
    previous index back, a retry commits;
  * each package opens the other's save: the reference's save (4 shards,
    with sections) cold on a world of 4, equal to the reference's own
    answers and counters; the port's save on the reference's mesh of 4,
    equal to the port's;
  * the elastic open: both 4-shard saves opened on a world of 2 (every
    row, the delta folded back at its ids) answer as the warm engine;
  * `from_writer(..., mesh=group)`: rank 0's Writer finalized and opened
    on a world of 2 answers as a distributed build of the same series.

Distances: ED within 1e-9 (both rescore in float64); DTW against the
reference within rtol 1e-5 of a float64 DP of the reported windows (the
reference's float32 DP cancels near matches, ROADMAP F4).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_worlds  # noqa: E402
from repro_torch.core import (Collection, EnvelopeParams,  # noqa: E402
                              QuerySpec, UlisseEngine)

PARAMS = dict(lmin=32, lmax=48, gamma=4, seg_len=8, card=64, znorm=True)
DTW_R = 3

# The reference's side.  argv[1] a pickled dict (base, extra, params, qs,
# specs, and "save" or "open": a path), argv[2] the .npz it writes:
# "save" builds the mesh engine over base, appends extra, searches and
# saves; "open" opens the path on the mesh and searches ("cold" tells
# whether it read the saved sections).
REFERENCE = r"""
import pickle, sys
import jax, numpy as np
from repro.core import EnvelopeParams, QuerySpec, UlisseEngine
sys.path.insert(0, sys.argv[3])
from torch_worlds import flatten
with open(sys.argv[1], "rb") as f:
    job = pickle.load(f)
mesh = jax.make_mesh((4,), ("data",))
if "save" in job:
    eng = UlisseEngine.distributed(mesh, EnvelopeParams(**job["params"]),
                                   job["base"], max_batch=4)
    eng.append(job["extra"])
else:
    eng = UlisseEngine.open(job["open"], mesh=mesh)
out = {"cold": np.array(eng._cold_sections is not None)}
for name, spec in job["specs"].items():
    res = eng.search(job["qs"], QuerySpec(**spec))
    out.update(flatten(4, "ref-" + name, res))
if "save" in job:
    eng.save(job["save"])
np.savez(sys.argv[2], **out)
"""


def _walk(rng, s, n=96):
    return np.cumsum(rng.normal(size=(s, n)), -1).astype(np.float32)


def _inputs():
    """The reference test's collection (16 series, a part of 8, then one
    of 4 for the cold engine) and three noisy windows: a main series, an
    appended one, a longer one."""
    rng = np.random.default_rng(5)
    base, extra, more = _walk(rng, 16), _walk(rng, 8), _walk(rng, 4)
    full = np.concatenate([base, extra])
    qs = [full[s, o:o + n] + rng.normal(size=n).astype(np.float32) * .02
          for s, o, n in ((3, 5, 40), (18, 10, 40), (9, 40, 48))]
    return base, extra, more, full, qs


def _specs(full, qs):
    p = EnvelopeParams(**PARAMS)
    local = UlisseEngine.from_collection(
        Collection.from_array(full, device="cpu"), p, device="cpu")
    eps = float(local.search(qs[0], QuerySpec(k=5, chunk_size=16))
                .dists[2]) + 1e-3
    return {"ed": dict(k=5, chunk_size=16),
            "dtw": dict(k=5, measure="dtw", r=DTW_R, chunk_size=16),
            "range": dict(eps=eps, chunk_size=16)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(world-4 [rank (arrays, record)], world-2 [rank (arrays, record)],
    the reference's warm arrays, its arrays over the port's save)."""
    base, extra, more, full, qs = _inputs()
    specs = _specs(full, qs)
    root = str(tmp_path_factory.mktemp("saves"))
    ref_path = os.path.join(root, "ref")
    job = dict(base=base, extra=extra, params=PARAMS, qs=qs, specs=specs)
    saver, saved = torch_worlds.start_reference(
        dict(job, save=ref_path), str(tmp_path_factory.mktemp("ref_save")),
        script=REFERENCE)
    opener = None
    try:
        four = torch_worlds.run_world(
            4, torch_worlds.storage_job, base, extra, more, PARAMS, qs,
            specs, root, ref_path, timeout=300)
        opener, opened = torch_worlds.start_reference(
            dict(job, open=os.path.join(root, "port")),
            str(tmp_path_factory.mktemp("ref_open")), script=REFERENCE)
        two = torch_worlds.run_world(
            2, torch_worlds.elastic_job, qs, specs,
            os.path.join(root, "port"), ref_path, base, PARAMS,
            os.path.join(root, "writer"), timeout=200)
    except BaseException:
        saver.kill()
        if opener is not None:
            opener.kill()
        raise
    return (four, two, torch_worlds.reference_results(saver, saved),
            torch_worlds.reference_results(opener, opened))


def _res(arrays, world, case):
    return torch_worlds.results(arrays, world, case)


def _same_answers(got, want, measure, what):
    """(sid, off) in the same order, distances ED 1e-9 / DTW 1e-6 (the
    same DP on the same rows)."""
    assert len(got) == len(want) > 0, what
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["series"], b["series"], err_msg=what)
        np.testing.assert_array_equal(a["offsets"], b["offsets"],
                                      err_msg=what)
        np.testing.assert_allclose(a["dists"], b["dists"], rtol=0,
                                   atol=1e-9 if measure != "dtw" else 1e-6,
                                   err_msg=what)


def _to_reference(got, want, name, what):
    _, _, _, full, qs = _inputs()
    if name == "dtw":
        torch_worlds.assert_same_dtw64(got, want, qs, full, DTW_R, True,
                                       what)
    else:
        torch_worlds.assert_same(got, want, "ed", what)


@pytest.mark.parametrize("name", ["ed", "dtw", "range"])
def test_cold_open_bit_equal_to_warm(runs, name):
    four = runs[0]
    for arrays, _ in four:
        warm = _res(arrays, 4, f"warm-{name}")
        cold = _res(arrays, 4, f"cold-{name}")
        assert len(warm) == 3
        for a, b in zip(cold, warm):
            for f in a:
                np.testing.assert_array_equal(a[f], b[f], err_msg=f)
        for a, b in zip(_res(four[0][0], 4, f"cold-{name}"), cold):
            for f in a:
                np.testing.assert_array_equal(a[f], b[f], err_msg=f)


def test_cold_open_reads_o_index_and_summarizes_nothing(runs):
    """The open ran with summarization poisoned; it left the index
    unbuilt, read eagerly the breakpoints and the delta ids only (under a
    quarter of the rank's own payload), kept max_batch and the delta."""
    p = EnvelopeParams(**PARAMS)
    for _, rec in runs[0]:
        eager, mine, payload, unbuilt, max_batch, delta = rec["eager"]
        assert payload == 16 * 96 * 4 and mine == payload // 4
        assert 0 < eager < mine // 4, rec["eager"]
        assert unbuilt and max_batch == 4
        assert delta == 8 * p.num_envelopes(96)


def test_append_and_compact_after_cold_open(runs):
    base, extra, more, _, qs = _inputs()
    grown = np.concatenate([base, extra, more])
    for arrays, rec in runs[0]:
        delta, raw = rec["cold_compacted"]
        assert delta == 0
        np.testing.assert_array_equal(raw, grown)
        for name in ("ed", "dtw", "range"):
            _same_answers(_res(arrays, 4, f"cold-compacted-{name}"),
                          _res(arrays, 4, f"cold-appended-{name}"), name,
                          name)
    # the appended windows are found
    ed = _res(runs[0][0][0], 4, "cold-appended-ed")
    assert ed[1]["series"][0] == 18


def test_crash_in_commit_window_rolls_back(runs):
    for rank, (arrays, rec) in enumerate(runs[0]):
        if rank == 0:
            assert "simulated crash" in rec["crash"]
        else:
            assert "failed on rank 0" in rec["crash"]
        assert rec["crash_left"] == (False, True)
        assert rec["rolled_back"] == (True, False, False, 16)
        for a, b in zip(_res(arrays, 4, "rolled-back"),
                        _res(arrays, 4, "v1")):
            for f in a:
                np.testing.assert_array_equal(a[f], b[f], err_msg=f)
        assert rec["retried_rows"] == 24


@pytest.mark.parametrize("name", ["ed", "dtw", "range"])
def test_port_opens_reference_save(runs, name):
    """The reference's 4-shard save, cold through its own sections on a
    world of 4: its answers and counters."""
    four, _, ref, _ = runs
    assert bool(ref["cold"]) is False
    for arrays, rec in four:
        assert rec["ref_cold"]
        _to_reference(_res(arrays, 4, f"ref-{name}"),
                      _res(ref, 4, f"ref-{name}"), name, f"ref {name}")


@pytest.mark.parametrize("name", ["ed", "dtw", "range"])
def test_reference_opens_port_save(runs, name):
    """The port's 4-shard save on the reference's mesh of 4, through the
    port's sections: the port's answers and counters."""
    four, _, _, opened = runs
    assert bool(opened["cold"])
    _to_reference(_res(four[0][0], 4, f"warm-{name}"),
                  _res(opened, 4, f"ref-{name}"), name, f"port {name}")


@pytest.mark.parametrize("name", ["ed", "dtw", "range"])
def test_elastic_open_on_a_world_of_2(runs, name):
    """Both 4-shard saves re-sharded onto 2 ranks: every row (the delta
    folded in at its ids, so nothing left to compact) and the warm
    engine's answers (the same rows and breakpoints)."""
    four, two = runs[:2]
    warm = _res(four[0][0], 4, f"warm-{name}")
    for arrays, rec in two:
        assert rec["port"] == rec["ref"] == (24, 0, False)
        for tag in ("port", "ref"):
            _same_answers(_res(arrays, 2, f"{tag}-{name}"), warm, name,
                          f"{tag} {name}")


@pytest.mark.parametrize("name", ["ed", "dtw", "range"])
def test_from_writer_on_a_group(runs, name):
    """A Writer held by rank 0, finalized and opened on a world of 2
    (`from_writer(..., mesh=group)`): the rows of a distributed build of
    the same series, and its answers."""
    for arrays, rec in runs[1]:
        assert rec["writer"] == (16, 0, False)
        _same_answers(_res(arrays, 2, f"writer-{name}"),
                      _res(arrays, 2, f"built-{name}"), name, name)
