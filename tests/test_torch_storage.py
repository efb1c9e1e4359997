"""Port parity, storage and ingestion: `repro_torch.storage` (CPU) against
the JAX package's on the same numpy inputs.

  * interop: an index saved by the reference opens in the port, and one
    saved by the port opens in the reference (`repro.storage`); the two
    engines then give the same answers (the same (series, offset) rows in
    the same order) and `SearchStats`, ED distances within 1e-9 (both
    rescore in float64), DTW distances within rtol 1e-3 (the reference's
    float32 closed-form DP cancels on near matches, ROADMAP Queue 3 F4),
    over ED/DTW x k-NN/range x znorm/raw;
  * cold opens stay cold: the raw series are read only at verification,
    and an append to a cold-opened index stays lazy through a save ->
    open round trip;
  * the port's `Writer` (spill runs merged at finalize) equals the port's
    `build_index` bit for bit, and agrees with the reference's `Writer`
    under P2's rule (the same envelopes, >= 99.9% of the symbols equal);
    the writer validates its input;
  * append -> compact equals a from-scratch build in every field and
    level, and the reference's `compact_index` of the same delta carried
    over by `convert`; a bad width is refused; `open` with a mesh still
    raises (ROADMAP Queue 1 item 4);
  * crash safety: a stale `*.tmp/` is ignored and GC'd, a crash in the
    commit window rolls back, a directory that is not an index is never
    replaced; a format version or params mismatch raises.

Queries are data windows plus N(0, 0.05) noise (ROADMAP Queue 3 P3).
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import Collection as JCollection  # noqa: E402
from repro.core import EnvelopeParams as JParams  # noqa: E402
from repro.core import QuerySpec as JQuerySpec  # noqa: E402
from repro.core import UlisseEngine as JEngine  # noqa: E402
from repro.storage import Writer as JWriter  # noqa: E402
from repro.storage import compact_index as j_compact  # noqa: E402
from repro_torch.convert import index_from_arrays  # noqa: E402
from repro_torch.core import (Collection, EnvelopeParams,  # noqa: E402
                              QuerySpec, UlisseEngine)
from repro_torch.core.index import build_index  # noqa: E402
from repro_torch.storage import (IndexCompatibilityError,  # noqa: E402
                                 IndexFormatError, Writer, open_index)
from repro_torch.storage.store import ENV_FIELDS  # noqa: E402

PARAMS = dict(lmin=64, lmax=128, gamma=8, seg_len=16, card=64)
BUILD = dict(block_size=16, num_levels=2)
SPECS = [dict(k=5), dict(k=3, measure="dtw", r=9), dict(eps=None),
         dict(eps=None, measure="dtw", r=9)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Run this module's small tensors on one torch thread: the tier-1 run
    has six workers on the same cores, and torch's default thread pool
    in each oversubscribes them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def walk():
    rng = np.random.default_rng(12345)
    return np.cumsum(rng.normal(size=(24, 192)), -1).astype(np.float32)


def _noised(data, sid, lo, hi, seed):
    rng = np.random.default_rng(seed)
    return data[sid, lo:hi] + rng.normal(size=hi - lo).astype(
        np.float32) * 0.05


def _arrays(index):
    """A reference index flattened to the convert.py schema (its delta
    included)."""
    out = {f"envelopes.{f.name}": np.asarray(getattr(index.envelopes, f.name))
           for f in dataclasses.fields(index.envelopes)}
    if index.delta is not None:
        out.update({f"delta.{f.name}": np.asarray(getattr(index.delta,
                                                          f.name))
                    for f in dataclasses.fields(index.delta)})
    for i, lvl in enumerate(index.levels):
        for f in ("paa_lo", "paa_hi", "valid"):
            out[f"levels.{i}.{f}"] = np.asarray(getattr(lvl, f))
    for f in ("data", "csum", "csum2", "center", "csum_lo", "csum2_lo"):
        out[f"collection.{f}"] = np.asarray(getattr(index.collection, f))
    out["breakpoints"] = np.asarray(index.breakpoints)
    return out


def _stats(res) -> dict:
    """A result's counters as a dict (each package has its own
    SearchStats class)."""
    return dataclasses.asdict(res.stats)


def _build(data, znorm=True):
    return UlisseEngine.from_collection(
        Collection.from_array(data, device="cpu"),
        EnvelopeParams(znorm=znorm, **PARAMS), device="cpu", **BUILD)


def _assert_same_result(a, b):
    np.testing.assert_array_equal(a.dists, b.dists)
    np.testing.assert_array_equal(a.series, b.series)
    np.testing.assert_array_equal(a.offsets, b.offsets)


def _assert_same_index(ia, ib):
    """Every envelope field and level, bit for bit (either package's)."""
    def host(x):
        return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    for f in ENV_FIELDS:
        np.testing.assert_array_equal(host(getattr(ia.envelopes, f)),
                                      host(getattr(ib.envelopes, f)),
                                      err_msg=f)
    assert len(ia.levels) == len(ib.levels)
    for la, lb in zip(ia.levels, ib.levels):
        for f in ("paa_lo", "paa_hi", "valid"):
            np.testing.assert_array_equal(host(getattr(la, f)),
                                          host(getattr(lb, f)), err_msg=f)


# -- interop: each package opens the other's saves -------------------------


@pytest.fixture(scope="module", params=[True, False], ids=["znorm", "raw"])
def ref_engine(request, walk):
    return request.param, JEngine.from_collection(
        JCollection.from_array(walk), JParams(znorm=request.param, **PARAMS),
        **BUILD)


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_saves_open_across_packages(ref_engine, walk, tmp_path, direction):
    """The same answers and `SearchStats` from the reference engine and
    the port engine over one saved index, whichever package saved it."""
    znorm, ref = ref_engine
    path = str(tmp_path / "idx")
    if direction == "ref_to_port":
        ref.save(path)
        port = UlisseEngine.open(path, device="cpu")
        assert not port.index.collection.is_materialized
    else:
        port = UlisseEngine.open(ref.save(str(tmp_path / "src")),
                                 device="cpu")
        port.save(path)
        ref = JEngine.open(path)
    _assert_same_index(port.index, ref.index)
    np.testing.assert_array_equal(port.index.breakpoints.numpy(),
                                  np.asarray(ref.index.breakpoints))
    for j, kw in enumerate(SPECS):
        q = _noised(walk, 3 + 4 * j, 10, 106, seed=j)
        if "eps" in kw:
            knn = ref.search(q, JQuerySpec(k=8, **{
                k: v for k, v in kw.items() if k != "eps"}))
            kw = dict(kw, eps=float(knn.dists[-1]) * 1.0001)
        got = port.search(q, QuerySpec(**kw))
        want = ref.search(q, JQuerySpec(**kw))
        np.testing.assert_array_equal(got.series, want.series)
        np.testing.assert_array_equal(got.offsets, want.offsets)
        assert _stats(got) == _stats(want), kw
        if kw.get("measure", "ed") == "ed":
            np.testing.assert_allclose(got.dists, want.dists, rtol=0,
                                       atol=1e-9)
        else:
            np.testing.assert_allclose(got.dists, want.dists, rtol=1e-3)


def test_open_is_lazy_until_verification(walk, tmp_path):
    path = str(tmp_path / "idx")
    _build(walk).save(path)
    reopened = UlisseEngine.open(path, device="cpu")
    coll = reopened.index.collection
    assert not coll.is_materialized, "a cold open must not read raw series"
    assert coll.num_series == walk.shape[0]
    assert coll.series_len == walk.shape[1]
    assert coll.device == torch.device("cpu")
    assert not coll.is_materialized
    reopened.search(_noised(walk, 0, 0, 96, 1), QuerySpec(k=1))
    if reopened.page_cache_stats() is not None:
        # a memory-constrained run (ULISSE_MEMORY_BUDGET_BYTES below the
        # payload): verification reads through the page cache instead
        assert not coll.is_materialized
    else:
        assert coll.is_materialized, "verification gathers raw windows"


def test_cold_open_append_stays_lazy_roundtrip(walk, tmp_path):
    """append on a cold-opened index queues the rows without reading the
    payload; searches see them; a save folds them in, and cold-open ->
    append -> save -> open carries them too."""
    first, second = walk[:16], walk[16:]
    _build(first).save(str(tmp_path / "idx"))
    cold = UlisseEngine.open(str(tmp_path / "idx"), device="cpu")
    cold.append(second)
    assert cold.delta_size == 8 * EnvelopeParams(**PARAMS).num_envelopes(192)
    assert not cold.index.collection.is_materialized
    assert cold.index.collection.num_series == walk.shape[0]
    q = _noised(walk, 18, 30, 126, 2)          # planted in the append
    got = cold.search(q, QuerySpec(k=5))
    want = _build(walk).search(q, QuerySpec(k=5))
    np.testing.assert_allclose(got.dists, want.dists, atol=1e-9)
    np.testing.assert_array_equal(got.series, want.series)
    assert int(got.series[0]) == 18
    cold.save(str(tmp_path / "idx2"))
    reopened = UlisseEngine.open(str(tmp_path / "idx2"), device="cpu")
    assert reopened.delta_size == cold.delta_size
    _assert_same_result(cold.search(q, QuerySpec(k=5)),
                        reopened.search(q, QuerySpec(k=5)))
    cold2 = UlisseEngine.open(str(tmp_path / "idx"), device="cpu")
    cold2.append(second)
    cold2.save(str(tmp_path / "idx3"))
    re3 = UlisseEngine.open(str(tmp_path / "idx3"), device="cpu")
    assert int(re3.search(q, QuerySpec(k=1)).series[0]) == 18
    np.testing.assert_array_equal(re3.raw_data, walk)


def test_writer_matches_build_and_reference_writer(walk, tmp_path):
    """The port's out-of-core build (ragged appends, several sorted spill
    runs merged at finalize) equals its `build_index` bit for bit, and
    the reference Writer's output under P2's rule."""
    p = EnvelopeParams(znorm=True, **PARAMS)
    w = Writer(str(tmp_path / "bulk"), p, chunk_series=7, device="cpu",
               **BUILD)
    jw = JWriter(str(tmp_path / "jbulk"), JParams(znorm=True, **PARAMS),
                 chunk_series=7, **BUILD)
    for i in range(0, walk.shape[0], 5):
        assert w.append(walk[i:i + 5]) == min(5, walk.shape[0] - i)
        jw.append(walk[i:i + 5])
    assert w.num_series == walk.shape[0]
    streamed = UlisseEngine.from_writer(w)
    assert streamed.device == torch.device("cpu")
    ref = _build(walk)
    _assert_same_index(streamed.index, ref.index)
    q = _noised(walk, 7, 5, 101, 3)
    _assert_same_result(streamed.search(q, QuerySpec(k=4)),
                        ref.search(q, QuerySpec(k=4)))
    jidx = JEngine.from_writer(jw).index
    got, want = streamed.index.envelopes, jidx.envelopes
    valid = got.valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(want.valid))
    # agreement per (series, anchor) envelope, whatever order a flipped
    # symbol would give the sort
    order = np.lexsort((got.anchor.numpy()[valid],
                        got.series_id.numpy()[valid]))
    jvalid = np.asarray(want.valid)
    jorder = np.lexsort((np.asarray(want.anchor)[jvalid],
                         np.asarray(want.series_id)[jvalid]))
    for f in ("series_id", "anchor", "n_master"):
        np.testing.assert_array_equal(
            getattr(got, f).numpy()[valid][order],
            np.asarray(getattr(want, f))[jvalid][jorder])
    for f in ("sym_lo", "sym_hi"):
        agree = (getattr(got, f).numpy()[valid][order]
                 == np.asarray(getattr(want, f))[jvalid][jorder]).mean()
        assert agree >= 0.999, (f, agree)
    for f in ("paa_lo", "paa_hi"):
        np.testing.assert_allclose(
            getattr(got, f).numpy()[valid][order],
            np.asarray(getattr(want, f))[jvalid][jorder], rtol=1e-5,
            atol=1e-5)


def test_writer_validates_input(tmp_path):
    p = EnvelopeParams(znorm=True, **PARAMS)
    w = Writer(str(tmp_path / "bad"), p, device="cpu")
    with pytest.raises(ValueError, match="empty Writer"):
        w.finalize()
    w2 = Writer(str(tmp_path / "bad2"), p, device="cpu")
    with pytest.raises(ValueError, match="shorter than"):
        w2.append(np.zeros(32, np.float32))
    w2.append(np.zeros((2, 192), np.float32))
    with pytest.raises(ValueError, match="fixed-width"):
        w2.append(np.zeros((2, 200), np.float32))
    w2.abort()
    assert not os.path.exists(str(tmp_path / "bad2") + ".tmp")
    with pytest.raises(RuntimeError, match="finalized"):
        w2.append(np.zeros((2, 192), np.float32))


def test_append_then_compact_matches_rebuild_and_reference(walk, tmp_path):
    """Appended series are searched at once (device and host backends),
    `compact()` equals `build_index` over the whole collection in every
    field and level, the delta survives a save -> open round trip, and
    the port's compact of the reference's delta (carried over by
    `convert`) equals the reference's `compact_index`."""
    first, second = walk[:16], walk[16:]
    eng = _build(first)
    eng.append(second[:4])
    eng.append(second[4:])
    assert eng.delta_size > 0
    ref = _build(walk)
    q = _noised(walk, 18, 30, 126, 4)
    for spec in (QuerySpec(k=5), QuerySpec(k=2, measure="dtw", r=9),
                 QuerySpec(k=3, mode="approx"), QuerySpec(eps=6.0),
                 QuerySpec(k=3, scan_backend="host")):
        got, want = eng.search(q, spec), ref.search(q, spec)
        np.testing.assert_allclose(got.dists, want.dists, atol=1e-5)
        np.testing.assert_array_equal(got.series, want.series)
    assert int(eng.search(q, QuerySpec(k=1)).series[0]) == 18

    eng.compact()
    assert eng.delta_size == 0
    _assert_same_index(eng.index, ref.index)
    _assert_same_result(eng.search(q, QuerySpec(k=5)),
                        ref.search(q, QuerySpec(k=5)))

    eng2 = _build(first)
    eng2.append(second)
    path = str(tmp_path / "delta_idx")
    eng2.save(path)
    reopened = UlisseEngine.open(path, device="cpu")
    assert reopened.delta_size == eng2.delta_size
    _assert_same_result(eng2.search(q, QuerySpec(k=5)),
                        reopened.search(q, QuerySpec(k=5)))
    reopened.compact()
    _assert_same_index(reopened.index, ref.index)

    jref = JEngine.from_collection(JCollection.from_array(first),
                                   JParams(znorm=True, **PARAMS), **BUILD)
    jref.append(second)
    carried = UlisseEngine.from_index(
        index_from_arrays(_arrays(jref.index), EnvelopeParams(**PARAMS),
                          device="cpu"), device="cpu")
    assert carried.delta_size == jref.delta_size
    spec = QuerySpec(k=5)
    got, want = carried.search(q, spec), jref.search(q, JQuerySpec(k=5))
    np.testing.assert_array_equal(got.series, want.series)
    assert _stats(got) == _stats(want)
    carried.compact()
    _assert_same_index(carried.index, j_compact(jref.index))


def test_append_rejects_bad_width_and_mesh(walk, tmp_path):
    eng = _build(walk)
    with pytest.raises(ValueError, match="fixed-width"):
        eng.append(np.zeros((1, 64), np.float32))
    with pytest.raises(ValueError, match="fixed-width"):
        eng.validate_append(np.zeros((1, 64), np.float32))
    with pytest.raises(ValueError, match="expected"):
        eng.validate_append(np.zeros((1, 2, 192), np.float32))
    assert eng.validate_append(walk[:3]) == 3
    assert eng.delta_size == 0
    path = str(tmp_path / "idx")
    eng.save(path)
    # a local save opens on a process group too (re-sharded from its raw
    # series): here a gloo world of one in this process
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rv",
                            world_size=1, rank=0)
    try:
        promoted = UlisseEngine.open(path, mesh=dist.group.WORLD,
                                     device="cpu")
        assert promoted.is_distributed and promoted.delta_size == 0
        np.testing.assert_array_equal(promoted.raw_data, walk)
        q = walk[5, 30:126] + np.float32(0.05)
        want, got = (e.search(q, QuerySpec(k=5)) for e in (eng, promoted))
        np.testing.assert_array_equal(got.series, want.series)
        np.testing.assert_array_equal(got.offsets, want.offsets)
        np.testing.assert_allclose(got.dists, want.dists, rtol=0, atol=1e-9)
    finally:
        dist.destroy_process_group()


def test_crash_safety_stale_tmp_ignored_and_gcd(walk, tmp_path):
    eng = _build(walk)
    path = str(tmp_path / "idx")
    eng.save(path)
    stale = path + ".tmp"
    os.makedirs(os.path.join(stale, "envelopes"))
    with open(os.path.join(stale, "garbage.bin"), "w") as f:
        f.write("crashed writer husk")
    reopened = UlisseEngine.open(path, device="cpu")
    assert not os.path.exists(stale), "a stale *.tmp is GC'd on open"
    q = _noised(walk, 2, 0, 96, 5)
    _assert_same_result(eng.search(q, QuerySpec(k=3)),
                        reopened.search(q, QuerySpec(k=3)))
    w = Writer(str(tmp_path / "never"), EnvelopeParams(**PARAMS),
               device="cpu", **BUILD)
    w.append(walk[:4])
    with pytest.raises(IndexFormatError, match="finalized"):
        UlisseEngine.open(str(tmp_path / "never"), device="cpu")


def test_crash_in_commit_window_rolls_back(walk, tmp_path):
    """A re-save moves the old index aside, never deletes it first: after
    a crash between the two renames `<path>.old/` is rolled back."""
    eng = _build(walk)
    path = str(tmp_path / "idx")
    eng.save(path)
    q = _noised(walk, 4, 8, 104, 6)
    want = eng.search(q, QuerySpec(k=3))
    os.rename(path, path + ".old")
    reopened = UlisseEngine.open(path, device="cpu")
    assert os.path.exists(path) and not os.path.exists(path + ".old")
    _assert_same_result(want, reopened.search(q, QuerySpec(k=3)))
    os.makedirs(path + ".old")            # a superseded copy: GC'd
    UlisseEngine.open(path, device="cpu")
    assert not os.path.exists(path + ".old")


def test_save_refuses_to_replace_non_index_dir(walk, tmp_path):
    eng = _build(walk)
    target = tmp_path / "precious"
    target.mkdir()
    (target / "data.txt").write_text("user files, not an index")
    with pytest.raises(IndexFormatError, match="refusing to replace"):
        eng.save(str(target))
    assert (target / "data.txt").read_text() == "user files, not an index"
    assert not os.path.exists(str(target) + ".tmp")
    path = str(tmp_path / "idx")
    eng.save(path)
    eng.save(path)
    assert os.path.exists(os.path.join(path, "manifest.json"))


def test_open_validates_version_and_params(walk, tmp_path):
    path = str(tmp_path / "idx")
    _build(walk).save(path)
    bad = EnvelopeParams(znorm=True, **{**PARAMS, "lmin": 48})
    with pytest.raises(IndexCompatibilityError, match="lmin"):
        UlisseEngine.open(path, params=bad, device="cpu")
    good = EnvelopeParams(znorm=True, **PARAMS)
    assert UlisseEngine.open(path, params=good, device="cpu").params == good
    assert open_index(path, params=good, mmap=False,
                      device="cpu").collection.num_series == walk.shape[0]
    mf = os.path.join(path, "manifest.json")
    with open(mf) as f:
        manifest = json.load(f)
    manifest["format_version"] = 99
    with open(mf, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(IndexFormatError, match="version"):
        UlisseEngine.open(path, device="cpu")
    with pytest.raises(IndexFormatError, match="not a ULISSE index"):
        UlisseEngine.open(str(tmp_path / "nowhere"), device="cpu")


def test_build_index_of_the_concatenation_equals_compact(walk):
    """`build_index` of a concatenated collection with the index's own
    breakpoints — what the card check holds `compact()` to."""
    eng = _build(walk[:20])
    eng.append(walk[20:])
    eng.compact()
    rebuilt = build_index(eng.index.collection, eng.params,
                          eng.index.breakpoints, **BUILD)
    _assert_same_index(eng.index, rebuilt)
