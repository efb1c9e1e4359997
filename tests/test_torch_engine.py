"""Port parity, the whole slice: `repro_torch.UlisseEngine(device="cpu")`
against `repro.UlisseEngine` (device scan backend) on the SAME index —
the reference's index carried over with `convert.index_from_arrays`, so
both engines search an identical plan.

For every case: identical (series, offsets); distances equal to 1e-9
(both engines rescore their reported rows in float64); identical
`SearchStats`; brute-force distances within 5e-3; no unfilled (-1) rows.

Queries are data windows plus a little noise: on an exact self-match the
best d2 is float32 cancellation noise of the dot identity, whose value
(0 or ~1e-4) decides whether leaves with lower bound 0 are still visited,
so the counters of the two engines could differ there by noise alone.

Also here: the port imports neither jax nor repro, and its engine never
runs on the CPU unless asked.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import Collection as JCollection  # noqa: E402
from repro.core import EnvelopeParams as JParams  # noqa: E402
from repro.core import QuerySpec as JQuerySpec  # noqa: E402
from repro.core import UlisseEngine as JEngine  # noqa: E402
from repro.core.search import brute_force_knn as j_brute  # noqa: E402
from repro.core.types import EnvelopeSet as JEnvelopeSet  # noqa: E402
from repro_torch.convert import index_from_arrays  # noqa: E402
from repro_torch.core import (Collection, EnvelopeParams,  # noqa: E402
                              QuerySpec, UlisseEngine)
from repro_torch.core.search import (brute_force_knn,  # noqa: E402
                                     brute_force_range)

PARAMS = dict(lmin=64, lmax=128, seg_len=16, card=64, gamma=8)
SRC = Path(__file__).resolve().parents[1] / "src"


def _arrays(index):
    """A reference index flattened to the convert.py schema."""
    out = {f"envelopes.{f.name}": np.asarray(getattr(index.envelopes, f.name))
           for f in dataclasses.fields(JEnvelopeSet)}
    for i, lvl in enumerate(index.levels):
        for f in ("paa_lo", "paa_hi", "valid"):
            out[f"levels.{i}.{f}"] = np.asarray(getattr(lvl, f))
    for f in ("data", "csum", "csum2", "center", "csum_lo", "csum2_lo"):
        out[f"collection.{f}"] = np.asarray(getattr(index.collection, f))
    out["breakpoints"] = np.asarray(index.breakpoints)
    return out


def _pair(data, znorm):
    """(reference engine, port engine on the converted index, port
    collection) for one collection."""
    ref = JEngine.from_collection(JCollection.from_array(data),
                                  JParams(znorm=znorm, **PARAMS),
                                  block_size=16, num_levels=2)
    idx = index_from_arrays(_arrays(ref.index),
                            EnvelopeParams(znorm=znorm, **PARAMS),
                            device="cpu")
    return ref, UlisseEngine.from_index(idx, device="cpu"), idx.collection


@pytest.fixture(scope="module", params=[True, False], ids=["znorm", "raw"])
def engines(request):
    rng = np.random.default_rng(12345)
    data = np.cumsum(rng.normal(size=(24, 192)), -1).astype(np.float32)
    return (request.param, data[:16]) + _pair(data[:16], request.param)


def _queries(data, spec, seed):
    """Data windows (series, start, length) plus N(0, 0.05) noise."""
    rng = np.random.default_rng(seed)
    return [data[s, o:o + l] + rng.normal(size=l).astype(np.float32) * 0.05
            for s, o, l in spec]


def _assert_same(ref_engine, port_engine, coll, qs, spec_kw, znorm):
    want = ref_engine.search(qs, JQuerySpec(**spec_kw))
    got = port_engine.search(qs, QuerySpec(**spec_kw))
    assert len(got) == len(want) == len(qs)
    for q, a, b in zip(qs, got, want):
        np.testing.assert_array_equal(a.series, b.series)
        np.testing.assert_array_equal(a.offsets, b.offsets)
        np.testing.assert_allclose(a.dists, b.dists, rtol=0, atol=1e-9)
        assert dataclasses.asdict(a.stats) == dataclasses.asdict(b.stats)
        assert (a.series >= 0).all() and (a.offsets >= 0).all()
        assert np.isfinite(a.dists).all()
        oracle = brute_force_knn(coll, q, k=min(spec_kw["k"], 50),
                                 znorm=znorm)
        n = min(len(a.dists), len(oracle.dists))
        np.testing.assert_allclose(a.dists[:n], oracle.dists[:n], rtol=0,
                                   atol=5e-3)
    return got


CASES = {
    # one query, B = 1
    "single_k5": (dict(k=5), [(3, 20, 96)]),
    # 8 queries of one length (B = 8) plus 3 of a second length (a batch
    # padded to 4): mixed lengths in one call
    "b8_mixed_k5": (dict(k=5), [(i, 3 * i, 96) for i in range(8)]
                    + [(9, 7, 64), (11, 40, 128), (12, 0, 64)]),
    "b2_k1": (dict(k=1), [(5, 30, 80), (6, 11, 80)]),
    # the pure scan: the pool starts empty
    "no_approx_k5": (dict(k=5, approx_first=False),
                     [(2, 0, 112), (7, 50, 112), (13, 9, 112)]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_engine_equals_reference(engines, case):
    znorm, data, ref, port, coll = engines
    spec_kw, windows = CASES[case]
    qs = _queries(data, windows, seed=len(case))
    _assert_same(ref, port, coll, qs, spec_kw, znorm)


@pytest.mark.parametrize("znorm", [True, False], ids=["znorm", "raw"])
def test_port_engine_k_exceeds_candidates(znorm):
    """k larger than the candidate count: the +inf pool filler is trimmed
    on both engines, and every real candidate comes back."""
    rng = np.random.default_rng(99)
    data = np.cumsum(rng.normal(size=(4, 192)), -1).astype(np.float32)
    ref, port, coll = _pair(data, znorm)
    qs = _queries(data, [(0, 10, 96)], seed=3)
    got = _assert_same(ref, port, coll, qs, dict(k=500, max_leaves=1), znorm)
    assert 0 < len(got[0].dists) < 500


def test_port_brute_force_matches_reference(engines):
    znorm, data, _, _, coll = engines
    q = _queries(data, [(4, 17, 100)], seed=5)[0]
    got = brute_force_knn(coll, q, k=7, znorm=znorm)
    want = j_brute(JCollection.from_array(data), q, k=7, znorm=znorm)
    np.testing.assert_array_equal(got.series, want.series)
    np.testing.assert_array_equal(got.offsets, want.offsets)
    # both use the float32 dot identity, summed in different orders: the
    # cancellation near d = 0 bounds the agreement (the repo's 5e-3)
    np.testing.assert_allclose(got.dists, want.dists, rtol=0, atol=5e-3)


@pytest.mark.parametrize("q", [np.zeros(100), np.zeros(63), np.zeros(129),
                               np.zeros((2, 80)), np.full(90, np.nan),
                               np.arange(64.0), np.arange(128.0)])
def test_admission_matches_reference(q):
    """admit_query / length_bucket route and refuse like the reference."""
    from repro.core import planner as jplanner
    from repro_torch.core import planner
    p, jp = EnvelopeParams(**PARAMS), JParams(**PARAMS)
    try:
        want = jplanner.admit_query(q, jp)
    except ValueError:
        with pytest.raises(ValueError):
            planner.admit_query(q, p)
        return
    got = planner.admit_query(q, p)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] == planner.length_bucket(q.size, p.lmax)


def test_unported_paths_raise(engines):
    """Range search is ported (device and host, ED and DTW) and answers
    the port's brute force; approx-only and the host backend answer; the
    paged tier, ingestion and the distributed backend still raise, naming
    their ROADMAP Queue 1 item."""
    znorm, data, _, port, coll = engines
    q = data[0, :96] + np.float32(0.05) * np.sin(np.arange(96),
                                                  dtype=np.float32)
    for kw in (dict(), dict(measure="dtw", r=4),
               dict(scan_backend="host")):
        eps = float(brute_force_knn(coll, q, k=5, znorm=znorm,
                                    **{k: v for k, v in kw.items()
                                       if k != "scan_backend"}).dists[-1])
        res = port.search(q, QuerySpec(eps=eps * 1.01, **kw))
        want = brute_force_range(coll, q, eps * 1.01, znorm=znorm,
                                 **{k: v for k, v in kw.items()
                                    if k != "scan_backend"})
        assert len(res.dists) >= 5 and (np.diff(res.dists) >= 0).all()
        assert set(zip(res.series, res.offsets)) == set(
            zip(want.series, want.offsets))
        np.testing.assert_allclose(res.dists, want.dists, rtol=0, atol=5e-3)
    for kw in (dict(mode="approx"), dict(measure="dtw", r=4, mode="approx"),
               dict(scan_backend="host")):
        res = port.search(q, QuerySpec(k=3, **kw))
        assert len(res.dists) == 3 and np.isfinite(res.dists).all()
        assert (np.diff(res.dists) >= 0).all()
    with pytest.raises(NotImplementedError, match="item 2"):
        port.append(data[:1])
    with pytest.raises(NotImplementedError, match="item 2"):
        port.compact()
    with pytest.raises(NotImplementedError, match="item 2"):
        UlisseEngine.from_index(port.index, memory_budget_bytes=1 << 20,
                                device="cpu")
    with pytest.raises(NotImplementedError, match="item 4"):
        UlisseEngine.distributed(None, EnvelopeParams(**PARAMS), data)


def test_engine_raises_without_cuda_unless_cpu_asked(engines):
    """The default device is CUDA; with no card the engine refuses to run
    rather than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, data, _, port, coll = engines
    p = EnvelopeParams(**PARAMS)
    with pytest.raises(RuntimeError, match="CUDA"):
        UlisseEngine.from_collection(coll, p)
    with pytest.raises(RuntimeError, match="CUDA"):
        UlisseEngine.from_index(port.index)
    with pytest.raises(RuntimeError, match="CUDA"):
        Collection.from_array(data)
    with pytest.raises(RuntimeError, match="CUDA"):
        UlisseEngine.from_collection(coll, p, device="cuda")


def test_port_imports_neither_jax_nor_repro():
    """Import repro_torch and every module under it in a fresh
    interpreter: no jax and no repro module may be loaded."""
    code = (
        "import pkgutil, importlib, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15
