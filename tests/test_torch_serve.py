"""Port parity, the serving tier: `repro_torch.serve` (CPU) against the JAX
package's `repro.serve` on the same numpy inputs.

  * coalescing never changes an answer: a burst of mixed-length requests,
    coalesced into padded bucket dispatches, answers bit-equal to one
    `engine.search` at a time (answers and `SearchStats`), over ED/DTW x
    k-NN/range; and the same burst served by the reference's server gives
    the same (series, offset) rows, ED distances within 1e-9 (both rescore
    in float64), DTW within rtol 1e-4 / atol 1e-5 (the engines' tolerances,
    PERF.md §6);
  * admission control sheds with a typed error, close without drain fails
    the queued tickets, malformed requests fail on the client thread, the
    hold window adapts to load, `warmup` exercises fills 1, 2 and 4 and
    the first request after it builds and loads nothing, a failing
    dispatch surfaces through `Ticket.result` and the server keeps
    serving;
  * append and compact through the writer lane under concurrent queries:
    every answer equals a float64 brute force over the snapshot its
    ticket reports (not the float32 oracle, whose cancellation at d2 ~ 0
    is ROADMAP F3); a server over an engine paging under a budget gives
    the resident engine's answers and mirrors the page cache's counters;
  * the reference's thread-discipline lint (rule T1) finds nothing in the
    port's `serve/server.py` and `serve/metrics.py` and catches injected
    cross-thread and frozen-attribute writes;
  * `kernels/_build.load_all` from several threads at once builds and
    loads each library once (a stubbed compiler: no nvcc here);
  * both launchers run on the CPU at a tiny size, with one engine and
    with `--devices 2` (two spawned gloo ranks serving a distributed
    engine, the backend in the banner).

Queries are data windows plus N(0, 0.05) noise (ROADMAP Queue 3 P3).
"""
import json
import os
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis.threads import lint_source  # noqa: E402
from repro.core import Collection as JCollection  # noqa: E402
from repro.core import EnvelopeParams as JParams  # noqa: E402
from repro.core import QuerySpec as JQuerySpec  # noqa: E402
from repro.core import UlisseEngine as JEngine  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import UlisseServer as JServer  # noqa: E402
from repro_torch.convert import index_from_arrays  # noqa: E402
from repro_torch.core import (Collection, EnvelopeParams,  # noqa: E402
                              QuerySpec, UlisseEngine)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch import obs as launch_obs  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.serve import (AdmissionError, ServeConfig,  # noqa: E402
                               ServerClosed, UlisseServer)

PARAMS = dict(lmin=64, lmax=128, seg_len=16, card=64)
LENGTHS = [64, 96, 128]       # buckets 64, 128, 128: one dispatch may
                              # mix exact lengths inside bucket 128
SERVE_DIR = Path(__file__).resolve().parents[1] / "src" / "repro_torch" \
    / "serve"
SPECS = {"ed_knn": dict(k=3), "dtw_knn": dict(k=3, measure="dtw", r=5),
         "ed_range": dict(eps=5.0),
         "dtw_range": dict(eps=5.0, measure="dtw", r=5)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors on one torch thread: the tier-1 run has six workers
    on the same cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def walk():
    """The session collection's shape (24 x 192), from a fixed seed."""
    rng = np.random.default_rng(12345)
    return np.cumsum(rng.normal(size=(24, 192)), -1).astype(np.float32)


def _arrays(index):
    """A reference index flattened to the convert.py schema."""
    out = {f"envelopes.{f}": np.asarray(getattr(index.envelopes, f))
           for f in index.envelopes.__dataclass_fields__}
    for i, lvl in enumerate(index.levels):
        for f in ("paa_lo", "paa_hi", "valid"):
            out[f"levels.{i}.{f}"] = np.asarray(getattr(lvl, f))
    for f in ("data", "csum", "csum2", "center", "csum_lo", "csum2_lo"):
        out[f"collection.{f}"] = np.asarray(getattr(index.collection, f))
    out["breakpoints"] = np.asarray(index.breakpoints)
    return out


@pytest.fixture(scope="module")
def engines(walk):
    """(reference engine, port engine on the converted index), both at
    max_batch 4 as in the reference's serve tests."""
    p = dict(PARAMS, gamma=8, znorm=True)
    ref = JEngine.from_collection(JCollection.from_array(walk),
                                  JParams(**p), max_batch=4)
    idx = index_from_arrays(_arrays(ref.index), EnvelopeParams(**p),
                            device="cpu")
    return ref, UlisseEngine.from_index(idx, max_batch=4, device="cpu")


def _queries(data, seed, n=6, lengths=LENGTHS):
    rng = np.random.default_rng(seed)
    qs = []
    for i in range(n):
        qlen = lengths[i % len(lengths)]
        s = int(rng.integers(0, data.shape[0]))
        o = int(rng.integers(0, data.shape[1] - qlen + 1))
        qs.append(data[s, o:o + qlen]
                  + rng.normal(size=qlen).astype(np.float32) * 0.05)
    return qs


def _assert_same(res, ref, stats=True):
    np.testing.assert_array_equal(res.dists, ref.dists)
    np.testing.assert_array_equal(res.series, ref.series)
    np.testing.assert_array_equal(res.offsets, ref.offsets)
    if stats:
        assert res.stats == ref.stats


def _burst(server, qs):
    tickets = [server.submit(q) for q in qs]
    out = [t.result(timeout=300) for t in tickets]
    server.close()
    return out


@pytest.mark.parametrize("case", sorted(SPECS))
def test_coalesced_bit_equal_vs_serial(engines, walk, case):
    _, port = engines
    spec = QuerySpec(**SPECS[case])
    qs = _queries(walk, seed=len(case))
    refs = [port.search(q, spec) for q in qs]
    server = UlisseServer(port, spec, ServeConfig(window_ms=50.0,
                                                  max_batch=4))
    for res, ref in zip(_burst(server, qs), refs):
        _assert_same(res, ref)
    m = server.metrics.snapshot()
    assert m["total"]["admitted"] == m["total"]["completed"] == len(qs)
    assert m["total"]["failed"] == 0
    assert max(f for bm in m["buckets"].values()
               for f in bm["fill_hist"]) >= 2      # it did coalesce


@pytest.mark.parametrize("case", sorted(SPECS))
def test_served_answers_equal_reference_server(engines, walk, case):
    """One burst of four queries of one length (one fill-4 dispatch, so
    the reference compiles one program a spec) through both servers."""
    ref, port = engines
    qs = _queries(walk, seed=7 + len(case), n=4, lengths=[112])
    mine = _burst(UlisseServer(port, QuerySpec(**SPECS[case]),
                               ServeConfig(window_ms=50.0, max_batch=4)),
                  qs)
    theirs = _burst(JServer(ref, JQuerySpec(**SPECS[case]),
                            JServeConfig(window_ms=50.0, max_batch=4)), qs)
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a.series, b.series)
        np.testing.assert_array_equal(a.offsets, b.offsets)
        if "dtw" in case:
            np.testing.assert_allclose(a.dists, b.dists, rtol=1e-4,
                                       atol=1e-5)
        else:
            np.testing.assert_allclose(a.dists, b.dists, rtol=0, atol=1e-9)
        assert len(a.dists) > 0


def test_admission_control(engines, walk):
    """Submits beyond max_pending shed with a typed AdmissionError;
    close(drain=True) still answers everything admitted."""
    _, port = engines
    qs = _queries(walk, seed=21, n=3)
    refs = [port.search(q, QuerySpec(k=3)) for q in qs]
    # a window too long to expire and a batch too large to fill: the
    # queue can only move when close() cuts the window short
    server = UlisseServer(port, QuerySpec(k=3),
                          ServeConfig(window_ms=60_000.0, max_batch=8,
                                      max_pending=2))
    t0 = server.submit(qs[0])
    t1 = server.submit(qs[1])
    assert server.pending == 2
    with pytest.raises(AdmissionError) as exc:
        server.submit(qs[2])
    assert exc.value.pending == 2 and exc.value.max_pending == 2
    assert exc.value.bucket in (64, 128)
    assert server.metrics.snapshot()["total"]["rejected"] == 1
    server.close(drain=True)
    _assert_same(t0.result(0), refs[0])
    _assert_same(t1.result(0), refs[1])
    with pytest.raises(ServerClosed):
        server.submit(qs[0])


def test_close_without_drain_fails_queued(engines, walk):
    _, port = engines
    q = _queries(walk, seed=22, n=1)[0]
    server = UlisseServer(port, QuerySpec(k=3),
                          ServeConfig(window_ms=60_000.0, max_batch=8))
    t = server.submit(q)
    server.close(drain=False)
    with pytest.raises(ServerClosed):
        t.result(0)


def test_admission_validates_on_client_thread(engines):
    _, port = engines
    server = UlisseServer(port, QuerySpec(k=3),
                          ServeConfig(window_ms=1.0, max_batch=4))
    bad = np.ones(64, np.float32)
    bad[3] = np.nan
    for q in (np.zeros((2, 64), np.float32),      # not 1-D
              bad,                                # non-finite
              np.ones(32, np.float32),            # < lmin
              np.ones(200, np.float32)):          # > lmax
        with pytest.raises(ValueError):
            server.submit(q)
    with pytest.raises(ValueError):
        server.append(np.ones((2, 100), np.float32))   # wrong width
    server.close()
    assert server.metrics.snapshot()["total"]["admitted"] == 0


def test_warmup_exercises_every_fill_and_builds_nothing_after(engines,
                                                              walk):
    """warmup() runs fills 1, 2 and 4 through the writer lane (returns 3);
    afterwards the first served request builds and loads no kernel
    library (on the CPU none is ever built: the wrappers run their plain
    versions)."""
    _, port = engines
    qlen = 104
    server = UlisseServer(port, QuerySpec(k=3),
                          ServeConfig(window_ms=0.0, max_batch=4))
    assert server.warmup([qlen]) == 3
    before = dict(_build.COUNTS)
    res = server.search(walk[1, 11:11 + qlen].copy(), timeout=300)
    server.close()
    assert _build.COUNTS == before
    assert res.series[0] == 1 and res.offsets[0] == 11
    with pytest.raises(ValueError):
        port.warmup([200])                       # outside [lmin, lmax]
    with pytest.raises(ValueError):
        port.warmup([qlen], batch_sizes=[0])


def test_failing_dispatch_surfaces_and_server_keeps_serving(engines, walk,
                                                            monkeypatch):
    """A dispatch whose engine call raises fails exactly its batch's
    tickets with that exception (counted as failed); the next dispatch
    answers."""
    _, port = engines
    q1, q2 = _queries(walk, seed=23, n=2, lengths=[96])
    real, calls = port.search, []

    def flaky(qs, spec):
        calls.append(len(qs))
        if len(calls) == 1:
            raise RuntimeError("kernel refused the shape")
        return real(qs, spec)

    monkeypatch.setattr(port, "search", flaky)
    server = UlisseServer(port, QuerySpec(k=3),
                          ServeConfig(window_ms=0.0, max_batch=4))
    with pytest.raises(RuntimeError, match="refused"):
        server.search(q1, timeout=300)
    res = server.search(q2, timeout=300)
    server.close()
    monkeypatch.undo()
    _assert_same(res, port.search(q2, QuerySpec(k=3)))
    total = server.metrics.snapshot()["total"]
    assert total["failed"] == 1 and total["completed"] == 1


def test_adaptive_window_idle_fast_burst_batched(engines, walk):
    """A dispatch that drains every queue drops the hold window to 0, so
    a lone request on an idle server is answered at once; a backlog
    restores the configured window and the burst still coalesces."""
    _, port = engines
    spec = QuerySpec(k=3)
    server = UlisseServer(port, spec,
                          ServeConfig(window_ms=250.0, max_batch=4))
    server.warmup(LENGTHS)
    qs = _queries(walk, seed=24, n=9)
    _assert_same(server.search(qs[0]), port.search(qs[0], spec))
    t0 = time.perf_counter()
    res = server.search(qs[1])
    dt = time.perf_counter() - t0
    _assert_same(res, port.search(qs[1], spec))
    assert dt < 0.2, f"idle-server request took {dt * 1e3:.0f} ms"
    tickets = [server.submit(q) for q in qs]
    for q, t in zip(qs, tickets):
        _assert_same(t.result(timeout=300), port.search(q, spec))
    server.close()
    snap = server.metrics.snapshot()
    assert max(int(f) for row in snap["buckets"].values()
               for f in row["fill_hist"]) >= 2


def _brute64_knn(data, q, k):
    """Exact Z-normalized ED k-NN in float64 over every window: the
    (series, offset) rows and distances, ties by position."""
    qlen = len(q)
    w = np.lib.stride_tricks.sliding_window_view(
        data.astype(np.float64), qlen, axis=1).reshape(-1, qlen)
    w = (w - w.mean(1, keepdims=True)) / np.maximum(
        w.std(1, keepdims=True), 1e-8)
    qn = q.astype(np.float64)
    qn = (qn - qn.mean()) / max(qn.std(), 1e-8)
    d2 = ((w - qn) ** 2).sum(1)
    top = np.argsort(d2, kind="stable")[:k]
    n_off = data.shape[1] - qlen + 1
    return top // n_off, top % n_off, np.sqrt(d2[top])


def test_append_compact_while_querying(walk):
    """Live ingestion under concurrent query load: every answer equals a
    float64 brute force over the snapshot its ticket reports (distances
    within 1e-9: the engine rescores in float64), and writer ops bump the
    version monotonically; windows of the appended series are found once
    the append is in."""
    p = EnvelopeParams(gamma=8, znorm=True, **PARAMS)
    engine = UlisseEngine.from_collection(
        Collection.from_array(walk, device="cpu"), p, max_batch=4,
        device="cpu")
    grown = np.cumsum(np.random.default_rng(77).normal(size=(8, 192)),
                      axis=-1).astype(np.float32)
    after = np.concatenate([walk, grown])
    datasets = {0: walk, 1: after, 2: after}   # compact keeps the content
    server = UlisseServer(engine, QuerySpec(k=3),
                          ServeConfig(window_ms=1.0, max_batch=4))
    server.warmup(LENGTHS)
    # half the queries are windows of the series being appended
    qs = [q for pair in zip(_queries(walk, seed=31, n=9),
                            _queries(grown, seed=32, n=9)) for q in pair]
    out = [None] * len(qs)

    def client(cid):
        for i in range(cid, len(qs), 3):
            t = server.submit(qs[i])
            out[i] = (t, t.result(timeout=300))

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(3)]
    for t in threads:
        t.start()
    time.sleep(0.03)
    assert server.append(grown).result(timeout=300) == 1   # mid-traffic
    assert server.compact().result(timeout=300) == 2
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    # after the writer ops: every appended window is found
    late = [server.search(q, timeout=300) for q in qs[1::2]]
    assert server.version == 2
    server.close()

    for q, (ticket, res) in zip(qs, out):
        assert ticket.snapshot in datasets
        series, offsets, dists = _brute64_knn(datasets[ticket.snapshot], q,
                                              3)
        np.testing.assert_array_equal(res.series, series)
        np.testing.assert_array_equal(res.offsets, offsets)
        np.testing.assert_allclose(res.dists, dists, rtol=0, atol=1e-9)
    for q, res in zip(qs[1::2], late):
        series, offsets, dists = _brute64_knn(after, q, 3)
        np.testing.assert_array_equal(res.series, series)
        assert res.series[0] >= walk.shape[0]      # an appended series
        np.testing.assert_allclose(res.dists, dists, rtol=0, atol=1e-9)


@pytest.mark.parametrize("case", ["ed_knn", "ed_range"])
def test_server_over_paged_engine_equals_resident(engines, walk, tmp_path,
                                                  case):
    """A server over an engine paging under a quarter of its payload: the
    dispatcher's scans (and their prefetch worker) give the resident
    engine's answers and SearchStats bit for bit, and each dispatch
    mirrors the page cache's counters into the registry."""
    from repro_torch import obs
    from repro_torch.storage import open_index, save_index
    _, port = engines
    path = str(tmp_path / "idx")
    save_index(path, port.index, shard_rows=8, page_rows=4)
    budget = open_index(path, device="cpu").collection.payload_bytes // 4
    resident = UlisseEngine.open(path, max_batch=4, device="cpu")
    paged = UlisseEngine.open(path, max_batch=4, memory_budget_bytes=budget,
                              device="cpu")
    spec = QuerySpec(**SPECS[case])
    qs = _queries(walk, seed=41, n=6)
    prev = obs.set_registry(obs.MetricsRegistry())
    try:
        server = UlisseServer(paged, spec, ServeConfig(window_ms=50.0,
                                                       max_batch=4))
        got = _burst(server, qs)
        reg = obs.get_registry()
        misses = reg.get("ulisse_page_cache_misses_total")
        cached = reg.get("ulisse_page_cache_bytes")
    finally:
        obs.set_registry(prev)
    for res, q in zip(got, qs):
        _assert_same(res, resident.search(q, spec))
    assert misses == paged.page_cache_stats()["misses"] > 0
    assert 0 < cached <= budget
    assert not paged.index.collection.is_materialized


# -- the thread-discipline lint (rule T1) ------------------------------------

@pytest.mark.parametrize("name", ["server.py", "metrics.py"])
def test_thread_lint_clean_on_port_serve(name):
    source = (SERVE_DIR / name).read_text()
    assert "THREAD_METHODS" in source and "THREAD_ATTRS" in source
    assert lint_source(source, f"serve/{name}") == []


@pytest.mark.parametrize("inject,code", [
    # close() runs on the client thread; `_version` is dispatcher-owned
    ("self._version += 1", "cross-thread-write-_version"),
    # `engine` is frozen after __init__
    ("self.engine = None", "frozen-attr-write-engine")])
def test_thread_lint_catches_injected_write(inject, code):
    source = (SERVE_DIR / "server.py").read_text()
    anchor = "self._closed = True"
    assert anchor in source
    bad = source.replace(anchor, anchor + "\n" + " " * 12 + inject, 1)
    codes = {f.code for f in lint_source(bad, "serve/server.py")}
    assert code in codes, codes


# -- the kernels' build from several threads ----------------------------------

def test_load_all_builds_and_loads_once_across_threads(tmp_path,
                                                       monkeypatch):
    """Threads that first need the kernels together (the server's
    dispatcher and the caller) build each library once and load it once;
    no two compiler runs share a temporary output."""
    started, loaded = [], []
    lock = threading.Lock()

    class FakeCompiler:
        def __init__(self, argv, **kwargs):
            out = Path(argv[argv.index("-o") + 1])
            with lock:
                started.append(out)
            time.sleep(0.05)                 # let racing threads overlap
            out.write_bytes(b"stub")
            self.returncode = 0

        def communicate(self):
            return "registers: 1", None

    class FakeLib:
        def __init__(self, path):
            with lock:
                loaded.append(path)
            self.fns = {}

        def __getattr__(self, fn):
            return self.fns.setdefault(fn, type("Fn", (), {})())

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "COUNTS", {"builds": 0, "loads": 0})
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", FakeCompiler)
    monkeypatch.setattr(_build.ctypes, "CDLL", FakeLib)
    barrier = threading.Barrier(6)
    errors = []

    def first_use(name):
        try:
            barrier.wait(timeout=30)
            _build.library(name)
        except Exception as e:          # noqa: BLE001 — reported below
            errors.append(e)

    names = sorted(_build.SIGNATURES)
    threads = [threading.Thread(target=first_use,
                                args=(names[i % len(names)],))
               for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errors, errors
    n = len(_build.SIGNATURES)
    assert len(started) == len(set(started)) == n
    assert _build.COUNTS == {"builds": n, "loads": n}
    assert sorted(loaded) == sorted(str(_build._target(m)) for m in names)
    assert sorted(_build._LIBS) == names
    # a later first use in another thread reuses everything
    threading.Thread(target=_build.load_all).start()
    _build.load_all()
    assert _build.COUNTS == {"builds": n, "loads": n}
    assert not list(tmp_path.glob("*.tmp"))


# -- the launchers --------------------------------------------------------------

def test_serve_launcher_on_cpu(capfd):
    args = ["--device", "cpu", "--series", "32", "--series-len", "128",
            "--queries", "6", "--clients", "3", "--window-ms", "5"]
    assert launch_serve.main(args) == 0
    out = capfd.readouterr().out
    assert "serial baseline" in out and "served 6 queries" in out
    assert "local pipeline on cpu" in out
    # two ranks (spawned; rank 0 prints): a server over a distributed
    # engine, the backend in the banner
    assert launch_serve.main(args + ["--devices", "2"]) == 0
    out = capfd.readouterr().out
    assert "sharded scan, 2 ranks over gloo on cpu" in out
    assert "serial baseline" in out and "served 6 queries" in out


def test_obs_launcher_writes_three_artifacts(tmp_path, capfd):
    from repro_torch import obs
    prev_tr = obs.set_tracer(obs.Tracer())
    prev_reg = obs.set_registry(obs.MetricsRegistry())
    try:
        out = tmp_path / "obs"
        assert launch_obs.main(["--device", "cpu", "--series", "16",
                                "--series-len", "128", "--queries", "6",
                                "--out", str(out)]) == 0
    finally:
        obs.set_tracer(prev_tr)
        obs.set_registry(prev_reg)
    assert sorted(os.listdir(out)) == ["metrics.json", "metrics.prom",
                                       "trace.json"]
    names = {e["name"] for e in json.loads(
        (out / "trace.json").read_text())["traceEvents"]}
    assert {"serve.dispatch", "query.exact_device", "query.approx_device",
            "query.range_device", "device_scan"} <= names
    prom = (out / "metrics.prom").read_text()
    assert "ulisse_serve_latency_seconds_bucket" in prom
    assert 'ulisse_engine_queries{backend="device"}' in prom
    snap = json.loads((out / "metrics.json").read_text())
    assert snap["ulisse_serve_completed_total"]["kind"] == "counter"
    # two ranks: rank 0 traces the distributed engine and writes the
    # artifacts
    out2 = tmp_path / "obs2"
    assert launch_obs.main(["--device", "cpu", "--devices", "2", "--series",
                            "16", "--series-len", "128", "--queries", "6",
                            "--out", str(out2)]) == 0
    assert "the distributed engine (2 ranks over gloo on cpu)" in \
        capfd.readouterr().out
    assert sorted(os.listdir(out2)) == ["metrics.json", "metrics.prom",
                                        "trace.json"]
    names = {e["name"] for e in json.loads(
        (out2 / "trace.json").read_text())["traceEvents"]}
    assert {"serve.dispatch", "query.sharded_knn",
            "query.sharded_range"} <= names
    assert 'ulisse_engine_queries{backend="distributed"}' in \
        (out2 / "metrics.prom").read_text()
