"""Port parity, observability: `repro_torch.obs` (CPU) against the JAX
package's `repro.obs` contract and on the same numpy inputs.

  * the tracer: a disabled span is the shared null singleton, nesting
    records depth and attributes, sampling is decided per root and
    inherited, the ring keeps the newest `capacity` spans,
    `record_interval` obeys `enabled` only, `configure` validates, the
    Chrome export is valid JSON in microseconds; `torch_annotations`
    puts the spans in a `torch.profiler` trace, and a failure to enter
    the range never breaks the span;
  * the registry: counter / gauge / histogram round trip, kind clashes
    and negative counters raise, the Prometheus text format;
    `record_search_stats` by backend, and `_check_stats_schema` failing
    on a drift of `executor.STATS_COLUMNS` (the reference's rule R5);
  * `ServeMetrics`: the total's mean fill folds failed dispatches, the
    registry mirror survives `reset`;
  * end to end: one query served by the port's `UlisseServer` leaves
    admission -> queue wait -> dispatch -> device scan -> merge spans and
    one scrape holds serving latency beside the engine's pruning
    counters; and the same query served by both packages leaves the same
    span tree (names, depths, attribute keys in order).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as jobs  # noqa: E402
from repro.core import Collection as JCollection  # noqa: E402
from repro.core import EnvelopeParams as JParams  # noqa: E402
from repro.core import QuerySpec as JQuerySpec  # noqa: E402
from repro.core import UlisseEngine as JEngine  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import UlisseServer as JServer  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.convert import index_from_arrays  # noqa: E402
from repro_torch.core import (EnvelopeParams, QuerySpec,  # noqa: E402
                              UlisseEngine, executor)
from repro_torch.obs import MetricsRegistry, Tracer  # noqa: E402
from repro_torch.obs.tracer import _NULL_SPAN  # noqa: E402
from repro_torch.serve import ServeConfig, UlisseServer  # noqa: E402
from repro_torch.serve.metrics import ServeMetrics  # noqa: E402

PARAMS = dict(lmin=64, lmax=128, seg_len=16, card=64, gamma=8, znorm=True)


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
    """(reference engine, port engine on the converted index), max_batch
    2 as in the reference's end-to-end trace test."""
    ref = JEngine.from_collection(JCollection.from_array(walk),
                                  JParams(**PARAMS), max_batch=2)
    idx = index_from_arrays(_arrays(ref.index), EnvelopeParams(**PARAMS),
                            device="cpu")
    return ref, UlisseEngine.from_index(idx, max_batch=2, device="cpu")


# -------------------------------------------------------------------------
# tracer
# -------------------------------------------------------------------------

def test_disabled_span_is_shared_null_singleton():
    tr = Tracer()
    assert tr.span("a") is _NULL_SPAN
    assert tr.span("b", attr=1) is tr.span("c")
    with tr.span("a") as sp:
        sp.set(k=1)              # attribute set is a no-op, not an error
    tr.record_interval("w", 0.0, 1.0)
    assert len(tr) == 0


def test_nested_spans_record_depth_and_attrs():
    tr = Tracer(enabled=True)
    with tr.span("root", qlen=128) as r:
        with tr.span("child") as c:
            c.set(chunks=4)
        r.set(batch=2)
    spans = tr.drain()
    assert [s.name for s in spans] == ["child", "root"]  # close order
    child, root = spans
    assert child.depth == 1 and root.depth == 0
    assert root.attrs == {"qlen": 128, "batch": 2}
    assert child.attrs == {"chunks": 4}
    assert child.t0 >= root.t0
    assert child.dur <= root.dur
    assert len(tr) == 0


def test_sampling_decision_is_per_root_and_inherited():
    tr = Tracer(enabled=True, sample_every=2)
    kept = []
    for _ in range(6):
        with tr.span("root"):
            with tr.span("child"):
                pass
        kept.append(len(tr.drain()))
    # every other root records, always with its child: never a partial
    # trace
    assert sorted(set(kept)) == [0, 2]
    assert kept.count(2) == 3


def test_ring_buffer_capacity_keeps_newest():
    tr = Tracer(enabled=True, capacity=3)
    for i in range(7):
        with tr.span(f"s{i}"):
            pass
    assert [s.name for s in tr.snapshot()] == ["s4", "s5", "s6"]


def test_record_interval_respects_enabled_only():
    tr = Tracer(enabled=True, sample_every=1000)   # roots unsampled
    tr.record_interval("queue_wait", 1.0, 1.5, bucket=128)
    (s,) = tr.snapshot()
    assert s.name == "queue_wait"
    assert s.dur == pytest.approx(0.5)
    assert s.attrs == {"bucket": 128}


def test_configure_validates_and_rebounds():
    tr = Tracer()
    with pytest.raises(ValueError):
        tr.configure(sample_every=0)
    with pytest.raises(ValueError):
        tr.configure(capacity=0)
    tr.configure(enabled=True, capacity=2)
    for i in range(4):
        with tr.span(f"s{i}"):
            pass
    assert [s.name for s in tr.snapshot()] == ["s2", "s3"]


def test_chrome_trace_is_valid_json_with_microsecond_events():
    tr = Tracer(enabled=True)
    with tr.span("outer", qlen=96):
        with tr.span("inner"):
            pass
    doc = json.loads(json.dumps(tr.chrome_trace()))
    evs = doc["traceEvents"]
    meta = [e for e in evs if e["ph"] == "M"]
    xs = [e for e in evs if e["ph"] == "X"]
    assert meta and meta[0]["args"]["name"] == "ulisse"
    assert {e["name"] for e in xs} == {"outer", "inner"}
    for e in xs:
        assert e["ts"] >= 0 and e["dur"] >= 0       # microseconds
        assert e["cat"] == "ulisse"
    outer = next(e for e in xs if e["name"] == "outer")
    assert outer["args"]["qlen"] == 96


def test_torch_annotations_reach_the_torch_profiler(monkeypatch):
    """With torch_annotations a recorded span is also a record_function
    range (visible in a torch.profiler trace); without it, not.  A range
    that cannot be entered leaves the span recorded and the caller
    unharmed."""
    from torch.profiler import ProfilerActivity, profile
    for annotate in (True, False):
        tr = Tracer(enabled=True, torch_annotations=annotate)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with tr.span("ulisse_outer"):
                with tr.span("ulisse_inner"):
                    torch.ones(4).sum()
        names = {e.name for e in prof.events()}
        assert ({"ulisse_outer", "ulisse_inner"} <= names) is annotate
        assert [s.name for s in tr.drain()] == ["ulisse_inner",
                                                "ulisse_outer"]

    def broken(name):
        raise RuntimeError("profiler unavailable")

    monkeypatch.setattr(torch.profiler, "record_function", broken)
    tr = Tracer(enabled=True, torch_annotations=True)
    with tr.span("still_recorded", qlen=3):
        pass
    (s,) = tr.drain()
    assert s.name == "still_recorded" and s.attrs == {"qlen": 3}


# -------------------------------------------------------------------------
# registry
# -------------------------------------------------------------------------

def test_registry_counter_gauge_histogram_roundtrip():
    reg = MetricsRegistry()
    reg.inc("req_total", 2.0, help_text="requests", bucket=128)
    reg.inc("req_total", bucket=128)
    reg.inc("req_total", bucket=256)
    reg.set_gauge("depth", 7.0, bucket=128)
    reg.observe("lat_seconds", 0.004, buckets=(0.001, 0.01, 0.1))
    reg.observe("lat_seconds", 0.04, buckets=(0.001, 0.01, 0.1))
    assert reg.get("req_total", bucket=128) == 3.0
    assert reg.get("req_total", bucket=256) == 1.0
    assert reg.get("req_total", bucket=999) is None
    assert reg.get("depth", bucket=128) == 7.0
    snap = reg.snapshot()
    (h,) = snap["lat_seconds"]["series"]
    assert h["count"] == 2 and h["sum"] == pytest.approx(0.044)
    assert [b["count"] for b in h["buckets"]] == [0, 1, 1]
    json.loads(reg.json_text())


def test_registry_kind_clash_and_negative_counter_raise():
    reg = MetricsRegistry()
    reg.inc("x_total")
    with pytest.raises(ValueError, match="counter"):
        reg.observe("x_total", 1.0)
    with pytest.raises(ValueError, match="only go up"):
        reg.inc("y_total", -1.0)
    with pytest.raises(ValueError, match="invalid metric name"):
        reg.inc("bad name")


def test_prometheus_text_exposition_format():
    """The port's registry prints the reference's text for the same
    records, line for line."""
    lines = []
    for reg in (MetricsRegistry(), jobs.MetricsRegistry()):
        reg.inc("ulisse_serve_completed_total", 5, help_text="done",
                bucket=128)
        for v in (0.004, 0.05):
            reg.observe("ulisse_serve_latency_seconds", v,
                        buckets=(0.001, 0.01, 0.1), bucket=128)
        text = reg.prometheus_text()
        assert text.endswith("\n")
        lines.append(text.strip().splitlines())
    got, want = lines
    assert got == want
    assert "# TYPE ulisse_serve_completed_total counter" in got
    assert 'ulisse_serve_completed_total{bucket="128"} 5' in got
    for le, n in (("0.001", 0), ("0.01", 1), ("0.1", 2), ("+Inf", 2)):
        assert ('ulisse_serve_latency_seconds_bucket'
                f'{{bucket="128",le="{le}"}} {n}') in got
    assert 'ulisse_serve_latency_seconds_count{bucket="128"} 2' in got


def test_record_search_stats_labels_by_backend():
    st = executor.SearchStats(envelopes_total=10, envelopes_checked=6,
                              envelopes_pruned=4, lb_computations=10,
                              true_dist_computations=40, chunks_visited=2,
                              chunks_planned=3)
    reg = MetricsRegistry()
    obs.record_search_stats(st, backend="device", registry=reg)
    obs.record_search_stats(st, backend="host", registry=reg)
    assert reg.get("ulisse_engine_envelopes_pruned", backend="device") == 4
    assert reg.get("ulisse_engine_chunks_planned", backend="host") == 3
    assert reg.get("ulisse_engine_queries", backend="device") == 1
    # the same records the reference exports from its own SearchStats
    from repro.core.executor import SearchStats as JStats
    jreg = jobs.MetricsRegistry()
    jobs.record_search_stats(JStats(**{
        f: getattr(st, f) for f in JStats.__dataclass_fields__}),
        backend="device", registry=jreg)
    obs.record_search_stats(st, backend="device",
                            registry=(mine := MetricsRegistry()))
    assert mine.prometheus_text() == jreg.prometheus_text()


@pytest.mark.parametrize("drift", ["new_column", "width"])
def test_stats_schema_drift_fails(monkeypatch, drift):
    """Rule R5: a device stats column with no exporter field, or a width
    that disagrees with the columns, fails the schema check."""
    obs._check_stats_schema()                      # the shipped schema
    if drift == "new_column":
        monkeypatch.setattr(executor, "STATS_COLUMNS",
                            executor.STATS_COLUMNS + ("new_counter",))
        monkeypatch.setattr(executor, "STATS_WIDTH",
                            executor.STATS_WIDTH + 1)
        match = "new_counter"
    else:
        monkeypatch.setattr(executor, "STATS_WIDTH",
                            executor.STATS_WIDTH + 1)
        match = "missing"
    with pytest.raises(RuntimeError, match=match):
        obs._check_stats_schema()


# -------------------------------------------------------------------------
# serve metrics mirroring
# -------------------------------------------------------------------------

def test_total_mean_fill_counts_failed_dispatches():
    m = ServeMetrics(registry=MetricsRegistry())
    m.record_dispatch(128, fill=4, waits=[0.001] * 4)
    m.record_failed(128, 4)                        # whole batch fails
    m.record_dispatch(256, fill=2, waits=[0.001] * 2)
    m.record_done(256, latencies=[0.01, 0.02])
    snap = m.snapshot()
    assert snap["total"]["dispatches"] == 2
    assert snap["total"]["completed"] == 2
    assert snap["total"]["failed"] == 4
    assert snap["total"]["mean_fill"] == 3.0       # (4 + 2) / 2
    assert snap["buckets"][128]["mean_fill"] == 4.0
    assert snap["buckets"][256]["mean_fill"] == 2.0


def test_serve_metrics_mirror_into_registry_and_reset_keeps_it():
    reg = MetricsRegistry()
    m = ServeMetrics(registry=reg)
    m.record_admit(128)
    m.record_dispatch(128, fill=2, waits=[0.001, 0.002])
    m.record_done(128, latencies=[0.01, 0.02])
    m.record_reject(128)
    m.record_failed(128, 1)
    assert reg.get("ulisse_serve_admitted_total", bucket=128) == 1
    assert reg.get("ulisse_serve_dispatches_total", bucket=128) == 1
    assert reg.get("ulisse_serve_completed_total", bucket=128) == 2
    assert reg.get("ulisse_serve_rejected_total", bucket=128) == 1
    assert reg.get("ulisse_serve_failed_total", bucket=128) == 1
    (lat,) = reg.snapshot()["ulisse_serve_latency_seconds"]["series"]
    assert lat["count"] == 2
    m.reset()
    assert m.snapshot()["total"]["dispatches"] == 0
    assert reg.get("ulisse_serve_completed_total", bucket=128) == 2


# -------------------------------------------------------------------------
# end to end: one served query traced admission -> dispatch -> scan
# -------------------------------------------------------------------------

def _serve_traced(obs_mod, server_cls, config, engine, spec, q):
    """Serve `q` once with a fresh tracer and registry swapped in:
    (result, finished spans, Chrome trace, Prometheus text)."""
    prev_tr = obs_mod.set_tracer(obs_mod.Tracer(enabled=True))
    prev_reg = obs_mod.set_registry(obs_mod.MetricsRegistry())
    try:
        server = server_cls(engine, spec, config)
        res = server.search(q, timeout=300)
        server.close()           # joins the dispatcher: every record is in
        tracer = obs_mod.get_tracer()
        return (res, tracer.snapshot(), tracer.chrome_trace(),
                server.metrics_text())
    finally:
        obs_mod.set_tracer(prev_tr)
        obs_mod.set_registry(prev_reg)


def test_one_served_query_traced_end_to_end(engines, walk):
    _, port = engines
    res, _, doc, text = _serve_traced(
        obs, UlisseServer, ServeConfig(max_batch=2), port, QuerySpec(k=3),
        walk[0, 5:5 + 96])
    assert res.stats.true_dist_computations > 0
    doc = json.loads(json.dumps(doc))
    names = {e["name"] for e in doc["traceEvents"]}
    for required in ("serve.admission", "serve.queue_wait",
                     "serve.dispatch", "query.exact_device", "prepare",
                     "approx_pass", "pack", "device_scan", "merge"):
        assert required in names, (required, sorted(names))
    evs = {e["name"]: e for e in doc["traceEvents"] if e["ph"] == "X"}
    disp, scan = evs["serve.dispatch"], evs["device_scan"]
    assert disp["ts"] <= scan["ts"]
    assert scan["ts"] + scan["dur"] <= disp["ts"] + disp["dur"] + 1
    assert evs["query.exact_device"]["args"]["qlen"] == 96
    for line in ("ulisse_serve_latency_seconds_bucket", 'le="+Inf"',
                 "ulisse_serve_completed_total",
                 'ulisse_engine_true_dist_computations{backend="device"}',
                 "ulisse_engine_envelopes_checked"):
        assert line in text


@pytest.mark.parametrize("spec_kw", [dict(k=3), dict(eps=4.0)],
                         ids=["knn", "range"])
def test_served_span_tree_equals_reference(engines, walk, spec_kw):
    """One query served by each package under its own tracer: the same
    spans (name, depth, attribute keys in order) in start order, and the
    same answer."""
    ref, port = engines
    q = walk[3, 20:20 + 112] + np.random.default_rng(1).normal(
        size=112).astype(np.float32) * 0.05
    trees, answers = [], []
    for obs_mod, server_cls, config, engine, spec in (
            (obs, UlisseServer, ServeConfig(max_batch=2), port,
             QuerySpec(**spec_kw)),
            (jobs, JServer, JServeConfig(max_batch=2), ref,
             JQuerySpec(**spec_kw))):
        res, spans, _, _ = _serve_traced(obs_mod, server_cls, config,
                                         engine, spec, q)
        spans = sorted(spans, key=lambda s: (s.t0, -s.dur))
        trees.append([(s.name, s.depth, tuple(s.attrs or {}))
                      for s in spans])
        answers.append(res)
    assert trees[0] == trees[1]
    assert trees[0][0][0] == "serve.admission"
    assert {"serve.dispatch", "device_scan", "merge"} <= {
        name for name, _, _ in trees[0]}
    mine, theirs = answers
    np.testing.assert_array_equal(mine.series, theirs.series)
    np.testing.assert_array_equal(mine.offsets, theirs.offsets)
    np.testing.assert_allclose(mine.dists, theirs.dists, rtol=0, atol=1e-9)


def test_quickstart_stats_surface():
    rng = np.random.default_rng(0)
    data = np.cumsum(rng.normal(size=(8, 128)), -1).astype(np.float32)
    from repro_torch.core import Collection
    p = EnvelopeParams(lmin=48, lmax=64, gamma=8, seg_len=8, card=64,
                       znorm=True)
    engine = UlisseEngine.from_collection(
        Collection.from_array(data, device="cpu"), p, device="cpu")
    res = engine.search(data[0, 3:3 + 48], QuerySpec(k=2))
    d = res.stats.as_dict()
    for field in ("pruning_power", "chunks_visited", "chunks_planned",
                  "envelopes_pruned", "true_dist_computations"):
        assert field in d
    assert 0.0 <= d["pruning_power"] <= 1.0
    assert d["chunks_planned"] >= d["chunks_visited"] >= 0


def test_engine_spans_are_free_when_disabled(engines, walk):
    """The engine calls span() unconditionally: with the process tracer
    disabled nothing is recorded and the answer is the traced one."""
    _, port = engines
    q = walk[1, 7:7 + 80]
    prev = obs.set_tracer(Tracer())
    try:
        plain = port.search(q, QuerySpec(k=3))
        assert len(obs.get_tracer()) == 0
        obs.get_tracer().configure(enabled=True)
        traced = port.search(q, QuerySpec(k=3))
        names = [s.name for s in obs.get_tracer().drain()]
    finally:
        obs.set_tracer(prev)
    assert names[-1] == "query.exact_device"
    np.testing.assert_array_equal(plain.dists, traced.dists)
    np.testing.assert_array_equal(plain.series, traced.series)
