"""The port's host-sync budget (the JAX package's R2,
`repro/analysis/transfers.py` and `audit.py:_audit_host_sync`):
`repro_torch.analysis` on the CPU, where the counter patches the
chokepoints through which a torch tensor becomes a host value.

  * the counter counts real traffic: N exports are N, a conversion
    inside another is one, host numpy work is none;
  * every device path (local exact, approximate and range, the delta,
    the sharded k-NN and range in a world of one, the paged paths) holds
    its budget at B = 1 and 8: one result readback a batch, every other
    sync a stop test, a round or a chunk of range continuation, and the
    independent count equal to the port's own counters (the paged
    paths' excess accepted with its reason, as the reference accepts
    its own);
  * the host backend registers more than one sync a query.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import audit, transfers  # noqa: E402
from repro_torch.core import QuerySpec  # noqa: E402


def test_counter_counts_every_export_once():
    """N `.numpy()` exports of N tensors count N; numpy's conversion
    (which calls `.numpy()` inside) and each scalar readback count one;
    work on host arrays counts nothing; the patches come off after."""
    ts = [torch.arange(6, dtype=torch.float32) + i for i in range(5)]
    with transfers.count_transfers("cpu") as c:
        for t in ts:
            t.numpy()
        host = np.asarray(ts[0])
        bool(ts[1].sum() > 0), int(ts[2][0]), float(ts[3][1])
        ts[4].tolist(), ts[4][2].item()
        (host * 2).sum()
    assert c.syncs == 5 + 1 + 3 + 2
    assert c.kinds["numpy"] == 5 and c.kinds["__array__"] == 1
    assert sum(c.sites.values()) == c.syncs
    with transfers.count_transfers("cpu") as after:
        pass
    ts[0].numpy()
    assert after.syncs == 0


def test_measure_steady_state_skips_the_warmup():
    calls = []

    def fn():
        calls.append(1)
        if len(calls) == 1:          # first use only
            torch.ones(3).numpy()
        return torch.zeros(2).tolist()

    counter = transfers.measure_steady_state(fn, warmups=1)
    assert len(calls) == 2 and counter.syncs == 1


@pytest.fixture(scope="module")
def rows():
    return audit.audit_host_sync("cpu", batches=(1, 8))


def test_every_path_runs_at_both_batch_sizes(rows):
    paths = {r["path"] for r in rows}
    assert {"local_knn[ed]", "local_knn[dtw]", "local_knn[approx]",
            "local_range", "local_range[overflow]", "delta_knn",
            "delta_range", "sharded_knn", "sharded_range",
            "local_paged_knn", "local_paged_range"} <= paths
    for p in paths:
        assert sorted(r["b"] for r in rows if r["path"] == p) == [1, 8]


def test_device_paths_hold_their_budget(rows):
    """One readback a batch; no host work but the overflow's
    continuation; nothing over budget that is not accepted."""
    assert audit.findings(rows) == []
    for r in rows:
        c = r["counters"]
        assert c["readback"] >= 1
        if r["accepted"]:
            continue
        assert r["ok"], r
        assert c["readback"] == 1, r
        if "overflow" in r["path"]:
            assert c["host"] > 0
        else:
            assert c["host"] == 0
        if r["path"].startswith("sharded"):
            assert c["collective"] >= 2
        assert c["stop_test"] + c["collective"] >= 1


def test_independent_count_equals_port_counters(rows):
    """The count through the patched chokepoints equals the port's own
    counters on every path but the accepted paged ones."""
    for r in rows:
        if not r["accepted"]:
            assert r["syncs"] == sum(r["counters"].values()), r
    # the batch size does not change a local path's count
    by = {(r["path"], r["b"]): r["syncs"] for r in rows}
    for p in ("local_knn[ed]", "local_knn[dtw]", "local_range",
              "delta_knn"):
        assert by[(p, 1)] == by[(p, 8)]


def test_host_backend_syncs_more_than_once_a_query(tmp_path):
    """The host backend reads every chunk back (`to_host`): more than one
    sync a query, which the device paths avoid."""
    eng = audit.engines("cpu", str(tmp_path))
    q = audit._queries(eng["data"], 1)[0]
    spec = QuerySpec(k=3, scan_backend="host", chunk_size=16)
    counter = transfers.measure_steady_state(
        lambda: eng["local"].search(q, spec))
    device = transfers.measure_steady_state(
        lambda: eng["local"].search(q, QuerySpec(k=3, chunk_size=16)))
    assert counter.syncs > 1
    assert counter.syncs > device.syncs
