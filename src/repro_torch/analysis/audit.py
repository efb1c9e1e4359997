"""The host-sync budget audit (the JAX package's R2, `repro/analysis/
audit.py:_audit_host_sync`): every device search path of the port held
to its stop tests + 1 result readback a same-length batch, counted
independently (`transfers`) and against the port's own counters.

Engines: a local one (ED and DTW k-NN exact and approximate, ED range,
and ED range at a capacity its hits overflow, which finishes on the host:
+ 1 sync a chunk of that continuation); the same collection with a part
appended (the delta, searched as main ++ delta); a distributed engine in
a world of one (this process alone: gloo on the CPU, NCCL on the card;
sharded k-NN and range); and a paging engine (a memory budget below its
payload).  Each path runs a warm batch of 1 and of 8 queries.

The port's counters, which the independent count must equal:
`executor.read_back.syncs` (a batch's result readback; a paged scan's
plan readback), `executor.device_exact_scan.syncs` /
`device_range_scan.syncs` (the stop tests), `executor.to_host.syncs`
(host work: the range continuation, the planner's host plans),
`executor.PAGED["syncs"]` (the paged scans' stop tests) and
`collectives.STATS["syncs"]` (a sharded round's exchange on the card:
the stream wait before it under NCCL).  The budget: exactly one
readback a batch, and every other sync a stop test, a round or a chunk
of host continuation.  The paged paths read their plan back as their
page schedule and test their stop on the host; that excess is accepted,
with its reason, in `BASELINE`, as the reference's
`analysis_baseline.json` accepts its own paged excess.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
from typing import List, Optional

import numpy as np
import torch

from repro_torch.analysis import transfers

# the reference's audit collection: tiny envelopes and plans
PARAMS = dict(lmin=32, lmax=48, gamma=4, seg_len=8, card=64)
SERIES_LEN = 96

# accepted excess: path -> why (the reference's analysis_baseline.json
# accepts the same for its paged paths)
BASELINE = {
    "local_paged_knn": (
        "accepted: planned transfers of the paged backend.  The LB-sorted "
        "plan is read back once a scan (the approximate stage's and the "
        "exact scan's) because the plan IS the page schedule: a slab "
        "gather cannot run on the device when the payload exceeds the "
        "memory budget; the stop test reads the pool's k-th back every "
        "STOP_TEST_EVERY chunks.  O(plan) ids and O(batch) scalars, no "
        "payload; the prefetch copies overlap the steps and do not sync.  "
        "On the CPU the slab fill's writes through numpy views of its "
        "host buffers count too (a CPU tensor cannot be told from a "
        "device one there)."),
    "local_paged_range": (
        "accepted: planned transfers of the paged backend.  One plan "
        "readback (the page schedule), the stop test's overflow readback "
        "while a query is live, and the batch's hit buffers; on the CPU "
        "also the slab fill's numpy views, as for local_paged_knn."),
}


def port_syncs() -> dict:
    """The port's own sync counters, by kind."""
    from repro_torch.core import executor
    from repro_torch.distributed import collectives
    return {"readback": executor.read_back.syncs,
            "stop_test": (executor.device_exact_scan.syncs
                          + executor.device_range_scan.syncs),
            "host": executor.to_host.syncs,
            "paged": executor.PAGED["syncs"],
            "collective": collectives.STATS["syncs"]}


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


@contextlib.contextmanager
def world_of_one(device):
    """A process group of this process alone (gloo on the CPU, NCCL on
    the card) unless one is up already; torn down after."""
    import torch.distributed as dist
    if dist.is_initialized():
        yield
        return
    with tempfile.TemporaryDirectory() as tmp:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
        dist.init_process_group(backend, init_method=f"file://{tmp}/rdv",
                                world_size=1, rank=0)
        try:
            yield
        finally:
            dist.destroy_process_group()


def engines(device, tmp: str, series: int = 16, seed: int = 0) -> dict:
    """The audit's engines on `device` (the paging one opened from a
    save under `tmp`; a distributed one needs a process group:
    `world_of_one`)."""
    from repro_torch.core import (Collection, EnvelopeParams, UlisseEngine)
    rng = np.random.default_rng(seed)
    data = np.cumsum(rng.normal(size=(series, SERIES_LEN)),
                     -1).astype(np.float32)
    part = np.cumsum(rng.normal(size=(4, SERIES_LEN)), -1).astype(np.float32)
    p = EnvelopeParams(**PARAMS)
    local = UlisseEngine.from_collection(
        Collection.from_array(data, device=device), p, device=device)
    delta = UlisseEngine.from_collection(
        Collection.from_array(data, device=device), p, device=device)
    delta.append(part)
    local.save(os.path.join(tmp, "index"))
    paged = UlisseEngine.open(os.path.join(tmp, "index"),
                              memory_budget_bytes=data.nbytes // 4,
                              device=device)
    out = {"local": local, "delta": delta, "paged": paged, "data": data}
    import torch.distributed as dist
    if dist.is_initialized():
        out["sharded"] = UlisseEngine.distributed(
            None, p, data, breakpoints=local.index.breakpoints,
            device=device)
    return out


def _paths(eng: dict, local_eps: float, chunk_size: int):
    """(path, engine, spec, query length) of every audited path; the local
    engine's range radius `local_eps` (the small engines' 3.0)."""
    from repro_torch.core import QuerySpec
    knn = QuerySpec(k=3, chunk_size=16)
    rng = QuerySpec(eps=3.0, range_capacity=64, chunk_size=16)
    lq = eng.get("qlen", 40)
    out = [("local_knn[ed]", "local", QuerySpec(k=3, chunk_size=chunk_size),
            lq),
           ("local_knn[dtw]", "local",
            QuerySpec(k=3, measure="dtw", r=3, chunk_size=chunk_size), lq),
           ("local_knn[approx]", "local",
            QuerySpec(k=3, mode="approx", chunk_size=chunk_size), lq),
           ("local_range", "local",
            QuerySpec(eps=local_eps, range_capacity=64,
                      chunk_size=chunk_size), lq),
           # on the small engine always: a full-size index's host tail
           # would walk thousands of chunks
           ("local_range[overflow]", "small",
            QuerySpec(eps=3.0, range_capacity=1, chunk_size=16), 40),
           ("delta_knn", "delta", knn, 40),
           ("delta_range", "delta", rng, 40),
           ("local_paged_knn", "paged", knn, 40),
           ("local_paged_range", "paged", rng, 40)]
    if "sharded" in eng:
        out += [("sharded_knn", "sharded", knn, 40),
                ("sharded_range", "sharded", rng, 40)]
    return out


def _queries(data, b: int, qlen: int = 40):
    """b windows of `data` of length qlen, with N(0, 0.05) noise."""
    rng = np.random.default_rng(b)
    span = data.shape[1] - qlen + 1
    return [data[i % len(data), 7 * i % span:7 * i % span + qlen]
            + rng.normal(size=qlen).astype(np.float32) * 0.05
            for i in range(b)]


def audit_host_sync(device=None, batches=(1, 8), series: int = 16,
                    local=None, local_data=None, local_qlen: int = 0
                    ) -> List[dict]:
    """Every device path's warm batch of each size in `batches`: the
    independent count (`transfers.measure_steady_state` on `device`,
    default CUDA), the port's counters, and the verdict.  A row: path, b,
    device, syncs, counters (by kind), sites (file:line -> count, the
    independent count's), ok, and accepted (the reason, for an accepted
    excess).  `local` (with its raw series `local_data` and a query
    length `local_qlen`): an engine of the caller's for the local paths
    (a full-size index), its range radius 1.02x the least 3rd-nearest
    distance of a batch (a few hits a query, inside capacity 64; a
    median radius gives smooth queries thousands), at its default chunk
    size."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("the audit runs on the card by default; "
                               "pass device='cpu' to run it on the CPU")
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    rows = []
    from repro_torch.core import QuerySpec
    with world_of_one(device), tempfile.TemporaryDirectory() as tmp:
        eng = engines(device, tmp, series=series)
        eng["small"] = eng["local"]
        local_eps, chunk_size = 3.0, 16
        if local is not None:
            eng.update(local=local, local_data=local_data, qlen=local_qlen)
            probe = local.search(_queries(local_data, max(batches),
                                          local_qlen), QuerySpec(k=3))
            local_eps = 1.02 * float(min(r.dists[-1] for r in probe))
            chunk_size = QuerySpec().chunk_size
        # a throwaway count first: the first one on the card saw a sync
        # of torch's own set-up
        transfers.measure_steady_state(
            lambda: eng["local"].search(_queries(
                eng.get("local_data", eng["data"]), 1, eng.get("qlen", 40))),
            device=device)
        for name, which, spec, qlen in _paths(eng, local_eps, chunk_size):
            for b in batches:
                qs = _queries(eng["local_data"] if "local_data" in eng
                              and which == "local" else eng["data"], b, qlen)
                run = (lambda e=eng[which], q=qs, s=spec: e.search(q, s))
                run()
                before = port_syncs()
                counter = transfers.measure_steady_state(run, warmups=0,
                                                         device=device)
                counters = _delta(port_syncs(), before)
                rows.append(_verdict(name, b, device, counter, counters))
    return rows


def _verdict(name, b, device, counter, counters) -> dict:
    """The budget: the independent count equals the port's counters, one
    readback a batch, nothing else but stop tests, rounds and host
    continuation chunks (the overflow path only)."""
    port = sum(counters.values())
    others = counters["readback"] - 1
    if "overflow" not in name:
        others += counters["host"]
    paged = name in BASELINE
    ok = counter.syncs == port and (paged or (others == 0 and (
        "paged" in name or counters["paged"] == 0)))
    return {"path": name, "b": b, "device": str(device),
            "syncs": counter.syncs, "counters": counters,
            "sites": dict(counter.sites), "ok": bool(ok),
            "accepted": BASELINE.get(name) if paged else None}


def findings(rows: List[dict]) -> List[dict]:
    """The rows that break the budget (an accepted excess is none)."""
    return [r for r in rows if not r["ok"] and not r["accepted"]]


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import json
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's host-sync budget audit (R2); on the card "
                    "unless --device cpu")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--json", default=None, help="write the rows here")
    ap.add_argument("--sites", action="store_true",
                    help="print each path's sync sites")
    args = ap.parse_args(argv)
    rows = audit_host_sync(args.device)
    for r in rows:
        flag = ("ok" if r["ok"] else "accepted" if r["accepted"]
                else "OVER")
        print(f"R2 {r['path']:<24} b={r['b']:<2} syncs={r['syncs']:<4} "
              f"port={sum(r['counters'].values()):<4} {flag:<8}  "
              f"{r['counters']}")
        if args.sites:
            for site, n in sorted(r["sites"].items()):
                print(f"      {n:4d}  {os.path.relpath(site)}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    bad = findings(rows)
    print(f"R2: {len(rows)} path runs, {len(bad)} over budget")
    return 1 if bad else 0
