"""Gloo worlds for the port's distributed tests (a helper module, not a
test file): `run_world(world, job, *args)` starts `world` ranks with
`torch.multiprocessing` (spawn), each joining a gloo process group
through a `file://` rendezvous in a fresh temporary directory (no fixed
port, so concurrent test workers cannot collide), with one torch
thread; every rank calls `job(rank, world, *args)` and the per-rank
results come back as a list in rank order.  A join that outlasts its
timeout kills the ranks and fails, so a deadlocked collective cannot
hang the suite.

Jobs live here, not in the test files, so that a rank imports torch and
the port only: the JAX package is imported by the test processes alone.
"""
from __future__ import annotations

import os
import pickle
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

SRC = str(Path(__file__).resolve().parents[1] / "src")


def _rank_main(rank, world, tmp, backend, job, args):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    if SRC not in sys.path:
        sys.path.insert(0, SRC)
    if backend == "nccl":
        torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous",
                            world_size=world, rank=rank)
    try:
        out = job(rank, world, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def run_world(world: int, job, *args, timeout: float = 150.0,
              backend: str = "gloo") -> list:
    """Run `job(rank, world, *args)` on every rank of a world of `world`
    processes (gloo; "nccl": every rank on cuda:0, a world of 1 on one
    card); returns the ranks' results in rank order."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(_rank_main,
                                 args=(world, tmp, backend, job, args),
                                 nprocs=world, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(),
                                           0.01)):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"a world of {world} ranks did not finish in "
                        f"{timeout:.0f} s (a deadlocked collective?)")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                    proc.join()
        out = []
        for rank in range(world):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


# -- the reference's side -------------------------------------------------

# SearchStats fields compared between the two packages (shard_chunks
# apart), in one order
STAT_FIELDS = ("envelopes_total", "envelopes_checked", "envelopes_pruned",
               "lb_computations", "true_dist_computations", "dtw_lb_keogh",
               "dtw_full", "leaves_visited", "chunks_visited",
               "chunks_planned", "exact_from_approx", "escalations",
               "range_overflows")

# The JAX package's side of a matrix, run in a subprocess with
# XLA_FLAGS forcing 4 host devices (as its own distributed tests run):
# argv[1] a pickled [(world, engines, cases)] as `engine_matrix_job`
# takes them, argv[2] the .npz it writes (`flatten`'s keys).  An engine
# may carry a fifth member, the parts appended to it before any search.
REFERENCE = r"""
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.core import EnvelopeParams, QuerySpec, UlisseEngine
sys.path.insert(0, sys.argv[3])
from torch_worlds import flatten
with open(sys.argv[1], "rb") as f:
    job = pickle.load(f)
out = {}


def build(mesh, data, params, bp, max_batch, parts=()):
    eng = UlisseEngine.distributed(
        mesh, EnvelopeParams(**params), data,
        breakpoints=None if bp is None else jnp.asarray(bp),
        max_batch=max_batch)
    for part in parts:
        eng.append(part)
    return eng


for world, engines, cases in job:
    mesh = jax.make_mesh((world,), ("data",))
    built = {name: build(mesh, *spec) for name, spec in engines.items()}
    for name, (eng, qs, spec) in cases.items():
        res = built[eng].search(qs, QuerySpec(**spec))
        out.update(flatten(world, name, res if isinstance(res, list)
                           else [res]))
np.savez(sys.argv[2], **out)
"""


def flatten(world, case, results) -> dict:
    """Arrays of a case's results under "world/case/j/field" keys:
    dists, series, offsets, stats (STAT_FIELDS) and shard_chunks."""
    out = {}
    for j, r in enumerate(results):
        key = f"{world}/{case}/{j}/"
        st = r.stats
        out[key + "dists"] = np.asarray(r.dists, np.float64)
        out[key + "series"] = np.asarray(r.series, np.int64)
        out[key + "offsets"] = np.asarray(r.offsets, np.int64)
        out[key + "stats"] = np.array([int(getattr(st, f))
                                       for f in STAT_FIELDS], np.int64)
        out[key + "shard_chunks"] = np.array(st.shard_chunks or [],
                                             np.int64)
    return out


def start_reference(job, tmp, script: str = REFERENCE):
    """Start the reference's side of `job` (`script`, REFERENCE by
    default, with REFERENCE's arguments) in a subprocess; returns
    (process, the .npz path it writes)."""
    import subprocess
    root = Path(__file__).resolve().parents[1]
    job_path, out_path = os.path.join(tmp, "job.pkl"), \
        os.path.join(tmp, "reference.npz")
    with open(job_path, "wb") as f:
        pickle.dump(job, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([str(root / "src"), str(root)]))
    proc = subprocess.Popen(
        [sys.executable, "-c", script, job_path, out_path,
         str(Path(__file__).resolve().parent)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, out_path


def reference_results(proc, out_path, timeout: float = 170.0) -> dict:
    """Wait for `start_reference`'s subprocess; its arrays."""
    try:
        _, err = proc.communicate(timeout=timeout)
    except Exception:
        proc.kill()
        proc.communicate()
        raise
    assert proc.returncode == 0, err[-4000:]
    with np.load(out_path) as z:
        return dict(z)


def dtw64(q, w, r: int, znorm: bool) -> float:
    """Float64 banded DTW distance of two windows (z-normalized first in
    znorm mode, as the engines normalize them)."""
    a, b = (np.asarray(x, np.float64) for x in (q, w))
    if znorm:
        a, b = ((x - x.mean()) / max(x.std(), 1e-8) for x in (a, b))
    n = len(a)
    d = np.full((n + 1, n + 1), np.inf)
    d[0, 0] = 0.0
    for i in range(1, n + 1):
        for j in range(max(1, i - r), min(n, i + r) + 1):
            d[i, j] = (a[i - 1] - b[j - 1]) ** 2 + min(
                d[i - 1, j], d[i, j - 1], d[i - 1, j - 1])
    return float(np.sqrt(d[n, n]))


def assert_same_dtw64(got, want, qs, data, r: int, znorm: bool, what):
    """DTW results against the reference's: the same (sid, off) in the
    same order and every counter; distances within rtol 1e-5 / atol 1e-6
    of a float64 DP of the reported windows (`qs[j]` the query of result
    j, `data` the collection): the reference's float32 closed-form DP
    cancels on near matches (ROADMAP F4), so it is not the yardstick."""
    assert len(got) == len(want) > 0, what
    for j, (a, b) in enumerate(zip(got, want)):
        for f in ("series", "offsets", "stats", "shard_chunks"):
            np.testing.assert_array_equal(a[f], b[f],
                                          err_msg=f"{what} q{j} {f}")
        q = qs[j]
        truth = [dtw64(q, data[s, o:o + len(q)], r, znorm)
                 for s, o in zip(a["series"], a["offsets"])]
        np.testing.assert_allclose(a["dists"], truth, rtol=1e-5, atol=1e-6,
                                   err_msg=f"{what} q{j}")


# -- jobs ---------------------------------------------------------------------

def collectives_job(rank, world, d2, sid, off, bsf, ids, k):
    """Every collective on this rank's slice of the inputs: (world, B,
    k) pools and codes, (world,) best-so-fars, (world, k) ids."""
    import torch
    from repro_torch.distributed import collectives as c

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x[rank]))

    out = {"world": c.world(None)}
    td, ti = c.topk_merge(t(d2)[0], t(ids), k)
    out["topk_merge"] = (td.numpy(), ti.numpy())
    out["bsf_allreduce"] = c.bsf_allreduce(t(bsf)).numpy()
    out["global_kth"] = c.global_kth(t(d2), k).numpy()
    out["allgather_topk_merge"] = tuple(
        x.numpy() for x in c.allgather_topk_merge(t(d2), t(sid), t(off), k))
    out["ring_topk_merge"] = tuple(
        x.numpy() for x in c.ring_topk_merge(t(d2), t(sid), t(off), k))
    rows = torch.arange(rank * 3, dtype=torch.float64).reshape(rank, 3)
    out["all_gather_rows"] = [x.numpy() for x in c.all_gather_rows(rows)]
    return out


def engine_basics_job(rank, world, data, params, breakpoints, path):
    """The distributed engine's surface on one world: refusals, the
    shard, raw_data, the write surface (validate_append, append, save,
    open on the group, compact; the save at `path`), warmup."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import EnvelopeParams, QuerySpec, UlisseEngine
    p = EnvelopeParams(**params)
    out = {}
    for what, bad in (("divisible", data[:-1]),
                      ("lmax", data[:, :p.lmax - 1])):
        try:
            UlisseEngine.distributed(None, p, bad, device="cpu")
            out[what] = None
        except ValueError as e:
            out[what] = str(e)
    if not torch.cuda.is_available():
        try:
            UlisseEngine.distributed(None, p, data)
            out["default_device"] = None
        except RuntimeError as e:
            out["default_device"] = str(e)
    eng = UlisseEngine.distributed(None, p, data, breakpoints=breakpoints,
                                   device="cpu")
    shard = eng._shard
    out["shard"] = (shard.rank, shard.shards, shard.row0,
                    shard.index.collection.data.numpy().copy(),
                    {f: getattr(shard.index.envelopes, f).numpy().copy()
                     for f in ("sym_lo", "sym_hi", "series_id", "anchor",
                               "n_master", "valid")})
    out["flags"] = (eng.is_distributed, eng.index is None, eng.delta_size,
                    str(eng.device), eng.page_cache_stats())
    out["raw_data"] = eng.raw_data
    writes = {}
    try:
        eng.validate_append(data[:world + 1])
        writes["refused"] = None
    except ValueError as e:
        writes["refused"] = str(e)
    writes["validate_append"] = eng.validate_append(data[:world])
    eng.append(data[:world])
    writes["appended"] = (eng.delta_size, eng.raw_data)
    eng.save(path)
    cold = UlisseEngine.open(path, mesh=dist.group.WORLD, device="cpu")
    writes["opened"] = (cold.delta_size, cold.raw_data)
    eng.compact()
    writes["compacted"] = (eng.delta_size, eng.raw_data)
    out["writes"] = writes
    out["warmup"] = eng.warmup([p.lmin, p.lmax], (1, 3), QuerySpec(k=2))
    return out


def build_engine(data, params, bp, max_batch, parts=(), device="cpu"):
    """A distributed engine over this rank's world, `parts` appended."""
    from repro_torch.core import EnvelopeParams, UlisseEngine
    eng = UlisseEngine.distributed(None, EnvelopeParams(**params), data,
                                   breakpoints=bp, max_batch=max_batch,
                                   device=device)
    for part in parts:
        eng.append(part)
    return eng


def engine_matrix_job(rank, world, engines, cases, device="cpu"):
    """Run the scan matrix's searches on distributed engines over this
    world: `engines` maps a name to (data, params, breakpoints,
    max_batch[, parts appended first]), `cases` a case name to (engine
    name, queries, spec kwargs); `device` None is the rank's default
    (CUDA).  Returns (`flatten`'s arrays, case name -> sharded k-NN
    rounds, the chunk entries' launches)."""
    from repro_torch.core import QuerySpec
    from repro_torch.distributed import ulisse
    from repro_torch.kernels import fused_verify
    built = {name: build_engine(*spec, device=device)
             for name, spec in engines.items()}
    out, rounds = {}, {}
    for name, (eng, qs, spec) in cases.items():
        before = ulisse.sharded_knn.rounds
        res = built[eng].search(qs, QuerySpec(**spec))
        out.update(flatten(world, name, res if isinstance(res, list)
                           else [res]))
        rounds[name] = ulisse.sharded_knn.rounds - before
    return out, rounds, {
        name: getattr(fused_verify, name).launches
        for name in ("fused_gather_ed_chunk", "fused_gather_lb_keogh_chunk")}


def multi_job(rank, world, jobs):
    """Run several jobs, [(job, args)], on one world: their results."""
    return [job(rank, world, *args) for job, args in jobs]


# -- comparing the flattened results -----------------------------------------

def results(arrays, world, case) -> list:
    """A case's flattened results (`flatten`'s keys), query by query."""
    out, j = [], 0
    while f"{world}/{case}/{j}/dists" in arrays:
        out.append({f: arrays[f"{world}/{case}/{j}/{f}"]
                    for f in ("dists", "series", "offsets", "stats",
                              "shard_chunks")})
        j += 1
    return out


def stat(res, field) -> int:
    """One SearchStats field of a flattened result."""
    return int(res["stats"][STAT_FIELDS.index(field)])


def assert_same(got, want, measure, what, dist_atol=None):
    """The port's flattened results against the reference's: the same
    (sid, off) in the same order, every counter and shard_chunks equal;
    distances within `dist_atol`, else ED 1e-9 (both rescore in float64)
    and DTW rtol 1e-4 / atol 1e-5 (the reference's float32 closed-form
    DP cancels near matches, ROADMAP F4)."""
    assert len(got) == len(want) > 0, what
    for j, (a, b) in enumerate(zip(got, want)):
        for f in ("series", "offsets", "stats", "shard_chunks"):
            np.testing.assert_array_equal(a[f], b[f],
                                          err_msg=f"{what} q{j} {f}")
        if dist_atol is not None:
            np.testing.assert_allclose(a["dists"], b["dists"], rtol=0,
                                       atol=dist_atol, err_msg=what)
        elif measure == "ed":
            np.testing.assert_allclose(a["dists"], b["dists"], rtol=0,
                                       atol=1e-9, err_msg=f"{what} q{j}")
        else:
            np.testing.assert_allclose(a["dists"], b["dists"], rtol=1e-4,
                                       atol=1e-5, err_msg=f"{what} q{j}")


def _listify(res) -> list:
    return res if isinstance(res, list) else [res]


# the shard fields a compaction is held to, bit for bit
SHARD_FIELDS = ("data", "csum", "csum2", "csum_lo", "csum2_lo", "center",
                "paa_lo", "paa_hi", "sym_lo", "sym_hi", "series_id",
                "anchor", "n_master", "valid")


def shard_differences(a, b) -> list:
    """The fields (SHARD_FIELDS, the main rows, the breakpoints) in which
    two engines' shards differ, bit for bit."""
    import torch
    x, y = a._shard, b._shard
    out = [f for f in SHARD_FIELDS
           if not torch.equal(*(getattr(s.index.collection if f in
                                        SHARD_FIELDS[:6]
                                        else s.index.envelopes, f)
                                for s in (x, y)))]
    if not np.array_equal(x.main_rows, y.main_rows):
        out.append("main_rows")
    if not torch.equal(x.breakpoints, y.breakpoints):
        out.append("breakpoints")
    return out


def ingest_job(rank, world, engines, cases, refusals):
    """The ingestion matrix on this world: `engines` as
    `engine_matrix_job` takes them (with their appended parts), `cases`
    searched after the appends; the first engine's validate_append
    messages for each of `refusals`; then every engine's delta_size and
    raw_data, its compaction against a fresh build of the concatenated
    data with the same breakpoints (`shard_differences`), and the
    "knn-" cases searched again after it.  Returns (arrays, messages,
    {engine: (delta_size, raw_data, delta_size after, differences)},
    the chunk steps that ran with a gmap)."""
    from repro_torch.core import QuerySpec
    from repro_torch.distributed import ulisse
    built = {name: build_engine(*spec) for name, spec in engines.items()}
    out = {}
    ulisse.sharded_knn.gmap_steps = 0
    for name, (eng, qs, spec) in cases.items():
        out.update(flatten(world, name, _listify(
            built[eng].search(qs, QuerySpec(**spec)))))
    gmap_steps = ulisse.sharded_knn.gmap_steps
    first = next(iter(built.values()))
    messages = []
    for bad in refusals:
        try:
            first.validate_append(bad)
            messages.append(None)
        except ValueError as e:
            messages.append(str(e))
    compacted = {}
    for name, eng in built.items():
        data, params, bp, max_batch, parts = engines[name]
        before = (eng.delta_size, eng.raw_data)
        eng.compact()
        fresh = build_engine(np.concatenate([data, *parts]), params, bp,
                             max_batch)
        compacted[name] = before + (eng.delta_size,
                                    shard_differences(eng, fresh))
    for name, (eng, qs, spec) in cases.items():
        if name.startswith("knn-"):
            out.update(flatten(world, "compacted-" + name, _listify(
                built[eng].search(qs, QuerySpec(**spec)))))
    return out, messages, compacted, gmap_steps


def serve_job(rank, world, data, params, bp, queries, spec, part, probe):
    """A server over a distributed engine on this world: every rank
    searches `queries` one at a time (serial), then rank 0 serves them
    from three client threads (window 20 ms, max_batch 4) while the
    other ranks follow, appends `part` and compacts through the writer
    lane, searching `probe` after each; then every rank searches `probe`
    once more.  Returns flattened "serial", "served" and "probe"
    (rank 0), "after" results, the writer versions, the ops a follower
    replayed, and the engine's (delta_size, rows) at the end."""
    import threading
    from repro_torch.core import QuerySpec
    from repro_torch.serve import ServeConfig, UlisseServer, follow
    eng = build_engine(data, params, bp, 4)
    spec = QuerySpec(**spec)
    out = flatten(world, "serial", [eng.search(q, spec) for q in queries])
    info = {}
    if rank == 0:
        server = UlisseServer(eng, spec, ServeConfig(window_ms=20,
                                                     max_batch=4))
        got = [None] * len(queries)

        def client(c):
            for i in range(c, len(queries), 3):
                got[i] = server.search(queries[i], timeout=120)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        v1 = server.append(part).result(120)
        seen = server.search(probe, timeout=120)
        v2 = server.compact().result(120)
        seen2 = server.search(probe, timeout=120)
        server.close()
        out.update(flatten(world, "served", got))
        out.update(flatten(world, "probe", [seen, seen2]))
        info["versions"] = (v1, v2)
        info["dispatches"] = server.metrics.snapshot()["total"]
    else:
        info["replayed"] = follow(eng)
    out.update(flatten(world, "after", [eng.search(probe, spec)]))
    info["final"] = (eng.delta_size, eng.raw_data.shape[0])
    return out, info


def _searches(world, tag, eng, qs, specs) -> dict:
    """`flatten`'s arrays of every spec's search of `qs` on `eng`, under
    "{tag}-{spec name}"."""
    from repro_torch.core import QuerySpec
    out = {}
    for name, spec in specs.items():
        out.update(flatten(world, f"{tag}-{name}", _listify(
            eng.search(qs, QuerySpec(**spec)))))
    return out


def storage_job(rank, world, base, extra, more, params, qs, specs, root,
                ref_path):
    """The distributed format on this world (every rank sees `root`):
      * an engine over `base` with `extra` appended, searched ("warm"),
        saved at root/port, opened cold on the group with summarization
        poisoned (build_envelope_set, host_prefix_stats) and the eager
        reads metered (`format.load_array` without mmap) ("cold"), then
        `more` appended to the cold engine and compacted;
      * the commit's crash window: a save at root/crash, `extra`
        appended, a second save whose promoting rename fails, the open
        that rolls it back, a clean retry;
      * the reference's save at `ref_path` (waited for), opened on the
        group ("ref").
    Returns (arrays, record)."""
    import os
    import time as _time

    import torch.distributed as dist

    import repro_torch.core.envelope as envelope
    import repro_torch.core.types as core_types
    import repro_torch.distributed.ulisse as du
    from repro_torch.core import QuerySpec, UlisseEngine
    from repro_torch.storage import format as fmt
    group = dist.group.WORLD
    rec = {}
    eng = build_engine(base, params, None, 4, (extra,))
    out = _searches(world, "warm", eng, qs, specs)
    path = os.path.join(root, "port")
    eng.save(path)

    def boom(*a, **k):
        raise AssertionError("cold open re-ran summarization")

    saved = (envelope.build_envelope_set, core_types.host_prefix_stats,
             du.build_envelope_set)
    envelope.build_envelope_set = boom
    core_types.host_prefix_stats = boom
    du.build_envelope_set = boom
    eager = [0]
    load = fmt.load_array

    def metered(directory, entry, mmap=False):
        arr = load(directory, entry, mmap=mmap)
        if not mmap:
            eager[0] += int(np.asarray(arr).nbytes)
        return arr

    fmt.load_array = metered
    try:
        cold = UlisseEngine.open(path, mesh=group, device="cpu")
    finally:
        fmt.load_array = load
        (envelope.build_envelope_set, core_types.host_prefix_stats,
         du.build_envelope_set) = saved
    table = fmt.read_manifest(path)["collection_shards"]
    rec["eager"] = (eager[0], int(np.prod(table[rank]["shape"])) * 4,
                    sum(int(np.prod(e["shape"])) * 4 for e in table),
                    cold._shard.built is None, cold.max_batch,
                    cold.delta_size)
    out.update(_searches(world, "cold", cold, qs, specs))
    cold.append(more)
    out.update(_searches(world, "cold-appended", cold, qs, specs))
    cold.compact()
    rec["cold_compacted"] = (cold.delta_size, cold.raw_data)
    out.update(_searches(world, "cold-compacted", cold, qs, specs))

    # the commit's crash window: the old index moved aside, the new one
    # never renamed in
    crash = os.path.join(root, "crash")
    v1 = build_engine(base, params, None, 4)
    v1.save(crash)
    knn = QuerySpec(**specs["ed"])
    out.update(flatten(world, "v1", _listify(v1.search(qs, knn))))
    v1.append(extra)
    rename = os.rename

    def killed(src, dst):
        if src.endswith(".tmp"):
            raise OSError("simulated crash between commit renames")
        return rename(src, dst)

    os.rename = killed
    try:
        v1.save(crash)
        rec["crash"] = None
    except OSError as e:
        rec["crash"] = str(e)
    finally:
        os.rename = rename
    rec["crash_left"] = (os.path.exists(crash),
                         os.path.exists(crash + ".old"))
    back = UlisseEngine.open(crash, mesh=group, device="cpu")
    rec["rolled_back"] = (os.path.exists(crash),
                          os.path.exists(crash + ".old"),
                          os.path.exists(crash + ".tmp"),
                          back.raw_data.shape[0])
    out.update(flatten(world, "rolled-back", _listify(back.search(qs, knn))))
    v1.save(crash)
    rec["retried_rows"] = UlisseEngine.open(
        crash, mesh=group, device="cpu").raw_data.shape[0]

    # the reference's save, read through its sections
    deadline = _time.monotonic() + 200
    while not os.path.exists(os.path.join(ref_path, "manifest.json")):
        if _time.monotonic() > deadline:
            raise TimeoutError("the reference's save never appeared")
        _time.sleep(0.2)
    ref = UlisseEngine.open(ref_path, mesh=group, device="cpu")
    rec["ref_cold"] = ref._shard.sections is not None
    out.update(_searches(world, "ref", ref, qs, specs))
    return out, rec


def elastic_job(rank, world, qs, specs, port_path, ref_path, base, params,
                writer_path):
    """Saves of another shard count opened on this world (re-sharded from
    their raw rows, the delta rows at their ids): the port's ("port") and
    the reference's ("ref"); then a Writer of `base` held by rank 0 alone,
    finalized and opened on the group (`from_writer`, "writer") beside a
    distributed build of `base` ("built").  Returns (arrays, {name:
    (rows, delta_size, cold)})."""
    import torch.distributed as dist
    from repro_torch.core import EnvelopeParams, UlisseEngine
    from repro_torch.storage import Writer
    group = dist.group.WORLD
    out, rec = {}, {}
    for tag, path in (("port", port_path), ("ref", ref_path)):
        eng = UlisseEngine.open(path, mesh=group, device="cpu")
        out.update(_searches(world, tag, eng, qs, specs))
        rec[tag] = (eng.raw_data.shape[0], eng.delta_size,
                    eng._shard.sections is not None)
    writer = None
    if rank == 0:
        writer = Writer(writer_path, EnvelopeParams(**params),
                        chunk_series=8, device="cpu")
        writer.append(base)
    eng = UlisseEngine.from_writer(writer, mesh=group, device="cpu")
    out.update(_searches(world, "writer", eng, qs, specs))
    rec["writer"] = (eng.raw_data.shape[0], eng.delta_size,
                     eng._shard.sections is not None)
    out.update(_searches(world, "built", build_engine(base, params, None, 4),
                         qs, specs))
    return out, rec


# -- rank grids (multi-axis meshes) -------------------------------------------

# The reference's side of the grid tests: argv as REFERENCE takes them; the
# job a pickled (data, params, breakpoints, {label: axes}, cases), every
# engine on jax.make_mesh((2, 2), ("data", "model")).
REFERENCE_GRID = r"""
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.core import EnvelopeParams, QuerySpec, UlisseEngine
sys.path.insert(0, sys.argv[3])
from torch_worlds import flatten
with open(sys.argv[1], "rb") as f:
    data, params, bp, grids, cases = pickle.load(f)
mesh = jax.make_mesh((2, 2), ("data", "model"))
out = {}
for label, axes in grids.items():
    eng = UlisseEngine.distributed(mesh, EnvelopeParams(**params), data,
                                   breakpoints=jnp.asarray(bp), axes=axes)
    for name, (qs, spec) in cases.items():
        out.update(flatten(label, name, eng.search(qs, QuerySpec(**spec))))
np.savez(sys.argv[2], **out)
"""


def grid_job(rank, world, data, params, bp, grids, cases, tmp):
    """Distributed engines over a 2 x 2 DeviceMesh ("data", "model") of
    this world, one for each {label: axes} of `grids`: `cases` (name ->
    (queries, spec kwargs)) searched on each; each engine saved under
    `tmp`/label and the save opened under every grid's axes on the same
    mesh (the save's recorded axes win, as the reference reopens) and on
    the whole group as a one-axis grid of 4 (a re-shard where the save
    holds 2 shards), each opened engine searched again; and a burst
    served by rank 0 over the first grid while every other rank,
    replicas included, follows.  Returns (arrays keyed "label/case",
    "label>opened_axes/case" and "served/case", {label: (shards, shard
    index, replica, cold)} for every engine built or opened)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.core import EnvelopeParams, QuerySpec, UlisseEngine
    from repro_torch.serve import ServeConfig, UlisseServer, follow
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    p = EnvelopeParams(**params)
    out, info = {}, {}

    def record(label, eng):
        s = eng._shard
        info[label] = (s.shards, s.rank, s.replica, s.sections is not None)
        for name, (qs, spec) in cases.items():
            out.update(flatten(label, name, eng.search(qs, QuerySpec(**spec))))

    engines = {}
    for label, axes in grids.items():
        engines[label] = eng = UlisseEngine.distributed(
            mesh, p, data, breakpoints=bp, device="cpu", axes=axes)
        record(label, eng)
        eng.save(os.path.join(tmp, label))
    for label in grids:
        path = os.path.join(tmp, label)
        for other, axes in grids.items():
            record(f"{label}>{other}", UlisseEngine.open(
                path, mesh=mesh, axes=axes, device="cpu"))
        record(f"{label}>world", UlisseEngine.open(
            path, mesh=dist.group.WORLD, device="cpu"))
    eng = engines[next(iter(grids))]
    name, (qs, spec) = next(iter(cases.items()))
    if rank == 0:
        server = UlisseServer(eng, QuerySpec(**spec),
                              ServeConfig(window_ms=20, max_batch=4))
        got = [server.search(q, timeout=120) for q in qs]
        server.close()
        out.update(flatten("served", name, got))
        info["served"] = server.metrics.snapshot()["total"]["completed"]
    else:
        info["replayed"] = follow(eng)
    return out, info


# -- the training collectives ---------------------------------------------------

# The reference's side: argv as REFERENCE takes them; the job a pickled
# list of (world, x (world, m), err (world, m), grads {name: array}, xm
# (world * r, c), w (c, n)), each run under shard_map on a mesh of the
# first `world` of the 4 forced host devices.
REFERENCE_TRAIN = r"""
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.distributed.collectives import (
    ef_int8_allreduce, make_compressed_grad_transform,
    ring_allgather_matmul)
from repro.distributed.compat import shard_map
with open(sys.argv[1], "rb") as f:
    job = pickle.load(f)
out = {}
for world, x, err, grads, xm, w in job:
    mesh = Mesh(np.array(jax.devices()[:world]), ("x",))

    def local(xs, es):
        red, new = ef_int8_allreduce(xs[0], es[0], "x")
        return red[None], new[None]
    red, new = shard_map(local, mesh=mesh, in_specs=(P("x"), P("x")),
                         out_specs=(P("x"), P("x")), check=False)(
        jnp.asarray(x), jnp.asarray(err))
    out[f"{world}/ef"] = np.asarray(red)
    out[f"{world}/err"] = np.asarray(new)
    g = make_compressed_grad_transform(mesh, axes=("x",))(
        {k: jnp.asarray(v) for k, v in grads.items()})
    for k, v in g.items():
        out[f"{world}/grad/{k}"] = np.asarray(v)

    def ring(xs, ws):
        return ring_allgather_matmul(xs, ws, "x", world)[None]
    y = shard_map(ring, mesh=mesh, in_specs=(P("x"), P()),
                  out_specs=P("x"), check=False)(jnp.asarray(xm),
                                                 jnp.asarray(w))
    out[f"{world}/ring"] = np.asarray(y)
np.savez(sys.argv[2], **out)
"""


def train_job(rank, world, x, err, grads, xm, w):
    """The training collectives on this rank's slices: its row of x and
    err through `ef_int8_allreduce` (and `int8_quantize` of x + err), the
    replicated `grads` ({name: array}, and a list and tuple of them)
    through `make_compressed_grad_transform` over a one-dim DeviceMesh
    and over the default group, and its block of xm through
    `ring_allgather_matmul` with w."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed import collectives as c
    xt, et = (torch.from_numpy(np.ascontiguousarray(a[rank]))
              for a in (x, err))
    red, new = c.ef_int8_allreduce(xt, et)
    codes, scale = c.int8_quantize(xt + et)
    tree = {k: torch.from_numpy(v) for k, v in grads.items()}
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    on_mesh = c.make_compressed_grad_transform(mesh)(tree)
    nested = c.make_compressed_grad_transform()(
        [tuple(tree.values()), {"a": tree}])
    m = xm.shape[0] // world
    y = c.ring_allgather_matmul(
        torch.from_numpy(np.ascontiguousarray(xm[rank * m:(rank + 1) * m])),
        torch.from_numpy(w))
    return {"ef": red.numpy(), "err": new.numpy(), "codes": codes.numpy(),
            "scale": float(scale),
            "grad": {k: v.numpy() for k, v in on_mesh.items()},
            "nested": (type(nested).__name__, type(nested[0]).__name__,
                       [v.numpy() for v in nested[0]],
                       {k: v.numpy() for k, v in nested[1]["a"].items()}),
            "ring": y.numpy()}
