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
# takes them, argv[2] the .npz it writes (`flatten`'s keys).
REFERENCE = r"""
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.core import EnvelopeParams, QuerySpec, UlisseEngine
sys.path.insert(0, sys.argv[3])
from torch_worlds import flatten
with open(sys.argv[1], "rb") as f:
    job = pickle.load(f)
out = {}
for world, engines, cases in job:
    mesh = jax.make_mesh((world,), ("data",))
    built = {name: UlisseEngine.distributed(
        mesh, EnvelopeParams(**params), data,
        breakpoints=None if bp is None else jnp.asarray(bp),
        max_batch=max_batch)
        for name, (data, params, bp, max_batch) in engines.items()}
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


def start_reference(job, tmp):
    """Start the reference's side of `job` in a subprocess; returns
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
        [sys.executable, "-c", REFERENCE, job_path, out_path,
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


def engine_basics_job(rank, world, data, params, breakpoints):
    """The distributed engine's surface on one world: refusals, the
    shard, raw_data, the local-only methods' refusals, warmup."""
    import torch
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
    refused = {}
    for name, call in (("save", lambda: eng.save("unused")),
                       ("append", lambda: eng.append(data[:1])),
                       ("compact", eng.compact),
                       ("validate_append", lambda: eng.validate_append(
                           data[:1])),
                       ("open", lambda: UlisseEngine.open(
                           "unused", mesh=object(), device="cpu"))):
        try:
            call()
            refused[name] = None
        except NotImplementedError as e:
            refused[name] = str(e)
    out["refused"] = refused
    out["warmup"] = eng.warmup([p.lmin, p.lmax], (1, 3), QuerySpec(k=2))
    return out


def engine_matrix_job(rank, world, engines, cases, device="cpu"):
    """Run the scan matrix's searches on distributed engines over this
    world: `engines` maps a name to (data, params, breakpoints,
    max_batch), `cases` a case name to (engine name, queries, spec
    kwargs); `device` None is the rank's default (CUDA).  Returns
    (`flatten`'s arrays, case name -> sharded k-NN rounds, the chunk
    entries' launches)."""
    from repro_torch.core import EnvelopeParams, QuerySpec, UlisseEngine
    from repro_torch.distributed import ulisse
    from repro_torch.kernels import fused_verify
    built = {name: UlisseEngine.distributed(
        None, EnvelopeParams(**params), data, breakpoints=bp,
        max_batch=max_batch, device=device)
        for name, (data, params, bp, max_batch) in engines.items()}
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
