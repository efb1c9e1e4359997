#!/usr/bin/env python3
"""Drive the PyTorch port of ULISSE (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py [--series N] [--out results.json]

Phases (any failed check raises, and the script exits non-zero):
  1. build the CUDA kernels from `src/repro_torch/kernels/csrc` (one nvcc
     per source, in parallel);
  2. hold each kernel against its plain PyTorch version on the card at
     the main path's shapes (fused_gather_ed: B = 8 queries, rows 64 and
     512, g = 49, znorm and raw, rtol 1e-4 / atol 1e-3; mindist: B = 8
     point and interval queries against the full envelope and block
     counts, rtol 1e-6 / atol 1e-6);
  3. build the index on the card: 1,000,000 random-walk series x 256
     points (`--series` may only shrink it) at lmin=160, lmax=256,
     seg_len=16, gamma=48, card=256, znorm — the repo's bench parameters;
  4. answer batches of default-spec queries (k=5, B=8, lengths 160 and
     256) through `UlisseEngine.search`, with every kernel launch counter
     set to 0 just before and read just after;
  5. check a subset of answers against the plain-torch brute force on
     the card;
  6. time each kernel and its plain version on main-path inputs (CUDA
     events), beside the least time the card could take (its bound);
     the inputs rotate through copies larger than L2, so reads are cold.

Prints the kernel table as one JSON line, the card's name and power
limit, and as its last line {"ok": true, "device": {...}}.  Needs one
CUDA device and nvcc; imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
FULL_SERIES = 1_000_000
SERIES_LEN = 256
BENCH = dict(lmin=160, lmax=256, seg_len=16, gamma=48, card=256, znorm=True)
BATCH = 8
BATCHES = 4             # query batches of BATCH on the main path
QLENS = (160, 256)
K = 5
# H100 SXM, NVIDIA data sheet: HBM3 bytes/s and float32 (non-tensor) FLOP/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
L2_BYTES = 50 * 2 ** 20     # H100 L2, where the device does not say
TOL = {"fused_gather_ed": (1e-4, 1e-3), "mindist_sym": (1e-6, 1e-6),
       "mindist_paa": (1e-6, 1e-6)}
REPLACES = {
    "fused_gather_ed": ("src/repro_torch/kernels/csrc/fused_verify.cu",
                        "src/repro/kernels/fused_verify.py:181"),
    "mindist_sym": ("src/repro_torch/kernels/csrc/mindist.cu",
                    "src/repro/kernels/mindist.py:40"),
    "mindist_paa": ("src/repro_torch/kernels/csrc/mindist.cu",
                    "src/repro/kernels/mindist.py:40"),
}


def log(*args, **kwargs):
    print(*args, flush=True, **kwargs)


def device_events(prof):
    """The device activity (kernels, copies, sets) of a torch.profiler
    trace, without the GPU ranges of record_function annotations."""
    from torch.autograd import DeviceType
    return [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA
            and not getattr(ev, "is_user_annotation", False)]


def device_ms(prof) -> float:
    """Summed duration of a trace's device activity, ms — the card's busy
    time (one stream: the activities do not overlap)."""
    return sum(ev.time_range.elapsed_us() for ev in device_events(prof)) / 1e3


def time_calls(torch, fns, reps=20):
    """(device ms, event ms) per call over `reps` rounds through `fns`
    (several inputs, so a working set larger than L2 is read cold).

    Device ms is the card's busy time from torch.profiler (None when the
    trace holds no device activity); event ms is CUDA events around the
    loop, which also counts the card waiting for the host to launch.
    """
    from torch.profiler import ProfilerActivity, profile
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for r in range(reps):
        fns[r % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    event_ms = start.elapsed_time(end) / reps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for r in range(reps):
            fns[r % len(fns)]()
        torch.cuda.synchronize()
    busy = device_ms(prof) / reps
    return (busy if busy > 0 else None), event_ms


def timing(torch, call, plain, nbytes, ops, err, shape):
    """One timing record: kernel and plain version, device time where the
    profiler sees the card (else CUDA events), beside the bound."""
    k_dev, k_ev = time_calls(torch, call)
    p_dev, p_ev = time_calls(torch, plain)
    by_bytes = nbytes / PEAK_BYTES >= ops / PEAK_F32
    return dict(
        shape=shape, timer="profiler" if k_dev and p_dev else "events",
        ms=k_dev if k_dev and p_dev else k_ev,
        plain_ms=p_dev if k_dev and p_dev else p_ev,
        event_ms=k_ev, plain_event_ms=p_ev,
        bound_ms=max(nbytes / PEAK_BYTES, ops / PEAK_F32) * 1e3,
        bound_by="bytes" if by_bytes else "operations", max_abs_err=err,
        bytes=nbytes, ops=ops)


def check_close(torch, name, got, want):
    """Raise unless `got` matches `want` (same non-finite entries, finite
    ones within the kernel's tolerance); returns the max abs error."""
    rtol, atol = TOL[name]
    torch.cuda.synchronize()
    fin = torch.isfinite(want)
    if not torch.equal(torch.isfinite(got), fin) \
            or not torch.equal(got[~fin], want[~fin]):
        raise AssertionError(f"{name}: non-finite entries differ")
    err = (got[fin] - want[fin]).abs()
    bad = err > atol + rtol * want[fin].abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {bad.numel()} entries outside "
            f"rtol {rtol} / atol {atol}; max abs err {float(err.max())}")
    return float(err.max()) if err.numel() else 0.0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--series", type=int, default=FULL_SERIES,
                    help="series in the collection (at most 1,000,000)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the full results as JSON here")
    args = ap.parse_args()
    if not 1 <= args.series <= FULL_SERIES:
        ap.error(f"--series must be in [1, {FULL_SERIES}]")

    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        log(f"chip_smoke: {SRC / 'repro_torch'} not found", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.core import (Collection, EnvelopeParams, QuerySpec,
                                  UlisseEngine, build_index, executor,
                                  planner)
    from repro_torch.core.search import brute_force_knn
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.fused_verify import fused_gather_ed
    from repro_torch.kernels.mindist import mindist_paa, mindist_sym
    from repro_torch.train.data import series_batches

    # the plain versions' products stay full float32, like the kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"], capture_output=True,
        text=True, check=True).stdout.strip()
    log(f"device: {torch.cuda.get_device_name(0)} | {card} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    wrappers = {"fused_gather_ed": fused_gather_ed,
                "mindist_sym": mindist_sym, "mindist_paa": mindist_paa}
    results = {"card": card, "series": args.series, "params": BENCH}

    # -- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    _build.load_all()
    results["build_s"] = time.perf_counter() - t0
    log(f"[1] kernels built in {results['build_s']:.1f} s")
    for name in _build.SIGNATURES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {name}.cu: {line.strip()}")

    # -- 2. kernels against their plain versions, main-path shapes --------
    p = EnvelopeParams(**BENCH)
    g = p.gamma + 1
    n_env = args.series * p.num_envelopes(SERIES_LEN)
    n_pad_env = -(-n_env // 64 ** 2) * 64 ** 2
    errs = {name: 0.0 for name in wrappers}
    rng = np.random.default_rng(args.seed + 1)
    probe = Collection.from_array(
        rng.normal(size=(4096, SERIES_LEN)).astype(np.float32) * 2 + 1,
        device=dev)
    for rows in (64, 512):
        for qlen in QLENS:
            sids = torch.from_numpy(rng.integers(
                0, 4096, BATCH * rows).astype(np.int32)).to(dev)
            anc = torch.from_numpy(rng.integers(
                0, SERIES_LEN - qlen + 1, BATCH * rows).astype(np.int32)
            ).to(dev)
            qs = torch.from_numpy(rng.normal(size=(BATCH, qlen)).astype(
                np.float32)).to(dev)
            for znorm in (True, False):
                a = (probe.data, probe.csum, probe.csum2, probe.csum_lo,
                     probe.csum2_lo, probe.center, sids, anc, qs)
                got = fused_gather_ed(*a, g=g, rows=rows, znorm=znorm)
                want = ref.fused_gather_ed_ref(*a, g=g, rows=rows,
                                               znorm=znorm)
                errs["fused_gather_ed"] = max(
                    errs["fused_gather_ed"],
                    check_close(torch, "fused_gather_ed", got, want))
    lo = torch.randn((n_pad_env, p.w), device=dev)
    hi = lo + torch.rand((n_pad_env, p.w), device=dev)
    lo[:7, 0], hi[:7, 0] = -float("inf"), float("inf")
    valid = torch.rand(n_pad_env, device=dev) > 0.01
    bp = torch.sort(torch.randn(p.card - 1, device=dev)).values
    sym_lo = torch.searchsorted(bp, lo, right=True).to(torch.int32)
    sym_hi = torch.searchsorted(bp, hi, right=True).to(torch.int32)
    qp = torch.randn((BATCH, p.w), device=dev)
    nb = n_pad_env // 64
    # a point query (ED) and a true interval (q_hi > q_lo), so that a
    # kernel mixing up the two query bounds cannot pass
    for qh in (qp, qp + torch.rand((BATCH, p.w), device=dev)):
        for nseg in (10, 16):
            errs["mindist_sym"] = max(errs["mindist_sym"], check_close(
                torch, "mindist_sym",
                mindist_sym(qp, qh, sym_lo, sym_hi, bp, valid, p.seg_len,
                            nseg),
                ref.mindist_sym_ref(qp, qh, sym_lo, sym_hi, bp, valid,
                                    p.seg_len, nseg)))
            errs["mindist_paa"] = max(errs["mindist_paa"], check_close(
                torch, "mindist_paa",
                mindist_paa(qp, qh, lo[:nb], hi[:nb], valid[:nb],
                            p.seg_len, nseg),
                ref.mindist_ref(qp, qh, lo[:nb], hi[:nb], valid[:nb],
                                p.seg_len, nseg)))
    del probe, lo, hi, valid, sym_lo, sym_hi
    torch.cuda.synchronize()
    log(f"[2] kernels agree with their plain versions: "
        + ", ".join(f"{k} max abs err {v:.3g}" for k, v in errs.items()))

    # -- 3. the index on the card ------------------------------------------
    t0 = time.perf_counter()
    data = series_batches(args.series, SERIES_LEN, seed=args.seed)
    coll = Collection.from_array(data, device=dev)
    t1 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    engine = UlisseEngine.from_collection(coll, p, block_size=64,
                                          num_levels=2, device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    index = engine.index
    results["index"] = {
        "data_s": t1 - t0, "build_s": t2 - t1,
        "envelopes": index.num_envelopes,
        "valid_envelopes": int(index.envelopes.valid.sum()),
        "blocks": [lvl.size for lvl in index.levels],
        "peak_build_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
        "resident_gib": torch.cuda.memory_allocated(dev) / 2 ** 30}
    log(f"[3] index: {args.series} series x {SERIES_LEN} -> "
        f"{results['index']['envelopes']} envelopes, blocks "
        f"{results['index']['blocks']}; data+stats {t1 - t0:.1f} s, build "
        f"{t2 - t1:.1f} s, peak {results['index']['peak_build_gib']:.2f} GiB")

    # -- 4. the main path --------------------------------------------------
    qrng = np.random.default_rng(args.seed + 2)

    def make_batch(qlen):
        sids = qrng.integers(0, args.series, BATCH)
        offs = qrng.integers(0, SERIES_LEN - qlen + 1, BATCH)
        return [data[s, o:o + qlen] + qrng.normal(size=qlen).astype(
            np.float32) * 0.1 for s, o in zip(sids, offs)]

    spec = QuerySpec(k=K)
    engine.search(make_batch(QLENS[0]), spec)        # warm-up (host copy)
    batches = [make_batch(QLENS[i % len(QLENS)]) for i in range(BATCHES)]
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    executor.device_exact_scan.syncs = 0
    answers, lat = [], []
    t0 = time.perf_counter()
    for qs in batches:
        tb = time.perf_counter()
        answers.append(engine.search(qs, spec))
        lat.append(time.perf_counter() - tb)
    wall = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    stop_syncs = executor.device_exact_scan.syncs
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    nq = sum(len(b) for b in batches)
    flat = [r for ans in answers for r in ans]
    for r in flat:
        if r.dists.shape != (K,) or not np.isfinite(r.dists).all() \
                or (r.series < 0).any() or (r.offsets < 0).any():
            raise AssertionError(f"malformed result {r}")
        if not (np.diff(r.dists) >= 0).all():
            raise AssertionError("result distances not ascending")
    st = [r.stats for r in flat]
    results["main_path"] = {
        "queries": nq, "batches": len(batches), "wall_s": wall,
        "queries_per_s": nq / wall, "batch_latency_s": lat,
        "launches": launches, "stop_test_syncs": stop_syncs,
        "host_syncs_per_batch": stop_syncs / len(batches) + 1,
        "stop_test_every": executor.STOP_TEST_EVERY,
        "mean_chunks_visited": float(np.mean([s.chunks_visited for s in st])),
        "mean_envelopes_checked": float(np.mean(
            [s.envelopes_checked for s in st])),
        "mean_true_dists": float(np.mean(
            [s.true_dist_computations for s in st])),
        "mean_pruning_power": float(np.mean([s.pruning_power for s in st])),
        "exact_from_approx": float(np.mean(
            [s.exact_from_approx for s in st]))}
    log(f"[4] main path: {nq} queries in {len(batches)} batches, "
        f"{nq / wall:.1f} queries/s; launches {launches}; host syncs per "
        f"batch {results['main_path']['host_syncs_per_batch']:.2f} (stop "
        f"test every {executor.STOP_TEST_EVERY} chunks + 1 readback); mean "
        f"chunks {results['main_path']['mean_chunks_visited']:.1f}, "
        f"pruning power {results['main_path']['mean_pruning_power']:.5f}")

    # -- 5. answers against the brute force on the card ---------------------
    worst = 0.0
    for ans, qs in ((answers[0], batches[0]), (answers[1], batches[1])):
        for r, q in list(zip(ans, qs))[:2]:
            oracle = brute_force_knn(coll, q, k=K, znorm=p.znorm)
            err = float(np.abs(r.dists - oracle.dists).max())
            worst = max(worst, err)
            if err > 5e-3:
                raise AssertionError(
                    f"engine {r.dists} vs brute force {oracle.dists}")
    results["brute_force_max_abs_err"] = worst
    log(f"[5] engine answers match the brute force on the card (4 queries,"
        f" max |d - d_brute| {worst:.2e}, tolerance 5e-3)")

    # -- 6. kernel timings at main-path inputs -------------------------------
    env = index.envelopes
    fine = index.levels[-1]
    l2 = getattr(torch.cuda.get_device_properties(dev), "L2_cache_size",
                 0) or L2_BYTES
    # enough copies of each kernel's envelope intervals that a round of
    # calls streams twice the L2 through it, so every call reads from HBM
    env_ins = {"mindist_sym": (env.sym_lo, env.sym_hi, env.valid),
               "mindist_paa": (fine.paa_lo, fine.paa_hi, fine.valid)}
    for name, ins in env_ins.items():
        in_bytes = sum(t.numel() * t.element_size() for t in ins)
        env_ins[name] = [ins] + [tuple(t.clone() for t in ins)
                                 for _ in range(-(-2 * l2 // in_bytes) - 1)]
    kernels, timings = [], {}
    for qlen in QLENS:
        nseg = p.query_segments(qlen)
        q = torch.from_numpy(np.stack(make_batch(qlen))).to(dev)
        qs, _, _, qb, qh = planner.prepare_query_batch(q, p.seg_len,
                                                       p.znorm)
        bpt = index.breakpoints
        for name, n_rows in (("mindist_sym", env.size),
                             ("mindist_paa", fine.size)):
            ins = env_ins[name]
            if name == "mindist_sym":
                call = [lambda c=c: mindist_sym(qb, qh, c[0], c[1], bpt,
                                                c[2], p.seg_len, nseg)
                        for c in ins]
                plain = [lambda c=c: ref.mindist_sym_ref(
                    qb, qh, c[0], c[1], bpt, c[2], p.seg_len, nseg)
                    for c in ins]
            else:
                call = [lambda c=c: mindist_paa(qb, qh, *c, p.seg_len, nseg)
                        for c in ins]
                plain = [lambda c=c: ref.mindist_ref(qb, qh, *c, p.seg_len,
                                                     nseg) for c in ins]
            err = check_close(torch, name, call[0](), plain[0]())
            nbytes = (2 * n_rows * nseg * 4 + n_rows + BATCH * n_rows * 4
                      + 2 * BATCH * nseg * 4 + (p.card - 1) * 4)
            ops = 7 * BATCH * n_rows * nseg
            timings[(name, qlen)] = timing(
                torch, call, plain, nbytes, ops, err,
                f"B={BATCH} N={n_rows} nseg={nseg} x{len(ins)}")
        # the exact scan's and the approximate pass's real chunk inputs
        lbs = planner.env_lower_bounds_batch(qb, qh, env, index.breakpoints,
                                             p.seg_len, nseg, False)
        n_pad = executor.pow2ceil(env.size)
        none = torch.full((BATCH, 1), env.size, dtype=torch.int32,
                          device=dev)
        zero = torch.zeros(BATCH, dtype=torch.int32, device=dev)
        ssids, sanc, _, _, _ = planner.device_scan_pack(
            env.series_id, env.anchor, env.n_master, lbs, none, zero,
            chunk=1, n_pad=n_pad)
        blk = planner.block_lower_bounds_batch(qb, qh, fine.paa_lo,
                                               fine.paa_hi, fine.valid,
                                               p.seg_len, nseg)
        asids, aanc, *_ = planner.device_leaf_pack(
            env.series_id, env.anchor, env.n_master, env.valid, blk,
            n_main=env.size, block_size=64, chunk=64, n_leaves=8)
        for rows, s_all, a_all in ((512, ssids, sanc), (64, asids, aanc)):
            chunks = [(s_all[:, i * rows:(i + 1) * rows].reshape(-1)
                       .contiguous(),
                       a_all[:, i * rows:(i + 1) * rows].reshape(-1)
                       .contiguous()) for i in range(8)]
            a0 = (coll.data, coll.csum, coll.csum2, coll.csum_lo,
                  coll.csum2_lo, coll.center)
            call = [lambda c=c: fused_gather_ed(*a0, c[0], c[1], qs, g=g,
                                                rows=rows, znorm=p.znorm)
                    for c in chunks]
            plain = [lambda c=c: ref.fused_gather_ed_ref(
                *a0, c[0], c[1], qs, g=g, rows=rows, znorm=p.znorm)
                for c in chunks]
            err = check_close(torch, "fused_gather_ed", call[0](),
                              plain[0]())
            # bytes this input needs: distinct region elements, distinct
            # prefix-sum positions (x4 arrays), queries, plan, output
            sid, anc = chunks[0][0].long(), chunks[0][1].long()
            reg = torch.arange(qlen + g - 1, device=dev)
            region = torch.unique((sid[:, None] * SERIES_LEN + anc[:, None]
                                   + reg).clamp(0, coll.data.numel() - 1))
            offs = (anc[:, None] + torch.arange(g, device=dev)).clamp(
                0, SERIES_LEN - qlen)
            pos = sid[:, None] * (SERIES_LEN + 1) + offs
            sums = torch.unique(torch.cat([pos, pos + qlen]).reshape(-1))
            nbytes = (region.numel() * 4 + 4 * sums.numel() * 4
                      + BATCH * qlen * 4 + BATCH * rows * 8
                      + BATCH * rows * g * 4)
            ops = 2 * BATCH * rows * g * qlen
            timings[("fused_gather_ed", qlen, rows)] = timing(
                torch, call, plain, nbytes, ops, err,
                f"B={BATCH} rows={rows} qlen={qlen} g={g}")
    results["timings"] = {" ".join(map(str, k)): v
                          for k, v in timings.items()}
    for key, t in timings.items():
        log(f"[6] {key[0]:16s} {t['shape']:30s} kernel {t['ms']:.4f} ms  "
            f"plain {t['plain_ms']:.4f} ms  bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}, {t['timer']}; events {t['event_ms']:.4f} / "
            f"{t['plain_event_ms']:.4f} ms)")

    # -- 7. where a batch's time goes (one traced batch) -------------------
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.search(batches[1], spec)
        traced_wall = time.perf_counter() - t0
    busy = device_ms(prof) / 1e3
    by_kernel = {}
    for ev in device_events(prof):
        row = by_kernel.setdefault(ev.name[:80], {"name": ev.name[:80],
                                                  "count": 0, "ms": 0.0})
        row["count"] += 1
        row["ms"] += ev.time_range.elapsed_us() / 1e3
    host = [{"name": e.key[:80], "count": e.count,
             "ms": e.self_cpu_time_total / 1e3}
            for e in sorted(prof.key_averages(),
                            key=lambda e: -e.self_cpu_time_total)[:10]]
    results["traced_batch"] = {
        "qlen": len(batches[1][0]), "wall_s": traced_wall,
        "device_busy_s": busy, "device_idle_share": 1 - busy / traced_wall,
        "top_self_device": sorted(by_kernel.values(),
                                  key=lambda r: -r["ms"])[:10],
        "top_self_cpu": host}
    log(f"[7] one traced batch (qlen {len(batches[1][0])}): wall "
        f"{traced_wall:.3f} s under the profiler, device busy {busy:.3f} s,"
        f" idle share {1 - busy / traced_wall:.3f}")
    for row in results["traced_batch"]["top_self_device"][:6]:
        log(f"    device {row['ms']:9.2f} ms  x{row['count']:6d}  "
            f"{row['name']}")
    for row in results["traced_batch"]["top_self_cpu"][:6]:
        log(f"    host   {row['ms']:9.2f} ms  x{row['count']:6d}  "
            f"{row['name']}")
    headline = {"fused_gather_ed": ("fused_gather_ed", 256, 512),
                "mindist_sym": ("mindist_sym", 256),
                "mindist_paa": ("mindist_paa", 256)}
    for name, key in headline.items():
        t = timings[key]
        src, replaces = REPLACES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(errs[name], t["max_abs_err"]),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None})
    results["kernels"] = kernels
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(results, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
