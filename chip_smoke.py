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
     counts, rtol 1e-6 / atol 1e-6), and the DTW path's at its shapes
     (B = 8, rows 64 and 512, qlen 160 with r = 16 and qlen 256 with
     r = 25 — the paper's Fig. 25 window of 10% of |Q| — with true
     interval queries: fused_gather_lb_keogh lb2 rtol 2e-4 / atol 2e-3,
     mu 1e-4 / 1e-4, sd 1e-3 / 1e-4; its chunk entry the same lb2, mu
     and sd bit for bit, the same survivor set (up to lb2 within the
     tolerance of kth) and counts; the LB and DP kernels' window
     normalization bit for bit against the IEEE divide at every window
     point (`gather_znorm`); dtw_survivors and the dtw_band entry rtol
     1e-4 / atol 1e-3);
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
     the inputs rotate through copies larger than L2, so reads are cold;
  7. trace one batch of the main path (device busy and idle share);
  8. the DTW path: one exact DTW k-NN batch (k=5, B=8) per length through
     `UlisseEngine.search(..., QuerySpec(measure="dtw", r=r))`, counters
     set to 0 just before and read just after; every qlen-256 answer and
     the first two qlen-160 answers (DTW_BRUTE) checked against the
     plain-DP brute force on the card;
  9. time the DTW kernels on that path's inputs, as in 6 (the LB
     kernel's contract entry and its chunk entry, the DP's two entries),
     and check LB_Keogh <= DTW on every survivor of one chunk;
 10. trace one DTW batch: device activities and kernel launch calls a
     chunk step, and no scan kernel (the survivor pack's cumsum is gone);
 11. the host backend (`scan_backend="host"`), ED and DTW: two queries
     each, counters set to 0 just before and read just after; answers
     equal the brute-force-checked device answers of the same queries as
     (series, offset) sets, distances within 5e-3; host syncs per query;
 12. approx-only (`mode="approx"`), one ED and one DTW batch, counters
     around each: the k-th distance is never below the exact one, and
     the answer equals the exact one wherever `exact_from_approx` is set;
 13. time the index build's and the host backend's kernels at their
     path's inputs, as in 6.

Phase 2 also holds the slice-3 kernels against their plain versions:
envelope_znorm bit for bit (both entries; the build entry also against
the plain version on the CPU, from the same prefix sums), batch_ed at
25,088 windows, qlen 160 and 256, Qb 1 and 8, znorm and raw (rtol 2e-4 /
atol 2e-3), lb_keogh at the same windows (rtol 1e-5 / atol 1e-5).
Phase 3 builds the index through envelope_znorm (launches counted) and
checks on a sample of envelopes that no lower bound exceeds the true
distance.

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
# DTW path: (qlen, r) with r = 10% of |Q| (the paper's Fig. 25 window)
DTW_CASES = ((160, 16), (256, 25))
# queries of each length held against the plain-DP brute force (at
# qlen 160 it takes ~100 windows per series, so only the first few)
DTW_BRUTE = {160: 2, 256: BATCH}
# H100 SXM, NVIDIA data sheet: HBM3 bytes/s and float32 (non-tensor) FLOP/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
L2_BYTES = 50 * 2 ** 20     # H100 L2, where the device does not say
# (rtol, atol).  LB_Keogh's mu and sd: the reference kernel test's
# tolerances (sd = sqrt(s2 / L - mu^2) cancels when |mu| >> sd, so an ulp
# of s2 / L moves sd by many).  The DTW DP: the kernel runs the
# recurrence, the plain version the cumsum/cummin closed form, whose
# float32 cumsum over the band cancels by up to ~1e-3 at these lengths.
# batch_ed and lb_keogh: the reference kernel tests' (sums in another
# order); envelope_znorm: bit for bit (shared IEEE arithmetic).
TOL = {"fused_gather_ed": (1e-4, 1e-3), "mindist_sym": (1e-6, 1e-6),
       "mindist_paa": (1e-6, 1e-6), "fused_gather_lb_keogh": (2e-4, 2e-3),
       "fused_gather_lb_keogh.mu": (1e-4, 1e-4),
       "fused_gather_lb_keogh.sd": (1e-3, 1e-4),
       "dtw_survivors": (1e-4, 1e-3), "dtw_band": (1e-4, 1e-3),
       "batch_ed": (2e-4, 2e-3), "lb_keogh": (1e-5, 1e-5),
       "envelope_znorm": (0.0, 0.0)}
# windows of one host-backend chunk: 512 envelopes x (gamma + 1) offsets
HOST_CHUNK_WINDOWS = 512 * (BENCH["gamma"] + 1)
REPLACES = {
    "fused_gather_ed": ("src/repro_torch/kernels/csrc/fused_verify.cu",
                        "src/repro/kernels/fused_verify.py:181"),
    "mindist_sym": ("src/repro_torch/kernels/csrc/mindist.cu",
                    "src/repro/kernels/mindist.py:40"),
    "mindist_paa": ("src/repro_torch/kernels/csrc/mindist.cu",
                    "src/repro/kernels/mindist.py:40"),
    "fused_gather_lb_keogh": ("src/repro_torch/kernels/csrc/fused_verify.cu",
                              "src/repro/kernels/fused_verify.py:219"),
    "dtw_survivors": ("src/repro_torch/kernels/csrc/dtw_band.cu",
                      "src/repro/kernels/dtw_band.py:73"),
    "dtw_band": ("src/repro_torch/kernels/csrc/dtw_band.cu",
                 "src/repro/kernels/dtw_band.py:73"),
    "envelope_znorm": ("src/repro_torch/kernels/csrc/envelope.cu",
                       "src/repro/kernels/envelope.py:65"),
    "batch_ed": ("src/repro_torch/kernels/csrc/batch_ed.cu",
                 "src/repro/kernels/batch_ed.py:47"),
    "lb_keogh": ("src/repro_torch/kernels/csrc/lb_keogh.cu",
                 "src/repro/kernels/lb_keogh.py:27"),
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


def time_calls(torch, fns, reps=20, budget_s=0.25, events=1):
    """(device ms, event ms) per call over up to `reps` rounds through
    `fns` (several inputs, so a working set larger than L2 is read cold);
    a slow function (a plain version of thousands of launches) gets as
    few rounds as fit `budget_s`, at least 3.

    Device ms is the card's busy time from torch.profiler (None when
    three traces in a row hold fewer than `events` device activities a
    call: a trace sometimes records none, or only some, of a loop's
    kernels);
    event ms is CUDA events around the loop, which also counts the card
    waiting for the host to launch.
    """
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    per_call = (time.perf_counter() - t0) / len(fns)
    reps = max(3, min(reps, int(budget_s / max(per_call, 1e-9))))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for r in range(reps):
        fns[r % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    event_ms = start.elapsed_time(end) / reps
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for r in range(reps):
                fns[r % len(fns)]()
            torch.cuda.synchronize()
        # every call makes at least `events` device activities
        if len(device_events(prof)) >= reps * events:
            return device_ms(prof) / reps, event_ms
    return None, event_ms


def timing(torch, call, plain, nbytes, ops, err, shape, library=None,
           events=1):
    """One timing record: kernel and plain version (and the one PyTorch
    call computing the same function, where there is one), each by its
    device time where the profiler saw the card (else by CUDA events,
    and the record says which), beside the bound.  `events`: the device
    activities one call of the kernel's wrapper makes."""
    k_dev, k_ev = time_calls(torch, call, events=events)
    p_dev, p_ev = time_calls(torch, plain)
    lib_ms = None
    if library is not None:
        l_dev, l_ev = time_calls(torch, library)
        lib_ms = l_dev or l_ev
    by_bytes = nbytes / PEAK_BYTES >= ops / PEAK_F32
    return dict(
        shape=shape, timer="profiler" if k_dev else "events",
        plain_timer="profiler" if p_dev else "events",
        ms=k_dev or k_ev, plain_ms=p_dev or p_ev,
        event_ms=k_ev, plain_event_ms=p_ev, library_ms=lib_ms,
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


def trace_batch(torch, engine, queries, spec):
    """One search call under torch.profiler: wall time, the card's busy
    time and idle share, the top device and host items."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.search(queries, spec)
        wall = time.perf_counter() - t0
    busy = device_ms(prof) / 1e3
    by_kernel = {}
    for ev in device_events(prof):
        row = by_kernel.setdefault(ev.name[:120], {"name": ev.name[:120],
                                                  "count": 0, "ms": 0.0})
        row["count"] += 1
        row["ms"] += ev.time_range.elapsed_us() / 1e3
    host = [{"name": e.key[:80], "count": e.count,
             "ms": e.self_cpu_time_total / 1e3}
            for e in sorted(prof.key_averages(),
                            key=lambda e: -e.self_cpu_time_total)[:10]]
    by_name = sorted(by_kernel.values(), key=lambda r: -r["ms"])
    return {"qlen": len(queries[0]), "wall_s": wall, "device_busy_s": busy,
            "device_idle_share": 1 - busy / wall,
            "top_self_device": by_name[:10], "device_by_name": by_name,
            "device_events": sum(r["count"] for r in by_name),
            "launch_calls": sum(e.count for e in prof.key_averages()
                                if e.key.startswith("cudaLaunchKernel")),
            "top_self_cpu": host}


def log_trace(step, tr):
    log(f"[{step}] one traced batch (qlen {tr['qlen']}): wall "
        f"{tr['wall_s']:.3f} s under the profiler, device busy "
        f"{tr['device_busy_s']:.3f} s, idle share "
        f"{tr['device_idle_share']:.3f}")
    for row in tr["top_self_device"][:6]:
        log(f"    device {row['ms']:9.2f} ms  x{row['count']:6d}  "
            f"{row['name']}")
    for row in tr["top_self_cpu"][:6]:
        log(f"    host   {row['ms']:9.2f} ms  x{row['count']:6d}  "
            f"{row['name']}")


def check_answers(results, k):
    """Raise unless every result holds k finite ascending distances with
    real (series, offset) ids."""
    for r in results:
        if r.dists.shape != (k,) or not np.isfinite(r.dists).all() \
                or (r.series < 0).any() or (r.offsets < 0).any():
            raise AssertionError(f"malformed result {r}")
        if not (np.diff(r.dists) >= 0).all():
            raise AssertionError("result distances not ascending")


def dtw_cells(l: int, r: int) -> int:
    """Cells of one banded DP of length l and window r inside the series."""
    r = min(r, l - 1)
    return l * (2 * r + 1) - r * (r + 1)


def gather_bytes(torch, coll, sids, anchors, qlen: int, g: int) -> int:
    """Bytes a fused-gather chunk must read from the collection: its
    distinct region elements and distinct prefix-sum positions (x4
    arrays)."""
    dev = sids.device
    n = coll.data.shape[1]
    sid, anc = sids.long(), anchors.long()
    reg = torch.arange(qlen + g - 1, device=dev)
    region = torch.unique((sid[:, None] * n + anc[:, None] + reg).clamp(
        0, coll.data.numel() - 1))
    offs = (anc[:, None] + torch.arange(g, device=dev)).clamp(0, n - qlen)
    pos = sid[:, None] * (n + 1) + offs
    sums = torch.unique(torch.cat([pos, pos + qlen]).reshape(-1))
    return region.numel() * 4 + 4 * sums.numel() * 4


def chunk_args(torch, a0, qn, dlo, dhi, sids, anchors, n_master, kth,
               g: int):
    """One scan chunk of (B, rows) envelope rows through the LB_Keogh
    chunk entry, as the executor's chunk step runs it: returns the chunk
    entry's inputs (`lb_in`, for the entry and its plain version), its
    outputs, and the `dtw_survivors` arguments it leaves (its survivors'
    list and count, the candidates, mu, sd, and the DP output, +inf at
    every non-survivor)."""
    from repro_torch.core import executor
    from repro_torch.kernels.fused_verify import fused_gather_lb_keogh_chunk
    b, rows = sids.shape
    ok, cand_sid, cand_off = executor._chunk_candidates(
        sids, anchors, n_master, torch.ones_like(sids, dtype=torch.bool),
        qn.shape[1], a0[0].shape[1], g)
    lb_in = (*a0, sids.reshape(-1).contiguous(),
             anchors.reshape(-1).contiguous(), dlo, dhi, ok,
             kth.contiguous())
    out = fused_gather_lb_keogh_chunk(*lb_in, g=g, rows=rows, znorm=True)
    _, mu, sd, slist, nsurv, d2 = out
    return lb_in, out, (a0[0], qn, slist, nsurv, cand_sid, cand_off,
                        mu.reshape(b, -1), sd.reshape(b, -1), d2)


def check_chunk_entry(torch, got, want, kth):
    """Hold the LB chunk entry's outputs against its plain version: lb2
    within the LB tolerance (the same +inf), mu and sd bit-equal, the
    same survivor set up to lb2 within the tolerance of kth, nsurv its
    size, the list a permutation of it, and +inf in the DP's output at
    every non-survivor.  Returns (max abs err of lb2, survivors)."""
    err = check_close(torch, "fused_gather_lb_keogh", got[0], want[0])
    for name, x, y in (("mu", got[1], want[1]), ("sd", got[2], want[2])):
        check_equal(torch, f"fused_gather_lb_keogh_chunk.{name}", x, y)
    b = kth.shape[0]
    rtol, atol = TOL["fused_gather_lb_keogh"]
    surv = got[0].reshape(b, -1) < kth[:, None]
    plain = want[0].reshape(b, -1)
    near = (plain - kth[:, None]).abs() <= atol + rtol * kth.abs()[:, None]
    if not bool((near | (surv == (plain < kth[:, None]))).all()):
        raise AssertionError("LB chunk entry: survivor set differs")
    if not torch.equal(got[4], surv.sum(dim=1, dtype=torch.int32)):
        raise AssertionError("LB chunk entry: nsurv is not the set's size")
    for i in range(b):
        listed = got[3][i, :int(got[4][i])].long().sort().values
        if not torch.equal(listed, surv[i].nonzero()[:, 0]):
            raise AssertionError("LB chunk entry: list is not the set")
    if not bool(torch.isinf(got[5][~surv]).all()):
        raise AssertionError("LB chunk entry: DP output not +inf off the "
                             "survivors")
    return err, int(got[4].sum())


def check_dtw_kernels(torch, dev, p, probe, rng):
    """The DTW path's kernels against their plain versions at its shapes;
    returns the max abs error of each, the share of LB_Keogh's mu and sd
    entries that are bit-equal to the plain version's (both entries), and
    the count of window points whose normalization (`gather_znorm`, the
    LB and DP kernels' arithmetic) differs from the IEEE divide, of how
    many."""
    from repro_torch.core import planner
    from repro_torch.core.paa import znormalize
    from repro_torch.kernels import ref
    from repro_torch.kernels.dtw_band import dtw_band, dtw_survivors
    from repro_torch.kernels.fused_verify import (fused_gather_lb_keogh,
                                                  gather_znorm)
    g = p.gamma + 1
    s_probe, n = probe.data.shape
    a0 = (probe.data, probe.csum, probe.csum2, probe.csum_lo,
          probe.csum2_lo, probe.center)
    errs = dict.fromkeys(("fused_gather_lb_keogh", "fused_gather_lb_keogh.mu",
                          "fused_gather_lb_keogh.sd", "dtw_survivors",
                          "dtw_band"), 0.0)
    same, total, w_differ, w_points = 0, 0, 0, 0

    def close(name, got, want):
        errs[name] = max(errs[name], check_close(torch, name, got, want))

    for qlen, r in DTW_CASES:
        q = torch.from_numpy(rng.normal(size=(BATCH, qlen)).astype(
            np.float32)).to(dev)
        qn, dlo, dhi, _, _ = planner.prepare_query_batch(
            q, p.seg_len, True, "dtw", r)
        for rows in (64, 512):
            sids = torch.from_numpy(rng.integers(
                0, s_probe, BATCH * rows).astype(np.int32)).to(dev)
            anc = torch.from_numpy(rng.integers(
                0, n - qlen + 1, BATCH * rows).astype(np.int32)).to(dev)
            for znorm in (False, True):
                got = fused_gather_lb_keogh(*a0, sids, anc, dlo, dhi, g=g,
                                            rows=rows, znorm=znorm)
                want = ref.fused_gather_lb_keogh_ref(
                    *a0, sids, anc, dlo, dhi, g=g, rows=rows, znorm=znorm)
                for suffix, x, y in zip(("", ".mu", ".sd"), got, want):
                    close("fused_gather_lb_keogh" + suffix, x, y)
                for x, y in zip(got[1:], want[1:]):
                    same += int((x == y).sum())
                    total += x.numel()
                # every window point: the kernels' w against the divide
                w = gather_znorm(probe.data, sids, anc, got[1], got[2],
                                 qlen=qlen, g=g)
                w_ref = ref.gather_znorm_ref(probe.data, sids, anc, got[1],
                                             got[2], qlen=qlen, g=g)
                w_differ += int((w.view(torch.int32)
                                 != w_ref.view(torch.int32)).sum())
                w_points += w.numel()
                del w, w_ref
            # the scan's chunk entry and the DP over its survivors (znorm):
            # each query keeps about its 600 least lower bounds, query 0
            # none
            kth = got[0].reshape(BATCH, -1).sort(dim=1).values[:, 600]
            kth[0] = -float("inf")
            csid = sids.reshape(BATCH, rows)
            lb_in, out, dp = chunk_args(
                torch, a0, qn, dlo, dhi, csid, anc.reshape(BATCH, rows),
                torch.full_like(csid, g), kth, g)
            err, _ = check_chunk_entry(
                torch, out, ref.fused_gather_lb_keogh_chunk_ref(
                    *lb_in, g=g, rows=rows, znorm=True), kth)
            errs["fused_gather_lb_keogh"] = max(
                errs["fused_gather_lb_keogh"], err)
            close("dtw_survivors",
                  dtw_survivors(*dp[:-1], dp[-1].clone(), r=r, znorm=True),
                  ref.dtw_survivors_ref(*dp[:-1], dp[-1].clone(), r=r,
                                        znorm=True))
        # the function entry: q_0 against 4096 z-normalized windows
        cands = znormalize(probe.data[:, :qlen]).contiguous()
        close("dtw_band", dtw_band(qn[0].contiguous(), cands, r),
              ref.dtw_band_ref(qn[0], cands, r))
    return errs, same / total, (w_differ, w_points)


def envelope_work(p, n: int):
    """Per series of length n: (valid (master, l', segment) cells,
    valid (master, l') pairs, (master, segment) pairs with a cell) of the
    Z-normalized build — what `envelope_znorm` computes."""
    g, w = p.gamma + 1, p.w
    cells = pairs = segs = 0
    for off in range(p.num_envelopes(n) * g):
        if off + p.lmin > n:
            continue
        longest = min(p.lmax, n - off)
        pairs += longest - p.lmin + 1
        for z in range(w):
            first = max(p.lmin, (z + 1) * p.seg_len)
            if first <= longest:
                cells += longest - first + 1
                segs += 1
    return cells, pairs, segs


def check_equal(torch, name, got, want):
    """Raise unless `got` equals `want` value for value (bit for bit up to
    the sign of zero); returns 0.0, the max abs error."""
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.equal(got, want.to(got.device)):
        raise AssertionError(f"{name}: not equal to its plain version")
    return 0.0


def probe_windows(torch, probe, rng, qlen: int):
    """HOST_CHUNK_WINDOWS windows of length qlen of the probe collection
    at random (series, offset): one host chunk's worth."""
    s, n = probe.data.shape
    dev = probe.data.device
    sid = torch.from_numpy(rng.integers(0, s, HOST_CHUNK_WINDOWS)).to(dev)
    off = torch.from_numpy(rng.integers(0, n - qlen + 1,
                                        HOST_CHUNK_WINDOWS)).to(dev)
    return probe.data.unfold(1, qlen, 1)[sid, off].contiguous()


def check_slice3_kernels(torch, dev, p, probe, rng):
    """The index build's and the host backend's kernels against their
    plain versions at the path's shapes; returns the max abs error of
    each."""
    from repro_torch.core import planner
    from repro_torch.core.envelope import _prefix
    from repro_torch.core.paa import znormalize
    from repro_torch.kernels import ref
    from repro_torch.kernels.batch_ed import batch_ed
    from repro_torch.kernels.envelope import (envelope_znorm,
                                              envelope_znorm_masters)
    from repro_torch.kernels.lb_keogh import lb_keogh
    errs = dict.fromkeys(("envelope_znorm", "batch_ed", "lb_keogh"), 0.0)
    # the build entry on the probe collection: kernel, plain version on
    # the card and on the CPU, from the same prefix sums
    x = probe.data
    xc = x - x.mean(dim=-1, keepdim=True)
    csum, csum2 = _prefix(xc), _prefix(xc * xc)
    kw = dict(lmin=p.lmin, lmax=p.lmax, gamma=p.gamma, seg_len=p.seg_len)
    got = envelope_znorm(csum, csum2, **kw)
    card = ref.envelope_znorm_ref(csum, csum2, **kw)
    cpu = ref.envelope_znorm_ref(csum.cpu(), csum2.cpu(), **kw)
    for k, c, h in zip(got, card, cpu):
        check_equal(torch, "envelope_znorm", k, c)
        check_equal(torch, "envelope_znorm (plain on the CPU)", k, h)
    # the per-master entry on every master of the first series
    n = x.shape[1]
    offs = torch.arange(n - p.lmin + 1, device=dev)
    start = offs[:, None] + torch.arange(p.w, device=dev) * p.seg_len
    segmean = ref.true_div(csum[0, (start + p.seg_len).clamp(max=n)]
                           - csum[0, start.clamp(max=n)], p.seg_len)
    ends = (offs[:, None] + torch.arange(p.lmin, p.lmax + 1, device=dev)
            ).clamp(max=n)
    margs = (segmean.contiguous(),
             (csum[0, ends] - csum[0, offs][:, None]).contiguous(),
             (csum2[0, ends] - csum2[0, offs][:, None]).contiguous(),
             offs.to(torch.int32))
    mkw = dict(n=n, lmin=p.lmin, seg_len=p.seg_len)
    for k, c in zip(envelope_znorm_masters(*margs, **mkw),
                    ref.envelope_scan_ref(*margs, **mkw)):
        check_equal(torch, "envelope_znorm_masters", k, c)
    # batch_ed and lb_keogh on one host chunk's worth of windows
    for qlen, r in DTW_CASES:
        windows = probe_windows(torch, probe, rng, qlen)
        q = torch.from_numpy(rng.normal(size=(BATCH, qlen)).astype(
            np.float32)).to(dev)
        qn, dlo, dhi, _, _ = planner.prepare_query_batch(q, p.seg_len, True,
                                                         "dtw", r)
        for qb in (1, 8):
            for znorm, qs in ((True, qn[:qb]), (False, q[:qb])):
                errs["batch_ed"] = max(errs["batch_ed"], check_close(
                    torch, "batch_ed", batch_ed(windows, qs, znorm),
                    ref.batch_ed_ref(windows, qs, znorm)))
        wn = znormalize(windows)
        errs["lb_keogh"] = max(errs["lb_keogh"], check_close(
            torch, "lb_keogh", lb_keogh(dlo[0], dhi[0], wn),
            ref.lb_keogh_ref(dlo[0], dhi[0], wn)))
    return errs


def check_lower_bounds(torch, index, data, p, queries, n_sample: int, seed):
    """On a sample of the index's valid envelopes, every lower bound
    (iSAX and PAA) of every query is at most the true distance of the
    envelope's nearest candidate window (float64 on the card; slack 1e-4
    for the float32 bound).  Returns the largest lb - d seen."""
    from repro_torch.core import planner
    env = index.envelopes
    dev = data.device
    s, n = data.shape
    g = p.gamma + 1
    gen = torch.Generator(device=dev).manual_seed(seed)
    valid = torch.nonzero(env.valid).squeeze(1)
    pick = valid[torch.randint(len(valid), (n_sample,), generator=gen,
                               device=dev)]
    sub = env.map(lambda t: t[pick].contiguous())
    sid, anc = sub.series_id.long(), sub.anchor.long()
    worst = -float("inf")
    for q in queries:
        qlen = len(q)
        qt = torch.from_numpy(np.asarray(q, np.float32)).to(dev)[None]
        qn, _, _, qb, qh = planner.prepare_query_batch(qt, p.seg_len,
                                                       p.znorm)
        offs = anc[:, None] + torch.arange(g, device=dev)
        ok = ((torch.arange(g, device=dev) < sub.n_master[:, None])
              & (offs + qlen <= n))
        w = data.unfold(1, qlen, 1)[sid[:, None], offs.clamp(max=n - qlen)
                                    ].double()
        if p.znorm:
            w = (w - w.mean(-1, keepdim=True)) / w.std(
                -1, keepdim=True, correction=0).clamp_min(1e-8)
        d = torch.sqrt(((w - qn[0].double()) ** 2).sum(-1))
        d_min = torch.where(ok, d, float("inf")).amin(dim=1)
        for use_paa in (False, True):
            lb = planner.env_lower_bounds_batch(
                qb, qh, sub, index.breakpoints, p.seg_len,
                p.query_segments(qlen), use_paa)[0].double()
            excess = float((lb - d_min).max())
            worst = max(worst, excess)
            if excess > 1e-4:
                raise AssertionError(
                    f"a lower bound exceeds the true distance by {excess} "
                    f"(qlen {qlen}, use_paa {use_paa})")
    return worst


def same_answers(a, b, atol: float, what: str) -> float:
    """Raise unless results a and b hold the same (series, offset) set and
    their distances (each sorted) agree within atol; returns the max abs
    difference."""
    if set(zip(a.series.tolist(), a.offsets.tolist())) \
            != set(zip(b.series.tolist(), b.offsets.tolist())):
        raise AssertionError(f"{what}: answers differ: "
                             f"{list(zip(a.series, a.offsets))} vs "
                             f"{list(zip(b.series, b.offsets))}")
    err = float(np.abs(np.sort(a.dists) - np.sort(b.dists)).max())
    if err > atol:
        raise AssertionError(f"{what}: distances {a.dists} vs {b.dists}")
    return err


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
    from repro_torch.core.paa import znormalize
    from repro_torch.core import envelope as core_envelope
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.batch_ed import batch_ed
    from repro_torch.kernels.dtw_band import dtw_band, dtw_survivors
    from repro_torch.kernels.envelope import envelope_znorm
    from repro_torch.kernels.fused_verify import (
        fused_gather_ed, fused_gather_lb_keogh, fused_gather_lb_keogh_chunk,
        gather_znorm)
    from repro_torch.kernels.lb_keogh import lb_keogh
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
    # every kernel wrapper of the port, each count set to 0 before a path
    all_wrappers = {**wrappers, "fused_gather_lb_keogh": fused_gather_lb_keogh,
                    "fused_gather_lb_keogh_chunk": fused_gather_lb_keogh_chunk,
                    "gather_znorm": gather_znorm,
                    "dtw_survivors": dtw_survivors, "dtw_band": dtw_band,
                    "envelope_znorm": envelope_znorm, "batch_ed": batch_ed,
                    "lb_keogh": lb_keogh}

    def zero_counts():
        torch.cuda.synchronize()
        for w in all_wrappers.values():
            w.launches = 0
        executor.device_exact_scan.syncs = 0
        executor.to_host.syncs = 0

    def read_counts(names):
        return {name: all_wrappers[name].launches for name in names}
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
    dtw_errs, results["lb_keogh_mu_sd_bit_equal"], (w_differ, w_points) = \
        check_dtw_kernels(torch, dev, p, probe, rng)
    results["znorm_w_differ_from_divide"] = {"points": w_points,
                                             "differ": w_differ}
    if w_differ:
        raise AssertionError(
            f"the kernels' window normalization differs from the IEEE "
            f"divide at {w_differ} of {w_points} points")
    errs.update(dtw_errs)
    errs.update(check_slice3_kernels(torch, dev, p, probe, rng))
    del probe, lo, hi, valid, sym_lo, sym_hi
    torch.cuda.synchronize()
    log(f"[2] kernels agree with their plain versions: "
        + ", ".join(f"{k} max abs err {v:.3g}" for k, v in errs.items())
        + f"; LB_Keogh mu/sd bit-equal to the plain version's: "
        f"{results['lb_keogh_mu_sd_bit_equal']:.6f}; the LB and DP "
        f"kernels' normalized window points differing from the IEEE "
        f"divide: {w_differ} of {w_points}")

    # -- 3. the index on the card ------------------------------------------
    t0 = time.perf_counter()
    data = series_batches(args.series, SERIES_LEN, seed=args.seed)
    coll = Collection.from_array(data, device=dev)
    zero_counts()
    t1 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    engine = UlisseEngine.from_collection(coll, p, block_size=64,
                                          num_levels=2, device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    build_launches = read_counts(("envelope_znorm",))
    if build_launches["envelope_znorm"] <= 0:
        raise AssertionError("the index build did not launch envelope_znorm")
    index = engine.index
    results["index"] = {
        "data_s": t1 - t0, "build_s": t2 - t1,
        "envelopes": index.num_envelopes,
        "valid_envelopes": int(index.envelopes.valid.sum()),
        "blocks": [lvl.size for lvl in index.levels],
        "launches": build_launches,
        "peak_build_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
        "resident_gib": torch.cuda.memory_allocated(dev) / 2 ** 30}
    log(f"[3] index: {args.series} series x {SERIES_LEN} -> "
        f"{results['index']['envelopes']} envelopes, blocks "
        f"{results['index']['blocks']}; data+stats {t1 - t0:.1f} s, build "
        f"{t2 - t1:.3f} s, peak {results['index']['peak_build_gib']:.2f} "
        f"GiB; launches {build_launches}")

    # -- 4. the main path --------------------------------------------------
    qrng = np.random.default_rng(args.seed + 2)

    def make_batch(qlen):
        sids = qrng.integers(0, args.series, BATCH)
        offs = qrng.integers(0, SERIES_LEN - qlen + 1, BATCH)
        return [data[s, o:o + qlen] + qrng.normal(size=qlen).astype(
            np.float32) * 0.1 for s, o in zip(sids, offs)]

    # its own query stream, so the paths' batches stay those of earlier runs
    lrng = np.random.default_rng(args.seed + 3)
    lb_excess = check_lower_bounds(
        torch, index, coll.data, p,
        [data[s, o:o + qlen] + lrng.normal(size=qlen).astype(np.float32)
         * 0.1 for qlen in QLENS
         for s, o in zip(lrng.integers(0, args.series, 2),
                         lrng.integers(0, SERIES_LEN - qlen + 1, 2))],
        4096, args.seed)
    results["index"]["lower_bound_max_excess"] = lb_excess
    log(f"[3] lower bounds never exceed the true distance on 4096 sampled "
        f"envelopes x 4 queries (iSAX and PAA; max lb - d {lb_excess:.3g},"
        f" slack 1e-4)")

    spec = QuerySpec(k=K)
    engine.search(make_batch(QLENS[0]), spec)        # warm-up (host copy)
    batches = [make_batch(QLENS[i % len(QLENS)]) for i in range(BATCHES)]
    zero_counts()
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
    check_answers(flat, K)
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
            nbytes = (gather_bytes(torch, coll, *chunks[0], qlen, g)
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
            f"({t['bound_by']}, {t['timer']}/{t['plain_timer']}; events "
            f"{t['event_ms']:.4f} / {t['plain_event_ms']:.4f} ms)")

    # -- 7. where a batch's time goes (one traced batch) -------------------
    results["traced_batch"] = trace_batch(torch, engine, batches[1], spec)
    log_trace(7, results["traced_batch"])

    # -- 8. the DTW path -----------------------------------------------------
    dtw_wrappers = {"fused_gather_lb_keogh_chunk": fused_gather_lb_keogh_chunk,
                    "dtw_survivors": dtw_survivors,
                    "mindist_sym": mindist_sym, "mindist_paa": mindist_paa}
    dtw_specs = [QuerySpec(k=K, measure="dtw", r=r) for _, r in DTW_CASES]
    dtw_batches = [make_batch(qlen) for qlen, _ in DTW_CASES]
    zero_counts()
    dtw_answers, dtw_lat = [], []
    t0 = time.perf_counter()
    for qs, dspec in zip(dtw_batches, dtw_specs):
        tb = time.perf_counter()
        dtw_answers.append(engine.search(qs, dspec))
        dtw_lat.append(time.perf_counter() - tb)
    dtw_wall = time.perf_counter() - t0
    dtw_launches = {name: w.launches for name, w in dtw_wrappers.items()}
    dtw_syncs = executor.device_exact_scan.syncs
    for name, n in dtw_launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the DTW path")
    if fused_gather_ed.launches:
        raise AssertionError("the DTW path launched fused_gather_ed")
    flat = [r for ans in dtw_answers for r in ans]
    check_answers(flat, K)
    st = [r.stats for r in flat]
    nq = len(flat)
    results["dtw_path"] = {
        "cases": [{"qlen": qlen, "r": r} for qlen, r in DTW_CASES],
        "queries": nq, "batches": len(dtw_batches), "wall_s": dtw_wall,
        "queries_per_s": nq / dtw_wall, "batch_latency_s": dtw_lat,
        "launches": dtw_launches, "stop_test_syncs": dtw_syncs,
        "host_syncs_per_batch": dtw_syncs / len(dtw_batches) + 1,
        "mean_chunks_visited": float(np.mean([s.chunks_visited for s in st])),
        "mean_envelopes_checked": float(np.mean(
            [s.envelopes_checked for s in st])),
        "mean_pruning_power": float(np.mean([s.pruning_power for s in st])),
        "mean_dtw_lb_keogh": float(np.mean([s.dtw_lb_keogh for s in st])),
        "mean_dtw_full": float(np.mean([s.dtw_full for s in st])),
        "mean_abandoning_power": float(np.mean(
            [s.abandoning_power for s in st])),
        "exact_from_approx": float(np.mean(
            [s.exact_from_approx for s in st]))}
    d = results["dtw_path"]
    log(f"[8] DTW path: {nq} queries in {len(dtw_batches)} batches "
        f"({', '.join(f'qlen {q} r {r}' for q, r in DTW_CASES)}), "
        f"{d['queries_per_s']:.2f} queries/s, batch latency "
        f"{', '.join(f'{x:.3f}' for x in dtw_lat)} s; launches "
        f"{dtw_launches}; host syncs per batch "
        f"{d['host_syncs_per_batch']:.2f}; mean chunks "
        f"{d['mean_chunks_visited']:.1f}, pruning power "
        f"{d['mean_pruning_power']:.5f}; LB_Keogh {d['mean_dtw_lb_keogh']:.1f}"
        f" -> DP {d['mean_dtw_full']:.1f} per query, abandoning power "
        f"{d['mean_abandoning_power']:.5f}")
    worst, checked, brute_s = 0.0, 0, {}
    tb = time.perf_counter()
    for (qlen, r), ans, qs in zip(DTW_CASES, dtw_answers, dtw_batches):
        tq = time.perf_counter()
        for res, q in list(zip(ans, qs))[:DTW_BRUTE[qlen]]:
            oracle = brute_force_knn(coll, q, k=K, znorm=p.znorm,
                                     measure="dtw", r=r)
            err = float(np.abs(res.dists - oracle.dists).max())
            worst, checked = max(worst, err), checked + 1
            if err > 5e-3:
                raise AssertionError(
                    f"DTW engine {res.dists} vs brute force {oracle.dists}")
        brute_s[qlen] = (time.perf_counter() - tq) / DTW_BRUTE[qlen]
    results["dtw_brute_force"] = {"queries": checked, "max_abs_err": worst,
                                  "seconds": time.perf_counter() - tb,
                                  "seconds_per_query": brute_s}
    log(f"[8] DTW answers match the plain-DP brute force on the card "
        f"({checked} queries: {DTW_BRUTE}; max |d - d_brute| {worst:.2e}, "
        f"tolerance 5e-3; {time.perf_counter() - tb:.1f} s, per query "
        + ", ".join(f"qlen {q}: {t:.1f} s" for q, t in brute_s.items())
        + ")")

    # -- 9. DTW kernel timings at the DTW path's inputs ----------------------
    n_pad = executor.pow2ceil(env.size)
    none = torch.full((BATCH, 1), env.size, dtype=torch.int32, device=dev)
    zero = torch.zeros(BATCH, dtype=torch.int32, device=dev)
    a0 = (coll.data, coll.csum, coll.csum2, coll.csum_lo, coll.csum2_lo,
          coll.center)
    rows = 512
    results["lb_le_dtw"] = {}
    for (qlen, r), qs_np, ans in zip(DTW_CASES, dtw_batches, dtw_answers):
        nseg = p.query_segments(qlen)
        q = torch.from_numpy(np.stack(qs_np)).to(dev)
        qn, dlo, dhi, qb, qh = planner.prepare_query_batch(
            q, p.seg_len, p.znorm, "dtw", r)
        lbs = planner.env_lower_bounds_batch(qb, qh, env, index.breakpoints,
                                             p.seg_len, nseg, False)
        ssids, sanc, snm, _, _ = planner.device_scan_pack(
            env.series_id, env.anchor, env.n_master, lbs, none, zero,
            chunk=1, n_pad=n_pad)
        # the first 24 chunks of the LB order: their regions (~6 MB each)
        # stream more than twice the L2 per round
        chunks = [(ssids[:, i * rows:(i + 1) * rows].contiguous(),
                   sanc[:, i * rows:(i + 1) * rows].contiguous(),
                   snm[:, i * rows:(i + 1) * rows]) for i in range(24)]
        call = [lambda c=c: fused_gather_lb_keogh(
            *a0, c[0].reshape(-1), c[1].reshape(-1), dlo, dhi, g=g,
            rows=rows, znorm=p.znorm) for c in chunks]
        plain = [lambda c=c: ref.fused_gather_lb_keogh_ref(
            *a0, c[0].reshape(-1), c[1].reshape(-1), dlo, dhi, g=g,
            rows=rows, znorm=p.znorm) for c in chunks]
        got, want = call[0](), plain[0]()
        err = check_close(torch, "fused_gather_lb_keogh", got[0], want[0])
        for suffix, x, y in zip((".mu", ".sd"), got[1:], want[1:]):
            check_close(torch, "fused_gather_lb_keogh" + suffix, x, y)
        region_bytes = gather_bytes(torch, coll, chunks[0][0].reshape(-1),
                                    chunks[0][1].reshape(-1), qlen, g)
        nbytes = (region_bytes + 2 * BATCH * qlen * 4 + BATCH * rows * 8
                  + 3 * BATCH * rows * g * 4)
        # per window point: subtract, divide, two subtracts, two max,
        # two multiplies, two adds
        ops = 10 * BATCH * rows * g * qlen
        timings[("fused_gather_lb_keogh", qlen, rows)] = timing(
            torch, call, plain, nbytes, ops, err,
            f"B={BATCH} rows={rows} qlen={qlen} g={g}")
        # the scan's chunk entry and the DP over its survivors, under the
        # batch's final k-th distance (what the scan's later chunks see)
        kth = torch.tensor([float(a.dists[-1]) ** 2 for a in ans],
                           dtype=torch.float32, device=dev)
        steps = [chunk_args(torch, a0, qn, dlo, dhi, sid_c, anc_c, nm_c,
                            kth, g) for sid_c, anc_c, nm_c in chunks]
        call = [lambda c=c: fused_gather_lb_keogh_chunk(
            *c[0], g=g, rows=rows, znorm=p.znorm) for c in steps]
        plain = [lambda c=c: ref.fused_gather_lb_keogh_chunk_ref(
            *c[0], g=g, rows=rows, znorm=p.znorm) for c in steps]
        err, _ = check_chunk_entry(torch, steps[0][1], plain[0](), kth)
        nsurv_total = sum(int(c[1][4].sum()) for c in steps[:8])
        per_call = nsurv_total / 8
        # + the mask, kth, the list and its counts, the DP's output
        timings[("fused_gather_lb_keogh_chunk", qlen, rows)] = timing(
            torch, call, plain, nbytes + BATCH * rows * g * 5 + BATCH * 8
            + per_call * 4, ops, err,
            f"B={BATCH} rows={rows} qlen={qlen} g={g} "
            f"surv/call={per_call:.0f}", events=2)
        # LB_Keogh <= DTW on every survivor of the first chunk that has
        # any (the LB kernel's bound and the DP kernel's distance, one
        # normalization)
        first = next(c for c in steps if int(c[1][4].sum()) > 0)
        lb2_0, dp0 = first[1][0], first[2]
        d2_0 = dtw_survivors(*dp0[:-1], dp0[-1].clone(), r=r, znorm=p.znorm)
        surv0 = torch.isfinite(d2_0)
        excess = (lb2_0.reshape(BATCH, -1) - d2_0)[surv0]
        worst = float(excess.max()) if excess.numel() else -float("inf")
        bad = int((excess > 0).sum())
        results["lb_le_dtw"][qlen] = {"survivors": int(surv0.sum()),
                                      "lb_above_dtw": bad,
                                      "max_lb_minus_dtw": worst}
        if bad or not excess.numel():
            raise AssertionError(
                f"LB_Keogh <= DTW fails on {bad} of {excess.numel()} "
                f"survivors (qlen {qlen}; max lb - d {worst})")
        log(f"[9] LB_Keogh <= DTW on all {excess.numel()} survivors of a "
            f"chunk (qlen {qlen}, r {r}; max lb - d {worst:.3g})")
        surv_inputs = [c[2] for c in steps[:8]]
        call = [lambda a=a: dtw_survivors(*a, r=r, znorm=p.znorm)
                for a in surv_inputs]
        plain = [lambda a=a: ref.dtw_survivors_ref(*a, r=r, znorm=p.znorm)
                 for a in surv_inputs]
        a_0 = surv_inputs[0]
        err = check_close(
            torch, "dtw_survivors",
            dtw_survivors(*a_0[:-1], a_0[-1].clone(), r=r, znorm=p.znorm),
            ref.dtw_survivors_ref(*a_0[:-1], a_0[-1].clone(), r=r,
                                  znorm=p.znorm))
        # survivor windows, their list entry and four plan entries and
        # their output, queries, counts
        nbytes = (per_call * (qlen * 4 + 6 * 4) + BATCH * qlen * 4
                  + BATCH * 4)
        ops = 5 * per_call * dtw_cells(qlen, r)
        timings[("dtw_survivors", qlen)] = timing(
            torch, call, plain, nbytes, ops, err,
            f"B={BATCH} M={rows * g} r={r} surv/call={per_call:.0f}")
        timings[("dtw_survivors", qlen)]["survivors_per_call"] = per_call
        # the function entry: q_0 against windows of the collection, more
        # than twice the L2 of them
        cands = znormalize(coll.data[:-(-2 * l2 // (qlen * 4)), :qlen]
                           ).contiguous()
        ncand = cands.shape[0]
        q0 = qn[0].contiguous()
        call = [lambda: dtw_band(q0, cands, r)]
        plain = [lambda: ref.dtw_band_ref(q0, cands, r)]
        err = check_close(torch, "dtw_band", call[0](), plain[0]())
        timings[("dtw_band", qlen)] = timing(
            torch, call, plain, ncand * qlen * 4 + qlen * 4 + ncand * 4,
            5 * ncand * dtw_cells(qlen, r), err,
            f"N={ncand} qlen={qlen} r={r}")
        del cands, surv_inputs, chunks, steps
    results["timings"] = {" ".join(map(str, k)): v
                          for k, v in timings.items()}
    for key, t in timings.items():
        if key[0] in ("fused_gather_lb_keogh", "fused_gather_lb_keogh_chunk",
                      "dtw_survivors", "dtw_band"):
            log(f"[9] {key[0]:27s} {t['shape']:45s} kernel {t['ms']:.4f} "
                f"ms  plain {t['plain_ms']:.4f} ms  bound {t['bound_ms']:.4f}"
                f" ms ({t['bound_by']}, {t['timer']}/{t['plain_timer']}; "
                f"events {t['event_ms']:.4f} / {t['plain_event_ms']:.4f} "
                f"ms)")

    # -- 10. where a DTW batch's time goes (one traced batch) ---------------
    zero_counts()
    tr = trace_batch(torch, engine, dtw_batches[1], dtw_specs[1])
    steps = fused_gather_lb_keogh_chunk.launches
    # the survivor pack's cumsum (a scan kernel) is gone from the scan
    tr["scan_kernel_events"] = sum(
        row["count"] for row in tr["device_by_name"]
        if "scan" in row["name"].lower())
    tr["chunk_steps"] = steps
    tr["device_events_per_step"] = tr["device_events"] / max(steps, 1)
    tr["launch_calls_per_step"] = tr["launch_calls"] / max(steps, 1)
    results["traced_dtw_batch"] = tr
    log_trace(10, tr)
    log(f"[10] {steps} chunk steps: {tr['device_events_per_step']:.1f} device"
        f" activities and {tr['launch_calls_per_step']:.1f} kernel launch "
        f"calls a step; scan kernels (the survivor pack's cumsum): "
        f"{tr['scan_kernel_events']}")
    if tr["scan_kernel_events"]:
        raise AssertionError("the traced DTW batch still runs scan kernels")

    # -- 11. the host backend ------------------------------------------------
    # two queries per measure whose device answers were checked against
    # the brute force in [5] and [8]
    host_cases = {
        "ed": [(batches[i][0], answers[i][0], QuerySpec(
            k=K, scan_backend="host")) for i in (0, 1)],
        "dtw": [(dtw_batches[i][0], dtw_answers[i][0], QuerySpec(
            k=K, measure="dtw", r=r, scan_backend="host"))
            for i, (_, r) in enumerate(DTW_CASES)]}
    host_kernels = {"ed": ("batch_ed", "mindist_sym", "mindist_paa"),
                    "dtw": ("lb_keogh", "dtw_band", "mindist_sym",
                            "mindist_paa")}
    results["host_path"] = {}
    host_answers = {}
    for measure, cases in host_cases.items():
        zero_counts()
        t0 = time.perf_counter()
        got = [engine.search(q, hspec) for q, _, hspec in cases]
        wall = time.perf_counter() - t0
        hl = read_counts(host_kernels[measure])
        syncs = executor.to_host.syncs
        for name, n in hl.items():
            if n <= 0:
                raise AssertionError(
                    f"{name} was not launched on the host {measure} path")
        worst = max(same_answers(g_, want, 5e-3, f"host {measure}")
                    for g_, (_, want, _) in zip(got, cases))
        host_answers[measure] = got
        results["host_path"][measure] = {
            "queries": len(cases), "qlens": [len(q) for q, _, _ in cases],
            "wall_s": wall, "queries_per_s": len(cases) / wall,
            "launches": hl, "host_syncs": syncs,
            "host_syncs_per_query": syncs / len(cases),
            "chunks_visited": [r.stats.chunks_visited for r in got],
            "max_abs_err_vs_device": worst}
        h = results["host_path"][measure]
        log(f"[11] host backend, {measure}: {len(cases)} queries (qlen "
            f"{h['qlens']}) in {wall:.2f} s, {h['queries_per_s']:.3f} "
            f"queries/s; launches {hl}; host syncs per query "
            f"{h['host_syncs_per_query']:.1f}; chunks {h['chunks_visited']};"
            f" answers = the device's (max |d - d_device| {worst:.2e}, "
            f"tolerance 5e-3)")

    # -- 12. approx-only -----------------------------------------------------
    approx_cases = {
        "ed": (batches[0], answers[0], QuerySpec(k=K, mode="approx"),
               ("fused_gather_ed", "mindist_paa")),
        "dtw": (dtw_batches[1], dtw_answers[1], QuerySpec(
            k=K, measure="dtw", r=DTW_CASES[1][1], mode="approx"),
            ("fused_gather_lb_keogh_chunk", "dtw_survivors",
             "mindist_paa"))}
    results["approx_path"] = {}
    for measure, (qs, exact, aspec, names) in approx_cases.items():
        zero_counts()
        t0 = time.perf_counter()
        got = engine.search(qs, aspec)
        wall = time.perf_counter() - t0
        al = read_counts(names)
        for name, n in al.items():
            if n <= 0:
                raise AssertionError(
                    f"{name} was not launched on the approx {measure} path")
        if mindist_sym.launches:
            raise AssertionError("approx-only launched mindist_sym")
        check_answers(got, K)
        certified = 0
        for a, e in zip(got, exact):
            # ED: both rescored in float64; DTW: the same device DP values
            if a.dists[-1] < e.dists[-1] - 1e-6:
                raise AssertionError(f"approx {measure} k-th distance "
                                     f"{a.dists[-1]} < exact {e.dists[-1]}")
            if a.stats.exact_from_approx:
                certified += 1
                same_answers(a, e, 1e-9, f"certified approx {measure}")
        results["approx_path"][measure] = {
            "queries": len(qs), "qlen": len(qs[0]), "wall_s": wall,
            "launches": al, "certified": certified,
            "stop_test_syncs": executor.device_exact_scan.syncs,
            "mean_kth_ratio": float(np.mean(
                [a.dists[-1] / e.dists[-1] for a, e in zip(got, exact)]))}
        ap = results["approx_path"][measure]
        log(f"[12] approx-only, {measure}: {len(qs)} queries (qlen "
            f"{ap['qlen']}) in {wall:.3f} s; launches {al}; stop-test "
            f"syncs {ap['stop_test_syncs']} + 1 readback; certified exact "
            f"{certified}/{len(qs)} (equal to the exact answer); mean "
            f"approx/exact k-th distance {ap['mean_kth_ratio']:.4f}")

    # -- 13. the index build's and the host backend's kernel timings ---------
    n_env1 = p.num_envelopes(SERIES_LEN)
    blk = max(1, core_envelope._BUILD_BLOCK_ELEMS // (n_env1 * g * p.w))
    x = coll.data[:blk]
    xc = x - x.mean(dim=-1, keepdim=True)
    sums = [(core_envelope._prefix(xc), core_envelope._prefix(xc * xc))]
    sums += [tuple(t.clone() for t in sums[0]) for _ in range(
        -(-2 * l2 // (2 * sums[0][0].numel() * 4)) - 1)]
    ekw = dict(lmin=p.lmin, lmax=p.lmax, gamma=p.gamma, seg_len=p.seg_len)
    call = [lambda c=c: envelope_znorm(*c, **ekw) for c in sums]
    plain = [lambda c=c: ref.envelope_znorm_ref(*c, **ekw) for c in sums]
    for k_, c_ in zip(call[0](), plain[0]()):
        check_equal(torch, "envelope_znorm", k_, c_)
    cells, len_pairs, seg_pairs = envelope_work(p, SERIES_LEN)
    # per cell a subtract, a divide, a min and a max; per (master,
    # length) two subtracts, two divides, a multiply, a subtract, two
    # max and a square root; per (master, segment) a subtract and a divide
    timings[("envelope_znorm",)] = timing(
        torch, call, plain,
        blk * (2 * (SERIES_LEN + 1) * 4 + 2 * n_env1 * p.w * 4),
        blk * (4 * cells + 9 * len_pairs + 2 * seg_pairs), 0.0,
        f"S={blk} n={SERIES_LEN} x{len(sums)}")
    timings[("envelope_znorm",)]["cells_per_series"] = cells
    del sums, call, plain, x, xc
    host = executor.host_envelopes(index)
    for qlen, r in DTW_CASES:
        q = (batches[0] if qlen == QLENS[0] else batches[1])[0]
        pq = planner.prepare_query(q, p, "dtw", r, device=dev)
        order, _ = planner.plan_scan_order(index, pq)
        # the windows of the host scan's first 8 chunks (512 envelopes
        # each, ~26 MB at qlen 256): a round streams more than the L2
        chunks = []
        for i in range(8):
            e = order[i * 512:(i + 1) * 512]
            chunks.append(executor.gather_windows(
                coll.data, host["series_id"][e], host["anchor"][e],
                host["n_master"][e], qlen, g)[0])
        nw = chunks[0].shape[0]
        qt = torch.from_numpy(np.stack(
            batches[0] if qlen == QLENS[0] else batches[1])).to(dev)
        qn_all = planner.prepare_query_batch(qt, p.seg_len, True)[0]
        for qb in (1, 8):
            for znorm, qs_t in ((True, qn_all[:qb]), (False, qt[:qb])):
                call = [lambda c=c: batch_ed(c, qs_t, znorm) for c in chunks]
                plain = [lambda c=c: ref.batch_ed_ref(c, qs_t, znorm)
                         for c in chunks]
                err = check_close(torch, "batch_ed", call[0](), plain[0]())
                lib = None if znorm else [
                    lambda c=c: torch.cdist(c, qs_t) ** 2 for c in chunks]
                timings[("batch_ed", qlen, qb,
                         "znorm" if znorm else "raw")] = timing(
                    torch, call, plain,
                    (nw * qlen + qb * qlen + nw * qb) * 4,
                    nw * qlen * (2 * qb + 3), err,
                    f"N={nw} qlen={qlen} Qb={qb} "
                    f"{'znorm' if znorm else 'raw'}", library=lib)
        wns = [znormalize(c) for c in chunks]
        del chunks
        call = [lambda c=c: lb_keogh(pq.dtw_lo, pq.dtw_hi, c) for c in wns]
        plain = [lambda c=c: ref.lb_keogh_ref(pq.dtw_lo, pq.dtw_hi, c)
                 for c in wns]
        err = check_close(torch, "lb_keogh", call[0](), plain[0]())
        # per point two subtracts, two max, two multiplies, two adds
        timings[("lb_keogh", qlen)] = timing(
            torch, call, plain, (nw * qlen + 2 * qlen + nw) * 4,
            8 * nw * qlen, err, f"N={nw} qlen={qlen} r={r}")
        del wns
    for key, t in timings.items():
        if key[0] in ("envelope_znorm", "batch_ed", "lb_keogh"):
            lib = (f"  library {t['library_ms']:.4f} ms"
                   if t["library_ms"] is not None else "")
            log(f"[13] {key[0]:14s} {t['shape']:30s} kernel {t['ms']:.4f} ms"
                f"  plain {t['plain_ms']:.4f} ms{lib}  bound "
                f"{t['bound_ms']:.4f} ms ({t['bound_by']}, {t['timer']}/"
                f"{t['plain_timer']}; events {t['event_ms']:.4f} / "
                f"{t['plain_event_ms']:.4f} ms)")
    results["timings"] = {" ".join(map(str, k)): v
                          for k, v in timings.items()}

    # launches: each kernel's count on the path it belongs to — the ED main
    # path, the DTW path, the index build, the host backend (ED: batch_ed;
    # DTW: lb_keogh and dtw_band)
    headline = {"fused_gather_ed": ("fused_gather_ed", 256, 512),
                "mindist_sym": ("mindist_sym", 256),
                "mindist_paa": ("mindist_paa", 256),
                # the scan's entry to the kernel (the contract entry's
                # time is in the timings as well)
                "fused_gather_lb_keogh": ("fused_gather_lb_keogh_chunk", 256,
                                          512),
                "dtw_survivors": ("dtw_survivors", 256),
                "dtw_band": ("dtw_band", 256),
                "envelope_znorm": ("envelope_znorm",),
                "batch_ed": ("batch_ed", 256, 1, "znorm"),
                "lb_keogh": ("lb_keogh", 256)}
    path_launches = dict(
        launches, fused_gather_lb_keogh=dtw_launches[
            "fused_gather_lb_keogh_chunk"],
        dtw_survivors=dtw_launches["dtw_survivors"],
        **build_launches,
        batch_ed=results["host_path"]["ed"]["launches"]["batch_ed"],
        **{name: results["host_path"]["dtw"]["launches"][name]
           for name in ("lb_keogh", "dtw_band")})
    for name, key in headline.items():
        t = timings[key]
        src, replaces = REPLACES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": path_launches[name],
            "max_abs_err": max(errs[name], t["max_abs_err"]),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
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
