"""Time the long-query ED path's kernels and the index build on the card,
for A/B calls.

Times the long-row ED chunk entries (k-NN and range) and the two mindist
entries at chip_smoke.py's shapes: [15] (B = 8, 128 rows of a 32 x
32,768 random-walk index, qlen 29,000, g 49; mindist over its 8,448
envelopes and 528 block unions at 1,812 segments), [21] (the k-NN entry
at g 20,480 over 1,024 x 40,960 random walks, qlen 256, 8 rows) and [6]
(mindist at nseg 16 and 10 over 31,296 block unions and 2,002,944
envelopes, the symbol entry and the PAA one, as `use_paa_bounds` runs
it).  Inputs are made from --seed; every time is CUDA events over
--reps launches after a warm-up, queued behind a spin of the card (so
they time the kernels back to back, not the host's launches), cycling
over copies of the inputs that exceed twice the L2 where one call reads
less.  Each record carries a
digest of the kernel's output (a float64 sum of its finite values and a
count of the rest), so two trees' runs can be compared for equal
results.

`--envelope` times the index build (`envelope_znorm` over the prefix sums
the build itself makes, `centered_prefixes`) instead: [13]'s blocks of
[3]'s random walks (21,399 and 198,988 series x 256, 16 segments), [14]
(128 x 1,024, lmin 512, lmax 1,024, seg_len 32: 32 segments), [15] (32 x
32,768, lmin 20,000, lmax 30,000, seg_len 16: 1,875 segments; chip_smoke
[15]'s series) and [21] (1,024 x 40,960 at gamma 20,479), each with the
float64 digest and a sha256 of its (lo, hi) bytes, so that two trees'
envelopes can be held equal bit for bit.

It imports `repro_torch` from the path, so one call can time a parent
tree and this one in turns:

    PYTHONPATH=_archive/parent/src python3 chip_kernels.py --out p1.json
    PYTHONPATH=src python3 chip_kernels.py --out c1.json

On a tree whose wrappers take forced plans (`plan=` on mindist and the
build, `otile=` / `block=` on the long ED entries) it also times the
alternatives the plan functions chose among (`--alternatives`).
`--check-mindist` holds both mindist entries against their plain
versions bit for bit
(torch.equal) at nseg 16, 1,812 and 6,000 and B 1, 4 and 8, and prints
every case that differs.  Needs a CUDA device; exits 1 without one.
"""
from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

L2_BYTES = 50 * 2 ** 20
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def events_ms(torch, calls, reps: int) -> float:
    """Mean ms a call over `reps` calls cycling through `calls`, by CUDA
    events, after one warm-up round.  The events are enqueued behind a
    spin of the card as long as the loop's host time, so that they time
    the queued launches back to back, not the card waiting for the host
    (a call shorter than its wrapper's host work)."""
    import time
    t0 = time.perf_counter()
    for c in calls:
        c()
    torch.cuda.synchronize()
    per_call = (time.perf_counter() - t0) / len(calls)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2 * per_call * reps, 1.0) * 2e9))
    e0.record()
    for i in range(reps):
        calls[i % len(calls)]()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def digest(torch, t) -> list:
    t = t.double() if t.is_floating_point() else t.long()
    fin = torch.isfinite(t) if t.is_floating_point() else torch.ones_like(
        t, dtype=torch.bool)
    return [float(t[fin].sum()), int((~fin).sum())]


def copies(ins, nbytes: int) -> list:
    """The inputs and enough clones that a round streams 2 L2 sizes."""
    n = max(1, -(-2 * L2_BYTES // max(nbytes, 1)))
    return [ins] + [tuple(x.clone() for x in ins) for _ in range(n - 1)]


def long_ed(torch, dev, rng, rec, reps, alternatives):
    from repro_torch.core import Collection
    from repro_torch.core.planner import prepare_query_batch
    from repro_torch.kernels import fused_verify as fv
    b, rows, g, qlen, n_series, n = 8, 128, 49, 29_000, 32, 32_768
    data = np.cumsum(rng.normal(size=(n_series, n)), -1).astype(np.float32)
    coll = Collection.from_array(data, device=dev)
    a0 = (coll.data, coll.csum, coll.csum2, coll.csum_lo, coll.csum2_lo,
          coll.center)
    n_pad = 4 * rows
    sids = torch.from_numpy(rng.integers(0, n_series, (b, n_pad)).astype(
        np.int32)).to(dev)
    anc = torch.from_numpy(rng.integers(0, n - qlen - g + 1, (b, n_pad))
                           .astype(np.int32)).to(dev)
    src = rng.integers(0, n_series, b)
    off = rng.integers(0, n - qlen, b)
    q = np.stack([data[s, o:o + qlen] for s, o in zip(src, off)])
    q = q + rng.normal(size=q.shape).astype(np.float32) * 0.1
    qn = prepare_query_batch(torch.from_numpy(q).to(dev), 16, True)[0]
    plan = (sids, anc, torch.full_like(sids, g),
            torch.zeros((b, n_pad), device=dev))
    st = torch.zeros((b, 6), dtype=torch.int32, device=dev)
    ops = 2 * b * rows * g * qlen
    bound = ops / PEAK_F32 * 1e3
    has_block = "block" in inspect.signature(
        fv.fused_gather_ed_long).parameters
    shapes = [None]
    if has_block and alternatives:
        shapes += [(None, (t, p)) for t in (1, 2, 4, 8)
                   for p in (512, 1_024, 2_048, 4_096)
                   if fv._ed_smem(t, g, p) <= 227 * 1024]
    for shape in shapes:
        kw = {} if shape is None else dict(otile=shape[0], block=shape[1])
        tag = "" if shape is None else f" block={shape[1]}"
        for name, cut, fn in (
                ("long k-NN +inf pool", torch.full((b, 5), float("inf"),
                                                   device=dev),
                 fv.fused_gather_ed_chunk_long),
                ("long k-NN pool 1e-30", torch.full((b, 5), 1e-30,
                                                    device=dev),
                 fv.fused_gather_ed_chunk_long),
                ("long range", None, fv.fused_gather_ed_range_long)):
            if fn is fv.fused_gather_ed_range_long:
                eps2 = torch.full((b,), 1e30, device=dev)
                ovf = torch.full((b,), 4, dtype=torch.int32, device=dev)
                calls = [lambda i=i: fn(*a0, *plan, qn, eps2, ovf, st, i=i,
                                        chunk=rows, g=g, znorm=True, **kw)
                         for i in range(4)]
            else:
                calls = [lambda i=i, c=cut: fn(*a0, *plan, qn, c, st, i=i,
                                               chunk=rows, g=g, znorm=True,
                                               **kw) for i in range(4)]
            if shape is not None and name != "long range":
                if cut[0, 0] < 1:          # one k-NN variant is enough
                    continue
            ms = events_ms(torch, calls, reps)
            out = calls[0]()
            torch.cuda.synchronize()
            rec[f"[15] {name}{tag}"] = dict(
                ms=ms, bound_ms=bound, shape=f"B={b} rows={rows} qlen="
                f"{qlen} g={g}", digest=digest(torch, out[0] if
                                               out.dim() == 3 else out))
    d2 = fv.fused_gather_ed_long(*a0, sids[:, :rows].reshape(-1).contiguous(),
                                 anc[:, :rows].reshape(-1).contiguous(), qn,
                                 g=g, rows=rows, znorm=True)
    rec["[15] long contract d2"] = dict(digest=digest(torch, d2))
    del coll, a0, data


def large_g(torch, dev, rng, rec, reps, alternatives):
    from repro_torch.core import Collection
    from repro_torch.core.planner import prepare_query_batch
    from repro_torch.kernels import fused_verify as fv
    b, rows, g, qlen, n_series, n = 8, 8, 20_480, 256, 1_024, 40_960
    data = np.cumsum(rng.normal(size=(n_series, n)), -1).astype(np.float32)
    coll = Collection.from_array(data, device=dev)
    a0 = (coll.data, coll.csum, coll.csum2, coll.csum_lo, coll.csum2_lo,
          coll.center)
    n_pad = 2 * rows
    sids = torch.from_numpy(rng.integers(0, n_series, (b, n_pad)).astype(
        np.int32)).to(dev)
    anc = torch.from_numpy((rng.integers(0, (n - qlen - g) // g + 1,
                                         (b, n_pad)) * g).astype(np.int32)
                           ).to(dev)
    src = rng.integers(0, n_series, b)
    off = rng.integers(0, n - qlen, b)
    q = np.stack([data[s, o:o + qlen] for s, o in zip(src, off)])
    q = q + rng.normal(size=q.shape).astype(np.float32) * 0.1
    qn = prepare_query_batch(torch.from_numpy(q).to(dev), 16, True)[0]
    d2 = fv.fused_gather_ed(*a0, sids[:, :rows].reshape(-1).contiguous(),
                            anc[:, :rows].reshape(-1).contiguous(), qn, g=g,
                            rows=rows, znorm=True).reshape(b, -1)
    pool = d2.sort(dim=1).values[:, :5].contiguous()
    plan = (sids, anc, torch.full_like(sids, g),
            torch.zeros((b, n_pad), device=dev))
    st = torch.zeros((b, 6), dtype=torch.int32, device=dev)
    ops = 2 * b * rows * g * qlen
    shapes = [None]
    if "block" in inspect.signature(
            fv.fused_gather_ed_long).parameters and alternatives:
        shapes += [(512, None), (2_048, None)]
    for shape in shapes:
        kw = {} if shape is None else dict(otile=shape[0])
        tag = "" if shape is None else f" otile={shape[0]}"
        try:
            calls = [lambda i=i: fv.fused_gather_ed_chunk_long(
                *a0, *plan, qn, pool, st, i=i, chunk=rows, g=g, znorm=True,
                **kw) for i in range(2)]
            ms = events_ms(torch, calls, reps)
        except (ValueError, RuntimeError) as e:
            rec[f"[21] k-NN{tag}"] = dict(refused=str(e))
            continue
        rec[f"[21] k-NN{tag}"] = dict(
            ms=ms, bound_ms=ops / PEAK_F32 * 1e3,
            shape=f"B={b} rows={rows} qlen={qlen} g={g}",
            digest=digest(torch, calls[0]()[0]))
    del coll, a0, data


def mindist_inputs(torch, dev, rng, n, w, b):
    lo = rng.normal(size=(n, w)).astype(np.float32)
    hi = lo + np.abs(rng.normal(size=(n, w))).astype(np.float32)
    lo[0, :5], hi[0, :5] = -np.inf, np.inf
    bp = np.sort(rng.normal(size=255)).astype(np.float32)
    sym_lo = np.searchsorted(bp, lo, side="right").astype(np.int32)
    sym_hi = np.searchsorted(bp, hi, side="right").astype(np.int32)
    valid = rng.random(n) > 0.1
    valid[1] = False
    q = rng.normal(size=(b, w)).astype(np.float32)
    t = lambda x: torch.from_numpy(x).to(dev)   # noqa: E731
    return (t(q), t(q + rng.random((b, w)).astype(np.float32)), t(sym_lo),
            t(sym_hi), t(bp), t(lo), t(hi), t(valid))


def mindist_times(torch, dev, rng, rec, reps, alternatives):
    from repro_torch.kernels import mindist as md
    has_plan = "plan" in inspect.signature(md.mindist_paa).parameters
    b = 8
    for tag, n, w, nseg, which in (
            ("[6] blocks", 31_296, 16, 16, ("paa",)),
            ("[6] blocks", 31_296, 16, 10, ("paa",)),
            ("[6] envelopes", 2_002_944, 16, 16, ("sym", "paa")),
            ("[6] envelopes", 2_002_944, 16, 10, ("sym", "paa")),
            ("[15] envelopes", 8_448, 1_875, 1_812, ("sym",)),
            ("[15] blocks", 528, 1_875, 1_812, ("paa",))):
        ql, qh, sl, sh, bpt, lo, hi, v = mindist_inputs(torch, dev, rng, n,
                                                        w, b)
        for kind in which:
            ins = (sl, sh, v) if kind == "sym" else (lo, hi, v)
            nbytes = sum(x.numel() * x.element_size() for x in ins)
            sets = copies(ins, nbytes)
            plans = [None]
            if has_plan and alternatives:
                sms = torch.cuda.get_device_properties(
                    dev).multi_processor_count
                own = md.mindist_plan(kind == "sym", b, n, w, nseg, sms)
                alt = [(0, qb, te, st) for qb in (1, 2, 4)
                       for te in (1, 4, 16, 64) if te * 8 // qb <= 256
                       for st in (32, 64)
                       if md._tile_smem(te, st, 8, nseg) <= 200 * 1024]
                if w % 4 == 0 and nseg <= 16:
                    alt.append((1, 0, 0, 0))
                plans += [p for p in dict.fromkeys(alt) if p != own]
            for plan in plans:
                kw = {} if plan is None else {"plan": plan}
                if kind == "sym":
                    calls = [lambda c=c: md.mindist_sym(
                        ql, qh, c[0], c[1], bpt, c[2], 16, nseg, **kw)
                        for c in sets]
                else:
                    calls = [lambda c=c: md.mindist_paa(
                        ql, qh, c[0], c[1], c[2], 16, nseg, **kw)
                        for c in sets]
                ms = events_ms(torch, calls, max(reps, len(calls)))
                nb = (2 * n * nseg * 4 + n + b * n * 4 + 2 * b * nseg * 4)
                rec[f"{tag} mindist_{kind} N={n} nseg={nseg}"
                    + ("" if plan is None else f" plan={plan}")] = dict(
                    ms=ms, bound_ms=nb / PEAK_BYTES * 1e3,
                    digest=digest(torch, calls[0]()))
        del ql, qh, sl, sh, bpt, lo, hi, v, sets


# the builds --envelope times: tag, series, points, (lmin, lmax, gamma,
# seg_len), the data's seed offset (6: chip_smoke [15]'s series), reps
# ([15], the longest, last: its heat does not reach the others)
ENVELOPE_SHAPES = (
    ("[13] build block", 21_399, 256, (160, 256, 48, 16), 13, 20),
    ("[13] 1M build block", 198_988, 256, (160, 256, 48, 16), 13, 10),
    ("[14]", 128, 1_024, (512, 1_024, 48, 32), 14, 20),
    ("[21]", 1_024, 40_960, (128, 256, 20_479, 16), 21, 10),
    ("[15]", 32, 32_768, (20_000, 30_000, 48, 16), 6, 2))
# forced plans --alternatives times beside the build's own, by segments
# (kind, lengths a tile, warps a block; (0, 0, 4) the one-pass kernel,
# past 16 segments in passes of 16)
ENVELOPE_ALTERNATIVES = {
    16: ((1, 96, 4), (1, 96, 2)),
    32: ((1, 288, 2), (1, 512, 2), (1, 544, 4)),
    1_875: ((0, 0, 4), (1, 512, 8), (1, 256, 4), (1, 256, 1), (1, 512, 2))}


def envelope_times(torch, dev, seed, rec, reps, alternatives, shapes=None):
    """The index build at the paths' shapes (the tags in `shapes`, else
    all): ms a launch (CUDA events), its operations bound, the float64
    digest and a sha256 of (lo, hi); with `alternatives` also
    ENVELOPE_ALTERNATIVES' plans at the shape's w."""
    from repro_torch.core.envelope import centered_prefixes
    from repro_torch.kernels import envelope as ev
    has_plan = "plan" in inspect.signature(ev.envelope_znorm).parameters
    for tag, s, n, (lmin, lmax, gamma, seg), off, n_reps in ENVELOPE_SHAPES:
        if shapes and tag not in shapes:
            continue
        rng = np.random.default_rng(seed + off)
        data = np.cumsum(rng.normal(size=(s, n)), -1).astype(np.float32)
        sums = centered_prefixes(torch.from_numpy(data).to(dev))
        del data
        kw = dict(lmin=lmin, lmax=lmax, gamma=gamma, seg_len=seg)
        w, g = lmax // seg, gamma + 1
        # chip_smoke's operations bound: 4 a valid (master, l', segment)
        # cell, 9 a valid (master, l'), 2 a (master, segment) with a cell
        off_ = np.arange(-(-(n - lmin + 1) // g) * g)
        off_ = off_[off_ + lmin <= n]
        longest = np.minimum(lmax, n - off_)[:, None]
        first = np.maximum(lmin, (np.arange(w) + 1) * seg)[None, :]
        per = np.maximum(longest - first + 1, 0)
        ops = (4 * int(per.sum()) + 9 * int((longest - lmin + 1).sum())
               + 2 * int((per > 0).sum()))
        bound = s * ops / PEAK_F32 * 1e3
        plans = [None]
        if has_plan and alternatives:
            plans += list(ENVELOPE_ALTERNATIVES.get(w, ()))
        for plan in plans:
            kw_p = {} if plan is None else {"plan": plan}
            call = [lambda: ev.envelope_znorm(*sums, **kw, **kw_p)]
            ms = events_ms(torch, call, min(reps, n_reps))
            lo, hi = call[0]()
            torch.cuda.synchronize()
            h = hashlib.sha256(lo.cpu().numpy().tobytes())
            h.update(hi.cpu().numpy().tobytes())
            own = (ev.envelope_plan(n, lmin, lmax, gamma, seg)
                   if has_plan and plan is None else plan)
            rec[f"{tag} envelope_znorm" + ("" if plan is None else
                                           f" plan={plan}")] = dict(
                ms=ms, bound_ms=bound, plan=own,
                shape=f"S={s} n={n} lmin={lmin} lmax={lmax} g={g} w={w}",
                digest=digest(torch, lo) + digest(torch, hi),
                sha256=h.hexdigest()[:16])
            del lo, hi
        del sums
        torch.cuda.empty_cache()


def check_mindist(torch, dev) -> list:
    """Every (entry, B, nseg) where the kernel differs from its plain
    version by a bit."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.mindist import mindist_paa, mindist_sym
    differ = []
    for nseg in (16, 1_812, 6_000):
        for b in (1, 4, 8):
            rng = np.random.default_rng(b * 7 + nseg)
            ql, qh, sl, sh, bpt, lo, hi, v = mindist_inputs(
                torch, dev, rng, 3_001, nseg, b)
            for name, got, want in (
                    ("mindist_sym",
                     mindist_sym(ql, qh, sl, sh, bpt, v, 16, nseg),
                     ref.mindist_sym_ref(ql, qh, sl, sh, bpt, v, 16, nseg)),
                    ("mindist_paa", mindist_paa(ql, qh, lo, hi, v, 16, nseg),
                     ref.mindist_ref(ql, qh, lo, hi, v, 16, nseg))):
                if not torch.equal(got, want):
                    d = (got - want).abs().nan_to_num()
                    differ.append(dict(entry=name, b=b, nseg=nseg,
                                       n_diff=int((got != want).sum()),
                                       max_abs=float(d.max())))
    return differ


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--alternatives", action="store_true")
    ap.add_argument("--check-mindist", action="store_true")
    ap.add_argument("--only", default="ed,large_g,mindist")
    ap.add_argument("--envelope", action="store_true",
                    help="time the index build alone (--only envelope)")
    ap.add_argument("--shapes", default="",
                    help="with --envelope: the tags to time, "
                    "'[14],[15]'")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_kernels.py: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    import repro_torch
    rec = {"card": card_line(), "tree": str(Path(
        repro_torch.__file__).resolve().parents[2])}
    print(rec["card"], flush=True)
    only = {"envelope"} if args.envelope else set(args.only.split(","))
    if args.check_mindist:
        rec["mindist_differs"] = check_mindist(torch, dev)
        print("mindist cases off their plain versions by a bit: "
              + json.dumps(rec["mindist_differs"]), flush=True)
    for name, fn in (("ed", long_ed), ("large_g", large_g),
                     ("mindist", mindist_times)):
        if name in only:
            fn(torch, dev, np.random.default_rng(args.seed), rec, args.reps,
               args.alternatives)
            torch.cuda.empty_cache()
    if "envelope" in only:
        envelope_times(torch, dev, args.seed, rec, args.reps,
                       args.alternatives,
                       [t for t in args.shapes.split(",") if t])
    for key, r in rec.items():
        if isinstance(r, dict) and "ms" in r:
            print(f"{key:70s} {r['ms']:.4f} ms (bound {r['bound_ms']:.4f})"
                  f" digest {r['digest']}"
                  + (f" sha256 {r['sha256']} plan {r['plan']}"
                     if "sha256" in r else ""), flush=True)
        elif isinstance(r, dict) and "refused" in r:
            print(f"{key:70s} refused: {r['refused']}", flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
