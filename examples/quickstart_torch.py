"""Quickstart for the PyTorch port: build a ULISSE index once, save it,
open it cold, and answer every query shape through one call,
`engine.search(q, QuerySpec(...))` — ED or DTW, k-NN or eps-range,
exact or approximate — then append series live.  Every answer is
checked against the exhaustive oracle (`repro_torch.core.search`); a
mismatch exits with status 1.

    python examples/quickstart_torch.py                 # on the card
    python examples/quickstart_torch.py --device cpu --series 60

Run from the repository root with `src` on PYTHONPATH (or the package
installed).
"""
import argparse
import os
import sys
import tempfile

import numpy as np

from repro_torch.core import Collection, EnvelopeParams, QuerySpec, UlisseEngine
from repro_torch.core.search import brute_force_knn, brute_force_range
from repro_torch.train.data import series_batches

SERIES_LEN = 256


def check(ok: bool, what: str) -> None:
    if not ok:
        print(f"MISMATCH: {what}", flush=True)
        sys.exit(1)


def same_knn(got, want, what: str) -> None:
    """Distances as the oracle's: squared, within 1e-3 relative and 5e-3
    absolute (the oracle's float32 dot identity errs by ~1e-3 in d^2
    near a match; the engine rescores in float64)."""
    check(len(got.dists) == len(want.dists)
          and np.allclose(got.dists ** 2, want.dists ** 2, rtol=1e-3,
                          atol=5e-3),
          f"{what}: {np.round(got.dists, 4)} vs oracle "
          f"{np.round(want.dists, 4)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--series", type=int, default=500)
    ap.add_argument("--dir", default=None,
                    help="where the index is saved (default: a temporary "
                         "directory)")
    args = ap.parse_args(argv)
    dev = args.device
    p = EnvelopeParams(lmin=160, lmax=SERIES_LEN, gamma=32, seg_len=16,
                       znorm=True)
    data = series_batches(args.series, SERIES_LEN, seed=0)
    coll = Collection.from_array(data, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(args.dir or tmp, "ulisse_quickstart_index")
        # 1. build once and save; a later process opens it cold (the
        #    envelopes read, the raw series mmap'd until the first search)
        built = UlisseEngine.from_collection(coll, p, device=dev)
        built.save(path)
        engine = UlisseEngine.open(path, params=p, device=dev)
        print(f"built, saved and reopened {args.series} series x "
              f"{SERIES_LEN} at {path} on {engine.device}")

        rng = np.random.default_rng(1)
        # 2. exact ED k-NN at three lengths from one index
        for qlen in (160, 192, 256):
            src = int(rng.integers(0, args.series))
            off = int(rng.integers(0, SERIES_LEN - qlen + 1))
            q = data[src, off:off + qlen] \
                + rng.normal(size=qlen).astype(np.float32) * 0.05
            r = engine.search(q, QuerySpec(k=3))
            same_knn(r, brute_force_knn(coll, q, 3, znorm=True),
                     f"ED k-NN at |Q|={qlen}")
            st = r.stats
            print(f"|Q|={qlen}: top-3 {np.round(r.dists, 3)} (planted at "
                  f"series {src} offset {off}; found {r.series[0]} "
                  f"{r.offsets[0]}); pruned {st.pruning_power:.0%} of "
                  f"{st.envelopes_total} envelopes")

        # 3. DTW (r = 10% of |Q|), an eps-range and an approximate pass
        q = data[7 % args.series, 30:222] \
            + rng.normal(size=192).astype(np.float32) * 0.05
        rd = engine.search(q, QuerySpec(k=2, measure="dtw", r=19))
        same_knn(rd, brute_force_knn(coll, q, 2, znorm=True, measure="dtw",
                                     r=19), "DTW k-NN")
        print(f"DTW top-2: {np.round(rd.dists, 3)} (LB_Keogh -> full DP: "
              f"{rd.stats.dtw_lb_keogh} -> {rd.stats.dtw_full})")
        exact = engine.search(q, QuerySpec(k=3))
        eps = float(exact.dists[-1]) * 1.5
        rr = engine.search(q, QuerySpec(eps=eps))
        want = brute_force_range(coll, q, eps, znorm=True)
        got = set(zip(rr.series.tolist(), rr.offsets.tolist()))
        sure = {(s, o) for s, o, d in zip(want.series.tolist(),
                                          want.offsets.tolist(), want.dists)
                if d * d <= eps * eps - 5e-3}
        check(sure <= got and len(got) <= len(want.dists) + 8,
              f"eps-range: {len(got)} hits against the oracle's "
              f"{len(want.dists)}")
        print(f"eps-range (eps={eps:.3f}): {len(rr.dists)} hits")
        ra = engine.search(q, QuerySpec(k=3, mode="approx"))
        check(len(ra.dists) == 3
              and np.all(ra.dists >= exact.dists - 1e-3),
              "approximate k-NN below the exact one")
        print(f"approx top-3: {np.round(ra.dists, 3)} after "
              f"{ra.stats.leaves_visited} leaf visits")

        # 4. live ingestion: appended series are searchable at once, and
        #    compact folds them into the sorted index
        new = series_batches(8, SERIES_LEN, seed=42)
        engine.append(new)
        grown = Collection.from_array(np.concatenate([data, new]),
                                      device=dev)
        qn = new[3, 40:232] + rng.normal(size=192).astype(np.float32) * 0.05
        rn = engine.search(qn, QuerySpec(k=1))
        same_knn(rn, brute_force_knn(grown, qn, 1, znorm=True),
                 "k-NN after the append")
        check(int(rn.series[0]) == args.series + 3,
              f"the planted appended series not found: {rn.series[0]}")
        engine.compact()
        rc = engine.search(qn, QuerySpec(k=1))
        check(int(rc.series[0]) == args.series + 3 and engine.delta_size == 0,
              "compact changed the answer")
        print(f"appended 8 series: found series {rn.series[0]} "
              f"(>= {args.series}: in the appended batch); compacted")
    print("quickstart OK: every answer matched the brute force")
    return 0


if __name__ == "__main__":
    sys.exit(main())
