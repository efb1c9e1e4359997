"""ULISSE at the data-pipeline layer, on the PyTorch port:
subsequence-similarity dedup of an incoming shard of series against
everything already accepted (the index screens each incoming series by
its nearest z-normalized subsequence).  Each decision is checked against
the exhaustive oracle (`repro_torch.core.search.brute_force_knn`); a
mismatch exits with status 1.

    python examples/dedup_pipeline_torch.py                  # on the card
    python examples/dedup_pipeline_torch.py --device cpu --series 60

Run from the repository root with `src` on PYTHONPATH.
"""
import argparse
import sys

import numpy as np

from repro_torch.core import Collection, EnvelopeParams, QuerySpec, UlisseEngine
from repro_torch.core.search import brute_force_knn
from repro_torch.train.data import series_batches

THRESHOLD = 1.0      # z-normalized distance of a near-duplicate


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--series", type=int, default=300,
                    help="series already accepted (the incoming shard has "
                         "a third as many fresh ones and a fifth as many "
                         "planted near-duplicates)")
    args = ap.parse_args(argv)
    dev = args.device
    n = args.series
    rng = np.random.default_rng(5)
    base = series_batches(n, 256, seed=7)
    planted = max(1, n // 5)
    dupes = base[rng.integers(0, n, size=planted)].copy()
    dupes += rng.normal(size=dupes.shape).astype(np.float32) * 0.02
    incoming = np.concatenate([series_batches(max(1, n // 3), 256, seed=8),
                               dupes])
    rng.shuffle(incoming)

    p = EnvelopeParams(lmin=192, lmax=256, gamma=32, seg_len=16, znorm=True)
    coll = Collection.from_array(base, device=dev)
    engine = UlisseEngine.from_collection(coll, p, device=dev)

    kept, dropped = [], 0
    for i, row in enumerate(incoming):
        probe = row[:224]              # a variable-length probe, one index
        r = engine.search(probe, QuerySpec(k=1))
        oracle = brute_force_knn(coll, probe, 1, znorm=True)
        # squared, as the oracle's float32 dot identity errs (~1e-3 in d^2)
        if not np.allclose(r.dists ** 2, oracle.dists ** 2, rtol=1e-3,
                           atol=5e-3):
            print(f"MISMATCH at incoming {i}: {r.dists} vs oracle "
                  f"{oracle.dists}")
            return 1
        if r.dists[0] < THRESHOLD:
            dropped += 1
        else:
            kept.append(row)
    print(f"incoming {len(incoming)} series -> kept {len(kept)}, dropped "
          f"{dropped} near-duplicates ({planted} planted) on "
          f"{engine.device}")
    if not planted * 0.8 <= dropped <= planted * 1.2 + 1:
        print(f"MISMATCH: caught {dropped} of {planted} planted duplicates")
        return 1
    print("dedup OK: every decision matched the brute force")
    return 0


if __name__ == "__main__":
    sys.exit(main())
