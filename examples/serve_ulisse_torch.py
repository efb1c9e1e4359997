"""A distributed ULISSE engine behind the dynamic-batching server, on
the PyTorch port: `--devices N` ranks (`repro_torch.launch.world`: NCCL
one card a rank where there are N cards, else gloo with every rank on
cuda:0; gloo on the host with --device cpu) each hold a shard of one
`UlisseEngine.distributed`; rank 0 runs `UlisseServer` for client
threads sending mixed-length queries, the other ranks follow it
(`serve.follow`).  Every served answer is checked against the exhaustive
oracle (`repro_torch.core.search.brute_force_knn`); a mismatch fails the
run (exit status 1).

    python examples/serve_ulisse_torch.py                      # on the card
    python examples/serve_ulisse_torch.py --devices 4 --device cpu \\
        --series 64 --queries 12

Run from the repository root with `src` on PYTHONPATH.
"""
import argparse
import sys
import threading

import numpy as np

from repro_torch.launch import world

SERIES_LEN = 256


def _rank(args, rank: int, ranks: int, device: str, banner: str) -> None:
    from repro_torch.core import (Collection, EnvelopeParams, QuerySpec,
                                  UlisseEngine)
    from repro_torch.core.search import brute_force_knn
    from repro_torch.serve import ServeConfig, UlisseServer, follow
    from repro_torch.train.data import series_batches

    ns = max(ranks, args.series // ranks * ranks)
    data = series_batches(ns, SERIES_LEN, seed=11)
    p = EnvelopeParams(lmin=SERIES_LEN // 2, lmax=SERIES_LEN, gamma=16,
                       seg_len=16, znorm=True)
    engine = UlisseEngine.distributed(None, p, data, max_batch=4,
                                      device=device)
    if rank != 0:
        follow(engine)                 # replay rank 0's engine ops
        return
    spec = QuerySpec(k=3)
    lengths = [128, 192, 256]
    rng = np.random.default_rng(1)
    queries = []
    for i in range(args.queries):
        qlen = lengths[i % 3]
        s, o = int(rng.integers(0, ns)), int(rng.integers(0, SERIES_LEN - qlen + 1))
        queries.append(data[s, o:o + qlen]
                       + rng.normal(size=qlen).astype(np.float32) * 0.02)
    server = UlisseServer(engine, spec, ServeConfig(window_ms=5, max_batch=4))
    server.warmup(lengths)
    answers = [None] * len(queries)

    def client(c):
        for i in range(c, len(queries), 3):
            answers[i] = server.search(queries[i], timeout=300)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    server.close()
    total = server.metrics.snapshot()["total"]
    print(f"served {total['completed']} queries over {banner} "
          f"({ns} series, mean fill {total['mean_fill']})", flush=True)
    coll = Collection.from_array(data, device=device)
    for i, (q, a) in enumerate(zip(queries, answers)):
        want = brute_force_knn(coll, q, 3, znorm=True)
        # squared, as the oracle's float32 dot identity errs (~1e-3 in d^2)
        if a is None or not np.allclose(a.dists ** 2, want.dists ** 2,
                                        rtol=1e-3, atol=5e-3):
            raise SystemExit(f"MISMATCH at query {i}: "
                             f"{None if a is None else a.dists} vs oracle "
                             f"{want.dists}")
    print("serve OK: every served answer matched the brute force",
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=1,
                    help="ranks sharing the engine (one process each)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--series", type=int, default=2048)
    ap.add_argument("--queries", type=int, default=24)
    args = ap.parse_args(argv)
    try:
        world.run(_rank, args, args.devices, args.device)
    except Exception as e:  # noqa: BLE001 — a rank failed: report, exit 1
        print(f"FAILED: {e}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
