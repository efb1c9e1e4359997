"""ULISSE query service launcher (the paper's native serving workload).

    python -m repro_torch.launch.serve --series 2048 --queries 60
    python -m repro_torch.launch.serve --device cpu --series 64 --queries 6
    python -m repro_torch.launch.serve --devices 4 --series 4096

Builds a collection behind one `UlisseEngine`, wraps it in the
`repro_torch.serve.UlisseServer` dynamic batcher, and drives it with a
closed-loop multi-client mixed-length workload: each client thread
submits a query, waits for its answer, submits the next.  Requests
coalesce into pow2 length buckets and dispatch as padded device batches
after --window-ms (or when a bucket fills to --batch); the serial
one-request-at-a-time loop is timed first as the baseline.  Runs on CUDA
unless --device cpu.  --devices N > 1 spawns N ranks (`launch.world`:
NCCL one card a rank when there are N cards, else gloo with every rank
on cuda:0; gloo on the host with --device cpu) serving one
`UlisseEngine.distributed`: every rank builds its shard and runs the
serial baseline, rank 0 leads the server and prints, the others follow
it (`serve.follow`).
"""
import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=0,
                    help="ranks to shard the engine over (one process "
                         "each; above 1 a distributed engine)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine (cuda or cpu)")
    ap.add_argument("--series", type=int, default=1024)
    ap.add_argument("--series-len", type=int, default=256)
    ap.add_argument("--queries", type=int, default=48)
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--batch", type=int, default=4,
                    help="max queries coalesced into one dispatch "
                         "(and scanned as one device batch)")
    ap.add_argument("--clients", type=int, default=8,
                    help="closed-loop client threads")
    ap.add_argument("--window-ms", type=float, default=2.0,
                    help="bucket hold window before a non-full "
                         "dispatch")
    args = ap.parse_args(argv)
    if args.devices > 1:
        from repro_torch.launch import world
        world.run(_serve, args, args.devices, args.device)
        return 0
    _serve(args, 0, 1, args.device, None)
    return 0


def _serve(args, rank: int, ranks: int, device: str, banner) -> None:
    """The launcher on one rank (`banner`: the world's words, None for a
    local engine on `device`)."""
    import threading

    import numpy as np

    from repro_torch.core import (Collection, EnvelopeParams, QuerySpec,
                                  UlisseEngine)
    from repro_torch.serve import ServeConfig, UlisseServer, follow
    from repro_torch.train.data import series_batches

    ns = (args.series // ranks) * ranks
    data = series_batches(ns, args.series_len, seed=11)
    p = EnvelopeParams(lmin=args.series_len // 2,
                       lmax=args.series_len, gamma=16, seg_len=16,
                       znorm=True)
    if banner is None:
        engine = UlisseEngine.from_collection(
            Collection.from_array(data, device=device), p,
            max_batch=args.batch, device=device)
        backend = f"local pipeline on {engine.device}"
    else:
        engine = UlisseEngine.distributed(None, p, data,
                                          max_batch=args.batch,
                                          device=device)
        backend = f"sharded scan, {banner}"
    spec = QuerySpec(k=args.k)
    lengths = sorted({p.lmin, (p.lmin + p.lmax) // 2 // 16 * 16, p.lmax})
    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"serving {ns} series x {args.series_len} ({backend}); query "
        f"lengths {lengths}", flush=True)

    rng = np.random.default_rng(1)

    def make_query(i):
        qlen = lengths[i % len(lengths)]
        s = rng.integers(0, ns)
        o = rng.integers(0, args.series_len - qlen + 1)
        return (data[s, o:o + qlen]
                + rng.normal(size=qlen).astype(np.float32) * .02)

    queries = [make_query(i) for i in range(args.queries)]

    # baseline: the serial one-request-at-a-time loop (every rank)
    engine.warmup(lengths, [1], spec)
    t0 = time.perf_counter()
    for q in queries:
        engine.search(q, spec)
    dt_serial = time.perf_counter() - t0
    say(f"serial baseline: {len(queries) / dt_serial:.1f} qps "
        f"({dt_serial / len(queries) * 1e3:.1f} ms/query)", flush=True)
    if rank != 0:
        follow(engine)             # replay rank 0's dispatches
        return

    # the serving loop: closed-loop clients against the dynamic batcher
    server = UlisseServer(engine, spec,
                          ServeConfig(window_ms=args.window_ms,
                                      max_batch=args.batch))
    server.warmup(lengths)
    server.metrics.reset()
    results = [None] * len(queries)

    def client(cid):
        for i in range(cid, len(queries), args.clients):
            results[i] = server.search(queries[i], timeout=300)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(args.clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    dt = time.perf_counter() - t0
    server.close()

    m = server.metrics.snapshot()
    if m["total"]["completed"] != len(queries):
        raise RuntimeError(f"served {m['total']['completed']} of "
                           f"{len(queries)} queries: {m['total']}")
    print(f"served {m['total']['completed']} queries from "
          f"{args.clients} clients: {len(queries) / dt:.1f} qps "
          f"({dt_serial / dt:.2f}x serial)")
    for bucket, bm in m["buckets"].items():
        print(f"  bucket {bucket}: qps={bm['qps']} "
              f"dispatches={bm['dispatches']} "
              f"mean_fill={bm['mean_fill']} fill={bm['fill_hist']} "
              f"wait_p50={bm['queue_wait_ms']['p50']}ms "
              f"latency p50/p95/p99="
              f"{bm['latency_ms']['p50']}/{bm['latency_ms']['p95']}/"
              f"{bm['latency_ms']['p99']}ms")
    first = results[0]
    print(f"sample answer: nn=({first.series[0]},{first.offsets[0]}) "
          f"d={first.dists[0]:.4f} "
          f"pruning={first.stats.pruning_power:.3f}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
