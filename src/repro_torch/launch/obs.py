"""Observability demo: trace a mixed workload end-to-end and dump the
artifacts a dashboard would scrape.

    python -m repro_torch.launch.obs --out obs_artifacts
    python -m repro_torch.launch.obs --device cpu --series 32 --out /tmp/o
    python -m repro_torch.launch.obs --devices 4 --out obs_artifacts

Runs kNN + eps-range + approximate queries two ways — directly against
the `UlisseEngine` (stats recorded by hand via
`obs.record_search_stats`) and through the `UlisseServer` dynamic
batcher (spans + stats recorded by the serving tier itself) — with the
process tracer enabled, then writes three artifacts into --out:

    trace.json     Chrome trace_event JSON (Perfetto / chrome://tracing)
    metrics.prom   Prometheus text exposition of the full registry
    metrics.json   the same registry as a JSON snapshot

Runs on CUDA unless --device cpu.  --devices N > 1 spawns N ranks
(`launch.world`, as `launch.serve` does) over one
`UlisseEngine.distributed`: every rank runs the direct queries, rank 0
leads the server (the others follow it), traces, prints and writes the
artifacts.
"""
import argparse
import json
import os
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=0,
                    help="ranks to shard the engine over (one process "
                         "each; above 1 a distributed engine)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine (cuda or cpu)")
    ap.add_argument("--series", type=int, default=128)
    ap.add_argument("--series-len", type=int, default=256)
    ap.add_argument("--queries", type=int, default=12)
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--out", default="obs_artifacts")
    ap.add_argument("--sample-every", type=int, default=1,
                    help="trace every N-th root span (1 = all)")
    ap.add_argument("--torch-annotations", action="store_true",
                    help="also enter torch.profiler.record_function "
                         "ranges so spans align with torch profiles")
    args = ap.parse_args(argv)
    if args.devices > 1:
        from repro_torch.launch import world
        world.run(_trace, args, args.devices, args.device)
        return 0
    _trace(args, 0, 1, args.device, None)
    return 0


def _trace(args, rank: int, ranks: int, device: str, banner) -> None:
    """The demo on one rank (`banner`: the world's words, None for a
    local engine on `device`)."""
    import numpy as np

    from repro_torch import obs
    from repro_torch.core import (Collection, EnvelopeParams, QuerySpec,
                                  UlisseEngine)
    from repro_torch.serve import ServeConfig, UlisseServer, follow
    from repro_torch.train.data import series_batches

    tracer = obs.get_tracer().configure(
        enabled=rank == 0, sample_every=args.sample_every,
        torch_annotations=args.torch_annotations)

    ns = max(args.series // ranks, 1) * ranks
    data = series_batches(ns, args.series_len, seed=7)
    p = EnvelopeParams(lmin=args.series_len // 2, lmax=args.series_len,
                       gamma=16, seg_len=16, znorm=True)
    if banner is None:
        engine = UlisseEngine.from_collection(
            Collection.from_array(data, device=device), p, max_batch=4,
            device=device)
        backend = f"the local pipeline ({engine.device})"
    else:
        engine = UlisseEngine.distributed(None, p, data, max_batch=4,
                                          device=device)
        backend = f"the distributed engine ({banner})"
    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"tracing {ns} series x {args.series_len} on {backend}; "
        f"artifacts -> {args.out}/", flush=True)

    rng = np.random.default_rng(3)
    qlen = (p.lmin + p.lmax) // 2 // 16 * 16

    def make_query():
        s = rng.integers(0, ns)
        o = rng.integers(0, args.series_len - qlen + 1)
        return (data[s, o:o + qlen]
                + rng.normal(size=qlen).astype(np.float32) * .02)

    knn = QuerySpec(k=args.k)
    approx = QuerySpec(k=args.k, mode="approx")

    # direct engine queries (every rank): the caller owns stats recording
    probe = engine.search(make_query(), knn)       # warm the first use
    eps = float(np.sqrt(probe.dists[-1]) * 1.5) if len(probe.dists) \
        else 1.0
    rng_spec = QuerySpec(eps=eps)
    specs = [knn, approx, rng_spec]
    label = "distributed" if engine.is_distributed else "device"
    t0 = time.perf_counter()
    for i in range(args.queries):
        res = engine.search(make_query(), specs[i % len(specs)])
        if rank == 0:
            obs.record_search_stats(res.stats, backend=label)
    dt = time.perf_counter() - t0
    say(f"engine: {args.queries} mixed queries "
        f"(knn/approx/range eps={eps:.3f}) in {dt:.2f}s", flush=True)
    if rank != 0:
        follow(engine)             # replay rank 0's dispatches
        return

    # served queries: the dispatcher records spans + stats itself
    server = UlisseServer(engine, knn, ServeConfig(max_batch=4))
    server.warmup([qlen])
    server.metrics.reset()
    for _ in range(args.queries):
        server.search(make_query(), timeout=300)
    server.close()        # joins the dispatcher: its records are all in
    m = server.metrics.snapshot()
    print(f"server: {m['total']['completed']} queries, "
          f"mean_fill={m['total']['mean_fill']}")

    os.makedirs(args.out, exist_ok=True)
    trace_path = tracer.export_chrome_trace(
        os.path.join(args.out, "trace.json"))
    with open(trace_path) as f:
        n_events = len(json.load(f)["traceEvents"])
    prom_path = os.path.join(args.out, "metrics.prom")
    with open(prom_path, "w") as f:
        f.write(server.metrics_text())
    json_path = os.path.join(args.out, "metrics.json")
    with open(json_path, "w") as f:
        f.write(obs.get_registry().json_text())
    print(f"wrote {trace_path} ({n_events} events), {prom_path}, "
          f"{json_path}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
