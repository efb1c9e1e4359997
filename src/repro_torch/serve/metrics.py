"""Serving metrics: per-bucket throughput, batch fill, queue wait and
end-to-end latency, surfaced like `SearchStats` (the port of
`repro.serve.metrics`).

The dispatcher thread is the only writer on the hot path, but
`snapshot()` may be called from any thread (benches poll it while
clients are in flight), so every mutation takes the (uncontended)
metrics lock.  Latency and queue-wait samples live in bounded deques —
a long-running server must not grow O(requests) host state just to
report a p99.

Every record_* call also mirrors into the process-wide
`repro_torch.obs.MetricsRegistry` as `ulisse_serve_*` counters/histograms
labelled by length bucket, so one Prometheus scrape
(`UlisseServer.metrics_text()`) sees serving latency next to the
engine's pruning counters.  `reset()` restarts only the local
measurement window — the registry is process-wide and monotone, as
scrapers expect.
"""
from __future__ import annotations

import threading
import time
from collections import Counter, deque
from typing import Dict, List, Optional

import numpy as np

from repro_torch import obs

MAX_SAMPLES = 65536          # per-bucket latency/wait sample window

# -- thread-discipline declarations (the reference's lint rule T1) ----------
# Same scheme as serve/server.py: record_admit/record_reject run on the
# client (admission) thread, record_dispatch/done/failed on the
# dispatcher, reset/snapshot on any thread — which is why every bucket
# mutation takes self._lock.  _bucket is only called with the lock held.

THREAD_METHODS = {
    "ServeMetrics.registry": "any",
    "ServeMetrics.reset": "any",
    "ServeMetrics._bucket": "any+locked",
    "ServeMetrics.record_admit": "client",
    "ServeMetrics.record_reject": "client",
    "ServeMetrics.record_dispatch": "dispatcher",
    "ServeMetrics.record_done": "dispatcher",
    "ServeMetrics.record_failed": "dispatcher",
    "ServeMetrics.snapshot": "any",
}

THREAD_ATTRS = {
    "ServeMetrics._lock": (),            # never rebound after __init__
    "ServeMetrics._registry": (),
    "ServeMetrics._buckets": ("client", "dispatcher", "any"),
    "ServeMetrics._t0": ("any",),
}

# fill is bounded by ServeConfig.max_batch (pow2-padded dispatches):
# integer-edge buckets keep the histogram exact for the usual range
_FILL_BUCKETS = (1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0, 24.0, 32.0,
                 64.0)


def _pctiles_ms(samples: List[float]) -> Dict[str, float]:
    """{p50, p95, p99} in milliseconds (zeros when empty)."""
    if not samples:
        return {"p50": 0.0, "p95": 0.0, "p99": 0.0}
    arr = np.asarray(samples, np.float64) * 1e3
    p50, p95, p99 = np.percentile(arr, (50.0, 95.0, 99.0))
    return {"p50": round(float(p50), 3), "p95": round(float(p95), 3),
            "p99": round(float(p99), 3)}


class _BucketMetrics:
    __slots__ = ("admitted", "rejected", "completed", "failed",
                 "dispatches", "fill_hist", "queue_wait", "latency")

    def __init__(self):
        self.admitted = 0
        self.rejected = 0        # shed by admission control
        self.completed = 0
        self.failed = 0          # dispatch raised; tickets carry the error
        self.dispatches = 0
        self.fill_hist = Counter()           # batch fill -> dispatches
        self.queue_wait = deque(maxlen=MAX_SAMPLES)   # submit -> dispatch
        self.latency = deque(maxlen=MAX_SAMPLES)      # submit -> response

    def as_dict(self, elapsed: float) -> dict:
        fills = sorted(self.fill_hist.items())
        total_fill = sum(f * c for f, c in fills)
        return {
            "admitted": self.admitted,
            "completed": self.completed,
            "rejected": self.rejected,
            "failed": self.failed,
            "dispatches": self.dispatches,
            "qps": round(self.completed / max(elapsed, 1e-9), 2),
            "mean_fill": round(total_fill / max(self.dispatches, 1), 3),
            "fill_hist": {int(f): int(c) for f, c in fills},
            "queue_wait_ms": _pctiles_ms(list(self.queue_wait)),
            "latency_ms": _pctiles_ms(list(self.latency)),
        }


class ServeMetrics:
    """Aggregated serving counters, exportable as one dict.

    `registry` (default: the process-wide `obs.get_registry()`)
    receives a mirrored `ulisse_serve_*` stream of every record; pass
    an isolated `MetricsRegistry` in tests to assert on exact values.
    """

    def __init__(self, registry: Optional["obs.MetricsRegistry"] = None):
        self._lock = threading.Lock()
        self._buckets: Dict[int, _BucketMetrics] = {}
        self._t0 = time.perf_counter()
        self._registry = registry

    @property
    def registry(self) -> "obs.MetricsRegistry":
        # late-bound so tests swapping obs.set_registry() take effect
        return (self._registry if self._registry is not None
                else obs.get_registry())

    def reset(self) -> None:
        """Restart the measurement window (benches call this after
        warmup so steady-state qps is not diluted by first-use costs).
        The mirrored registry stream is NOT reset — it is process-wide
        and monotone."""
        with self._lock:
            self._buckets = {}
            self._t0 = time.perf_counter()

    def _bucket(self, bucket: int) -> _BucketMetrics:
        bm = self._buckets.get(bucket)
        if bm is None:
            bm = self._buckets[bucket] = _BucketMetrics()
        return bm

    def record_admit(self, bucket: int) -> None:
        with self._lock:
            self._bucket(bucket).admitted += 1
        self.registry.inc("ulisse_serve_admitted_total",
                          help_text="Requests admitted to the queue",
                          bucket=bucket)

    def record_reject(self, bucket: int) -> None:
        with self._lock:
            self._bucket(bucket).rejected += 1
        self.registry.inc("ulisse_serve_rejected_total",
                          help_text="Requests shed by admission control",
                          bucket=bucket)

    def record_dispatch(self, bucket: int, fill: int,
                        waits: List[float]) -> None:
        with self._lock:
            bm = self._bucket(bucket)
            bm.dispatches += 1
            bm.fill_hist[fill] += 1
            bm.queue_wait.extend(waits)
        reg = self.registry
        reg.inc("ulisse_serve_dispatches_total",
                help_text="Coalesced batches dispatched", bucket=bucket)
        reg.observe("ulisse_serve_batch_fill", float(fill),
                    help_text="Requests coalesced per dispatch",
                    buckets=_FILL_BUCKETS, bucket=bucket)
        for w in waits:
            reg.observe("ulisse_serve_queue_wait_seconds", w,
                        help_text="Submit-to-dispatch wait",
                        bucket=bucket)

    def record_done(self, bucket: int, latencies: List[float]) -> None:
        with self._lock:
            bm = self._bucket(bucket)
            bm.completed += len(latencies)
            bm.latency.extend(latencies)
        reg = self.registry
        reg.inc("ulisse_serve_completed_total", float(len(latencies)),
                help_text="Requests answered", bucket=bucket)
        for lat in latencies:
            reg.observe("ulisse_serve_latency_seconds", lat,
                        help_text="Submit-to-response latency",
                        bucket=bucket)

    def record_failed(self, bucket: int, n: int) -> None:
        with self._lock:
            self._bucket(bucket).failed += n
        self.registry.inc("ulisse_serve_failed_total", float(n),
                          help_text="Requests failed at dispatch",
                          bucket=bucket)

    def snapshot(self) -> dict:
        """One nested dict: per-bucket rows + a `total` fold — the
        serving analogue of SearchStats, consumed by benches, the
        example, and tests."""
        with self._lock:
            elapsed = time.perf_counter() - self._t0
            buckets = {b: bm.as_dict(elapsed)
                       for b, bm in sorted(self._buckets.items())}
            all_lat: List[float] = []
            all_wait: List[float] = []
            for bm in self._buckets.values():
                all_lat.extend(bm.latency)
                all_wait.extend(bm.queue_wait)
            completed = sum(bm.completed
                            for bm in self._buckets.values())
            dispatches = sum(bm.dispatches
                             for bm in self._buckets.values())
            # mean_fill must fold the per-bucket fill histograms, like
            # the per-bucket rows do: completed/dispatches undercounts
            # whenever a dispatch fails (its requests were coalesced
            # but never complete), silently deflating the batching
            # efficiency the serving tier exists to demonstrate
            total_fill = sum(f * c for bm in self._buckets.values()
                             for f, c in bm.fill_hist.items())
            total = {
                "admitted": sum(bm.admitted
                                for bm in self._buckets.values()),
                "completed": completed,
                "rejected": sum(bm.rejected
                                for bm in self._buckets.values()),
                "failed": sum(bm.failed
                              for bm in self._buckets.values()),
                "dispatches": dispatches,
                "qps": round(completed / max(elapsed, 1e-9), 2),
                "mean_fill": round(total_fill / max(dispatches, 1), 3),
                "queue_wait_ms": _pctiles_ms(all_wait),
                "latency_ms": _pctiles_ms(all_lat),
            }
        return {"elapsed_s": round(elapsed, 3), "total": total,
                "buckets": buckets}
