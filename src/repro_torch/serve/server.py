"""`UlisseServer`: the asynchronous serving tier in front of one
`UlisseEngine` (the port of `repro.serve.server`, the same dispatch
logic).

The engine's design — pow2 batch buckets, one padded device batch and
one result readback per same-length group — is built for batching; this
module is what exploits it under load:

  * **Length-bucket dynamic batching.**  `submit()` runs the
    per-request half of the planner split (`planner.admit_query`:
    validation + pow2 bucket routing, host, cheap, on the client
    thread) and enqueues into that bucket's queue.  The dispatcher
    holds a bucket for `window_ms` (or until it fills to `max_batch`),
    then dispatches the coalesced batch as ONE `engine.search` call —
    the execution half: device, batched, per bucket.  The dispatcher
    thread, not the caller's, launches every kernel.
  * **Admission control.**  Total queued requests are bounded by
    `max_pending`; a submit over the bound is shed immediately with a
    typed `AdmissionError` (backpressure the caller can act on)
    instead of growing an unbounded queue.
  * **Writer lane.**  `append()`/`compact()` (and `warmup()`) enqueue
    writer ops that the dispatcher applies BETWEEN dispatches, on the
    same thread that runs queries.  The engine's index reference is
    therefore only ever swapped when no scan is in flight: every query
    batch runs against one consistent index snapshot, and a compact
    can never race a scan.  Responses carry the snapshot version they
    executed under (`Ticket.snapshot`).
  * **Metrics + tracing.**  Per-bucket qps, batch-fill histogram,
    queue wait and p50/p95/p99 end-to-end latency, exported as a dict
    (`server.metrics.snapshot()`) — the serving analogue of
    `SearchStats` — and mirrored into the process-wide
    `repro_torch.obs` registry together with every dispatched query's
    engine pruning counters (`server.metrics_text()` = one Prometheus
    scrape for the whole pipeline).  With `repro_torch.obs` tracing
    enabled,
    each request leaves admission -> queue_wait -> dispatch spans that
    nest around the engine's prepare/pack/device-scan/merge spans.

  * **Distributed engines.**  Over `UlisseEngine.distributed` every
    rank must make the same engine calls, in the same order, with the
    same batches, or the collectives inside them deadlock; independent
    dispatchers with their own hold windows would not.  So rank 0 leads:
    it runs the server (admission, bucket queues, the adaptive window,
    the writer lane), and its dispatcher sends each engine op (`search`
    of a batch and spec, `append`, `compact`, `warmup`, then `close`) to
    the other ranks in one broadcast on the engine's group before it
    runs the op; every other rank runs `follow(engine)`, which replays
    them.  Served answers are the same on every rank.

Typical use::

    server = UlisseServer(engine, QuerySpec(k=5),
                          ServeConfig(window_ms=2.0, max_batch=8))
    server.warmup([96, 128, 160])
    res = server.search(q)                   # blocking convenience
    t = server.submit(q); ...; res = t.result()
    server.append(new_series).result()       # via the writer lane
    server.close()

    # a distributed engine: rank 0 serves, the other ranks follow
    if engine.rank == 0:
        server = UlisseServer(engine, spec); ...; server.close()
    else:
        follow(engine)
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Deque, Dict, Optional, Sequence

import torch

from repro_torch import obs
from repro_torch.core import planner
from repro_torch.core.engine import QuerySpec, UlisseEngine
from repro_torch.distributed import collectives
from repro_torch.obs import span
from repro_torch.serve.metrics import ServeMetrics

# -- thread-discipline declarations (the reference's lint rule T1) ----------
#
# Role vocabulary: "client" = any caller thread (submit/close/append...),
# "dispatcher" = the single ulisse-serve-dispatch thread, "any" = both.
# A "+locked" suffix marks a method whose contract is that self._cond is
# already held by its caller.  THREAD_ATTRS maps every mutable attribute
# to the roles allowed to write it outside __init__ (() = never written
# after construction); an attribute reachable from more than one thread
# may only be written inside a `with self._cond:` block or from a
# "+locked" method, unless marked "nolock" (externally synchronized —
# say how in a comment).  The reference's `repro.analysis.threads` parses
# these literals and checks every method body against them (the port's
# tests run it on this file); an undeclared writing
# method or attribute is itself a finding.

THREAD_METHODS = {
    "UlisseServer.start": "client",
    "UlisseServer.close": "client",
    "UlisseServer.__enter__": "client",
    "UlisseServer.__exit__": "client",
    "UlisseServer.version": "any",
    "UlisseServer.pending": "any",
    "UlisseServer._backend_label": "any",
    "UlisseServer.metrics_text": "any",
    "UlisseServer.metrics_json": "any",
    "UlisseServer.submit": "client",
    "UlisseServer.search": "client",
    "UlisseServer.append": "client",
    "UlisseServer.compact": "client",
    "UlisseServer.warmup": "client",
    "UlisseServer._submit_writer": "client",
    "UlisseServer._loop": "dispatcher",
    "UlisseServer._pick_ripe_locked": "dispatcher+locked",
    "UlisseServer._timeout_locked": "dispatcher+locked",
    "UlisseServer._dispatch": "dispatcher",
    "UlisseServer._apply_writer": "dispatcher",
    "UlisseServer._replicate": "dispatcher",
    "Ticket.done": "any",
    "Ticket.result": "client",
    # close() fails queued tickets from the client thread, so _fail is
    # "any"; a ticket still transitions exactly once (see _value below)
    "Ticket._complete": "dispatcher",
    "Ticket._fail": "any",
}

THREAD_ATTRS = {
    # never rebound after __init__
    "UlisseServer.engine": (),
    "UlisseServer.spec": (),
    "UlisseServer.config": (),
    "UlisseServer.metrics": (),
    "UlisseServer._cond": (),
    "UlisseServer._buckets": ("client", "dispatcher"),
    "UlisseServer._writer": ("client", "dispatcher"),
    "UlisseServer._pending": ("client", "dispatcher"),
    # dispatcher-private: written between dispatches only; the version
    # property's unguarded int read is a snapshot, never torn
    "UlisseServer._version": ("dispatcher",),
    # dispatcher-private adaptive hold window (seconds): read/written
    # only inside the dispatch loop's locked section
    "UlisseServer._eff_window": ("dispatcher",),
    # dispatcher-private page-cache stats snapshot for delta mirroring
    "UlisseServer._page_last": ("dispatcher",),
    "UlisseServer._closed": ("client",),
    "UlisseServer._drain": ("client",),
    "UlisseServer._thread": ("client",),
    # one-shot hand-off published by Event.set() in the same method —
    # the happens-before edge IS the synchronization, no lock involved
    "Ticket._value": ("any", "nolock"),
    "Ticket._error": ("any", "nolock"),
    "Ticket._event": (),
}


class AdmissionError(RuntimeError):
    """The serving queue is full: the request was shed, not queued.

    Carries the queue state so callers can implement retry/backoff.
    """

    def __init__(self, msg: str, *, pending: int, max_pending: int,
                 bucket: Optional[int] = None):
        super().__init__(msg)
        self.pending = pending
        self.max_pending = max_pending
        self.bucket = bucket


class ServerClosed(RuntimeError):
    """The server no longer accepts work (closed or closing)."""


class Ticket:
    """Completion handle for one admitted request or writer op.

    `snapshot` is the index version the work executed under (writer
    ops bump it); set at dispatch, valid once `done()`.
    """

    __slots__ = ("bucket", "snapshot", "t_submit", "_event", "_value",
                 "_error")

    def __init__(self, bucket: Optional[int] = None):
        self.bucket = bucket
        self.snapshot: Optional[int] = None
        self.t_submit = 0.0
        self._event = threading.Event()
        self._value = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        """Block until the response is ready; re-raises the dispatch
        error if the request failed."""
        if not self._event.wait(timeout):
            raise TimeoutError("request still pending")
        if self._error is not None:
            raise self._error
        return self._value

    def _complete(self, value) -> None:
        self._value = value
        self._event.set()

    def _fail(self, err: BaseException) -> None:
        self._error = err
        self._event.set()


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving knobs.

    window_ms:   how long a non-full bucket is held before dispatch —
                 the latency the slowest request of a batch donates to
                 coalescing (0 disables holding: dispatch whatever is
                 queued the moment the dispatcher is free).  The window
                 adapts to load: when a dispatch leaves every queue
                 empty the effective window drops to zero (a lone
                 request under light traffic never donates hold
                 latency), and the configured window is restored the
                 moment a dispatch leaves requests queued behind it.
    max_batch:   requests coalesced into one dispatch.  At or below
                 the engine's own `max_batch` a dispatch is exactly one
                 padded device batch per exact length present.
    max_pending: admission bound on TOTAL queued (not yet dispatched)
                 requests across buckets; submits beyond it raise
                 AdmissionError.
    """

    window_ms: float = 2.0
    max_batch: int = 8
    max_pending: int = 256

    def __post_init__(self):
        if self.window_ms < 0:
            raise ValueError("window_ms must be >= 0")
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.max_pending < 1:
            raise ValueError("max_pending must be >= 1")


class _Request:
    __slots__ = ("q", "ticket")

    def __init__(self, q, ticket: Ticket):
        self.q = q
        self.ticket = ticket


class _WriterOp:
    __slots__ = ("kind", "payload", "ticket")

    def __init__(self, kind: str, payload, ticket: Ticket):
        self.kind = kind
        self.payload = payload
        self.ticket = ticket


class UlisseServer:
    """Dynamic-batching request server over one `UlisseEngine`."""

    def __init__(self, engine: UlisseEngine,
                 spec: QuerySpec = QuerySpec(),
                 config: ServeConfig = ServeConfig(),
                 start: bool = True):
        if engine.rank != 0:
            raise ValueError(
                f"rank {engine.rank} of a distributed engine follows the "
                "server of rank 0: call serve.follow(engine)")
        self.engine = engine
        self.spec = spec
        self.config = config
        self.metrics = ServeMetrics()
        self._cond = threading.Condition()
        self._buckets: Dict[int, Deque[_Request]] = {}
        self._writer: Deque[_WriterOp] = deque()
        self._pending = 0
        self._version = 0
        # adaptive hold window: starts at the configured value so the
        # first requests can still coalesce; drops to 0 once a dispatch
        # drains the queues, restored when one leaves work behind
        self._eff_window = config.window_ms / 1e3
        self._page_last: Optional[dict] = None
        self._closed = False
        self._drain = True
        self._thread: Optional[threading.Thread] = None
        if start:
            self.start()

    # -- lifecycle -----------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("server already started")
        self._thread = threading.Thread(target=self._loop,
                                        name="ulisse-serve-dispatch",
                                        daemon=True)
        self._thread.start()

    def close(self, drain: bool = True,
              timeout: Optional[float] = None) -> None:
        """Stop accepting work.  `drain=True` answers everything
        already queued (windows are cut short); `drain=False` fails
        queued tickets with ServerClosed."""
        with self._cond:
            self._closed = True
            self._drain = drain
            if not drain:
                for dq in self._buckets.values():
                    while dq:
                        dq.popleft().ticket._fail(
                            ServerClosed("server closed before "
                                         "dispatch"))
                while self._writer:
                    self._writer.popleft().ticket._fail(
                        ServerClosed("server closed before apply"))
                self._pending = 0
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)

    def __enter__(self) -> "UlisseServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close(drain=exc == (None, None, None))

    @property
    def version(self) -> int:
        """Current index snapshot version (writer ops bump it)."""
        return self._version

    @property
    def pending(self) -> int:
        """Requests queued and not yet dispatched."""
        with self._cond:
            return self._pending

    @property
    def _backend_label(self) -> str:
        """Registry label for engine stats recorded at dispatch."""
        if self.engine.is_distributed:
            return "distributed"
        return self.spec.scan_backend

    def metrics_text(self) -> str:
        """Prometheus text exposition of the process registry: the
        `ulisse_serve_*` stream this server mirrors (per-bucket latency
        and queue-wait histograms, fill, admission counters) plus the
        `ulisse_engine_*` pruning counters recorded per dispatched
        query — one scrape surface for the whole pipeline."""
        return self.metrics.registry.prometheus_text()

    def metrics_json(self) -> dict:
        """JSON snapshot of the same registry state as metrics_text()."""
        return self.metrics.registry.snapshot()

    # -- client surface ------------------------------------------------

    def submit(self, q) -> Ticket:
        """Admit one query: validate + route (planner.admit_query, on
        this thread), enqueue into its length bucket.  Raises
        ValueError (malformed request), AdmissionError (queue full) or
        ServerClosed."""
        with span("serve.admission") as sp:
            arr, bucket = planner.admit_query(q, self.engine.params)
            sp.set(bucket=bucket)
            ticket = Ticket(bucket)
            with self._cond:
                if self._closed:
                    raise ServerClosed("server is closed")
                if self._pending >= self.config.max_pending:
                    self.metrics.record_reject(bucket)
                    raise AdmissionError(
                        f"queue full ({self._pending} pending >= "
                        f"max_pending={self.config.max_pending}); retry "
                        "with backoff", pending=self._pending,
                        max_pending=self.config.max_pending,
                        bucket=bucket)
                ticket.t_submit = time.perf_counter()
                self._buckets.setdefault(bucket, deque()).append(
                    _Request(arr, ticket))
                self._pending += 1
                self.metrics.record_admit(bucket)
                self._cond.notify()
            return ticket

    def search(self, q, timeout: Optional[float] = None):
        """Blocking convenience: submit + wait for the SearchResult."""
        return self.submit(q).result(timeout)

    def append(self, series) -> Ticket:
        """Ingest series through the writer lane: applied between
        dispatches, bumps the snapshot version.  The ticket completes
        once the series are searchable.

        Shape/layout errors are raised HERE, on the caller's thread
        (`engine.validate_append` is read-only, so it is safe off the
        dispatcher) — a malformed batch fails fast as ValueError
        instead of surfacing later through the ticket.  The same lane
        serves both backends: a distributed engine lands the rows in
        its per-shard delta buffers (searched alongside the sorted
        envelopes) exactly as the local engine's unsorted delta is.
        """
        self.engine.validate_append(series)
        return self._submit_writer("append", series)

    def compact(self) -> Ticket:
        """Merge the ingestion delta between dispatches (never racing
        an in-flight scan)."""
        return self._submit_writer("compact", None)

    def warmup(self, lengths: Sequence[int],
               batch_sizes: Optional[Sequence[int]] = None,
               timeout: Optional[float] = None) -> int:
        """Pay a traffic mix's first-use costs (`engine.warmup`: the
        kernels' build and load on a CUDA engine, then one search per
        shape) through the writer lane, so all engine use stays on the
        dispatcher thread.  Blocks; returns the shapes exercised.

        The default batch sizes are every power of two up to
        `max_batch` — dispatch fills pad to their pow2 bucket, so this
        covers EVERY fill the dispatcher can produce."""
        if batch_sizes is None:
            sizes, b = {self.config.max_batch}, 1
            while b < self.config.max_batch:
                sizes.add(b)
                b *= 2
            batch_sizes = sorted(sizes)
        op = self._submit_writer("warmup", (tuple(lengths),
                                            tuple(batch_sizes)))
        return op.result(timeout)

    def _submit_writer(self, kind: str, payload) -> Ticket:
        ticket = Ticket()
        with self._cond:
            if self._closed:
                raise ServerClosed("server is closed")
            self._writer.append(_WriterOp(kind, payload, ticket))
            self._cond.notify()
        return ticket

    # -- dispatcher ----------------------------------------------------

    def _loop(self) -> None:
        window = self.config.window_ms / 1e3
        dev = self.engine.device
        if dev.type == "cuda" and dev.index is not None:
            # the thread's own current device: the engine's card
            torch.cuda.set_device(dev)
        while True:
            op = batch = bucket = None
            done = False
            with self._cond:
                while True:
                    if self._writer:
                        op = self._writer.popleft()
                        break
                    bucket, batch = self._pick_ripe_locked(
                        self._eff_window)
                    if batch is not None:
                        # adapt the hold window to observed load: queues
                        # drained -> stop holding; backlog left -> the
                        # configured window coalesces it again
                        self._eff_window = (window if self._pending > 0
                                            else 0.0)
                        break
                    if self._closed:
                        done = True  # drained (or flushed by close)
                        break
                    self._cond.wait(self._timeout_locked(
                        self._eff_window))
            if done:
                self._replicate("close")     # the followers return
                return
            if op is not None:
                self._apply_writer(op)
            else:
                self._dispatch(bucket, batch)

    def _pick_ripe_locked(self, window: float):
        """The ripest bucket's batch, or (None, None).

        Ripe = full to max_batch, or its oldest request has waited out
        the window (always, once closing).  Among ripe buckets the one
        with the oldest head dispatches first (FIFO across buckets
        prevents a hot bucket starving a cold one)."""
        now = time.perf_counter()
        best, best_t = None, None
        for bucket, dq in self._buckets.items():
            if not dq:
                continue
            head_t = dq[0].ticket.t_submit
            ripe = (len(dq) >= self.config.max_batch
                    or now - head_t >= window or self._closed)
            if ripe and (best_t is None or head_t < best_t):
                best, best_t = bucket, head_t
        if best is None:
            return None, None
        dq = self._buckets[best]
        batch = [dq.popleft()
                 for _ in range(min(len(dq), self.config.max_batch))]
        self._pending -= len(batch)
        return best, batch

    def _timeout_locked(self, window: float) -> Optional[float]:
        """Sleep until the earliest bucket deadline (None = until
        notified)."""
        deadline = None
        for dq in self._buckets.values():
            if dq:
                t = dq[0].ticket.t_submit + window
                deadline = t if deadline is None else min(deadline, t)
        if deadline is None:
            return None
        return max(deadline - time.perf_counter(), 1e-4)

    def _dispatch(self, bucket: int, batch) -> None:
        t0 = time.perf_counter()
        tracer = obs.get_tracer()
        with span("serve.dispatch", bucket=bucket,
                  fill=len(batch)) as sp:
            # the waits happened across threads, before this span
            # opened: record them as externally-timed queue_wait spans
            # so a trace shows submit->dispatch next to the dispatch
            for r in batch:
                tracer.record_interval("serve.queue_wait",
                                       r.ticket.t_submit, t0,
                                       bucket=bucket)
            self.metrics.record_dispatch(
                bucket, fill=len(batch),
                waits=[t0 - r.ticket.t_submit for r in batch])
            version = self._version
            try:
                # ONE engine call: per exact length present this is one
                # padded device batch with one result readback (plus
                # the scan's stop tests)
                queries = [r.q for r in batch]
                self._replicate("search", queries, self.spec)
                results = self.engine.search(queries, self.spec)
            except Exception as e:  # noqa: BLE001 — fail the tickets,
                for r in batch:     # keep serving
                    r.ticket._fail(e)
                self.metrics.record_failed(bucket, len(batch))
                sp.set(failed=len(batch))
                return
            t1 = time.perf_counter()
            for r, res in zip(batch, results):
                r.ticket.snapshot = version
                r.ticket._complete(res)
                obs.record_search_stats(res.stats,
                                        backend=self._backend_label)
            self.metrics.record_done(
                bucket, [t1 - r.ticket.t_submit for r in batch])
            # paged engines only: mirror the store's cumulative cache
            # counters into the registry as deltas (the engine hot path
            # stays registry-free)
            cur = self.engine.page_cache_stats()
            if cur is not None:
                last = self._page_last or {}
                delta = {k: max(0, cur.get(k, 0) - last.get(k, 0))
                         for k in ("hits", "misses", "evicted_bytes")}
                obs.record_page_stats(delta, cur.get("cache_bytes", 0))
                self._page_last = cur

    def _apply_writer(self, op: _WriterOp) -> None:
        """Index mutation between dispatches: the only place the
        engine's snapshot is swapped, on the only thread that runs
        scans — a batch can never observe a half-applied index."""
        try:
            if op.kind == "warmup":
                self._replicate("warmup", *op.payload, self.spec)
            else:
                self._replicate(op.kind, op.payload)
            if op.kind == "append":
                self.engine.append(op.payload)
                self._version += 1
                op.ticket.snapshot = self._version
                op.ticket._complete(self._version)
            elif op.kind == "compact":
                self.engine.compact()
                self._version += 1
                op.ticket.snapshot = self._version
                op.ticket._complete(self._version)
            else:                  # warmup
                lengths, batch_sizes = op.payload
                traced = self.engine.warmup(lengths, batch_sizes,
                                            spec=self.spec)
                op.ticket._complete(traced)
        except Exception as e:     # noqa: BLE001
            op.ticket._fail(e)

    def _replicate(self, kind: str, *args) -> None:
        """Send one engine op to the other ranks of a distributed engine
        (one broadcast on its group, from rank 0), before rank 0 runs it;
        a no-op on a local engine."""
        if self.engine.is_distributed:
            collectives.broadcast_object((kind,) + args,
                                         group=self.engine.group,
                                         device=self.engine.device)


def follow(engine: UlisseEngine) -> int:
    """The other ranks' half of a server over a distributed engine: replay
    every engine op that rank 0's dispatcher broadcasts, in its order,
    until it closes; returns the ops replayed.  An op that raises here
    raises on rank 0 too (the same call on the same inputs), which fails
    its tickets and serves on: so does this loop."""
    replayed = 0
    while True:
        op = collectives.broadcast_object(group=engine.group,
                                          device=engine.device)
        kind, args = op[0], op[1:]
        if kind == "close":
            return replayed
        try:
            if kind == "search":
                engine.search(*args)
            elif kind == "append":
                engine.append(*args)
            elif kind == "compact":
                engine.compact()
            else:                                  # warmup
                lengths, batch_sizes, spec = args
                engine.warmup(lengths, batch_sizes, spec=spec)
        except Exception:  # noqa: BLE001 — rank 0 fails the same op
            pass
        replayed += 1
