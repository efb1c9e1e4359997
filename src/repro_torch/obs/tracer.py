"""Sampling span tracer: one query traced end-to-end, exportable as
Chrome ``trace_event`` JSON (the port of `repro.obs.tracer`, same
contract).

The paper's performance argument lives in quantities that only show up
*inside* one query — how long the LB pack took vs the device scan, how
much wall time the host continuation of an overflowed range query ate,
how long a request waited in its serving bucket before dispatch.  The
tracer records those as nested spans:

    with tracer.span("device_scan", bucket=128, batch=8):
        ...

Design constraints, in order:

  1. **Disabled must be (nearly) free.**  Tracing is off by default;
     the engine hot path calls ``span()`` unconditionally, so the
     disabled call is one attribute check returning a shared no-op
     context manager — no allocation, no lock, no clock read.
  2. **Bounded memory.**  Finished spans land in a ring buffer
     (``deque(maxlen=capacity)``); a long-running server traces
     forever without growing host state.
  3. **Sampling by trace, not by span.**  The sampling decision is
     made once per ROOT span (deterministic 1-in-N counter, no RNG on
     the hot path) and inherited by every nested span on that thread,
     so a sampled trace is always complete — a partial trace is worse
     than none.
  4. **Alignment with torch profiles.**  With ``torch_annotations=True``
     each recorded span also enters a
     ``torch.profiler.record_function`` range, so spans show up in a
     ``torch.profiler`` trace next to the kernels they wrap.  The
     profiler records the ranges of its own thread only, unless started
     with ``profile_all_threads`` (a serving dispatcher is another
     thread).

Span timestamps are ``time.perf_counter()`` relative to the tracer
epoch; the Chrome export emits microseconds, loadable in Perfetto /
``chrome://tracing``.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional


class Span:
    """One finished span: name, [t0, t0+dur) in seconds since the
    tracer epoch, thread id, nesting depth, and free-form attributes."""

    __slots__ = ("name", "t0", "dur", "tid", "depth", "attrs")

    def __init__(self, name: str, t0: float, dur: float, tid: int,
                 depth: int, attrs: Optional[dict]):
        self.name = name
        self.t0 = t0
        self.dur = dur
        self.tid = tid
        self.depth = depth
        self.attrs = attrs

    def as_dict(self) -> dict:
        return {"name": self.name, "t0": self.t0, "dur": self.dur,
                "tid": self.tid, "depth": self.depth,
                "attrs": dict(self.attrs or {})}


class _NullSpan:
    """The shared no-op context manager returned while disabled (or
    for unsampled traces).  One instance, zero state."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        """Attribute recording is a no-op on an unsampled span."""


_NULL_SPAN = _NullSpan()


class _UnsampledRoot:
    """Placeholder for a root span that lost the sampling draw.  It
    must still occupy the thread's nesting state: without it, the spans
    nested under an unsampled root would see an empty stack, treat
    themselves as roots, and make fresh sampling decisions — recording
    partial traces, which the design forbids (§3 of the module doc)."""

    __slots__ = ("_local",)

    def __init__(self, local):
        self._local = local

    def __enter__(self) -> "_UnsampledRoot":
        self._local.suppress = getattr(self._local, "suppress", 0) + 1
        return self

    def __exit__(self, *exc) -> bool:
        self._local.suppress -= 1
        return False

    def set(self, **attrs) -> None:
        """Attribute recording is a no-op on an unsampled trace."""


class _LiveSpan:
    """An open span on a sampled trace (context manager)."""

    __slots__ = ("_tracer", "name", "attrs", "_t0", "_prof_ctx")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self._t0 = 0.0
        self._prof_ctx = None

    def set(self, **attrs) -> None:
        """Attach attributes discovered mid-span (e.g. overflow counts
        known only after the device readback)."""
        self.attrs.update(attrs)

    def __enter__(self) -> "_LiveSpan":
        tr = self._tracer
        stack = tr._stack()
        stack.append(self)
        if tr.torch_annotations:
            try:
                from torch.profiler import record_function
                self._prof_ctx = record_function(self.name)
                self._prof_ctx.__enter__()
            except Exception:              # noqa: BLE001 — tracing must
                self._prof_ctx = None      # never break the query path
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        if self._prof_ctx is not None:
            self._prof_ctx.__exit__(*exc)
        tr = self._tracer
        stack = tr._stack()
        depth = len(stack) - 1
        if stack and stack[-1] is self:
            stack.pop()
        tr._record(Span(self.name, self._t0 - tr._epoch,
                        t1 - self._t0, threading.get_ident(), depth,
                        self.attrs or None))
        return False


class Tracer:
    """Sampling span tracer with a bounded in-memory ring buffer.

    ``enabled=False`` (the default) makes ``span()`` a near-free no-op.
    ``sample_every=N`` records every N-th root span (and all of its
    children); 1 records everything.
    """

    def __init__(self, enabled: bool = False, sample_every: int = 1,
                 capacity: int = 8192, torch_annotations: bool = False):
        self.configure(enabled=enabled, sample_every=sample_every,
                       capacity=capacity,
                       torch_annotations=torch_annotations)

    def configure(self, enabled: Optional[bool] = None,
                  sample_every: Optional[int] = None,
                  capacity: Optional[int] = None,
                  torch_annotations: Optional[bool] = None) -> "Tracer":
        """Reconfigure in place (None = keep).  Changing ``capacity``
        re-bounds the ring buffer, keeping the newest spans."""
        if not hasattr(self, "_lock"):
            self._lock = threading.Lock()
            self._local = threading.local()
            self._spans: deque = deque(maxlen=8192)
            self._epoch = time.perf_counter()
            self._seq = 0
            self.enabled = False
            self.sample_every = 1
            self.torch_annotations = False
        with self._lock:
            if sample_every is not None:
                if sample_every < 1:
                    raise ValueError("sample_every must be >= 1")
                self.sample_every = sample_every
            if capacity is not None:
                if capacity < 1:
                    raise ValueError("capacity must be >= 1")
                self._spans = deque(self._spans, maxlen=capacity)
            if torch_annotations is not None:
                self.torch_annotations = torch_annotations
            if enabled is not None:
                self.enabled = enabled
        return self

    # -- hot path ------------------------------------------------------

    def span(self, name: str, **attrs):
        """Open a span.  THE hot-path call: when disabled this is one
        attribute check + returning a shared singleton."""
        if not self.enabled:
            return _NULL_SPAN
        if getattr(self._local, "suppress", 0):
            return _NULL_SPAN              # inside an unsampled trace
        stack = self._stack()
        if not stack:                      # root span: sampling decision
            with self._lock:
                self._seq += 1
                if self._seq % self.sample_every:
                    return _UnsampledRoot(self._local)
        return _LiveSpan(self, name, attrs)

    def record_interval(self, name: str, t0: float, t1: float,
                        **attrs) -> None:
        """Record an externally-timed span: [t0, t1) are
        ``time.perf_counter()`` readings taken by the caller (e.g. a
        queue wait measured between a submit on one thread and the
        dispatch on another).  Subject to `enabled` only — intervals
        bridge traces, so root-span sampling does not apply."""
        if not self.enabled:
            return
        self._record(Span(name, t0 - self._epoch, max(t1 - t0, 0.0),
                          threading.get_ident(),
                          len(self._stack()), attrs or None))

    # -- internals -----------------------------------------------------

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _record(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)

    # -- export --------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    def drain(self) -> List[Span]:
        """Remove and return every buffered span (oldest first)."""
        with self._lock:
            out = list(self._spans)
            self._spans.clear()
        return out

    def snapshot(self) -> List[Span]:
        """Buffered spans without clearing (oldest first)."""
        with self._lock:
            return list(self._spans)

    def chrome_trace(self, clear: bool = False) -> dict:
        """Chrome ``trace_event`` JSON object (complete 'X' events,
        microsecond timestamps) — loadable in Perfetto."""
        spans = self.drain() if clear else self.snapshot()
        pid = os.getpid()
        tids: Dict[int, int] = {}
        events = [{
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": "ulisse"},
        }]
        for s in spans:
            tid = tids.setdefault(s.tid, len(tids))
            ev = {"name": s.name, "cat": "ulisse", "ph": "X",
                  "ts": round(s.t0 * 1e6, 3),
                  "dur": round(s.dur * 1e6, 3),
                  "pid": pid, "tid": tid}
            if s.attrs:
                ev["args"] = {k: v for k, v in s.attrs.items()}
            events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_chrome_trace(self, path: str, clear: bool = False) -> str:
        """Write the Chrome trace JSON to ``path``; returns the path."""
        doc = self.chrome_trace(clear=clear)
        with open(path, "w") as f:
            json.dump(doc, f)
        return path
