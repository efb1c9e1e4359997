"""Process-wide metrics registry with Prometheus / JSON exporters.

`MetricsRegistry` is the single sink that `ServeMetrics` (per-bucket
serving latency, fill, queue depth) and the engine's per-query
`SearchStats` (pruning counters, chunk funnel) both feed into, so one
scrape sees the whole system.  Three instrument kinds, all labelled:

  * **counter** — monotone float/int, ``inc(name, value, **labels)``.
  * **gauge** — last-write-wins, ``set_gauge(name, value, **labels)``.
  * **histogram** — fixed upper-bound buckets (cumulative, Prometheus
    semantics) plus ``_sum``/``_count``; ``observe(name, value,
    **labels)``.

Exporters:

  * ``prometheus_text()`` — text exposition format 0.0.4: ``# HELP`` /
    ``# TYPE`` headers, one ``name{label="v",...} value`` line per
    series, histograms expanded to ``_bucket{le="..."}`` series with a
    ``+Inf`` bucket.
  * ``snapshot()`` — a plain-dict JSON mirror of the same state.

All operations take one short lock; this registry sits on the serving
metrics path (per-dispatch, not per-envelope) so contention is low.
Instruments auto-register on first touch — callers don't pre-declare,
but a name keeps the kind of its first use (a kind clash raises).
"""
from __future__ import annotations

import json
import threading
from typing import Dict, List, Optional, Sequence, Tuple

# Default histogram upper bounds (seconds) — spans serving latencies
# from ~0.1ms to 30s; registry users can override per-instrument.
DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: dict) -> _LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt_labels(key: _LabelKey) -> str:
    if not key:
        return ""
    inner = ",".join(
        '%s="%s"' % (k, v.replace("\\", "\\\\").replace('"', '\\"'))
        for k, v in key
    )
    return "{%s}" % inner


def _fmt_value(v: float) -> str:
    # Prometheus wants plain decimals; ints render without the .0 for
    # counter readability.
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _Histogram:
    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets: Sequence[float]):
        self.buckets = tuple(buckets)
        self.counts = [0] * len(self.buckets)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        # counts are NON-cumulative (one bucket per observation); the
        # exporters cumulate, so incrementing every matching bound here
        # would double-count
        self.sum += value
        self.count += 1
        for i, ub in enumerate(self.buckets):
            if value <= ub:
                self.counts[i] += 1
                break


class _Family:
    __slots__ = ("name", "kind", "help", "buckets", "series")

    def __init__(self, name: str, kind: str, help_text: str,
                 buckets: Optional[Sequence[float]] = None):
        self.name = name
        self.kind = kind
        self.help = help_text
        self.buckets = tuple(buckets) if buckets else DEFAULT_BUCKETS
        self.series: Dict[_LabelKey, object] = {}


_NAME_OK = set("abcdefghijklmnopqrstuvwxyz"
               "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_:")


class MetricsRegistry:
    """Threadsafe named counters/gauges/histograms with label sets."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    # -- registration --------------------------------------------------

    def _family(self, name: str, kind: str, help_text: str,
                buckets: Optional[Sequence[float]] = None) -> _Family:
        fam = self._families.get(name)
        if fam is None:
            if not name or set(name) - _NAME_OK or name[0].isdigit():
                raise ValueError("invalid metric name: %r" % (name,))
            fam = _Family(name, kind, help_text, buckets)
            self._families[name] = fam
        elif fam.kind != kind:
            raise ValueError(
                "metric %r is a %s, not a %s" % (name, fam.kind, kind))
        return fam

    # -- instruments ---------------------------------------------------

    def inc(self, name: str, value: float = 1.0, help_text: str = "",
            **labels) -> None:
        """Add ``value`` (must be >= 0) to a counter series."""
        if value < 0:
            raise ValueError("counters only go up")
        key = _label_key(labels)
        with self._lock:
            fam = self._family(name, "counter", help_text)
            fam.series[key] = fam.series.get(key, 0.0) + value

    def set_gauge(self, name: str, value: float, help_text: str = "",
                  **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            fam = self._family(name, "gauge", help_text)
            fam.series[key] = float(value)

    def observe(self, name: str, value: float, help_text: str = "",
                buckets: Optional[Sequence[float]] = None,
                **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            fam = self._family(name, "histogram", help_text, buckets)
            h = fam.series.get(key)
            if h is None:
                h = fam.series[key] = _Histogram(fam.buckets)
            h.observe(value)

    # -- reads ---------------------------------------------------------

    def get(self, name: str, **labels) -> Optional[float]:
        """Current value of a counter/gauge series (None if absent)."""
        with self._lock:
            fam = self._families.get(name)
            if fam is None or fam.kind == "histogram":
                return None
            v = fam.series.get(_label_key(labels))
            return None if v is None else float(v)

    def clear(self) -> None:
        with self._lock:
            self._families.clear()

    # -- exporters -----------------------------------------------------

    def prometheus_text(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: List[str] = []
        with self._lock:
            for name in sorted(self._families):
                fam = self._families[name]
                if fam.help:
                    lines.append("# HELP %s %s" % (name, fam.help))
                lines.append("# TYPE %s %s" % (name, fam.kind))
                for key in sorted(fam.series):
                    if fam.kind == "histogram":
                        h = fam.series[key]
                        cum = 0
                        for ub, c in zip(h.buckets, h.counts):
                            cum += c
                            bkey = key + (("le", _fmt_value(ub)),)
                            lines.append("%s_bucket%s %d" % (
                                name, _fmt_labels(bkey), cum))
                        bkey = key + (("le", "+Inf"),)
                        lines.append("%s_bucket%s %d" % (
                            name, _fmt_labels(bkey), h.count))
                        lines.append("%s_sum%s %s" % (
                            name, _fmt_labels(key), _fmt_value(h.sum)))
                        lines.append("%s_count%s %d" % (
                            name, _fmt_labels(key), h.count))
                    else:
                        lines.append("%s%s %s" % (
                            name, _fmt_labels(key),
                            _fmt_value(fam.series[key])))
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """JSON-ready mirror: {name: {kind, help, series: [...]}}."""
        out: Dict[str, dict] = {}
        with self._lock:
            for name, fam in self._families.items():
                series = []
                for key, v in fam.series.items():
                    entry: dict = {"labels": dict(key)}
                    if fam.kind == "histogram":
                        entry.update(
                            sum=v.sum, count=v.count,
                            buckets=[
                                {"le": ub, "count": c}
                                for ub, c in zip(v.buckets, v.counts)
                            ],
                        )
                    else:
                        entry["value"] = v
                    series.append(entry)
                out[name] = {"kind": fam.kind, "help": fam.help,
                             "series": series}
        return out

    def json_text(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)
