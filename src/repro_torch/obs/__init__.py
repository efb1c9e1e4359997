"""repro_torch.obs — tracing, pruning telemetry and metrics export (the
port of `repro.obs`, the same names and contract).

One substrate, three surfaces:

  * ``get_tracer()`` / ``span(...)`` — the process-wide sampling
    `Tracer`.  Engine and server call ``span()`` unconditionally; it is
    a near-free no-op until someone calls
    ``get_tracer().configure(enabled=True)`` (add
    ``torch_annotations=True`` to see the spans in a ``torch.profiler``
    trace as well).
  * ``get_registry()`` — the process-wide `MetricsRegistry` that
    `ServeMetrics` mirrors into and `record_search_stats` feeds, with
    Prometheus text / JSON snapshot exporters.
  * ``record_search_stats(stats, backend=...)`` — fold one query's
    `SearchStats` into the registry as ``ulisse_engine_*`` counters.

The engine fills one `SearchStats` schema on every backend; this module
is where those numbers become scrapeable.
"""
from __future__ import annotations

from .registry import DEFAULT_BUCKETS, MetricsRegistry
from .tracer import Span, Tracer

__all__ = [
    "DEFAULT_BUCKETS",
    "MetricsRegistry",
    "Span",
    "Tracer",
    "get_registry",
    "get_tracer",
    "record_page_stats",
    "record_search_stats",
    "set_registry",
    "set_tracer",
    "span",
]

_tracer = Tracer()
_registry = MetricsRegistry()


def get_tracer() -> Tracer:
    """The process-wide tracer (disabled until configured)."""
    return _tracer


def set_tracer(tracer: Tracer) -> Tracer:
    """Swap the process-wide tracer (tests); returns the previous one."""
    global _tracer
    prev, _tracer = _tracer, tracer
    return prev


def span(name: str, **attrs):
    """Open a span on the process-wide tracer — the one call sites use."""
    return _tracer.span(name, **attrs)


def get_registry() -> MetricsRegistry:
    """The process-wide metrics registry."""
    return _registry


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Swap the process-wide registry (tests); returns the previous one."""
    global _registry
    prev, _registry = _registry, registry
    return prev


# SearchStats counter fields exported per query.  Everything here is a
# monotone per-query count, so summing across queries stays meaningful.
_STATS_COUNTERS = (
    ("envelopes_total", "Envelopes in scope across queries"),
    ("envelopes_checked", "Envelopes surviving LB pruning"),
    ("envelopes_pruned", "Envelopes cut by LB/bsf inside visited chunks"),
    ("lb_computations", "Envelope lower-bound evaluations"),
    ("true_dist_computations", "True-distance window verifications"),
    ("dtw_lb_keogh", "DTW LB_Keogh band evaluations"),
    ("dtw_full", "Full DTW dynamic programs run"),
    ("chunks_visited", "Scan chunks actually executed"),
    ("chunks_planned", "Scan chunks in the dispatch plan"),
    ("escalations", "verify_top escalation rounds"),
    ("range_overflows", "Device range hits past capacity (host tail)"),
)


def _check_stats_schema() -> None:
    """Pin the exporter to the device stats schema (the reference's rule
    R5): every column of `executor.STATS_COLUMNS` must be an exported
    counter, so a widened device stats vector fails at import time
    instead of exporting a truncated schema.  The executor is imported
    here, not at the top: the engine imports this package."""
    from repro_torch.core.executor import STATS_COLUMNS, STATS_WIDTH
    exported = {f for f, _ in _STATS_COUNTERS}
    missing = [c for c in STATS_COLUMNS if c not in exported]
    if len(STATS_COLUMNS) != STATS_WIDTH or missing:
        raise RuntimeError(
            f"obs exporter is missing device stats columns {missing}; "
            "extend _STATS_COUNTERS when executor.STATS_COLUMNS grows")


_check_stats_schema()


def record_search_stats(stats, backend: str = "local",
                        registry: MetricsRegistry | None = None) -> None:
    """Fold one query's `SearchStats` into ``ulisse_engine_*`` counters,
    labelled by backend (host / device)."""
    reg = registry if registry is not None else _registry
    for field, help_text in _STATS_COUNTERS:
        v = getattr(stats, field, 0)
        if v:
            reg.inc("ulisse_engine_" + field, float(v),
                    help_text=help_text, backend=backend)
    reg.inc("ulisse_engine_queries", 1.0,
            help_text="Queries with recorded stats", backend=backend)


# Page-cache counter deltas exported by `record_page_stats`; cache_bytes
# is a gauge (current residency), everything else is monotone.
_PAGE_COUNTERS = (
    ("hits", "Page cache hits"),
    ("misses", "Page cache misses (shard faults)"),
    ("evicted_bytes", "Bytes evicted from the page cache"),
)


def record_page_stats(delta, cache_bytes: float,
                      registry: MetricsRegistry | None = None) -> None:
    """Fold a page-cache stats *delta* into ``ulisse_page_cache_*``.

    `delta` holds hit/miss/evicted_bytes increments since the caller's
    last snapshot (`PayloadStore.stats()` counters are cumulative, so the
    caller diffs); `cache_bytes` is the current resident byte count.
    The engine hot path stays registry-free — the serve dispatcher
    mirrors the store's counters here after each batch."""
    reg = registry if registry is not None else _registry
    for field, help_text in _PAGE_COUNTERS:
        v = delta.get(field, 0)
        if v:
            reg.inc("ulisse_page_cache_" + field + "_total", float(v),
                    help_text=help_text)
    reg.set_gauge("ulisse_page_cache_bytes", float(cache_bytes),
                  help_text="Bytes currently resident in the page cache")
