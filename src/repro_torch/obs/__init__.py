"""Observability: the dual-clock span tracer, the metrics registry with the
sync's modeled cost, and the Chrome/Perfetto trace-event export."""
from .export import save_trace_events, to_trace_events, validate_trace_events
from .metrics import MetricsRegistry, modeled_sync_cost
from .spans import CATEGORIES, Span, SpanTracer

__all__ = [
    "CATEGORIES",
    "MetricsRegistry",
    "Span",
    "SpanTracer",
    "modeled_sync_cost",
    "save_trace_events",
    "to_trace_events",
    "validate_trace_events",
]
