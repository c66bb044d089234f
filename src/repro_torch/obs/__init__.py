"""Observability: the dual-clock span tracer (metrics and export come in a
later slice)."""
from .spans import CATEGORIES, Span, SpanTracer

__all__ = ["CATEGORIES", "Span", "SpanTracer"]
