"""Observability for the port's weight streamer: a metrics
:class:`Registry` (counters, gauges, log-bucketed histograms) and
per-prefetch lifecycle spans collected by a :class:`Tracer`.

Copies of ``repro.obs.metrics`` and ``repro.obs.spans``; the Chrome-trace
export (``repro.obs.export``) is not ported yet.
"""

from .metrics import Counter, Gauge, Histogram, Meter, Registry
from .spans import PrefetchSpan, SpanError, Tracer, check_span_invariants

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Meter",
    "PrefetchSpan",
    "Registry",
    "SpanError",
    "Tracer",
    "check_span_invariants",
]
