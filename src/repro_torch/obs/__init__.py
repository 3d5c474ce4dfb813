"""Unified observability layer (DESIGN.md section 3.7).

One measurement substrate shared by the live ``ObjectStore`` (wall clock)
and the ``VirtualReplay`` engine (virtual clock):

  * ``metrics``  — a low-overhead :class:`Registry` of named counters,
    gauges and log-bucketed :class:`Histogram`\\ s with per-service /
    per-session labels, absorbing the repo's previously disjoint metric
    surfaces (``StoreMetrics``, ``StreamMetrics``, ``Overhead``) behind one
    ``snapshot()`` / ``reset()`` API;
  * ``spans``    — per-prefetch lifecycle records (:class:`PrefetchSpan`)
    threaded from prediction through dispatch, claim, disk queue and load
    to exactly one terminal outcome, collected by a :class:`Tracer` that
    works on either clock;
  * ``export``   — Chrome-trace / Perfetto JSON serialization of spans plus
    derived disk/demand-queue occupancy, so a benchmark run renders as an
    inspectable timeline.

Instrumentation cost is itself metered (:class:`Meter`) and charged to the
prediction ``Overhead`` ledger, so CAPre's zero-overhead claim stays
falsifiable even with the instruments attached.
"""

from .metrics import Counter, Gauge, Histogram, Meter, Registry
from .spans import PrefetchSpan, SpanError, Tracer, check_span_invariants
from .export import (
    chrome_trace,
    full_lifecycle_phase_counts,
    validate_chrome_trace,
    validate_flow_pairing,
    write_chrome_trace,
)

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class Observability:
    """The context a host (store, streamer, replay engine) is instrumented
    with: a metrics registry, optionally a span tracer, and one shared
    :class:`Meter` accounting the instrumentation's own cost."""

    registry: Registry = field(default_factory=Registry)
    tracer: Optional[Tracer] = None
    tracing: bool = False

    def __post_init__(self) -> None:
        if self.tracing and self.tracer is None:
            self.tracer = Tracer(meter=self.registry.meter)
        elif self.tracer is not None and self.tracer.meter is None:
            self.tracer.meter = self.registry.meter

    @property
    def meter(self) -> Meter:
        return self.registry.meter

    def snapshot(self) -> dict:
        out = self.registry.snapshot()
        if self.tracer is not None:
            out["spans"] = self.tracer.counts()
        return out

    def reset(self) -> None:
        self.registry.reset()
        if self.tracer is not None:
            self.tracer.reset()

    def charge(self, overhead) -> None:
        """Add this context's metered instrumentation cost to a prediction
        ``Overhead`` ledger (``obs_seconds`` / ``obs_events``)."""
        overhead.obs_seconds += self.meter.seconds
        overhead.obs_events += self.meter.events


__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Meter",
    "Observability",
    "PrefetchSpan",
    "Registry",
    "SpanError",
    "Tracer",
    "check_span_invariants",
    "chrome_trace",
    "full_lifecycle_phase_counts",
    "validate_chrome_trace",
    "validate_flow_pairing",
    "write_chrome_trace",
]
