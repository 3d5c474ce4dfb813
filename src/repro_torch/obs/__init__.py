"""Observability for the port's weight streamer and object store: a
metrics :class:`Registry` (counters, gauges, log-bucketed histograms),
per-prefetch lifecycle spans collected by a :class:`Tracer`, and the
:class:`Observability` context a host (``pos.store.ObjectStore.attach_obs``)
is instrumented with.

Copies of ``repro.obs.metrics``, ``repro.obs.spans`` and
``repro.obs.Observability``; the Chrome-trace export (``repro.obs.export``)
is not ported yet.
"""

from .metrics import Counter, Gauge, Histogram, Meter, Registry
from .spans import PrefetchSpan, SpanError, Tracer, check_span_invariants

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
]
