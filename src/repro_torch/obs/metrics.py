"""Low-overhead metrics: counters, gauges, log-bucketed histograms and the
named, labeled :class:`Registry` that owns them.  A copy of
``repro.obs.metrics`` (pure Python), kept here so that the port imports
nothing of the JAX package.

Design constraints:

  * **hot-path cheap** — recording a sample is a handful of dict/list ops
    under a per-metric lock; callers on the demand path pre-resolve their
    metric objects once and call ``record``/``inc`` directly;
  * **two fidelity regimes** — the virtual clock can afford exact
    percentiles (samples are kept and sorted on read), the wall clock keeps
    fixed log-spaced buckets only (p50/p99/p999 are bucket estimates);
  * **self-metering** — every recording charges its own wall cost to a
    shared :class:`Meter`, so the observability layer can report what *it*
    cost and the zero-overhead claim stays falsifiable;
  * **one snapshot** — pre-existing metric surfaces (``StoreMetrics``,
    ``StreamMetrics``, ``Overhead``) plug in as *sources* so one
    ``Registry.snapshot()`` returns everything a run measured.
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional, Sequence


@dataclass
class Meter:
    """Accumulated cost of the instrumentation itself."""

    seconds: float = 0.0
    events: int = 0

    def reset(self) -> None:
        self.seconds = 0.0
        self.events = 0


class Counter:
    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: dict):
        self.name = name
        self.labels = labels
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def snapshot(self) -> dict:
        return {"labels": dict(self.labels), "value": self.value}

    def reset(self) -> None:
        self.value = 0


class Gauge:
    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: dict):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v

    def snapshot(self) -> dict:
        return {"labels": dict(self.labels), "value": self.value}

    def reset(self) -> None:
        self.value = 0.0


def log_buckets(lo: float = 1e-6, hi: float = 100.0, per_decade: int = 8) -> list[float]:
    """Ascending upper bucket edges, log-spaced ``per_decade`` per decade
    from ``lo`` to ``hi`` inclusive.  Bucket 0 is the implicit ``[0, lo)``
    underflow (where a fully hidden / cache-hit stall of 0.0 lands), and an
    implicit overflow bucket catches everything ``>= hi``."""
    n = int(round(math.log10(hi / lo) * per_decade))
    return [lo * 10 ** (i / per_decade) for i in range(n + 1)]


class Histogram:
    """Latency histogram over fixed log-spaced buckets.

    ``exact=True`` (the virtual-clock regime) additionally keeps every raw
    sample so ``percentile`` returns the exact numpy-style (linear
    interpolation) quantile; ``exact=False`` (wall clock) answers from the
    buckets alone — the estimate is the geometric midpoint of the bucket
    containing the requested rank, i.e. within one bucket width (a factor
    of ``10**(1/per_decade)``) of the truth."""

    def __init__(self, name: str = "", labels: Optional[dict] = None,
                 lo: float = 1e-6, hi: float = 100.0, per_decade: int = 8,
                 exact: bool = False, meter: Optional[Meter] = None):
        self.name = name
        self.labels = labels or {}
        self.exact = exact
        self.meter = meter
        self._edges = log_buckets(lo, hi, per_decade)
        # counts[0] = underflow [0, lo); counts[-1] = overflow [hi, inf)
        self._counts = [0] * (len(self._edges) + 1)
        self._samples: list[float] = []
        self._lock = threading.Lock()
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = 0.0

    def _bucket_index(self, v: float) -> int:
        edges = self._edges
        if v < edges[0]:
            return 0
        if v >= edges[-1]:
            return len(edges)
        # log-spaced edges: the index is a closed-form log, clamped for
        # float-rounding safety (no bisect on the hot path)
        lo = edges[0]
        per = len(edges) - 1
        i = int(math.log10(v / lo) * per / math.log10(edges[-1] / lo)) + 1
        while i < len(edges) and v >= edges[i]:
            i += 1
        while i > 0 and v < edges[i - 1]:
            i -= 1
        return i

    def record(self, value: float) -> None:
        t0 = time.perf_counter() if self.meter is not None else 0.0
        v = value if value > 0.0 else 0.0
        with self._lock:
            self._counts[self._bucket_index(v)] += 1
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            if self.exact:
                self._samples.append(v)
        m = self.meter
        if m is not None:
            m.events += 1
            m.seconds += time.perf_counter() - t0

    # -- read side ----------------------------------------------------------

    def percentile(self, q: float) -> Optional[float]:
        """Quantile ``q`` in [0, 1].  Exact (numpy 'linear') when samples
        are kept; bucket-estimated otherwise.  None when empty."""
        with self._lock:
            if not self.count:
                return None
            if self.exact:
                xs = sorted(self._samples)
                pos = q * (len(xs) - 1)
                lo_i = int(math.floor(pos))
                hi_i = min(lo_i + 1, len(xs) - 1)
                frac = pos - lo_i
                return xs[lo_i] * (1.0 - frac) + xs[hi_i] * frac
            rank = q * self.count
            cum = 0
            for i, c in enumerate(self._counts):
                cum += c
                if cum >= rank:
                    return self._bucket_estimate(i)
            return self._bucket_estimate(len(self._counts) - 1)

    def _bucket_estimate(self, i: int) -> float:
        if i == 0:
            return 0.0
        if i >= len(self._edges):
            return self.max  # overflow: best available bound
        lo = self._edges[i - 1]
        hi = self._edges[i]
        return math.sqrt(lo * hi)

    def percentiles(self, qs: Sequence[float] = (0.5, 0.99, 0.999)) -> list[Optional[float]]:
        return [self.percentile(q) for q in qs]

    def merge_from(self, other: "Histogram") -> None:
        """Pool another histogram's population into this one (same bucket
        layout required) — how per-service histograms aggregate to one
        store-wide distribution."""
        with other._lock:
            counts = list(other._counts)
            samples = list(other._samples)
            count, total = other.count, other.sum
            mn, mx = other.min, other.max
        with self._lock:
            if len(counts) != len(self._counts):
                raise ValueError("histogram bucket layouts differ")
            for i, c in enumerate(counts):
                self._counts[i] += c
            self.count += count
            self.sum += total
            self.min = min(self.min, mn)
            self.max = max(self.max, mx)
            if self.exact:
                self._samples.extend(samples)

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "labels": dict(self.labels),
                "count": self.count,
                "sum": self.sum,
                "min": self.min if self.count else None,
                "max": self.max if self.count else None,
                "exact": self.exact,
            }
        for q, key in ((0.5, "p50"), (0.99, "p99"), (0.999, "p999")):
            out[key] = self.percentile(q)
        return out

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * len(self._counts)
            self._samples = []
            self.count = 0
            self.sum = 0.0
            self.min = math.inf
            self.max = 0.0


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


class Registry:
    """Named, labeled metrics plus pluggable snapshot *sources*.

    ``counter``/``gauge``/``histogram`` are get-or-create (same name +
    labels returns the same object), so hosts resolve their metric objects
    once at attach time and the hot path never hits the registry again.
    ``register_source`` adopts a legacy metric surface (anything with a
    callable returning a dict) so ``snapshot()`` is the one coherent read
    of everything a run measured, and ``reset()`` the one zeroing."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[tuple, Counter] = {}
        self._gauges: dict[tuple, Gauge] = {}
        self._histograms: dict[tuple, Histogram] = {}
        self._sources: dict[str, tuple[Callable[[], dict], Optional[Callable[[], None]]]] = {}
        self.meter = Meter()

    # -- get-or-create -------------------------------------------------------

    def counter(self, name: str, **labels) -> Counter:
        key = (name, _label_key(labels))
        with self._lock:
            if key not in self._counters:
                self._counters[key] = Counter(name, labels)
            return self._counters[key]

    def gauge(self, name: str, **labels) -> Gauge:
        key = (name, _label_key(labels))
        with self._lock:
            if key not in self._gauges:
                self._gauges[key] = Gauge(name, labels)
            return self._gauges[key]

    def histogram(self, name: str, exact: bool = False, **labels) -> Histogram:
        key = (name, _label_key(labels))
        with self._lock:
            if key not in self._histograms:
                self._histograms[key] = Histogram(
                    name, labels, exact=exact, meter=self.meter
                )
            return self._histograms[key]

    def register_source(self, name: str, snapshot_fn: Callable[[], dict],
                        reset_fn: Optional[Callable[[], None]] = None) -> None:
        with self._lock:
            self._sources[name] = (snapshot_fn, reset_fn)

    def unregister_source(self, name: str) -> bool:
        """Remove a snapshot source (the inverse ``register_source`` never
        had): a closed ``Session`` must drop its ``runtime/<label>`` entry,
        or every snapshot keeps calling a snapshot_fn that pins a shut-down
        ``PrefetchRuntime`` forever.  Returns whether the name was
        registered."""
        with self._lock:
            return self._sources.pop(name, None) is not None

    def source_names(self) -> list[str]:
        with self._lock:
            return sorted(self._sources)

    # -- aggregation ---------------------------------------------------------

    def merged_histogram(self, name: str) -> Optional[Histogram]:
        """One pooled histogram across every labeled instance of ``name``
        (e.g. the store-wide stall distribution over per-service labels)."""
        with self._lock:
            parts = [h for (n, _), h in self._histograms.items() if n == name]
        if not parts:
            return None
        merged = Histogram(name, {"merged": True}, exact=all(p.exact for p in parts))
        for p in parts:
            merged.merge_from(p)
        return merged

    def percentiles(self, name: str, qs: Sequence[float] = (0.5, 0.99, 0.999)
                    ) -> list[Optional[float]]:
        merged = self.merged_histogram(name)
        if merged is None:
            return [None] * len(qs)
        return merged.percentiles(qs)

    # -- lifecycle -----------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            counters = list(self._counters.values())
            gauges = list(self._gauges.values())
            hists = list(self._histograms.values())
            sources = dict(self._sources)
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}, "sources": {}}
        for c in counters:
            out["counters"].setdefault(c.name, []).append(c.snapshot())
        for g in gauges:
            out["gauges"].setdefault(g.name, []).append(g.snapshot())
        for h in hists:
            out["histograms"].setdefault(h.name, []).append(h.snapshot())
        for name, (snap, _reset) in sources.items():
            out["sources"][name] = snap()
        out["self"] = {"seconds": self.meter.seconds, "events": self.meter.events}
        return out

    def reset(self) -> None:
        with self._lock:
            metrics = (list(self._counters.values()) + list(self._gauges.values())
                       + list(self._histograms.values()))
            sources = dict(self._sources)
        for m in metrics:
            m.reset()
        for _name, (_snap, reset) in sources.items():
            if reset is not None:
                reset()
        self.meter.reset()
