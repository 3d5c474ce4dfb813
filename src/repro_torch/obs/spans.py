"""Per-prefetch lifecycle spans.  A copy of ``repro.obs.spans`` (pure
Python), kept here so that the port imports nothing of the JAX package.

Every prefetched oid gets ONE :class:`PrefetchSpan` per residency
generation, threaded through its whole life:

  predicted  — a predictor emitted the oid (origin = predictor + hint
               context);
  dispatched — ``ObjectStore.prefetch_batch`` grouped it into a batch for
               its owning Data Service (batch id assigned here);
  claimed    — ``DataService.claim_prefetch_batch`` won the dedupe (or the
               span terminates ``suppressed``: already resident/in flight);
  queued/loaded — a batch lane picked the oid into a chunk (``queued_t``),
               acquired a disk slot (``load_start_t``: slot wait ends) and
               landed it (``load_done_t``: service time ends);
  terminal   — exactly one of:
               * ``hit``      — first demand access found it resident
                 (stall 0, ``hidden_s`` = the disk load removed from the
                 app's critical path);
               * ``partial``  — first demand access caught the load in
                 flight (``stall_s`` = the remainder the app waited);
               * ``evicted``  — evicted before any demand use;
               * ``suppressed`` — deduped before any load was submitted;
               * ``dropped``  — cancelled on drain / reset / error.

Demand *misses* get the same span shape (kind ``demand``, terminal
``miss``) so stall attribution is symmetric: the timeline shows exactly
where every second of disk wait went, hidden or not.

The tracer is clock-agnostic: the live store records wall timestamps
(``time.perf_counter``), the replay engine passes explicit virtual times —
the exported span fields are identical, which is what makes wall and
virtual timelines comparable side by side.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Iterable, Optional, Sequence

from .metrics import Meter

#: terminal outcomes a span can reach (exactly one each)
TERMINAL_OUTCOMES = ("hit", "partial", "miss", "evicted", "suppressed", "dropped")


class SpanError(AssertionError):
    """A span lifecycle invariant was violated."""


@dataclass
class PrefetchSpan:
    oid: int
    kind: str = "prefetch"  # "prefetch" | "demand"
    origin: str = ""  # predictor name + hint/method context
    service: int = -1
    session: str = ""
    batch_id: int = -1
    lane: int = -1
    predicted_t: Optional[float] = None
    dispatched_t: Optional[float] = None
    claimed_t: Optional[float] = None
    queued_t: Optional[float] = None
    load_start_t: Optional[float] = None
    load_done_t: Optional[float] = None
    outcome: str = ""  # "" while active; one of TERMINAL_OUTCOMES when done
    outcome_t: Optional[float] = None
    hidden_s: float = 0.0
    stall_s: float = 0.0
    re_predicted: int = 0  # later predictions of the same live span

    @property
    def terminal(self) -> bool:
        return bool(self.outcome)

    @property
    def slot_wait_s(self) -> Optional[float]:
        if self.queued_t is None or self.load_start_t is None:
            return None
        return self.load_start_t - self.queued_t

    @property
    def service_s(self) -> Optional[float]:
        if self.load_start_t is None or self.load_done_t is None:
            return None
        return self.load_done_t - self.load_start_t

    def fields_set(self) -> tuple[str, ...]:
        """Names of the populated lifecycle fields — the wall-vs-virtual
        parity check compares these, not the (clock-dependent) values."""
        keys = ("predicted_t", "dispatched_t", "claimed_t", "queued_t",
                "load_start_t", "load_done_t", "outcome_t")
        return tuple(k for k in keys if getattr(self, k) is not None)


class Tracer:
    """Collects spans from either clock.  All mutation goes through the
    lifecycle methods below; ``t=None`` means "now" on the tracer's clock
    (the live store's wall clock), explicit ``t`` is the virtual replay's
    spelling.  Thread-safe; the internal lock is a leaf (never acquires any
    store lock), so calls are safe under a Data Service's cache lock."""

    def __init__(self, clock=None, meter: Optional[Meter] = None,
                 session: str = ""):
        self.clock = clock or time.perf_counter
        self.meter = meter
        self.session = session
        self._lock = threading.Lock()
        self._active: dict[int, PrefetchSpan] = {}
        self._done: list[PrefetchSpan] = []
        self._batch_ids = 0
        # point-in-time markers outside any span's lifecycle (failover,
        # service crash/down, demand steal, straggler flags): rendered as
        # Perfetto instant events on the service's track
        self._instants: list[dict] = []
        self.events = 0

    # -- internals -----------------------------------------------------------

    def now(self) -> float:
        return self.clock()

    def _charge(self, t0: float) -> None:
        m = self.meter
        if m is not None:
            m.events += 1
            m.seconds += time.perf_counter() - t0

    def _finish(self, span: PrefetchSpan, outcome: str, t: float) -> None:
        """Move a span to its single terminal state (callers hold the
        lock)."""
        if span.terminal:
            raise SpanError(
                f"span oid={span.oid} already terminal ({span.outcome}); "
                f"second outcome {outcome}"
            )
        span.outcome = outcome
        span.outcome_t = t
        self._active.pop(span.oid, None)
        self._done.append(span)

    # -- lifecycle recording -------------------------------------------------

    def predicted(self, oids: Iterable[int], origin: str = "",
                  t: Optional[float] = None, session: str = "") -> None:
        t0 = time.perf_counter()
        ts = self.clock() if t is None else t
        who = session or self.session
        with self._lock:
            self.events += 1
            for oid in oids:
                span = self._active.get(oid)
                if span is not None:
                    span.re_predicted += 1
                    continue
                self._active[oid] = PrefetchSpan(
                    oid=oid, origin=origin, predicted_t=ts, session=who
                )
        self._charge(t0)

    def new_batch(self) -> int:
        with self._lock:
            self._batch_ids += 1
            return self._batch_ids

    def dispatched(self, oids: Iterable[int], service: int, batch_id: int = -1,
                   t: Optional[float] = None, session: str = "") -> None:
        t0 = time.perf_counter()
        ts = self.clock() if t is None else t
        who = session or self.session
        with self._lock:
            self.events += 1
            for oid in oids:
                span = self._active.get(oid)
                if span is None:
                    # dispatch without a recorded prediction (e.g. the
                    # legacy generated closure): open the span here
                    span = PrefetchSpan(oid=oid, predicted_t=ts,
                                        session=who)
                    self._active[oid] = span
                if span.dispatched_t is None:
                    span.dispatched_t = ts
                    span.service = service
                    span.batch_id = batch_id
        self._charge(t0)

    def claimed(self, oids: Iterable[int], service: int,
                t: Optional[float] = None) -> None:
        t0 = time.perf_counter()
        ts = self.clock() if t is None else t
        with self._lock:
            self.events += 1
            for oid in oids:
                span = self._active.get(oid)
                if span is not None and span.claimed_t is None:
                    span.claimed_t = ts
                    span.service = service
        self._charge(t0)

    def suppressed(self, oids: Iterable[int], service: int,
                   t: Optional[float] = None) -> None:
        """Deduped before submission (already resident / in flight /
        duplicate).  Terminal only for spans that never got past dispatch;
        a span whose load is underway just counts a re-prediction."""
        t0 = time.perf_counter()
        ts = self.clock() if t is None else t
        with self._lock:
            self.events += 1
            for oid in oids:
                span = self._active.get(oid)
                if span is None:
                    continue
                if span.claimed_t is None and span.load_done_t is None:
                    span.service = service if span.service < 0 else span.service
                    self._finish(span, "suppressed", ts)
                else:
                    span.re_predicted += 1
        self._charge(t0)

    def loaded(self, oids: Iterable[int], service: int, lane: int,
               queued_t: float, start_t: float, done_t: float,
               session: str = "") -> None:
        """A batch lane landed a chunk: slot wait = ``start - queued``,
        service time = ``done - start`` (chunk-granular on the wall clock:
        the chunk's sequential loads share one slot hold)."""
        t0 = time.perf_counter()
        who = session or self.session
        with self._lock:
            self.events += 1
            for oid in oids:
                span = self._active.get(oid)
                if span is None:
                    span = PrefetchSpan(oid=oid, predicted_t=queued_t,
                                        dispatched_t=queued_t, service=service,
                                        session=who)
                    self._active[oid] = span
                span.lane = lane
                span.service = service
                if span.queued_t is None:
                    span.queued_t = queued_t
                span.load_start_t = start_t
                span.load_done_t = done_t
        self._charge(t0)

    def demand(self, oid: int, service: int, needed_t: float, stall_s: float,
               full_load: bool, disk_load_s: float,
               t: Optional[float] = None, session: str = "") -> None:
        """A demand access touched ``oid``.  If a prefetch span is live,
        this is its terminal ``hit`` (resident: full disk load hidden) or
        ``partial`` (in flight: the app waited out ``stall_s``); otherwise
        a full miss opens-and-closes a symmetric demand span.  Plain cache
        hits with no live span record nothing (bounded memory)."""
        t0 = time.perf_counter()
        end_t = (needed_t + stall_s) if t is None else t
        with self._lock:
            self.events += 1
            span = self._active.get(oid)
            if span is not None and span.kind == "prefetch":
                span.stall_s = stall_s
                if full_load:
                    # the prefetch never landed in time and the demand path
                    # re-loaded it itself: nothing was hidden
                    span.hidden_s = 0.0
                    self._finish(span, "miss", end_t)
                elif stall_s > 0.0 and span.load_done_t is not None and \
                        span.load_done_t > needed_t:
                    span.hidden_s = max(0.0, disk_load_s - stall_s)
                    self._finish(span, "partial", end_t)
                else:
                    span.hidden_s = disk_load_s
                    span.stall_s = 0.0
                    self._finish(span, "hit", end_t)
            elif full_load:
                miss = PrefetchSpan(
                    oid=oid, kind="demand", service=service,
                    session=session or self.session,
                    predicted_t=needed_t, queued_t=needed_t,
                    load_start_t=needed_t, load_done_t=end_t,
                    stall_s=stall_s,
                )
                miss.outcome = "miss"
                miss.outcome_t = end_t
                self._done.append(miss)
        self._charge(t0)

    def instant(self, name: str, service: int = -1,
                t: Optional[float] = None, **args) -> None:
        """Record a point-in-time marker (retry/failover/crash/steal
        instants — events that are not a phase of any one span's life)."""
        t0 = time.perf_counter()
        ts = self.clock() if t is None else t
        with self._lock:
            self.events += 1
            self._instants.append(
                {"name": name, "service": service, "t": ts, "args": args}
            )
        self._charge(t0)

    def evicted(self, oid: int, t: Optional[float] = None) -> None:
        t0 = time.perf_counter()
        ts = self.clock() if t is None else t
        with self._lock:
            self.events += 1
            span = self._active.get(oid)
            if span is not None:
                self._finish(span, "evicted", ts)
        self._charge(t0)

    def dropped(self, oids: Iterable[int], reason: str = "error",
                t: Optional[float] = None) -> None:
        t0 = time.perf_counter()
        ts = self.clock() if t is None else t
        with self._lock:
            self.events += 1
            for oid in oids:
                span = self._active.get(oid)
                if span is not None:
                    span.origin = span.origin or reason
                    self._finish(span, "dropped", ts)
        self._charge(t0)

    def drop_active(self, reason: str = "drained",
                    t: Optional[float] = None) -> int:
        """Terminate every still-active span (hard drain, store reset, end
        of run) so the lifecycle invariant — exactly one terminal state per
        dispatched span — holds even through cancellation."""
        ts = self.clock() if t is None else t
        with self._lock:
            self.events += 1
            live = list(self._active.values())
            for span in live:
                self._finish(span, "dropped", ts)
        return len(live)

    # -- read side -----------------------------------------------------------

    def spans(self) -> list[PrefetchSpan]:
        with self._lock:
            return list(self._done) + list(self._active.values())

    def instants(self) -> list[dict]:
        with self._lock:
            return list(self._instants)

    def active_count(self) -> int:
        with self._lock:
            return len(self._active)

    def counts(self) -> dict:
        with self._lock:
            out: dict = {"active": len(self._active), "total": len(self._done) + len(self._active)}
            for span in self._done:
                key = f"outcome_{span.outcome}"
                out[key] = out.get(key, 0) + 1
            return out

    def reset(self) -> None:
        with self._lock:
            self._active.clear()
            self._done.clear()
            self._batch_ids = 0
            self._instants.clear()
            self.events = 0


def check_span_invariants(spans: Sequence[PrefetchSpan]) -> list[str]:
    """Lifecycle invariants the test suite (and CI) hold every run to.
    Returns human-readable violations (empty = pass):

      * every span is terminal with exactly one outcome from the vocabulary;
      * every *dispatched* prefetch span that loaded has the full phase
        chain (predicted <= dispatched <= claimed <= queued <= start <=
        done), monotone;
      * hits/partials carry non-negative hidden/stall attribution.
    """
    problems: list[str] = []
    for span in spans:
        label = f"oid={span.oid}/{span.kind}"
        if not span.terminal:
            problems.append(f"{label}: no terminal outcome")
            continue
        if span.outcome not in TERMINAL_OUTCOMES:
            problems.append(f"{label}: unknown outcome {span.outcome!r}")
        chain = [span.predicted_t, span.dispatched_t, span.claimed_t,
                 span.queued_t, span.load_start_t, span.load_done_t,
                 span.outcome_t]
        present = [t for t in chain if t is not None]
        if any(b < a - 1e-9 for a, b in zip(present, present[1:])):
            problems.append(f"{label}: non-monotone phase timestamps {present}")
        if span.kind == "prefetch" and span.load_done_t is not None \
                and span.outcome in ("hit", "partial") and span.claimed_t is None:
            problems.append(f"{label}: loaded+used span was never claimed")
        if span.hidden_s < 0 or span.stall_s < 0:
            problems.append(f"{label}: negative attribution "
                            f"hidden={span.hidden_s} stall={span.stall_s}")
    return problems
