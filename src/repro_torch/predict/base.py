"""The unified prediction interface (DESIGN.md section 3).

CAPre's argument (paper sections 1-2) is a three-way comparison:

  * **schema-based** prediction (ROP) — cheap but rigid: the same expansion
    regardless of the running code;
  * **monitoring-based** prediction (Palpatine-style sequence mining) —
    adaptive but pays a *runtime overhead*: every access is observed, and
    the mined tables occupy memory;
  * **code-analysis-based** prediction (CAPre) — derived entirely at
    registration time, zero runtime monitoring.

The repo originally hard-wired the first and third into ``pos.client`` and
``runtime.prefetch``; this module defines the common ``Predictor`` surface
that all strategies implement so they can be compared head-to-head, and an
``Overhead`` ledger so the memory/CPU cost the paper attributes to the
monitoring family is *measured*, not asserted.

A predictor serves two hosts:

  * **online** — bound to a live ``pos.client.Session``: it installs the
    store hooks it needs (``miss_listener`` for ROP, ``access_listener``
    for the miners) and schedules real ``prefetch_access`` work on the
    session's background runtime;
  * **offline** — driven by ``predict.evaluate`` replaying a recorded
    trace: the same ``on_access``/``on_method_entry`` entry points return
    the predicted oids instead of scheduling loads, so precision/recall
    can be computed without a store in the loop.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Optional, Sequence

# Rough per-entry cost of a Python dict slot holding small ints; used to
# charge mined tables a realistic resident size (the paper's "memory
# overhead to store data structures of monitored accesses").
_TABLE_ENTRY_BYTES = 96


@dataclass
class Overhead:
    """The runtime cost a prediction strategy pays (beyond the prefetch
    I/O itself, which every strategy pays and the store already meters)."""

    table_bytes: int = 0  # resident size of mined/derived tables
    monitor_events: int = 0  # accesses observed at runtime (monitoring tax)
    train_seconds: float = 0.0  # offline mining / analysis wall time
    predictions: int = 0  # oids emitted (prefetch pressure)
    # timeliness (filled by the virtual-clock replay engine): a prediction
    # only helps if its load *completes* before the access needs it
    late_predictions: int = 0  # predicted, but load still in flight (or queued) at need
    evicted_before_use: int = 0  # prefetched loads evicted before any access
    hidden_seconds: float = 0.0  # disk seconds removed from the app critical path
    protected_evictions: int = 0  # evictions where the policy spared a pending prefetch
    # dispatch accounting (filled by the replay engine; the live store keeps
    # the same pair per Data Service): how many executor submissions the
    # prediction stream cost, and how many requested oids were suppressed
    # before submission because they were already cached / in flight
    batch_dispatches: int = 0
    dedup_suppressed: int = 0
    # static-optimizer accounting (core.opt annotations): prefetches issued
    # read-for-ownership (dirty-allocated ahead of a known update site), and
    # collection expansions clipped to their static prefix bound
    rfo_prefetches: int = 0
    truncated_hints: int = 0
    # instrumentation self-accounting (repro_torch.obs): what the observability
    # layer itself cost this run — charged here so CAPre's zero-overhead
    # claim stays falsifiable *with the instruments attached*
    obs_seconds: float = 0.0
    obs_events: int = 0

    def snapshot(self) -> dict:
        return dict(self.__dict__)


def table_bytes(n_entries: int, entry_bytes: int = _TABLE_ENTRY_BYTES) -> int:
    return n_entries * entry_bytes


class Predictor:
    """Base class for all prefetch predictors.

    Lifecycle: construct -> (optionally) ``warm(trace)`` -> either
    ``bind(session)`` for online use or plain ``on_*`` calls for offline
    replay.  Subclasses override the ``on_*`` hooks; both must be
    side-effect-free when ``self.session is None`` (offline mode) and may
    schedule real prefetches when bound.
    """

    #: registry name (set by the @register decorator)
    name: str = "?"

    def __init__(self) -> None:
        self.session = None  # live pos.client.Session when bound
        self.store = None  # ObjectStore (bound or attached for replay)
        self.reg = None  # pos.client.RegisteredApp (schema + analysis)
        self.overhead = Overhead()
        self._installed_listeners: list[tuple[str, object]] = []
        # offline emission metadata (static-optimizer signals) accumulated
        # by _emit between take_emission_meta() calls — the replay harness
        # reads it so the virtual clock sees the same rfo/priority stream
        # the live dispatch path gets
        self._pending_rfo: set[int] = set()
        self._pending_priorities: dict[int, float] = {}

    # -- lifecycle ---------------------------------------------------------

    def warm(self, trace: Sequence) -> None:
        """Consume a recorded trace (``ObjectStore.trace``: schema-v2
        ``TraceEvent`` records, or a legacy bare-oid list) before prediction
        starts.  Static strategies ignore it; trace miners build their
        tables here and charge ``overhead.train_seconds`` /
        ``overhead.table_bytes``."""

    def attach(self, store, reg) -> None:
        """Give the predictor its schema/analysis context without a live
        session — what the offline replay harness uses.  Subclasses build
        their derived structures here."""
        self.store = store
        self.reg = reg

    def bind(self, session) -> None:
        """Attach to a live Session: install whatever store listeners this
        strategy needs.  The default installs nothing."""
        self.session = session
        self.attach(session.store, session.reg)

    def _listen(self, store, attr: str, fn) -> None:
        """Install a store listener and remember it as ours, so unbind can
        remove exactly what this predictor installed — and nothing another
        session's predictor owns.  The callable is tagged with its owning
        predictor so ``Session.close`` can refuse to resurrect a hook whose
        predictor has since unbound (``fn`` must accept attributes — pass a
        lambda, not a bound method)."""
        fn.predictor = self
        setattr(store, attr, fn)
        self._installed_listeners.append((attr, fn))

    def unbind(self) -> None:
        """Detach from the session (Session.close): remove only the
        listeners this predictor installed (if still in place — a later
        session may have legitimately replaced them)."""
        if self.session is not None:
            store = self.session.store
            for attr, fn in self._installed_listeners:
                if getattr(store, attr) is fn:
                    setattr(store, attr, None)
        self._installed_listeners = []
        self.session = None

    # -- prediction entry points ------------------------------------------

    def on_method_entry(self, method_key: str, this_oid: int) -> list[int]:
        """Called when the application enters a registered method (the
        paper's injected scheduling point).  Returns the oids predicted at
        this point; when bound, also schedules their prefetch."""
        return []

    def on_access(self, oid: int, cls: str) -> list[int]:
        """Called on every application-path object access (the monitoring
        hook).  Returns the oids predicted to be accessed next; when
        bound, also schedules their prefetch."""
        return []

    def on_write(self, oid: int, cls: str) -> list[int]:
        """Called on every application-path field update.  Writes are
        demand accesses (write-allocate), so by default they feed the same
        monitoring hook as reads — Palpatine-style miners observe the full
        get/put stream.  Override to treat updates differently."""
        return self.on_access(oid, cls)

    def on_miss(self, oid: int) -> list[int]:
        """Called on application-path cache misses only (the ROP hook)."""
        return []

    # -- shared helpers ----------------------------------------------------

    def _dispatch_mode(self) -> str:
        """The bound session's dispatch granularity ("batch" unless the
        session opted into the legacy per-oid fan-out)."""
        cfg = self.session.config if self.session is not None else None
        return getattr(cfg, "dispatch", "batch")

    def _emit(self, oids: Iterable[int], context: str = "",
              rfo: frozenset = frozenset(),
              priorities: Optional[dict] = None) -> list[int]:
        """Account predictions; when bound, dispatch their loads on the
        session's background runtime — batched per Data Service by default,
        or one pool task per oid in "per-oid" mode.  ``context`` names the
        point in the program that triggered the prediction (method key /
        hint node); spans carry it as ``origin = "<predictor>:<context>"``.

        ``rfo`` oids dirty-allocate on landing and ``priorities``
        (oid -> static dispatch priority) orders/gates batched dispatch —
        the static-optimizer signals (core.opt).  Offline (no session) the
        metadata accumulates for ``take_emission_meta``."""
        out = [o for o in oids]
        self.overhead.predictions += len(out)
        if not out:
            return out
        if self.session is None:
            self._pending_rfo.update(rfo)
            if priorities:
                self._pending_priorities.update(priorities)
            return out
        cfg = self.session.config
        if not getattr(cfg, "rfo", True):
            rfo = frozenset()
        store = self.session.store
        origin = f"{self.name}:{context}" if context else self.name
        # per-call span attribution: the session's label travels with every
        # dispatch instead of living on shared tracer state, so concurrent
        # tenants' spans interleave correctly
        label = getattr(self.session, "label", "")
        if self._dispatch_mode() == "batch":
            store.prefetch_batch(out, runtime=self.session.runtime,
                                 origin=origin, rfo=rfo,
                                 priorities=priorities or None,
                                 session=label)
        else:
            self.session.runtime.fan_out(
                lambda oid: store.prefetch_access(oid, origin=origin,
                                                  rfo=oid in rfo,
                                                  session=label), out
            )
        return out

    def take_emission_meta(self) -> tuple[frozenset, dict]:
        """Drain the static-optimizer metadata accumulated by offline
        ``_emit`` calls since the last drain: ``(rfo_oids, priorities)``.
        The replay harness calls this after each ``on_*`` hook so the
        virtual dispatch sees the same signals the live path gets."""
        rfo = frozenset(self._pending_rfo)
        priorities = dict(self._pending_priorities)
        self._pending_rfo.clear()
        self._pending_priorities.clear()
        return rfo, priorities
