"""Hybrid static + trace-mined predictor (GrASP-style, see PAPERS.md).

GrASP's observation is that static structure and learned history are
complementary: schema/code analysis is exact about *bulk* structure
(collections — where mis-prediction is most expensive and monitoring is
least informative, since element order varies), while learned predictors
shine on *branch-dependent* single navigations that static analysis must
either over-approximate (include policy) or drop (exclude policy).

So the hybrid splits the hint space:

  * **static part** — CAPre hints that traverse a collection are kept and
    scheduled at method entry exactly like ``static-capre`` (the injected
    closure, parallel fan-out over distributed collections);
  * **learned part** — everything else (single-association chains,
    branch-dependent navigations) is left to an order-k ``MarkovMiner``
    driven by the access listener.

Overhead is the sum of both parts — i.e. it pays the miner's monitoring
tax only for the single-association share of the workload.
"""

from __future__ import annotations

from typing import Optional, Sequence

from .base import Overhead, Predictor
from .markov import MarkovMiner
from .static_capre import StaticCapre


class Hybrid(Predictor):
    def __init__(self, config=None):
        super().__init__()
        self.config = config
        self.static = StaticCapre(config, hint_filter=lambda h: h.has_collection)
        self.miner = MarkovMiner(config)

    # -- lifecycle ----------------------------------------------------------

    def warm(self, trace: Sequence[int]) -> None:
        self.miner.warm(trace)

    def attach(self, store, reg) -> None:
        super().attach(store, reg)
        self.static.attach(store, reg)
        self.miner.store = store
        self.miner.reg = reg

    def bind(self, session) -> None:
        Predictor.bind(self, session)
        self.static.session = session
        self.miner.session = session
        self._listen(session.store, "access_listener", lambda oid: self.on_access(oid, None))
        if session.config is not None and session.config.warm_trace:
            self.miner.warm(session.config.warm_trace)

    def unbind(self) -> None:
        self.static.session = None
        self.miner.session = None
        super().unbind()

    # -- prediction ----------------------------------------------------------

    def on_method_entry(self, method_key: str, this_oid: int) -> list[int]:
        return self.static.on_method_entry(method_key, this_oid)

    def on_access(self, oid: int, cls: Optional[str]) -> list[int]:
        return self.miner.on_access(oid, cls)

    # -- accounting ------------------------------------------------------------

    @property
    def overhead(self) -> Overhead:  # type: ignore[override]
        s, m = self.static.overhead, self.miner.overhead
        return Overhead(
            table_bytes=s.table_bytes + m.table_bytes,
            monitor_events=s.monitor_events + m.monitor_events,
            train_seconds=s.train_seconds + m.train_seconds,
            predictions=s.predictions + m.predictions,
            late_predictions=s.late_predictions + m.late_predictions,
            evicted_before_use=s.evicted_before_use + m.evicted_before_use,
            hidden_seconds=s.hidden_seconds + m.hidden_seconds,
            protected_evictions=s.protected_evictions + m.protected_evictions,
            batch_dispatches=s.batch_dispatches + m.batch_dispatches,
            dedup_suppressed=s.dedup_suppressed + m.dedup_suppressed,
        )

    @overhead.setter
    def overhead(self, value: Overhead) -> None:
        # base __init__ assigns a fresh ledger; the hybrid's ledger is
        # derived from its parts, so the assignment is a no-op
        pass
