"""Trace-mined sequence predictor — the monitoring-based baseline.

Palpatine-style (PAPERS.md): mine frequent access sequences from recorded
``ObjectStore.trace``s into an order-k Markov table (context of up to the
last k accessed oids -> successor counts), then at runtime predict the
most likely continuation of the current access history and prefetch it.

This is exactly the regime the paper argues against, so its costs are
charged honestly on the ``Overhead`` ledger:

  * **memory** — the mined table is bounded (``table_capacity`` contexts);
    once full, new contexts are dropped (existing ones keep counting), and
    the resident size is reported as ``overhead.table_bytes``;
  * **CPU** — every application-path access is observed
    (``overhead.monitor_events``), each paying history-update + table
    lookups on the application thread.

Prediction: back-off from order k to order 1 until a context with
sufficiently confident successors is found; then greedily follow the top
successor chain up to ``chain`` steps (sequence prefetch, not just the
next object).
"""

from __future__ import annotations

import time
from collections import Counter, deque
from typing import Optional, Sequence

from repro_torch.pos.trace import trace_oids

from .base import Predictor, table_bytes


class MarkovMiner(Predictor):
    def __init__(self, config=None, *, order: Optional[int] = None,
                 confidence: Optional[float] = None,
                 table_capacity: Optional[int] = None,
                 fanout: Optional[int] = None, chain: Optional[int] = None):
        super().__init__()

        def cfg(attr, override, default):
            if override is not None:
                return override
            return getattr(config, attr, default) if config is not None else default

        self.order = cfg("markov_order", order, 2)
        self.confidence = cfg("markov_confidence", confidence, 0.25)
        self.table_capacity = cfg("markov_table_capacity", table_capacity, 65536)
        self.fanout = cfg("markov_fanout", fanout, 8)
        self.chain = cfg("markov_chain", chain, 4)
        self._table: dict[tuple[int, ...], Counter] = {}
        self._history: deque[int] = deque(maxlen=self.order)
        self._issued: set[int] = set()
        self._dropped_contexts = 0

    # -- mining -------------------------------------------------------------

    def warm(self, trace: Sequence) -> None:
        t0 = time.perf_counter()
        # schema-v2 event traces carry writes and method entries; the miner
        # trains on the demand-path oid sequence (reads AND writes — the
        # Palpatine regime mines full get/put streams).  Bare-oid lists
        # pass through unchanged.
        trace = trace_oids(trace)
        for i in range(1, len(trace)):
            succ = trace[i]
            lo = max(0, i - self.order)
            for j in range(lo, i):
                ctx = tuple(trace[j:i])
                counts = self._table.get(ctx)
                if counts is None:
                    if len(self._table) >= self.table_capacity:
                        self._dropped_contexts += 1
                        continue
                    counts = self._table[ctx] = Counter()
                counts[succ] += 1
        self.overhead.train_seconds += time.perf_counter() - t0
        n_slots = len(self._table) + sum(len(c) for c in self._table.values())
        self.overhead.table_bytes = table_bytes(n_slots)

    # -- prediction ----------------------------------------------------------

    def _successors(self, ctx: tuple[int, ...]) -> list[int]:
        counts = self._table.get(ctx)
        if not counts:
            return []
        total = sum(counts.values())
        return [
            succ
            for succ, c in counts.most_common(self.fanout)
            if c / total >= self.confidence
        ]

    def _backoff(self, walk: Sequence[int]) -> list[int]:
        for k in range(min(self.order, len(walk)), 0, -1):
            nxt = self._successors(tuple(walk[-k:]))
            if nxt:
                return nxt
        return []

    def predict_next(self, history: Sequence[int]) -> list[int]:
        """Back-off prediction + greedy chain following: predict the likely
        immediate successors of ``history``, then extend the single most
        likely continuation up to ``chain`` more steps."""
        preds: list[int] = []
        seen: set[int] = set()
        for o in self._backoff(list(history)):
            if o not in seen:
                preds.append(o)
                seen.add(o)
        if preds:
            walk = list(history) + [preds[0]]
            for _ in range(self.chain):
                nxt = self._backoff(walk)
                if not nxt or nxt[0] in seen:
                    break
                preds.append(nxt[0])
                seen.add(nxt[0])
                walk.append(nxt[0])
        return preds

    # -- runtime hooks ---------------------------------------------------------

    def bind(self, session) -> None:
        super().bind(session)
        self._listen(session.store, "access_listener", lambda oid: self.on_access(oid, None))
        if session.config is not None and session.config.warm_trace:
            self.warm(session.config.warm_trace)

    def on_access(self, oid: int, cls: Optional[str]) -> list[int]:
        self.overhead.monitor_events += 1
        self._history.append(oid)
        preds = [
            o for o in self.predict_next(self._history) if o not in self._issued
        ]
        self._issued.update(preds)
        return self._emit(preds, context=f"access-{oid}")
