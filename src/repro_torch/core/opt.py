"""Static hint optimizer — multi-pass post-processing of the Algorithm-1
analysis output (DESIGN.md section 3.9).

CAPre's raw ``PH_m`` knows *which* objects a method navigates but throws
away three things the rest of the stack needs, all statically derivable
from the same augmented type graphs:

  * **Pass 1 — interprocedural write-set analysis.**  ``type_graph``
    records a ``write_occurrences`` set per node (every ``putfield`` whose
    receiver is that object, propagated through call grafting exactly like
    read occurrences).  This pass projects those marks onto each hint as
    ``rfo_depths``: the step indices whose target object is a known update
    site.  The prefetch path dirty-allocates those lines (read-for-
    ownership) so the later write is a pure hit instead of an ownership
    upgrade / write-allocate miss.

  * **Pass 2 — partial-traversal truncation.**  A collection navigation
    whose *every* occurrence is loop-tainted sits only inside loops that
    provably exit early (break / continue / return — the same taint
    Algorithm 1 computes for branch-dependence).  Predicting "all
    elements" for such a loop floods the cache with objects the method
    never reads; the pass marks the first such collection step with a
    static ``prefix_bound`` (:data:`DEFAULT_PREFIX_BOUND`) so dispatch
    stops after a bounded prefix.

  * **Pass 3 — static cost / priority model.**  Expected fan-out from
    schema cardinalities (:data:`DEFAULT_COLLECTION_FANOUT` per unbounded
    collection step, the prefix bound for truncated ones) gives each hint
    an expected object count; priority is its inverse on a log scale —
    cheap shallow hints are demanded soonest and finish fastest, so
    ``ObjectStore.prefetch_batch`` dispatches them first and
    ``PrefetchRuntime`` can shed the expensive tail under load (the
    multi-tenant admission-control signal).

Pass 4 — the verifier — lives in :mod:`repro_torch.core.lint`.

Annotations ride the existing frozen :class:`~repro_torch.core.hints.Hint` as
``compare=False`` fields, so hint identity (eq/hash, the all-callers
dedup, the replay trace-cache fingerprint) is untouched: the optimizer
decorates hints, it never changes which hints exist.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Optional

from . import lang
from .hints import AnalysisReport, Hint, Steps, _included_nodes
from .type_graph import MethodGraph, Node

#: elements predicted for a provably-partial collection traversal
DEFAULT_PREFIX_BOUND = 8

#: assumed elements per unbounded collection step (the schema carries
#: cardinality *kind*, not counts; this is the cost model's population
#: guess, deliberately round and documented rather than fitted)
DEFAULT_COLLECTION_FANOUT = 16


@dataclass
class OptStats:
    """Per-application summary of what the optimizer passes did."""

    methods: int = 0
    hints: int = 0
    rfo_hints: int = 0  # hints carrying >= 1 RFO step
    truncated_hints: int = 0  # hints carrying a prefix bound
    prefix_bound: int = DEFAULT_PREFIX_BOUND
    mean_priority: float = 0.0

    def snapshot(self) -> dict:
        return dict(self.__dict__)


def hint_cost(steps: Steps, prefix_bound: Optional[int] = None,
              trunc_step: Optional[int] = None,
              fanout: int = DEFAULT_COLLECTION_FANOUT) -> float:
    """Expected number of objects a full expansion of ``steps`` loads:
    collection steps multiply the live frontier by their expected width,
    every step adds the frontier to the total."""
    total, frontier = 0.0, 1.0
    for i, (_fld, card) in enumerate(steps):
        if card == lang.COLLECTION:
            width = prefix_bound if (trunc_step == i and prefix_bound) else fanout
            frontier *= width
        total += frontier
    return total


def hint_priority(cost: float) -> float:
    """Dispatch priority in (0, 1]: inverse log cost, so a depth-1 single
    association scores ~1.0 and a nested-collection flood scores near 0.
    Rounded so golden artifacts are stable across platforms."""
    return round(1.0 / (1.0 + math.log2(1.0 + cost)), 4)


def _node_for(g: MethodGraph, policy: str) -> dict[Steps, Node]:
    return {steps: node for node, steps in _included_nodes(g, policy)}


def _truncation(nodes: dict[Steps, Node], steps: Steps,
                bound: int) -> tuple[Optional[int], Optional[int]]:
    """First collection step whose every occurrence is loop-tainted (the
    loop provably exits early) -> (trunc_step, prefix_bound)."""
    for i in range(len(steps)):
        _fld, card = steps[i]
        if card != lang.COLLECTION:
            continue
        node = nodes.get(steps[: i + 1])
        if node is None or not node.occurrences:
            continue
        if all(tainted for _bp, tainted in node.occurrences):
            return i, bound
    return None, None


def annotate_hint(nodes: dict[Steps, Node], h: Hint,
                  bound: int = DEFAULT_PREFIX_BOUND,
                  fanout: int = DEFAULT_COLLECTION_FANOUT) -> Hint:
    """All three passes for one hint against its method's node map."""
    rfo_depths = tuple(
        i for i in range(len(h.steps))
        if (n := nodes.get(h.steps[: i + 1])) is not None and n.written
    )
    trunc_step, prefix_bound = _truncation(nodes, h.steps, bound)
    cost = hint_cost(h.steps, prefix_bound=prefix_bound,
                     trunc_step=trunc_step, fanout=fanout)
    return replace(
        h,
        rfo_depths=rfo_depths,
        prefix_bound=prefix_bound,
        trunc_step=trunc_step,
        priority=hint_priority(cost),
    )


def optimize_report(report: AnalysisReport, app=None,
                    bound: int = DEFAULT_PREFIX_BOUND,
                    fanout: int = DEFAULT_COLLECTION_FANOUT) -> OptStats:
    """Run passes 1–3 over every method's hints (both the raw ``full_hints``
    and the deduplicated ``hints``), rewriting the report in place with
    annotated hints and recording an :class:`OptStats` on ``report.opt``."""
    stats = OptStats(prefix_bound=bound)
    node_maps = {
        key: _node_for(g, report.policy) for key, g in report.graphs.items()
    }
    for table in (report.full_hints, report.hints):
        for key, hints in table.items():
            nodes = node_maps.get(key, {})
            table[key] = tuple(
                annotate_hint(nodes, h, bound=bound, fanout=fanout) for h in hints
            )
    priorities = []
    for key, hints in report.hints.items():
        stats.methods += 1
        for h in hints:
            stats.hints += 1
            stats.rfo_hints += 1 if h.rfo else 0
            stats.truncated_hints += 1 if h.truncated else 0
            priorities.append(h.priority)
    stats.mean_priority = round(
        sum(priorities) / len(priorities), 4) if priorities else 0.0
    report.opt = stats
    return stats
