"""Prefetching-hint generation (paper sections 4.3 and 5.1.3).

``PH_m`` is obtained by traversing the augmented method type graph ``AG_m``
from the receiver root (``this``): each maximal root-to-leaf navigation path
``f1.f2.....fn`` is one prefetching hint; hints whose first step is a
collection predict that *all its elements* are accessed.

Two policies for runtime-dependent behavior (section 4.4):

  * ``include`` (CAPre's implementation choice): branch-dependent navigations
    are included — the union of all branches is prefetched;
  * ``exclude``: subtrees below the first branch-dependent navigation are
    dropped (reproduces the conservative PH_m printed in section 4.3).

Finally, the all-callers deduplication of section 5.1.3: a hint of ``m`` is
removed when every method that invokes ``m`` already prefetches the same
objects (its own hint set covers the grafted copy), which "brings the
prefetching forward" while keeping accuracy unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from . import lang
from .type_graph import (
    CAPreAnalysis,
    EXCLUDE_BRANCH_DEPENDENT,
    INCLUDE_BRANCH_DEPENDENT,
    MethodGraph,
    Node,
)

Steps = tuple[tuple[str, str], ...]


@dataclass(frozen=True)
class Hint:
    steps: Steps
    # -- static-optimizer annotations (core.opt) ---------------------------
    # All compare=False: hint identity, eq/hash, the all-callers dedup and
    # the replay trace-cache fingerprint stay steps-only — the optimizer
    # decorates hints, it never changes which hints exist.
    #: step indices whose navigated-to object is a known update site — the
    #: prefetch of that object should be read-for-ownership (dirty-allocate)
    rfo_depths: tuple[int, ...] = field(default=(), compare=False)
    #: partial-traversal truncation: at step ``trunc_step`` (a collection),
    #: only the first ``prefix_bound`` elements are predicted
    prefix_bound: Optional[int] = field(default=None, compare=False)
    trunc_step: Optional[int] = field(default=None, compare=False)
    #: static priority from the cost model (higher = dispatch sooner)
    priority: float = field(default=0.0, compare=False)

    def __str__(self) -> str:
        return ".".join(f + ("[]" if c == lang.COLLECTION else "") for f, c in self.steps)

    __repr__ = __str__

    @property
    def has_collection(self) -> bool:
        return any(c == lang.COLLECTION for _f, c in self.steps)

    @property
    def rfo(self) -> bool:
        return bool(self.rfo_depths)

    @property
    def truncated(self) -> bool:
        return self.prefix_bound is not None


def _included_nodes(g: MethodGraph, policy: str):
    """DFS over this-rooted nodes honoring the branch policy; yields
    (node, steps) where ``steps`` is the full path from the root to ``node``
    (inclusive)."""
    stack: list[tuple[Node, Steps]] = [(g.this_root, ())]
    while stack:
        node, steps = stack.pop()
        if node.parent is not None:
            if policy == EXCLUDE_BRANCH_DEPENDENT and node.branch_dependent:
                continue
            yield node, steps
        for child in node.children.values():
            stack.append((child, steps + ((child.field, child.card),)))


def method_paths(g: MethodGraph, policy: str) -> set[Steps]:
    """Prefix-closed set of this-rooted navigation paths under ``policy``."""
    return {steps for _node, steps in _included_nodes(g, policy)}


def method_hints(g: MethodGraph, policy: str) -> tuple[Hint, ...]:
    """PH_m: maximal this-rooted paths (leaves of the included subgraph)."""
    paths = method_paths(g, policy)
    leaves = [p for p in paths if not any(q != p and q[: len(p)] == p for q in paths)]
    return tuple(Hint(p) for p in sorted(leaves, key=str))


@dataclass
class AnalysisReport:
    app_name: str
    policy: str
    graphs: dict[str, MethodGraph]
    full_hints: dict[str, tuple[Hint, ...]]  # PH_m before caller dedup
    hints: dict[str, tuple[Hint, ...]]  # PH_m after caller dedup (section 5.1.3)
    stats: "CorpusStats" = None
    opt: object = None  # core.opt.OptStats once the optimizer has run

    def hints_str(self, key: str) -> set[str]:
        return {str(h) for h in self.hints[key]}

    def full_hints_str(self, key: str) -> set[str]:
        return {str(h) for h in self.full_hints[key]}


@dataclass
class CorpusStats:
    """Reproduces the aggregates of section 4.4 (Table 2)."""

    n_methods: int = 0
    n_methods_no_bd: int = 0
    n_conditionals: int = 0
    n_conditionals_no_bd: int = 0
    n_loops: int = 0
    n_loops_no_bd: int = 0
    n_classes: int = 0

    @property
    def pct_methods_no_bd(self) -> float:
        return 100.0 * self.n_methods_no_bd / max(1, self.n_methods)

    @property
    def pct_conditionals_no_bd(self) -> float:
        return 100.0 * self.n_conditionals_no_bd / max(1, self.n_conditionals)

    @property
    def pct_loops_no_bd(self) -> float:
        return 100.0 * self.n_loops_no_bd / max(1, self.n_loops)


def generate(analysis: CAPreAnalysis, policy: str = INCLUDE_BRANCH_DEPENDENT) -> AnalysisReport:
    graphs = analysis.analyze_all()
    full = {k: method_hints(g, policy) for k, g in graphs.items()}
    paths = {k: method_paths(g, policy) for k, g in graphs.items()}

    final: dict[str, tuple[Hint, ...]] = {}
    for key, hints in full.items():
        final[key] = _dedup_against_callers(analysis, graphs, paths, key, hints)

    stats = CorpusStats(n_classes=len(analysis.app.classes))
    for g in graphs.values():
        stats.n_methods += 1
        stats.n_methods_no_bd += 0 if g.has_branch_dependent() else 1
        stats.n_conditionals += g.n_conditionals
        stats.n_conditionals_no_bd += g.n_conditionals - g.conds_with_bd
        stats.n_loops += g.n_loops
        stats.n_loops_no_bd += g.n_loops - g.loops_with_bd

    return AnalysisReport(
        app_name=analysis.app.name,
        policy=policy,
        graphs=graphs,
        full_hints=full,
        hints=final,
        stats=stats,
    )


def _dedup_against_callers(
    analysis: CAPreAnalysis,
    graphs: dict[str, MethodGraph],
    paths: dict[str, set[Steps]],
    key: str,
    hints: tuple[Hint, ...],
) -> tuple[Hint, ...]:
    """Remove hints found in *all* of the methods that invoke ``key``.

    A caller covers hint ``h`` when some invocation site grafted the callee's
    graph onto a this-rooted receiver whose path prefixed with ``h`` is a path
    the caller itself prefetches."""
    sites = analysis.call_sites.get(key, [])
    if not sites or not hints:
        return hints
    callers = sorted({s.caller for s in sites})
    kept: list[Hint] = []
    for h in hints:
        covered_by_all = True
        for caller in callers:
            caller_graph = graphs.get(caller)
            caller_paths = paths.get(caller, set())
            covered = False
            for s in sites:
                if s.caller != caller or not s.grafted or s.receiver is None:
                    continue
                if caller_graph is None or s.receiver.root() is not caller_graph.this_root:
                    continue
                if s.receiver.path() + h.steps in caller_paths:
                    covered = True
                    break
            if not covered:
                covered_by_all = False
                break
        if not covered_by_all:
            kept.append(h)
    return tuple(kept)


def analyze_application(
    app: lang.Application, policy: str = INCLUDE_BRANCH_DEPENDENT,
    optimize: bool = True,
) -> AnalysisReport:
    """One-call entry point: lower, run Algorithm 1 on every method, generate
    deduplicated prefetching hints, and (unless ``optimize=False``) run the
    static optimizer passes (core.opt) that annotate each hint with RFO
    depths, partial-traversal bounds and a dispatch priority."""
    report = generate(CAPreAnalysis(app), policy)
    if optimize:
        from .opt import optimize_report  # lazy: opt imports this module

        optimize_report(report, app=app)
    return report
