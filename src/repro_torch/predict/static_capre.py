"""CAPre's code-analysis predictor behind the unified interface.

This is the paper's own strategy: everything is derived at registration
time (``core.hints`` builds PH_m, ``core.injection`` generates the prefetch
closures), so the runtime pays **no monitoring** — ``on_access`` is a no-op
and the only scheduling point is method entry, exactly the injected
``prefetchingExecutor.submit`` of Listing 5.

Online it preserves the historical ``Session(mode="capre")`` behavior
verbatim: the generated closure runs on the session's single-thread
background executor and fans collection hints out on the parallel pool.
Offline (no session) the same hint trees are expanded over the store
snapshot via ``peek`` so the replay harness gets the predicted oid set
without paying I/O.
"""

from __future__ import annotations

import time

from repro_torch.core import lang
from repro_torch.core.injection import _HintTree, build_hint_tree

from .base import Predictor, table_bytes


def iter_hint_tree(store, root_oid: int, tree: _HintTree, on_truncate=None):
    """Lazily yield ``(oid, hint_node)`` pairs a generated prefetch method
    would load for ``root_oid``, in traversal (= needed-at) order, over the
    current store contents without cost accounting.  Lazy matters online:
    the batch dispatcher streams segments off this iterator, so the head of
    a large subtree is already loading while the tail is still being
    expanded — expanding OO7's full design tree before dispatching anything
    made the application demand-miss every subtree's first objects.

    The static-optimizer annotations apply here exactly like in the
    generated closure: siblings expand in priority order, and a collection
    carrying a ``prefix_bound`` yields only its static prefix
    (``on_truncate(node)`` fires once per clipped expansion)."""
    stack: list[tuple[int, _HintTree]] = [(root_oid, tree)]
    while stack:
        oid, node = stack.pop()
        yield oid, node
        rec = store.peek(oid)
        pushes: list[tuple[int, _HintTree]] = []
        for child in node.ordered_children():
            ref = rec.fields.get(child.fld)
            if ref is None:
                continue
            if child.card == lang.COLLECTION:
                elems = list(ref)
                if (child.prefix_bound is not None
                        and len(elems) > child.prefix_bound):
                    elems = elems[: child.prefix_bound]
                    if on_truncate is not None:
                        on_truncate(child)
                pushes.extend((e, child) for e in elems)
            else:
                pushes.append((ref, child))
        stack.extend(reversed(pushes))


def expand_hint_tree(store, root_oid: int, tree: _HintTree) -> list[int]:
    """The oids a generated prefetch method would load for ``root_oid``
    (the eager spelling of ``iter_hint_tree``)."""
    return [oid for oid, _node in iter_hint_tree(store, root_oid, tree)]


class _CountingStore:
    """Thin store proxy charging every ``prefetch_access`` to a predictor's
    ``Overhead`` ledger — the generated prefetch closures cannot do it
    themselves."""

    def __init__(self, store, overhead, rfo_enabled=True, session_label=""):
        self._store = store
        self._overhead = overhead
        self._rfo_enabled = rfo_enabled
        self._session_label = session_label

    def prefetch_access(self, oid: int, rfo: bool = False):
        self._overhead.predictions += 1
        return self._store.prefetch_access(oid, rfo=rfo and self._rfo_enabled,
                                           session=self._session_label)

    def __getattr__(self, name):
        return getattr(self._store, name)


class StaticCapre(Predictor):
    """Hint-driven prefetching — zero runtime monitoring."""

    def __init__(self, config=None, hint_filter=None):
        super().__init__()
        self.config = config
        self.hint_filter = hint_filter  # optional predicate over Hint
        self._methods: dict[str, object] = {}
        self._trees: dict[str, _HintTree] = {}
        # (hint-node id, oid) pairs the batched dispatcher has already
        # expanded this session: recursive traversals (OO7's t1) re-enter
        # nested methods whose hint subtrees were fully expanded by an
        # ancestor's entry — re-expanding them emitted ~5x redundant
        # predictions that predispatch dedupe then threw away one by one
        self._dispatched: set[tuple[int, int]] = set()

    def attach(self, store, reg) -> None:
        super().attach(store, reg)
        if self.hint_filter is None:
            self._methods = dict(reg.prefetch_methods)
            hints = reg.report.hints
        else:
            from repro_torch.core.injection import generate_prefetch_method

            hints = {
                k: tuple(h for h in hs if self.hint_filter(h))
                for k, hs in reg.report.hints.items()
            }
            self._methods = {}
            for k, hs in hints.items():
                fn = generate_prefetch_method(hs)
                if fn is not None:
                    self._methods[k] = fn
        self._trees = {k: build_hint_tree(hs) for k, hs in hints.items() if hs}
        # the analysis is this strategy's entire training cost
        self.overhead.train_seconds += reg.analysis_time_s
        self.overhead.table_bytes = table_bytes(
            sum(len(hs) for hs in hints.values())
        )

    def on_method_entry(self, method_key: str, this_oid: int) -> list[int]:
        if self.session is not None:
            if self._dispatch_mode() == "batch":
                self._schedule_batched(method_key, this_oid)
                return []
            fn = self._methods.get(method_key)
            if fn is not None:
                # the generated closure is opaque: meter its prefetches
                # through a counting proxy so the online ledger is
                # comparable with the miners' (which count via _emit)
                store = _CountingStore(self.session.store, self.overhead,
                                       getattr(self.session.config, "rfo", True),
                                       getattr(self.session, "label", ""))
                runtime = self.session.runtime
                self.session.runtime.schedule(lambda: fn(store, runtime, this_oid))
            return []
        tree = self._trees.get(method_key)
        if tree is None:
            return []
        oids: list[int] = []
        rfo: set[int] = set()
        priorities: dict[int, float] = {}
        for oid, node in iter_hint_tree(self.store, this_oid, tree,
                                        on_truncate=self._note_truncation):
            oids.append(oid)
            if node.rfo:
                rfo.add(oid)
            if node.priority:
                priorities[oid] = node.priority
        return self._emit(oids, context=method_key,
                          rfo=frozenset(rfo), priorities=priorities)

    def _note_truncation(self, _node) -> None:
        self.overhead.truncated_hints += 1

    #: oids per streamed dispatch segment: large enough that executor
    #: submissions stay well below per-oid dispatch, small enough that a
    #: big subtree's head is loading while its tail is still being expanded
    SEGMENT = 64
    #: collection elements per parallel sub-expansion job — discovery of a
    #: large collection's subtrees spreads over the pool (the generated
    #: closure fans out per *element*; grouping keeps task counts an order
    #: of magnitude lower while matching its expansion parallelism)
    SUBTREE_GROUP = 16

    def _schedule_batched(self, method_key: str, this_oid: int) -> None:
        """Batched online dispatch: pool workers expand the hint tree over
        the store snapshot (pure metadata walk, no I/O — the same traversal
        the generated closure performs, so the oid set is identical) and
        stream need-ordered segments to ``prefetch_batch``: one deduped
        request per Data Service per segment instead of one pool task per
        object.  Two lessons from the wall-clock benches are baked in:
        jobs go to the parallel pool, not the single-thread scheduler
        (expansion for every method entry serialized on one thread falls
        behind a fast application — OO7's ~4k entries turned timely
        prefetches into demand misses), and large collections split into
        grouped sub-expansion jobs so discovery parallelism matches the
        per-oid closure's fan-out."""
        tree = self._trees.get(method_key)
        if tree is None:
            return
        self._submit_expansion([(this_oid, tree)], origin=f"capre:{method_key}")

    def _memo_active(self, store) -> bool:
        """Subtree dedupe is only sound while nothing can leave the cache:
        once a pair is dispatched it stays resident or in flight, so
        skipping its re-walk loses no coverage.  Under a bounded capacity
        (or a shared budget) an evicted prefetch must be re-dispatchable —
        the per-oid path re-issues it and the virtual replay re-schedules
        it — so the memo switches off to keep all three semantics
        aligned."""
        return store.budget is None and all(
            ds.cache_capacity == 0 for ds in store.services
        )

    def _submit_expansion(self, roots, origin: str = "capre") -> None:
        store, runtime = self.session.store, self.session.runtime
        rfo_enabled = getattr(self.session.config, "rfo", True)
        label = getattr(self.session, "label", "")

        dispatched = self._dispatched if self._memo_active(store) else None

        def expand_job() -> None:
            seg: list[int] = []
            seg_rfo: set[int] = set()
            seg_prio: dict[int, float] = {}

            def flush() -> None:
                if seg:
                    self.overhead.predictions += len(seg)
                    store.prefetch_batch(seg, runtime=runtime, origin=origin,
                                         rfo=frozenset(seg_rfo),
                                         priorities=dict(seg_prio) or None,
                                         session=label)
                    seg.clear()
                    seg_rfo.clear()
                    seg_prio.clear()

            stack = list(reversed(roots))
            while stack:
                oid, node = stack.pop()
                # dedupe against already-dispatched work at subtree
                # granularity: this exact (hint node, oid) pair was fully
                # expanded by an earlier entry, so its whole subtree is
                # already requested (the emitted SET is unchanged — only
                # the redundant re-walk is skipped).  Sound because an
                # expansion never truncates past its own static bound:
                # reaching a pair means its (bounded) subtree under that
                # node was pushed in the same pass.
                if dispatched is not None:
                    key = (id(node), oid)
                    if key in dispatched:
                        continue
                    dispatched.add(key)
                seg.append(oid)
                if rfo_enabled and node.rfo:
                    seg_rfo.add(oid)
                if node.priority:
                    seg_prio[oid] = node.priority
                if len(seg) >= self.SEGMENT:
                    flush()
                    time.sleep(0)  # yield the GIL between segments
                rec = store.peek(oid)
                pushes = []
                for child in node.ordered_children():
                    ref = rec.fields.get(child.fld)
                    if ref is None:
                        continue
                    if child.card == lang.COLLECTION:
                        elems = list(ref)
                        if (child.prefix_bound is not None
                                and len(elems) > child.prefix_bound):
                            # partial-traversal truncation: the loop behind
                            # this hint provably exits early — expand only
                            # the static prefix
                            elems = elems[: child.prefix_bound]
                            self.overhead.truncated_hints += 1
                        if len(elems) > self.SUBTREE_GROUP:
                            for i in range(0, len(elems), self.SUBTREE_GROUP):
                                self._submit_expansion(
                                    [(e, child) for e in elems[i:i + self.SUBTREE_GROUP]],
                                    origin=origin,
                                )
                            continue
                        pushes.extend((e, child) for e in elems)
                    else:
                        pushes.append((ref, child))
                stack.extend(reversed(pushes))
            flush()

        runtime.submit(expand_job)
