"""Source-code generation & injection component (paper section 5.2).

For every analyzed method CAPre generates a helper prefetching method that
loads the objects predicted by its hints, and injects a scheduling of that
helper at the beginning of the method.  Here the "generated source" is a
closure over the hint tree; the "injection" is performed by the interpreter,
which schedules the closure on the background executor on method entry —
exactly the behavior of the injected ``prefetchingExecutor.submit`` of
Listing 5.

Hints sharing a prefix are merged into a tree so, like the generated code of
Listing 4, a collection is iterated once and every per-element navigation
happens inside the same parallel fan-out.  The static-optimizer annotations
(core.opt) ride the tree nodes: ``rfo`` nodes are loaded read-for-ownership
(dirty-allocated ahead of their known update site), ``prefix_bound`` nodes
expand only a bounded prefix of their collection, and ``priority`` orders
sibling expansion most-valuable-first.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core import lang
from repro_torch.core.hints import Hint


@dataclass
class _HintTree:
    fld: Optional[str] = None
    card: str = lang.SINGLE
    children: dict[str, "_HintTree"] = field(default_factory=dict)
    # static-optimizer annotations (core.opt), merged across the hints that
    # traverse this node:
    rfo: bool = False  # the object reached by this step is a known update site
    prefix_bound: Optional[int] = None  # partial traversal: expand first N only
    priority: float = 0.0  # max dispatch priority of the hints through here

    def ordered_children(self) -> list["_HintTree"]:
        """Children by descending priority (stable on field name): cheap,
        soon-demanded subtrees dispatch before expensive floods."""
        return sorted(self.children.values(),
                      key=lambda c: (-c.priority, c.fld or ""))


def build_hint_tree(hints: tuple[Hint, ...]) -> _HintTree:
    root = _HintTree()
    visited: set[int] = set()
    for h in hints:
        node = root
        for i, (fld, card) in enumerate(h.steps):
            nxt = node.children.get(fld)
            if nxt is None:
                nxt = _HintTree(fld=fld, card=card)
                node.children[fld] = nxt
            nxt.rfo = nxt.rfo or (i in h.rfo_depths)
            nxt.priority = max(nxt.priority, h.priority)
            # a node stays bounded only while EVERY hint traversing it is
            # truncated there — one full-traversal hint through the same
            # collection makes the merged expansion unbounded again
            bound = h.prefix_bound if h.trunc_step == i else None
            if id(nxt) not in visited:
                nxt.prefix_bound = bound
            elif bound is None or nxt.prefix_bound is None:
                nxt.prefix_bound = None
            else:
                nxt.prefix_bound = max(nxt.prefix_bound, bound)
            visited.add(id(nxt))
            node = nxt
    return root


def tree_rfo_nodes(tree: _HintTree) -> int:
    """Number of RFO-marked nodes in a hint tree (diagnostics/lint)."""
    n = (1 if tree.rfo else 0)
    for c in tree.children.values():
        n += tree_rfo_nodes(c)
    return n


def generate_prefetch_method(hints: tuple[Hint, ...]):
    """Returns ``prefetch(store, runtime, root_oid)`` — the analogue of the
    generated ``<Class>_prefetch.<method>_prefetch(rootObject)``.

    Single associations chain sequentially (``load(a).load(b)``); collection
    associations fan their elements out on the runtime's parallel pool
    (``parallelStream().forEach``), each element continuing its own subtree.
    RFO nodes dirty-allocate their line; truncated collections fan out only
    their static prefix.
    """
    tree = build_hint_tree(hints)
    if not tree.children:
        return None

    def prefetch(store, runtime, root_oid: int) -> None:
        def visit(oid: int, node: _HintTree) -> None:
            rec = store.prefetch_access(oid, rfo=node.rfo)
            if rec is None:
                return
            for child in node.ordered_children():
                ref = rec.fields.get(child.fld)
                if ref is None:
                    continue
                if child.card == lang.COLLECTION:
                    elems = list(ref)
                    if child.prefix_bound is not None:
                        elems = elems[: child.prefix_bound]
                    runtime.fan_out(lambda e, c=child: visit(e, c), elems)
                else:
                    visit(ref, child)

        visit(root_oid, tree)

    return prefetch


def generate_all(report) -> dict[str, object]:
    """Generated prefetch methods for every analyzed method with non-empty
    (deduplicated) hints."""
    out = {}
    for key, hints in report.hints.items():
        fn = generate_prefetch_method(hints)
        if fn is not None:
            out[key] = fn
    return out
