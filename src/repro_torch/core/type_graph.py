"""Augmented method type graphs — Algorithm 1 of the paper (section 5.1.2).

For every method ``m`` we construct the augmented method type graph ``AG_m``:

  * single-association nodes from ``getfield`` instructions whose field type
    is a user-defined persistent type;
  * collection-association nodes from ``arrayload`` / ``Iterator.next()``
    instructions inside loop statements;
  * inter-procedural augmentation: the graph of an invoked method is grafted
    onto the navigation that caused the invocation (the receiver), parameter
    nodes are bound to the argument objects, and the callee's return node is
    linked so chained calls (``getAccount().setCustomer(...)``) keep
    navigating (section 4.2.3);
  * branch-dependent marking (section 4.4): navigations inside a conditional
    branch are branch-dependent *unless the same navigation occurs in every
    branch* (the paper's observation that "the accessed objects are the same
    although the methods executed in each branch may be different"); loops
    containing break/continue/return taint every navigation in the loop;
  * overridden methods are never inlined (dynamic binding, section 4.4);
  * recursion is cut at the first back-edge (the paper's benchmarks include
    recursive traversals — OO7, DFS — and each method schedules its own
    prefetching at runtime, so cutting the static graph is sound).

Because each method is analyzed exactly once and memoized, the complexity is
O(|M| * max|I_m|) as stated in section 5.1.4.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from . import ir, lang
from .lower import lower_application

# Branch-dependence policies for hint generation (section 4.4): the published
# CAPre implementation *includes* branch-dependent navigations (union of all
# branches); `exclude` reproduces the conservative variant used for the
# printed PH_m example of section 4.3.
INCLUDE_BRANCH_DEPENDENT = "include"
EXCLUDE_BRANCH_DEPENDENT = "exclude"

BranchPath = tuple[tuple[int, int, int], ...]


@dataclass
class Node:
    nid: int
    field: Optional[str]  # navigation field that reaches this node (None: root)
    card: str  # single | collection
    type_name: Optional[str]
    parent: Optional["Node"] = None
    children: dict[str, "Node"] = field(default_factory=dict)
    # every occurrence that created/merged this navigation:
    #   (branch_path, tainted)  -- tainted = loop-taint or callee-internal dep
    occurrences: set[tuple[BranchPath, bool]] = field(default_factory=set)
    param_index: Optional[int] = None  # set on root nodes (0 == this)
    is_return: bool = False
    # putfield occurrences whose *receiver* is this object — the object is a
    # known update site (the interprocedural write-set of the opt.py RFO
    # pass); same (branch_path, tainted) shape as ``occurrences``
    write_occurrences: set[tuple[BranchPath, bool]] = field(default_factory=set)

    @property
    def written(self) -> bool:
        """True when some execution of the analyzed method may write a field
        of this object (conditional writes count: prefetching for ownership
        ahead of a branchy update site is the whole point of RFO)."""
        return bool(self.write_occurrences)

    @property
    def branch_dependent(self) -> bool:
        if self.parent is None:
            return False
        clean = {bp for (bp, tainted) in self.occurrences if not tainted}
        return not _covers_unconditional(clean)

    def path(self) -> tuple[tuple[str, str], ...]:
        """Navigation steps (field, card) from the root to this node."""
        steps: list[tuple[str, str]] = []
        n: Optional[Node] = self
        while n is not None and n.parent is not None:
            steps.append((n.field, n.card))
            n = n.parent
        return tuple(reversed(steps))

    def root(self) -> "Node":
        n = self
        while n.parent is not None:
            n = n.parent
        return n


def _covers_unconditional(paths: set[BranchPath]) -> bool:
    """True if the set of branch paths covers every execution path: reduce
    {p+(c,0,n), ..., p+(c,n-1,n)} -> {p} to a fixed point and test for ()."""
    if () in paths:
        return True
    if not paths:
        return False
    work = set(paths)
    changed = True
    while changed:
        changed = False
        for p in list(work):
            if not p:
                return True
            prefix, (cid, _, n) = p[:-1], p[-1]
            siblings = [prefix + ((cid, b, n),) for b in range(n)]
            if all(s in work for s in siblings):
                work -= set(siblings)
                work.add(prefix)
                changed = True
        if () in work:
            return True
    return () in work


# ---------------------------------------------------------------------------
# Per-method graph
# ---------------------------------------------------------------------------


@dataclass
class MethodGraph:
    key: str
    roots: list[Node]  # roots[0] == this, then one per declared parameter
    return_nodes: list[Node]
    # statistics for the section 4.4 reproduction
    n_conditionals: int = 0
    n_loops: int = 0
    conds_with_bd: int = 0
    loops_with_bd: int = 0

    @property
    def this_root(self) -> Node:
        return self.roots[0]

    def iter_nodes(self, root: Optional[Node] = None):
        stack = [root] if root is not None else list(self.roots)
        while stack:
            n = stack.pop()
            yield n
            stack.extend(n.children.values())

    def has_branch_dependent(self) -> bool:
        return any(n.branch_dependent for n in self.iter_nodes() if n.parent is not None)


class _GraphBuilder:
    """One Algorithm-1 pass over a method's IR."""

    def __init__(self, analysis: "CAPreAnalysis", mir: ir.MethodIR):
        self.analysis = analysis
        self.mir = mir
        self._nid = 0
        self.roots: list[Node] = []
        self.return_nodes: list[Node] = []
        # var id -> Node | _CollRef | None (opaque)
        self.var_state: dict[str, object] = {}
        # loops that contain a branching instruction taint all their navigations
        self.tainted_loops = {
            lid
            for instr in mir.instrs
            if instr.itype in ir.BRANCHING and instr.has_loop_parent
            for lid in instr.loop_path
        }
        self.cond_ids: set[int] = set()
        self.loop_ids: set[int] = set()
        self.bd_cond_ids: set[int] = set()
        self.bd_loop_ids: set[int] = set()

    # -- node helpers -----------------------------------------------------

    def _new_node(self, **kw) -> Node:
        self._nid += 1
        return Node(nid=self._nid, **kw)

    def create_root(self, type_name: Optional[str], param_index: int) -> Node:
        n = self._new_node(field=None, card=lang.SINGLE, type_name=type_name, param_index=param_index)
        self.roots.append(n)
        return n

    def nav_child(
        self,
        parent: Node,
        fld: str,
        card: str,
        target: Optional[str],
        occurrence: tuple[BranchPath, bool],
    ) -> Node:
        child = parent.children.get(fld)
        if child is None:
            child = self._new_node(field=fld, card=card, type_name=target, parent=parent)
            parent.children[fld] = child
        child.occurrences.add(occurrence)
        return child

    # -- main pass ---------------------------------------------------------

    def build(self) -> MethodGraph:
        mir = self.mir
        for i, (var, _name, typ) in enumerate(mir.params):
            self.var_state[var] = self.create_root(typ, param_index=i)
        for instr in mir.instrs:
            self._visit(instr)
        g = MethodGraph(
            key=mir.key,
            roots=self.roots,
            return_nodes=self.return_nodes,
            n_conditionals=len(self.cond_ids),
            n_loops=len(self.loop_ids),
        )
        self._finalize_stats(g)
        return g

    def _occurrence(self, instr: ir.Instr, extra_taint: bool = False) -> tuple[BranchPath, bool]:
        tainted = extra_taint or any(l in self.tainted_loops for l in instr.loop_path)
        return (instr.branch_path, tainted)

    def _note_context(self, instr: ir.Instr) -> None:
        for cid, _b, _n in instr.branch_path:
            self.cond_ids.add(cid)
        for lid in instr.loop_path:
            self.loop_ids.add(lid)

    def _visit(self, instr: ir.Instr) -> None:
        self._note_context(instr)
        t = instr.itype
        if t == ir.GETFIELD:
            self._visit_getfield(instr)
        elif t == ir.PUTFIELD:
            self._visit_putfield(instr)
        elif t == ir.ITER_INIT:
            src = self.var_state.get(instr.used_vars[0])
            self.var_state[instr.def_var] = src if isinstance(src, _CollRef) else None
        elif t in (ir.ITER_NEXT, ir.ARRAYLOAD):
            # Table 3: collection element access, only inside a loop statement
            if not instr.has_loop_parent:
                return
            src = self.var_state.get(instr.used_vars[0])
            if isinstance(src, _CollRef):
                node = self.nav_child(
                    src.owner, src.field, lang.COLLECTION, src.target, self._occurrence(instr)
                )
                self.var_state[instr.def_var] = node
        elif t == ir.INVOKE:
            self._visit_invoke(instr)
        elif t == ir.RETURN:
            if instr.used_vars:
                node = self.var_state.get(instr.used_vars[0])
                if isinstance(node, Node):
                    node.is_return = True
                    self.return_nodes.append(node)
        elif t in (ir.COMPUTE, ir.CONST, ir.NEW):
            if instr.def_var is not None:
                self.var_state[instr.def_var] = None

    def _visit_getfield(self, instr: ir.Instr) -> None:
        p = instr.params
        src = self.var_state.get(instr.used_vars[0])
        if not isinstance(src, Node):
            return  # navigation from a non-persistent value: no node
        if not p.get("persistent"):
            return  # primitive fields are not part of the graph (section 4.2.2)
        if p.get("card") == lang.COLLECTION:
            # "accesses a field of type collection. Hence, no changes to AG_m"
            # -- the element access (next/arrayload) creates the node.
            self.var_state[instr.def_var] = _CollRef(src, p["field"], p.get("target"))
            return
        node = self.nav_child(src, p["field"], lang.SINGLE, p.get("target"), self._occurrence(instr))
        self.var_state[instr.def_var] = node

    def _visit_putfield(self, instr: ir.Instr) -> None:
        """Write-set pass: a putfield marks its *receiver* object as a known
        update site.  The written field's own type doesn't matter (writing a
        primitive like ``amount`` dirties the receiver's cache line exactly
        like rewriting an association), so unlike getfield there is no
        persistent-field filter — only the receiver must be a graph node."""
        src = self.var_state.get(instr.used_vars[0])
        if isinstance(src, Node):
            src.write_occurrences.add(self._occurrence(instr))

    def _visit_invoke(self, instr: ir.Instr) -> None:
        p = instr.params
        if not p.get("is_user"):
            if instr.def_var is not None:
                self.var_state[instr.def_var] = None
            return
        owner, mname = p["owner"], p["method"]
        app = self.analysis.app
        try:
            mdef = app.resolve_method(owner, mname)
        except AttributeError:
            return
        callee_key = mdef.key
        receiver = self.var_state.get(instr.used_vars[0])
        receiver_node = receiver if isinstance(receiver, Node) else None
        # section 4.4: never inline overridden methods (dynamic binding).
        if app.is_overridden(owner, mname):
            self.analysis._record_call(callee_key, self.mir.key, grafted=False, reason="overridden")
            if instr.def_var is not None:
                self.var_state[instr.def_var] = None
            return
        callee_graph = self.analysis.graph_of(callee_key)
        if callee_graph is None:  # recursion cut
            self.analysis._record_call(callee_key, self.mir.key, grafted=False, reason="recursion")
            if instr.def_var is not None:
                self.var_state[instr.def_var] = None
            return

        arg_nodes: list[Optional[Node]] = [receiver_node]
        for v in instr.used_vars[1:]:
            st = self.var_state.get(v)
            arg_nodes.append(st if isinstance(st, Node) else None)

        copied: dict[int, Node] = {}
        occ = self._occurrence(instr)
        for i, callee_root in enumerate(callee_graph.roots):
            if i < len(arg_nodes) and arg_nodes[i] is not None:
                # bindParameter: the callee's root/param subtree hangs off the
                # caller's node for the corresponding object.
                self._graft(callee_root, arg_nodes[i], occ, copied)

        self.analysis._record_call(
            callee_key,
            self.mir.key,
            grafted=receiver_node is not None,
            receiver=receiver_node,
        )

        ret: Optional[Node] = None
        for rn in callee_graph.return_nodes:
            if rn.nid in copied:
                ret = copied[rn.nid]
                break
            if rn.parent is None:
                # method returns one of its own parameters verbatim
                idx = rn.param_index or 0
                if idx < len(arg_nodes):
                    ret = arg_nodes[idx]
                    break
        if instr.def_var is not None:
            self.var_state[instr.def_var] = ret

    def _graft(
        self,
        callee_node: Node,
        onto: Node,
        occ: tuple[BranchPath, bool],
        copied: dict[int, Node],
    ) -> None:
        copied[callee_node.nid] = onto
        branch_path, tainted = occ
        if callee_node.write_occurrences:
            # interprocedural write-set propagation: the callee updates this
            # object, so the caller's corresponding node is an update site
            # too.  The callee's own branch numbering is meaningless here, so
            # its conditionality is collapsed into the taint bit (mirroring
            # how child occurrences fold in ``child.branch_dependent``).
            clean = {bp for (bp, t) in callee_node.write_occurrences if not t}
            onto.write_occurrences.add(
                (branch_path, tainted or not _covers_unconditional(clean))
            )
        for child in callee_node.children.values():
            child_occ = (branch_path, tainted or child.branch_dependent)
            new = self.nav_child(onto, child.field, child.card, child.type_name, child_occ)
            self._graft(child, new, (branch_path, tainted), copied)

    def _finalize_stats(self, g: MethodGraph) -> None:
        """Which conditional/loop statements trigger branch-dependent
        navigations (the Table 2 reproduction)."""
        for n in g.iter_nodes():
            if n.parent is None or not n.branch_dependent:
                continue
            for bp, tainted in n.occurrences:
                for cid, _b, _nb in bp:
                    self.bd_cond_ids.add(cid)
                if tainted:
                    # attribute loop taint to the loops the node's occurrences
                    # sit in (conservative: all tainted loops of the method)
                    self.bd_loop_ids |= self.tainted_loops & self.loop_ids
        g.conds_with_bd = len(self.bd_cond_ids & self.cond_ids)
        g.loops_with_bd = len(self.bd_loop_ids & self.loop_ids)


@dataclass
class _CollRef:
    owner: Node
    field: str
    target: Optional[str]


# ---------------------------------------------------------------------------
# Whole-application analysis driver
# ---------------------------------------------------------------------------


@dataclass
class CallSite:
    caller: str
    grafted: bool
    receiver: Optional[Node] = None
    reason: Optional[str] = None


class CAPreAnalysis:
    """Memoized inter-procedural analysis over a whole application.

    ``graph_of`` computes AG_m once per method (O(|M| * max|I_m|) overall,
    section 5.1.4); cycles in the call graph are cut at the back edge.
    """

    def __init__(self, app: lang.Application):
        self.app = app
        self.method_ir = lower_application(app)
        self._graphs: dict[str, MethodGraph] = {}
        self._in_progress: set[str] = set()
        self.call_sites: dict[str, list[CallSite]] = {}

    def _record_call(self, callee: str, caller: str, grafted: bool, receiver=None, reason=None):
        # Self-recursive sites ARE callers for the section 5.1.3 dedup: the
        # recursion cut means the recursive caller's graph does NOT contain
        # the callee's grafted subtree, so it cannot cover the hints — hence
        # recursive methods keep their hints and re-schedule prefetching at
        # every level (the rolling-frontier behavior that gives the paper its
        # OO7 gains).
        self.call_sites.setdefault(callee, []).append(
            CallSite(caller=caller, grafted=grafted, receiver=receiver, reason=reason)
        )

    def graph_of(self, key: str) -> Optional[MethodGraph]:
        if key in self._graphs:
            return self._graphs[key]
        if key in self._in_progress:
            return None  # recursion cut
        if key not in self.method_ir:
            return None
        self._in_progress.add(key)
        try:
            g = _GraphBuilder(self, self.method_ir[key]).build()
        finally:
            self._in_progress.discard(key)
        self._graphs[key] = g
        return g

    def analyze_all(self) -> dict[str, MethodGraph]:
        for key in list(self.method_ir):
            self.graph_of(key)
        return dict(self._graphs)
