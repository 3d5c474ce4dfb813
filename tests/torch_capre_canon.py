"""Plain forms of CAPre's analysis objects, for holding the port's
(``repro_torch.core``, ``repro_torch.apps``) against the JAX package's.

Objects never cross the packages: a JAX ``lang.Application`` fails every
``isinstance`` of the port's analysis and the other way round, so each
package builds and analyses its own apps and the tests compare these
forms: dataclasses by class name and fields, callables (``Compute.fn``) by
their qualified name and bytecode (their ``repr`` carries an address), the
augmented type graphs node by node, hints with every optimizer annotation.  Also stubs of
the object store's surface that the apps' ``populate_*`` and the generated
prefetch methods use, recording what they are asked.
"""

from __future__ import annotations

import copy
import dataclasses
from types import CodeType, SimpleNamespace


def canon(x):
    """A plain nested value for an AST or IR object."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                tuple((f.name, canon(getattr(x, f.name))) for f in dataclasses.fields(x)))
    if isinstance(x, dict):
        return ("dict", tuple((canon(k), canon(v)) for k, v in x.items()))
    if isinstance(x, list):
        return ("list", tuple(canon(v) for v in x))
    if isinstance(x, tuple):
        return tuple(canon(v) for v in x)
    if isinstance(x, (set, frozenset)):
        return ("set", tuple(sorted((canon(v) for v in x), key=repr)))
    if callable(x):
        code = getattr(x, "__code__", None)
        return ("fn", getattr(x, "__qualname__", type(x).__qualname__),
                None if code is None else _code(code))
    return x


def _code(code: CodeType) -> tuple:
    return (code.co_code, code.co_names,
            tuple(_code(c) if isinstance(c, CodeType) else c for c in code.co_consts))


def node_canon(n) -> tuple:
    """One augmented-type-graph node and its subtree."""
    return (n.nid, n.field, n.card, n.type_name, n.param_index, n.is_return,
            tuple(sorted(n.occurrences)), tuple(sorted(n.write_occurrences)),
            n.branch_dependent, n.written, n.path(),
            tuple((k, node_canon(c)) for k, c in n.children.items()))


def graph_canon(g) -> tuple:
    return (g.key, tuple(node_canon(r) for r in g.roots),
            tuple(n.nid for n in g.return_nodes), g.n_conditionals, g.n_loops,
            g.conds_with_bd, g.loops_with_bd, g.has_branch_dependent())


def call_sites_canon(analysis) -> tuple:
    """Every recorded call site, in order: caller, grafted, the receiver
    node (id and path in the caller's graph) and the reason of a cut."""
    return tuple(
        (callee, tuple((s.caller, s.grafted,
                        None if s.receiver is None else (s.receiver.nid, s.receiver.path()),
                        s.reason) for s in sites))
        for callee, sites in analysis.call_sites.items())


def hint_canon(h) -> tuple:
    return (str(h), h.steps, h.rfo_depths, h.trunc_step, h.prefix_bound, h.priority)


def hints_canon(hints: dict) -> tuple:
    return tuple((k, tuple(hint_canon(h) for h in hs)) for k, hs in hints.items())


def report_canon(r) -> tuple:
    """An ``AnalysisReport``: graphs, hints before and after the caller
    dedup (in the report's order), corpus stats and the optimizer's."""
    return (r.app_name, r.policy,
            tuple((k, graph_canon(g)) for k, g in r.graphs.items()),
            hints_canon(r.full_hints), hints_canon(r.hints),
            dataclasses.asdict(r.stats), r.opt.snapshot() if r.opt else None)


def schema_canon(app) -> tuple:
    """The application type graph and every class's fields, as tuples."""
    return (app.name, tuple(app.type_graph().items()),
            tuple((c.name, c.supertype,
                   tuple((f.name, f.target, f.card) for f in c.fields.values()),
                   tuple(c.methods))
                  for c in app.classes.values()))


class RecordingStore:
    """The store surface the apps' ``populate_*`` write through (``put``,
    ``peek``) and the generated prefetch methods read through
    (``prefetch_access``), recording every call.  Oids count from 1."""

    def __init__(self):
        self.records: dict[int, SimpleNamespace] = {}
        self.calls: list[tuple] = []
        self.accesses: list[tuple[int, bool]] = []

    def put(self, cls, fields=None, group=None):
        oid = len(self.records) + 1
        fields = dict(fields or {})
        self.calls.append(("put", oid, cls, copy.deepcopy(fields), group))
        self.records[oid] = SimpleNamespace(cls=cls, fields=fields, group=group)
        return oid

    def peek(self, oid):
        self.calls.append(("peek", oid))
        return self.records[oid]

    def prefetch_access(self, oid, rfo=False):
        self.accesses.append((oid, rfo))
        return self.records.get(oid)

    def state(self) -> tuple:
        return tuple((oid, r.cls, r.fields, r.group) for oid, r in self.records.items())


class SerialRuntime:
    """A runtime whose ``fan_out`` runs each element in turn, in order."""

    def fan_out(self, fn, items) -> None:
        for x in items:
            fn(x)
