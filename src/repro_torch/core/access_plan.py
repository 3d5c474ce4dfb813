"""CAPre on the port: static access analysis over a PyTorch graph traced on
the ``meta`` device.  Counterpart of ``repro.core.access_plan``.

The "application" is a step function; the "persistent objects" are the
parameter leaves; and the graph that ``make_fx`` records from the step on
``meta`` tensors (no allocation, nothing run on a device: the counterpart
of ``jax.make_jaxpr``) tells exactly which parameters each part of the step
touches:

  paper                        | here
  -----------------------------+------------------------------------------
  getfield navigation          | an aten node consuming a parameter leaf
  collection + loop iteration  | a Python loop over a stacked [L, ...]
                               | leaf, taking ``select(leaf, 0, l)`` per layer
  invokemethod augmentation    | recursion into ``torch.cond`` branch graphs
  branch-dependent navigation  | parameters used under some branches only
  prefetching hints PH_m       | PrefetchPlan records ordered by first use

Where the JAX step consumes every stacked leaf in one ``lax.scan``
equation, the port's layer loop opens each layer with one run of
consecutive ``select``s, one per stacked leaf: such a run is one loop
entry, one tick of the program-order clock, so the plan's groups (records
of equal ``first_use``) are the JAX package's.  ``uses`` counts per layer
here and per scan there.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.utils._pytree as pytree
from torch.fx.experimental.proxy_tensor import make_fx

from repro_torch.models.common import tree_items


@dataclass
class AccessRecord:
    path: str
    first_use: int  # program-order clock of the first consuming node
    nbytes: int
    shape: tuple
    collection: bool = False  # stacked leaf consumed layer by layer (CAPre collection)
    branch_dependent: bool = False  # used under a torch.cond branch (section 4.4)
    uses: int = 1

    def __repr__(self) -> str:
        tags = []
        if self.collection:
            tags.append("[]")
        if self.branch_dependent:
            tags.append("bd")
        return f"<{self.path}@{self.first_use} {self.nbytes}B {' '.join(tags)}>"


@dataclass
class PrefetchPlan:
    records: list[AccessRecord]

    @property
    def total_bytes(self) -> int:
        return sum(r.nbytes for r in self.records)

    def ordered(self) -> list[AccessRecord]:
        return sorted(self.records, key=lambda r: r.first_use)

    def collections(self) -> list[AccessRecord]:
        return [r for r in self.records if r.collection]

    def groups(self) -> list[list[AccessRecord]]:
        """The records of equal ``first_use``, in first-use order: what the
        weight streamer fetches and serves together."""
        groups: list[list[AccessRecord]] = []
        for r in self.ordered():
            if groups and r.first_use == groups[-1][0].first_use:
                groups[-1].append(r)
            else:
                groups.append([r])
        return groups

    def hints(self) -> list[str]:
        """String hints, CAPre-style."""
        return [
            r.path + ("[]" if r.collection else "") for r in self.ordered()
        ]


def _path_str(path) -> str:
    """The dotted name of a pytree key path (``layers.attn.wq``)."""
    parts = []
    for p in path:
        if hasattr(p, "key"):
            parts.append(str(p.key))
        elif hasattr(p, "idx"):
            parts.append(str(p.idx))
        elif hasattr(p, "name"):
            parts.append(str(p.name))
        else:
            parts.append(str(p))
    return ".".join(parts)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _to_meta(tree):
    return pytree.tree_map_only(
        torch.Tensor, lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), tree
    )


def _is_layer_select(node, env) -> bool:
    """``select(leaf, 0, l)`` on a whole parameter leaf: one layer's view of
    a stacked leaf."""
    return (node.target is torch.ops.aten.select.int and node.args[0] in env
            and env[node.args[0]][1] and node.args[1] == 0)


def build_access_plan(fn, params, *args, **kwargs) -> PrefetchPlan:
    """Trace ``fn(params, *args, **kwargs)`` and derive the parameter access
    plan.

    Every tensor of ``params`` and ``args`` is replaced by a ``meta`` tensor
    of its shape and dtype before tracing, so concrete tensors and meta
    ones give the same plan and nothing is allocated or run (the paper's
    compile-time analysis).  Placeholders map to dotted paths through
    ``torch.utils._pytree``'s flattening of ``params``, the one ``make_fx``
    uses."""
    params, args = _to_meta(params), _to_meta(args)
    gm = make_fx(lambda p, *a: fn(p, *a, **kwargs), tracing_mode="fake")(params, *args)

    leaves, _ = pytree.tree_flatten_with_path(params)
    placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    # env: node -> (dotted path, whether the node is the whole leaf)
    env: dict = {}
    leaf_of: dict[str, torch.Tensor] = {}
    for (path, leaf), node in zip(leaves, placeholders[: len(leaves)]):
        name = _path_str(path)
        env[node] = (name, True)
        leaf_of[name] = leaf

    records: dict[str, AccessRecord] = {}
    clock = [0]
    use_log: list[set] = []  # per-branch used-path sets (for cond promotion)

    def record_use(pathname, *, collection=False, branch=False):
        for s in use_log:
            s.add(pathname)
        r = records.get(pathname)
        if r is None:
            leaf = leaf_of[pathname]
            records[pathname] = AccessRecord(
                path=pathname,
                first_use=clock[0],
                nbytes=_nbytes(leaf),
                shape=tuple(leaf.shape),
                collection=collection,
                branch_dependent=branch,
            )
        else:
            r.uses += 1
            r.collection |= collection
            # a use on an unconditional path clears branch-dependence
            # (the union-of-branches promotion of section 4.4)
            if not branch:
                r.branch_dependent = False

    def walk(module, env: dict, in_branch: bool):
        """env maps the module's nodes -> (param path, whole leaf)."""
        in_run = False  # inside a run of layer selects (one loop entry)
        for node in module.graph.nodes:
            if node.op != "call_function":
                continue
            if _is_layer_select(node, env):
                if not in_run:
                    clock[0] += 1
                in_run = True
                name = env[node.args[0]][0]
                record_use(name, collection=True, branch=in_branch)
                env[node] = (name, False)  # later uses of the view use the leaf
                continue
            in_run = False
            clock[0] += 1
            if node.target is torch.ops.higher_order.cond:
                _pred, true_br, false_br, operands = node.args[:4]
                branch_used: list[set] = []
                for br in (true_br, false_br):
                    sub = getattr(module, br.target)
                    inner = [n for n in sub.graph.nodes if n.op == "placeholder"]
                    br_env = {i: env[o] for i, o in zip(inner, operands) if o in env}
                    use_log.append(set())
                    walk(sub, br_env, True)
                    branch_used.append(use_log.pop())
                # section 4.4 promotion: a param accessed in EVERY branch is
                # not branch-dependent ("the accessed objects are the same
                # although the methods executed may differ")
                in_all = set.intersection(*branch_used) if branch_used else set()
                for pathname in in_all:
                    if pathname in records and not in_branch:
                        records[pathname].branch_dependent = False
                continue
            for v in node.all_input_nodes:
                if v in env:
                    record_use(env[v][0], branch=in_branch)

    walk(gm, env, False)
    return PrefetchPlan(records=list(records.values()))


def rop_plan(params, depth_groups: int) -> PrefetchPlan:
    """The ROP baseline on the tensor store: schema-only — prefetch the
    first ``depth_groups`` top-level parameter groups in tree order (keys
    sorted, as the JAX package's tree flattening orders them), never
    'collections' (it cannot know a loop consumes all layers).  Mirrors the
    paper's depth-limited referenced-object expansion."""
    groups: dict[str, list] = {}
    for path, leaf in tree_items(params):
        groups.setdefault(path.split(".")[0], []).append((path, leaf))
    records = []
    for gi, (gname, members) in enumerate(groups.items()):
        if gi >= depth_groups:
            break
        for path, leaf in members:
            records.append(
                AccessRecord(path=path, first_use=gi, nbytes=_nbytes(leaf),
                             shape=tuple(leaf.shape))
            )
    return PrefetchPlan(records=records)
