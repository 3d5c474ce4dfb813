"""Cost analysis of a step traced on the ``meta`` device.  Counterpart of
``repro.launch.costmodel`` (the jaxpr walk) and of the job of
``repro.launch.hlo_parse`` (collective bytes per device).

``step_cost(fn, *abstract_args)`` runs ``fn`` once on ``meta`` tensors
(nothing is allocated and no device is touched) and returns the GLOBAL
totals of that step, as JAX's jaxpr walk gives them for the unsharded
step:

  * ``dot_flops`` -- the matrix products, counted by
    ``torch.utils.flop_counter.FlopCounterMode`` (2 M N K for ``mm``,
    ``bmm``, ``addmm``, ``baddbmm``), plus the products inside the
    hand-written kernels the step reaches;
  * ``flops``     -- ``dot_flops`` plus one per output element of every
    other op that writes memory (JAX's ``|out|`` for elementwise and
    materialising equations), plus the kernels' own;
  * ``bytes``     -- the memory traffic of each aten op, by JAX's classes
    (``costmodel.py:125-170``): a matrix product reads its inputs and
    writes its output; a gather or index reads twice its output plus its
    indices; an in-place slot write (``copy_``, ``index_copy_``,
    ``index_put_``, a scatter) moves twice the update; a reduction,
    concatenation, copy or sort reads its inputs and writes its output;
    an elementwise op writes its output only (fused into its producer, as
    JAX assumes of XLA).  Views move nothing;
  * ``collective_bytes`` -- the output bytes of the collectives the step
    runs itself (none in an unsharded step);
  * ``kernels``   -- {kernel wrapper's name: calls}, with each kernel priced
    by ``kernels.pricing`` (JAX's ``_pallas_cost`` formulas).

Autograd runs inside the trace, so a train step counts its forward, the
recomputation that its ``remat`` policy makes in the backward pass, the
backward and the optimizer update.

``collective_cost(fn, *args)`` runs ``fn`` on DTensors (a mesh's local
shards on ``meta``; a ``fake`` process group runs no collective), counts
each ``_c10d_functional`` (or ``c10d``) collective this rank runs and sums
its output bytes: the per-rank collective bytes that
``hlo_parse.collective_bytes`` reads off JAX's partitioned HLO.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import pricing

aten = torch.ops.aten

# the products; with autograd off (``inference_mode``) the dispatcher hands
# a mode the composite ops (``matmul``, ``einsum``, ``linear``) before they
# decompose into these
MATMULS = {aten.mm, aten.bmm, aten.addmm, aten.baddbmm, aten._scaled_mm, aten.matmul,
           aten.einsum, aten.linear, aten.tensordot}
GATHERS = {aten.index, aten.index_select, aten.gather, aten.embedding, aten.take,
           aten._unsafe_index}
SLOT_WRITES = {aten.copy_, aten.index_copy_, aten.index_copy, aten.index_put_,
               aten.index_put, aten.scatter, aten.scatter_, aten.scatter_add,
               aten.scatter_add_, aten.slice_scatter, aten.select_scatter,
               aten.masked_scatter}
# reductions, concatenations, copies and sorts: inputs plus output
MATERIALIZING = {aten.sum, aten.mean, aten.amax, aten.amin, aten.max, aten.min,
                 aten.argmax, aten.argmin, aten.logsumexp, aten._softmax,
                 aten._log_softmax, aten.cumsum, aten.cumprod, aten.sort, aten.topk,
                 aten.any, aten.all, aten.prod, aten.var_mean, aten.var, aten.std,
                 aten.norm, aten.linalg_vector_norm, aten._softmax_backward_data,
                 aten._log_softmax_backward_data, aten.cat, aten.stack, aten.clone,
                 aten.contiguous,
                 aten.constant_pad_nd, aten.flip, aten.roll, aten.repeat, aten.tril,
                 aten.triu, aten.softmax, aten.log_softmax, aten.layer_norm, aten.rms_norm,
                 aten.native_layer_norm, aten.pad}
# views and bookkeeping: they move nothing
FREE = {aten._unsafe_view, aten.detach, aten.lift_fresh, aten.empty, aten.empty_like,
        aten.empty_strided, aten.new_empty, aten.new_empty_strided, aten.sym_size,
        aten.sym_stride, aten.sym_numel, aten.is_same_size, aten.reshape, aten.flatten,
        aten.unflatten, aten.view_as, aten.expand_as, aten.split, aten.chunk, aten.unbind,
        aten.tensor_split, aten.movedim}


@dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    dot_flops: float = 0.0
    kernels: dict = field(default_factory=dict)  # kernel wrapper -> calls


def _tensors(tree) -> list:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _is_collective(func) -> bool:
    """A collective of the functional (``_c10d_functional``) or the c10d
    API; not ``wait_tensor`` or the functional API's autograd wrapper."""
    ns, name = func.namespace, func._opname
    return ns in ("_c10d_functional", "c10d") and not (name.startswith("_")
                                                        or name == "wait_tensor")


class _OpCost(TorchDispatchMode):
    """Adds each aten op's bytes and non-product FLOPs into ``cost``."""

    def __init__(self, cost: Cost):
        super().__init__()
        self.cost = cost

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        packet = func.overloadpacket
        if func.is_view or packet in FREE:
            return out
        ins = _tensors((args, kwargs))
        outs = [t for t in _tensors(out) if not any(t is i for i in ins)]  # not an alias
        if not outs or packet is aten.contiguous and ins[0].is_contiguous():
            return out
        c = self.cost
        if packet in MATMULS:
            c.bytes += _nbytes(ins) + _nbytes(outs)
        elif _is_collective(func):
            c.collective_bytes += _nbytes(outs)
            c.bytes += _nbytes(ins) + _nbytes(outs)
        elif packet in SLOT_WRITES:  # the update is the last tensor argument
            c.bytes += 2 * _nbytes(ins[-1:])
        elif packet in GATHERS:
            idx = [t for t in ins[1:] if not t.is_floating_point()]
            c.bytes += 2 * _nbytes(outs) + _nbytes(idx)
        elif packet in MATERIALIZING:
            c.flops += sum(t.numel() for t in outs)
            c.bytes += _nbytes(ins) + _nbytes(outs)
        else:  # elementwise: fused into its producer, its write counted
            c.flops += sum(t.numel() for t in outs)
            c.bytes += _nbytes(outs)
        return out


def step_cost(fn, *abstract_args, **kw) -> Cost:
    """The cost of one call ``fn(*abstract_args, **kw)`` on ``meta``
    tensors (``launch.steps.input_specs``, ``decode_input_specs``,
    ``Model.abstract_params``): the whole step's global totals and the
    kernels it reaches."""
    from torch.utils.flop_counter import FlopCounterMode

    cost = Cost()

    def record(name, flops, nbytes, dot_flops):
        cost.kernels[name] = cost.kernels.get(name, 0) + 1
        cost.flops += flops
        cost.dot_flops += dot_flops
        cost.bytes += nbytes

    products = FlopCounterMode(display=False)
    with pricing.pricing(record), products, _OpCost(cost):
        fn(*abstract_args, **kw)
    cost.dot_flops += products.get_total_flops()
    cost.flops += products.get_total_flops()
    return cost


class _CollectiveBytes(TorchDispatchMode):
    """The calls and output bytes of every collective this rank runs, by op
    name.  DTensor ops are let through (``NotImplemented``) so that their
    redistributions reach the mode as the collectives they run."""

    def __init__(self):
        super().__init__()
        self.bytes: dict = {}
        self.counts: dict = {}
        self.calls: list = []  # (op, group name, output shape, dtype) in order

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **(kwargs or {}))
        if any(t is DTensor or issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if _is_collective(func):
            name = func._opname
            moved = _tensors(out) if func.namespace == "_c10d_functional" else _tensors(args[0])
            self.bytes[name] = self.bytes.get(name, 0) + _nbytes(moved)
            self.counts[name] = self.counts.get(name, 0) + 1
            group = next((a for a in reversed(args) if isinstance(a, str)), None)
            self.calls += [(name, group, tuple(t.shape), t.dtype) for t in moved]
        return out


def collective_cost(fn, *args, **kw) -> dict:
    """{"bytes_per_rank": total, "bytes": {op: bytes}, "counts": {op: calls},
    "calls": [(op, group name, shape, dtype)]} of the collectives that
    ``fn(*args, **kw)`` runs on this rank: bytes summed over each op's
    outputs (the per-rank shapes)."""
    coll = _CollectiveBytes()
    with coll:
        fn(*args, **kw)
    return {"bytes_per_rank": float(sum(coll.bytes.values())), "bytes": dict(coll.bytes),
            "counts": dict(coll.counts), "calls": coll.calls}
