"""The port's ``shard_map``: a thin ``local_map`` wrapper with JAX's
``(f, mesh, in_specs, out_specs)`` signature.  Counterpart of
``repro.launch.compat``.

``f`` runs on each rank's local shards (plain tensors): the hand-written
kernels, whose wrappers take raw pointers, only ever see those.  Inputs are
redistributed to ``in_specs`` first; outputs become DTensors placed by
``out_specs``.  An output axis listed in ``out_partial`` is a sum over that
axis still to be taken (``Partial``): the body's ``psum`` left to the next
redistribution, which is differentiable.

Gradients: an input replicated over a mesh axis that the computation is
split over (some input sharded on it) gets a gradient that is a sum of the
ranks' parts (``Partial``), as JAX transposes a replicated ``shard_map``
input; an axis nothing is split over runs the same work on every rank, and
its gradient stays replicated.
"""

from __future__ import annotations


def _placements(mesh, spec, partial=()):
    from torch.distributed.tensor import Partial

    from .mesh import axis_sizes
    from .shardings import placements

    names = list(axis_sizes(mesh))
    out = list(placements(mesh, spec))
    for a in partial:
        out[names.index(a)] = Partial()
    return tuple(out)


def shard_map(f, mesh, in_specs, out_specs, out_partial=()):
    """``f`` over local shards; ``in_specs``/``out_specs``: one ``PSpec``
    per positional input/output (None for an input that is not a tensor),
    ``out_specs`` a single ``PSpec`` where ``f`` returns one tensor, a
    plain tuple of them where it returns several."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    in_pl = [None if s is None else _placements(mesh, s) for s in in_specs]
    split = [any(pl is not None and isinstance(pl[i], Shard) for pl in in_pl)
             for i in range(mesh.ndim)]
    grad_pl = [None if pl is None else tuple(
        Partial() if isinstance(p, Replicate) and split[i] else p for i, p in enumerate(pl))
        for pl in in_pl]
    if type(out_specs) is tuple:  # several outputs (a single spec is a PSpec)
        out_pl = tuple(_placements(mesh, s, out_partial) for s in out_specs)
    else:
        out_pl = (_placements(mesh, out_specs, out_partial),)
    return local_map(f, out_placements=out_pl, in_placements=tuple(in_pl),
                     in_grad_placements=tuple(grad_pl), device_mesh=mesh,
                     redistribute_inputs=True)
