"""Optional pipeline parallelism (GPipe-style).  Counterpart of
``repro.launch.pipeline``.

Stages hold disjoint slices of the layer stack (the stacked layer params
are sharded over the ``stage`` mesh axis); microbatches flow through the
classic looped schedule: every tick each stage processes one activation and
sends it downstream.  Bubble fraction = (S-1)/(M+S-1).  JAX's ring
``ppermute`` is an ``all_to_all_single`` over the ``stage`` axis in which
each rank sends its whole activation to the next (differentiable: the
backward sends the gradients back up the ring).
"""

from __future__ import annotations

from typing import Callable

import torch

from .compat import shard_map
from .shardings import PSpec, placements


def _ring_shift(y, group, rank: int, n: int):
    """``y`` from each rank to rank + 1 (mod n): what this rank returns is
    rank - 1's ``y``."""
    import torch.distributed._functional_collectives as funcol

    rows = y.shape[0]
    send = [rows if r == (rank + 1) % n else 0 for r in range(n)]
    recv = [rows if r == (rank - 1) % n else 0 for r in range(n)]
    return funcol.wait_tensor(funcol.all_to_all_single_autograd(y, recv, send, group))


def gpipe(stage_fn: Callable, mesh, axis: str = "stage"):
    """Builds ``run(stage_params, microbatches) -> outputs``.

    stage_fn(lp, x) applies one stage's layer slice to activation x.
    stage_params: tensor with leading dim == n_stages (sharded over axis).
    microbatches: [M, mb, ...] (replicated; stage 0 injects them).
    Returns outputs [M, mb, ...] (replicated: the last stage's, summed over
    the axis with zeros from the others, as JAX's psum does)."""
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    group = mesh.get_group(axis)

    def body(sp, xs):
        stage = mesh.get_local_rank(axis)
        sp = sp[0]  # this stage's slice
        M = xs.shape[0]
        state = torch.zeros_like(xs[0])
        outputs = [torch.zeros_like(xs[0]) for _ in range(M)]
        for t in range(M + n_stages - 1):
            # stage 0 injects microbatch t (while available); the others
            # consume the activation sent from upstream
            x_in = xs[min(t, M - 1)] if stage == 0 else state
            y = stage_fn(sp, x_in)
            # the last stage emits microbatch t - (S - 1) at tick t
            if stage == n_stages - 1 and t >= n_stages - 1:
                outputs[t - (n_stages - 1)] = y
            state = _ring_shift(y, group, stage, n_stages)
        return torch.stack(outputs)

    def run(stage_params, microbatches):
        out = shard_map(body, mesh, (PSpec(axis), PSpec()), PSpec(),
                        out_partial=(axis,))(stage_params, microbatches)
        return out.redistribute(mesh, placements(mesh, PSpec()))

    return run
