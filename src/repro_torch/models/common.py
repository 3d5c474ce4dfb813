"""Shared model utilities: logical-axis sharding constraints and the
parameter-template mechanism (single source of truth for parameter shapes,
initializers and logical sharding axes).

Counterpart of ``repro.models.common``.  A template is a nested dict whose
leaves are ``ParamSpec``; the dotted path of a leaf (``layers.attn.wq``) is
the path ``repro.core.access_plan._path_str`` gives the same JAX leaf.

Model code annotates activations with *logical* axes ("batch", "embed",
"heads", ...).  The launcher activates a (mesh, rules) context mapping
logical axes to mesh axes; there ``constrain`` redistributes a DTensor to
the rule's placements (JAX's ``with_sharding_constraint``).  Outside a
context it returns its argument, so the single-device path is unchanged.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Iterator, Optional

import torch

class _Context:
    """The active (mesh, rules), or None.  Process-wide, not per thread: the
    backward pass, which runs on the autograd engine's thread for CUDA
    tensors, recomputes remat'd layers and must see the same mesh."""

    ctx = None


_CTX = _Context()


@contextmanager
def activate_sharding(mesh, rules: dict):
    """Run the model under ``mesh`` and ``rules``.  Inside, a plain tensor
    met by a DTensor op counts as replicated (DTensor's
    ``implicit_replication``), as an unsharded array does under JAX: the
    positions, masks and rotary tables the model makes on the fly."""
    from torch.distributed.tensor.experimental import implicit_replication

    prev = _CTX.ctx
    _CTX.ctx = (mesh, rules)
    try:
        with implicit_replication():
            yield
    finally:
        _CTX.ctx = prev


def current_mesh_rules():
    """(mesh, rules) of the active context, or None."""
    return _CTX.ctx


def logical_to_pspec(axes: tuple, rules: dict):
    from repro_torch.launch.shardings import PSpec

    return PSpec(*[rules.get(a) if a is not None else None for a in axes])


def to_dtensor(x, mesh):
    """``x`` as a DTensor on ``mesh``: a DTensor as it is; a plain tensor,
    whole on every rank, as a replicated one (as JAX treats an unsharded
    array)."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)


def replicated_like(x, t):
    """``t`` (a plain tensor, whole on every rank) as a replicated DTensor
    on ``x``'s mesh where ``x`` is a DTensor, else ``t``.  For tensors the
    model makes on the fly and mixes with sharded ones in code that the
    backward recomputes on the autograd engine's thread, where DTensor's
    ``implicit_replication`` (per thread) is not on."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor) and not isinstance(t, DTensor):
        return to_dtensor(t, x.device_mesh)
    return t


def constrain(x, *axes: Optional[str]):
    """``with_sharding_constraint`` by logical axis names (None = unsharded
    dim): under an active context, ``x`` redistributed to the placements
    the rules give those axes; outside one, ``x`` itself."""
    ctx = _CTX.ctx
    if ctx is None:
        return x
    from repro_torch.launch.shardings import placements

    mesh, rules = ctx
    return to_dtensor(x, mesh).redistribute(mesh, placements(mesh, logical_to_pspec(axes, rules)))


def split_last(x, n: int, size: int):
    """``x [..., n * size] -> [..., n, size]`` (heads out of a flattened
    head dim).  A DTensor sharded on the last dim over mesh dims whose
    product does not divide ``n`` is first gathered on that dim: DTensor
    cannot split a shard across a head boundary (GSPMD moves the same bytes
    without being asked)."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(x, DTensor):
        dim = x.ndim - 1
        on = [i for i, p in enumerate(x.placements) if p.is_shard(dim)]
        ways = 1
        for i in on:
            ways *= x.device_mesh.size(i)
        if n % ways:
            pl = [Replicate() if i in on else p for i, p in enumerate(x.placements)]
            x = x.redistribute(x.device_mesh, pl)
    return x.reshape(*x.shape[:-1], n, size)


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]  # logical axis per dim
    init: str = "normal"  # normal | zeros | ones
    scale: float = 0.02


def tree_map(fn: Callable, tree, *rest):
    """Map ``fn`` over the leaves of a nested dict (and the matching leaves
    of ``rest``, dicts of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_items(tree, prefix: str = "") -> Iterator[tuple[str, object]]:
    """(dotted path, leaf) pairs of a nested dict, in JAX's leaf order
    (keys sorted, as ``jax.tree.flatten`` orders dict keys)."""
    for k in sorted(tree):
        path = f"{prefix}.{k}" if prefix else str(k)
        v = tree[k]
        if isinstance(v, dict):
            yield from tree_items(v, path)
        else:
            yield path, v


def init_from_template(template, generator: torch.Generator, dtype, device) -> dict:
    """Materialize a parameter tree from a template of ParamSpecs:
    ``scale * normal`` for ``normal`` leaves, zeros and ones otherwise.
    Leaves draw from ``generator`` in ``tree_items`` order."""
    out: dict = {}
    for path, spec in tree_items(template):
        if spec.init == "zeros":
            t = torch.zeros(spec.shape, dtype=dtype, device=device)
        elif spec.init == "ones":
            t = torch.ones(spec.shape, dtype=dtype, device=device)
        else:
            t = torch.randn(spec.shape, generator=generator, dtype=dtype, device=device)
            t.mul_(spec.scale)
        node = out
        *parents, leaf = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t
    return out


def abstract_from_template(template, dtype) -> dict:
    """The parameter tree as tensors on the ``meta`` device: shapes and
    dtypes, no storage."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=dtype, device="meta"), template)


def pspecs_from_template(template, rules: dict) -> dict:
    return tree_map(lambda s: logical_to_pspec(s.axes, rules), template)


def param_bytes(template, bytes_per_el: int = 4) -> int:
    return param_count(template) * bytes_per_el


def param_count(template) -> int:
    total = 0
    for _, s in tree_items(template):
        n = 1
        for d in s.shape:
            n *= d
        total += n
    return total
