"""Shared model utilities: the parameter-template mechanism (single source
of truth for parameter shapes and initializers) and a no-op ``constrain``.

Counterpart of ``repro.models.common``.  A template is a nested dict whose
leaves are ``ParamSpec``; the dotted path of a leaf (``layers.attn.wq``) is
the path ``repro.core.access_plan._path_str`` gives the same JAX leaf.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterator, Optional

import torch


def constrain(x, *axes: Optional[str]):
    """Logical-axis sharding annotation; the port runs on one device, so it
    returns ``x`` unchanged (multi-device is a later slice)."""
    return x


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]  # logical axis per dim
    init: str = "normal"  # normal | zeros | ones
    scale: float = 0.02


def tree_map(fn: Callable, tree):
    """Map ``fn`` over the leaves of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


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


def param_count(template) -> int:
    total = 0
    for _, s in tree_items(template):
        n = 1
        for d in s.shape:
            n *= d
        total += n
    return total
