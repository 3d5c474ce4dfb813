"""AdamW with global-norm clipping, on trees of tensors.  Counterpart of
``repro.optim.adamw``, with its state tree (``{"mu", "nu", "step"}``, mu and
nu mirroring the parameters in f32) and its exact update: weight decay on
every leaf, norms and biases included; bias correction from ``step + 1``;
``eps`` outside the square root.

JAX returns new trees; here ``update`` writes the new parameters and
moments into the tensors it is given, leaf by leaf, and returns them, so a
step holds one leaf's temporaries at a time instead of a second copy of
the parameters and the optimizer state.  ``step`` is a host int32 scalar:
the schedule reads it every update.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Union

import torch

from repro_torch.models.common import tree_items, tree_map


def _leaves(tree) -> list:
    return [t for _, t in tree_items(tree)]


def clip_by_global_norm(grads, max_norm: float):
    """Scale every gradient, in place, by min(1, max_norm / global norm);
    returns (grads, the f32 global norm before clipping)."""
    flat = _leaves(grads)
    norms = torch._foreach_norm([g.float() for g in flat])
    gnorm = torch.linalg.vector_norm(torch.stack(norms))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    for g in flat:
        g.mul_(scale.to(g.dtype))
    return grads, gnorm


@dataclass(frozen=True)
class AdamW:
    learning_rate: Union[float, Callable[[int], float]] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    max_grad_norm: float = 1.0

    def init(self, params) -> dict:
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return {
            "mu": tree_map(zeros, params),
            "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32),
        }

    def _lr(self, step: int) -> float:
        if callable(self.learning_rate):
            return float(self.learning_rate(step))
        return float(self.learning_rate)

    def update(self, grads, state, params):
        """One AdamW step from ``grads``; returns (params, state, metrics)
        with ``metrics = {"grad_norm", "lr"}``.  Updates ``params``,
        ``state`` and (by the clipping) ``grads`` in place."""
        step = int(state["step"]) + 1
        grads, gnorm = clip_by_global_norm(grads, self.max_grad_norm)
        b1, b2, eps, wd = self.b1, self.b2, self.eps, self.weight_decay
        bc1, bc2 = 1 - b1**step, 1 - b2**step
        lr = self._lr(step)
        for p, g, mu, nu in zip(_leaves(params), _leaves(grads), _leaves(state["mu"]),
                                _leaves(state["nu"])):
            g = g.float()
            mu.mul_(b1).add_(g, alpha=1 - b1)
            nu.mul_(b2).add_(g.square(), alpha=1 - b2)
            p32 = p.float()
            delta = (mu / bc1).div_((nu / bc2).sqrt_().add_(eps)).add_(p32, alpha=wd)
            if p.dtype == torch.float32:
                p.sub_(delta, alpha=lr)
            else:
                p.copy_(p32.sub_(delta, alpha=lr))
        state["step"].fill_(step)
        return params, state, {"grad_norm": gnorm, "lr": lr}
