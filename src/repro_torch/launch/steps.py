"""Step functions (train / prefill / decode) and a concrete batch for tests
and examples.  Counterpart of ``repro.launch.steps`` on one device (the
mesh-info and abstract-input parts wait for the multi-device slice).

PyTorch runs eagerly, so a step is a plain function (the serving steps
under ``torch.inference_mode``); the JAX package's ``jit`` has no
counterpart here.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.common import tree_items, tree_map
from repro_torch.models.model import Model
from repro_torch.optim import AdamW, warmup_cosine


def make_optimizer(total_steps: int = 10_000) -> AdamW:
    warmup = max(1, min(200, total_steps // 10))
    return AdamW(learning_rate=warmup_cosine(3e-4, warmup, total_steps))


def loss_and_grads(model: Model, params: dict, batch: dict):
    """(loss, gradient tree) of ``model.loss_fn`` at ``params``: the
    counterpart of ``jax.value_and_grad(Model.loss_fn)``, with the same tree.

    The autograd leaves are the top-level parameters and, for the stacked
    ``[L, ...]`` layer parameters, one view per layer, handed to the model
    as a list of per-layer trees.  Each view's gradient accumulates in place
    into row ``l`` of a stacked f32 gradient tensor.  With the stacked tensor
    itself as the leaf, autograd would build a zero tensor the size of the
    whole stack for every layer's view and add them all up: O(L^2) bytes
    per step."""
    top = tree_map(lambda p: p.detach().requires_grad_(),
                   {k: v for k, v in params.items() if k != "layers"})
    stacked = tree_map(torch.zeros_like, params["layers"])
    layers = []
    for l in range(model.cfg.n_layers):
        lp = tree_map(lambda a: a[l].detach().requires_grad_(), params["layers"])
        for (_, leaf), (_, g) in zip(tree_items(lp), tree_items(stacked)):
            leaf.grad = g[l]
        layers.append(lp)
    with torch.enable_grad():
        loss = model.loss_fn({**top, "layers": layers}, batch)
        loss.backward()
    grads = tree_map(lambda p: p.grad, top)
    grads["layers"] = stacked
    return loss.detach(), grads


def make_train_step(cfg: ModelConfig, optimizer: Optional[AdamW] = None, device="cuda"):
    """(model, optimizer, train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)); the step updates ``params`` and ``opt_state`` in
    place and returns them, with ``metrics = {"loss", "grad_norm", "lr"}``."""
    model = Model(cfg, device=device)
    opt = optimizer or make_optimizer()

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(model, params, batch)
        params, opt_state, metrics = opt.update(grads, opt_state, params)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return model, opt, train_step


def make_prefill_step(cfg: ModelConfig, device="cuda"):
    """(model, prefill_step(params, batch) -> (logits, cache))."""
    model = Model(cfg, device=device)

    @torch.inference_mode()
    def prefill_step(params, batch):
        return model.prefill(params, batch)

    return model, prefill_step


def make_decode_step(cfg: ModelConfig, device="cuda"):
    """(model, decode_step(params, cache, tokens, pos) -> (logits, cache));
    the step writes into ``cache`` in place."""
    model = Model(cfg, device=device)

    @torch.inference_mode()
    def decode_step(params, cache, tokens, pos: int):
        return model.decode_step(params, cache, tokens, pos)

    return model, decode_step


def concrete_batch(cfg: ModelConfig, shape_or_bs, seq_len: Optional[int] = None,
                   generator: Optional[torch.Generator] = None, device="cuda") -> dict:
    """A random token batch ({"inputs", "targets"} [B, S]) drawn from
    ``generator`` (seed 0 when none is given) on ``device``."""
    if isinstance(shape_or_bs, ShapeConfig):
        B, S = shape_or_bs.global_batch, shape_or_bs.seq_len
    else:
        B, S = shape_or_bs, seq_len
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    kw = dict(generator=generator, device=dev, dtype=torch.int64)
    return {
        "inputs": torch.randint(0, cfg.vocab_size, (B, S), **kw),
        "targets": torch.randint(0, cfg.vocab_size, (B, S), **kw),
    }
