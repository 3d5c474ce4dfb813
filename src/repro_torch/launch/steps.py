"""Step functions (prefill / decode) and a concrete batch for tests and
examples.  Counterpart of the serving parts of ``repro.launch.steps``.

PyTorch runs eagerly, so a step is a plain function under
``torch.inference_mode``; the JAX package's ``jit`` has no counterpart here.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.model import Model


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
