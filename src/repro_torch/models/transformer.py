"""Transformer assembly for the dense family: blocks, the layer stack and
the decode path.  Counterpart of the dense parts of
``repro.models.transformer``.

Layer parameters are stacked on a leading ``layers`` dim as in the JAX
package; the stack is a Python loop and layer ``l`` is the view
``params["layers"][...][l]``, or, where the train step hands the layers over
as a list of per-layer trees, ``params["layers"][l]``.  Under autograd each
layer is recomputed in the backward pass as the config's ``remat`` says.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops

from .common import constrain, tree_map
from .layers import (
    apply_norm,
    apply_rope,
    attn_output,
    gqa_attention,
    mlp_apply,
    qkv_project,
    rope_angles,
)

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float8_e4m3fn": torch.float8_e4m3fn,
}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def cfg_dtype(cfg) -> torch.dtype:
    return torch_dtype(cfg.compute_dtype)


def layer_params(layers, l: int) -> dict:
    """Layer ``l`` of the layer parameters: views of a stacked ``[L, ...]``
    subtree, or entry ``l`` of a list of per-layer subtrees."""
    if isinstance(layers, list):
        return layers[l]
    return tree_map(lambda a: a[l], layers)


def _remat(fn, cfg):
    """``fn`` under the config's remat policy (JAX ``transformer._remat``):
    ``"full"`` keeps only the layer's inputs and recomputes the rest in the
    backward pass (non-reentrant ``torch.utils.checkpoint``), ``"none"``
    keeps every activation.  With autograd not recording there is nothing
    to keep, and ``fn`` runs as it is."""
    if cfg.remat not in ("full", "none"):
        raise NotImplementedError(
            f"remat={cfg.remat!r} is not ported yet: ROADMAP.md, section 1, item 2"
        )
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    return functools.partial(checkpoint, fn, use_reentrant=False)


# ---------------------------------------------------------------------------
# Blocks (full-sequence)
# ---------------------------------------------------------------------------


def attn_block(x, lp, cfg, dt, angles, *, causal=True, local_window=0,
               collect_cache=False):
    """Pre-norm attention sub-block; ``angles``: ``rope_angles`` of the
    positions. Returns (x, (k, v) or None)."""
    h = apply_norm(cfg.norm, x, lp["ln1"], lp.get("ln1_b"))
    h = constrain(h, "batch", "seq", "embed")
    q, k, v = qkv_project(h, lp["attn"], cfg, dt)
    q = apply_rope(q, angles)
    k = apply_rope(k, angles)
    o = gqa_attention(
        q, k, v, causal=causal, impl=cfg.attn_impl, chunk=cfg.attn_chunk,
        local_window=local_window,
    )
    x = x + attn_output(o, lp["attn"], cfg, dt)
    return x, ((k, v) if collect_cache else None)


def ffn_block(x, lp, cfg, dt):
    h = apply_norm(cfg.norm, x, lp["ln2"], lp.get("ln2_b"))
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: ROADMAP.md, section 1, item 5"
        )
    return x + mlp_apply(cfg.mlp, h, lp["mlp"], dt)


def dense_layer(x, lp, cfg, dt, angles, *, causal=True, local_window=0,
                collect_cache=False):
    x, kv = attn_block(
        x, lp, cfg, dt, angles, causal=causal, local_window=local_window,
        collect_cache=collect_cache,
    )
    return ffn_block(x, lp, cfg, dt), kv


def forward_stack(params, cfg, x, positions, *, causal=True, collect_cache=False):
    """The dense stack; with ``collect_cache`` also returns the per-layer
    (k, v) stacked to [L, B, S, KV, hd] each."""
    dt = cfg_dtype(cfg)
    angles = rope_angles(cfg.rope, positions, cfg.head_dim, cfg.rope_theta)
    layer = _remat(
        lambda x, lp: dense_layer(x, lp, cfg, dt, angles, causal=causal,
                                  collect_cache=collect_cache),
        cfg,
    )
    ks, vs = [], []
    for l in range(cfg.n_layers):
        x, kv = layer(x, layer_params(params["layers"], l))
        if collect_cache:
            ks.append(kv[0])
            vs.append(kv[1])
    if not collect_cache:
        return x, None
    return x, (torch.stack(ks), torch.stack(vs))


# ---------------------------------------------------------------------------
# Decode (single token against a cache)
# ---------------------------------------------------------------------------


def _decode_attn(x, lp, cfg, dt, k_cache, v_cache, pos: int, angles):
    """One-token attention against a cache [B, S, KV, hd]: writes the new
    k/v at ``pos`` and attends to slots [0, pos]; ``angles``:
    ``rope_angles`` of position ``pos``.

    The write is in place into ``k_cache`` / ``v_cache`` (views of the
    stacked cache): the counterpart of the JAX code's
    ``dynamic_update_slice`` on a donated buffer."""
    h = apply_norm(cfg.norm, x, lp["ln1"], lp.get("ln1_b"))
    q, k, v = qkv_project(h, lp["attn"], cfg, dt)
    q = apply_rope(q, angles)
    k = apply_rope(k, angles)
    k_cache[:, pos] = k[:, 0].to(k_cache.dtype)
    v_cache[:, pos] = v[:, 0].to(v_cache.dtype)
    if cfg.attn_impl == "pallas" and k_cache.shape[1] % 128 == 0:
        # the flash-decode kernel reads the cache in its stored dtype (fp8
        # caches halve the traffic) and only the first pos + 1 slots
        o = ops.decode_attention(q[:, 0], k_cache, v_cache, pos + 1).to(dt)[:, None]
    else:
        o = gqa_attention(
            q, k_cache.to(dt), v_cache.to(dt), causal=False,
            impl="naive", q_offset=pos, kv_len=pos + 1,
        )
    return x + attn_output(o, lp["attn"], cfg, dt)


def decode_stack(params, cfg, x, cache, pos: int):
    """Dense decode over all layers; updates ``cache`` in place and returns
    (x, cache)."""
    dt = cfg_dtype(cfg)
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32, device=x.device)
    angles = rope_angles(cfg.rope, positions, cfg.head_dim, cfg.rope_theta)
    for l in range(cfg.n_layers):
        lp = layer_params(params["layers"], l)
        x = _decode_attn(x, lp, cfg, dt, cache["k"][l], cache["v"][l], pos, angles)
        x = ffn_block(x, lp, cfg, dt)
    return x, cache
