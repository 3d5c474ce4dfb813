"""Core layers of the dense family: norms, rotary embeddings, MLPs and
grouped-query attention.  Counterpart of ``repro.models.layers``.

Attention has three implementations, as in the JAX package:

  * ``naive``   — materializes the [.., S_q, S_k] score matrix;
  * ``chunked`` — online softmax over KV chunks in plain PyTorch;
  * ``pallas``  — the name kept from the JAX package for the kernel
                  branch: ``kernels.ops.flash_attention_trainable`` (the CUDA
                  forward and backward kernels on a CUDA device, at any
                  length; on the CPU their plain versions, where both lengths
                  are multiples of 128 as in JAX, else ``chunked``).

All matmuls run in the config's compute dtype; softmax and norms accumulate
in f32.  Rounding points follow the JAX code so that the two agree.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, pricing

from .common import (
    constrain,
    current_mesh_rules,
    logical_to_pspec,
    replicated_like,
    split_last,
    to_dtensor,
)

NEG_INF = -1e30

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm(x, scale, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def layernorm(x, scale, bias=None, eps: float = 1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)  # jnp.var: ddof=0
    out = (xf - mu) * torch.rsqrt(var + eps) * scale.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def apply_norm(kind: str, x, scale, bias=None):
    if kind == "rmsnorm":
        return rmsnorm(x, scale)
    return layernorm(x, scale, bias)


# ---------------------------------------------------------------------------
# Position embeddings: rotary (default / half / mrope) and sinusoidal
# ---------------------------------------------------------------------------


def _rope_angles(positions, dim: int, theta: float):
    """positions [...] -> cos, sin of shape [..., dim/2] (f32)."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device) / dim
    freqs = 1.0 / (theta**exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def _rotate(x, cos, sin):
    """Rotate the two halves of the last dim of ``x``; f32 math, x's dtype."""
    d = x.shape[-1] // 2
    x1, x2 = x[..., :d], x[..., d:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def rope_angles(kind: str, positions, head_dim: int, theta: float):
    """The rotation tables of ``apply_rope`` for positions [B, S] ([3, B, S]
    for mrope): (cos, sin) of shape [B, S, 1, rot/2], or None for kinds that
    do not rotate.  Every layer rotates at the same positions, so a stack
    computes them once per forward or decode step (the JAX code recomputes
    them in each layer; the values are the same)."""
    if kind in ("none", "sinusoidal"):
        return None
    if kind == "mrope":
        # qwen2-vl: the half head dim split into (t, h, w) sections, each
        # with its own frequency ladder turned by its own position stream
        parts = [_rope_angles(positions[i], 2 * width, theta)
                 for i, width in enumerate(_mrope_sections(head_dim // 2))]
        cos = torch.cat([c for c, _ in parts], dim=-1)
        sin = torch.cat([s for _, s in parts], dim=-1)
        return cos[:, :, None, :], sin[:, :, None, :]
    if kind not in ("default", "half"):
        raise ValueError(f"unknown rope kind {kind}")
    # "half" rotates only the first half of the head dim (ChatGLM 2d / partial)
    cos, sin = _rope_angles(positions, head_dim if kind == "default" else head_dim // 2, theta)
    return cos[:, :, None, :], sin[:, :, None, :]


def _mrope_sections(half: int) -> tuple[int, int, int]:
    """(t, h, w) frequency sections; qwen2-vl uses (16, 24, 24) for hd=128."""
    t = half // 4
    h = (half - t) // 2
    return (t, h, half - t - h)


def sinusoidal_embedding(positions, d_model: int):
    """Absolute sinusoidal position embeddings [..., d_model] in f32: the
    [sin, cos] halves of ``positions`` times a ladder of ``d_model / 2``
    frequencies from 1 down to 1e-4 (whisper)."""
    half = d_model // 2
    steps = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = torch.exp(-math.log(10_000.0) * steps / max(1, half - 1))
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def apply_rope(x, angles):
    """x: [B, S, H, hd]; angles: ``rope_angles`` of its positions."""
    if angles is None:
        return x
    cos, sin = (replicated_like(x, a) for a in angles)
    rot = 2 * cos.shape[-1]
    if rot == x.shape[-1]:
        return _rotate(x, cos, sin)
    return torch.cat([_rotate(x[..., :rot], cos, sin), x[..., rot:]], dim=-1)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def mlp_apply(kind: str, x, p, compute_dtype):
    """p: dict with wi_gate/wi_up/wo (gated) or wi/wo (plain)."""
    cast = lambda w: w.to(compute_dtype)
    if kind in ("swiglu", "geglu"):
        g = x @ cast(p["wi_gate"])
        u = x @ cast(p["wi_up"])
        # jax.nn.gelu defaults to the tanh approximation
        act = F.silu(g) if kind == "swiglu" else F.gelu(g, approximate="tanh")
        h = act * u
    elif kind == "gelu":
        pre = x @ cast(p["wi"])
        if "bi" in p:
            pre = pre + cast(p["bi"])
        h = F.gelu(pre, approximate="tanh")
    elif kind == "relu2":
        h = torch.square(F.relu(x @ cast(p["wi"])))
    else:
        raise ValueError(f"unknown mlp kind {kind}")
    h = constrain(h, "batch", "inner_seq", "act_ff")
    out = h @ cast(p["wo"])
    if "bo" in p:
        out = out + cast(p["bo"])
    return out


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _split_heads(x, n_heads: int, head_dim: int):
    return split_last(x, n_heads, head_dim)


def gqa_attention(
    q,  # [B, Sq, H, hd]
    k,  # [B, Sk, KV, hd]
    v,  # [B, Sk, KV, hd]
    *,
    causal: bool,
    impl: str = "chunked",
    chunk: int = 1024,
    q_offset: int = 0,
    local_window: int = 0,
    kv_len: Optional[int] = None,  # decode: number of valid kv slots
):
    """Grouped-query attention.  ``q_offset`` positions the queries within
    the kv sequence (prefill chunking / decode).  ``local_window`` > 0 adds a
    sliding-window constraint.  ``kv_len`` masks cache slots >= kv_len.
    Under a mesh it runs on each rank's local rows and heads
    (``_sharded_attention``)."""
    kw = dict(causal=causal, impl=impl, chunk=chunk, q_offset=q_offset,
              local_window=local_window, kv_len=kv_len)
    ctx = current_mesh_rules()
    if ctx is not None:
        return _sharded_attention(ctx, q, k, v, kw)
    return local_attention(q, k, v, **kw)


def _sharded_attention(ctx, q, k, v, kw):
    """``gqa_attention`` under a mesh, as a ``shard_map`` over q (batch,
    inner_seq, act_heads) and k, v (batch, inner_seq, act_kv): the flash
    kernels (or the plain paths) see only this rank's rows and heads.  Where
    q's heads are split over ``model`` and k's are not (fewer kv heads than
    ranks), each rank takes the kv heads its query heads read."""
    from repro_torch.launch.compat import shard_map

    mesh, rules = ctx
    qs = logical_to_pspec(("batch", "inner_seq", "act_heads", None), rules)
    ks = logical_to_pspec(("batch", "inner_seq", "act_kv", None), rules)
    G = q.shape[2] // k.shape[2]

    def body(ql, kl, vl):
        kl, vl = local_kv(mesh, qs[2], ks[2], ql, kl, vl, G)
        return local_attention(ql, kl, vl, **kw)

    return shard_map(body, mesh, (qs, ks, ks), qs)(q, k, v)


def local_kv(mesh, q_axis, kv_axis, ql, kl, vl, G: int):
    """Inside a ``shard_map`` body over [B, S, heads, hd] q and k/v: the kv
    heads this rank's query heads read.  Where q's heads are split over
    ``q_axis`` and k/v's are not (``kv_axis`` None: fewer kv heads than
    ranks), that is a slice of k/v's heads; otherwise k/v as given.  Local
    query heads that split a group of ``G`` raise."""
    if q_axis is None or kv_axis is not None:
        return kl, vl
    Hl = ql.shape[2]
    if G % Hl and Hl % G:
        raise ValueError(f"{Hl} local query heads split a group of {G}")
    h0 = mesh.get_local_rank(q_axis) * Hl
    kv0, kv1 = h0 // G, (h0 + Hl - 1) // G + 1
    return kl[:, :, kv0:kv1], vl[:, :, kv0:kv1]


def merge_partials(o, lse, dtype):
    """Attention outputs over disjoint sets of keys merged into the output
    over their union: o [R, ..., D], each part normalised over its own keys,
    and its f32 log-sum-exp lse [R, ...] -> sum_r exp(lse_r - lse) o_r with
    lse = logsumexp_r lse_r, in f32, rounded once to ``dtype``.  A part
    with no key (lse -1e30) weighs exactly 0.  Plain PyTorch: the reduction
    that JAX's GSPMD makes of the softmax over a sharded sequence."""
    w = torch.exp(lse - torch.logsumexp(lse, dim=0))
    return (w[..., None] * o.float()).sum(0).to(dtype)


def local_attention(q, k, v, *, causal, impl, chunk, q_offset, local_window, kv_len):
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / (hd**0.5)

    if (
        impl == "pallas"
        and Sq > 1
        and kv_len is None
        and local_window == 0
        and (pricing.on_card(q) or (Sq % 128 == 0 and k.shape[1] % 128 == 0))
    ):
        # the flash-attention kernels, forward and backward: scores and
        # probabilities never reach device memory.  The CUDA kernels mask
        # ragged edges, so on the card every length takes them; the
        # 128-multiple condition is the JAX package's Pallas guard (a TPU
        # block constraint), kept off the card so that the plain versions run
        # where the JAX package runs its Pallas branch
        return ops.flash_attention_trainable(q, k, v, causal, q_offset)

    q5 = q.reshape(B, Sq, KV, G, hd)
    if impl == "naive" or Sq == 1:
        out = _attn_naive(q5, k, v, scale, causal, q_offset, local_window, kv_len)
    else:
        out = _attn_chunked(q5, k, v, scale, causal, q_offset, local_window, kv_len, chunk)
    return out.reshape(B, Sq, H, hd)


def _mask(Sq, Sk, q_offset, causal, local_window, kv_len, device, k_offset=0):
    qpos = q_offset + torch.arange(Sq, device=device)[:, None]  # [Sq, 1]
    kpos = k_offset + torch.arange(Sk, device=device)[None, :]  # [1, Sk]
    m = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        m &= kpos <= qpos
    if local_window:
        m &= kpos > qpos - local_window
    if kv_len is not None:
        m &= kpos < kv_len
    return m


def _scores(q5, k, scale):
    """[B, Sq, KV, G, hd] x [B, Sk, KV, hd] -> f32 [B, KV, G, Sq, Sk]:
    operands in their dtype, products and sums in f32 (JAX's
    preferred_element_type=f32)."""
    return torch.einsum("bqkgd,bskd->bkgqs", q5.float(), k.float()) * scale


def _attn_naive(q5, k, v, scale, causal, q_offset, local_window, kv_len):
    B, Sq, KV, G, hd = q5.shape
    Sk = k.shape[1]
    scores = _scores(q5, k, scale)
    mask = _mask(Sq, Sk, q_offset, causal, local_window, kv_len, q5.device)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(q5.dtype)
    return torch.einsum("bkgqs,bskd->bqkgd", probs, v)


def _attn_chunked(q5, k, v, scale, causal, q_offset, local_window, kv_len, chunk):
    """Online softmax over KV chunks (the flash-attention recurrence).  As in
    the JAX code the accumulator stays in the compute dtype."""
    B, Sq, KV, G, hd = q5.shape
    Sk = k.shape[1]
    chunk = min(chunk, Sk)
    n_chunks = -(-Sk // chunk)
    pad = n_chunks * chunk - Sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    valid = min(Sk, kv_len) if kv_len is not None else Sk
    m = torch.full((B, KV, G, Sq), float("-inf"), dtype=torch.float32, device=q5.device)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=q5.device)
    acc = torch.zeros((B, KV, G, Sq, hd), dtype=q5.dtype, device=q5.device)
    for idx in range(n_chunks):
        kb = k[:, idx * chunk : (idx + 1) * chunk]
        vb = v[:, idx * chunk : (idx + 1) * chunk]
        s = _scores(q5, kb, scale)
        mask = _mask(Sq, chunk, q_offset, causal, local_window, valid, q5.device,
                     k_offset=idx * chunk)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(vb.dtype), vb)
        acc = acc * corr[..., None].to(acc.dtype) + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None].to(acc.dtype)
    return out.permute(0, 3, 1, 2, 4)  # [B, Sq, KV, G, hd]


def qkv_project(x, p, cfg, compute_dtype):
    """x [B,S,d] -> q [B,S,H,hd], k/v [B,S,KV,hd]."""
    cast = lambda w: w.to(compute_dtype)
    q = x @ cast(p["wq"])
    k = x @ cast(p["wk"])
    v = x @ cast(p["wv"])
    if cfg.qkv_bias:
        q = q + cast(p["bq"])
        k = k + cast(p["bk"])
        v = v + cast(p["bv"])
    q = _split_heads(q, cfg.n_heads, cfg.head_dim)
    k = _split_heads(k, cfg.n_kv_heads, cfg.head_dim)
    v = _split_heads(v, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    return q, k, v


def merge_heads(o):
    """o [B, S, H, hd] -> [B, S, H * hd], under a mesh split over the
    ``heads`` rule's axes that the batch does not take: the layout of the
    row-parallel ``wo``'s input.
    Made explicit, the split is a step of autograd's graph, whose backward
    gathers the input's gradient before the flatten's backward splits it
    into heads; left to the product, the gradient would come back split
    over the flattened dim, which a head count the axis does not divide
    cannot be split from (GSPMD gathers it unasked)."""
    B, S, H, hd = o.shape
    flat = o.reshape(B, S, H * hd)
    ctx = current_mesh_rules()
    if ctx is None:
        return flat
    from repro_torch.launch.shardings import PSpec, off_batch, placements

    mesh, rules = ctx
    spec = PSpec(rules["batch"], rules["inner_seq"], off_batch(rules, "heads"))  # fsdp: None
    return to_dtensor(flat, mesh).redistribute(mesh, placements(mesh, spec))


def attn_output(o, p, cfg, compute_dtype):
    out = merge_heads(o) @ p["wo"].to(compute_dtype)
    if cfg.attn_out_bias and "bo" in p:
        out = out + p["bo"].to(compute_dtype)
    return out
