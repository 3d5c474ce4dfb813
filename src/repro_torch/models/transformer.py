"""Transformer assembly for every family (dense, moe, ssm, hybrid, encdec):
blocks, the layer stacks and the decode paths.  Counterpart of
``repro.models.transformer``.

Layer parameters are stacked on a leading ``layers`` dim as in the JAX
package; a stack (``layers``, or encdec's ``enc_layers`` and
``dec_layers``) is one Python loop (``_walk``) and layer ``l`` is the view
``params[group][...][l]``, or, where the train step hands the layers over
as a list of per-layer trees, ``params[group][l]``.  The hybrid's
interleaved (rec, rec, attn) pattern takes its layers from
``rec_layers`` and ``attn_layers`` by static slices (``static_layer_params``),
as JAX's Python loop does, or from the train step's lists.  Under autograd
each layer is recomputed in the backward pass as the config's ``remat``
says.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.kernels import ops, ref

from .common import (
    constrain,
    current_mesh_rules,
    logical_to_pspec,
    split_last,
    tree_items,
    tree_map,
)
from .layers import (
    NEG_INF,
    local_attention,
    local_kv,
    merge_heads,
    merge_partials,
    apply_norm,
    apply_rope,
    attn_output,
    gqa_attention,
    mlp_apply,
    qkv_project,
    rope_angles,
    sinusoidal_embedding,
)
from .moe import moe_apply
from .rglru import recurrent_block
from .ssm import mamba_block

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


def static_layer_params(layers, l: int) -> dict:
    """Layer ``l`` of stacked ``[L, ...]`` layer parameters, each leaf taken
    as the static slice ``a[l : l + 1]`` squeezed, in JAX's leaf order (keys
    sorted), or entry ``l`` of a list of per-layer subtrees (the train
    step's).  This is how the JAX hybrid's Python loop indexes its layers
    (``jax.tree.map(lambda a: a[i], ...)`` with a static ``i``), so the
    access plan sees one slice per leaf, as in JAX's jaxpr: no loop entry
    and no collection (``layer_params`` opens a loop entry)."""
    if isinstance(layers, list):
        return layers[l]
    out: dict = {}
    for path, a in tree_items(layers):
        node = out
        *parents, name = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = a[l : l + 1].squeeze(0)
    return out


def block_kinds(cfg) -> list[str]:
    """The hybrid's layer kinds ("rec" or "attn"), layer by layer."""
    pattern = cfg.block_pattern
    return [pattern[i % len(pattern)] for i in range(cfg.n_layers)]


# the matrix products whose outputs ``remat="dots"`` keeps (JAX's
# ``checkpoint_dots`` keeps every ``dot_general``); ``x @ w`` and ``einsum``
# reach the dispatcher as these
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    if op in _DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _save_collectives(ctx, op, *args, **kwargs):
    """Keep the MoE all-to-all exchanges' outputs (JAX names the a2a path's
    output ``moe_out`` and saves it), so that the recomputation does not
    exchange the tokens again; recompute everything else."""
    if op is torch.ops._c10d_functional.all_to_all_single.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg):
    """``fn`` under the config's remat policy (JAX ``transformer._remat``),
    with non-reentrant ``torch.utils.checkpoint``:

    - ``"full"`` keeps only the layer's inputs and recomputes the rest in
      the backward pass;
    - ``"dots"`` (JAX's ``checkpoint_dots``) keeps the outputs of the matrix
      products (``aten.mm``, ``bmm``, ``addmm``, ``baddbmm``) and recomputes
      everything else, the flash kernels' ``autograd.Function`` included, as
      JAX's policy recomputes the Pallas call;
    - ``"save_collectives"`` keeps only the collectives' results that JAX
      names ``moe_out``: the ``ep_a2a`` MoE path's all-to-all exchanges
      (``models.moe.moe_apply_ep_a2a``); everywhere else (one device, the
      other mesh paths) it is therefore ``"full"``;
    - ``"none"`` keeps every activation.

    With autograd not recording there is nothing to keep, and ``fn`` runs as
    it is."""
    if cfg.remat not in ("full", "dots", "save_collectives", "none"):
        raise ValueError(f"unknown remat policy {cfg.remat!r}")
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    policy = {"dots": _save_dots, "save_collectives": _save_collectives}.get(cfg.remat)
    if policy is not None:
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts, policy))
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
    q = constrain(q, "batch", "inner_seq", "act_heads", None)
    k = constrain(k, "batch", "inner_seq", "act_kv", None)
    o = gqa_attention(
        q, k, v, causal=causal, impl=cfg.attn_impl, chunk=cfg.attn_chunk,
        local_window=local_window,
    )
    x = x + attn_output(o, lp["attn"], cfg, dt)
    x = constrain(x, "batch", "seq", "embed")
    return x, ((k, v) if collect_cache else None)


def ffn_block(x, lp, cfg, dt, mesh_info=None):
    """Pre-norm FFN sub-block: the MLP, or for the moe family the routed
    experts (``moe.moe_apply``, on the path ``mesh_info`` selects)."""
    h = apply_norm(cfg.norm, x, lp["ln2"], lp.get("ln2_b"))
    h = constrain(h, "batch", "seq", "embed")
    if cfg.family == "moe":
        x = x + moe_apply(h, lp["mlp"], cfg, dt, mesh_info)
    else:
        x = x + mlp_apply(cfg.mlp, h, lp["mlp"], dt)
    return constrain(x, "batch", "seq", "embed")


def dense_layer(x, lp, cfg, dt, angles, mesh_info=None, *, causal=True, local_window=0,
                collect_cache=False):
    x, kv = attn_block(
        x, lp, cfg, dt, angles, causal=causal, local_window=local_window,
        collect_cache=collect_cache,
    )
    return ffn_block(x, lp, cfg, dt, mesh_info), kv


def mamba_layer(x, lp, cfg, dt, collect_cache=False):
    h = apply_norm(cfg.norm, x, lp["ln1"], lp.get("ln1_b"))
    y, conv_state, ssm_state = mamba_block(h, lp["mamba"], cfg, dt)
    x = constrain(x + y, "batch", "seq", "embed")
    return x, ((conv_state, ssm_state) if collect_cache else None)


def rec_layer(x, lp, cfg, dt, collect_cache=False):
    h = apply_norm(cfg.norm, x, lp["ln1"], lp.get("ln1_b"))
    y, conv_state, rec_state = recurrent_block(h, lp["rec"], cfg, dt)
    x = constrain(x + y, "batch", "seq", "embed")
    x = ffn_block(x, lp, cfg, dt)
    return x, ((conv_state, rec_state) if collect_cache else None)


def cross_kv(enc_out, lp, cfg, dt):
    """encdec: the cross-attention's k, v [B, F, KV, hd] projected from the
    encoder output [B, F, d] (no bias)."""
    cp = lp["cross"]
    k = split_last(enc_out @ cp["wk"].to(dt), cfg.n_kv_heads, cfg.head_dim)
    v = split_last(enc_out @ cp["wv"].to(dt), cfg.n_kv_heads, cfg.head_dim)
    return k, v


def cross_attn(x, lp, cfg, dt, k, v, impl):
    """encdec: the pre-norm (``lnc``) cross-attention sub-block, the
    decoder's queries against the encoder's ``k``, ``v``, unmasked."""
    h = apply_norm(cfg.norm, x, lp["lnc"], lp.get("lnc_b"))
    cp = lp["cross"]
    q = split_last(h @ cp["wq"].to(dt), cfg.n_heads, cfg.head_dim)
    o = gqa_attention(q, k, v, causal=False, impl=impl, chunk=cfg.attn_chunk)
    return x + merge_heads(o) @ cp["wo"].to(dt)


def _stack_pairs(pairs):
    """[(a_l, b_l, ...)] per layer -> (stacked a, stacked b, ...)."""
    return tuple(torch.stack(xs) for xs in zip(*pairs))


def _n_stacked(layers) -> int:
    """The number of layers in stacked ``[L, ...]`` layer parameters or a
    list of per-layer trees."""
    if isinstance(layers, list):
        return len(layers)
    return next(iter(tree_items(layers)))[1].shape[0]


def _walk(layers, cfg, x, body, collect_cache):
    """``body(x, lp) -> (x, cache)`` over every layer of ``layers`` under
    the config's remat policy; with ``collect_cache`` also the per-layer
    caches stacked on a leading layer dim."""
    layer = _remat(body, cfg)
    caches = []
    for l in range(_n_stacked(layers)):
        x, cache = layer(x, layer_params(layers, l))
        caches.append(cache)
    if not collect_cache:
        return x, None
    return x, _stack_pairs(caches)


def forward_stack(params, cfg, x, positions, mesh_info=None, *, group="layers", causal=True,
                  collect_cache=False):
    """A homogeneous stack: ``params[group]`` of the dense, moe and ssm
    families, or encdec's encoder (``enc_layers``, not causal); with
    ``collect_cache`` also returns the per-layer caches stacked on a leading
    layer dim: (k, v) [L, B, S, KV, hd] each (dense, moe), (conv [L, B,
    K-1, d_inner], ssm [L, B, d_inner, N]) (ssm)."""
    dt = cfg_dtype(cfg)
    if cfg.family == "ssm":
        body = lambda x, lp: mamba_layer(x, lp, cfg, dt, collect_cache)  # noqa: E731
    else:
        angles = rope_angles(cfg.rope, positions, cfg.head_dim, cfg.rope_theta)
        body = lambda x, lp: dense_layer(x, lp, cfg, dt, angles, mesh_info,  # noqa: E731
                                         causal=causal, collect_cache=collect_cache)
    return _walk(params[group], cfg, x, body, collect_cache)


def forward_encoder(params, cfg, frames, mesh_info=None):
    """whisper's encoder over precomputed (stub) frame embeddings [B, F, d]:
    the sinusoidal embedding added, the non-causal ``enc_layers`` stack,
    then ``enc_norm``."""
    dt = cfg_dtype(cfg)
    pos = torch.arange(frames.shape[1], device=frames.device)[None, :]
    x = frames.to(dt) + sinusoidal_embedding(pos, cfg.d_model).to(dt)
    x, _ = forward_stack(params, cfg, x, pos, mesh_info, group="enc_layers", causal=False)
    return apply_norm(cfg.norm, x, params["enc_norm"], params.get("enc_norm_b"))


def forward_decoder(params, cfg, x, frames, mesh_info=None, *, collect_cache=False):
    """whisper's decoder over the embedded tokens ``x`` (absolute positions
    added): per layer causal self-attention, cross-attention to the
    encoder's output over ``frames``, then the MLP.  With ``collect_cache``
    also returns (k, v, cross k, cross v), each stacked over the layers."""
    dt = cfg_dtype(cfg)
    enc_out = forward_encoder(params, cfg, frames, mesh_info)

    def body(h, lp):
        h, self_kv = attn_block(h, lp, cfg, dt, None, collect_cache=collect_cache)
        kc, vc = cross_kv(enc_out, lp, cfg, dt)
        h = cross_attn(h, lp, cfg, dt, kc, vc, cfg.attn_impl)
        return (ffn_block(h, lp, cfg, dt, mesh_info),
                (*self_kv, kc, vc) if collect_cache else None)

    return _walk(params["dec_layers"], cfg, x, body, collect_cache)


def forward_hybrid(params, cfg, x, positions, mesh_info=None, *, collect_cache=False):
    """recurrentgemma: a Python loop over the (rec, rec, attn) pattern; the
    attention layers attend within ``cfg.local_window``.  With
    ``collect_cache`` also returns ((conv, rec), (k, v)), each stacked over
    its kind's layers."""
    dt = cfg_dtype(cfg)
    angles = rope_angles(cfg.rope, positions, cfg.head_dim, cfg.rope_theta)
    rec = _remat(lambda x, lp: rec_layer(x, lp, cfg, dt, collect_cache), cfg)
    attn = _remat(
        lambda x, lp: dense_layer(x, lp, cfg, dt, angles, causal=True,
                                  local_window=cfg.local_window, collect_cache=collect_cache),
        cfg,
    )
    rec_caches, attn_caches = [], []
    for kind in block_kinds(cfg):
        if kind == "rec":
            lp = static_layer_params(params["rec_layers"], len(rec_caches))
            x, cache = rec(x, lp)
            rec_caches.append(cache)
        else:
            lp = static_layer_params(params["attn_layers"], len(attn_caches))
            x, kv = attn(x, lp)
            attn_caches.append(kv)
    if not collect_cache:
        return x, None
    return x, (_stack_pairs(rec_caches), _stack_pairs(attn_caches))


# ---------------------------------------------------------------------------
# Decode (single token against a cache)
# ---------------------------------------------------------------------------


def _decode_attn(x, lp, cfg, dt, k_cache, v_cache, pos, angles, *, window: int = 0,
                 kv_len=None):
    """One-token attention against a cache [B, S, KV, hd]: writes the new
    k/v at ``pos`` (or ``pos % window`` for ring caches) and attends to the
    positions it holds; ``angles``: ``rope_angles`` of position ``pos``.
    ``pos`` is a Python int or a 0-d int tensor on the step's device;
    ``kv_len`` is ``pos + 1`` in the form flash-decode takes (``_kv_len``).

    The write is in place into ``k_cache`` / ``v_cache`` (views of the
    stacked cache): the counterpart of the JAX code's
    ``dynamic_update_slice`` on a donated buffer; at a device position it
    is an ``index_copy_`` on the slot dim, which a CUDA graph can replay.
    At an int position a slot outside the cache raises ``IndexError`` where
    JAX's write would be clamped onto the last slot, so a ring must hold
    ``min(window, max_len)`` slots (``Server._pad_cache``); at a device
    position the caller checks the range on the host before it replays."""
    h = apply_norm(cfg.norm, x, lp["ln1"], lp.get("ln1_b"))
    q, k, v = qkv_project(h, lp["attn"], cfg, dt)
    q = apply_rope(q, angles)
    k = apply_rope(k, angles)
    if kv_len is None and not window:
        kv_len = _kv_len(pos)
    kw = dict(cfg=cfg, dt=dt, pos=pos, window=window, kv_len=kv_len)
    ctx = current_mesh_rules()
    if ctx is None:
        _write_cache(k, v, k_cache, v_cache, pos, window)
        o = _attend_cache(q, k_cache, v_cache, **kw)
    else:
        o = _sharded_cache_attention(ctx, q, k, v, k_cache, v_cache, kw)
    return x + attn_output(o, lp["attn"], cfg, dt)


def _write_cache(k, v, k_cache, v_cache, pos, window):
    """The new k/v [B, 1, KV, hd] into slot ``pos`` (``pos % window``)."""
    slot = pos % window if window else pos
    if isinstance(pos, torch.Tensor):
        at = slot.reshape(1).long()
        k_cache.index_copy_(1, at, k.to(k_cache.dtype))
        v_cache.index_copy_(1, at, v.to(v_cache.dtype))
    else:
        k_cache[:, slot] = k[:, 0].to(k_cache.dtype)
        v_cache[:, slot] = v[:, 0].to(v_cache.dtype)


def _attend_cache(q, k_cache, v_cache, *, cfg, dt, pos, window, kv_len):
    """q [B, 1, H, hd] against the positions the cache holds."""
    if window:
        # ring buffer: mask by the absolute position each slot holds
        S = k_cache.shape[1]
        slot = pos % window
        idx = torch.arange(S, device=q.device)
        ring_pos = pos - ((slot - idx) % S)
        valid = (ring_pos >= 0) & (ring_pos >= pos - window + 1)
        return _masked_decode_attention(q, k_cache, v_cache, valid, cfg)
    if _kernel_route(cfg, k_cache):
        # the flash-decode kernel reads the cache in its stored dtype (fp8
        # caches halve the traffic) and only the first pos + 1 slots
        return ops.decode_attention(q[:, 0], k_cache, v_cache, kv_len).to(dt)[:, None]
    # the local function: under a mesh this runs inside a shard_map body
    return local_attention(q, k_cache.to(dt), v_cache.to(dt), causal=False, impl="naive",
                            chunk=cfg.attn_chunk, q_offset=pos, local_window=0, kv_len=kv_len)


def _kernel_route(cfg, k_cache) -> bool:
    """Whether the decode attends through flash-decode: ``attn_impl="pallas"``
    and a cache (under a mesh: this rank's shard of it) of a multiple of 128
    slots, JAX's guard."""
    return cfg.attn_impl == "pallas" and k_cache.shape[1] % 128 == 0


def _sharded_cache_attention(ctx, q, k, v, k_cache, v_cache, kw):
    """The cache write and the attention under a mesh, as a ``shard_map``
    on each rank's rows and heads.  Where the rules shard the cache's
    sequence (``cache_seq``: decode), that is ``_seq_sharded_attention``.
    Otherwise q is split by (batch, act_heads), the new k/v and the cache
    [B, S, KV, hd] by (batch, act_kv), the cache's sequence whole; where q's
    heads are split and the cache's are not, each rank writes every kv head
    and attends with those its query heads read."""
    from repro_torch.launch.compat import shard_map

    mesh, rules = ctx
    if rules.get("cache_seq") is not None:
        return _seq_sharded_attention(mesh, rules, q, k, v, k_cache, v_cache, kw)
    qs = logical_to_pspec(("batch", None, "act_heads", None), rules)
    ks = logical_to_pspec(("batch", None, "act_kv", None), rules)
    G = q.shape[2] // k.shape[2]

    def body(ql, kl, vl, kc, vc):
        _write_cache(kl, vl, kc, vc, kw["pos"], kw["window"])
        kc, vc = local_kv(mesh, qs[2], ks[2], ql, kc, vc, G)
        return _attend_cache(ql, kc, vc, **kw)

    return shard_map(body, mesh, (qs, ks, ks, ks, ks), qs)(q, k, v, k_cache, v_cache)


def _seq_sharded_attention(mesh, rules, q, k, v, k_cache, v_cache, kw):
    """Decode attention against a cache whose sequence is split over the
    mesh axis ``cache_seq`` names, or over a tuple of axes (the batch-1
    ``long`` layout's ``("pod", "data")``), taken as one flattened axis
    (``launch.shardings.cache_pspecs``' decode layout: [B, S, KV, hd] by
    (batch, cache_seq), the kv heads whole), as a ``shard_map``.  Each
    rank holds the ``n = S / R`` slots from ``start = r * n`` (rank ``r``
    of ``R`` along the axis, the first of a tuple major:
    ``launch.mesh.entry_rank``):

    - q's heads and the new k/v's kv heads are gathered over the axis (the
      body's inputs are whole on heads);
    - only the rank whose slots hold the write slot (``pos``, or for the
      hybrid's ring ``pos % window``) writes the new k/v; at a device
      ``pos`` every rank writes a clamped slot, the others their old row
      back, so a captured step replays on every rank alike;
    - a full cache: flash-decode (the route ``_kernel_route`` decides on the
      shard's length) attends to the shard's live slots, ``pos + 1 - start``
      of them (clamped to [0, n] by the kernel: an empty shard gives lse
      -1e30), with each head's log-sum-exp;
    - a ring of ``S = min(window, max_len)`` slots: each rank masks its
      slots by the absolute position each holds, ``pos - ((pos % window -
      (start + j)) mod S)``, valid where >= 0 and > ``pos - window`` (as
      ``_attend_cache`` does over the whole ring), and attends with the
      plain masked attention and its log-sum-exp (JAX's route for a window);
    - the ranks' (o, lse) are all-gathered over the axis and merged
      (``merge_partials``: what GSPMD computes by reducing the softmax's
      statistics over the axis), and each rank keeps its own query heads
      (act_heads) for ``attn_output``.

    On one rank this is the unsharded step's arithmetic: a merge of one
    part is that part, bitwise."""
    from repro_torch.launch.compat import shard_map
    from repro_torch.launch.mesh import entry_rank
    from repro_torch.launch.shardings import PSpec, placements

    axis, window, pos, cfg, dt = (rules["cache_seq"], kw["window"], kw["pos"], kw["cfg"],
                                  kw["dt"])
    b, heads = rules["batch"], rules.get("act_heads")
    whole = PSpec(b, None, None, None)
    cs = PSpec(b, axis, None, None)
    want = placements(mesh, cs)
    for c in (k_cache, v_cache):
        if tuple(getattr(c, "placements", ())) != want:
            raise ValueError(f"the cache must lie in cache_pspecs' decode layout {cs} "
                             f"({want}); it has {getattr(c, 'placements', 'no placements')}")
    S = k_cache.shape[1]  # the whole cache's slots
    if not window and not isinstance(pos, torch.Tensor) and not 0 <= pos < S:
        raise IndexError(f"position {pos} outside the cache's {S} slots")
    slot = pos % window if window else pos

    def body(ql, kl, vl, kc, vc):
        n = kc.shape[1]
        start = entry_rank(mesh, axis) * n
        _write_shard(kl, vl, kc, vc, slot - start)
        if window:
            ring_pos = pos - ((slot - (start + torch.arange(n, device=ql.device))) % S)
            valid = (ring_pos >= 0) & (ring_pos > pos - window)
            o, lse = _masked_decode_attention(ql, kc, vc, valid, cfg, with_lse=True)
            o = o[:, 0]
        else:
            o, lse = _attend_shard(ql, kc, vc, cfg, dt,
                                   _local_kv_len(kw["kv_len"], start, n, ql.device))
        D = o.shape[-1]
        parts = _all_gather(torch.cat([o.float(), lse[..., None]], dim=-1)[None], mesh, axis)
        o = merge_partials(parts[..., :D], parts[..., D], ql.dtype)[:, None]
        if heads is not None:
            Hl = o.shape[2] // mesh.size(mesh.mesh_dim_names.index(heads))
            h0 = mesh.get_local_rank(heads) * Hl
            o = o[:, :, h0:h0 + Hl]
        return o

    qs = PSpec(b, None, heads, None)
    return shard_map(body, mesh, (whole, whole, whole, cs, cs), qs)(q, k, v, k_cache, v_cache)


def _write_shard(k, v, k_cache, v_cache, slot):
    """The new k/v [B, 1, KV, hd] into slot ``slot`` of a cache shard [B, n,
    KV, hd] where it lies in the shard (``slot`` = the write slot less the
    shard's ``start``).  At a device position every rank writes the clamped
    slot: the new row where the shard holds the write slot, its own old row
    elsewhere (a row picked from [old, new] by index, which any cache dtype
    takes)."""
    n = k_cache.shape[1]
    if not isinstance(slot, torch.Tensor):
        if 0 <= slot < n:
            k_cache[:, slot] = k[:, 0].to(k_cache.dtype)
            v_cache[:, slot] = v[:, 0].to(v_cache.dtype)
        return
    at = slot.clamp(0, n - 1).reshape(1).long()
    owned = ((slot >= 0) & (slot < n)).reshape(1).long()
    for new, cache in ((k, k_cache), (v, v_cache)):
        rows = torch.cat([cache.index_select(1, at), new.to(cache.dtype)], dim=1)
        cache.index_copy_(1, at, rows.index_select(1, owned))


def _local_kv_len(kv_len, start: int, n: int, device):
    """A shard's live length ``kv_len - start`` (``kv_len`` = pos + 1, an
    int or flash-decode's int32 device tensor) in the form flash-decode
    takes: the step's own tensor on the first shard, an int32 tensor the
    kernel clamps to [0, n] past it; an int where it lies in [1, n]."""
    if isinstance(kv_len, torch.Tensor):
        return kv_len if start == 0 else (kv_len - start).to(torch.int32)
    local = kv_len - start
    if 1 <= local <= n:
        return local
    return torch.full((1,), min(max(local, 0), n), dtype=torch.int32, device=device)


def _attend_shard(q, k_cache, v_cache, cfg, dt, kv_len):
    """q [B, 1, H, hd] against the first ``kv_len`` slots of a cache shard
    -> (o [B, H, hd] in ``dt``, lse [B, H] f32): flash-decode where
    ``_kernel_route`` takes the shard, else its plain version on the cache
    cast to ``dt`` (the plain path's operands)."""
    if _kernel_route(cfg, k_cache):
        o, lse = ops.decode_attention(q[:, 0], k_cache, v_cache, kv_len, with_lse=True)
        return o.to(dt), lse
    return ref.decode_attention_ref(q[:, 0], k_cache.to(dt), v_cache.to(dt), kv_len,
                                    with_lse=True)


def _all_gather(x, mesh, axis):
    """``x`` [1, ...] of every rank on ``axis`` (a mesh axis, or a tuple of
    them taken as one flattened axis, the first major), stacked in that
    order: [R, ...].  One collective over the axes' group
    (``launch.mesh.entry_group``)."""
    from torch.distributed import _functional_collectives as funcol

    from repro_torch.launch.mesh import entry_group

    gather = getattr(funcol, "all_gather_single", None) or funcol.all_gather_tensor
    out = gather(x.contiguous(), 0, entry_group(mesh, axis))
    return out.wait() if isinstance(out, funcol.AsyncCollectiveTensor) else out


def _masked_decode_attention(q, k_cache, v_cache, valid, cfg, with_lse: bool = False):
    """q [B, 1, H, hd] against every slot of k/v [B, S, KV, hd] where
    ``valid`` ([S], or [B, 1, 1, 1, S]: a mask per row); the cache upcast to
    q's dtype, scores in f32.  With ``with_lse`` also each head's f32
    log-sum-exp of its valid scaled scores [B, H], -1e30 where no slot is
    valid (such a part weighs nothing in ``merge_partials``)."""
    B, S, KV, hd = k_cache.shape
    H = q.shape[2]
    G = H // KV
    q5 = q.reshape(B, 1, KV, G, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", q5.float(), k_cache.to(q.dtype).float()) / (hd**0.5)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v_cache.to(q.dtype)).reshape(B, 1, H, hd)
    if not with_lse:
        return o
    live = valid.expand(s.shape).any(dim=-1)
    lse = torch.where(live, torch.logsumexp(s, dim=-1), NEG_INF)
    return o, lse.reshape(B, H)


def _kv_len(pos):
    """The live cache length after the write at ``pos``: ``pos + 1``, as an
    int, or as the one-element int32 tensor flash-decode reads on the
    device."""
    if isinstance(pos, torch.Tensor):
        return (pos + 1).to(torch.int32)
    return pos + 1


def step_positions(pos, shape: tuple, device):
    """The decode position ``pos`` as an int tensor of ``shape``: a 0-d
    device ``pos`` expanded (so that a captured step reads it at replay),
    an int filled in."""
    if isinstance(pos, torch.Tensor):
        return pos.reshape((1,) * len(shape)).expand(shape)
    return torch.full(shape, pos, dtype=torch.int32, device=device)


def _step_angles(cfg, pos, B: int, device):
    """``rope_angles`` of the decode position ``pos`` for a batch of ``B``
    ([B, 1]); mrope turns all three streams by ``pos`` ([3, B, 1]), as
    JAX's decode does."""
    shape = (3, B, 1) if cfg.rope == "mrope" else (B, 1)
    return rope_angles(cfg.rope, step_positions(pos, shape, device), cfg.head_dim,
                       cfg.rope_theta)


def decode_stack(params, cfg, x, cache, pos, mesh_info=None):
    """Dense, moe and encdec decode over all layers at ``pos`` (an int, or a
    0-d int tensor on x's device); updates ``cache`` in place and returns
    (x, cache).  encdec's layers (``dec_layers``) attend to the prefilled
    cross k/v after the self cache, on the plain path as in JAX (its
    ``impl="naive"``)."""
    dt = cfg_dtype(cfg)
    encdec = cfg.family == "encdec"
    layers = params["dec_layers" if encdec else "layers"]
    angles = _step_angles(cfg, pos, x.shape[0], x.device)
    kv_len = _kv_len(pos)  # once per step, not per layer
    for l in range(cfg.n_layers):
        lp = layer_params(layers, l)
        x = _decode_attn(x, lp, cfg, dt, cache["k"][l], cache["v"][l], pos, angles,
                         kv_len=kv_len)
        if encdec:
            x = cross_attn(x, lp, cfg, dt, cache["cross_k"][l].to(dt),
                           cache["cross_v"][l].to(dt), "naive")
        x = ffn_block(x, lp, cfg, dt, mesh_info)
    return x, cache


def decode_ssm(params, cfg, x, cache):
    """ssm decode over all layers: one recurrence step per layer from the
    cache's (conv, ssm) states, which the block overwrites in place (the
    scan writes the ssm state straight into the cache; under a mesh, into
    this rank's shard of it); returns (x, cache)."""
    dt = cfg_dtype(cfg)
    for l in range(cfg.n_layers):
        lp = layer_params(params["layers"], l)
        hn = apply_norm(cfg.norm, x, lp["ln1"], lp.get("ln1_b"))
        y, _, _ = mamba_block(hn, lp["mamba"], cfg, dt, conv_state=cache["conv"][l],
                              ssm_state=cache["ssm"][l])
        x = x + y
    return x, cache


def decode_hybrid(params, cfg, x, cache, pos):
    """hybrid decode at ``pos`` (an int, or a 0-d int tensor on x's
    device): one step per rec layer from its (conv, rec) states, which the
    block overwrites in place, one ring-window attention per attn layer;
    returns (x, cache)."""
    dt = cfg_dtype(cfg)
    angles = _step_angles(cfg, pos, x.shape[0], x.device)
    rec_i = attn_i = 0
    for kind in block_kinds(cfg):
        if kind == "rec":
            lp = static_layer_params(params["rec_layers"], rec_i)
            hn = apply_norm(cfg.norm, x, lp["ln1"], lp.get("ln1_b"))
            y, _, _ = recurrent_block(hn, lp["rec"], cfg, dt, conv_state=cache["conv"][rec_i],
                                      rec_state=cache["rec"][rec_i])
            x = ffn_block(x + y, lp, cfg, dt)
            rec_i += 1
        else:
            lp = static_layer_params(params["attn_layers"], attn_i)
            x = _decode_attn(x, lp, cfg, dt, cache["k"][attn_i], cache["v"][attn_i], pos,
                             angles, window=cfg.local_window)
            x = ffn_block(x, lp, cfg, dt)
            attn_i += 1
    return x, cache


def decode_layers(params, cfg, x, cache, pos, mesh_info=None):
    """The layer stack of one decode step, for the config's family; ``pos``
    is an int or a 0-d int tensor on x's device (the ssm family reads
    none)."""
    if cfg.family == "ssm":
        return decode_ssm(params, cfg, x, cache)
    if cfg.family == "hybrid":
        return decode_hybrid(params, cfg, x, cache, pos)
    return decode_stack(params, cfg, x, cache, pos, mesh_info)
