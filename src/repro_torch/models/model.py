"""Model facade for every family (dense, moe, ssm, hybrid, encdec):
parameter template, init, the training loss, prefill and decode.
Counterpart of ``repro.models.model``.

The parameter template (``build_template``) is the single source of truth
for parameter shapes and initializers; its dotted paths and stacked
``[L, ...]`` shapes are exactly the JAX package's.  The modality front ends
are stubs, as in JAX: whisper's encoder reads precomputed audio frames
(``batch["frames"]``), qwen2-vl reads precomputed embeddings
(``batch["embeds"]``) at 3-stream positions.
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.pricing import on_card
from repro_torch.launch.compat import shard_map

from .common import (
    ParamSpec,
    abstract_from_template,
    constrain,
    current_mesh_rules,
    init_from_template,
    logical_to_pspec,
    param_count,
    pspecs_from_template,
    tree_map,
)
from .layers import apply_norm, sinusoidal_embedding
from .transformer import (
    block_kinds,
    cfg_dtype,
    decode_layers,
    forward_decoder,
    forward_hybrid,
    forward_stack,
    step_positions,
    torch_dtype,
)

# ---------------------------------------------------------------------------
# Parameter templates
# ---------------------------------------------------------------------------


def _stack(tmpl: dict, n: int) -> dict:
    """Add a leading stacked-layers dim to every ParamSpec."""
    return tree_map(
        lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.axes, s.init, s.scale), tmpl
    )


def _attn_tmpl(cfg: ModelConfig, cross: bool = False) -> dict:
    """Self-attention's projections; the ``cross`` block (encdec) has no
    biases and no qk-norm."""
    d, qd, kvd, hd = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.head_dim
    t = {
        "wq": ParamSpec((d, qd), ("embed", "heads")),
        "wk": ParamSpec((d, kvd), ("embed", "kv_heads")),
        "wv": ParamSpec((d, kvd), ("embed", "kv_heads")),
        "wo": ParamSpec((qd, d), ("heads", "embed")),
    }
    if cfg.qkv_bias and not cross:
        t["bq"] = ParamSpec((qd,), ("heads",), init="zeros")
        t["bk"] = ParamSpec((kvd,), ("kv_heads",), init="zeros")
        t["bv"] = ParamSpec((kvd,), ("kv_heads",), init="zeros")
    if cfg.attn_out_bias and not cross:
        t["bo"] = ParamSpec((d,), ("embed",), init="zeros")
    if cfg.qk_norm and not cross:
        t["q_norm"] = ParamSpec((hd,), (None,), init="ones")
        t["k_norm"] = ParamSpec((hd,), (None,), init="ones")
    return t


def _norm_tmpl(cfg: ModelConfig, name: str) -> dict:
    t = {name: ParamSpec((cfg.d_model,), ("embed",), init="ones")}
    if cfg.norm == "layernorm":
        t[f"{name}_b"] = ParamSpec((cfg.d_model,), ("embed",), init="zeros")
    return t


def _mlp_tmpl(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp in ("swiglu", "geglu"):
        t = {
            "wi_gate": ParamSpec((d, f), ("embed", "ff")),
            "wi_up": ParamSpec((d, f), ("embed", "ff")),
            "wo": ParamSpec((f, d), ("ff", "embed")),
        }
    else:  # gelu / relu2
        t = {
            "wi": ParamSpec((d, f), ("embed", "ff")),
            "wo": ParamSpec((f, d), ("ff", "embed")),
        }
        if cfg.mlp_bias:
            t["bi"] = ParamSpec((f,), ("ff",), init="zeros")
    if cfg.mlp_bias:
        t["bo"] = ParamSpec((d,), ("embed",), init="zeros")
    return t


def _moe_tmpl(cfg: ModelConfig) -> dict:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": ParamSpec((d, E), ("embed", None)),
        "we_gate": ParamSpec((E, d, f), ("experts", "embed", None)),
        "we_up": ParamSpec((E, d, f), ("experts", "embed", None)),
        "we_down": ParamSpec((E, f, d), ("experts", None, "embed")),
    }


def _mamba_tmpl(cfg: ModelConfig) -> dict:
    d, di, N, R, K = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank, cfg.ssm_conv
    return {
        "in_proj": ParamSpec((d, 2 * di), ("embed", "ff")),
        "conv_w": ParamSpec((di, K), ("ff", None)),
        "conv_b": ParamSpec((di,), ("ff",), init="zeros"),
        "x_proj": ParamSpec((di, R + 2 * N), ("ff", None)),
        "dt_w": ParamSpec((R, di), (None, "ff")),
        "dt_b": ParamSpec((di,), ("ff",), init="zeros"),
        "A_log": ParamSpec((di, N), ("ff", None), init="ones"),
        "D": ParamSpec((di,), ("ff",), init="ones"),
        "out_proj": ParamSpec((di, d), ("ff", "embed")),
    }


def _rec_tmpl(cfg: ModelConfig) -> dict:
    d, w, K = cfg.d_model, cfg.lru_width, cfg.ssm_conv
    return {
        "wy": ParamSpec((d, w), ("embed", "ff")),
        "wx": ParamSpec((d, w), ("embed", "ff")),
        "conv_w": ParamSpec((w, K), ("ff", None)),
        "conv_b": ParamSpec((w,), ("ff",), init="zeros"),
        "w_a": ParamSpec((w, w), ("ff", None)),
        "w_x": ParamSpec((w, w), ("ff", None)),
        "lam": ParamSpec((w,), ("ff",), init="ones"),
        "out_w": ParamSpec((w, d), ("ff", "embed")),
    }


def _layer_tmpl(cfg: ModelConfig, mixer: str = "attn") -> dict:
    """One pre-norm layer: ``ln1``, ``ln2``, the mixer (``attn`` or the
    hybrid's ``rec``) and the MLP (the moe family's: the router and the
    expert banks)."""
    t = {}
    t.update(_norm_tmpl(cfg, "ln1"))
    t.update(_norm_tmpl(cfg, "ln2"))
    t[mixer] = _attn_tmpl(cfg) if mixer == "attn" else _rec_tmpl(cfg)
    t["mlp"] = _moe_tmpl(cfg) if cfg.family == "moe" else _mlp_tmpl(cfg)
    return t


def padded_vocab(cfg: ModelConfig) -> int:
    """Vocab rows padded to a multiple of 256 (as in the JAX package, whose
    embedding and head shard evenly on any model axis up to 256)."""
    return -(-cfg.vocab_size // 256) * 256


def build_template(cfg: ModelConfig) -> dict:
    V, d = padded_vocab(cfg), cfg.d_model
    base = {"embed": ParamSpec((V, d), ("vocab", "embed"), scale=0.01)}
    if not cfg.tie_embeddings:
        base["lm_head"] = ParamSpec((d, V), ("embed", "vocab"), scale=0.01)
    base.update(_norm_tmpl(cfg, "final_norm"))
    if cfg.family in ("dense", "moe"):
        base["layers"] = _stack(_layer_tmpl(cfg), cfg.n_layers)
    elif cfg.family == "ssm":
        lt = _norm_tmpl(cfg, "ln1")
        lt["mamba"] = _mamba_tmpl(cfg)
        base["layers"] = _stack(lt, cfg.n_layers)
    elif cfg.family == "hybrid":
        kinds = block_kinds(cfg)
        base["rec_layers"] = _stack(_layer_tmpl(cfg, "rec"), kinds.count("rec"))
        base["attn_layers"] = _stack(_layer_tmpl(cfg, "attn"), kinds.count("attn"))
    elif cfg.family == "encdec":
        # the decoder layer: the encoder's, plus a cross-attention block
        # behind its own norm ``lnc``
        dec = _layer_tmpl(cfg)
        dec.update(_norm_tmpl(cfg, "lnc"))
        dec["cross"] = _attn_tmpl(cfg, cross=True)
        base["enc_layers"] = _stack(_layer_tmpl(cfg), cfg.enc_layers)
        base["dec_layers"] = _stack(dec, cfg.n_layers)
        base.update({k.replace("final_norm", "enc_norm"): v
                     for k, v in _norm_tmpl(cfg, "final_norm").items()})
    else:
        raise ValueError(f"unknown family {cfg.family}")
    return base


def count_params_config(cfg: ModelConfig, active_only: bool = False) -> int:
    """The parameter count; with ``active_only``, the moe family's expert
    banks count only the ``experts_per_token / n_experts`` share a token
    reads (JAX's rounding)."""
    tmpl = build_template(cfg)
    total = param_count(tmpl)
    if active_only and cfg.family == "moe":
        mlp = tmpl["layers"]["mlp"]
        expert_total = param_count({k: v for k, v in mlp.items() if k.startswith("we_")})
        total -= int(expert_total * (1.0 - cfg.experts_per_token / cfg.n_experts))
    return total


# parameters read through a norm (upcast to f32) rather than cast to the
# compute dtype, and those read in f32 (A_log, D: ``models/ssm.py``; lam:
# ``models/rglru.py``; rounding them would change every step's decay; the
# moe router: ``models/moe.py``, rounding it would move the top-k choice);
# ``Model.compute_params`` leaves them as they are
_KEEP_LEAVES = ("ln1", "ln1_b", "ln2", "ln2_b", "lnc", "lnc_b", "final_norm",
                "final_norm_b", "enc_norm", "enc_norm_b", "q_norm", "k_norm", "A_log", "D",
                "lam", "router")


# ---------------------------------------------------------------------------
# Model facade
# ---------------------------------------------------------------------------


class Model:
    def __init__(self, cfg: ModelConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.template = build_template(cfg)

    # -- params -------------------------------------------------------------

    def init_params(self, seed: int = 0) -> dict:
        """Random parameters from a seeded generator on the model's device
        (``normal * scale``, zeros, ones as the template says)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return init_from_template(
            self.template, gen, torch_dtype(self.cfg.param_dtype), self.device
        )

    def abstract_params(self) -> dict:
        """The parameter tree on the ``meta`` device: no allocation."""
        return abstract_from_template(self.template, torch_dtype(self.cfg.param_dtype))

    def param_pspecs(self, rules: dict) -> dict:
        """The ``PSpec`` of every parameter under ``rules`` (its template
        axes mapped through the rules)."""
        return pspecs_from_template(self.template, rules)

    def compute_params(self, params: dict) -> dict:
        """``params`` with every leaf that the model casts to the compute
        dtype on use (matmul weights, biases, embedding, head) cast once;
        norm parameters and those read in f32 stay as they are.  The values seen by the model are
        identical, so serving from the result gives the same outputs."""
        dt = cfg_dtype(self.cfg)

        def walk(tree):
            return {
                k: walk(v) if isinstance(v, dict)
                else (v if k in _KEEP_LEAVES else v.to(dt))
                for k, v in tree.items()
            }

        return walk(params)

    def prompt_shape(self, batch) -> tuple[int, int]:
        """(B, S) of the prompt that ``hidden_states`` reads from ``batch``:
        ``embeds`` where an ``embeds_input`` config is given them, else
        ``inputs``."""
        if self.cfg.embeds_input and "embeds" in batch:
            return tuple(batch["embeds"].shape[:2])
        return tuple(batch["inputs"].shape)

    # -- embedding / head ----------------------------------------------------

    def embed(self, params, tokens):
        """The embedding rows of ``tokens`` in the compute dtype.

        Where autograd does not need the table's gradient (serving, and any
        forward without grad), the rows come from ``ops.prefetch_gather``:
        the CUDA gather kernel on the card, its plain version elsewhere.
        Under autograd the lookup stays ``table[tokens]``: the gather kernel,
        like the TPU kernel it replaces, has no backward.  Under a mesh the
        table is split over ``act_vocab``'s axis: each rank looks up the
        tokens its rows hold, zeros the rest, and the sum over that axis
        (the constraint to (batch, seq, embed)) completes every row."""
        ctx = current_mesh_rules()
        if ctx is None:
            return _lookup(params["embed"], tokens).to(cfg_dtype(self.cfg))
        mesh, rules = ctx
        vocab = rules.get("act_vocab")

        def body(table, tok):
            if vocab is None:
                return _lookup(table, tok)
            n = table.shape[0]
            local = tok - mesh.get_local_rank(vocab) * n
            held = (local >= 0) & (local < n)
            rows = _lookup(table, torch.where(held, local, 0))
            return torch.where(held[..., None], rows, 0)

        x = shard_map(body, mesh,
                      (logical_to_pspec(("act_vocab", "embed"), rules),
                       logical_to_pspec(("batch", "inner_seq"), rules)),
                      logical_to_pspec(("batch", "inner_seq", "embed"), rules),
                      out_partial=(vocab,) if vocab else ())(params["embed"], tokens)
        return constrain(x, "batch", "seq", "embed").to(cfg_dtype(self.cfg))

    def logits(self, params, h):
        """bf16-rounded operands, f32 products and sums (the JAX code's
        ``preferred_element_type=f32``): f32 logits.

        On the card this is one GEMM on the head as it is stored, with f32
        accumulation and an f32 output: products of bf16 values are exact in
        f32, so only the order of the sums differs from widening both
        operands, and no f32 copy of the head (1 GB at chatglm3-6b width) is
        made.  The CPU has no such GEMM, so there both operands are widened.
        Both are differentiable (``_HeadMatmul`` on the card).  Under a mesh
        the GEMM runs on each rank's rows and vocab columns (a
        ``shard_map``), and the logits stay split over ``act_vocab``."""
        cfg = self.cfg
        dt = cfg_dtype(cfg)
        w = (params["embed"].T if cfg.tie_embeddings else params["lm_head"]).to(dt)
        h = constrain(h.to(dt), "batch", "seq", "embed")
        ctx = current_mesh_rules()
        if ctx is None:
            return _head_matmul(h, w)
        mesh, rules = ctx
        out = shard_map(_head_matmul, mesh,
                        (logical_to_pspec(("batch", "inner_seq", "embed"), rules),
                         logical_to_pspec(("embed", "act_vocab"), rules)),
                        logical_to_pspec(("batch", "inner_seq", "act_vocab"), rules))(h, w)
        return constrain(out, "batch", "inner_seq", "act_vocab")

    def _final_norm(self, params, h):
        return apply_norm(self.cfg.norm, h, params["final_norm"], params.get("final_norm_b"))

    # -- full-sequence forward -------------------------------------------------

    def hidden_states(self, params, batch, mesh_info=None, collect_cache=False):
        """The final-normed hidden states [B, S, d] and, with
        ``collect_cache``, what the family's cache is assembled from.
        encdec: the encoder over ``batch["frames"]``, then the decoder over
        the tokens at absolute positions; ``embeds_input`` configs read
        ``batch["embeds"]`` in place of the token embedding where it is
        given, at ``batch["positions"]`` ([3, B, S] for mrope; by default
        0..S-1 in every stream)."""
        cfg = self.cfg
        dt = cfg_dtype(cfg)
        if cfg.family == "encdec":
            x = self.embed(params, batch["inputs"])
            pos = torch.arange(x.shape[1], device=x.device)[None, :]
            x = x + sinusoidal_embedding(pos, cfg.d_model).to(dt)
            h, extras = forward_decoder(params, cfg, x, batch["frames"], mesh_info,
                                        collect_cache=collect_cache)
            return self._final_norm(params, h), extras
        if cfg.embeds_input and "embeds" in batch:
            x = batch["embeds"].to(dt)
        else:
            x = self.embed(params, batch["inputs"])
        B, S = x.shape[:2]
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
            if cfg.rope == "mrope":
                positions = positions[None].expand(3, B, S)
        forward = forward_hybrid if cfg.family == "hybrid" else forward_stack
        h, extras = forward(params, cfg, x, positions, mesh_info, collect_cache=collect_cache)
        return self._final_norm(params, h), extras

    # -- training loss -----------------------------------------------------------

    def loss_fn(self, params, batch, mesh_info=None):
        """Mean next-token cross-entropy of ``batch["targets"]`` (JAX
        ``Model.loss_fn``).  The logits cover the padded vocab, unsliced, as
        in JAX: the padding columns take part in the softmax."""
        cfg = self.cfg
        h, _ = self.hidden_states(params, batch, mesh_info)
        targets = batch["targets"]
        if cfg.loss_chunk and cfg.loss_chunk < h.shape[1]:
            return self._chunked_loss(params, h, targets)
        return _ce_loss(self.logits(params, h), targets)

    def _chunked_loss(self, params, h, targets):
        """The loss over ``loss_chunk``-long pieces of the sequence, with
        both operands of the head widened to f32 (JAX ``_chunked_loss``);
        a sequence tail shorter than a chunk is left out, as there."""
        cfg = self.cfg
        C = cfg.loss_chunk
        B, S, _ = h.shape
        n = S // C
        w = (params["embed"].T if cfg.tie_embeddings else params["lm_head"]).float()
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(n):
            tb = targets[:, i * C : (i + 1) * C]
            total = total + _ce_loss(h[:, i * C : (i + 1) * C].float() @ w, tb) * tb.numel()
        return total / (B * n * C)

    # -- serving -------------------------------------------------------------------

    def prefill(self, params, batch, mesh_info=None):
        """Full forward; returns (last-token logits [B, 1, vocab], decode
        cache)."""
        cfg = self.cfg
        h, extras = self.hidden_states(params, batch, mesh_info, collect_cache=True)
        logits = self.logits(params, h[:, -1:, :])[..., : cfg.vocab_size]
        return logits, self._assemble_cache(extras)

    def _assemble_cache(self, extras):
        cfg = self.cfg
        kvdt = self.kv_dtype()
        if cfg.family == "ssm":
            conv, ssm = extras
            return {"conv": conv, "ssm": ssm}
        if cfg.family == "hybrid":
            (conv, rec), (k, v) = extras
            # keep the last W positions; decode continues the ring at pos % W,
            # so position p must sit at slot p % W: roll the slice to align.
            # A prompt shorter than W keeps its S slots here and is padded
            # to min(W, max_len) by ``Server._pad_cache``
            W, S = cfg.local_window, k.shape[2]
            if S > W:
                k = torch.roll(k[:, :, -W:], shifts=S % W, dims=2)
                v = torch.roll(v[:, :, -W:], shifts=S % W, dims=2)
            return {"conv": conv, "rec": rec, "k": k.to(kvdt), "v": v.to(kvdt)}
        if cfg.family == "encdec":
            k, v, ck, cv = extras
            return {"k": k.to(kvdt), "v": v.to(kvdt),
                    "cross_k": ck.to(kvdt), "cross_v": cv.to(kvdt)}
        k, v = extras
        return {"k": k.to(kvdt), "v": v.to(kvdt)}

    def decode_step(self, params, cache, tokens, pos, mesh_info=None):
        """One decode step. tokens [B, 1] int; ``pos``: the position of the
        new token, a Python int or a 0-d int tensor on the model's device
        (the JAX step's traced int32, which a captured CUDA graph reads at
        replay).  Writes the new k/v (and recurrent states) into ``cache``
        in place and returns (logits [B, 1, vocab], cache)."""
        x = self.embed(params, tokens)
        if self.cfg.family == "encdec":  # absolute positions (whisper)
            pos11 = step_positions(pos, (1, 1), x.device)
            x = x + sinusoidal_embedding(pos11, self.cfg.d_model).to(x.dtype)
        h, cache = decode_layers(params, self.cfg, x, cache, pos, mesh_info)
        h = self._final_norm(params, h)
        return self.logits(params, h)[..., : self.cfg.vocab_size], cache

    # -- cache templates -------------------------------------------------------

    def kv_dtype(self) -> torch.dtype:
        cfg = self.cfg
        return torch_dtype(cfg.kv_cache_dtype or cfg.compute_dtype)

    def abstract_cache(self, batch_size: int, seq_len: int) -> dict:
        """The decode cache on the ``meta`` device: no allocation.  k/v in
        the KV-cache dtype, conv tails in the compute dtype, recurrent
        states in f32; the hybrid's ring holds min(window, seq_len) slots;
        encdec adds the cross-attention's k/v over the encoder's
        ``enc_positions`` frames."""
        cfg = self.cfg
        kvdt, cdt = self.kv_dtype(), cfg_dtype(cfg)
        KV, hd = cfg.n_kv_heads, cfg.head_dim

        def meta(shape, dtype):
            return torch.empty(shape, dtype=dtype, device="meta")

        if cfg.family == "ssm":
            L = cfg.n_layers
            return {"conv": meta((L, batch_size, cfg.ssm_conv - 1, cfg.d_inner), cdt),
                    "ssm": meta((L, batch_size, cfg.d_inner, cfg.ssm_state), torch.float32)}
        if cfg.family == "hybrid":
            kinds = block_kinds(cfg)
            n_rec, n_attn = kinds.count("rec"), kinds.count("attn")
            W = min(cfg.local_window, seq_len)
            return {"conv": meta((n_rec, batch_size, cfg.ssm_conv - 1, cfg.lru_width), cdt),
                    "rec": meta((n_rec, batch_size, cfg.lru_width), torch.float32),
                    "k": meta((n_attn, batch_size, W, KV, hd), kvdt),
                    "v": meta((n_attn, batch_size, W, KV, hd), kvdt)}
        shp = (cfg.n_layers, batch_size, seq_len, KV, hd)
        cache = {"k": meta(shp, kvdt), "v": meta(shp, kvdt)}
        if cfg.family == "encdec":
            cshp = (cfg.n_layers, batch_size, cfg.enc_positions, KV, hd)
            cache.update(cross_k=meta(cshp, kvdt), cross_v=meta(cshp, kvdt))
        return cache


class _HeadMatmul(torch.autograd.Function):
    """h [T, d] @ w [d, V], both in the compute dtype, as one GEMM with f32
    accumulation and an f32 output.  ``torch.mm(..., out_dtype=...)`` has no
    derivative of its own; here the f32 cotangent is rounded once to the
    compute dtype and both gradients are GEMMs in that dtype with f32
    accumulation: dh = g w^T in h's dtype, dw = h^T g in w's dtype, where
    JAX's transpose keeps g in f32 and rounds the same two products.  No f32
    copy of the head is made in either direction."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        return torch.mm(h, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        g = g.to(h.dtype)
        dh = torch.mm(g, w.T) if ctx.needs_input_grad[0] else None
        dw = torch.mm(h.T, g) if ctx.needs_input_grad[1] else None
        return dh, dw


def _lookup(table, tokens):
    """``table[tokens]``: the gather kernel where autograd needs no
    gradient of the table, else indexing."""
    if torch.is_grad_enabled() and table.requires_grad:
        return table[tokens]
    return ops.prefetch_gather(table, tokens.reshape(-1)).reshape(*tokens.shape, table.shape[1])


def _head_matmul(h, w):
    """h [..., d] @ w [d, V] -> f32 logits: ``_HeadMatmul`` for bf16 on the
    card (and on ``meta`` under the cost model's ``pricing``), both operands
    widened to f32 elsewhere."""
    if on_card(h) and h.dtype != torch.float32:
        out = _HeadMatmul.apply(h.reshape(-1, h.shape[-1]), w)
        return out.reshape(*h.shape[:-1], w.shape[-1])
    return h.float() @ w.float()


def _ce_loss(logits, targets):
    """Mean of logsumexp(logits) - logits[target] in f32; under a mesh,
    over logits split on the vocab (``_vocab_parallel_ce``)."""
    ctx = current_mesh_rules()
    if ctx is not None:
        return _vocab_parallel_ce(ctx, logits, targets)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return torch.mean(logz - gold)


def _vocab_parallel_ce(ctx, logits, targets):
    """The cross-entropy of logits split over ``act_vocab``'s axis
    (Megatron's vocab-parallel loss), in two passes.  First, with no
    gradient, logz = max + log(sum exp(logits - max)): the max a DTensor
    reduction (MAX over the axis), each rank's sum of exp ``Partial`` over
    it.  Then on each rank the sum ``s`` of exp(logits - logz) and its part
    of the target logit (zero where another rank holds the target), both
    ``Partial``; their reduction, differentiable, is DTensor's.
    loss = mean(logz + (s - s.detach()) - gold): ``s - s.detach()`` is 0 and
    carries the gradient exp(logits - logz), the one ``torch.logsumexp``
    gives, so on one rank the loss and its gradient are ``_ce_loss``'s
    bitwise."""
    mesh, rules = ctx
    vocab = rules.get("act_vocab")
    lspec = logical_to_pspec(("batch", "inner_seq", "act_vocab"), rules)
    tspec = logical_to_pspec(("batch", "inner_seq"), rules)
    partial = (vocab,) if vocab else ()
    logits = constrain(logits.float(), "batch", "inner_seq", "act_vocab")
    with torch.no_grad():
        m = constrain(logits.amax(dim=-1), "batch", "inner_seq")
        sumexp = shard_map(lambda lg, mx: torch.exp(lg - mx[..., None]).sum(-1), mesh,
                           (lspec, tspec), tspec, out_partial=partial)(logits, m)
        logz = m + torch.log(constrain(sumexp, "batch", "inner_seq"))

    def body(lg, tg, lz):
        off = mesh.get_local_rank(vocab) * lg.shape[-1] if vocab else 0
        s = torch.exp(lg - lz[..., None]).sum(-1)
        local = tg.long() - off
        held = (local >= 0) & (local < lg.shape[-1])
        gold = torch.gather(lg, -1, torch.where(held, local, 0)[..., None])[..., 0]
        return s, torch.where(held, gold, 0.0)

    s, gold = shard_map(body, mesh, (lspec, tspec, tspec), (tspec, tspec),
                        out_partial=partial)(logits, targets, logz)
    s, gold = (constrain(t, "batch", "inner_seq") for t in (s, gold))
    return torch.mean(logz + (s - s.detach()) - gold)
