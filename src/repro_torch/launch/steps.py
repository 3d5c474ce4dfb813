"""Step functions (train / prefill / decode), the MoE path a mesh selects
(``mesh_info_for``), their abstract inputs on the ``meta`` device
(``input_specs``, ``decode_input_specs``: what the dry-run and the cost
model trace) and a concrete batch for tests and examples.  Counterpart of
``repro.launch.steps``.

Under a mesh the steps run on DTensors placed by the logical rules, inside
``models.common.activate_sharding(mesh, rules)``, which the caller enters
(as JAX's callers do).  The gradients of the train step are reduced as
GSPMD reduces them: each is brought to its parameter's placements, a sum
over the data axes of the ranks' parts of the global mean (an all-reduce),
a reduce-scatter where fsdp shards the parameter.

PyTorch runs eagerly, so a step is a plain function (the serving steps
under ``torch.inference_mode``).  The JAX server's compiled decode step
(``jax.jit(decode_fn, donate_argnums=(1,))``, replayed with ``pos`` as a
traced int32) has its counterpart in ``CapturedDecode``: the eager step
captured once in a CUDA graph over static buffers, the position among them
on the device, and replayed for every token; the continuous batcher's
per-slot step (``runtime.scheduler``, JAX's ``jax.jit(self._decode_step)``)
is captured by the same class, with one position per slot.  The train and
prefill steps stay eager (they are bound by the device, not by the host).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.kernels import counters
from repro_torch.models.common import current_mesh_rules, tree_items, tree_map
from repro_torch.models.model import Model
from repro_torch.optim import AdamW, warmup_cosine

from .mesh import data_axes


def mesh_info_for(cfg: ModelConfig, mesh) -> Optional[tuple]:
    """(mesh, data_axes, model_axis[, mode]) for the MoE paths.

    Under FSDP the expert banks are gathered per layer like every other
    weight and routing runs rank-local (model_axis=None selects the
    fsdp-local path in ``moe_apply``)."""
    if mesh is None or cfg.family != "moe":
        return None
    dp = data_axes(mesh)
    if cfg.parallelism == "fsdp":
        return (mesh, dp + ("model",), None)
    if cfg.parallelism == "ep_a2a":
        return (mesh, dp + ("model",), "model", "ep_a2a")
    # "tp" and "fsdp_ep": expert parallelism over `model`, batch over data
    return (mesh, dp if len(dp) > 1 else dp[0], "model")


def serving_mode(mesh):
    """The serving steps' autograd context: ``inference_mode``, or under a
    mesh ``no_grad`` (DTensor cannot take views of its parameters in
    inference mode: an inference tensor has no version counter)."""
    return torch.no_grad() if mesh is not None else torch.inference_mode()


def _require_context(mesh) -> None:
    if mesh is not None and current_mesh_rules() is None:
        raise RuntimeError("a step built for a mesh runs inside "
                           "models.common.activate_sharding(mesh, rules)")


def make_optimizer(total_steps: int = 10_000) -> AdamW:
    warmup = max(1, min(200, total_steps // 10))
    return AdamW(learning_rate=warmup_cosine(3e-4, warmup, total_steps))


# the stacked ``[L, ...]`` layer trees of every family: ``layers`` (dense,
# moe, ssm), the hybrid's ``rec_layers`` and ``attn_layers``, encdec's
# ``enc_layers`` and ``dec_layers``
LAYER_STACKS = ("layers", "rec_layers", "attn_layers", "enc_layers", "dec_layers")


def _layer_views(stack: dict, grads: dict) -> list:
    """One autograd leaf per layer of a stacked tree: the view ``a[l]`` of
    each leaf, detached, whose ``.grad`` is row ``l`` of ``grads``."""
    n = next(iter(tree_items(stack)))[1].shape[0]
    views = []
    for l in range(n):
        lp = tree_map(lambda a: a[l].detach().requires_grad_(), stack)
        for (_, leaf), (_, g) in zip(tree_items(lp), tree_items(grads)):
            leaf.grad = g[l]
        views.append(lp)
    return views


def loss_and_grads(model: Model, params: dict, batch: dict, mesh_info=None):
    """(loss, gradient tree) of ``model.loss_fn`` at ``params``: the
    counterpart of ``jax.value_and_grad(Model.loss_fn)``, with the same tree.

    The autograd leaves are the top-level parameters and, for each stacked
    ``[L, ...]`` layer tree of the family (``LAYER_STACKS``), one view per
    layer, handed to the model as a list of per-layer trees.  Each view's
    gradient accumulates in place into row ``l`` of a stacked f32 gradient
    tensor.  With the stacked tensor itself as the leaf, autograd would
    build a zero tensor the size of the whole stack for every layer's view
    and add them all up: O(L^2) bytes per step.  A parameter the loss does
    not read (the token embedding of an ``embeds_input`` batch with an
    untied head) gets a zero gradient, as under ``jax.grad``."""
    top = tree_map(lambda p: p.detach().requires_grad_(),
                   {k: v for k, v in params.items() if k not in LAYER_STACKS})
    stacked = {k: tree_map(torch.zeros_like, v) for k, v in params.items() if k in LAYER_STACKS}
    views = {k: _layer_views(params[k], g) for k, g in stacked.items()}
    with torch.enable_grad():
        loss = model.loss_fn({**top, **views}, batch, mesh_info)
        loss.backward()
    grads = tree_map(lambda p: torch.zeros_like(p) if p.grad is None else p.grad, top)
    grads.update(stacked)
    return loss.detach(), grads


def make_train_step(cfg: ModelConfig, optimizer: Optional[AdamW] = None, device="cuda",
                    mesh=None):
    """(model, optimizer, train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)); the step updates ``params`` and ``opt_state`` in
    place and returns them, with ``metrics = {"loss", "grad_norm", "lr"}``.
    With a ``mesh``: DTensor parameters, state and batch, the step run
    inside ``activate_sharding``."""
    model = Model(cfg, device=device)
    opt = optimizer or make_optimizer()
    minfo = mesh_info_for(cfg, mesh)

    def train_step(params, opt_state, batch):
        _require_context(mesh)
        loss, grads = loss_and_grads(model, params, batch, minfo)
        if mesh is not None:
            grads = tree_map(lambda g, p: g.redistribute(p.device_mesh, p.placements),
                             grads, params)
        params, opt_state, metrics = opt.update(grads, opt_state, params)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return model, opt, train_step


def make_prefill_step(cfg: ModelConfig, device="cuda", mesh=None):
    """(model, prefill_step(params, batch) -> (logits, cache))."""
    model = Model(cfg, device=device)
    minfo = mesh_info_for(cfg, mesh)

    @serving_mode(mesh)
    def prefill_step(params, batch):
        _require_context(mesh)
        return model.prefill(params, batch, minfo)

    return model, prefill_step


def make_decode_step(cfg: ModelConfig, device="cuda", mesh=None):
    """(model, decode_step(params, cache, tokens, pos) -> (logits, cache));
    the step writes into ``cache`` in place.  ``pos`` is a Python int or a
    0-d int tensor on the model's device."""
    model = Model(cfg, device=device)
    minfo = mesh_info_for(cfg, mesh)

    @serving_mode(mesh)
    def decode_step(params, cache, tokens, pos):
        _require_context(mesh)
        return model.decode_step(params, cache, tokens, pos, minfo)

    return model, decode_step


class CapturedDecode:
    """One greedy decode step captured in a CUDA graph: the counterpart of
    the JAX server's ``jax.jit(decode_fn, donate_argnums=(1,))``.

    The graph reads and writes static buffers on the card: ``tokens``
    [B, 1] int64 (the token at ``pos``), ``pos`` (int64 of ``pos_shape``:
    0-d, one position for every row, or ``(B,)``, one per row, as the
    continuous batcher's slots take it), ``cache`` (zeros shaped as
    ``cache_like``: the padded layout ``Server._pad_cache`` gives) and
    ``logits`` [B, 1, vocab] f32.  One ``replay()`` runs
    ``decode_fn`` at the device ``pos`` (the cache written in place), writes
    the logits, the greedy next token into ``tokens`` and ``pos + 1`` into
    ``pos``: no host work beyond the launch of the graph.

    The step is warmed up on a side stream before the capture, so that the
    kernels' builds, cuBLAS's handles, flash-decode's ticket buffer, a mesh's
    communicators and the allocator's blocks exist before it begins; the
    capture's own launch counts are taken back and added again on every
    replay (``kernels.counters``).  The graph reads ``params`` where they
    lay at the capture, and holds no reference to them: ``key`` is their
    (address, shape, stride, dtype) leaf by leaf, which a caller checks
    before it replays (``Server.captured_decode``).  A capture that fails
    raises.

    On a mesh (``layout`` = (mesh, decode rules, the cache's specs)) the
    static cache is DTensors in that layout, over local buffers; the step
    runs under ``activate_sharding`` with the tokens split over the batch
    rule's axes, and its logits are gathered to whole rows before the
    argmax.  ``tokens`` and ``logits`` are this rank's rows (plain
    tensors); ``local`` and ``whole`` move between a DTensor of the step's
    rows and its local rows.  The collectives (NCCL) are captured with
    the graph; the capture is in thread-local mode, so the process group's
    watchdog thread may query its events meanwhile."""

    def __init__(self, decode_fn, params: dict, cache_like: dict, device,
                 pos_shape: tuple = (), layout=None):
        self.decode_fn = decode_fn
        self.key = params_key(params)
        self.layout = layout
        B = next(iter(cache_like.values())).shape[1]
        self.pos = torch.zeros(pos_shape, dtype=torch.int64, device=device)
        if layout is None:
            self.tokens = torch.zeros((B, 1), dtype=torch.int64, device=device)
            self._tokens_in = self.tokens
            self.cache = {k: torch.zeros(c.shape, dtype=c.dtype, device=device)
                          for k, c in cache_like.items()}
        else:
            from torch.distributed import tensor as dtensor

            from .shardings import placements

            mesh, _, specs = layout
            self._tokens_in = dtensor.zeros((B, 1), dtype=torch.int64, device_mesh=mesh,
                                            placements=self._row_placements(2))
            self.tokens = self._tokens_in.to_local()
            self.cache = {k: dtensor.zeros(c.shape, dtype=c.dtype, device_mesh=mesh,
                                           placements=placements(mesh, specs[k]))
                          for k, c in cache_like.items()}
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(2):
                self._step(params)
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        self.graph = torch.cuda.CUDAGraph()
        mode = "global" if layout is None else "thread_local"
        before = counters.snapshot()
        try:
            with torch.cuda.graph(self.graph, capture_error_mode=mode):
                self._step(params)
        finally:
            self.launches = counters.since(before)  # per replay
            counters.add(self.launches, -1)  # the capture launched nothing

    def _step(self, params):
        if self.layout is None:
            self.logits, _ = self.decode_fn(params, self.cache, self.tokens, self.pos)
        else:
            from repro_torch.models.common import activate_sharding

            mesh, rules, _ = self.layout
            with activate_sharding(mesh, rules):
                logits, _ = self.decode_fn(params, self.cache, self._tokens_in, self.pos)
            self.logits = self.local(logits)
        self.tokens.copy_(torch.argmax(self.logits, dim=-1))
        self.pos.add_(1)

    def _row_placements(self, ndim: int) -> tuple:
        """The placements of a [B, ...] tensor split by the batch rule alone."""
        from .shardings import PSpec, placements

        mesh, rules, _ = self.layout
        return placements(mesh, PSpec(rules["batch"], *(None,) * (ndim - 1)))

    def local(self, t):
        """This rank's rows of ``t`` (a DTensor [B, ...] on the mesh, made
        whole on every other dim), or ``t`` itself without a mesh."""
        if self.layout is None:
            return t
        return t.redistribute(self.layout[0], self._row_placements(t.ndim)).to_local()

    def whole(self, t):
        """This rank's rows ``t`` as the DTensor [B, ...] they are part of, or
        ``t`` itself without a mesh."""
        if self.layout is None:
            return t
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(t, self.layout[0], self._row_placements(t.ndim),
                                  run_check=False)

    def load(self, cache: dict, tokens, pos: int) -> None:
        """Start from a prefill: its ``cache`` into the static one (a k/v
        cache with fewer slots into the first ones, the rest zeroed, as
        ``Server._pad_cache`` pads; encdec's cross k/v, whose shape the
        prefill fixes, as it is; on a mesh, local shard into local shard),
        ``tokens`` [B, 1] (this rank's rows) and ``pos``, the position of
        those tokens.  Runs under the caller's serving context."""
        for key, buf in self.cache.items():
            src = cache[key]
            if self.layout is not None:
                if src.placements != buf.placements:
                    raise ValueError(f"cache {key!r}: {src.placements}, the captured step "
                                     f"holds {buf.placements}")
                src, buf = src.to_local(), buf.to_local()
            if src.dtype != buf.dtype:
                raise TypeError(f"cache {key!r}: {src.dtype}, the captured step holds {buf.dtype}")
            if src.shape == buf.shape:
                buf.copy_(src)
            else:  # a k/v cache [L, B, slots, KV, hd] with fewer slots
                n = src.shape[2]
                buf[:, :, :n].copy_(src)
                buf[:, :, n:].zero_()
        self.tokens.copy_(tokens)
        self.pos.fill_(pos)

    def replay(self) -> None:
        self.graph.replay()
        counters.add(self.launches)


def params_key(params: dict) -> tuple:
    """What a captured step reads of ``params``: each leaf's address, shape,
    stride and dtype (a DTensor's: its local shard's, and its
    placements)."""
    from torch.distributed.tensor import DTensor

    def key(path, t):
        if isinstance(t, DTensor):
            return key(path, t.to_local()) + (t.placements,)
        return (path, t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)

    return tuple(key(path, t) for path, t in tree_items(params))


# ---------------------------------------------------------------------------
# Abstract inputs (tensors on the ``meta`` device: no allocation), per shape
# kind; the dtypes are JAX's (token ids and positions int32)
# ---------------------------------------------------------------------------


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The abstract batch of a train or prefill step: ``inputs`` [B, S]
    (and for train ``targets``) int32; an ``embeds_input`` config's
    ``embeds`` [B, S, d] f32 (mrope: ``positions`` [3, B, S] int32); encdec's
    ``frames`` [B, enc_positions, d] f32.  For decode the abstract (cache,
    tokens, pos) triple is ``decode_input_specs``'."""
    B, S = shape.global_batch, shape.seq_len
    i32, f32 = torch.int32, torch.float32
    batch = {"inputs": _meta((B, S), i32)}
    if shape.kind == "train":
        batch["targets"] = _meta((B, S), i32)
    if cfg.embeds_input:
        batch["embeds"] = _meta((B, S, cfg.d_model), f32)
        if cfg.rope == "mrope":
            batch["positions"] = _meta((3, B, S), i32)
    if cfg.family == "encdec":
        batch["frames"] = _meta((B, cfg.enc_positions, cfg.d_model), f32)
    return batch


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> tuple:
    """(cache, tokens, pos): the abstract inputs of one decode step, one new
    token [B, 1] int32 against a cache of ``seq_len`` slots
    (``Model.abstract_cache``), at a 0-d int32 position."""
    B, S = shape.global_batch, shape.seq_len
    cache = Model(cfg, device="meta").abstract_cache(B, S)
    return cache, _meta((B, 1), torch.int32), _meta((), torch.int32)


def concrete_batch(cfg: ModelConfig, shape_or_bs, seq_len: Optional[int] = None,
                   generator: Optional[torch.Generator] = None, device="cuda") -> dict:
    """A random token batch ({"inputs", "targets"} [B, S]) drawn from
    ``generator`` (seed 0 when none is given) on ``device``, with what the
    modality stubs read (JAX ``concrete_batch``): ``embeds_input`` configs
    get ``embeds`` [B, S, d] (and, for mrope, ``positions`` [3, B, S]: 0..S-1
    in every stream), encdec gets the audio ``frames`` [B, enc_positions,
    d]; both f32, 0.02 times a standard normal."""
    if isinstance(shape_or_bs, ShapeConfig):
        B, S = shape_or_bs.global_batch, shape_or_bs.seq_len
    else:
        B, S = shape_or_bs, seq_len
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    kw = dict(generator=generator, device=dev, dtype=torch.int64)
    batch = {
        "inputs": torch.randint(0, cfg.vocab_size, (B, S), **kw),
        "targets": torch.randint(0, cfg.vocab_size, (B, S), **kw),
    }
    normal = dict(generator=generator, device=dev, dtype=torch.float32)
    if cfg.embeds_input:
        batch["embeds"] = 0.02 * torch.randn((B, S, cfg.d_model), **normal)
        if cfg.rope == "mrope":
            batch["positions"] = torch.arange(S, device=dev)[None, None].expand(3, B, S)
    if cfg.family == "encdec":
        batch["frames"] = 0.02 * torch.randn((B, cfg.enc_positions, cfg.d_model), **normal)
    return batch
