"""Continuous-batching serving scheduler.  Counterpart of
``repro.runtime.scheduler``.

Production serving keeps the decode batch full: finished sequences release
their KV-cache slot and queued requests are prefilled into it while the
other slots keep decoding (continuous batching).  This scheduler implements
the slot machinery over the Model prefill/decode steps:

  * a fixed pool of ``batch_size`` slots, each owning a row of the
    static-shape KV cache;
  * per-slot position counters: sequences at different offsets decode in
    the same step, the attention masked per slot by its own length;
  * admission: each new request is prefilled at batch 1 into a free slot's
    cache row (single-sequence prefill, batched decode);
  * completion at EOS, at ``max_new_tokens`` or at the cache's end.

CAPre connection: the decode step's access plan is batch-shape-static, so
the scheduler's steady state keeps the prefetch schedule valid regardless
of request churn: this is why the plan is derived per (shape, batch) and
not per request.

On the card the per-slot step is captured once in a CUDA graph
(``launch.steps.CapturedDecode`` with one position per slot: the
counterpart of JAX's ``jax.jit(self._decode_step)``), and every engine tick
copies the slots' tokens and positions into its static buffers, replays it
and reads the next tokens back; with ``attn_impl="pallas"`` and a cache of
a multiple of 128 slots it attends through flash-decode with one
``kv_len`` per row.  On the CPU, or with ``captured=False``, each tick
runs the step eagerly.  The dense and moe families are taken; the others
keep no per-slot k/v cache of this shape and are refused.

Given a ``trace`` (``obs.engine.EngineTrace``), the batcher records its
spans: ``engine.queue`` of each request (``submit`` to its admission),
``engine.step``, inside it ``engine.admit`` (the request's ``rid``, its
prompt length ``S`` and the flash forward's launches during it,
``flash``) with its laps ``admit.upload`` (the prompt to the device: a
pageable copy, which waits for the stream), ``admit.prefill``
(``Model.prefill``, which returns once its kernels are launched),
``admit.handoff`` (the slot row's copies and zeroing) and ``admit.read``
(the first token, which waits for the device), and ``engine.tick`` with
``tick.launch`` (the replay, or the eager step) and ``tick.read`` (the
next tokens, which wait for the device).  Without one, each of these
boundaries costs one ``is None`` test.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.launch.steps import CapturedDecode, params_key
from repro_torch.models.layers import apply_norm, apply_rope, attn_output, qkv_project, rope_angles
from repro_torch.models.transformer import (
    _masked_decode_attention,
    cfg_dtype,
    ffn_block,
    layer_params,
)

FAMILIES = ("dense", "moe")


@dataclass
class Request:
    rid: int
    prompt: np.ndarray  # [S] int
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    # filled by the scheduler
    output: list = field(default_factory=list)
    done: bool = False


@dataclass
class _Slot:
    busy: bool = False
    req: Optional[Request] = None
    pos: int = 0  # next write position in this slot's cache row
    generated: int = 0


class ContinuousBatcher:
    """Slot-based continuous batching over a Model.

    The KV cache is [L, B, max_len, KV, hd] in ``model.kv_dtype()``; slot i
    owns batch row i.  Each admitted prompt is prefilled at batch 1 and its
    cache rows are copied into the slot, the rest of the row zeroed (real
    deployments run a dedicated prefill worker; the copy is the slot
    hand-off either way).

    ``device`` is where the cache lives and the steps run: the card unless
    ``"cpu"`` is asked for (without CUDA, ``"cuda"`` raises).  On the card
    the per-slot step is captured at construction in a CUDA graph whose
    static cache is the batcher's cache (admission writes into it), unless
    ``captured=False``, which runs every tick eagerly: the reference the
    captured step must equal bit for bit.  ``logits`` holds the last
    tick's logits [B, 1, vocab] (on the card with capture, the graph's
    static buffer, overwritten by the next tick).  ``trace``, an
    ``obs.engine.EngineTrace`` or None, takes the engine's spans (see the
    module's docstring)."""

    def __init__(self, model, params, batch_size: int, max_len: int, device="cuda",
                 captured: bool = True, trace=None):
        cfg = model.cfg
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"continuous batching takes the {' and '.join(FAMILIES)} families, whose "
                f"decode holds one k/v cache row per slot; {cfg.name} is {cfg.family}")
        self.device = resolve_device(device)
        self.model = model
        self.params = params
        self.B = batch_size
        self.max_len = max_len
        self.slots = [_Slot() for _ in range(batch_size)]
        self.queue: deque[Request] = deque()
        self.finished: list[Request] = []
        self.steps = 0
        self.logits = None
        self.trace = trace
        self._submitted: dict[int, int] = {}  # id(request) -> ns, while traced
        cache_like = model.abstract_cache(batch_size, max_len)
        self._graph = None
        with torch.inference_mode():
            if captured and self.device.type == "cuda":
                self._graph = CapturedDecode(self._decode_step, params, cache_like, self.device,
                                             pos_shape=(batch_size,))
                self.cache = self._graph.cache
                # the host's side of each tick's copies in, pinned so that
                # they do not wait for the device
                self._host_tokens = torch.zeros((batch_size, 1), dtype=torch.int64,
                                                pin_memory=True)
                self._host_lens = torch.zeros((batch_size,), dtype=torch.int64, pin_memory=True)
            else:
                self.cache = {k: torch.zeros(c.shape, dtype=c.dtype, device=self.device)
                              for k, c in cache_like.items()}

    # -- batched decode with per-slot positions -----------------------------

    def _decode_step(self, params, cache, tokens, kv_lens):
        """One decode step where every slot sits at its own position: tokens
        [B, 1] int and kv_lens [B] int64 (slot b's write position) on the
        step's device; writes each slot's new k/v at ``(b, kv_lens[b])`` of
        ``cache`` ({"k", "v"} [L, B, max_len, KV, hd]) in place and returns
        (logits [B, 1, vocab] f32, cache).

        The write is one ``index_copy_`` per layer and tensor on the
        flattened (row, slot) dim, which a CUDA graph replays: JAX blends a
        one-hot into the whole cache, with the same result for a finite
        cache.  Slot b attends to its first ``kv_lens[b] + 1`` slots:
        through flash-decode with a ``[B]`` int32 ``kv_len`` where
        ``attn_impl == "pallas"`` and the cache holds a multiple of 128
        slots (the rule of the server's decode), else through the masked
        einsum of JAX's step (scores in f32, p cast to the compute dtype).
        Every tensor the step reads of the positions is computed from
        ``kv_lens`` on the device, so a captured step replays at any mix of
        positions."""
        model, cfg = self.model, self.model.cfg
        dt = cfg_dtype(cfg)
        x = model.embed(params, tokens)
        B = tokens.shape[0]
        S = cache["k"].shape[2]
        positions = kv_lens[:, None]  # [B, 1] current index per slot
        if cfg.rope == "mrope":
            positions = positions[None].expand(3, B, 1)
        angles = rope_angles(cfg.rope, positions, cfg.head_dim, cfg.rope_theta)
        at = torch.arange(B, device=x.device) * S + kv_lens  # each write, (row, slot) flattened
        flash = cfg.attn_impl == "pallas" and S % 128 == 0
        if flash:
            kv_len = (kv_lens + 1).to(torch.int32)
        else:
            valid = torch.arange(S, device=x.device)[None, :] <= kv_lens[:, None]  # [B, S]
            valid = valid[:, None, None, None, :]
        for l in range(cfg.n_layers):
            lp = layer_params(params["layers"], l)
            h = apply_norm(cfg.norm, x, lp["ln1"], lp.get("ln1_b"))
            q, k, v = qkv_project(h, lp["attn"], cfg, dt)
            q = apply_rope(q, angles)
            k = apply_rope(k, angles)
            kc, vc = cache["k"][l], cache["v"][l]
            kc.view(B * S, *kc.shape[2:]).index_copy_(0, at, k[:, 0].to(kc.dtype))
            vc.view(B * S, *vc.shape[2:]).index_copy_(0, at, v[:, 0].to(vc.dtype))
            if flash:
                o = ops.decode_attention(q[:, 0], kc, vc, kv_len).to(dt)[:, None]
            else:
                o = _masked_decode_attention(q, kc, vc, valid, cfg)
            x = x + attn_output(o, lp["attn"], cfg, dt)
            x = ffn_block(x, lp, cfg, dt)
        h = model._final_norm(params, x)
        return model.logits(params, h)[..., : cfg.vocab_size], cache

    def _decode(self, tokens: np.ndarray, lens: np.ndarray) -> np.ndarray:
        """One per-slot decode of ``tokens`` [B, 1] at ``lens`` [B] (host
        int64): sets ``logits`` and returns each slot's greedy next token
        (host [B]), read back in one device-to-host copy."""
        g, tr = self._graph, self.trace
        if tr is not None:
            t = tr.now()
        if g is None:
            dev = self.device
            self.logits, self.cache = self._decode_step(
                self.params, self.cache, torch.from_numpy(tokens).to(dev),
                torch.from_numpy(lens).to(dev))
            nxt = torch.argmax(self.logits[:, 0, :], dim=-1)
        else:
            self._replay(tokens, lens)
            self.logits = g.logits
            nxt = g.tokens[:, 0]
        if tr is not None:
            t = tr.lap("tick.launch", t)
        nxt = nxt.cpu().numpy()
        if tr is not None:
            tr.lap("tick.read", t)
        return nxt

    def _replay(self, tokens: np.ndarray, lens: np.ndarray) -> None:
        """The captured tick up to the read of its tokens: ``tokens`` and
        ``lens`` through pinned host buffers into the graph's static ones,
        then one replay (the logits, then their argmax into the graph's
        ``tokens``).  Nothing here waits for the device."""
        g = self._graph
        if g.key != params_key(self.params):
            raise RuntimeError("the params no longer lie where the captured step reads them")
        # the previous tick's read waited for the device, so the copies out
        # of these buffers are done
        self._host_tokens.numpy()[:] = tokens
        self._host_lens.numpy()[:] = lens
        g.tokens.copy_(self._host_tokens, non_blocking=True)
        g.pos.copy_(self._host_lens, non_blocking=True)
        g.replay()

    # -- admission -----------------------------------------------------------

    def submit(self, req: Request) -> None:
        S = len(req.prompt)
        if not 0 < S < self.max_len:
            # the first decode writes at position S, which must lie in the cache
            raise ValueError(f"request {req.rid}: a prompt of {S} tokens; the cache holds "
                             f"max_len={self.max_len}, so a prompt takes 1 to "
                             f"{self.max_len - 1}")
        if self.trace is not None:
            self._submitted[id(req)] = self.trace.now()
        self.queue.append(req)

    def _admit(self) -> None:
        for i, slot in enumerate(self.slots):
            if slot.busy or not self.queue:
                continue
            self._admit_one(i, slot, self.queue.popleft())

    @torch.inference_mode()
    def _admit_one(self, i: int, slot: _Slot, req: Request) -> None:
        S = len(req.prompt)
        tr = self.trace
        if tr is not None:
            launched = flash_attention_fwd.launches
            span = tr.begin("engine.admit", rid=req.rid, S=S)
            t = span.start
            submitted = self._submitted.pop(id(req), None)
            if submitted is not None:
                tr.add("engine.queue", submitted, t, rid=req.rid)
        inputs = torch.as_tensor(np.asarray(req.prompt, dtype=np.int64), device=self.device)
        if tr is not None:
            t = tr.lap("admit.upload", t)
        logits, cache1 = self.model.prefill(self.params, {"inputs": inputs[None]})
        if tr is not None:
            t = tr.lap("admit.prefill", t)
        # hand the prefilled rows to the slot's cache row; past the prompt
        # the row is zeroed, as JAX's jnp.pad leaves it (the kernel never
        # reads there, but the masked path multiplies it by a zero p)
        for key in ("k", "v"):
            row = self.cache[key][:, i]
            row[:, :S].copy_(cache1[key][:, 0])
            row[:, S:].zero_()
        if tr is not None:
            t = tr.lap("admit.handoff", t)
        slot.busy = True
        slot.req = req
        slot.pos = S
        slot.generated = 0
        tok = int(torch.argmax(logits[0, -1]))
        if tr is not None:
            tr.lap("admit.read", t)
            tr.end(span, flash=flash_attention_fwd.launches - launched)
        req.output.append(tok)
        slot.generated = 1

    # -- one engine tick -------------------------------------------------------

    @torch.inference_mode()
    def step(self) -> int:
        """Admit + one batched decode step. Returns number of active slots."""
        tr = self.trace
        if tr is None:
            return self._step()
        span = tr.begin("engine.step")
        try:
            return self._step()
        finally:
            tr.end(span)

    def _step(self) -> int:
        self._admit()
        active = [s for s in self.slots if s.busy]
        if not active:
            return 0
        tokens = np.zeros((self.B, 1), np.int64)
        lens = np.zeros((self.B,), np.int64)
        for i, slot in enumerate(self.slots):
            if slot.busy:
                tokens[i, 0] = slot.req.output[-1]
                lens[i] = slot.pos
        tr = self.trace
        if tr is not None:
            span = tr.begin("engine.tick")
        nxt = self._decode(tokens, lens)
        if tr is not None:
            tr.end(span)
        for i, slot in enumerate(self.slots):
            if not slot.busy:
                continue
            slot.pos += 1
            slot.generated += 1
            req = slot.req
            tok = int(nxt[i])
            req.output.append(tok)
            eos = req.eos_id is not None and tok == req.eos_id
            if eos or slot.generated >= req.max_new_tokens or slot.pos >= self.max_len - 1:
                req.done = True
                self.finished.append(req)
                slot.busy = False
                slot.req = None
        self.steps += 1
        return len([s for s in self.slots if s.busy])

    def run_until_drained(self, max_steps: int = 10_000) -> list[Request]:
        while (self.queue or any(s.busy for s in self.slots)) and self.steps < max_steps:
            self.step()
        return self.finished
