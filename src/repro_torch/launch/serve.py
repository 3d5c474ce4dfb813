"""Serving driver of the port: batched prefill, then greedy decode against a
KV cache, with the CAPre access plan of one decode step printed before
serving (the paper's prefetching hints for the tensor store).  Counterpart
of ``repro.launch.serve``.

With ``attn_impl="pallas"`` on a CUDA device the dense and moe families'
prefill runs the CUDA flash-attention kernel and every decode step the
CUDA flash-decode kernel (the moe family's router, dispatch, expert
products and combine are plain PyTorch, as in JAX they are XLA's); so do
whisper's decoder self-attention (encdec; its encoder and cross-attention
take the flash kernel where both lengths are multiples of 128, as in JAX,
and the decode's cross-attention the plain path) and qwen2-vl (dense, M-RoPE;
its prompt arrives as precomputed ``embeds``, so only the decode steps
gather embedding rows); the ssm
family's prefill and decode run the CUDA selective scan once per layer,
the hybrid's the CUDA gated RG-LRU scan once per recurrent layer (its
windowed attention takes the plain path, as in JAX); all take the
embedding rows with the CUDA row gather.

On a CUDA device ``generate`` runs the prefill eagerly and then replays one
captured decode step (``launch.steps.CapturedDecode``, the counterpart of
the JAX server's ``_jit_decode``) for every further token; on the CPU it
runs the eager loop (``generate_eager``).

Usage (on the card; ``--device cpu`` runs the plain path on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch chatglm3_6b \
      --batch 4 --prompt-len 512 --gen 32 --attn-impl pallas
  (also ``--arch qwen3_moe_30b_a3b``, ``granite_moe_1b_a400m``,
  ``falcon_mamba_7b``, ``recurrentgemma_2b``, ``whisper_large_v3`` (random
  audio frames) and ``qwen2_vl_2b`` (random prompt embeddings))
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.access_plan import build_access_plan
from repro_torch.launch.steps import (
    CapturedDecode,
    concrete_batch,
    make_decode_step,
    make_prefill_step,
    params_key,
)
from repro_torch.models.common import tree_items
from repro_torch.models.transformer import decode_layers


class Server:
    def __init__(self, cfg, device="cuda", max_len: int = 256, mesh=None):
        """``mesh``: sharded serving is not ported (ROADMAP.md, section 1,
        item 6.1), so a mesh of more than one rank raises; it is never
        served unsharded in silence.  A one-rank mesh serves as no mesh."""
        if mesh is not None and mesh.size() > 1:
            raise NotImplementedError(
                f"Server on a mesh of {mesh.size()} ranks: sharded serving is ROADMAP.md, "
                "section 1, item 6.1; serve on one device")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.max_len = max_len
        self.model, self.prefill_fn = make_prefill_step(cfg, self.device)
        _, self.decode_fn = make_decode_step(cfg, self.device)
        self._captured: dict[int, CapturedDecode] = {}  # by batch size

    def plan(self, batch_size: int):
        """The CAPre access plan of one decode step, traced on the ``meta``
        device (compile-time: nothing is allocated and the card is never
        touched)."""
        return build_access_plan(
            lambda p, c, t: self.decode_fn(p, c, t, 0),
            self.model.abstract_params(),
            self.model.abstract_cache(batch_size, self.max_len),
            torch.empty((batch_size, 1), dtype=torch.int64, device="meta"),
        )

    @torch.inference_mode()
    def generate(self, params, batch: dict, steps: int, *, with_logits: bool = False):
        """Prefill the prompt batch, then greedily decode: ``steps`` tokens
        in all ([B, steps]), the first from the prefill logits; with
        ``with_logits`` also the logits of every step ([B, steps, vocab]).

        On a CUDA device the decode replays the captured step of this batch
        size (``captured_decode``), with no host work per token beyond the
        replay and the copy of the token out; the prompt and the tokens must
        fit ``max_len``, which is checked here (the eager loop's cache write
        would raise ``IndexError``).  Elsewhere the eager loop runs.

        The prompt is ``batch["inputs"]`` [B, S], or for an ``embeds_input``
        config ``batch["embeds"]`` [B, S, d] where given (with its
        ``positions``); encdec also reads ``batch["frames"]``."""
        if self.device.type != "cuda":
            return self.generate_eager(params, batch, steps, with_logits=with_logits)
        B, S = self.model.prompt_shape(batch)
        if S + steps - 1 > self.max_len:
            raise ValueError(f"a prompt of {S} and {steps} tokens need {S + steps - 1} "
                             f"positions; the server holds max_len={self.max_len}")
        logits, cache = self.prefill_fn(params, batch)
        step = self.captured_decode(params, B)
        tok = torch.argmax(logits, dim=-1)
        step.load(cache, tok, S)
        del cache
        out = torch.empty((B, steps), dtype=tok.dtype, device=self.device)
        out[:, :1] = tok
        if with_logits:
            all_logits = logits.new_empty((B, steps, logits.shape[-1]))
            all_logits[:, :1] = logits
        for i in range(1, steps):
            step.replay()
            out[:, i : i + 1] = step.tokens
            if with_logits:
                all_logits[:, i : i + 1] = step.logits
        return (out, all_logits) if with_logits else out

    @torch.inference_mode()
    def generate_eager(self, params, batch: dict, steps: int, *, with_logits: bool = False):
        """``generate`` with every decode step run eagerly from the host at an
        int position: the plain loop, which the captured step must equal."""
        B, S = self.model.prompt_shape(batch)
        logits, cache = self.prefill_fn(params, batch)
        cache = self._pad_cache(cache)
        tok = torch.argmax(logits, dim=-1)
        out, outs = [tok], [logits]
        for i in range(steps - 1):
            logits, cache = self.decode_fn(params, cache, tok, S + i)
            tok = torch.argmax(logits, dim=-1)
            out.append(tok)
            outs.append(logits)
        out = torch.cat(out, dim=1)
        return (out, torch.cat(outs, dim=1)) if with_logits else out

    @torch.inference_mode()
    def captured_decode(self, params, batch_size: int) -> CapturedDecode:
        """The captured decode step for ``batch_size`` rows over this
        server's ``max_len`` and these ``params``, captured at the first
        call (and again when the params lie elsewhere)."""
        step = self._captured.get(batch_size)
        if step is None or step.key != params_key(params):
            self._captured.pop(batch_size, None)  # its graph and buffers go first
            step = CapturedDecode(self.decode_fn, params,
                                  self.model.abstract_cache(batch_size, self.max_len),
                                  self.device)
            self._captured[batch_size] = step
        return step

    @torch.inference_mode()
    def stream_decode(self, streamer, cache: dict, tokens, pos: int):
        """One decode step whose weights ``streamer`` (a
        ``runtime.prefetch.WeightStreamer`` over this model's plan) serves
        group by group: each part of the step (the embedding, the layer
        stack, the final norm, the head) runs as soon as every parameter it
        reads has been served, and its parameters are dropped once no later
        part reads them.  Writes into ``cache`` in place, as ``decode_fn``
        does; returns (logits [B, 1, vocab], cache).  The encdec family is
        not streamed yet: it raises."""
        cfg, model = self.cfg, self.model
        if cfg.family == "encdec":
            raise NotImplementedError(
                "streaming the encdec family is not ported yet: ROADMAP.md, section 1, item 5.8")
        paths = [p for p, _ in tree_items(model.template)]
        head = "embed" if cfg.tie_embeddings else "lm_head"
        out = {}

        def embed(tree):
            out["x"] = model.embed(tree, tokens)

        def stack(tree):
            out["x"], _ = decode_layers(tree, cfg, out["x"], cache, pos)

        def norm(tree):
            out["x"] = model._final_norm(tree, out["x"])

        def logits(tree):
            out["logits"] = model.logits(tree, out["x"])[..., : cfg.vocab_size]

        stages = [
            (embed, {"embed"}),
            (stack, {p for p in paths if p.split(".")[0] in _STACKS}),
            (norm, {p for p in paths if p.split(".")[0] in ("final_norm", "final_norm_b")}),
            (logits, {head}),
        ]
        served: dict = {}

        def compute(_gi, arrays):
            served.update(arrays)
            while stages and stages[0][1] <= served.keys():
                run, needs = stages.pop(0)
                run(_nest({p: served[p] for p in needs}))
                later = set().union(*(n for _, n in stages))
                for p in needs - later:
                    del served[p]

        streamer.run_plan(compute_fn=compute)
        if stages:
            missing = sorted(stages[0][1] - served.keys())
            raise RuntimeError(f"the plan never served {missing}: the step cannot run")
        return out["logits"], cache

    def _pad_cache(self, cache: dict) -> dict:
        """Grow the seq dim of the k/v cache to the slots decode writes in
        place: ``max_len`` (dense, moe and encdec's self-attention cache:
        slot ``pos``), or ``min(local_window, max_len)`` (hybrid: slot
        ``pos % local_window``; a prompt shorter than the window leaves
        fewer).  The ssm cache has no seq dim, and encdec's cross k/v keep
        their ``enc_positions`` slots.

        The JAX server pads the dense, moe and encdec caches alike (their
        k/v only), and not the hybrid's, so its
        hybrid decode after a prompt shorter than the window writes outside
        the ring (clamped onto the last prompt key) and masks modulo the
        wrong length."""
        cfg = self.cfg
        if cfg.family == "ssm":
            return cache
        slots = min(cfg.local_window, self.max_len) if cfg.family == "hybrid" else self.max_len
        S = cache["k"].shape[2]
        if S >= slots:
            return cache
        out = dict(cache)
        for key in ("k", "v"):
            c = cache[key]
            shp = (c.shape[0], c.shape[1], slots) + tuple(c.shape[3:])
            buf = torch.zeros(shp, dtype=c.dtype, device=c.device)
            buf[:, :, :S] = c
            out[key] = buf
        return out


# the top-level parameter groups of a layer stack, per family: ``layers``
# (dense, moe, ssm), ``rec_layers`` and ``attn_layers`` (hybrid); encdec's
# decode is not streamed (``Server.stream_decode`` raises)
_STACKS = ("layers", "rec_layers", "attn_layers")


def _nest(flat: dict) -> dict:
    """{dotted path: leaf} -> the nested parameter tree."""
    tree: dict = {}
    for path, leaf in flat.items():
        *parents, name = path.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return tree


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--attn-impl", default=None,
                    help="naive | chunked | pallas (the CUDA kernels); default: the config's")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.attn_impl:
        cfg = cfg.replace(attn_impl=args.attn_impl)
    device = resolve_device(args.device)
    server = Server(cfg, device=device, max_len=args.prompt_len + args.gen)
    plan = server.plan(args.batch)
    print(f"access plan: {len(plan.records)} records, "
          f"{len(plan.collections())} collections, {plan.total_bytes/1e6:.1f} MB")
    for h in plan.hints()[:8]:
        print("  hint:", h)

    model = server.model
    params = model.compute_params(model.init_params(seed=0))
    batch = concrete_batch(cfg, args.batch, args.prompt_len, device=device)
    batch.pop("targets", None)
    t0 = time.perf_counter()
    tokens = server.generate(params, batch, args.gen)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    print(f"generated {tuple(tokens.shape)} tokens in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s) on {device}")
    print("sample:", tokens[0, :12].tolist())


if __name__ == "__main__":
    main()
