"""Serving driver of the port: batched prefill, then greedy decode against a
KV cache, with the CAPre access plan of one decode step printed before
serving (the paper's prefetching hints for the tensor store).  Counterpart
of ``repro.launch.serve``.

With ``attn_impl="pallas"`` on a CUDA device the dense and moe families'
prefill runs the CUDA flash-attention kernel and every decode step the
CUDA flash-decode kernel (the moe family's router, dispatch, expert
products and combine are plain PyTorch, as in JAX they are XLA's); so do
whisper's decoder self-attention, encoder and prefill cross-attention
(encdec; at any length on the card, where JAX's Pallas branch takes only
multiples of 128; the decode's cross-attention the plain path) and
qwen2-vl (dense, M-RoPE;
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

On a mesh (``Server(cfg, mesh=mesh)``, every family) the prefill runs
under the prefill rules (batch over the data axes, heads and channels over
``model``) and the decode under the decode rules, on JAX's decode layout
(``shardings.cache_pspecs``): a k/v cache's sequence (the hybrid's ring
too) split over ``cache_seq``'s axis, each rank's attention over its slots
merged across the ranks (``models.transformer._seq_sharded_attention``);
the conv and recurrent states split over ``ff``, each rank's scans on its
own channels (``models.ssm.channel_map``); encdec's cross k/v whole on the
sequence.  At batch 1 the decode takes the ``long`` layout (states over
every axis, the ring over the data axes).  ``generate`` captures the
sharded step, its collectives inside the graph, on an NCCL mesh; over gloo
(several ranks sharing a card, or the CPU) the decode runs eagerly
(``generate_eager``).

Usage (on the card; ``--device cpu`` runs the plain path on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch chatglm3_6b \
      --batch 4 --prompt-len 512 --gen 32 --attn-impl pallas
  (also ``--arch qwen3_moe_30b_a3b``, ``granite_moe_1b_a400m``,
  ``falcon_mamba_7b``, ``recurrentgemma_2b``, ``whisper_large_v3`` (random
  audio frames) and ``qwen2_vl_2b`` (random prompt embeddings))
On a mesh, one rank per card (NCCL; with ``--device cpu``, gloo):
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
      --arch chatglm3_6b --mesh 2x2 --batch 4 --prompt-len 512 --gen 32 --attn-impl pallas
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.access_plan import build_access_plan
from repro_torch.launch.mesh import entry_rank, entry_size
from repro_torch.launch.shardings import (
    PSpec,
    batch_pspecs,
    cache_pspecs,
    logical_rules,
    named,
    placements,
)
from repro_torch.launch.steps import (
    CapturedDecode,
    concrete_batch,
    make_decode_step,
    make_prefill_step,
    params_key,
    serving_mode,
)
from repro_torch.models.common import activate_sharding, to_dtensor, tree_items
from repro_torch.models.transformer import decode_layers

class Server:
    def __init__(self, cfg, device="cuda", max_len: int = 256, mesh=None):
        """``mesh``: a ``DeviceMesh`` with axes ("data", "model") (or
        ("pod", "data", "model")) over every rank of the process group, on
        ``device``'s type.  Every family serves on it (the parameters placed
        by ``model.param_pspecs`` under the prefill rules, ``place``), the
        decode cache in ``cache_pspecs``' layout.  The cache's slots
        (``max_len``, or the hybrid's ring of min(local_window, max_len))
        must divide by the size of the axis the decode splits its sequence
        over."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.max_len = max_len
        self.mesh = mesh
        self.model, self.prefill_fn = make_prefill_step(cfg, self.device, mesh)
        _, self.decode_fn = make_decode_step(cfg, self.device, mesh)
        self._captured: dict[int, CapturedDecode] = {}  # by batch size
        if mesh is not None:
            n_data = mesh.size() // mesh.size(mesh.mesh_dim_names.index("model"))
            self._param_specs = self.model.param_pspecs(
                self._rules("prefill", n_data, max_len))

    def _rules(self, kind: str, batch_size: int, seq_len: int) -> dict:
        """The logical rules of a ``kind`` step.  A prefill of fewer rows
        than the data axes hold (the batch-1 ``long`` decode's prompt) keeps
        its rows whole: the batch does not divide over them."""
        rules = logical_rules(self.cfg, ShapeConfig(kind, kind, seq_len, batch_size), self.mesh)
        if kind == "prefill" and batch_size % entry_size(self.mesh, rules["batch"]):
            rules["batch"] = None
        return rules

    def place(self, params: dict) -> dict:
        """``params`` on this server's mesh: each whole tensor placed by
        ``model.param_pspecs`` under the prefill rules (a copy of this
        rank's shard), each DTensor as it is.  Without a mesh, ``params``.
        Placing once and serving from the result saves the copy per call."""
        if self.mesh is None:
            return params
        return named(self.mesh, self._param_specs, params)

    def plan(self, batch_size: int):
        """The CAPre access plan of one decode step, traced on the ``meta``
        device (compile-time: nothing is allocated and the card is never
        touched).  It is the per-model plan, a server on a mesh included:
        the step's parameters and cache whole, as one device reads them."""
        decode_fn = self.decode_fn
        if self.mesh is not None:
            _, decode_fn = make_decode_step(self.cfg, self.device)
        return build_access_plan(
            lambda p, c, t: decode_fn(p, c, t, 0),
            self.model.abstract_params(),
            self.model.abstract_cache(batch_size, self.max_len),
            torch.empty((batch_size, 1), dtype=torch.int64, device="meta"),
        )

    def _serving(self):
        """``steps.serving_mode``: ``inference_mode``, or on a mesh
        ``no_grad``."""
        return serving_mode(self.mesh)

    def _prefill(self, params, batch: dict):
        """(params, logits, cache, decode context) for a prompt batch: on a
        mesh the parameters and batch placed, the prefill run under the
        prefill rules and its cache moved into the decode layout
        (``to_decode_layout``), with the decode rules' context; without
        one, the prefill as it is (its cache unpadded) and no context."""
        if self.mesh is None:
            logits, cache = self.prefill_fn(params, batch)
            return params, logits, cache, contextlib.nullcontext()
        mesh, cfg = self.mesh, self.cfg
        B, S = self.model.prompt_shape(batch)
        if S > self.max_len:
            raise ValueError(f"a prompt of {S} tokens; the server holds max_len={self.max_len}")
        params = self.place(params)
        prules = self._rules("prefill", B, S)
        specs = batch_pspecs(cfg, ShapeConfig("prefill", "prefill", S, B), mesh)
        if prules["batch"] is None:  # rows kept whole (``_rules``)
            specs = {k: PSpec(*[None] * len(spec)) for k, spec in specs.items()}
        batch = {k: named(mesh, specs[k], v) if k in specs else v for k, v in batch.items()}
        with activate_sharding(mesh, prules):
            logits, cache = self.prefill_fn(params, batch)
        dshape = ShapeConfig("decode", "decode", self.max_len, B)
        cache = to_decode_layout(cache, mesh, cache_pspecs(cfg, dshape, mesh),
                                 self.model.abstract_cache(B, self.max_len))
        return params, logits, cache, activate_sharding(mesh, self._rules("decode", B,
                                                                          self.max_len))

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
        ``positions``); encdec also reads ``batch["frames"]``.

        On a mesh the tokens and logits are DTensors (``full_tensor()``
        gives them whole; ``generate``'s are split over the batch alone,
        ``generate_eager``'s logits also over the vocab where the rules
        split it), and the parameters may be whole tensors or ``place``'s
        DTensors.  The captured step needs an
        NCCL mesh: over gloo, whose collectives run on the host and cannot
        be captured, a CUDA mesh raises and names ``generate_eager``."""
        if self.device.type != "cuda":
            return self.generate_eager(params, batch, steps, with_logits=with_logits)
        if self.mesh is not None:
            import torch.distributed as dist

            backend = dist.get_backend(self.mesh.get_group(0))
            if "nccl" not in backend:
                raise RuntimeError(
                    f"generate captures the decode step in a CUDA graph, which a {backend} "
                    "mesh's collectives cannot enter: serve it with generate_eager")
        B, S = self.model.prompt_shape(batch)
        if S + steps - 1 > self.max_len:
            raise ValueError(f"a prompt of {S} and {steps} tokens need {S + steps - 1} "
                             f"positions; the server holds max_len={self.max_len}")
        with self._serving():
            params, logits, cache, _ = self._prefill(params, batch)
            step = self.captured_decode(params, B)
            logits = step.local(logits)
            tok = torch.argmax(logits, dim=-1)
            step.load(cache, tok, S)
            del cache
            out = torch.empty((tok.shape[0], steps), dtype=tok.dtype, device=self.device)
            out[:, :1] = tok
            if with_logits:
                all_logits = logits.new_empty((tok.shape[0], steps, logits.shape[-1]))
                all_logits[:, :1] = logits
            for i in range(1, steps):
                step.replay()
                out[:, i : i + 1] = step.tokens
                if with_logits:
                    all_logits[:, i : i + 1] = step.logits
            out = step.whole(out)
            return (out, step.whole(all_logits)) if with_logits else out

    def generate_eager(self, params, batch: dict, steps: int, *, with_logits: bool = False):
        """``generate`` with every decode step run eagerly from the host at an
        int position: the plain loop, which the captured step must equal."""
        B, S = self.model.prompt_shape(batch)
        with self._serving():
            params, logits, cache, decoding = self._prefill(params, batch)
            if self.mesh is None:
                cache = self._pad_cache(cache)
            tok = torch.argmax(logits, dim=-1)
            out, outs = [tok], [logits]
            with decoding:
                for i in range(steps - 1):
                    logits, cache = self.decode_fn(params, cache, tok, S + i)
                    tok = torch.argmax(logits, dim=-1)
                    out.append(tok)
                    outs.append(logits)
            out = torch.cat(out, dim=1)
            return (out, torch.cat(outs, dim=1)) if with_logits else out

    def captured_decode(self, params, batch_size: int) -> CapturedDecode:
        """The captured decode step for ``batch_size`` rows over this
        server's ``max_len`` and these ``params`` (on a mesh: ``place``'s
        DTensors), captured at the first call (and again when the params lie
        elsewhere)."""
        step = self._captured.get(batch_size)
        if step is None or step.key != params_key(params):
            self._captured.pop(batch_size, None)  # its graph and buffers go first
            layout = None
            if self.mesh is not None:
                dshape = ShapeConfig("decode", "decode", self.max_len, batch_size)
                rules = self._rules("decode", batch_size, self.max_len)
                layout = (self.mesh, rules, cache_pspecs(self.cfg, dshape, self.mesh))
            with self._serving():
                step = CapturedDecode(self.decode_fn, params,
                                      self.model.abstract_cache(batch_size, self.max_len),
                                      self.device, layout=layout)
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
        if self.mesh is not None:
            raise NotImplementedError("streaming a sharded decode step: serve the mesh with "
                                      "generate or generate_eager")
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


def to_decode_layout(cache: dict, mesh, specs: dict, like: dict) -> dict:
    """A prefill's cache (DTensors in the prefill's layout) as the decode
    cache shaped as ``like`` (``Model.abstract_cache(B, max_len)``) in
    ``specs``' layout (``cache_pspecs`` under the decode rules), on the
    device; no tensor leaves it.

    - A k/v cache whose sequence (dim 2) the spec splits over a mesh axis
      or a tuple of them (the self-attention cache of ``max_len`` slots
      over ``model``; the hybrid's ring of min(local_window, max_len), at
      batch 1 over the data axes, ``("pod", "data")`` on a multi-pod
      mesh): each rank gathers the prompt's k/v heads it lacks over the
      head axis, keeps the slots of its own sequence shard ([r * n, (r + 1)
      * n) with n = slots / R, r its index along the flattened axes, the
      first axis major: ``mesh.entry_rank``) and zeros the rest (a prompt
      shorter than the cache leaves them empty).  The slots must divide by
      R, else ``ValueError``.
    - Every other entry (the recurrent and conv states; encdec's cross k/v
      over the encoder's frames, sequence whole): redistributed to its
      spec."""
    from torch.distributed.tensor import DTensor

    out = {}
    for key, c in cache.items():
        spec, shape = specs[key], tuple(like[key].shape)
        axis = spec[2] if key in ("k", "v") else None
        if axis is None:
            if tuple(c.shape) != shape:
                raise ValueError(f"cache {key!r}: {tuple(c.shape)}, the decode holds {shape}")
            out[key] = to_dtensor(c, mesh).redistribute(mesh, placements(mesh, spec))
            continue
        R, slots = entry_size(mesh, axis), shape[2]
        if slots % R:
            raise ValueError(f"the cache's {slots} slots do not divide over the {R} ranks "
                             f"of {axis!r}")
        n = slots // R
        whole_seq = PSpec(*spec[:2], None, *spec[3:])
        local = to_dtensor(c, mesh).redistribute(mesh, placements(mesh, whole_seq)).to_local()
        start = entry_rank(mesh, axis) * n
        buf = local.new_zeros(local.shape[:2] + (n,) + local.shape[3:])
        m = min(n, max(0, local.shape[2] - start))
        buf[:, :, :m] = local[:, :, start:start + m]
        out[key] = DTensor.from_local(buf, mesh, placements(mesh, spec), run_check=False,
                                      shape=shape,
                                      stride=torch.empty(shape, device="meta").stride())
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
    ap.add_argument("--mesh", default=None,
                    help="DATAxMODEL (or PODxDATAxMODEL): serve on a mesh of every rank of "
                         "the process group (torchrun's)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.attn_impl:
        cfg = cfg.replace(attn_impl=args.attn_impl)
    device = resolve_device(args.device)
    mesh, rank = None, 0
    if args.mesh:
        from .mesh import make_mesh

        shape = tuple(int(n) for n in args.mesh.split("x"))
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        mesh = make_mesh(shape, ("pod", "data", "model")[-len(shape):], device=device.type)
        rank = mesh.get_rank()
    server = Server(cfg, device=device, max_len=args.prompt_len + args.gen, mesh=mesh)
    if rank == 0:
        plan = server.plan(args.batch)
        print(f"access plan: {len(plan.records)} records, "
              f"{len(plan.collections())} collections, {plan.total_bytes/1e6:.1f} MB")
        for h in plan.hints()[:8]:
            print("  hint:", h)

    model = server.model
    params = server.place(model.compute_params(model.init_params(seed=0)))
    batch = concrete_batch(cfg, args.batch, args.prompt_len, device=device)
    batch.pop("targets", None)
    t0 = time.perf_counter()
    tokens = server.generate(params, batch, args.gen)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    if mesh is not None:
        tokens = tokens.full_tensor()
    if rank == 0:
        print(f"generated {tuple(tokens.shape)} tokens in {dt:.2f}s "
              f"({args.batch * args.gen / dt:.1f} tok/s) on {device}"
              + (f", mesh {args.mesh}" if mesh is not None else ""))
        print("sample:", tokens[0, :12].tolist())


if __name__ == "__main__":
    main()
