"""Training loop of the port: config -> mesh -> parameters and AdamW state
placed by the sharding rules -> synthetic data pipeline -> train step ->
checkpointed loop with a straggler detector.  Counterpart of
``repro.launch.train``.

With ``mesh=`` (a ``DeviceMesh`` from ``launch.mesh.make_mesh``, every rank
running the same loop: ``torchrun``, or ``launch.spawn.run_ranks``) the
parameters, the AdamW moments and every batch are DTensors placed by
``logical_rules`` and the step runs under ``activate_sharding``; the
checkpoints keep the JAX on-disk format, written by rank 0 from the full
tensors and re-sharded on restore.  Without a mesh it runs on one device.

Every family trains.  With ``attn_impl="pallas"`` on a CUDA device an
attention with no window runs the CUDA flash-attention forward kernel twice
(the forward and its recomputation under ``remat="full"``) and the dK/dV
and dQ kernels once per step, at any length (the JAX package sends only
lengths that are multiples of 128 to its Pallas kernels; the CPU keeps
that guard):

- dense, moe and qwen2-vl: every layer's attention;
- encdec (whisper): the decoder's self-attention, the encoder's and the
  cross-attention's;
- hybrid (recurrentgemma): none, its attention is windowed;
- ssm (falcon-mamba): none.

The scans take their plain loop over time under autograd (the scan kernels
have no backward, as the TPU kernels have none).

Usage (on the card; ``--device cpu`` runs the plain path on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch chatglm3_6b \
      --layers 16 --steps 3 --batch 2 --seq 2048 --attn-impl pallas
  PYTHONPATH=src python -m repro_torch.launch.train --arch whisper_large_v3 \
      --steps 3 --batch 4 --seq 384 --attn-impl pallas
  PYTHONPATH=src python -m repro_torch.launch.train --arch falcon_mamba_7b --smoke \
      --device cpu --steps 20 --batch 4 --seq 128
  PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train \
      --arch chatglm3_6b --layers 16 --mesh 2x4 --steps 3 --batch 8 --seq 2048 \
      --attn-impl pallas          (one rank per card, NCCL)
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import os
import time
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import DataPipeline, SyntheticLMSource
from repro_torch.models.common import activate_sharding, tree_map
from repro_torch.runtime.fault import StragglerDetector

from .mesh import make_mesh
from .shardings import batch_pspecs, logical_rules, named
from .steps import make_optimizer, make_train_step

_FLOAT_INPUTS = {"embeds": torch.float32, "frames": torch.float32}


def synthetic_source(cfg, global_batch: int, seq_len: int, seed: int = 0) -> SyntheticLMSource:
    """The synthetic batches JAX's ``Trainer.train`` draws: ``embeds`` (and
    mrope's 3-stream ``positions``) for an ``embeds_input`` config, the
    audio ``frames`` for encdec.  encdec sets ``embeds_dim`` after
    construction, as JAX does: each batch then draws an ``embeds`` array the
    model does not read before its ``d_model``-wide frames."""
    source = SyntheticLMSource(
        cfg.vocab_size, global_batch, seq_len, seed=seed,
        embeds_dim=cfg.d_model if cfg.embeds_input else 0,
        frames=cfg.enc_positions if cfg.family == "encdec" else 0,
        mrope=cfg.rope == "mrope",
    )
    if cfg.family == "encdec":
        source.embeds_dim = cfg.d_model
    return source


def batch_to_device(batch: dict, device) -> dict:
    """A numpy batch on ``device``: tokens and positions as int64,
    ``embeds`` and ``frames`` as f32."""
    return {k: torch.from_numpy(v).to(device, _FLOAT_INPUTS.get(k, torch.int64))
            for k, v in batch.items()}


def full(t):
    """A DTensor's whole value on every rank (a collective: every rank
    calls it); a plain tensor as it is."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


class Trainer:
    def __init__(
        self,
        cfg,
        device="cuda",
        global_batch: int = 8,
        seq_len: int = 128,
        ckpt_dir: Optional[str] = None,
        total_steps: int = 1000,
        log_every: int = 10,
        mesh=None,
    ):
        self.cfg = cfg
        self.mesh = mesh
        self.device = resolve_device(mesh.device_type if mesh is not None else device)
        self.shape = ShapeConfig("train", "train", seq_len, global_batch)
        self.model, self.opt, self.step_fn = make_train_step(
            cfg, make_optimizer(total_steps), self.device, mesh
        )
        self.rank = mesh.get_rank() if mesh is not None else 0
        self.ckpt = CheckpointManager(ckpt_dir, keep=3) if ckpt_dir else None
        self.log_every = log_every
        self.stragglers = StragglerDetector()
        self.rules = logical_rules(cfg, self.shape, mesh) if mesh is not None else {}

    # -- state --------------------------------------------------------------

    def _place(self, params, opt_state):
        """Parameters and moments as DTensors placed by the rules (each rank
        keeps its shard of the whole tensors it is given); the step count
        stays a host scalar."""
        psh = self.model.param_pspecs(self.rules)
        opt_state = {"mu": named(self.mesh, psh, opt_state["mu"]),
                     "nu": named(self.mesh, psh, opt_state["nu"]), "step": opt_state["step"]}
        return named(self.mesh, psh, params), opt_state

    def init_state(self, seed: int = 0):
        params = self.model.init_params(seed)
        if self.mesh is not None:
            params = named(self.mesh, self.model.param_pspecs(self.rules), params)
        return params, self.opt.init(params)

    def maybe_restore(self, params, opt_state):
        start = 0
        if self.ckpt and self.ckpt.latest_step() is not None:
            # each leaf lands on its fresh counterpart's device (the step on
            # the host); under a mesh, whole, then re-sharded
            like = {"params": params, "opt": opt_state}
            if self.mesh is not None:
                like = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"),
                                like)
            start, state = self.ckpt.restore(like=like)
            params, opt_state = state["params"], state["opt"]
            if self.mesh is not None:
                on = lambda t: t.to(self.device)  # noqa: E731
                params, opt_state = self._place(tree_map(on, params),
                                                {**tree_map(on, opt_state),
                                                 "step": opt_state["step"]})
        return start, params, opt_state

    def save(self, step: int, params, opt_state) -> None:
        """A checkpoint at ``step``: under a mesh every rank gathers the
        whole tensors and rank 0 writes them."""
        state = {"params": params, "opt": opt_state}
        if self.mesh is not None:
            state = tree_map(full, state)
            if self.rank != 0:
                return
        self.ckpt.save(step, state)

    # -- loop ---------------------------------------------------------------

    def train(self, total_steps: int, seed: int = 0, save_every: int = 100):
        params, opt_state = self.init_state(seed)
        start, params, opt_state = self.maybe_restore(params, opt_state)
        source = synthetic_source(self.cfg, self.shape.global_batch, self.shape.seq_len, seed)
        pipeline = DataPipeline(source, start_step=start, prefetch=2)

        put = lambda b: b  # noqa: E731
        context = contextlib.nullcontext
        if self.mesh is not None:
            specs = batch_pspecs(self.cfg, self.shape, self.mesh)
            put = lambda b: named(self.mesh, {k: specs[k] for k in b}, b)  # noqa: E731
            context = functools.partial(activate_sharding, self.mesh, self.rules)
        losses = []
        try:
            for step, batch in pipeline:
                if step >= total_steps:
                    break
                batch = put(batch_to_device(batch, self.device))
                t0 = time.perf_counter()
                with context():
                    params, opt_state, metrics = self.step_fn(params, opt_state, batch)
                loss = float(full(metrics["loss"]))  # waits for the device
                dt = time.perf_counter() - t0
                self.stragglers.record("self", dt)
                losses.append(loss)
                if step % self.log_every == 0 and self.rank == 0:
                    tok_s = self.shape.global_batch * self.shape.seq_len / dt
                    print(f"step {step:5d} loss {loss:.4f} {dt*1e3:7.1f} ms/step "
                          f"{tok_s:,.0f} tok/s", flush=True)
                if self.ckpt and step and step % save_every == 0:
                    self.save(step, params, opt_state)
        finally:
            pipeline.close()
            if self.ckpt:
                self.ckpt.wait()
        return params, opt_state, losses


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--layers", type=int, default=0, help="cut the depth to this many layers")
    ap.add_argument("--attn-impl", default=None,
                    help="naive | chunked | pallas (the CUDA kernels); default: the config's")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=100)
    ap.add_argument("--mesh", default=None,
                    help="DATAxMODEL (or PODxDATAxMODEL): train on a mesh of every rank "
                         "of the process group (torchrun's)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.layers:
        cfg = cfg.replace(n_layers=args.layers)
    if args.attn_impl:
        cfg = cfg.replace(attn_impl=args.attn_impl)
    mesh = None
    if args.mesh:
        shape = tuple(int(n) for n in args.mesh.split("x"))
        axes = ("pod", "data", "model")[-len(shape):]
        if torch.device(args.device).type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        mesh = make_mesh(shape, axes, device=args.device)
    trainer = Trainer(
        cfg, device=args.device, global_batch=args.batch, seq_len=args.seq,
        ckpt_dir=args.ckpt_dir, total_steps=args.steps, log_every=1, mesh=mesh,
    )
    _, _, losses = trainer.train(args.steps, save_every=args.save_every)
    if trainer.rank == 0:
        print(f"final loss {losses[-1]:.4f} (from {losses[0]:.4f} over {len(losses)} steps) "
              f"on {trainer.device}" + (f", mesh {args.mesh}" if mesh is not None else ""))


if __name__ == "__main__":
    main()
