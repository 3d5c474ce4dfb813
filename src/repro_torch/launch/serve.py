"""Serving driver of the port: batched prefill, then greedy decode against a
KV cache.  Counterpart of ``repro.launch.serve``.

With ``attn_impl="pallas"`` on a CUDA device the prefill runs the CUDA
flash-attention kernel and every decode step the CUDA flash-decode kernel.

Usage (on the card; ``--device cpu`` runs the plain path on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch chatglm3_6b \
      --batch 4 --prompt-len 512 --gen 32 --attn-impl pallas
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch.steps import concrete_batch, make_decode_step, make_prefill_step


class Server:
    def __init__(self, cfg, device="cuda", max_len: int = 256):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.max_len = max_len
        self.model, self.prefill_fn = make_prefill_step(cfg, self.device)
        _, self.decode_fn = make_decode_step(cfg, self.device)

    @torch.inference_mode()
    def generate(self, params, batch: dict, steps: int):
        """Prefill the prompt batch, then greedily decode: ``steps`` tokens
        in all ([B, steps]), the first from the prefill logits."""
        B, S = batch["inputs"].shape
        logits, cache = self.prefill_fn(params, batch)
        cache = self._pad_cache(cache)
        tok = torch.argmax(logits, dim=-1)
        out = [tok]
        for i in range(steps - 1):
            logits, cache = self.decode_fn(params, cache, tok, S + i)
            tok = torch.argmax(logits, dim=-1)
            out.append(tok)
        return torch.cat(out, dim=1)

    def _pad_cache(self, cache: dict) -> dict:
        """Grow the seq dim of the cache to ``max_len`` (decode writes slot
        ``pos`` in place, so the buffer must hold every position)."""
        S = cache["k"].shape[2]
        if S >= self.max_len:
            return cache
        out = {}
        for key in ("k", "v"):
            c = cache[key]
            shp = (c.shape[0], c.shape[1], self.max_len) + tuple(c.shape[3:])
            buf = torch.zeros(shp, dtype=c.dtype, device=c.device)
            buf[:, :, :S] = c
            out[key] = buf
        return out


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
    print("access plan: not ported yet (the next slice of the port, ROADMAP.md section 1 item 3)")

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
