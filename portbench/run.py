"""The port's serving benchmark: one cell of ``BENCHMARK.json``, one run.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The run makes the cell's weights on the card
from the seed, builds ``repro_torch``'s ``ContinuousBatcher`` (its decode
tick captured in a CUDA graph) and drives it with the cell's traffic for a
warm-up and then ``--seconds`` of window (``pb/engine.py``).  After the
window it reads the peak memory, frees the program's state and holds what
the timed path served to the plain reference (``pb/check.py``).  The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, the cell's end-to-end metrics (``--trace 0``) or its per-layer
metrics (``--trace 1``, which profiles the window's first TRACE_S
seconds), ``device``, with ``--trace 1`` a ``breakdown``, and last
``checked``, each compared number beside its limit; standard error ends
with the same numbers.

The run exits with another code than 0, and prints no result, when CUDA or
the cell's chips are missing, and when ``jax``, ``jaxlib``, ``flax`` or the
JAX package ``repro`` is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = HERE / ".cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACE_S = 6.0  # seconds of the window a traced run profiles
# the program's configuration keys that the configuration file sets
PROGRAM_KEYS = ("family", "n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
                "vocab_size", "norm", "mlp", "rope", "rope_theta", "qkv_bias", "qk_norm",
                "tie_embeddings", "attn_impl", "n_experts", "experts_per_token", "capacity_factor",
                "moe_chunk", "moe_dispatch")

sys.path.insert(0, str(HERE))
sys.path.insert(0, str(ROOT / "src"))


def use_checkout_caches() -> None:
    """Every build and kernel cache at a fixed place inside the checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_kernels() -> None:
    """Every CUDA kernel of the program built (into the checkout's cache)
    and loaded, so that nothing builds inside the window."""
    from repro_torch.kernels import _build

    _build.BUILD_ROOT = CACHE / "kernels"
    for name in _build.build_all():
        _build.load(name)


def read_libraries() -> None:
    """Every shared library the process maps, read through once.  On a
    fresh machine the first read of them can be slow, and a window whose
    admissions load kernel code from pages not yet read would wait on it,
    so set-up reads them all."""
    paths = set()
    with open("/proc/self/maps") as maps:
        for line in maps:
            parts = line.split(maxsplit=5)
            if len(parts) == 6 and ".so" in os.path.basename(parts[5].strip()):
                paths.add(parts[5].strip())
    buf = bytearray(16 << 20)
    for path in sorted(p for p in paths if os.path.isfile(p)):
        with open(path, "rb", buffering=0) as f:
            while f.readinto(buf):
                pass


def program_config(cfg: dict):
    from repro_torch.configs import get_config

    keys = {k: cfg[k] for k in PROGRAM_KEYS if k in cfg}
    return get_config(cfg["model"]).replace(compute_dtype=cfg["dtype"], **keys)


def check_layout(model, tree: dict) -> None:
    """The benchmark's weight tree has the program's paths and shapes."""
    from pb.weights import leaves

    want = {p: tuple(t.shape) for p, t in leaves(model.abstract_params())}
    got = {p: tuple(t.shape) for p, t in leaves(tree)}
    if want != got:
        raise RuntimeError(f"the weights' layout differs from the program's: "
                           f"{sorted(set(want.items()) ^ set(got.items()))}")


def serve(cell, seed: int, seconds: float, trace: bool, device: str, t_process: float,
          control: bool = False) -> dict:
    """One run of ``cell``; returns the result's fields and the readings."""
    import torch

    from pb import check, engine, reference, spec, weights
    from pb.traffic import Traffic
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.models.model import Model
    from repro_torch.runtime.scheduler import ContinuousBatcher, Request

    cfg, mix, cc = cell.config, cell.traffic, cell.cell
    dev = torch.device(device)
    if dev.type == "cuda":
        load_kernels()
    read_libraries()
    tree = weights.make(cfg, seed, dev)
    model = Model(program_config(cfg), device=dev)
    check_layout(model, tree)
    batcher = ContinuousBatcher(model, tree, mix["slots"], mix["max_len"], device=dev)
    tracer = None
    if trace:
        from pb.trace import Tracer

        with torch.profiler.profile():  # the profiler's own start-up, before the window
            torch.zeros(1, device=dev).add_(1)
        tracer = Tracer()
    traffic = Traffic(mix, seed, cfg["vocab_size"], cc.get("rate_rps"), seconds, cc["warmup_s"])
    gen = engine.LoadGen(batcher, traffic, mix, Request, tracer,
                         (lambda: flash_attention_fwd.launches) if trace else None)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    rec = gen.run(cfg, cc["warmup_s"], seconds, TRACE_S)
    rec.setup_s = rec.t_open - t_process
    if dev.type == "cuda":
        torch.cuda.synchronize()
        rec.peak_bytes = torch.cuda.max_memory_allocated()
    if tracer is not None:
        rec.trace = tracer.reduce()
        del tracer
    window = [e for e in rec.requests if rec.t_open <= e["due"] < rec.t_close]
    state = check.State.take(batcher, rec.requests)
    del batcher, gen, model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    reference.exact_f32()
    t = time.perf_counter()
    with torch.inference_mode():
        prog, ctrl = check.compare(cfg, tree, state, seed, cc["check"], control)
    check_s = time.perf_counter() - t
    names = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in names:
        value = spec.reader(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    failed = sum(1 for e in window if not e["times"])
    limits = cc["limits"]
    out = {
        "correct": failed == 0 and all(prog[k] <= limits[k] for k in limits),
        "attempted": len(window),
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
                   "count": cell.chips,
                   "memory_peak_bytes": rec.peak_bytes or 0},
    }
    if rec.trace is not None:
        out["device"].update(busy_s=rec.trace["busy_s"], window_s=rec.trace["window_s"])
        out["breakdown"] = {k: rec.trace[k] for k in ("device_ops", "idle_gaps")}
    out["checked"] = {k: {"value": prog[k], "limit": limits[k]} for k in limits}
    return {"result": out, "program": prog, "control": ctrl, "check_s": check_s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    use_checkout_caches()
    import torch

    from pb import spec

    cell = spec.find_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}", file=sys.stderr)
        return 2
    run = serve(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_PROCESS)
    found = loaded_forbidden()
    if found:
        print(f"loaded in the process after the window: {', '.join(found)}", file=sys.stderr)
        return 3
    prog = run["program"]
    print(f"checked {prog['tokens']} served tokens and {prog['rows']} cache rows in "
          f"{run['check_s']:.1f} s: {json.dumps(prog)}", file=sys.stderr)
    for k, v in run["result"]["checked"].items():
        print(f"check {k} = {v['value']} (limit {v['limit']})", file=sys.stderr)
    print(json.dumps(run["result"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
