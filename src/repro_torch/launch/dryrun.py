"""Multi-pod dry-run of the port: every (architecture x input shape) cell
traced on the production meshes (one pod, (16, 16) = 256 ranks; two pods,
(2, 16, 16) = 512 ranks), which proves that the distribution config is
coherent, with the roofline inputs of each cell.  Counterpart of
``repro.launch.dryrun``.

The process is rank 0 of a ``fake`` process group of 256 or 512 ranks
(PyTorch's test backend: collectives return at once and move nothing), made
inside ``run_cell`` and destroyed before it returns.  The production mesh
(``launch.mesh.make_production_mesh`` on ``"cpu"``) and the logical rules
(``launch.shardings``) place the step's arguments as DTensors whose local
shards lie on the ``meta`` device: nothing is allocated, no card is touched
(as JAX's dry-run runs on forced host devices).  A record holds:

  * ``mem_argument_size_in_bytes``: this rank's bytes of the step's
    arguments under their placements (train: parameters, AdamW's f32 mu and
    nu and its int32 step, the batch; prefill: parameters and batch;
    decode: parameters, cache, tokens and the int32 position), JAX's
    ``compiled.memory_analysis().argument_size_in_bytes``;
  * ``jaxpr_flops``, ``jaxpr_dot_flops``, ``jaxpr_bytes``: the global totals
    of the unsharded step traced on ``meta`` (``launch.costmodel.step_cost``;
    the names are JAX's, so that two records diff), and ``kernels``, the
    hand-written kernels it reaches with their calls (``attn_impl="pallas"``
    cells);
  * ``collective_bytes_per_rank`` and ``collective_counts``: the sharded
    step run on the mesh's DTensors (``launch.costmodel.collective_cost``),
    what JAX parses from its partitioned HLO;
  * ``param_count``, ``active_param_count``, ``model_flops`` (6 N D for
    train, 2 N D otherwise, N active), ``tokens_per_step``;
  * ``t_trace_s`` (the cost trace) and ``t_sharded_s`` (the sharded run).

Nothing is compiled, so a record has no ``t_compile_s`` and no temporary
bytes.  Records land in ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json``
and are read by ``launch.roofline``.

Usage (CPU only):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch recurrentgemma_2b \
      --shape long_500k --mesh multi
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --jobs 4
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import json
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ART_DIR = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"
ALL_MESHES = ("single", "multi")
SKIP_REASON = "long_500k requires sub-quadratic attention (DESIGN.md §Arch-applicability)"


def iter_cells():
    from repro_torch.configs import ARCH_IDS, SHAPES

    for arch in ARCH_IDS:
        for shape in SHAPES:
            yield arch, shape


@contextlib.contextmanager
def fake_group(world: int):
    """This process as rank 0 of a ``fake`` process group of ``world``
    ranks, destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group exists already: the dry-run makes its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local_bytes(tree) -> int:
    """This rank's bytes of a tree of DTensors (or plain tensors)."""
    import torch.utils._pytree as pytree
    from torch.distributed.tensor import DTensor

    total = 0
    for t in pytree.tree_leaves(tree):
        t = t.to_local() if isinstance(t, DTensor) else t
        total += t.numel() * t.element_size()
    return total


def _config(arch: str, overrides):
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    return cfg.replace(**overrides) if overrides else cfg


def _step(cfg, shape, mesh=None, rules=None):
    """(the step's arguments on ``meta``, the step function) for ``shape``'s
    kind; with a ``mesh``, the arguments placed on it by ``rules`` as
    DTensors over ``meta`` shards and the step built for it."""
    from repro_torch.models.model import Model

    from .shardings import PSpec, batch_pspecs, cache_pspecs, named
    from .steps import (
        decode_input_specs,
        input_specs,
        make_decode_step,
        make_prefill_step,
        make_train_step,
    )

    def place(specs, tree):  # ``specs`` a function: the rules exist only with a mesh
        return tree if mesh is None else named(mesh, specs(), tree)

    model = Model(cfg, device="meta")
    params = place(lambda: model.param_pspecs(rules), model.abstract_params())
    if shape.kind == "decode":
        _, step = make_decode_step(cfg, device="meta", mesh=mesh)
        cache, tokens, pos = decode_input_specs(cfg, shape)
        cache = place(lambda: cache_pspecs(cfg, shape, mesh), cache)
        tokens = place(lambda: PSpec(rules["batch"], None), tokens)
        return (params, cache, tokens, pos), step
    batch = place(lambda: batch_pspecs(cfg, shape, mesh), input_specs(cfg, shape))
    if shape.kind == "prefill":
        _, step = make_prefill_step(cfg, device="meta", mesh=mesh)
        return (params, batch), step
    _, opt, step = make_train_step(cfg, device="meta", mesh=mesh)
    return (params, opt.init(params), batch), step  # the step count: a host int32


def layer_fit(cfg) -> list:
    """[(config overrides, weight)]: the depths to trace, whose costs
    weighted and summed give the cost at the config's own depth.  A step's
    cost is affine in its number of layers (each layer of a stack costs
    the same; the hybrid's layers repeat their ``block_pattern``), so two
    depths fix it, as JAX's cost model multiplies its layer scan's body by
    the trip count: depths a and b = a + p, one period p apart (a = L mod
    p + p: 1, or for the hybrid the remainder and one whole pattern, so
    that every layer kind is there), and cost = c(a) + k (c(b) - c(a))
    with k = (L - a) / p.  encdec's two stacks are affine
    each: c(1, 1) + (E - 1) (c(2, 1) - c(1, 1)) + (D - 1) (c(1, 2) - c(1,
    1)) for E encoder and D decoder layers.  A config no deeper than b is
    traced as it is."""
    if cfg.family == "encdec":
        E, D = cfg.enc_layers, cfg.n_layers
        return [({"enc_layers": 1, "n_layers": 1}, 3.0 - E - D),
                ({"enc_layers": 2, "n_layers": 1}, E - 1.0),
                ({"enc_layers": 1, "n_layers": 2}, D - 1.0)]
    p = len(cfg.block_pattern) if cfg.family == "hybrid" else 1
    a = cfg.n_layers % p + p
    if cfg.n_layers <= a + p:
        return [({"n_layers": cfg.n_layers}, 1.0)]
    k = (cfg.n_layers - a) / p
    return [({"n_layers": a}, 1.0 - k), ({"n_layers": a + p}, k)]


def _add(total: dict, part: dict, weight: float) -> dict:
    """``total`` + ``weight`` * ``part``, numbers and nested dicts of them
    key by key."""
    out = dict(total)
    for k, v in part.items():
        if isinstance(v, dict):
            out[k] = _add(out.get(k, {}), v, weight)
        else:
            out[k] = out.get(k, 0.0) + weight * v
    return out


def cell_layout(arch: str, shape_name: str, mesh_kind: str, overrides: dict | None = None,
                trace: bool = False) -> dict:
    """The record of a cell without its traces (``trace=False``): status
    (``skipped`` with JAX's reason for ``long_500k`` outside the ssm and
    hybrid families), chips, parameter counts, model FLOPs and this rank's
    argument bytes under the production mesh's placements; with ``trace``
    also the cost model's and the sharded run's figures (``run_cell``)."""
    from repro_torch.configs import SHAPES, runnable_shapes
    from repro_torch.models.common import activate_sharding

    from .costmodel import collective_cost, step_cost
    from .mesh import PRODUCTION_SHAPES, make_production_mesh
    from .shardings import logical_rules

    cfg = _config(arch, overrides)
    shape = SHAPES[shape_name]
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "kind": shape.kind,
                 "status": "running", "overrides": dict(overrides or {})}
    if shape not in runnable_shapes(cfg):
        rec["status"] = "skipped"
        rec["reason"] = SKIP_REASON
        return rec
    multi = mesh_kind == "multi"
    world = 1
    for n in PRODUCTION_SHAPES[multi][0]:
        world *= n
    with fake_group(world):
        mesh = make_production_mesh(multi_pod=multi, device="cpu", backend="fake")
        rec["chips"] = mesh.size()
        rules = logical_rules(cfg, shape, mesh)
        args, _ = _step(cfg, shape, mesh, rules)
        rec["mem_argument_size_in_bytes"] = sum(_local_bytes(a) for a in args)
        if trace:
            fit = layer_fit(cfg)
            rec["layer_fit"] = [[o, w] for o, w in fit]
            t0 = time.perf_counter()
            cost = {}
            for o, w in fit:
                c_args, c_step = _step(cfg.replace(**o), shape)
                c = step_cost(c_step, *c_args)
                cost = _add(cost, {"flops": c.flops, "dot_flops": c.dot_flops,
                                   "bytes": c.bytes, "collective_bytes": c.collective_bytes,
                                   "kernels": c.kernels}, w)
            rec["jaxpr_flops"] = cost["flops"]
            rec["jaxpr_dot_flops"] = cost["dot_flops"]
            rec["jaxpr_bytes"] = cost["bytes"]
            rec["jaxpr_collective_bytes"] = cost["collective_bytes"]
            rec["kernels"] = cost["kernels"]
            rec["t_trace_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            coll = {}
            for o, w in fit:
                c_args, c_step = _step(cfg.replace(**o), shape, mesh, rules)
                with activate_sharding(mesh, rules):
                    part = collective_cost(c_step, *c_args)
                coll = _add(coll, {k: part[k] for k in ("bytes_per_rank", "bytes", "counts")}, w)
            rec["collective_bytes_per_rank"] = coll["bytes_per_rank"]
            rec["collective_bytes"] = coll["bytes"]
            rec["collective_counts"] = coll["counts"]
            rec["t_sharded_s"] = time.perf_counter() - t0
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    rec["param_count"] = cfg.param_count()
    rec["active_param_count"] = n_active
    rec["model_flops"] = (6.0 if shape.kind == "train" else 2.0) * n_active * tokens
    rec["tokens_per_step"] = tokens
    rec["status"] = "ok"
    return rec


def run_cell(arch: str, shape_name: str, mesh_kind: str, overrides: dict | None = None) -> dict:
    """One cell's record, traced (``cell_layout`` with ``trace=True``)."""
    return cell_layout(arch, shape_name, mesh_kind, overrides, trace=True)


def _overrides(pairs: list) -> dict:
    out = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        try:
            out[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            out[k] = v
    return out


def _run_all(args) -> int:
    """Each cell in a subprocess of its own, ``--jobs`` at a time; a cell
    whose record exists is skipped unless ``--force``."""
    meshes = ALL_MESHES if args.mesh == "both" else (args.mesh,)
    cells = [(a, s, m) for a, s in iter_cells() for m in meshes]
    extra = [f for kv in args.set for f in ("--set", kv)] + (["--tag", args.tag] if args.tag else [])
    sfx = f"__{args.tag}" if args.tag else ""
    todo = [c for c in cells
            if args.force or not (ART_DIR / f"{c[0]}__{c[1]}__{c[2]}{sfx}.json").exists()]

    def run(cell) -> str | None:
        arch, shape, m = cell
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
               shape, "--mesh", m, *extra]
        rc = subprocess.run(cmd, stdout=subprocess.DEVNULL).returncode
        print(f"{'FAIL' if rc else 'done'} {arch}/{shape}/{m}", flush=True)
        return f"{arch}/{shape}/{m}" if rc else None

    with ThreadPoolExecutor(max_workers=args.jobs) as pool:
        failed = [name for name in pool.map(run, todo) if name]
    print(f"dry-run complete; {len(failed)} failures: {failed}")
    return 1 if failed else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (python literal), e.g. --set attn_impl='pallas'")
    ap.add_argument("--tag", default="", help="artifact suffix for variant runs")
    args = ap.parse_args(argv)
    ART_DIR.mkdir(parents=True, exist_ok=True)
    if args.all:
        return _run_all(args)
    if args.mesh == "both":
        ap.error("--mesh both needs --all")
    rec = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh, "status": "error"}
    try:
        rec = run_cell(args.arch, args.shape, args.mesh, _overrides(args.set))
    except Exception:  # noqa: BLE001 -- written into the record, and the exit code says so
        rec["traceback"] = traceback.format_exc()
        print(rec["traceback"], file=sys.stderr)
    sfx = f"__{args.tag}" if args.tag else ""
    out = ART_DIR / f"{args.arch}__{args.shape}__{args.mesh}{sfx}.json"
    out.write_text(json.dumps(rec, indent=2, default=str))
    print(json.dumps({k: rec[k] for k in ("arch", "shape", "mesh", "status") if k in rec}))
    if rec["status"] == "ok":
        print(f"trace={rec['t_trace_s']:.1f}s sharded={rec['t_sharded_s']:.1f}s "
              f"flops={rec['jaxpr_flops']:.3e} "
              f"coll_bytes/rank={rec['collective_bytes_per_rank']:.3e}")
    return 0 if rec["status"] in ("ok", "skipped") else 1


if __name__ == "__main__":
    sys.exit(main())
