"""The port's dry-run and cost tooling (``repro_torch.launch.dryrun``,
``launch.costmodel``, ``kernels.pricing``) against the JAX package:

  * every cell (10 architectures x 4 shapes x {single, multi}): status,
    skip reason, chips and parameter counts equal JAX's ``run_cell``
    fields, and this rank's argument bytes equal the sum of JAX's
    ``NamedSharding(mesh, spec).shard_shape`` bytes under its own specs, on
    512 forced host devices in a subprocess (no lowering, no compile);
  * ``dot_flops`` of every smoke config's prefill, decode and train steps
    against JAX's ``costmodel.step_cost`` on both attention routes, to 1e-6
    relative (the terms each side counts and the other cannot are added
    explicitly: see ``_jax_only_products``);
  * each priced kernel against JAX's ``_pallas_cost`` of its Pallas twin at
    the same shapes, FLOPs and bytes;
  * a DP x TP train step on a ``fake`` (2, 2) group: the gradient
    all-reduce over ``data`` found, its bytes the hand count from the
    parameters' placements (the twin of ``test_hlo_parser_finds_collectives``);
  * the layer fit of the dry-run equal to a full trace;
  * two real cells: recurrentgemma-2b's ``long_500k`` on the multi-pod mesh
    (the ring over ("pod", "data")) and yi-34b's, skipped with JAX's reason.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.launch import costmodel as jcm  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, get_smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.costmodel import collective_cost, step_cost  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    decode_input_specs,
    input_specs,
    make_decode_step,
    make_prefill_step,
    make_train_step,
)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
REL = 1e-6

# JAX's side of every cell, on 512 forced host devices: its run_cell fields
# for the skipped cells (it returns before it needs a mesh) and, for the
# rest, its mesh's size, the parameter counts and the bytes of one device's
# shard of each argument under its own specs
_JAX_CELLS = textwrap.dedent("""
    import json, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import ARCH_IDS, SHAPES, get_config, runnable_shapes
    from repro.launch import dryrun
    from repro.launch.mesh import make_production_mesh
    from repro.launch.shardings import batch_pspecs, cache_pspecs, logical_rules
    from repro.launch.steps import decode_input_specs, input_specs
    from repro.models.model import Model

    port_kv = json.loads(sys.argv[1])  # the port's cache specs where JAX's name an axis twice

    def nbytes(mesh, spec, aval):
        try:
            shape = NamedSharding(mesh, spec).shard_shape(aval.shape)
        except Exception as err:  # DuplicateSpecError
            return ("dup", str(err))
        return int(np.prod(shape)) * np.dtype(aval.dtype).itemsize

    def tree_bytes(mesh, specs, avals):
        leaves = jax.tree.leaves(jax.tree.map(lambda s, a: nbytes(mesh, s, a), specs, avals,
                                              is_leaf=lambda x: isinstance(x, P)))
        return leaves

    meshes = {m: make_production_mesh(multi_pod=m == "multi") for m in ("single", "multi")}
    out = {}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        model = Model(cfg)
        params = model.abstract_params()
        for sname, shape in SHAPES.items():
            for m, mesh in meshes.items():
                key = f"{arch}/{sname}/{m}"
                if shape not in runnable_shapes(cfg):
                    rec = dryrun.run_cell(arch, sname, m)
                    out[key] = {k: rec[k] for k in ("status", "reason")}
                    continue
                rules = logical_rules(cfg, shape, mesh)
                pspecs = model.param_pspecs(rules)
                parts = tree_bytes(mesh, pspecs, params)
                if shape.kind == "train":
                    f32 = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, jnp.float32), params)
                    parts += 2 * tree_bytes(mesh, pspecs, f32) + [4]
                if shape.kind in ("train", "prefill"):
                    parts += tree_bytes(mesh, batch_pspecs(cfg, shape, mesh), input_specs(cfg, shape))
                else:
                    cache, tok, pos = decode_input_specs(cfg, shape)
                    cspecs = cache_pspecs(cfg, shape, mesh)
                    for k, spec in cspecs.items():
                        b = nbytes(mesh, spec, cache[k])
                        if isinstance(b, tuple):  # a fault of the reference: the port's layout
                            b = nbytes(mesh, P(*port_kv[key][k]), cache[k])
                        parts.append(b)
                    parts += [nbytes(mesh, P(rules["batch"], None), tok), 4]
                out[key] = {"status": "ok", "chips": mesh.size,
                            "param_count": cfg.param_count(),
                            "active_param_count": cfg.active_param_count(),
                            "mem_argument_size_in_bytes": int(sum(parts))}
    print("JSON" + json.dumps(out))
""")


def _port_cache_specs() -> dict:
    """The port's decode cache specs of every decode cell, as lists (the
    subprocess takes them where JAX's spec names an axis twice)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import PRODUCTION_SHAPES
    from repro_torch.launch.shardings import cache_pspecs

    class Shape:  # the rules read the mesh's axis sizes alone
        def __init__(self, multi):
            dims, axes = PRODUCTION_SHAPES[multi]
            self.shape = dict(zip(axes, dims))

    out = {}
    for arch, sname in dryrun.iter_cells():
        for m in dryrun.ALL_MESHES:
            if SHAPES[sname].kind == "decode":
                specs = cache_pspecs(get_config(arch), SHAPES[sname], Shape(m == "multi"))
                out[f"{arch}/{sname}/{m}"] = {k: list(v) for k, v in specs.items()}
    return out


@pytest.fixture(scope="module")
def jax_cells():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    r = subprocess.run([sys.executable, "-c", _JAX_CELLS, json.dumps(_port_cache_specs())],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    line = next(x for x in r.stdout.splitlines() if x.startswith("JSON"))
    return json.loads(line[4:])


@pytest.fixture(scope="module")
def port_cells():
    return {f"{a}/{s}/{m}": dryrun.cell_layout(a, s, m)
            for a, s in dryrun.iter_cells() for m in dryrun.ALL_MESHES}


def test_every_cell_matches_jax(jax_cells, port_cells):
    """All 80 cells: status, reason, chips and parameter counts are JAX's;
    the 16 ``long_500k`` cells of the eight attention architectures are
    skipped."""
    assert len(port_cells) == 80 and set(port_cells) == set(jax_cells)
    skipped = [k for k, r in port_cells.items() if r["status"] == "skipped"]
    assert len(skipped) == 16 and all("/long_500k/" in k for k in skipped)
    for key, want in jax_cells.items():
        got = port_cells[key]
        for field in ("status", "reason", "chips", "param_count", "active_param_count"):
            assert got.get(field) == want.get(field), (key, field, got.get(field),
                                                       want.get(field))


def test_argument_bytes_per_rank_match_jax(jax_cells, port_cells):
    """Every runnable cell: this rank's bytes of the step's arguments
    (parameters; AdamW's mu, nu and step and the batch for train; the batch
    for prefill; cache, tokens and position for decode) under the port's
    placements equal one device's under JAX's ``NamedSharding``s."""
    n = 0
    for key, want in jax_cells.items():
        if want["status"] == "ok":
            assert port_cells[key]["mem_argument_size_in_bytes"] == \
                want["mem_argument_size_in_bytes"], key
            n += 1
    assert n == 64


def _jit_walk(monkeypatch):
    """JAX's jaxpr walk as it means to run: under JAX 0.9 a ``jax.jit``
    call is a ``jit`` equation (it was ``pjit``), which
    ``costmodel._sub_jaxprs`` does not open, so every product inside a
    jitted function (the Pallas wrappers among them) would go uncounted.
    The walk is handed the sub-jaxpr of such an equation, as of a
    ``pjit``; nothing else changes."""
    sub = jcm._sub_jaxprs

    def walk(eqn):
        if eqn.primitive.name == "jit":
            return [(eqn.params["jaxpr"].jaxpr, 1)]
        return sub(eqn)

    monkeypatch.setattr(jcm, "_sub_jaxprs", walk)


def _jax_only_products(cfg, kind: str, B: int, S: int, impl: str) -> float:
    """The products JAX's step counts and the port's does not, by route:

    - moe: JAX builds the combine tensor with the einsum "tkec,tk->tec"
      (2 T k E C a chunk, C = max(1, int(1.25 T k / E))), the port writes
      the same values with a scatter (``models.moe._dispatch_onehot``); the
      train step runs it in the forward, the recomputation and the
      backward (for the gates' gradient);
    - ssm on the "pallas" route: JAX's scan contracts the state with C
      as a product (2 B S Ch N a layer), which the port's
      ``selective_scan`` kernel does inside (priced by its outputs, as
      JAX prices every kernel that is not attention) -- serving only: under
      autograd both run the plain loop;
    - encdec on the "pallas" route, train: JAX's Pallas branch takes only
      lengths that are multiples of 128, the port's card route every
      length, so an attention with a ragged length (the encoder's F x F and
      the cross-attention's S x F at F = ``enc_positions``) runs JAX's
      chunked einsums, whose backward makes 8 B H Sq Sk D of products (two
      for each of the forward's two einsums), where the port runs its dK/dV
      and dQ kernels, which recompute the scores, at the products their
      wrappers price (``_flash_bwd_products``); the forwards agree at
      4 B H Sq Sk D."""
    T = B * (1 if kind == "decode" else S)
    extra = 0.0
    if cfg.family == "moe":
        E, k = cfg.n_experts, cfg.experts_per_token
        for lo in range(0, T, cfg.moe_chunk):
            t = min(cfg.moe_chunk, T - lo)
            extra += 2.0 * t * k * E * max(1, int(cfg.capacity_factor * t * k / E))
        extra *= cfg.n_layers * (3 if kind == "train" else 1)
    if cfg.family == "ssm" and impl == "pallas" and kind != "train":
        extra += 2.0 * B * (1 if kind == "decode" else S) * cfg.d_inner * cfg.ssm_state \
            * cfg.n_layers
    if cfg.family == "encdec" and impl == "pallas" and kind == "train":
        F = cfg.enc_positions
        for n, sq, sk in ((cfg.enc_layers, F, F), (cfg.n_layers, S, F), (cfg.n_layers, S, S)):
            if sq % 128 or sk % 128:
                H, D = cfg.n_heads, cfg.head_dim
                extra -= n * (_flash_bwd_products(B, sq, sk, H, D) - 8.0 * B * H * sq * sk * D)
    return extra


def _flash_bwd_products(B: int, Sq: int, Sk: int, H: int, D: int) -> float:
    """The products the port's cost model counts for one flash backward
    (dK/dV and dQ) at these lengths: its kernel wrappers priced on ``meta``
    tensors."""
    from repro_torch.kernels import pricing
    from repro_torch.kernels.flash_attention_bwd import (
        flash_attention_bwd_dkdv,
        flash_attention_bwd_dq,
    )

    dots = []
    q, do = (torch.empty((B, Sq, H, D), device="meta") for _ in range(2))
    k, v = (torch.empty((B, Sk, H, D), device="meta") for _ in range(2))
    lse = torch.empty((B * H, Sq), device="meta")
    with pricing.pricing(lambda name, flops, nbytes, dot: dots.append(dot)):
        flash_attention_bwd_dkdv(q, k, v, do, lse, lse, causal=False)
        flash_attention_bwd_dq(q, k, v, do, lse, lse, causal=False)
    return sum(dots)


@pytest.mark.parametrize("impl", ("chunked", "pallas"))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_dot_flops_match_jax(arch, impl, monkeypatch):
    """Prefill (B 2, 256 tokens), decode (B 2 over 256 slots) and train (B
    2, S 256, ``remat="full"``) of the smoke config: the port's
    ``dot_flops`` plus the products only JAX's route makes equal JAX's
    ``step_cost(...).dot_flops`` to 1e-6 relative.  Both count the
    recomputation of ``remat`` once more in the train step: JAX's walk
    opens the ``checkpoint`` equation of the backward, the port's trace
    runs ``torch.utils.checkpoint``'s recomputation."""
    _jit_walk(monkeypatch)
    B, S = 2, 256
    cfg = get_smoke_config(arch).replace(attn_impl=impl)
    jcfg = jsmoke(arch).replace(attn_impl=impl)
    jm = JModel(jcfg)
    jp = jax.eval_shape(lambda: jm.init_params(jax.random.PRNGKey(0)))
    model, prefill = make_prefill_step(cfg, device="meta")
    _, decode = make_decode_step(cfg, device="meta")
    _, opt, train = make_train_step(cfg, device="meta")
    params = model.abstract_params()
    _, jprefill = jsteps.make_prefill_step(jcfg)
    _, jdecode = jsteps.make_decode_step(jcfg)
    _, jopt, jtrain = jsteps.make_train_step(jcfg)
    cases = {
        "prefill": (step_cost(prefill, params, input_specs(cfg, ShapeConfig("p", "prefill", S, B))),
                    jcm.step_cost(jprefill, jp, jsteps.input_specs(jcfg, JShape("p", "prefill",
                                                                                  S, B)))),
        "decode": (step_cost(decode, params, *decode_input_specs(cfg, ShapeConfig("d", "decode",
                                                                                  S, B))),
                   jcm.step_cost(jdecode, jp, *jsteps.decode_input_specs(
                       jcfg, JShape("d", "decode", S, B)))),
        "train": (step_cost(train, params, opt.init(params),
                            input_specs(cfg, ShapeConfig("t", "train", S, B))),
                  jcm.step_cost(jtrain, jp, jax.eval_shape(jopt.init, jp),
                                jsteps.input_specs(jcfg, JShape("t", "train", S, B)))),
    }
    for kind, (got, want) in cases.items():
        extra = _jax_only_products(cfg, kind, B, S, impl)
        assert got.dot_flops + extra == pytest.approx(want.dot_flops, rel=REL), (kind, got,
                                                                                 want, extra)
    kernels = {k: v.kernels for k, (v, _) in cases.items()}
    if impl == "chunked":
        assert all(k in ({}, {"prefetch_gather_fwd": 1}) for k in kernels.values()), kernels
    elif cfg.family in ("dense", "moe", "encdec"):
        L = cfg.n_layers
        assert kernels["decode"]["decode_attention_fwd"] == L
        # encdec: the encoder's and the cross-attention's ragged lengths on
        # the card's route too
        A = L + (cfg.enc_layers + L if cfg.family == "encdec" else 0)
        assert kernels["train"] == {"flash_attention_fwd": 2 * A,
                                    "flash_attention_bwd_dkdv": A, "flash_attention_bwd_dq": A}


def _pallas_costs(fn, *args) -> list:
    """JAX's ``_pallas_cost`` of every ``pallas_call`` in ``fn``'s jaxpr."""
    out = []

    def walk(j):
        for e in j.eqns:
            if e.primitive.name == "pallas_call":
                ins = sum(jcm._nbytes(v.aval) for v in e.invars if hasattr(v, "aval"))
                outs = sum(jcm._nbytes(v.aval) for v in e.outvars)
                out.append(jcm._pallas_cost(e, ins, outs))
            for p in e.params.values():
                for q in (p if isinstance(p, (list, tuple)) else [p]):
                    if hasattr(q, "eqns"):
                        walk(q)
                    elif hasattr(q, "jaxpr") and hasattr(q.jaxpr, "eqns"):
                        walk(q.jaxpr)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return out


def _priced(fn, *args) -> list:
    """[(name, flops, bytes, dot_flops)] of the kernels ``fn`` reaches on
    ``meta`` tensors under ``pricing``."""
    from repro_torch.kernels import pricing

    got = []
    with pricing.pricing(lambda *r: got.append(r)):
        fn(*args)
    return got


def test_kernel_prices_match_jax_pallas_cost():
    """Each kernel priced on ``meta`` tensors equals JAX's ``_pallas_cost``
    of its Pallas twin at the same shapes (the model layouts of the port,
    the kernel layouts of JAX): FLOPs, bytes, and the products among the
    FLOPs.  dK/dV is taken at G = 1, where both write one gradient per KV
    head (JAX's kernel writes one per query head and sums after it; the
    port sums inside, ROADMAP section 3); flash-decode at an int32 length
    (JAX's scalar operand); the gather at a width JAX does not pad."""
    from repro.kernels.decode_attention import decode_attention_kernel
    from repro.kernels.flash_attention import flash_attention_kernel
    from repro.kernels.flash_attention_bwd import flash_attention_bwd_kernel
    from repro.kernels.mamba_scan import mamba_scan_kernel
    from repro.kernels.prefetch_gather import prefetch_gather_kernel
    from repro.kernels.rglru_scan import rglru_scan_kernel
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.kernels.decode_attention import decode_attention_fwd
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.mamba_scan import mamba_scan_fwd
    from repro_torch.kernels.prefetch_gather import prefetch_gather_fwd
    from repro_torch.kernels.rglru_scan import rglru_scan_fwd

    def meta(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")

    def sds(*shape, dtype=jax.numpy.bfloat16):
        return jax.ShapeDtypeStruct(shape, dtype)

    f32, i32 = torch.float32, torch.int32
    jf32, ji32 = jax.numpy.float32, jax.numpy.int32
    B, S, H, KV, D = 2, 256, 8, 2, 64
    cases = [
        ([("flash_attention_fwd",) + r[1:] for r in _priced(
            lambda: flash_attention_fwd(meta(B, S, H, D), meta(B, S, KV, D), meta(B, S, KV, D)))],
         _pallas_costs(lambda q, k, v: flash_attention_kernel(q, k, v, causal=True,
                                                              with_lse=True),
                       sds(B * H, S, D), sds(B * KV, S, D), sds(B * KV, S, D))),
        (_priced(lambda: fb.flash_attention_bwd_dkdv(
            meta(B, S, H, D), meta(B, S, H, D), meta(B, S, H, D), meta(B, S, H, D),
            meta(B * H, S, dtype=f32), meta(B * H, S, dtype=f32)))
         + _priced(lambda: fb.flash_attention_bwd_dq(
             meta(B, S, H, D), meta(B, S, H, D), meta(B, S, H, D), meta(B, S, H, D),
             meta(B * H, S, dtype=f32), meta(B * H, S, dtype=f32))),
         _pallas_costs(lambda q, k, v, do, lse, dl: flash_attention_bwd_kernel(
             q, k, v, do, lse, dl, causal=True), *[sds(B * H, S, D)] * 4,
             sds(B * H, S, dtype=jf32), sds(B * H, S, dtype=jf32))),
        (_priced(lambda: decode_attention_fwd(meta(B, H, D), meta(B, 1024, KV, D),
                                              meta(B, 1024, KV, D), meta(1, dtype=i32))),
         _pallas_costs(lambda n, q, k, v: decode_attention_kernel(q, k, v, n),
                       sds(dtype=ji32), sds(B * H, D), sds(B * KV, 1024, D),
                       sds(B * KV, 1024, D))),
        (_priced(lambda: prefetch_gather_fwd(meta(4096, 256), meta(64, dtype=i32))),
         _pallas_costs(lambda t, i: prefetch_gather_kernel(t, i, block_d=256),
                       sds(4096, 256), sds(64, dtype=ji32))),
        (_priced(lambda: rglru_scan_fwd(meta(1, S, 4 * 128, dtype=f32),
                                        meta(1, S, 4 * 128, dtype=f32))),
         _pallas_costs(lambda a, g: rglru_scan_kernel(a, g), sds(S, 4 * 128, dtype=jf32),
                       sds(S, 4 * 128, dtype=jf32))),
        (_priced(lambda: mamba_scan_fwd(meta(1, S, 128, 16, dtype=f32),
                                        meta(1, S, 128, 16, dtype=f32),
                                        meta(1, S, 16, dtype=f32))),
         _pallas_costs(lambda a, b, c: mamba_scan_kernel(a, b, c), sds(S, 128, 16, dtype=jf32),
                       sds(S, 128, 16, dtype=jf32), sds(S, 16, dtype=jf32))),
    ]
    for got, want in cases:
        assert len(got) == len(want) >= 1, (got, want)
        for (name, flops, nbytes, dot), w in zip(got, want):
            assert (flops, nbytes, dot) == (w.flops, w.bytes, w.dot_flops), (name, w)


def test_a_meta_tensor_outside_the_cost_model_raises():
    """A kernel wrapper given ``meta`` tensors outside ``pricing`` raises:
    only the cost model prices a kernel."""
    from repro_torch.kernels.flash_attention import flash_attention_fwd

    q = torch.empty((1, 128, 2, 64), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="priced only under"):
        flash_attention_fwd(q, q, q)


def test_dp_tp_train_step_collectives_found_on_a_fake_group():
    """chatglm3's smoke config trained on a (2, 2) ("data", "model") mesh
    of a ``fake`` group (rank 0 of 4), on ``meta`` shards: the gradient
    all-reduce over ``data`` is there, one f32 call per parameter leaf and
    layer (the backward reduces each layer's gradient as it is made), its
    bytes the hand count: each leaf's local shard under its placements, in
    f32.  The other all-reduces run over ``model`` (the row-parallel
    products' partial sums, the gradient norm).  The calls counted equal
    ``CommDebugMode``'s counts."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shardings import logical_rules
    from repro_torch.models.common import activate_sharding, tree_items

    cfg = get_smoke_config("chatglm3_6b")
    shape = ShapeConfig("t", "train", 64, 4)
    with dryrun.fake_group(4):
        mesh = make_mesh((2, 2), ("data", "model"), device="cpu", backend="fake")
        rules = logical_rules(cfg, shape, mesh)
        args, step = dryrun._step(cfg, shape, mesh, rules)
        params = args[0]
        with activate_sharding(mesh, rules), CommDebugMode() as comm:
            coll = collective_cost(step, *args)
        groups = {mesh.get_group(a).group_name: a for a in ("data", "model")}
        leaves = {path: p.to_local() for path, p in tree_items(params)}
    assert all(isinstance(p, DTensor) for _, p in tree_items(params))
    calls = [(groups[g], s, dt) for op, g, s, dt in coll["calls"] if op == "all_reduce"]
    assert {g for g, _, _ in calls} == {"data", "model"}
    reduced = sorted((s, dt) for g, s, dt in calls if g == "data")
    want = sorted((tuple(t.shape[1:]) if path.startswith("layers.") else tuple(t.shape),
                   torch.float32)
                  for path, t in leaves.items()
                  for _ in range(cfg.n_layers if path.startswith("layers.") else 1))
    assert reduced == want
    hand = sum(t.numel() * 4 for t in leaves.values())
    assert sum(int(np.prod(s)) * 4 for s, _ in reduced) == hand > 0
    assert coll["bytes"]["all_reduce"] > hand
    assert coll["counts"]["all_reduce"] == len(calls)
    assert coll["counts"] == {str(op).split(".")[-1]: int(n)
                              for op, n in comm.get_comm_counts().items() if n}


@pytest.mark.parametrize("arch,layers", (("chatglm3_6b", 5), ("recurrentgemma_2b", 10),
                                         ("whisper_large_v3", 3)))
def test_layer_fit_equals_the_full_trace(arch, layers):
    """The dry-run traces two depths and extends linearly (``layer_fit``):
    on a smoke config cut to ``layers`` (the hybrid: 3 periods and one
    layer more; whisper: 3 encoder and 3 decoder layers), its train step's
    costs and kernel calls equal a trace at the full depth."""
    cfg = get_smoke_config(arch).replace(n_layers=layers, attn_impl="pallas")
    if cfg.family == "encdec":
        cfg = cfg.replace(enc_layers=layers)
    shape = ShapeConfig("t", "train", 128, 2)
    fit = dryrun.layer_fit(cfg)
    assert len(fit) > 1 and all(sum(o.values()) < 2 * layers for o, _ in fit)
    fields = ("flops", "dot_flops", "bytes")
    total = {}
    for o, w in fit:
        c_args, c_fn = dryrun._step(cfg.replace(**o), shape)
        c = step_cost(c_fn, *c_args)
        total = dryrun._add(total, {**{f: getattr(c, f) for f in fields},
                                    "kernels": c.kernels}, w)
    args, fn = dryrun._step(cfg, shape)
    full = step_cost(fn, *args)
    for f in fields:
        assert total[f] == pytest.approx(getattr(full, f), rel=1e-12), f
    assert total["kernels"] == full.kernels


def test_the_hybrid_long_cell_runs_on_the_multi_pod_mesh():
    """recurrentgemma-2b's ``long_500k`` on (2, 16, 16): batch 1, the ring
    of 2048 slots over ("pod", "data"), 64 a rank, the states over all 512
    ranks; its record is ``ok``, with the step's collectives on this rank;
    yi-34b's ``long_500k`` is skipped with JAX's reason."""
    rec = dryrun.run_cell("recurrentgemma_2b", "long_500k", "multi")
    assert rec["status"] == "ok" and rec["chips"] == 512, rec
    assert rec["collective_bytes_per_rank"] > 0 and rec["collective_counts"], rec
    assert rec["jaxpr_dot_flops"] > 0 and rec["tokens_per_step"] == 1
    skipped = dryrun.run_cell("yi_34b", "long_500k", "single")
    assert skipped["status"] == "skipped" and skipped["reason"] == dryrun.SKIP_REASON
    import torch.distributed as dist

    assert not dist.is_initialized()  # the fake group is gone


@pytest.mark.parametrize("arch", ("chatglm3_6b", "whisper_large_v3"))
def test_train_step_where_model_does_not_divide_the_heads(arch):
    """A train step on a (1, 4) mesh of a ``fake`` group whose ``model``
    axis does not divide the heads (the smoke config with 2 heads of 32,
    as yi-34b's 56, qwen1.5-4b's 20 and qwen2-vl's 12 on the production
    16): the merged heads' gradient comes back whole on heads
    (``layers.merge_heads``) and the backward splits it; whisper's
    cross-attention too.  It raised in the flatten's backward before."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shardings import logical_rules
    from repro_torch.models.common import activate_sharding

    cfg = get_smoke_config(arch).replace(n_heads=2, n_kv_heads=2, head_dim=32)
    shape = ShapeConfig("t", "train", 16, 2)
    with dryrun.fake_group(4):
        mesh = make_mesh((1, 4), ("data", "model"), device="cpu", backend="fake")
        rules = logical_rules(cfg, shape, mesh)
        assert rules["act_heads"] is None and rules["heads"] == "model"
        args, step = dryrun._step(cfg, shape, mesh, rules)
        with activate_sharding(mesh, rules):
            coll = collective_cost(step, *args)
    assert coll["counts"].get("all_gather_into_tensor", 0) > 0
