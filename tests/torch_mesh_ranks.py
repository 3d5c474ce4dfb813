"""Rank functions of the port's multi-rank tests (``test_torch_*``), run by
``repro_torch.launch.spawn.run_ranks`` in processes of their own.  They
import torch and the port only: the JAX references are computed by the
tests, in the parent process."""

from __future__ import annotations

import numpy as np
import torch


def _full(t) -> np.ndarray:
    from torch.distributed.tensor import DTensor

    t = t.full_tensor() if isinstance(t, DTensor) else t
    return t.detach().float().numpy()


def train(rank, world, arch, overrides, mesh_shape, params_np, batch_np, steps):
    """``steps`` sharded train steps of a smoke config on a ("data",
    "model") mesh: (losses, the full parameters after them on rank 0)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.convert import from_numpy_tree
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shardings import batch_pspecs, logical_rules, named
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.common import activate_sharding, tree_map

    cfg = get_smoke_config(arch).replace(**overrides)
    mesh = make_mesh(mesh_shape, ("data", "model"), device="cpu", backend="gloo")
    B, S = batch_np["inputs"].shape
    shape = ShapeConfig("t", "train", S, B)
    model, opt, step = make_train_step(cfg, device="cpu", mesh=mesh)
    rules = logical_rules(cfg, shape, mesh)
    params = named(mesh, model.param_pspecs(rules), from_numpy_tree(params_np, device="cpu"))
    opt_state = opt.init(params)
    batch = {k: torch.from_numpy(v).long() for k, v in batch_np.items()}
    batch = named(mesh, batch_pspecs(cfg, shape, mesh), batch)
    losses = []
    with activate_sharding(mesh, rules):
        for _ in range(steps):
            params, opt_state, metrics = step(params, opt_state, batch)
            losses.append(float(_full(metrics["loss"])))
    full = tree_map(_full, params)
    return losses, (full if rank == 0 else None)


def moe(rank, world, arch, overrides, mesh_shape, layer_np, x_np):
    """One MoE layer under a ("data", "model") mesh through the three mesh
    paths: {"ep", "ep_a2a", "fsdp"} -> the full output, on rank 0."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import from_numpy_tree
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shardings import PSpec, named
    from repro_torch.models.moe import moe_apply_ep, moe_apply_ep_a2a, moe_apply_fsdp

    cfg = get_smoke_config(arch).replace(**overrides)
    mesh = make_mesh(mesh_shape, ("data", "model"), device="cpu", backend="gloo")
    lp = from_numpy_tree(layer_np, device="cpu")
    bank = PSpec("model", None, None)
    specs = {"router": PSpec(None, None), "we_gate": bank, "we_up": bank, "we_down": bank}
    lp = named(mesh, specs, lp)
    x = torch.from_numpy(x_np)
    every = ("data", "model")
    out = {
        "ep": moe_apply_ep(named(mesh, PSpec("data", None, None), x), lp, cfg, torch.float32,
                           mesh, "data", "model"),
        "ep_a2a": moe_apply_ep_a2a(named(mesh, PSpec(every, None, None), x), lp, cfg,
                                   torch.float32, mesh, every, "model"),
        "fsdp": moe_apply_fsdp(named(mesh, PSpec(every, None, None), x), lp, cfg,
                               torch.float32, mesh, every),
    }
    out = {k: _full(v) for k, v in out.items()}
    return out if rank == 0 else None


def remat_a2a(rank, world, arch, mesh_shape, params_np, batch_np):
    """One ``loss_and_grads`` of a smoke MoE config under ``ep_a2a`` with
    ``remat="full"`` and ``"save_collectives"``: {remat: (loss, the full
    gradients, the all-to-all exchanges run)} on rank 0."""
    import torch.distributed as dist
    import torch.distributed.distributed_c10d as c10d

    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.convert import from_numpy_tree
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shardings import batch_pspecs, logical_rules, named
    from repro_torch.launch.steps import loss_and_grads, mesh_info_for
    from repro_torch.models.common import activate_sharding, tree_map
    from repro_torch.models.model import Model

    mesh = make_mesh(mesh_shape, ("data", "model"), device="cpu", backend="gloo")
    calls = []

    def all_to_all_single(input, output_split_sizes, input_split_sizes, group_name):
        """The exchange itself (forward and backward both call it), counted."""
        calls.append(1)
        out = input.new_empty((sum(output_split_sizes), *input.shape[1:]))
        dist.all_to_all_single(out, input.contiguous(), output_split_sizes, input_split_sizes,
                               group=c10d._resolve_process_group(group_name))
        return out

    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_to_all_single", all_to_all_single, "CPU")
    out = {}
    try:
        for remat in ("full", "save_collectives"):
            cfg = get_smoke_config(arch).replace(compute_dtype="float32", parallelism="ep_a2a",
                                                 remat=remat, moe_chunk=16)
            B, S = batch_np["inputs"].shape
            shape = ShapeConfig("t", "train", S, B)
            model = Model(cfg, device="cpu")
            rules = logical_rules(cfg, shape, mesh)
            params = named(mesh, model.param_pspecs(rules),
                           from_numpy_tree(params_np, device="cpu"))
            batch = named(mesh, batch_pspecs(cfg, shape, mesh),
                          {k: torch.from_numpy(v).long() for k, v in batch_np.items()})
            calls.clear()
            with activate_sharding(mesh, rules):
                loss, grads = loss_and_grads(model, params, batch, mesh_info_for(cfg, mesh))
            out[remat] = (float(_full(loss)), tree_map(_full, grads), len(calls))
    finally:
        lib._destroy()
    return out if rank == 0 else None


def one_rank(rank, world, arch, overrides, params_np, batch_np, dtypes):
    """``loss_and_grads`` of a smoke config unsharded and on a 1x1 ("data",
    "model") mesh, on the same parameters and batch, in each compute dtype
    of ``dtypes``: {dtype: ((loss, gradients) unsharded, the same on the
    mesh)}."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.convert import from_numpy_tree
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shardings import batch_pspecs, logical_rules, named
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models.common import activate_sharding, tree_map
    from repro_torch.models.model import Model

    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    batch = {k: torch.from_numpy(v).long() for k, v in batch_np.items()}
    B, S = batch["inputs"].shape
    out = {}
    for dtype in dtypes:
        cfg = get_smoke_config(arch).replace(compute_dtype=dtype, **overrides)
        model = Model(cfg, device="cpu")
        params = from_numpy_tree(params_np, device="cpu")
        loss, grads = loss_and_grads(model, params, batch)
        rules = logical_rules(cfg, ShapeConfig("t", "train", S, B), mesh)
        with activate_sharding(mesh, rules):
            mloss, mgrads = loss_and_grads(
                model, named(mesh, model.param_pspecs(rules), params),
                named(mesh, batch_pspecs(cfg, ShapeConfig("t", "train", S, B), mesh), batch))
        out[dtype] = ((float(_full(loss)), tree_map(_full, grads)),
                      (float(_full(mloss)), tree_map(_full, mgrads)))
    return out


def backward_on_a_thread(rank, world, arch, mesh_shape, params_np, batch_np):
    """The loss's backward (``remat="full"``: it recomputes each layer)
    run on another thread, as the autograd engine runs a CUDA backward,
    against the same backward on this one: (max abs difference over the
    gradients, the loss) on rank 0."""
    import threading

    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.convert import from_numpy_tree
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shardings import batch_pspecs, logical_rules, named
    from repro_torch.models.common import activate_sharding, tree_items
    from repro_torch.models.model import Model

    cfg = get_smoke_config(arch).replace(compute_dtype="float32", attn_impl="pallas",
                                         remat="full")
    mesh = make_mesh(mesh_shape, ("data", "model"), device="cpu", backend="gloo")
    B, S = batch_np["inputs"].shape
    shape = ShapeConfig("t", "train", S, B)
    model = Model(cfg, device="cpu")
    rules = logical_rules(cfg, shape, mesh)
    batch = named(mesh, batch_pspecs(cfg, shape, mesh),
                  {k: torch.from_numpy(v).long() for k, v in batch_np.items()})
    grads = []
    for threaded in (False, True):
        params = named(mesh, model.param_pspecs(rules), from_numpy_tree(params_np, device="cpu"))
        for _, p in tree_items(params):
            p.requires_grad_()
        with activate_sharding(mesh, rules):
            loss = model.loss_fn(params, batch)
            if threaded:
                errors = []

                def backward():
                    try:
                        loss.backward()
                    except Exception as e:  # noqa: BLE001 -- re-raised below
                        errors.append(e)

                t = threading.Thread(target=backward)
                t.start()
                t.join(timeout=120)
                assert not t.is_alive()
                if errors:
                    raise errors[0]
            else:
                loss.backward()
        grads.append([_full(p.grad) for _, p in tree_items(params)])
    diff = max(float(np.abs(a - b).max()) for a, b in zip(*grads))
    loss = float(_full(loss))  # a collective: on every rank
    return (diff, loss) if rank == 0 else None


def suite(rank, world, cases):
    """Several cases in one process group (one spawn): each ``(name,
    *args)`` runs ``name(rank, world, *args)``; the list of results."""
    fns = {"train": train, "moe": moe, "remat_a2a": remat_a2a,
           "backward_on_a_thread": backward_on_a_thread, "serve": serve, "server": server,
           "serve_cli": serve_cli, "decode_layout": decode_layout, "long_slots": long_slots}
    return [fns[name](rank, world, *args) for name, *args in cases]


def trainer_checkpoint(rank, world, arch, overrides, mesh_shape, ckpt_dir, steps):
    """``Trainer(mesh=)`` trains ``steps`` steps, saving a checkpoint at
    every second one; a second Trainer on the mesh restores the latest and
    re-shards it.  Rank 0 returns (losses, the full parameters after the
    run, the full restored parameters and step count)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import Trainer
    from repro_torch.models.common import tree_items, tree_map

    cfg = get_smoke_config(arch).replace(**overrides)
    mesh = make_mesh(mesh_shape, ("data", "model"), device="cpu", backend="gloo")
    kw = dict(mesh=mesh, global_batch=4, seq_len=16, ckpt_dir=ckpt_dir, total_steps=steps)
    trainer = Trainer(cfg, **kw)
    params, opt_state, losses = trainer.train(steps, save_every=2)
    after = tree_map(_full, params)
    again = Trainer(cfg, **kw)
    start, restored, ropt = again.maybe_restore(*again.init_state())
    placed = all(a.placements == b.placements
                 for (_, a), (_, b) in zip(tree_items(restored), tree_items(params)))
    # the loss of the restored parameters, then again with the functional
    # all-gather sent through c10d's (as ``make_mesh`` does for gloo on CUDA)
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import route_all_gather
    from repro_torch.launch.shardings import batch_pspecs, named
    from repro_torch.models.common import activate_sharding

    gen = np.random.RandomState(1)
    batch = {k: torch.from_numpy(gen.randint(0, cfg.vocab_size, (4, 16))) for k in
             ("inputs", "targets")}
    batch = named(mesh, batch_pspecs(cfg, ShapeConfig("t", "train", 16, 4), mesh), batch)
    routed = []
    for step in range(2):
        if step:
            route_all_gather("CPU")
        with activate_sharding(mesh, again.rules):
            routed.append(float(_full(again.model.loss_fn(restored, batch))))
    routed.append(_routed_branches(world))
    restored = tree_map(_full, {"params": restored, "opt": ropt})
    # the CLI on the same process group
    import contextlib
    import io

    from repro_torch.launch.train import main

    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        main(["--arch", arch, "--smoke", "--device", "cpu", "--mesh",
              "x".join(map(str, mesh_shape)), "--steps", "2", "--batch", "4", "--seq", "16"])
    return (losses, after, start, restored, placed, routed, printed.getvalue()) \
        if rank == 0 else None


def _routed_branches(world):
    """The functional all-gather once ``route_all_gather`` holds, on the
    gloo group and on a group of another backend (PyTorch's ``fake`` test
    backend): {backend: (works left registered for ``wait_tensor``, the
    gathered rows' first column)}.  The gloo gather is synchronous and
    registers none; another backend keeps the functional op's own
    asynchronous path, whose work ``wait_tensor`` waits on."""
    import torch.distributed as dist
    from torch._C._distributed_c10d import _get_work_registry_size
    from torch.testing._internal.distributed.fake_pg import FakeStore  # noqa: F401 -- "fake"

    x = torch.full((2, 3), float(dist.get_rank()))
    out = {}
    for name, group in (("gloo", dist.group.WORLD), ("fake", dist.new_group(backend="fake"))):
        before = _get_work_registry_size()
        y = torch.ops._c10d_functional.all_gather_into_tensor(x, world, group.group_name)
        works = _get_work_registry_size() - before
        y = torch.ops._c10d_functional.wait_tensor(y)
        out[name] = (works, y[:, 0].tolist() if name == "gloo" else tuple(y.shape))
    return out


def pipeline_and_compression(rank, world, ws, xs, grads, residuals):
    """``gpipe`` over a ("stage",) mesh of every rank (the stage function
    ``x -> tanh(x @ w)`` per layer), then the compressed all-reduce over a
    ("pod",) mesh of every rank, each rank with its own gradients: rank 0
    returns (pipeline outputs, [(mean, residuals) of each rank], the mean
    of gradients of 0.5 on every rank)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.pipeline import gpipe
    from repro_torch.launch.shardings import PSpec, named
    from repro_torch.models.common import tree_map
    from repro_torch.optim.grad_compress import make_compressed_allreduce

    import torch.distributed as dist

    def stage_fn(sp, x):
        for i in range(sp.shape[0]):
            x = torch.tanh(x @ sp[i])
        return x

    mesh = make_mesh((world,), ("stage",), device="cpu", backend="gloo")
    run = gpipe(stage_fn, mesh)
    out = _full(run(named(mesh, PSpec("stage"), torch.from_numpy(ws)), torch.from_numpy(xs)))

    pods = make_mesh((world,), ("pod",), device="cpu", backend="gloo")
    fn = make_compressed_allreduce(pods, axis="pod")
    mean, res = fn(tree_map(torch.from_numpy, grads[rank]),
                   tree_map(torch.from_numpy, residuals[rank]))
    mine = (tree_map(lambda t: t.numpy(), mean), tree_map(lambda t: t.numpy(), res))
    every = [None] * world
    dist.all_gather_object(every, mine)
    half, _ = fn({"w": torch.full((8, 8), 0.5)}, {"w": torch.zeros(8, 8)})
    return (out, every, half["w"].numpy()) if rank == 0 else None


def serve(rank, world, arch, mesh_shape, params_np, prompt_np, max_len, steps, layout):
    """``make_prefill_step(mesh=)`` on a prompt, then ``steps`` greedy
    ``make_decode_step(mesh=)`` steps on the cache in ``layout``: "seq",
    the decode layout (``cache_pspecs``: the sequence split over ``model``,
    the kv heads whole; ``serve.to_decode_layout``), or "heads", the
    decode rules without ``cache_seq`` (the cache split over batch and kv
    heads, its sequence whole, padded on the host): (prefill logits,
    [decode logits], [tokens]) on rank 0."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.convert import from_numpy_tree
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import to_decode_layout
    from repro_torch.launch.shardings import PSpec, cache_pspecs, logical_rules, named, placements
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.common import activate_sharding, logical_to_pspec

    cfg = get_smoke_config(arch).replace(compute_dtype="float32", attn_impl="pallas")
    mesh = make_mesh(mesh_shape, ("data", "model"), device="cpu", backend="gloo")
    B, S = prompt_np.shape
    model, prefill = make_prefill_step(cfg, device="cpu", mesh=mesh)
    _, decode = make_decode_step(cfg, device="cpu", mesh=mesh)
    rules = logical_rules(cfg, ShapeConfig("p", "prefill", S, B), mesh)
    dshape = ShapeConfig("d", "decode", max_len, B)
    drules = logical_rules(cfg, dshape, mesh)
    if layout == "heads":
        drules["cache_seq"] = None
    params = from_numpy_tree(params_np, device="cpu")
    batch = named(mesh, {"inputs": PSpec(rules["batch"], None)},
                  {"inputs": torch.from_numpy(prompt_np).long()})
    with activate_sharding(mesh, rules):
        logits, cache = prefill(named(mesh, model.param_pspecs(rules), params), batch)
    first = _full(logits)
    if layout == "seq":
        specs = cache_pspecs(cfg, dshape, mesh)
        padded = to_decode_layout(cache, mesh, specs, model.abstract_cache(B, max_len))
    else:
        kv_spec = logical_to_pspec((None, "batch", None, "act_kv", None), drules)
        specs, padded = {}, {}
        for key, c in cache.items():
            buf = torch.zeros((c.shape[0], B, max_len) + tuple(c.shape[3:]), dtype=c.dtype)
            buf[:, :, :S] = torch.from_numpy(_full(c)).to(c.dtype)
            specs[key] = kv_spec
            padded[key] = named(mesh, kv_spec, buf)
    dparams = named(mesh, model.param_pspecs(drules), params)
    tok = torch.from_numpy(first[:, -1].argmax(-1)[:, None]).long()
    out, toks = [], []
    for i in range(steps):
        tokens = named(mesh, PSpec(drules["batch"], None), tok)
        with activate_sharding(mesh, drules):
            logits, padded = decode(dparams, padded, tokens, S + i)
        step = _full(logits)
        out.append(step)
        tok = torch.from_numpy(step[:, -1].argmax(-1)[:, None]).long()
        toks.append(tok.numpy())
    assert all(c.placements == placements(mesh, specs[k]) for k, c in padded.items())
    return (first, out, toks) if rank == 0 else None


def _batch(batch_np: dict) -> dict:
    """A prompt batch of numpy arrays as tensors: token ids int64, the rest
    (encdec's audio ``frames``) as they are."""
    return {k: torch.from_numpy(v).long() if k == "inputs" else torch.from_numpy(v)
            for k, v in batch_np.items()}


def _axes(mesh_shape) -> tuple:
    """("data", "model"), or for a 3-dim shape ("pod", "data", "model")."""
    return ("pod", "data", "model")[-len(mesh_shape):]


def server(rank, world, arch, mesh_shape, params_np, batch_np, max_len, steps, dtype):
    """``Server(mesh=)`` on a ("data", "model") mesh, or ("pod", "data",
    "model") for a 3-dim ``mesh_shape``: ``generate`` (on the CPU, the
    eager loop) from whole parameters on the prompt batch ``batch_np``
    (numpy arrays), ``steps`` tokens: (tokens, logits) whole, on rank 0."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import from_numpy_tree
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import Server

    cfg = get_smoke_config(arch).replace(compute_dtype=dtype, attn_impl="pallas")
    mesh = make_mesh(mesh_shape, _axes(mesh_shape), device="cpu", backend="gloo")
    srv = Server(cfg, device="cpu", max_len=max_len, mesh=mesh)
    params = srv.model.compute_params(from_numpy_tree(params_np, device="cpu"))
    tokens, logits = srv.generate(params, _batch(batch_np), steps, with_logits=True)
    tokens, logits = _full(tokens), _full(logits)  # collectives: every rank takes part
    return (tokens, logits) if rank == 0 else None


def decode_layout(rank, world, arch, mesh_shape, params_np, batch_np, max_len):
    """``serve.to_decode_layout`` on the mesh's own prefill cache: for each
    key, whether this rank's shard equals, slot for slot, its part of the
    whole prefill cache (the k/v padded to the decode's slots with zeros),
    in ``cache_pspecs``' placements and the decode cache's shape; whether a
    ring of a slot count the ``model`` axis does not divide raises
    ``ValueError``; and whether an int position outside the cache's slots
    raises ``IndexError``: {key: bool, "odd_ring": bool, "outside": bool},
    from every rank."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.convert import from_numpy_tree
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import Server, to_decode_layout
    from repro_torch.launch.shardings import PSpec, batch_pspecs, cache_pspecs, named, placements
    from repro_torch.models.common import activate_sharding

    cfg = get_smoke_config(arch).replace(compute_dtype="float32", attn_impl="pallas")
    mesh = make_mesh(mesh_shape, _axes(mesh_shape), device="cpu", backend="gloo")
    srv = Server(cfg, device="cpu", max_len=max_len, mesh=mesh)
    params = srv.place(srv.model.compute_params(from_numpy_tree(params_np, device="cpu")))
    batch = _batch(batch_np)
    B, S = batch["inputs"].shape
    prules = srv._rules("prefill", B, S)
    bspecs = batch_pspecs(cfg, ShapeConfig("p", "prefill", S, B), mesh)
    with torch.no_grad(), activate_sharding(mesh, prules):
        _, cache = srv.prefill_fn(params, named(mesh, bspecs, batch))
        dshape = ShapeConfig("d", "decode", max_len, B)
        specs = cache_pspecs(cfg, dshape, mesh)
        like = srv.model.abstract_cache(B, max_len)
        out = to_decode_layout(cache, mesh, specs, like)
        got = {}
        for key, c in cache.items():
            whole = c.full_tensor()
            pad = like[key].shape[2] - whole.shape[2]
            if pad > 0:
                whole = torch.cat([whole, whole.new_zeros(whole.shape[:2] + (pad,)
                                                          + whole.shape[3:])], dim=2)
            want = distribute_tensor(whole, mesh, placements(mesh, specs[key]),
                                     src_data_rank=None).to_local()
            got[key] = (out[key].placements == placements(mesh, specs[key])
                        and tuple(out[key].shape) == tuple(like[key].shape)
                        and torch.equal(out[key].to_local(), want))
        got["odd_ring"] = got["outside"] = None
        if cfg.family == "hybrid":  # a ring of min(window, 7) = 7 slots over 2 ranks
            try:
                to_decode_layout(cache, mesh, specs, srv.model.abstract_cache(B, 7))
                got["odd_ring"] = False
            except ValueError as err:
                got["odd_ring"] = "7 slots" in str(err) and "2 ranks" in str(err)
        if "k" in cache and cfg.family != "hybrid":
            tok = named(mesh, PSpec(prules["batch"], None), torch.zeros((B, 1), dtype=torch.long))
            try:
                with activate_sharding(mesh, srv._rules("decode", B, max_len)):
                    srv.decode_fn(params, out, tok, max_len)
                got["outside"] = False
            except IndexError:
                got["outside"] = True
    return got


def long_slots(rank, world, arch, mesh_shape, params_np, batch_np, max_len):
    """The batch-1 ``long`` layout's k cache after ``Server(mesh=)``'s
    prefill (``to_decode_layout``): (this rank's mesh coordinate, its shard
    [L, 1, n, KV, hd], the k cache of an unsharded ``Server``'s prefill on
    the same parameters and batch), from every rank."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import from_numpy_tree
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import Server

    cfg = get_smoke_config(arch).replace(compute_dtype="float32", attn_impl="pallas")
    mesh = make_mesh(mesh_shape, _axes(mesh_shape), device="cpu", backend="gloo")
    srv = Server(cfg, device="cpu", max_len=max_len, mesh=mesh)
    params = srv.model.compute_params(from_numpy_tree(params_np, device="cpu"))
    plain = Server(cfg, device="cpu", max_len=max_len)
    with torch.no_grad():
        _, _, cache, _ = srv._prefill(params, _batch(batch_np))
        _, _, whole, _ = plain._prefill(params, _batch(batch_np))
    return (tuple(mesh.get_coordinate()), cache["k"].to_local().numpy(), whole["k"].numpy())


def serve_cli(rank, world, argv):
    """``python -m repro_torch.launch.serve`` with ``argv`` on every rank:
    what rank 0 prints."""
    import contextlib
    import io

    from repro_torch.launch.serve import main

    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        main(argv)
    return printed.getvalue() if rank == 0 else None


def server_one_rank(rank, world, cases, max_len, steps):
    """``Server(mesh=)`` on a 1x1 mesh and the unsharded ``Server`` on the
    same parameters and prompt batch, for each (arch, compute dtype, params,
    prompt batch) of ``cases``: {(arch, dtype): ((tokens, logits) on the
    mesh, (tokens, logits) unsharded)}, logits as raw bits, and
    "dtensor_refused" (``_refuses_a_dtensor``)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import from_numpy_tree
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import Server

    mesh = make_mesh((1, 1), ("data", "model"), device="cpu", backend="gloo")
    out = {"dtensor_refused": _refuses_a_dtensor(mesh)}
    for arch, dtype, params_np, batch_np in cases:
        prompt = _batch(batch_np)
        cfg = get_smoke_config(arch).replace(compute_dtype=dtype, attn_impl="pallas")
        runs = []
        for m in (mesh, None):
            srv = Server(cfg, device="cpu", max_len=max_len, mesh=m)
            params = srv.model.compute_params(from_numpy_tree(params_np, device="cpu"))
            tokens, logits = srv.generate(params, prompt, steps, with_logits=True)
            if m is not None:
                tokens, logits = tokens.full_tensor(), logits.full_tensor()
            runs.append((tokens.numpy(), logits.view(torch.int32).numpy()))
        out[arch, dtype] = tuple(runs)
    return out


def _refuses_a_dtensor(mesh) -> bool:
    """Whether the kernel wrappers' guard (``ops._local``, which each
    wrapper applies to its tensors on the card) raises ``TypeError`` on a
    DTensor and hands a plain tensor (and None) back as it is."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.kernels import ops

    t = torch.ones(4, 4)
    kept, none = ops._local(t, None)
    if kept is not t or none is not None:
        return False
    try:
        ops._local(t, distribute_tensor(t, mesh, [Replicate(), Replicate()]))
    except TypeError as err:
        return "DTensor reached a kernel wrapper" in str(err)
    return False
