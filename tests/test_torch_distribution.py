"""The port's multi-device layer on the CPU, in gloo process groups, against
the JAX package run unsharded on the same inputs (f32):

  * the MoE mesh paths on a 2x4 mesh (twin of
    ``test_distribution.py::test_moe_ep_matches_dense``): ``moe_apply_ep``
    against JAX's ``moe_apply_dense`` over the whole batch;
    ``moe_apply_ep_a2a`` and ``moe_apply_fsdp``, which route each rank's
    tokens under its own capacity, against ``moe_apply_dense`` on each
    rank's tokens; all three against the whole batch at a capacity that
    drops nothing;
  * a sharded chatglm3 smoke ``train_step`` on a 2x4 mesh for 4 steps under
    ``tp`` and ``fsdp`` (twin of ``test_smoke_train_step_sharded_end_to_end``),
    yi's under ``sequence_parallel`` (twin of
    ``test_perf_variants.py::test_sequence_parallel_loss_matches_unsharded``)
    and qwen3-moe's under ``tp`` (the EP path inside the step): the first
    loss within 1e-5 of JAX's, the parameters after 4 steps held to JAX's;
  * ``Trainer(mesh=)`` on a 2x2 mesh: its checkpoint restores bitwise in
    JAX's ``CheckpointManager`` and in the unsharded port's, and on the mesh
    (re-sharded);
  * the prefill and greedy decode steps on a 2x4 mesh, the decode on JAX's
    decode layout (the cache's sequence over ``model``: 64-slot shards,
    which take the plain route) and with the cache split over batch and kv
    heads; ``Server(mesh=)`` itself is ``test_torch_serve_mesh.py``'s.

Each group of ranks runs once per module (``run_ranks``: a ``FileStore``
under pytest's temporary directory, a timeout on the process group and on
the whole run).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # beside the other test workers on the CPU

from repro.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.launch.steps import make_train_step as jmake_train_step  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.models.moe import moe_apply_dense as jmoe_apply_dense  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.launch.spawn import run_ranks  # noqa: E402
from repro_torch.models.common import tree_items  # noqa: E402
from test_torch_train import _close_params  # noqa: E402
import torch_mesh_ranks  # noqa: E402

MOE = ("qwen3_moe_30b_a3b", "granite_moe_1b_a400m")
TRAIN = {  # name: (arch, overrides, B, S)
    "tp": ("chatglm3_6b", dict(attn_impl="pallas"), 8, 128),
    "fsdp": ("chatglm3_6b", dict(attn_impl="pallas", parallelism="fsdp"), 8, 128),
    "sp": ("yi_34b", dict(sequence_parallel=True), 8, 16),
    "moe_tp": ("qwen3_moe_30b_a3b", dict(moe_chunk=16), 8, 16),
}
STEPS = 4
MESH = (2, 4)
SERVE = ("chatglm3_6b", "qwen3_moe_30b_a3b")  # a dense model; the MoE EP path
SERVE_LEN, SERVE_STEPS = 256, 3  # cache slots, decode steps
# the decode cache's layouts: JAX's decode layout (the sequence over
# `model`), and the decode rules without `cache_seq` (batch and kv heads)
SERVE_CASES = [(arch, layout) for arch in SERVE for layout in ("seq", "heads")]
TIMEOUT = 240.0


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _moe_inputs(arch):
    cfg = jget_smoke(arch).replace(moe_chunk=16)
    params = JModel(cfg).init_params(jax.random.PRNGKey(0))
    layer = _np(jax.tree.map(lambda a: a[0], params["layers"]["mlp"]))
    x = (0.1 * np.random.RandomState(1).randn(8, 8, cfg.d_model)).astype(np.float32)
    return cfg, layer, x


def _train_inputs(name):
    arch, overrides, B, S = TRAIN[name]
    cfg = jget_smoke(arch).replace(compute_dtype="float32", **overrides)
    params = _np(JModel(cfg).init_params(jax.random.PRNGKey(0)))
    rng = np.random.RandomState(0)
    batch = {k: rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
             for k in ("inputs", "targets")}
    return cfg, params, batch


def _serve_inputs(arch):
    cfg = jget_smoke(arch).replace(compute_dtype="float32", attn_impl="pallas")
    params = _np(JModel(cfg).init_params(jax.random.PRNGKey(0)))
    prompt = np.random.RandomState(2).randint(0, cfg.vocab_size, (8, 128)).astype(np.int32)
    return cfg, params, prompt


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One 8-rank run: the MoE paths of both configs, then the four
    trainings."""
    cases = []
    for arch in MOE:
        _, layer, x = _moe_inputs(arch)
        for cf in (None, "no_drop"):
            cfg = jget_smoke(arch)
            over = dict(moe_chunk=16)
            if cf:
                over["capacity_factor"] = cfg.n_experts / cfg.experts_per_token
            cases.append(("moe", arch, over, MESH, layer, x))
    for name, (arch, overrides, _, _) in TRAIN.items():
        _, params, batch = _train_inputs(name)
        cases.append(("train", arch, dict(compute_dtype="float32", **overrides), MESH,
                      params, batch, STEPS))
    _, params, batch = _train_inputs("moe_tp")
    cases.append(("remat_a2a", "qwen3_moe_30b_a3b", MESH, params, batch))
    _, params, batch = _train_inputs("sp")
    cases.append(("backward_on_a_thread", "chatglm3_6b", MESH,
                  _np(JModel(jget_smoke("chatglm3_6b")).init_params(jax.random.PRNGKey(0))),
                  batch))
    for arch, layout in SERVE_CASES:
        cfg, params, prompt = _serve_inputs(arch)
        cases.append(("serve", arch, MESH, params, prompt, SERVE_LEN, SERVE_STEPS, layout))
    out = run_ranks(torch_mesh_ranks.suite, 8, cases, timeout=TIMEOUT,
                    store_dir=tmp_path_factory.mktemp("store"))[0]
    moe = {(arch, cf): out[2 * i + j] for i, arch in enumerate(MOE)
           for j, cf in enumerate((None, "no_drop"))}
    n = 2 * len(MOE) + len(TRAIN)
    return (moe, dict(zip(TRAIN, out[2 * len(MOE):n])), out[n], out[n + 1],
            dict(zip(SERVE_CASES, out[n + 2:])))


@pytest.mark.parametrize("arch", MOE)
def test_moe_ep_matches_dense(ranks, arch):
    cfg, layer, x = _moe_inputs(arch)
    dense = np.asarray(jmoe_apply_dense(jnp.asarray(x), layer, cfg, jnp.float32))
    np.testing.assert_allclose(ranks[0][(arch, None)]["ep"], dense, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("path", ["ep_a2a", "fsdp"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_rank_local_paths_match_dense_per_rank(ranks, arch, path):
    """a2a and fsdp route each rank's tokens (the batch split over every
    axis: one row a rank) under a capacity from its own token count: the
    dense path over each rank's tokens."""
    cfg, layer, x = _moe_inputs(arch)
    want = np.concatenate([np.asarray(jmoe_apply_dense(jnp.asarray(x[r:r + 1]), layer, cfg,
                                                       jnp.float32)) for r in range(8)])
    np.testing.assert_allclose(ranks[0][(arch, None)][path], want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("arch", MOE)
def test_moe_paths_match_dense_without_drops(ranks, arch):
    cfg, layer, x = _moe_inputs(arch)
    cfg = cfg.replace(capacity_factor=cfg.n_experts / cfg.experts_per_token)
    dense = np.asarray(jmoe_apply_dense(jnp.asarray(x), layer, cfg, jnp.float32))
    for path, got in ranks[0][(arch, "no_drop")].items():
        np.testing.assert_allclose(got, dense, rtol=2e-5, atol=2e-5, err_msg=path)


def _jax_steps(cfg, params, batch, steps):
    model, opt, step = jmake_train_step(cfg)
    p = jax.tree.map(jnp.asarray, params)
    o = opt.init(p)
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    jstep = jax.jit(step)
    losses, lrs = [], []
    for _ in range(steps):
        p, o, m = jstep(p, o, b)
        losses.append(float(m["loss"]))
        lrs.append(float(m["lr"]))
    return losses, lrs, p, o


@pytest.mark.parametrize("name", list(TRAIN))
def test_sharded_train_steps_match_jax(ranks, name):
    cfg, params, batch = _train_inputs(name)
    losses, full = ranks[1][name]
    want, lrs, jparams, jopt = _jax_steps(cfg, params, batch, STEPS)
    assert abs(losses[0] - want[0]) < 1e-5, (losses, want)
    np.testing.assert_allclose(losses, want, rtol=1e-5)
    got = {p: torch.from_numpy(a) for p, a in tree_items(full)}
    nested: dict = {}
    for path, t in got.items():
        node = nested
        *parents, leaf = path.split(".")
        for q in parents:
            node = node.setdefault(q, {})
        node[leaf] = t
    # an element whose gradient is within the tolerance of zero may step the
    # other way each step: up to 2 lr a step
    _close_params(nested, _np(jparams), _np(jopt["mu"]), sum(lrs), 1e-4)


@pytest.fixture(scope="module")
def trainer_run(tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("mesh_ckpt")
    out = run_ranks(torch_mesh_ranks.trainer_checkpoint, 4, "chatglm3_6b",
                    dict(compute_dtype="float32"), (2, 2), str(ckpt), 3,
                    timeout=TIMEOUT, store_dir=tmp_path_factory.mktemp("store"))[0]
    return ckpt, out


def test_trainer_mesh_checkpoint_restores_bitwise(trainer_run):
    """The checkpoint at step 2 holds the state after the last of 3 steps:
    JAX's ``CheckpointManager`` and the unsharded port's read it bitwise,
    and a Trainer on the mesh restores it re-sharded."""
    ckpt, (losses, after, start, restored, placed, *_) = trainer_run
    assert len(losses) == 3 and start == 2 and placed
    step, jstate = JCheckpointManager(ckpt).restore()
    pstep, pstate = CheckpointManager(ckpt).restore()
    assert step == pstep == 2
    for path, a in tree_items(after):
        key = f"params.{path}"
        np.testing.assert_array_equal(np.asarray(jstate[key]), a, err_msg=path)
        np.testing.assert_array_equal(pstate[key], a, err_msg=path)
    for path, a in tree_items(restored):
        np.testing.assert_array_equal(np.asarray(jstate[path]), a, err_msg=path)


def test_routed_all_gather_gives_the_same_loss(trainer_run):
    """``route_all_gather`` (which ``make_mesh`` installs for gloo on CUDA)
    sends DTensor's gathers through c10d's all-gather: the same loss.  It
    holds for the process, and takes only gloo groups: a group of another
    backend keeps the functional op's asynchronous path (one work left for
    ``wait_tensor``)."""
    _, (*_, routed, _) = trainer_run
    assert routed[0] == routed[1]
    world = 4
    assert routed[2] == {"gloo": (0, [float(r) for r in range(world) for _ in range(2)]),
                         "fake": (1, (2 * world, 3))}


def test_train_cli_on_a_mesh(trainer_run):
    """``python -m repro_torch.launch.train --mesh 2x2`` (each rank; under
    ``torchrun`` the process group comes from its environment)."""
    printed = trainer_run[1][-1]
    assert "over 2 steps) on cpu, mesh 2x2" in printed, printed


def test_save_collectives_keeps_the_a2a_exchanges(ranks):
    """Under ``ep_a2a``, ``remat="save_collectives"`` gives ``"full"``'s loss
    and gradients without exchanging the tokens again in the recomputation:
    ``full`` runs the layer's 2 all-to-alls a second time, per layer."""
    runs = ranks[2]
    (floss, fgrads, fcalls), (sloss, sgrads, scalls) = runs["full"], runs["save_collectives"]
    n_layers = jget_smoke("qwen3_moe_30b_a3b").n_layers
    assert scalls >= 4 * n_layers and fcalls - scalls == 2 * n_layers, (fcalls, scalls)
    assert sloss == floss
    for (path, a), (_, b) in zip(tree_items(sgrads), tree_items(fgrads)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9, err_msg=path)


def test_backward_on_another_thread_sees_the_mesh(ranks):
    """The CUDA backward runs on the autograd engine's thread and recomputes
    each remat'd layer there: it must see the mesh (the attention's
    ``shard_map``), giving this thread's gradients."""
    diff, loss = ranks[3]
    assert diff == 0.0 and np.isfinite(loss)


def _jax_serve(cfg, params, prompt):
    """JAX's unsharded prefill, then greedy decode steps on a cache padded
    to SERVE_LEN slots: (prefill logits, [step logits], [tokens])."""
    model = JModel(cfg)
    logits, cache = jax.jit(model.prefill)(params, {"inputs": jnp.asarray(prompt)})
    first, steps, toks = np.asarray(logits), [], []
    S = prompt.shape[1]
    cache = jax.tree.map(
        lambda c: jnp.pad(c, [(0, 0), (0, 0), (0, SERVE_LEN - S), (0, 0), (0, 0)]), cache)
    tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
    step = jax.jit(model.decode_step)
    for i in range(SERVE_STEPS):
        logits, cache = step(params, cache, tok, S + i)
        tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        steps.append(np.asarray(logits))
        toks.append(np.asarray(tok))
    return first, steps, toks


@pytest.mark.parametrize("arch,layout", SERVE_CASES)
def test_prefill_and_decode_steps_on_a_mesh_match_jax(ranks, arch, layout):
    """``make_prefill_step(mesh=)`` (the flash forward on local heads) and
    greedy ``make_decode_step(mesh=)`` steps against JAX's unsharded
    ``prefill`` and ``decode_step`` on each data shard's rows (the MoE EP
    path routes a data shard's tokens under their own capacity, as JAX's
    does), f32.  "seq": the sequence-sharded cache (four 64-slot shards:
    the plain route, each rank's partial (o, lse) merged over ``model``;
    the cache written in place by the rank that holds the position, the
    prompt's 128 filling two shards and the decode the third).  "heads":
    the cache split over batch and kv heads, its sequence whole (256 slots:
    flash-decode's route), written in place on each rank."""
    cfg, params, prompt = _serve_inputs(arch)
    first, steps, toks = ranks[4][arch, layout]
    p = jax.tree.map(jnp.asarray, params)
    half = prompt.shape[0] // MESH[0]
    shards = [_jax_serve(cfg, p, prompt[r * half:(r + 1) * half]) for r in range(MESH[0])]
    want = (np.concatenate([s[0] for s in shards]),
            [np.concatenate([s[1][i] for s in shards]) for i in range(SERVE_STEPS)],
            [np.concatenate([s[2][i] for s in shards]) for i in range(SERVE_STEPS)])
    np.testing.assert_allclose(first, want[0], rtol=1e-5, atol=1e-5)
    for i in range(SERVE_STEPS):
        np.testing.assert_allclose(steps[i], want[1][i], rtol=1e-5, atol=1e-5, err_msg=str(i))
        np.testing.assert_array_equal(toks[i], want[2][i])


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    _, params, batch = _train_inputs("tp")
    return run_ranks(torch_mesh_ranks.one_rank, 1, "chatglm3_6b", dict(attn_impl="pallas"),
                     params, batch, ("float32", "bfloat16"), timeout=TIMEOUT,
                     store_dir=tmp_path_factory.mktemp("store"))[0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_rank_mesh_step_is_the_unsharded_step_bitwise(one_rank, dtype):
    """On a 1x1 mesh the step runs the unsharded step's operations on the
    same tensors: the loss and every gradient leaf bitwise, the
    vocab-parallel loss's gradient being ``logsumexp``'s (the card's
    ``[mesh]`` phase holds chatglm3-6b at full width to the same)."""
    (loss, grads), (mloss, mgrads) = one_rank[dtype]
    assert mloss == loss
    for (path, a), (_, b) in zip(tree_items(mgrads), tree_items(grads)):
        np.testing.assert_array_equal(a, b, err_msg=path)
