"""The port's training path on the CPU against the JAX package: one
``make_train_step`` step (loss, gradient norm, learning rate, every updated
parameter and both AdamW moments), the loss with and without chunking,
three ``Trainer.train`` steps, remat, and the entry points.

Parameters come from JAX's ``Model.init_params`` through
``repro_torch.convert``; batches from a numpy seed.  Tolerances, relative to
each leaf's largest magnitude: 1e-4 in f32 for gradients and updated
leaves, 1e-5 for losses in f32, 2e-2 for everything in bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

torch.set_num_threads(2)  # beside the other test workers on the CPU

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.launch.steps import make_train_step as jmake_train_step  # noqa: E402
import repro.launch.train as jtrain  # noqa: E402
from repro.launch.train import Trainer as JTrainer  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import from_numpy_tree  # noqa: E402
from repro_torch.launch.steps import loss_and_grads, make_train_step  # noqa: E402
from repro_torch.launch.train import Trainer, batch_to_device, main, synthetic_source  # noqa: E402
from repro_torch.models.common import tree_items  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402

REL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
LOSS_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
B, S = 2, 128


def _configs(arch, **kw):
    return jget_smoke(arch).replace(**kw), get_smoke_config(arch).replace(**kw)


def _batch(vocab, seed=0):
    rng = np.random.RandomState(seed)
    return {k: rng.randint(0, vocab, (B, S)).astype(np.int32) for k in ("inputs", "targets")}


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _jax_params(jcfg, seed=0):
    return JModel(jcfg).init_params(jax.random.PRNGKey(seed))


def _to_torch(jtree):
    return from_numpy_tree(jax.tree.map(np.asarray, jtree), device="cpu")


# leaves whose gradient is zero in exact arithmetic: softmax is invariant to
# a constant added to all of a query's scores, and the key bias adds q . bk
# to every score of query q (the dense and moe stacks; whisper's encoder and
# decoder self-attention).  Both packages compute rounding noise there (and
# AdamW turns noise into steps of +-lr), so these leaves are held to the
# largest magnitude in their whole tree instead of their own.
ZERO_GRAD_LEAVES = ("layers.attn.bk", "enc_layers.attn.bk", "dec_layers.attn.bk")


def _close_tree(got: dict, want: dict, tol: float, what: str, fn=lambda a: a):
    """Every leaf of ``fn(got)`` within ``tol`` of the largest magnitude of
    the same leaf of ``fn(want)``."""
    want_items = {p: fn(np.asarray(w, np.float32)) for p, w in tree_items(want)}
    got_items = {p: fn(g.float().numpy()) for p, g in tree_items(got)}
    assert got_items.keys() == want_items.keys()
    tree_max = max(np.abs(w).max() for w in want_items.values())
    for path, w in want_items.items():
        g = got_items[path]
        assert g.shape == w.shape, (what, path)
        scale = tree_max if path in ZERO_GRAD_LEAVES else np.abs(w).max()
        err = np.abs(g - w).max()
        assert err <= tol * max(scale, 1e-30), (what, path, err, scale)


def _close_params(got: dict, want: dict, mu_want: dict, lr: float, tol: float):
    """Parameters after one AdamW step.  Its direction g / (|g| + eps) is
    about sign(g), so an element whose gradient is within the tolerance of
    zero (|mu| within ``tol`` of its leaf's largest |mu|) may step the other
    way: up to 2 lr apart; every element of a ``ZERO_GRAD_LEAVES`` leaf,
    whose whole gradient is rounding noise, is such an element.  Where |g|
    is near eps (whisper's encoder, whose gradients are ~1e-8), the
    direction is a slope: a gradient error of ``tol`` times the leaf's
    largest |g| moves it by that times eps / (|g| + eps)^2, and the
    parameter by lr times as much.  Every element is also held like
    ``_close_tree``, to its own leaf's largest magnitude."""
    mu = {p: np.asarray(m, np.float32) for p, m in tree_items(mu_want)}
    eps, b1 = AdamW.eps, AdamW.b1
    for path, w in tree_items(want):
        w = np.asarray(w, np.float32)
        g = dict(tree_items(got))[path].float().numpy()
        m = mu[path]
        undetermined = np.abs(m) <= tol * np.abs(m).max()
        if path in ZERO_GRAD_LEAVES:
            undetermined = np.ones_like(undetermined)
        grad = np.abs(m) / (1 - b1)  # the first step's mu is (1 - b1) g
        slope = lr * tol * grad.max() * eps / (grad + eps) ** 2
        limit = tol * np.abs(w).max() + np.where(undetermined, 2 * lr, slope)
        bad = np.abs(g - w) > limit
        assert not bad.any(), (path, np.abs(g - w)[bad].max(), np.abs(w).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["chatglm3_6b", "yi_34b"])
def test_train_step_matches_jax(arch, dtype):
    jcfg, cfg = _configs(arch, attn_impl="pallas", compute_dtype=dtype)
    jparams = _jax_params(jcfg)
    batch = _batch(cfg.vocab_size)
    _, jopt, jstep = jmake_train_step(jcfg)
    jp, js, jm = jax.jit(jstep)(jparams, jopt.init(jparams),
                                {k: jnp.asarray(v) for k, v in batch.items()})

    _, opt, step = make_train_step(cfg, device="cpu")
    params = _to_torch(jparams)
    p, s, m = step(params, opt.init(params), _torch_batch(batch))
    assert p is params  # updated in place
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=LOSS_TOL[dtype])
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=REL_TOL[dtype])
    np.testing.assert_allclose(m["lr"], float(jm["lr"]), rtol=1e-6)
    assert int(s["step"]) == int(js["step"]) == 1
    tol = REL_TOL[dtype]
    _close_tree(s["mu"], jax.tree.map(np.asarray, js["mu"]), tol, "mu")
    # nu holds squared gradients: compared as sqrt(nu), on the gradient's scale
    _close_tree(s["nu"], jax.tree.map(np.asarray, js["nu"]), tol, "nu", fn=np.sqrt)
    _close_params(p, jax.tree.map(np.asarray, jp), js["mu"], m["lr"], tol)


@pytest.mark.parametrize("loss_chunk", [0, 32])
def test_loss_and_grads_match_jax(loss_chunk):
    """The loss over the padded vocab, unchunked and chunked (f32 head), and
    its gradient tree against ``jax.value_and_grad``."""
    jcfg, cfg = _configs("qwen1_5_4b", compute_dtype="float32", loss_chunk=loss_chunk)
    jparams = _jax_params(jcfg, seed=1)
    batch = _batch(cfg.vocab_size, seed=1)
    jloss, jgrads = jax.value_and_grad(JModel(jcfg).loss_fn)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = loss_and_grads(Model(cfg, device="cpu"), _to_torch(jparams),
                                 _torch_batch(batch))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_TOL["float32"])
    _close_tree(grads, jax.tree.map(np.asarray, jgrads), REL_TOL["float32"], "grads")


def _trainer_losses_match_jax(arch):
    jcfg, cfg = _configs(arch, compute_dtype="float32")
    jtrainer = JTrainer(jcfg, mesh=None, global_batch=B, seq_len=S, total_steps=3)
    _, _, want = jtrainer.train(3)

    trainer = Trainer(cfg, device="cpu", global_batch=B, seq_len=S, total_steps=3)
    params = _to_torch(_jax_params(jcfg))
    trainer.init_state = lambda seed=0: (params, trainer.opt.init(params))
    _, state, got = trainer.train(3)
    assert int(state["step"]) == 3
    np.testing.assert_allclose(got, want, rtol=LOSS_TOL["float32"])


def test_trainer_losses_match_jax():
    """Three steps of ``Trainer.train`` on ``SyntheticLMSource``, from the
    same parameters, give JAX's losses."""
    _trainer_losses_match_jax("chatglm3_6b")


# the Trainer's batches beyond tokens: qwen2-vl's embeds at M-RoPE
# positions, whisper's audio frames, and the hybrid's two layer stacks
TRAINER_FAMILIES = ["qwen2_vl_2b", "whisper_large_v3", "recurrentgemma_2b"]


@pytest.mark.parametrize("arch", TRAINER_FAMILIES)
def test_trainer_losses_match_jax_for_each_family(arch):
    _trainer_losses_match_jax(arch)


@pytest.mark.parametrize("arch", ["chatglm3_6b"] + TRAINER_FAMILIES)
def test_trainer_batches_match_jax(arch, monkeypatch):
    """The Trainer's ``SyntheticLMSource`` draws JAX's batches, array for
    array (whisper's unread ``embeds`` before its frames included), and
    moves tokens and positions as int64, embeddings and frames as f32."""
    captured = []

    class Recording(jtrain.DataPipeline):
        def __next__(self):
            step, batch = super().__next__()
            captured.append(batch)
            return step, batch

    monkeypatch.setattr(jtrain, "DataPipeline", Recording)
    jcfg, cfg = _configs(arch)
    jtrainer = JTrainer(jcfg, mesh=None, global_batch=B, seq_len=S, total_steps=3)
    jtrainer.step_fn = lambda p, o, batch: (p, o, {"loss": jnp.zeros(())})
    jtrainer.train(2, seed=5)
    assert len(captured) == 3  # the loop draws step 2 before it stops
    source = synthetic_source(cfg, B, S, seed=5)
    for step, want in enumerate(captured):
        got = source.batch_at(step)
        assert got.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
        moved = batch_to_device(got, "cpu")
        for k, t in moved.items():
            assert t.dtype == (torch.float32 if k in ("embeds", "frames") else torch.int64), k
            np.testing.assert_array_equal(t.numpy(), got[k], err_msg=k)


def test_remat_none_and_full_give_the_same_grads():
    cfg = get_smoke_config("chatglm3_6b").replace(compute_dtype="float32",
                                                  attn_impl="pallas")
    model = Model(cfg, device="cpu")
    params = model.init_params(seed=3)
    batch = _torch_batch(_batch(cfg.vocab_size, seed=3))
    loss_full, g_full = loss_and_grads(model, params, batch)
    model_none = Model(cfg.replace(remat="none"), device="cpu")
    loss_none, g_none = loss_and_grads(model_none, params, batch)
    assert float(loss_full) == float(loss_none)
    for (path, a), (_, b) in zip(tree_items(g_full), tree_items(g_none)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9, msg=path)
    with pytest.raises(ValueError, match="unknown remat policy"):
        loss_and_grads(Model(cfg.replace(remat="dot"), device="cpu"), params, batch)


class _CountProducts(TorchDispatchMode):
    """Counts the matrix products dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                           torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)
        return func(*args, **(kwargs or {}))


def _grads_and_products(cfg, params, batch):
    with _CountProducts() as count:
        loss, grads = loss_and_grads(Model(cfg, device="cpu"), params, batch)
    return loss, grads, count.n


@pytest.mark.parametrize("policy", ["dots", "save_collectives"])
@pytest.mark.parametrize("arch", ["chatglm3_6b", "qwen3_moe_30b_a3b", "recurrentgemma_2b"])
def test_remat_policies_give_none_grads(arch, policy):
    """``dots`` and ``save_collectives`` give ``none``'s loss and gradients
    (a dense, an MoE and the hybrid smoke config).  ``dots`` keeps the
    products' outputs, so its backward recomputes none of them and runs as
    many as ``none``; ``save_collectives`` names nothing on one device and
    recomputes them all, as ``full`` does."""
    cfg = get_smoke_config(arch).replace(compute_dtype="float32", attn_impl="pallas")
    params = Model(cfg, device="cpu").init_params(seed=3)
    batch = _torch_batch(_batch(cfg.vocab_size, seed=3))
    loss_none, g_none, n_none = _grads_and_products(cfg.replace(remat="none"), params, batch)
    loss, grads, n = _grads_and_products(cfg.replace(remat=policy), params, batch)
    assert float(loss) == float(loss_none)
    for (path, a), (_, b) in zip(tree_items(grads), tree_items(g_none)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9, msg=path)
    _, _, n_full = _grads_and_products(cfg.replace(remat="full"), params, batch)
    assert n_none < n_full
    assert n == (n_none if policy == "dots" else n_full)


@pytest.mark.parametrize("arch", ["chatglm3_6b", "qwen3_moe_30b_a3b", "recurrentgemma_2b"])
def test_remat_dots_matches_jax_checkpoint_dots(arch):
    """``remat="dots"``'s loss and gradients against JAX's under
    ``checkpoint_dots``."""
    jcfg, cfg = _configs(arch, compute_dtype="float32", remat="dots")
    jparams = _jax_params(jcfg, seed=1)
    batch = _batch(cfg.vocab_size, seed=1)
    jloss, jgrads = jax.jit(jax.value_and_grad(JModel(jcfg).loss_fn))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = loss_and_grads(Model(cfg, device="cpu"), _to_torch(jparams),
                                 _torch_batch(batch))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_TOL["float32"])
    _close_tree(grads, jax.tree.map(np.asarray, jgrads), REL_TOL["float32"], "grads")


def test_train_entry_points_raise_without_cuda(monkeypatch):
    """No silent drop to the CPU: without a CUDA device the default
    device="cuda" raises, in the Trainer, the train step and the CLI."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("chatglm3_6b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--arch", "chatglm3_6b", "--smoke", "--steps", "1"])


def test_train_cli_on_cpu(capsys, tmp_path):
    main(["--arch", "chatglm3_6b", "--smoke", "--device", "cpu", "--steps", "3", "--batch",
          "2", "--seq", "128", "--attn-impl", "pallas", "--ckpt-dir", str(tmp_path),
          "--save-every", "2"])
    out = capsys.readouterr().out
    assert "final loss" in out and "over 3 steps" in out and "on cpu" in out
    assert (tmp_path / "step_0000000002" / "manifest.json").exists()
