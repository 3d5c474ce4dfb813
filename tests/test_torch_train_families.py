"""Training of the ssm, hybrid, moe and encdec families on the CPU against
the JAX package: ``loss_and_grads`` against ``jax.value_and_grad(
Model.loss_fn)`` and one ``make_train_step`` step against JAX's, in f32, on
the falcon-mamba, recurrentgemma, granite-moe, qwen3-moe and whisper smoke
configs; their bf16 gradients; and the port's twin of
``tests/test_arch_smoke.py::test_smoke_train_step`` over every architecture.

Parameters come from JAX's ``Model.init_params`` through
``repro_torch.convert``; batches from a numpy seed.  f32 is held as
``tests/test_torch_train.py`` holds it: 1e-5 for the loss, 1e-4 of each
leaf's largest magnitude for gradients, moments and updated parameters.

bf16 (2e-2 of each leaf's largest magnitude, the port's bf16 tolerance):

- ssm and hybrid: against JAX's f32 gradient.  JAX's own bf16 gradient
  is no reference there: it sits up to 3.6e-2 of a leaf's largest value
  from the f32 one (falcon-mamba-smoke, ``layers.mamba.dt_b``), which is
  rounding, and the port's is as far from it again.  The test computes
  JAX's bf16 distance beside the port's and names both on a failure.
- moe: on JAX's routes.  A near-tie router logit takes another expert in
  bf16 under a one-unit difference of the normed activations (2 of 256
  tokens), and an expert's gradient then moves by up to a quarter of its
  largest value.  So the experts JAX run op by op (``jax.disable_jit``)
  chooses are recorded, and both packages take those experts with their
  own gates; the port's own differing choices are counted in the message.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # beside the other test workers on the CPU

import repro.models.moe as jmoe  # noqa: E402
from repro.configs import ARCH_IDS as JARCH_IDS  # noqa: E402
from repro.launch.steps import make_train_step as jmake_train_step  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.launch.steps import loss_and_grads, make_train_step  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.common import tree_items  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from test_torch_train import (  # noqa: E402
    LOSS_TOL,
    REL_TOL,
    _close_params,
    _close_tree,
    _configs,
    _to_torch,
)

FAMILIES = ["falcon_mamba_7b", "recurrentgemma_2b", "granite_moe_1b_a400m",
            "qwen3_moe_30b_a3b", "whisper_large_v3"]
B, S = 2, 128


def _batch(cfg, seed=0) -> dict:
    """Tokens [B, S] and, for encdec, audio frames [B, enc_positions, d]."""
    rng = np.random.RandomState(seed)
    batch = {k: rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
             for k in ("inputs", "targets")}
    if cfg.family == "encdec":
        batch["frames"] = (0.02 * rng.randn(B, cfg.enc_positions, cfg.d_model)).astype(np.float32)
    return batch


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in batch.items()}


def _jax_grads(jcfg, jparams, batch):
    return jax.jit(jax.value_and_grad(JModel(jcfg).loss_fn))(jparams, _jax_batch(batch))


def _worst(got: dict, want: dict) -> tuple[float, str]:
    """The largest leaf error of ``got`` against ``want`` as a fraction of
    the leaf's largest magnitude (``_close_tree``'s measure), and its leaf."""
    errs = []
    for path, w in tree_items(want):
        w = np.asarray(w, np.float32)
        g = got[path]
        g = g.float().numpy() if isinstance(g, torch.Tensor) else np.asarray(g, np.float32)
        errs.append((float(np.abs(g - w).max()) / max(float(np.abs(w).max()), 1e-30), path))
    return max(errs)


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_jax(arch):
    jcfg, cfg = _configs(arch, compute_dtype="float32")
    jparams = JModel(jcfg).init_params(jax.random.PRNGKey(0))
    batch = _batch(cfg)
    jloss, jgrads = _jax_grads(jcfg, jparams, batch)
    loss, grads = loss_and_grads(Model(cfg, device="cpu"), _to_torch(jparams),
                                 _torch_batch(batch))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_TOL["float32"])
    _close_tree(grads, jax.tree.map(np.asarray, jgrads), REL_TOL["float32"], "grads")


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_matches_jax(arch):
    """One ``make_train_step`` step: loss, gradient norm, learning rate,
    both AdamW moments and every updated parameter against JAX's jitted
    step."""
    jcfg, cfg = _configs(arch, compute_dtype="float32")
    jparams = JModel(jcfg).init_params(jax.random.PRNGKey(0))
    batch = _batch(cfg)
    _, jopt, jstep = jmake_train_step(jcfg)
    jp, js, jm = jax.jit(jstep)(jparams, jopt.init(jparams), _jax_batch(batch))

    _, opt, step = make_train_step(cfg, device="cpu")
    params = _to_torch(jparams)
    p, s, m = step(params, opt.init(params), _torch_batch(batch))
    tol = REL_TOL["float32"]
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=LOSS_TOL["float32"])
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=tol)
    np.testing.assert_allclose(m["lr"], float(jm["lr"]), rtol=1e-6)
    assert int(s["step"]) == int(js["step"]) == 1
    _close_tree(s["mu"], jax.tree.map(np.asarray, js["mu"]), tol, "mu")
    _close_tree(s["nu"], jax.tree.map(np.asarray, js["nu"]), tol, "nu", fn=np.sqrt)
    _close_params(p, jax.tree.map(np.asarray, jp), js["mu"], m["lr"], tol)


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "recurrentgemma_2b"])
def test_recurrent_bf16_grads_near_jax_f32(arch):
    """The port's bf16 gradient within the bf16 tolerance of JAX's f32
    gradient; JAX's own bf16 gradient measured the same way beside it."""
    jcfg32, _ = _configs(arch, compute_dtype="float32")
    jcfg, cfg = _configs(arch, compute_dtype="bfloat16")
    jparams = JModel(jcfg).init_params(jax.random.PRNGKey(0))
    batch = _batch(cfg)
    _, want = _jax_grads(jcfg32, jparams, batch)
    want = jax.tree.map(np.asarray, want)
    _, jax_bf16 = _jax_grads(jcfg, jparams, batch)
    loss, grads = loss_and_grads(Model(cfg, device="cpu"), _to_torch(jparams),
                                 _torch_batch(batch))
    assert np.isfinite(float(loss))
    port_err = _worst(dict(tree_items(grads)), want)
    jax_err = _worst(dict(tree_items(jax.tree.map(np.asarray, jax_bf16))), want)
    assert port_err[0] <= REL_TOL["bfloat16"], (port_err, "JAX's own bf16:", jax_err)


def _jax_routes(jcfg, jparams, batch) -> list:
    """The experts [T, k] that each router call of JAX's forward chooses,
    run op by op, in call order (layer by layer, chunk by chunk)."""
    topk, routes = jmoe.router_topk, []

    def recording(x2d, router_w, n_experts, k, router_dtype=jnp.float32):
        top_p, top_i = topk(x2d, router_w, n_experts, k, router_dtype)
        routes.append(np.asarray(top_i))
        return top_p, top_i

    jmoe.router_topk = recording
    try:
        with jax.disable_jit():
            JModel(jcfg).loss_fn(jparams, _jax_batch(batch))
    finally:
        jmoe.router_topk = topk
    return routes


def _jax_grads_on_routes(jcfg, jparams, batch, routes):
    """JAX's loss and gradient, run op by op, every router call taking the
    next of ``routes`` with its own gates there (its softmax at those
    experts, renormalised)."""
    topk, calls = jmoe.router_topk, iter(routes)

    def forced(x2d, router_w, n_experts, k, router_dtype=jnp.float32):
        idx = jnp.asarray(next(calls))
        probs = jax.nn.softmax(x2d.astype(router_dtype) @ router_w.astype(router_dtype), axis=-1)
        p = jnp.take_along_axis(probs, idx, axis=-1)
        return p / jnp.maximum(p.sum(-1, keepdims=True), 1e-9), idx

    jmoe.router_topk = forced
    try:
        with jax.disable_jit():
            return jax.value_and_grad(JModel(jcfg).loss_fn)(jparams, _jax_batch(batch))
    finally:
        jmoe.router_topk = topk


def _port_grads_on_routes(cfg, params, batch, routes):
    """The port's ``loss_and_grads`` with every router call taking the next
    of ``routes`` as ``_jax_grads_on_routes`` does; also returns how many
    of the choices the port would have made differ from them."""
    topk, calls, own = moe.router_topk, iter(routes), []

    def forced(x2d, router_w, n_experts, k, router_dtype=torch.float32):
        _, mine = topk(x2d, router_w, n_experts, k, router_dtype)
        idx = torch.tensor(next(calls), dtype=torch.int64)
        own.append(int((~(mine[:, :, None] == idx[:, None, :]).any(-1)).sum()))
        probs = torch.softmax(x2d.to(router_dtype) @ router_w.to(router_dtype), dim=-1)
        p = probs.gather(-1, idx)
        return p / torch.clamp(p.sum(-1, keepdim=True), min=1e-9), idx

    moe.router_topk = forced
    try:
        loss, grads = loss_and_grads(Model(cfg, device="cpu"), params, _torch_batch(batch))
    finally:
        moe.router_topk = topk
    return loss, grads, sum(own)


@pytest.mark.parametrize("arch", ["granite_moe_1b_a400m", "qwen3_moe_30b_a3b"])
def test_moe_bf16_grads_match_jax_on_its_routes(arch):
    """bf16 loss and gradients against JAX run op by op, both taking the
    experts JAX's forward chose.  ``remat="none"``: the router runs once per
    layer, in the order both packages call it."""
    jcfg, cfg = _configs(arch, compute_dtype="bfloat16", remat="none")
    jparams = JModel(jcfg).init_params(jax.random.PRNGKey(0))
    batch = _batch(cfg)
    routes = _jax_routes(jcfg, jparams, batch)
    assert len(routes) == cfg.n_layers
    jloss, jgrads = _jax_grads_on_routes(jcfg, jparams, batch, routes)
    loss, grads, flips = _port_grads_on_routes(cfg, _to_torch(jparams), batch, routes)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_TOL["bfloat16"])
    err = _worst(dict(tree_items(grads)), jax.tree.map(np.asarray, jgrads))
    assert err[0] <= REL_TOL["bfloat16"], (err, f"{flips} of the port's own choices differ")


def _smoke_batch(cfg, seed: int = 0) -> dict:
    """``tests/test_arch_smoke.py``'s batch, drawn by JAX, as numpy."""
    from test_arch_smoke import _batch as smoke_batch

    return {k: np.array(v) for k, v in smoke_batch(cfg, jax.random.PRNGKey(seed)).items()}


def test_the_port_trains_every_architecture_jax_does():
    assert ARCH_IDS == JARCH_IDS


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_train_step(arch):
    """The port's twin of ``tests/test_arch_smoke.py::test_smoke_train_step``
    on the same config, parameters and batch: a finite, positive loss (JAX's
    within the bf16 tolerance) and a finite gradient norm."""
    kw = dict(attn_impl="chunked", attn_chunk=8, remat="none")
    jcfg, cfg = _configs(arch, **kw)
    jparams = JModel(jcfg).init_params(jax.random.PRNGKey(0))
    batch = _smoke_batch(jcfg)
    jloss = JModel(jcfg).loss_fn(jparams, _jax_batch(batch))
    loss, grads = loss_and_grads(Model(cfg, device="cpu"), _to_torch(jparams),
                                 _torch_batch(batch))
    assert np.isfinite(float(loss)) and float(loss) > 0, arch
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_TOL["bfloat16"])
    gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2) for _, g in tree_items(grads)))
    assert torch.isfinite(gnorm), f"{arch}: grad norm not finite"
