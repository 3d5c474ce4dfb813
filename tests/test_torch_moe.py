"""The port's MoE family (``repro_torch.models.moe`` and the moe models)
against the JAX package on the CPU.

Inputs come from numpy seeds; JAX parameters go across through
``repro_torch.convert.from_numpy_tree``.  The router's top-k, the dispatch
and combine tensors (with tokens dropped past the capacity, the decode's
capacity of 1, and out-of-range experts), the scatter dispatch, the layer
in both dispatch modes with one chunk and several, and both MoE smoke
models' prefill and decode chain with greedy tokens, against JAX's; the
full configs' templates and parameter counts, built abstractly.
Tolerances: 1e-5 in f32, 2e-2 in bf16 (tests/test_kernels.py:14); the
router and the dispatch tensors are held bitwise.  The inputs have no ties
among router probabilities, where ``torch.topk`` and ``jax.lax.top_k`` may
order equal values differently.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # beside the other test workers on the CPU

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.launch.serve import Server as JServer  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.models.model import count_params_config as jcount  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import from_numpy_tree  # noqa: E402
from repro_torch.launch.serve import Server  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.common import tree_items  # noqa: E402
from repro_torch.models.model import Model, count_params_config  # noqa: E402

MOE = ["qwen3_moe_30b_a3b", "granite_moe_1b_a400m"]
TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def _routing(T: int, E: int, k: int, seed: int):
    """Router inputs x [T, d] and weights [d, E] from a numpy seed, and
    JAX's top-k of them."""
    rng = np.random.RandomState(seed)
    x = rng.randn(T, 32).astype(np.float32)
    w = (0.3 * rng.randn(32, E)).astype(np.float32)
    top_p, top_i = jmoe.router_topk(jnp.asarray(x), jnp.asarray(w), E, k)
    return x, w, np.array(top_p), np.array(top_i)


@pytest.mark.parametrize("T,E,k", [(64, 8, 2), (4, 128, 8), (33, 32, 8), (16, 4, 2)])
def test_router_topk_matches_jax(T, E, k):
    x, w, jp, ji = _routing(T, E, k, seed=T + E)
    top_p, top_i = moe.router_topk(torch.from_numpy(x), torch.from_numpy(w), E, k)
    assert top_p.dtype == torch.float32 and top_i.shape == (T, k)
    np.testing.assert_array_equal(top_i.numpy(), ji)
    _close(top_p, jp, **TOL["float32"])
    # the router casts bf16 tokens and weights to f32 before the product
    xb = torch.from_numpy(x).to(torch.bfloat16)
    bp, bi = moe.router_topk(xb, torch.from_numpy(w), E, k)
    jbp, jbi = jmoe.router_topk(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), E, k)
    np.testing.assert_array_equal(bi.numpy(), np.asarray(jbi))
    _close(bp, jbp, **TOL["float32"])


@pytest.mark.parametrize("T,E,k,cap", [
    (64, 8, 2, 20),    # 1.25 * 64 * 2 / 8: room for nearly every choice
    (64, 8, 2, 6),     # a small capacity: most choices are dropped
    (4, 128, 8, 1),    # qwen3's decode at B = 4: cap = max(1, int(0.3125)) = 1
    (4, 32, 8, 1),     # granite's decode at B = 4: cap = int(1.25) = 1
])
def test_dispatch_onehot_matches_jax_bitwise(T, E, k, cap):
    _, _, jp, ji = _routing(T, E, k, seed=7 * T + E)
    jd, jc = jmoe._dispatch_onehot(jnp.asarray(ji), jnp.asarray(jp), E, cap)
    disp, comb = moe._dispatch_onehot(torch.from_numpy(ji).long(), torch.from_numpy(jp), E, cap)
    assert disp.shape == (T, E, cap) and disp.dtype == torch.float32
    np.testing.assert_array_equal(disp.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(comb.numpy(), np.asarray(jc))
    kept = int(disp.sum())
    assert kept <= min(T * k, E * cap)
    if cap < 1.25 * T * k / E:
        assert kept < T * k  # this case drops tokens


def test_dispatch_onehot_drops_out_of_range_experts():
    """Out-of-range indices one-hot to zero rows, as ``jax.nn.one_hot``
    gives them (the JAX EP path's shifted local indices)."""
    _, _, jp, ji = _routing(16, 8, 2, seed=3)
    shifted = ji - 4  # experts 0..3 fall below the range, 4..7 become 0..3
    jd, jc = jmoe._dispatch_onehot(jnp.asarray(shifted), jnp.asarray(jp), 4, 10)
    disp, comb = moe._dispatch_onehot(torch.from_numpy(shifted).long(), torch.from_numpy(jp), 4, 10)
    np.testing.assert_array_equal(disp.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(comb.numpy(), np.asarray(jc))
    assert int(disp.sum()) == int((shifted >= 0).sum())


@pytest.mark.parametrize("T,E,k,cap", [(64, 8, 2, 6), (4, 128, 8, 1), (16, 4, 2, 10)])
def test_dispatch_scatter_matches_jax(T, E, k, cap):
    x, _, jp, ji = _routing(T, E, k, seed=11 * T + E)
    jbuf, jslot, jvalid, jrank = jmoe._dispatch_scatter(
        jnp.asarray(x), jnp.asarray(ji), jnp.asarray(jp), E, cap, jnp.float32)
    buf, slot, valid, rank = moe._dispatch_scatter(
        torch.from_numpy(x), torch.from_numpy(ji).long(), torch.from_numpy(jp), E, cap,
        torch.float32)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(rank.numpy(), np.asarray(jrank))


def _layer(arch: str, dtype: str, **overrides):
    """(JAX cfg, port cfg, JAX layer-0 MoE params, the port's copy)."""
    jcfg = jget_smoke(arch).replace(compute_dtype=dtype, **overrides)
    cfg = get_smoke_config(arch).replace(compute_dtype=dtype, **overrides)
    jparams = JModel(jcfg).init_params(jax.random.PRNGKey(0))
    lp = jax.tree.map(lambda a: np.asarray(a[0]), jparams["layers"]["mlp"])
    return jcfg, cfg, lp, from_numpy_tree(lp, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [1024, 8])  # one chunk of 32 tokens; four of 8
@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_apply_dense_matches_jax(arch, dispatch, chunk, dtype):
    jcfg, cfg, jlp, lp = _layer(arch, dtype, moe_dispatch=dispatch, moe_chunk=chunk)
    jdt, tdt = DTYPES[dtype]
    x = np.random.RandomState(1).randn(2, 16, cfg.d_model).astype(np.float32)
    want = jmoe.moe_apply_dense(jnp.asarray(x, jdt), jlp, jcfg, jdt)
    got = moe.moe_apply(torch.from_numpy(x).to(tdt), lp, cfg, tdt)
    assert got.shape == (2, 16, cfg.d_model) and got.dtype == tdt
    _close(got, want, **TOL[dtype])


def test_moe_scatter_matches_einsum_dispatch():
    """Twin of tests/test_distribution.py::test_moe_scatter_matches_einsum_dispatch
    on one device: the two dispatch modes give the same layer output."""
    _, cfg, _, lp = _layer("granite_moe_1b_a400m", "float32", moe_chunk=32, capacity_factor=4.0)
    x = 0.1 * np.random.RandomState(1).randn(2, 16, cfg.d_model)
    x = torch.from_numpy(x.astype(np.float32))
    y1 = moe.moe_apply_dense(x, lp, cfg, torch.float32)
    y2 = moe.moe_apply_dense(x, lp, cfg.replace(moe_dispatch="scatter"), torch.float32)
    torch.testing.assert_close(y1, y2, rtol=2e-5, atol=2e-5)


def test_moe_apply_refuses_a_mesh():
    """The expert-parallel paths refuse a mesh whose model axis has one rank
    or does not divide the experts, as JAX's ``moe_apply`` does: the layer
    takes the dense path there, bitwise (the mesh paths themselves are
    held to JAX in ``test_torch_distribution.py``)."""
    _, cfg, _, lp = _layer("granite_moe_1b_a400m", "float32")

    class ShapeOnlyMesh:
        mesh_dim_names = ("data", "model")

        def __init__(self, model):
            self.sizes = (1, model)

        def size(self, dim):
            return self.sizes[dim]

    x = 0.1 * torch.randn((1, 4, cfg.d_model), generator=torch.Generator().manual_seed(0))
    dense = moe.moe_apply_dense(x, lp, cfg, torch.float32)
    for n_model in (1, 3):  # granite-smoke has 4 experts
        got = moe.moe_apply(x, lp, cfg, torch.float32,
                            mesh_info=(ShapeOnlyMesh(n_model), "data", "model"))
        assert torch.equal(got, dense)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_prefill_then_decode_matches_jax(arch, dtype):
    """Twin of tests/test_arch_smoke.py::test_smoke_prefill_then_decode,
    against JAX's jitted ``prefill`` and ``decode_step``: the prefill logits
    and cache, then greedy decode steps (each side feeding back its own
    argmax), whose logits and tokens must agree.

    In bf16 the prefill cache is held against JAX run op by op
    (``jax.disable_jit``): XLA's fused prefill rounds the normed activations
    one bf16 unit away from JAX's own op-by-op run in places, and at
    granite's smoke layer 0 that moves a router choice whose two logits are
    5e-5 apart (token 9: experts (2, 3) jitted, (2, 0) op by op and in the
    port), which moves one k element of layer 1 by 0.027.  The port agrees
    with the op-by-op run, and its logits and tokens with the jitted one."""
    B, S, STEPS, MAX = 2, 16, 4, 32
    jcfg = jget_smoke(arch).replace(compute_dtype=dtype, attn_impl="pallas")
    cfg = get_smoke_config(arch).replace(compute_dtype=dtype, attn_impl="pallas")
    jparams = JModel(jcfg).init_params(jax.random.PRNGKey(1))
    params = from_numpy_tree(jax.tree.map(np.asarray, jparams), device="cpu")
    inputs = np.random.RandomState(1).randint(0, cfg.vocab_size, (B, S))
    jbatch = {"inputs": jnp.asarray(inputs, jnp.int32)}

    jm = JModel(jcfg)
    jl, jc = jax.jit(jm.prefill)(jparams, jbatch)
    jc_ref = dict(jc)  # JServer._pad_cache pads jc in place
    if dtype == "bfloat16":
        with jax.disable_jit():
            _, jc_ref = jm.prefill(jparams, jbatch)
    jc = JServer(jcfg, max_len=MAX)._pad_cache(jc, S)
    jstep = jax.jit(jm.decode_step)
    server = Server(cfg, device="cpu", max_len=MAX)
    logits, cache = server.prefill_fn(params, {"inputs": torch.from_numpy(inputs)})
    assert logits.shape == (B, 1, cfg.vocab_size) and bool(torch.isfinite(logits).all())
    for key in ("k", "v"):
        _close(cache[key], jc_ref[key], **TOL[dtype])
    cache = server._pad_cache(cache)
    for i in range(STEPS):
        _close(logits, jl, **TOL[dtype])
        tok = torch.argmax(logits, dim=-1)
        jtok = jnp.argmax(jl, axis=-1).astype(jnp.int32)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        logits, cache = server.decode_fn(params, cache, tok, S + i)
        jl, jc = jstep(jparams, jc, jtok, S + i)
        assert bool(torch.isfinite(logits).all())
    _close(logits, jl, **TOL[dtype])
    assert set(cache) == set(jc) == {"k", "v"}


# (layers, d_model, heads, kv, d_ff, vocab): tests/test_arch_smoke.py:82-93
EXPECTED = {
    "qwen3_moe_30b_a3b": (48, 2048, 32, 4, 768, 151936),
    "granite_moe_1b_a400m": (24, 1024, 16, 8, 512, 49155),
}
# total and active parameter counts of the JAX templates
COUNTS = {
    "qwen3_moe_30b_a3b": (30_532_646_912, 3_353_556_992),
    "granite_moe_1b_a400m": (1_334_887_424, 428_917_760),
}


@pytest.mark.parametrize("arch", MOE)
def test_full_config_dimensions_and_param_counts(arch):
    """Twin of tests/test_arch_smoke.py:69-110 at full size, abstract (no
    allocation): the published dimensions, the padded vocab, the template's
    paths and shapes equal JAX's, and the parameter count with and without
    ``active_only``."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff,
            cfg.vocab_size) == EXPECTED[arch]
    assert (cfg.n_experts, cfg.experts_per_token) == (jcfg.n_experts, jcfg.experts_per_token)
    model = Model(cfg, device="meta")
    abstract = dict(tree_items(model.abstract_params()))
    jabstract = jax.tree_util.tree_flatten_with_path(JModel(jcfg).abstract_params())[0]
    want = {".".join(str(p.key) for p in path): tuple(a.shape) for path, a in jabstract}
    assert {k: tuple(v.shape) for k, v in abstract.items()} == want
    vp = abstract["embed"].shape[0]
    assert vp % 256 == 0 and cfg.vocab_size <= vp < cfg.vocab_size + 256
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    assert abstract["layers.mlp.we_gate"].shape == (cfg.n_layers, E, d, f)
    assert abstract["layers.mlp.router"].shape == (cfg.n_layers, d, E)
    total, active = COUNTS[arch]
    assert cfg.param_count() == jcount(jcfg) == total
    assert count_params_config(cfg, active_only=True) == jcount(jcfg, active_only=True) == active
    assert cfg.active_param_count() == active


def test_compute_params_keeps_the_router_in_f32():
    """``compute_params`` casts the expert banks to the compute dtype and
    leaves the router in f32, which the router reads (JAX casts f32 params
    on use, so the top-k sees unrounded weights)."""
    cfg = get_smoke_config("qwen3_moe_30b_a3b")
    model = Model(cfg, device="cpu")
    params = model.init_params(seed=0)
    cp = model.compute_params(params)
    mlp = cp["layers"]["mlp"]
    assert mlp["router"].dtype == torch.float32
    assert mlp["router"] is params["layers"]["mlp"]["router"]
    assert {mlp[k].dtype for k in ("we_gate", "we_up", "we_down")} == {torch.bfloat16}
    assert cp["layers"]["attn"]["q_norm"].dtype == torch.float32
