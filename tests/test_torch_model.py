"""The port's dense model against the JAX package on the CPU.

Parameters come from JAX's ``Model.init_params`` and go across through
``repro_torch.convert``; tokens come from a numpy seed.  For the four dense
smoke configs, both ``attn_impl`` values and both compute dtypes, the
prefill logits and cache and eight teacher-forced decode steps must match.
Tolerances: 1e-5 at f32, 2e-2 at bf16 (tests/test_kernels.py:14).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # beside the other test workers on the CPU

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.core.access_plan import _path_str
from repro.models.common import ParamSpec as JParamSpec
from repro.models.model import Model as JModel
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import from_numpy_tree
from repro_torch.models.common import tree_items
from repro_torch.models.model import Model

DENSE = ["chatglm3_6b", "yi_34b", "qwen1_5_4b", "minitron_8b"]
TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
B, PROMPT, CACHE, STEPS = 2, 128, 256, 8


def _close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def _jax_run(cfg, params, inputs, forced):
    """JAX prefill, cache padded to CACHE, then teacher-forced decode."""
    model = JModel(cfg)
    logits, cache = jax.jit(model.prefill)(params, {"inputs": jnp.asarray(inputs, jnp.int32)})
    outs = [(logits, cache)]
    pad = ((0, 0), (0, 0), (0, CACHE - PROMPT), (0, 0), (0, 0))
    cache = {k: jnp.pad(v, pad) for k, v in cache.items()}
    step = jax.jit(model.decode_step)
    for i in range(STEPS):
        tok = jnp.asarray(forced[:, i : i + 1], jnp.int32)
        logits, cache = step(params, cache, tok, PROMPT + i)
        outs.append((logits, cache))
    return outs


def _torch_run(cfg, params, inputs, forced):
    model = Model(cfg, device="cpu")
    with torch.inference_mode():
        logits, cache = model.prefill(params, {"inputs": torch.from_numpy(inputs)})
        outs = [(logits, {k: v.clone() for k, v in cache.items()})]
        for key in ("k", "v"):
            buf = torch.zeros(cache[key].shape[:2] + (CACHE,) + cache[key].shape[3:],
                              dtype=cache[key].dtype)
            buf[:, :, :PROMPT] = cache[key]
            cache[key] = buf
        for i in range(STEPS):
            tok = torch.from_numpy(forced[:, i : i + 1])
            logits, cache = model.decode_step(params, cache, tok, PROMPT + i)
            outs.append((logits, {k: v.clone() for k, v in cache.items()}))
    return outs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["chunked", "pallas"])
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_jax(arch, impl, dtype):
    jcfg = jget_smoke(arch).replace(attn_impl=impl, compute_dtype=dtype)
    cfg = get_smoke_config(arch).replace(attn_impl=impl, compute_dtype=dtype)
    jparams = JModel(jcfg).init_params(jax.random.PRNGKey(0))
    params = from_numpy_tree(jax.tree.map(np.asarray, jparams), device="cpu")
    rng = np.random.RandomState(0)
    inputs = rng.randint(0, cfg.vocab_size, (B, PROMPT))
    forced = rng.randint(0, cfg.vocab_size, (B, STEPS))

    want = _jax_run(jcfg, jparams, inputs, forced)
    got = _torch_run(cfg, params, inputs, forced)
    (l0, c0), (jl0, jc0) = got[0], want[0]
    assert l0.shape == (B, 1, cfg.vocab_size) and l0.dtype == torch.float32
    assert c0["k"].shape == jc0["k"].shape and c0["k"].dtype == getattr(torch, dtype)
    for (l, c), (jl, jc) in zip(got, want):
        _close(l, jl, **TOL[dtype])
        for key in ("k", "v"):
            _close(c[key], jc[key], **TOL[dtype])


def test_fp8_kv_cache_decode_close_to_bf16():
    """Twin of tests/test_perf_variants.py::test_fp8_kv_cache_decode_close_to_bf16,
    plus the fp8 decode logits against JAX's from the same parameters."""
    jcfg = jget_smoke("chatglm3_6b").replace(attn_impl="pallas")
    cfg = get_smoke_config("chatglm3_6b").replace(attn_impl="pallas")
    jparams = JModel(jcfg).init_params(jax.random.PRNGKey(0))
    params = from_numpy_tree(jax.tree.map(np.asarray, jparams), device="cpu")
    inputs = np.random.RandomState(1).randint(0, cfg.vocab_size, (2, PROMPT))
    m_ref = Model(cfg, device="cpu")
    m_fp8 = Model(cfg.replace(kv_cache_dtype="float8_e4m3fn"), device="cpu")

    def run(model):
        with torch.inference_mode():
            logits, cache = model.prefill(params, {"inputs": torch.from_numpy(inputs)})
            for key in ("k", "v"):
                buf = torch.zeros(cache[key].shape[:2] + (CACHE,) + cache[key].shape[3:],
                                  dtype=cache[key].dtype)
                buf[:, :, :PROMPT] = cache[key]
                cache[key] = buf
            tok = torch.argmax(logits, dim=-1)
            dec, cache = model.decode_step(params, cache, tok, PROMPT)
        return logits, cache, tok, dec

    l_ref, _, tok, d_ref = run(m_ref)
    l_fp8, c_fp8, _, d_fp8 = run(m_fp8)
    assert c_fp8["k"].dtype == torch.float8_e4m3fn
    # prefill logits identical (cache dtype unused until decode)
    torch.testing.assert_close(l_ref, l_fp8, rtol=1e-5, atol=1e-5)
    # decode: top-1 agreement + bounded drift (fp8 is lossy by design)
    assert (d_ref.argmax(-1) == d_fp8.argmax(-1)).float().mean() >= 0.5
    assert torch.isfinite(d_fp8).all()

    jm = JModel(jcfg.replace(kv_cache_dtype="float8_e4m3fn"))
    _, jc = jax.jit(jm.prefill)(jparams, {"inputs": jnp.asarray(inputs, jnp.int32)})
    pad = ((0, 0), (0, 0), (0, CACHE - PROMPT), (0, 0), (0, 0))
    jc = {k: jnp.pad(v, pad) for k, v in jc.items()}
    jd, _ = jax.jit(jm.decode_step)(jparams, jc, jnp.asarray(tok.numpy(), jnp.int32), PROMPT)
    _close(d_fp8, jd, **TOL["bfloat16"])


def _jax_template(cfg) -> dict:
    from repro.models.model import build_template

    leaves, _ = jax.tree_util.tree_flatten_with_path(
        build_template(cfg), is_leaf=lambda x: isinstance(x, JParamSpec)
    )
    return {_path_str(path): (tuple(spec.shape), spec.init, spec.scale) for path, spec in leaves}


@pytest.mark.parametrize("arch", DENSE)
def test_template_matches_jax_at_full_width(arch):
    """Same dotted paths, shapes and initializers as the JAX template, built
    on the meta device (no storage), and the same param_count."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    model = Model(cfg, device="meta")
    abstract = dict(tree_items(model.abstract_params()))
    want = _jax_template(jcfg)
    assert list(abstract) == list(want)  # also JAX's leaf order
    for path, t in abstract.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == want[path][0], path
        spec = dict(tree_items(model.template))[path]
        assert (spec.init, spec.scale) == want[path][1:], path
    assert cfg.param_count() == jcfg.param_count()
    cache = model.abstract_cache(4, 1024)
    jcache = JModel(jcfg).abstract_cache(4, 1024)
    assert tuple(cache["k"].shape) == jcache["k"].shape and cache["k"].device.type == "meta"


def test_param_views_share_the_stacked_storage():
    """Layer l is a view of the stacked [L, ...] leaf, not a copy."""
    from repro_torch.models.transformer import layer_params

    cfg = get_smoke_config("chatglm3_6b")
    params = Model(cfg, device="cpu").init_params(seed=0)
    lp = layer_params(params["layers"], 1)
    assert lp["attn"]["wq"].data_ptr() == params["layers"]["attn"]["wq"][1].data_ptr()
    assert tuple(params["layers"]["attn"]["wq"].shape) == (cfg.n_layers, cfg.d_model, cfg.q_dim)
