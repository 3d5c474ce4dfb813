"""The port's recurrent families (ssm: falcon-mamba-7b; hybrid:
recurrentgemma-2b) against the JAX package on the CPU.

The two scan ops against JAX's (the Pallas kernels in interpret mode) over
the sweeps of tests/test_kernels.py:118-172; the scans' initial and final
states, the conv, both blocks and the full smoke models (prefill, cache, a
three-step decode chain, greedy serving) against JAX's model functions;
the hybrid's ring window with prompts longer and shorter than the window.
Parameters come from JAX's ``Model.init_params`` through
``repro_torch.convert``; inputs from numpy seeds.  Tolerances: 1e-5 at f32,
2e-2 at bf16 (tests/test_kernels.py:14), logits relative to the largest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # beside the other test workers on the CPU

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.kernels import ops as jops
from repro.launch.serve import Server as JServer
from repro.models import rglru as jrglru
from repro.models import ssm as jssm
from repro.models.model import Model as JModel
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import from_numpy_tree
from repro_torch.kernels import ops
from repro_torch.launch.serve import Server
from repro_torch.models import rglru, ssm
from repro_torch.models.common import tree_items
from repro_torch.models.model import Model

RECURRENT = ["falcon_mamba_7b", "recurrentgemma_2b"]
TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
B, PROMPT, STEPS = 2, 16, 3


def _pair(a, dtype="float32"):
    """The same values as a JAX array and a CPU tensor, rounded to dtype."""
    j = jnp.asarray(np.asarray(a, np.float32), DT[dtype][0])
    return j, from_numpy_tree({"x": np.asarray(j)}, device="cpu")["x"]


def _close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# the scan ops against JAX's (tests/test_kernels.py:118-172)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("Bn,S,W", [(1, 128, 256), (2, 64, 128), (3, 256, 384)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_scan_op_matches_jax(Bn, S, W, dtype):
    rng = np.random.RandomState(4)
    ja, a = _pair(rng.uniform(0.5, 0.99, size=(Bn, S, W)), dtype)
    jg, g = _pair(0.1 * rng.randn(Bn, S, W), dtype)
    want = jops.rglru_scan(ja, jg, block_s=32, block_m=128)
    got = ops.rglru_scan(a, g)
    assert got.dtype == DT[dtype][1] and got.shape == (Bn, S, W)
    _close(got, want, **TOL[dtype])


@pytest.mark.parametrize("s", [1, 2, 17])
def test_rglru_zero_decay_returns_input(s):
    """a == 0 -> h_t == g_t exactly (tests/test_kernels.py:136)."""
    g = torch.from_numpy(np.random.RandomState(s).randn(1, s, 128).astype(np.float32))
    assert torch.equal(ops.rglru_scan(torch.zeros_like(g), g), g)


@pytest.mark.parametrize("Bn,S,C,N", [(1, 64, 256, 16), (2, 32, 128, 8), (1, 128, 512, 4)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_scan_op_matches_jax(Bn, S, C, N, dtype):
    rng = np.random.RandomState(5)
    jdA, dA = _pair(rng.uniform(0.3, 0.99, size=(Bn, S, C, N)), dtype)
    jdBu, dBu = _pair(0.1 * rng.randn(Bn, S, C, N), dtype)
    jC, Cm = _pair(rng.randn(Bn, S, N), dtype)
    want = jops.mamba_scan(jdA, jdBu, jC, block_s=16, block_c=64)
    got = ops.mamba_scan(dA, dBu, Cm)
    assert got.dtype == DT[dtype][1] and got.shape == (Bn, S, C)
    _close(got, want, **TOL[dtype])


def test_mamba_single_step_is_dbu_dot_c():
    """S == 1 from h0 = 0: y = dBu . C (tests/test_kernels.py:160)."""
    rng = np.random.RandomState(7)
    dA, dBu = (torch.from_numpy(rng.rand(1, 1, 128, 8).astype(np.float32)) for _ in range(2))
    Cm = torch.from_numpy(rng.randn(1, 1, 8).astype(np.float32))
    want = np.einsum("cn,n->c", dBu[0, 0].numpy(), Cm[0, 0].numpy())
    np.testing.assert_allclose(ops.mamba_scan(dA, dBu, Cm)[0, 0].numpy(), want,
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the model functions: states, conv, blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("with_h0", [False, True])
def test_selective_scan_states_match_jax(kernel, with_h0):
    """y and the last state from an initial state (or zeros) against JAX's
    ``selective_scan``: without ``kernel`` through the model's plain loop;
    with it through ``ops.selective_scan``'s dispatch by device (its plain
    version here), and also through the TPU kernel's materialised contract
    (``ops.mamba_scan`` over dA = exp(dt A) and dBu = (dt u) B formed from
    the same inputs, plus D u), which no model path runs any more."""
    rng = np.random.RandomState(8)
    Bn, S, C, N = 2, 12, 48, 16
    ju, u = _pair(rng.randn(Bn, S, C))
    jdt, dt = _pair(np.log1p(np.exp(rng.randn(Bn, S, C))))
    jA, A = _pair(-np.exp(rng.randn(C, N) * 0.5))
    jB, Bs = _pair(rng.randn(Bn, S, N))
    jC, Cs = _pair(rng.randn(Bn, S, N))
    jD, D = _pair(rng.randn(C))
    jh0, h0 = _pair(rng.randn(Bn, C, N)) if with_h0 else (None, None)
    want_y, want_h = jssm.selective_scan(ju, jdt, jA, jB, jC, jD, h0=jh0)
    if kernel:
        dA = torch.exp(dt[..., None] * A)
        dBu = (dt * u)[..., None] * Bs[:, :, None, :]
        ym, hm = ops.mamba_scan(dA, dBu, Cs, h0, with_state=True)
        _close(ym + D * u, want_y, **TOL["float32"])
        _close(hm, want_h, **TOL["float32"])
    y, h = ssm.selective_scan(u, dt, A, Bs, Cs, D, h0=h0, kernel=kernel)
    _close(y, want_y, **TOL["float32"])
    _close(h, want_h, **TOL["float32"])
    assert h.dtype == torch.float32 and h.shape == (Bn, C, N)
    assert with_h0 == (h is h0)  # a given state is the decode's cache: updated in place


@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_states_match_jax(kernel, with_h0):
    rng = np.random.RandomState(9)
    Bn, S, W = 2, 12, 64
    jx, x = _pair(rng.randn(Bn, S, W))
    jr, r = _pair(1 / (1 + np.exp(-rng.randn(Bn, S, W))))
    ji, i = _pair(1 / (1 + np.exp(-rng.randn(Bn, S, W))))
    jlam, lam = _pair(rng.randn(W))
    jh0, h0 = _pair(rng.randn(Bn, W)) if with_h0 else (None, None)
    want_y, want_h = jrglru.rglru_scan(jx, jr, ji, jlam, h0=jh0)
    y, h = rglru.rglru_scan(x, r, i, lam, h0=h0, kernel=kernel)
    _close(y, want_y, **TOL["float32"])
    _close(h, want_h, **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_depthwise_causal_conv_matches_jax(dtype, with_state):
    rng = np.random.RandomState(10)
    jx, x = _pair(rng.randn(2, 5, 24), dtype)
    jw, w = _pair(rng.randn(24, 4))
    jb, b = _pair(rng.randn(24))
    js, st = _pair(rng.randn(2, 3, 24), dtype) if with_state else (None, None)
    want_y, want_s = jssm.depthwise_causal_conv(jx, jw, jb, js)
    y, s = ssm.depthwise_causal_conv(x, w, b, st)
    assert y.dtype == DT[dtype][1] and s.shape == (2, 3, 24)
    _close(y, want_y, **TOL[dtype])
    _close(s, want_s, **TOL[dtype])


def _smoke(arch, **kw):
    """(JAX config, port config, JAX params, the same params as tensors)."""
    jcfg, cfg = jget_smoke(arch).replace(**kw), get_smoke_config(arch).replace(**kw)
    jparams = JModel(jcfg).init_params(jax.random.PRNGKey(0))
    return jcfg, cfg, jparams, from_numpy_tree(jax.tree.map(np.asarray, jparams), device="cpu")


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", RECURRENT)
def test_blocks_match_jax_with_and_without_states(arch, dtype):
    """``mamba_block`` and ``recurrent_block`` of layer 0, first over a
    prompt (no states), then one step from the states that left."""
    jcfg, cfg, jparams, params = _smoke(arch, compute_dtype=dtype)
    jdt, tdt = DT[dtype]
    key = "layers" if cfg.family == "ssm" else "rec_layers"
    sub = "mamba" if cfg.family == "ssm" else "rec"
    jp = _layer0(jparams[key])[sub]
    tp = {k: v[0] for k, v in params[key][sub].items()}
    jblock, block = ((jssm.mamba_block, ssm.mamba_block) if cfg.family == "ssm"
                     else (jrglru.recurrent_block, rglru.recurrent_block))
    rng = np.random.RandomState(11)
    jx, x = _pair(rng.randn(B, PROMPT, cfg.d_model), dtype)
    jout = jblock(jx, jp, jcfg, jdt)
    out = block(x, tp, cfg, tdt)
    for got, want in zip(out, jout):
        _close(got, want, **TOL[dtype])
    jx1, x1 = _pair(rng.randn(B, 1, cfg.d_model), dtype)
    jout = jblock(jx1, jp, jcfg, jdt, jout[1], jout[2])
    out = block(x1, tp, cfg, tdt, out[1], out[2])
    for got, want in zip(out, jout):
        _close(got, want, **TOL[dtype])


# ---------------------------------------------------------------------------
# the full smoke models
# ---------------------------------------------------------------------------


def _decode_chain(jcfg, cfg, jparams, params, prompt):
    """Prefill ``prompt`` tokens, then STEPS teacher-forced decode steps,
    in both packages: [(port logits, port cache, JAX logits, JAX cache)]."""
    rng = np.random.RandomState(0)
    inputs = rng.randint(0, cfg.vocab_size, (B, prompt))
    forced = rng.randint(0, cfg.vocab_size, (B, STEPS))
    jm = JModel(jcfg)
    jl, jc = jax.jit(jm.prefill)(jparams, {"inputs": jnp.asarray(inputs, jnp.int32)})
    server = Server(cfg, device="cpu", max_len=prompt + STEPS)
    logits, cache = server.prefill_fn(params, {"inputs": torch.from_numpy(inputs)})
    out = [(logits, {k: v.clone() for k, v in cache.items()}, jl, jc)]
    cache = server._pad_cache(cache)
    jstep = jax.jit(jm.decode_step)
    for i in range(STEPS):
        tok = forced[:, i : i + 1]
        jl, jc = jstep(jparams, jc, jnp.asarray(tok, jnp.int32), prompt + i)
        logits, cache = server.decode_fn(params, cache, torch.from_numpy(tok), prompt + i)
        out.append((logits, {k: v.clone() for k, v in cache.items()}, jl, jc))
    return out, np.concatenate([inputs, forced], axis=1), server


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", RECURRENT)
def test_prefill_cache_and_decode_match_jax(arch, dtype):
    """Prefill logits and cache, then three decode steps (a prompt longer
    than the hybrid's window of 8), within the tolerance of the largest
    logit; the caches element for element."""
    jcfg, cfg, jparams, params = _smoke(arch, compute_dtype=dtype, attn_impl="pallas")
    chain, _, _ = _decode_chain(jcfg, cfg, jparams, params, PROMPT)
    (l0, c0, _, jc0) = chain[0]
    assert l0.shape == (B, 1, cfg.vocab_size) and l0.dtype == torch.float32
    assert sorted(c0) == sorted(jc0)
    tol = TOL[dtype]["atol"]
    for logits, cache, jl, jc in chain:
        assert _rel(logits, jl) <= tol
        # the cache as the step leaves it; the ring is compared over the
        # slots both hold (JAX's ring after a prompt >= W has W slots too)
        for key, want in jc.items():
            assert tuple(cache[key].shape) == want.shape, key
            assert cache[key].dtype == DT[str(want.dtype)][1], key
            _close(cache[key], want, **TOL[dtype])


@pytest.mark.parametrize("arch", RECURRENT)
def test_smoke_prefill_then_decode(arch):
    """Twin of tests/test_arch_smoke.py:49: shapes, no NaNs, the cache's
    structure kept by a decode step."""
    cfg = get_smoke_config(arch).replace(attn_impl="chunked", attn_chunk=8, remat="none")
    model = Model(cfg, device="cpu")
    params = model.init_params(seed=1)
    gen = torch.Generator().manual_seed(1)
    inputs = torch.randint(0, cfg.vocab_size, (B, PROMPT), generator=gen)
    with torch.inference_mode():
        logits, cache = model.prefill(params, {"inputs": inputs})
        assert logits.shape == (B, 1, cfg.vocab_size) and torch.isfinite(logits).all()
        shapes = {k: (tuple(v.shape), v.dtype) for k, v in cache.items()}
        tok = torch.argmax(logits, dim=-1)
        logits2, cache2 = model.decode_step(params, cache, tok, PROMPT)
    assert logits2.shape == (B, 1, cfg.vocab_size) and torch.isfinite(logits2).all()
    assert {k: (tuple(v.shape), v.dtype) for k, v in cache2.items()} == shapes


@pytest.mark.parametrize("arch", RECURRENT)
def test_generate_matches_jax_tokens(arch):
    """Greedy tokens of the port's Server equal JAX's in f32 (the hybrid
    with a prompt longer than its window, where JAX's decode is right)."""
    jcfg, cfg, jparams, params = _smoke(arch, compute_dtype="float32", attn_impl="pallas")
    inputs = np.random.RandomState(3).randint(0, cfg.vocab_size, (B, PROMPT))
    want = JServer(jcfg, max_len=PROMPT + 6).generate(
        jparams, {"inputs": jnp.asarray(inputs, jnp.int32)}, 6)
    got = Server(cfg, device="cpu", max_len=PROMPT + 6).generate(
        params, {"inputs": torch.from_numpy(inputs)}, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_hybrid_ring_with_prompts_longer_and_shorter_than_the_window():
    """rg-smoke (window 8) in f32.  Prompt 16 >= window: the port's decode
    equals JAX's.  Prompt 4 < window: the port pads its ring to
    min(window, max_len) slots, and its decode equals a full prefill of the
    same tokens, in the port and in JAX; JAX's decode does not, since its
    server leaves the ring at 4 slots and its write at slot pos % 8 is
    clamped onto the last prompt key (repro/models/model.py:343-354,
    repro/launch/serve.py:60-69)."""
    jcfg, cfg, jparams, params = _smoke("recurrentgemma_2b", compute_dtype="float32",
                                        attn_impl="pallas")
    chain, _, _ = _decode_chain(jcfg, cfg, jparams, params, 16)
    for logits, _, jl, _ in chain:
        assert _rel(logits, jl) <= 1e-5

    chain, tokens, server = _decode_chain(jcfg, cfg, jparams, params, 4)
    assert tuple(chain[1][1]["k"].shape)[2] == min(cfg.local_window, 4 + STEPS)
    jm = JModel(jcfg)
    jax_decode_err = []
    for i, (logits, _, jl, _) in enumerate(chain[1:]):
        upto = torch.from_numpy(tokens[:, : 4 + i + 1])
        full, _ = server.prefill_fn(params, {"inputs": upto})
        jfull, _ = jax.jit(jm.prefill)(jparams, {"inputs": jnp.asarray(upto.numpy(), jnp.int32)})
        assert _rel(logits, full.numpy()) <= 1e-5
        assert _rel(logits, jfull) <= 1e-5
        jax_decode_err.append(_rel(torch.from_numpy(np.array(jl)), jfull))
    assert min(jax_decode_err) > 0.05, jax_decode_err  # the reference's fault


# ---------------------------------------------------------------------------
# templates, caches and parameters at full width (abstract)
# ---------------------------------------------------------------------------


def _jax_template(cfg) -> dict:
    from repro.core.access_plan import _path_str
    from repro.models.common import ParamSpec as JParamSpec
    from repro.models.model import build_template

    leaves, _ = jax.tree_util.tree_flatten_with_path(
        build_template(cfg), is_leaf=lambda x: isinstance(x, JParamSpec))
    return {_path_str(path): (tuple(spec.shape), spec.init, spec.scale) for path, spec in leaves}


@pytest.mark.parametrize("arch", RECURRENT)
def test_template_and_cache_match_jax_at_full_width(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    model = Model(cfg, device="meta")
    want = _jax_template(jcfg)
    got = {p: (tuple(s.shape), s.init, s.scale) for p, s in tree_items(model.template)}
    assert list(got) == list(want) and got == want
    assert cfg.param_count() == jcfg.param_count()
    for seq in (512, 4096):
        cache = model.abstract_cache(4, seq)
        jcache = JModel(jcfg).abstract_cache(4, seq)
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in cache.items()} == \
            {k: (v.shape, str(v.dtype)) for k, v in jcache.items()}


def test_compute_params_keep_the_f32_decay_parameters():
    """A_log, D (mamba) and lam (RG-LRU) are read in f32 by both packages;
    ``compute_params`` leaves them in f32 and casts the matmul weights."""
    for arch, keep in (("falcon_mamba_7b", ("layers.mamba.A_log", "layers.mamba.D")),
                       ("recurrentgemma_2b", ("rec_layers.rec.lam",))):
        model = Model(get_smoke_config(arch), device="cpu")
        cast = dict(tree_items(model.compute_params(model.init_params(seed=0))))
        for path in keep:
            assert cast[path].dtype == torch.float32, path
        assert cast["embed"].dtype == torch.bfloat16


def test_scan_wrappers_refuse_cpu_tensors_and_ops_count_no_launch():
    """The CUDA scan wrappers take CUDA tensors only; ``ops`` runs the plain
    versions for CPU tensors, which launch nothing."""
    from repro_torch.kernels.mamba_scan import mamba_scan_fwd
    from repro_torch.kernels.rglru_scan import rglru_scan_fwd

    before = (mamba_scan_fwd.launches, rglru_scan_fwd.launches)
    x = torch.rand(2, 3, 8, 4)
    with pytest.raises(ValueError, match="CUDA"):
        mamba_scan_fwd(x, x, x[..., 0, :])
    with pytest.raises(ValueError, match="CUDA"):
        rglru_scan_fwd(x[..., 0], x[..., 0])
    y, h = ops.mamba_scan(x, x, x[..., 0, :], with_state=True)
    assert y.shape == (2, 3, 8) and h.shape == (2, 8, 4)
    assert ops.rglru_scan(x[..., 0], x[..., 0]).shape == (2, 3, 8)
    assert (mamba_scan_fwd.launches, rglru_scan_fwd.launches) == before
