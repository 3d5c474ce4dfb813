"""The port's encoder-decoder family (whisper-large-v3: ``forward_encoder``,
``forward_decoder``, ``decode_stack`` with cross-attention, the sinusoidal
embedding) against the JAX package on the CPU.

Inputs come from numpy seeds; JAX parameters go across through
``repro_torch.convert.from_numpy_tree``.  Where the JAX side takes its
Pallas branch (``attn_impl="pallas"``) it runs in interpret mode, as the
JAX tests run it; the port runs the kernels' plain versions.  Tolerances:
1e-5 in f32, 2e-2 in bf16 (tests/test_kernels.py:14).
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
from repro.models.layers import sinusoidal_embedding as jsinusoidal  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.models.model import count_params_config as jcount  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import from_numpy_tree  # noqa: E402
from repro_torch.launch.serve import Server, main  # noqa: E402
from repro_torch.launch.steps import concrete_batch, loss_and_grads  # noqa: E402
from repro_torch.models.common import tree_items  # noqa: E402
from repro_torch.models.layers import sinusoidal_embedding  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

ARCH = "whisper_large_v3"
TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
B, S, MAX = 2, 128, 256


def _close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def _configs(**kw):
    return jget_smoke(ARCH).replace(**kw), get_smoke_config(ARCH).replace(**kw)


def _batch(cfg, seed: int = 0) -> dict:
    """Token prompt [B, S] and audio frames [B, enc_positions, d] (numpy)."""
    rng = np.random.RandomState(seed)
    return {"inputs": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "frames": (0.02 * rng.randn(B, cfg.enc_positions, cfg.d_model)).astype(np.float32)}


def _torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in batch.items()}


def _params(jcfg, seed: int = 0):
    jparams = JModel(jcfg).init_params(jax.random.PRNGKey(seed))
    return jparams, from_numpy_tree(jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.mark.parametrize("d_model", [1280, 64])
def test_sinusoidal_embedding_matches_jax(d_model):
    """Positions 0..1499 (whisper's frames).  The angle p * f is an f32
    number whose last place is 1.2e-4 at p >= 1024, and XLA's exp and
    torch's round some of the frequencies f to neighbouring f32 values (43
    of 640 at d 1280; JAX's own jitted and eager ladders differ in 198), so
    each row is held within 1e-5 plus two units in the last place of its
    largest angle; the frequencies themselves within 1e-5 (row 1)."""
    pos = np.arange(1500)
    want = np.asarray(jsinusoidal(jnp.asarray(pos)[None], d_model))[0]
    got = sinusoidal_embedding(torch.from_numpy(pos)[None], d_model)[0]
    assert got.dtype == torch.float32 and tuple(got.shape) == (1500, d_model)
    _close(got[:2], want[:2], **TOL["float32"])
    err = np.abs(got.numpy() - want).max(axis=1)
    limit = 1e-5 + 2 * np.spacing(pos.astype(np.float32))
    assert (err <= limit).all(), (err - limit).max()


def test_sinusoidal_embedding_reads_a_device_position():
    """The decode step's position as a 0-d tensor (what a captured step
    replays) gives the int position's embedding bit for bit."""
    from repro_torch.models.transformer import step_positions

    for p in (0, 17, 255):
        a = sinusoidal_embedding(step_positions(torch.tensor(p), (1, 1), "cpu"), 64)
        b = sinusoidal_embedding(step_positions(p, (1, 1), "cpu"), 64)
        assert a.shape == (1, 1, 64) and torch.equal(a, b)


@pytest.mark.parametrize("enc_positions", [16, 256])
@pytest.mark.parametrize("impl", ["chunked", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_matches_jax(dtype, impl, enc_positions):
    """Twin of tests/test_arch_smoke.py::test_smoke_prefill_then_decode on
    whisper-smoke against JAX's jitted ``prefill`` and ``decode_step``: the
    prefill logits and all four caches (self and cross k/v), then 8
    teacher-forced decode steps.  At 256 frames the encoder (256 x 256) and
    the prefill's cross-attention (128 x 256, not causal) take the flash
    branch on both sides with ``pallas``; at 16 they take the chunked path."""
    jcfg, cfg = _configs(compute_dtype=dtype, attn_impl=impl, enc_positions=enc_positions)
    jparams, params = _params(jcfg)
    batch = _batch(cfg)
    tol = TOL[dtype]
    jm = JModel(jcfg)
    jl, jc = jax.jit(jm.prefill)(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    server = Server(cfg, device="cpu", max_len=MAX)
    logits, cache = server.prefill_fn(params, _torch_batch(batch))
    assert logits.shape == (B, 1, cfg.vocab_size)
    assert set(cache) == set(jc) == {"k", "v", "cross_k", "cross_v"}
    for key in cache:
        assert cache[key].dtype == server.model.kv_dtype()
        assert tuple(cache[key].shape) == tuple(jc[key].shape)
        _close(cache[key], jc[key], **tol)
    jc = JServer(jcfg, max_len=MAX)._pad_cache(dict(jc), S)
    cache = server._pad_cache(cache)
    assert tuple(cache["k"].shape) == tuple(jc["k"].shape) == (cfg.n_layers, B, MAX, 4, 16)
    assert tuple(cache["cross_k"].shape) == (cfg.n_layers, B, enc_positions, 4, 16)
    jstep = jax.jit(jm.decode_step)
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size, (B, 8))
    for i in range(8):
        _close(logits, jl, **tol)
        tok = toks[:, i : i + 1]
        logits, cache = server.decode_fn(params, cache, torch.from_numpy(tok).long(), S + i)
        jl, jc = jstep(jparams, jc, jnp.asarray(tok, jnp.int32), S + i)
        assert bool(torch.isfinite(logits).all())
    _close(logits, jl, **tol)
    for key in cache:
        _close(cache[key], jc[key], **tol)


def test_decode_at_a_device_position_is_bitwise_the_int_form():
    """The encdec step at a 0-d tensor ``pos`` (the captured step's) equals
    the step at the int ``pos`` bit for bit, logits and caches."""
    cfg = get_smoke_config(ARCH).replace(compute_dtype="bfloat16", attn_impl="pallas")
    model = Model(cfg, device="cpu")
    params = model.compute_params(model.init_params(seed=0))
    server = Server(cfg, device="cpu", max_len=MAX)
    _, cache = server.prefill_fn(params, _torch_batch(_batch(cfg)))
    cache = server._pad_cache(cache)
    other = {k: v.clone() for k, v in cache.items()}
    tok = torch.full((B, 1), 5, dtype=torch.int64)
    for i in range(3):
        a, cache = server.decode_fn(params, cache, tok, S + i)
        b, other = server.decode_fn(params, other, tok, torch.tensor(S + i))
        assert torch.equal(a, b)
    for k in cache:
        assert torch.equal(cache[k], other[k]), k


def test_generate_matches_jax_tokens():
    """Greedy tokens of the port's Server equal JAX's on whisper-smoke at
    f32 compute, kernel branch (plain versions on the CPU), with the
    encoder and cross-attention on the flash branch (256 frames)."""
    jcfg, cfg = _configs(compute_dtype="float32", attn_impl="pallas", enc_positions=256)
    jparams, params = _params(jcfg)
    batch = _batch(cfg, seed=2)
    want = np.asarray(JServer(jcfg, max_len=MAX).generate(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, 8))
    server = Server(cfg, device="cpu", max_len=MAX)
    got = server.generate(params, _torch_batch(batch), 8)
    assert got.shape == (B, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    cast = server.generate(server.model.compute_params(params), _torch_batch(batch), 8)
    torch.testing.assert_close(cast, got)


def test_full_config_template_cache_and_param_count():
    """whisper-large-v3 at full size, abstract (no allocation): the
    template's paths and shapes, ``abstract_cache`` and the parameter
    count equal JAX's."""
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    assert (cfg.n_layers, cfg.enc_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.enc_positions) == \
        (32, 32, 1280, 20, 20, 64, 5120, 51866, 1500)
    model = Model(cfg, device="meta")
    abstract = {p: tuple(t.shape) for p, t in tree_items(model.abstract_params())}
    jabstract = jax.tree_util.tree_flatten_with_path(JModel(jcfg).abstract_params())[0]
    assert abstract == {".".join(str(p.key) for p in path): tuple(a.shape)
                        for path, a in jabstract}
    assert "dec_layers.cross.bq" not in abstract and "dec_layers.cross.bo" not in abstract
    assert abstract["dec_layers.attn.bq"] == (32, 1280)
    assert cfg.param_count() == jcount(jcfg) == 1_535_677_440
    cache = model.abstract_cache(4, 256)
    jcache = JModel(jcfg).abstract_cache(4, 256)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in cache.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in jcache.items()}
    assert tuple(cache["cross_k"].shape) == (32, 4, 1500, 20, 64)


def test_compute_params_keeps_the_norms_in_f32():
    """``compute_params`` casts the projections to bf16 and leaves every
    norm parameter (the cross-attention's ``lnc`` and the encoder's final
    ``enc_norm`` too) in f32."""
    model = Model(get_smoke_config(ARCH), device="cpu")
    params = model.init_params(seed=0)
    cp = dict(tree_items(model.compute_params(params)))
    for path in ("dec_layers.lnc", "dec_layers.lnc_b", "enc_norm", "enc_norm_b",
                 "enc_layers.ln1", "dec_layers.ln2_b", "final_norm_b"):
        assert cp[path].dtype == torch.float32, path
    for path in ("dec_layers.cross.wq", "enc_layers.attn.bq", "embed"):
        assert cp[path].dtype == torch.bfloat16, path


def _records(plan) -> dict:
    return {r.path: (tuple(r.shape), r.nbytes, r.collection, r.branch_dependent)
            for r in plan.records}


def _groups(plan) -> list[set]:
    """Records of equal first use, in first-use order (the streamer's
    groups; tests/test_torch_access_plan.py)."""
    out, last = [], None
    for r in plan.ordered():
        if out and r.first_use == last:
            out[-1].add(r.path)
        else:
            out.append({r.path})
        last = r.first_use
    return out


@pytest.mark.parametrize("full", [False, True])
def test_decode_plan_matches_jax(full):
    """The access plan of one decode step equals JAX's: 25 records (the
    embedding, which is also the tied head; the 22 decoder leaves, a
    collection each; the final norm's scale and bias), 4 groups of sizes
    [1, 22, 1, 1]; the encoder's parameters are not read by a decode step."""
    get, jget = (get_config, jget_config) if full else (get_smoke_config, jget_smoke)
    max_len = 256 if full else 64
    plan = Server(get(ARCH), device="cpu", max_len=max_len).plan(4)
    jplan = JServer(jget(ARCH), max_len=max_len).plan(4)
    assert _records(plan) == _records(jplan)
    assert _groups(plan) == _groups(jplan)
    assert (len(plan.records), len(plan.collections())) == (25, 22)
    assert [len(g) for g in _groups(plan)] == [1, 22, 1, 1]
    assert not any(r.path.startswith("enc_") for r in plan.records)
    if full:
        assert plan.total_bytes == jplan.total_bytes == 3_623_987_200


def test_training_refuses_encdec():
    """whisper-smoke trains: ``loss_and_grads`` at 256 frames with
    ``attn_impl="pallas"`` (the encoder, the decoder's self-attention and
    the cross-attention on the flash branch, forward and backward: JAX's
    Pallas kernels in interpret mode, the port's plain trainable path)
    against ``jax.value_and_grad`` in f32; the key biases, whose gradient is
    zero in exact arithmetic, against the tree's largest gradient."""
    jcfg, cfg = _configs(compute_dtype="float32", attn_impl="pallas", enc_positions=256)
    jparams, params = _params(jcfg)
    batch = _batch(cfg)
    batch["targets"] = np.roll(batch["inputs"], -1, axis=1)
    jloss, jgrads = jax.jit(jax.value_and_grad(JModel(jcfg).loss_fn))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = loss_and_grads(Model(cfg, device="cpu"), params, _torch_batch(batch))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = {p: np.asarray(g, np.float32) for p, g in tree_items(jax.tree.map(np.asarray, jgrads))}
    got = dict(tree_items(grads))
    assert got.keys() == want.keys()
    tree_max = max(np.abs(w).max() for w in want.values())
    for path, w in want.items():
        scale = tree_max if path.endswith("attn.bk") else np.abs(w).max()
        err = np.abs(got[path].numpy() - w).max()
        assert err <= 1e-4 * scale, (path, err, scale)


def test_stream_decode_refuses_encdec():
    server = Server(get_smoke_config(ARCH), device="cpu", max_len=64)
    with pytest.raises(NotImplementedError, match="section 1, item 5.8"):
        server.stream_decode(None, {}, torch.zeros((2, 1), dtype=torch.int64), 8)


def test_concrete_batch_has_the_audio_frames():
    cfg = get_smoke_config(ARCH)
    batch = concrete_batch(cfg, 3, 8, device="cpu")
    assert batch["frames"].shape == (3, cfg.enc_positions, cfg.d_model)
    assert batch["frames"].dtype == torch.float32
    assert 0.01 < float(batch["frames"].std()) < 0.03
    assert set(batch) == {"inputs", "targets", "frames"}


def test_serve_cli_on_cpu(capsys):
    main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
          "--prompt-len", "128", "--gen", "4", "--attn-impl", "pallas"])
    out = capsys.readouterr().out
    assert "generated (2, 4) tokens" in out and "on cpu" in out
    assert "access plan: 25 records, 22 collections" in out
    assert "  hint: embed\n" in out
