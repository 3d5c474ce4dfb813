"""The port's M-RoPE and ``embeds_input`` path (qwen2-vl-2b: three position
streams over the rotary sections, the prompt given as precomputed
embeddings) against the JAX package on the CPU, and the registry.

Inputs come from numpy seeds; JAX parameters go across through
``repro_torch.convert.from_numpy_tree``.  The positions lay out an image in
a text as Qwen2-VL does: text tokens with all three streams equal, then a
grid of image tokens at one temporal position whose height and width
streams count its rows and columns, then text continuing past the grid's
largest position; three equal streams would not test the sections.  Where
the JAX side takes its Pallas branch it runs in interpret mode; the port
runs the kernels' plain versions.  Tolerances: 1e-5 in f32, 2e-2 in bf16
(tests/test_kernels.py:14); gradients 1e-4 of each leaf's largest
magnitude in f32 (tests/test_torch_train.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # beside the other test workers on the CPU

from repro.configs import ARCH_IDS as JARCH_IDS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.launch.serve import Server as JServer  # noqa: E402
from repro.models.layers import apply_rope as japply_rope  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.models.model import count_params_config as jcount  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import from_numpy_tree  # noqa: E402
from repro_torch.launch.serve import Server, main  # noqa: E402
from repro_torch.launch.steps import concrete_batch, loss_and_grads  # noqa: E402
from repro_torch.models.common import tree_items  # noqa: E402
from repro_torch.models.layers import apply_rope, rope_angles  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

ARCH = "qwen2_vl_2b"
TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
GRAD_TOL = 1e-4
B, S, MAX = 2, 128, 256


def _close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def image_positions(B: int, text: int, rows: int, cols: int, tail: int) -> np.ndarray:
    """[3, B, text + rows*cols + tail] int32 (t, h, w) positions: ``text``
    tokens at 0..text-1 in every stream, a rows x cols image at t = text,
    h = text + row, w = text + column, then ``tail`` text tokens from one
    past the image's largest position."""
    n = text + rows * cols + tail
    pos = np.zeros((3, n), np.int32)
    pos[:, :text] = np.arange(text)
    r, c = np.divmod(np.arange(rows * cols), cols)
    pos[0, text : text + rows * cols] = text
    pos[1, text : text + rows * cols] = text + r
    pos[2, text : text + rows * cols] = text + c
    start = text + max(rows, cols)
    pos[:, text + rows * cols :] = start + np.arange(tail)
    return np.broadcast_to(pos[:, None], (3, B, n)).copy()


def test_image_positions_layout():
    pos = image_positions(1, 64, 16, 24, 64)
    assert pos.shape == (3, 1, 512)
    assert (pos[:, 0, :64] == np.arange(64)).all()
    assert pos[0, 0, 64] == pos[0, 0, 447] == 64
    assert (pos[1, 0, 64], pos[2, 0, 64], pos[1, 0, 447], pos[2, 0, 447]) == (64, 64, 79, 87)
    assert (pos[:, 0, 448:] == 88 + np.arange(64)).all() and pos.max() == 151


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("head_dim", [16, 128])
def test_mrope_matches_jax(head_dim, dtype):
    """``rope_angles("mrope")`` + ``apply_rope`` against JAX's
    ``apply_rope("mrope")`` on q [B, S, H, hd] at three distinct streams;
    head_dim 128 is qwen2-vl's (sections 16, 24, 24 of the half)."""
    pos = image_positions(B, 8, 4, 6, 8)  # 40 positions, three streams apart
    n = pos.shape[-1]
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    x = np.random.RandomState(0).randn(B, n, 4, head_dim).astype(np.float32)
    want = japply_rope("mrope", jnp.asarray(x, jdt), jnp.asarray(pos), 1_000_000.0)
    angles = rope_angles("mrope", torch.from_numpy(pos), head_dim, 1_000_000.0)
    assert angles[0].shape == (B, n, 1, head_dim // 2)
    got = apply_rope(torch.from_numpy(x).to(tdt), angles)
    assert got.dtype == tdt
    _close(got, want, **TOL[dtype])
    # the streams matter: the text layout (all streams equal) rotates otherwise
    same = rope_angles("mrope", torch.from_numpy(np.broadcast_to(pos[:1], pos.shape).copy()),
                       head_dim, 1_000_000.0)
    assert not torch.equal(apply_rope(torch.from_numpy(x).to(tdt), same), got)


def _configs(**kw):
    return jget_smoke(ARCH).replace(**kw), get_smoke_config(ARCH).replace(**kw)


def _batch(cfg, seed: int = 0) -> dict:
    """A prompt of S precomputed embeddings at the image layout's positions,
    with tokens beside them (which JAX's server reads for B and S)."""
    rng = np.random.RandomState(seed)
    return {"inputs": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "targets": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "embeds": (0.02 * rng.randn(B, S, cfg.d_model)).astype(np.float32),
            "positions": image_positions(B, 32, 8, 8, 32)}


def _torch_batch(batch: dict, keys=("inputs", "targets", "embeds", "positions")) -> dict:
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in batch.items() if k in keys}


def _params(jcfg, seed: int = 0):
    jparams = JModel(jcfg).init_params(jax.random.PRNGKey(seed))
    return jparams, from_numpy_tree(jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_matches_jax(dtype, impl):
    """qwen2vl-smoke prefilled from ``embeds`` at the image layout's
    positions, against JAX's jitted ``prefill`` (logits and cache), then 8
    teacher-forced decode steps (tokens through the embedding, rotated at
    their slot ``pos`` in all three streams, as JAX's decode does)."""
    jcfg, cfg = _configs(compute_dtype=dtype, attn_impl=impl)
    jparams, params = _params(jcfg)
    batch = _batch(cfg)
    tol = TOL[dtype]
    jm = JModel(jcfg)
    jl, jc = jax.jit(jm.prefill)(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    server = Server(cfg, device="cpu", max_len=MAX)
    logits, cache = server.prefill_fn(params, _torch_batch(batch, ("embeds", "positions")))
    assert logits.shape == (B, 1, cfg.vocab_size)
    assert set(cache) == set(jc) == {"k", "v"}
    for key in cache:
        _close(cache[key], jc[key], **tol)
    jc = JServer(jcfg, max_len=MAX)._pad_cache(dict(jc), S)
    cache = server._pad_cache(cache)
    jstep = jax.jit(jm.decode_step)
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size, (B, 8))
    for i in range(8):
        _close(logits, jl, **tol)
        tok = toks[:, i : i + 1]
        logits, cache = server.decode_fn(params, cache, torch.from_numpy(tok).long(), S + i)
        jl, jc = jstep(jparams, jc, jnp.asarray(tok, jnp.int32), S + i)
    _close(logits, jl, **tol)
    for key in cache:
        _close(cache[key], jc[key], **tol)


def test_prefill_without_positions_uses_the_text_layout():
    """Without ``positions`` the streams are 0..S-1 each, as in JAX; with
    no ``embeds`` the tokens are embedded."""
    jcfg, cfg = _configs(compute_dtype="float32")
    jparams, params = _params(jcfg)
    batch = _batch(cfg)
    jm, model = JModel(jcfg), Model(cfg, device="cpu")
    for keys in (("embeds",), ("inputs",)):
        jl, _ = jax.jit(jm.prefill)(jparams, {k: jnp.asarray(batch[k]) for k in keys})
        logits, _ = model.prefill(params, _torch_batch(batch, keys))
        _close(logits, jl, **TOL["float32"])


def test_decode_at_a_device_position_is_bitwise_the_int_form():
    cfg = get_smoke_config(ARCH).replace(compute_dtype="bfloat16", attn_impl="pallas")
    model = Model(cfg, device="cpu")
    params = model.compute_params(model.init_params(seed=0))
    server = Server(cfg, device="cpu", max_len=MAX)
    _, cache = server.prefill_fn(params, _torch_batch(_batch(cfg), ("embeds", "positions")))
    cache = server._pad_cache(cache)
    other = {k: v.clone() for k, v in cache.items()}
    tok = torch.full((B, 1), 3, dtype=torch.int64)
    for i in range(3):
        a, cache = server.decode_fn(params, cache, tok, S + i)
        b, other = server.decode_fn(params, other, tok, torch.tensor(S + i))
        assert torch.equal(a, b)
    assert all(torch.equal(cache[k], other[k]) for k in cache)


def test_generate_matches_jax_tokens():
    """Greedy tokens of the port's Server, given only the embeddings and
    their positions, equal JAX's (whose server reads B and S from the
    tokens beside them) at f32 compute, kernel branch."""
    jcfg, cfg = _configs(compute_dtype="float32", attn_impl="pallas")
    jparams, params = _params(jcfg)
    batch = _batch(cfg, seed=2)
    want = np.asarray(JServer(jcfg, max_len=MAX).generate(
        jparams, {k: jnp.asarray(v) for k, v in batch.items() if k != "targets"}, 8))
    server = Server(cfg, device="cpu", max_len=MAX)
    got = server.generate(params, _torch_batch(batch, ("embeds", "positions")), 8)
    assert got.shape == (B, 8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_loss_and_grads_match_jax():
    """Twin of tests/test_arch_smoke.py::test_smoke_train_step for
    qwen2vl-smoke with embeddings and image positions: the loss and every
    gradient leaf against ``jax.value_and_grad`` (f32, the kernel branch;
    the unread token embedding's gradient is zero on both sides)."""
    jcfg, cfg = _configs(compute_dtype="float32", attn_impl="pallas")
    jparams, params = _params(jcfg, seed=1)
    batch = _batch(cfg, seed=1)
    jloss, jgrads = jax.value_and_grad(JModel(jcfg).loss_fn)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = loss_and_grads(Model(cfg, device="cpu"), params, _torch_batch(batch))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = {p: np.asarray(g, np.float32) for p, g in
            ((".".join(str(k.key) for k in path), g)
             for path, g in jax.tree_util.tree_flatten_with_path(jgrads)[0])}
    got = {p: g.float().numpy() for p, g in tree_items(grads)}
    assert got.keys() == want.keys()
    assert not got["embed"].any() and not want["embed"].any()
    tree_max = max(np.abs(w).max() for w in want.values())
    for path, w in want.items():
        # the key bias's gradient is zero in exact arithmetic (softmax is
        # invariant to it): held to the tree's largest magnitude
        scale = tree_max if path == "layers.attn.bk" else np.abs(w).max()
        assert np.abs(got[path] - w).max() <= GRAD_TOL * max(scale, 1e-30), path


def test_full_config_template_cache_and_param_count():
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff,
            cfg.vocab_size, cfg.rope, cfg.rope_theta, cfg.embeds_input) == \
        (28, 1536, 12, 2, 128, 8960, 151936, "mrope", 1e6, True)
    model = Model(cfg, device="meta")
    abstract = {p: tuple(t.shape) for p, t in tree_items(model.abstract_params())}
    jabstract = jax.tree_util.tree_flatten_with_path(JModel(jcfg).abstract_params())[0]
    assert abstract == {".".join(str(p.key) for p in path): tuple(a.shape)
                        for path, a in jabstract}
    assert cfg.param_count() == jcount(jcfg) == 1_777_481_216
    cache = model.abstract_cache(4, 1024)
    jcache = JModel(jcfg).abstract_cache(4, 1024)
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: tuple(v.shape) for k, v in jcache.items()} == \
        {"k": (28, 4, 1024, 2, 128), "v": (28, 4, 1024, 2, 128)}


def _records(plan) -> dict:
    return {r.path: (tuple(r.shape), r.nbytes, r.collection, r.branch_dependent)
            for r in plan.records}


def _group_sizes(plan) -> list[int]:
    sizes, last = [], None
    for r in plan.ordered():
        if sizes and r.first_use == last:
            sizes[-1] += 1
        else:
            sizes.append(1)
        last = r.first_use
    return sizes


@pytest.mark.parametrize("full", [False, True])
def test_decode_plan_matches_jax(full):
    get, jget = (get_config, jget_config) if full else (get_smoke_config, jget_smoke)
    max_len = 1024 if full else 64
    plan = Server(get(ARCH), device="cpu", max_len=max_len).plan(4)
    jplan = JServer(jget(ARCH), max_len=max_len).plan(4)
    assert _records(plan) == _records(jplan)
    assert _group_sizes(plan) == _group_sizes(jplan) == [1, 12, 1, 1]
    assert [r.path for r in plan.ordered()][0] == "embed"
    assert (len(plan.records), len(plan.collections())) == (15, 12)
    if full:
        assert plan.total_bytes == jplan.total_bytes == 7_109_924_864


def test_concrete_batch_has_embeddings_and_positions():
    cfg = get_smoke_config(ARCH)
    batch = concrete_batch(cfg, 3, 8, device="cpu")
    assert batch["embeds"].shape == (3, 8, cfg.d_model)
    assert batch["embeds"].dtype == torch.float32
    assert batch["positions"].shape == (3, 3, 8)
    assert torch.equal(batch["positions"][2, 1], torch.arange(8))
    assert Model(cfg, device="cpu").prompt_shape({"embeds": batch["embeds"]}) == (3, 8)


def test_registry_holds_jax_architectures_in_order():
    """The port's registry is JAX's: the ten architectures in its order,
    each full and smoke config field for field."""
    assert ARCH_IDS == JARCH_IDS
    for arch in ARCH_IDS:
        assert vars(get_config(arch)) == vars(jget_config(arch)), arch
        assert vars(get_smoke_config(arch)) == vars(jget_smoke(arch)), arch


def test_serve_cli_on_cpu(capsys):
    main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
          "--prompt-len", "128", "--gen", "4", "--attn-impl", "pallas"])
    out = capsys.readouterr().out
    assert "generated (2, 4) tokens" in out and "on cpu" in out
    assert "access plan: 15 records, 12 collections" in out
