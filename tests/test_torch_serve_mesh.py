"""Sharded serving on the CPU, against the JAX package on the same inputs:

  * flash-decode's plain version with its log-sum-exp
    (``decode_attention_ref(with_lse=True)``): the output against JAX's
    ``decode_attention_ref``, the lse against ``logsumexp`` of JAX's scaled,
    masked f32 scores; two halves of a cache (one of them empty) merged by
    ``models.layers.merge_partials`` against JAX over the whole cache;
  * ``Server(mesh=)`` on a 2x2 gloo mesh (chatglm3's and qwen3-moe's smoke
    configs, f32, ``attn_impl="pallas"``, a 256-slot cache whose 128-slot
    shards take flash-decode's route): a prompt of 120 and 16 greedy tokens,
    so the ``model``-1 shard starts empty and fills during the run, against
    JAX's unsharded prefill and ``decode_step`` on each data shard's rows
    (the MoE EP path routes a data shard's tokens under their own capacity,
    as JAX's does);
  * ``Server`` on a 1x1 mesh bitwise the unsharded ``Server``, f32 and bf16;
  * the families a mesh of several ranks does not serve yet (item 6.2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # beside the other test workers on the CPU

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch.serve import Server  # noqa: E402
from repro_torch.launch.spawn import run_ranks  # noqa: E402
from repro_torch.models.layers import merge_partials  # noqa: E402
import torch_mesh_ranks  # noqa: E402

TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ARCHS = ("chatglm3_6b", "qwen3_moe_30b_a3b")  # a dense model; the MoE EP path
MESH = (2, 2)
B, PROMPT, STEPS, MAX_LEN = 4, 120, 16, 256  # positions 120..134 cross the shards' 128
TIMEOUT = 240.0


def _qkv(B, S, H, KV, D, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, H, D).astype(np.float32), rng.randn(B, S, KV, D).astype(np.float32),
            rng.randn(B, S, KV, D).astype(np.float32))


def _jax_lse(q, k, kv_len):
    """logsumexp of JAX's scaled, masked f32 scores (its oracle's), [B, H]."""
    B, H, D = q.shape
    KV = k.shape[2]
    q5 = q.reshape(B, KV, H // KV, D)
    s = jnp.einsum("bkgd,bskd->bkgs", q5, k, preferred_element_type=jnp.float32) / (D**0.5)
    mask = jnp.arange(k.shape[1])[None, None, None, :] < kv_len
    return jax.nn.logsumexp(jnp.where(mask, s, -1e30), axis=-1).reshape(B, H)


def _both(a, dtype):
    t = torch.from_numpy(a).to(TORCH_DTYPES[dtype])
    return jnp.asarray(t.float().numpy()).astype(dtype), t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_len", [1, 37, 128, 256, "per_row"])
def test_decode_attention_ref_lse_matches_jax(dtype, kv_len):
    q, k, v = _qkv(3, 256, 8, 2, 64, seed=5)
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, dtype) for a in (q, k, v))
    if kv_len == "per_row":
        lens = np.array([1, 100, 256], np.int32)
        kv_t, kv_j = torch.from_numpy(lens), jnp.asarray(lens)[:, None, None, None]
    else:
        kv_t = kv_j = kv_len
    o, lse = ref.decode_attention_ref(qt, kt, vt, kv_t, with_lse=True)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (3, 8)
    assert torch.equal(o, ref.decode_attention_ref(qt, kt, vt, kv_t))
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(jref.decode_attention_ref(qj, kj, vj, kv_j), np.float32),
                               **TOL[dtype])
    np.testing.assert_allclose(lse.numpy(), np.asarray(_jax_lse(qj, kj, kv_j)), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_len", [1, 100, 128, 129, 200, 256])
def test_merged_halves_match_jax_over_the_whole_cache(dtype, kv_len):
    """Two 128-slot halves of a 256-slot cache, each attended with its own
    live length (the second's ``kv_len - 128``, empty up to 128), merged,
    against JAX's oracle over the whole cache; in f32 at 1e-5, in bf16
    (each half's output rounded to bf16 before the merge) at 2e-2."""
    q, k, v = _qkv(2, 256, 8, 2, 64, seed=6)
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, dtype) for a in (q, k, v))
    parts = [ref.decode_attention_ref(qt, kt[:, h:h + 128], vt[:, h:h + 128], kv_len - h,
                                      with_lse=True) for h in (0, 128)]
    if kv_len <= 128:
        assert float(parts[1][1].max()) <= -1e29
    got = merge_partials(torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts]),
                         qt.dtype)
    assert got.dtype == qt.dtype
    want = np.asarray(jref.decode_attention_ref(qj, kj, vj, kv_len), np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])


def test_an_empty_part_weighs_exactly_nothing():
    """A part with no live key (lse -1e30) gets merge weight 0: merging it
    with another part gives that part bitwise, with no NaN from its
    output, whatever it holds."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 64, 4, 4, 32, seed=7))
    o, lse = ref.decode_attention_ref(q, k, v, 40, with_lse=True)
    eo, e_lse = ref.decode_attention_ref(q, k, v, 0, with_lse=True)
    assert float(e_lse.max()) <= -1e29
    for junk in (eo, torch.full_like(eo, 1e30)):
        got = merge_partials(torch.stack([junk, o]), torch.stack([e_lse, lse]), torch.float32)
        assert torch.equal(got, o)
    assert torch.equal(merge_partials(o[None], lse[None], torch.float32), o)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _inputs(arch, seed=0):
    cfg = jget_smoke(arch).replace(compute_dtype="float32", attn_impl="pallas")
    params = _np(JModel(cfg).init_params(jax.random.PRNGKey(seed)))
    prompt = np.random.RandomState(2).randint(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    return cfg, params, prompt


def _jax_generate(cfg, params, prompt):
    """JAX's unsharded prefill, then greedy ``decode_step``s on a cache
    padded to MAX_LEN slots: (tokens [b, STEPS], logits [b, STEPS, vocab])."""
    model = JModel(cfg)
    logits, cache = jax.jit(model.prefill)(params, {"inputs": jnp.asarray(prompt)})
    S = prompt.shape[1]
    cache = jax.tree.map(
        lambda c: jnp.pad(c, [(0, 0), (0, 0), (0, MAX_LEN - S), (0, 0), (0, 0)]), cache)
    step = jax.jit(model.decode_step)
    toks, outs = [], []
    for i in range(STEPS):
        if i:
            logits, cache = step(params, cache, tok, S + i - 1)
        tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        toks.append(np.asarray(tok))
        outs.append(np.asarray(logits))
    return np.concatenate(toks, 1), np.concatenate(outs, 1)


CLI = ["--arch", "chatglm3_6b", "--smoke", "--device", "cpu", "--batch", "4", "--prompt-len",
       "128", "--gen", "8", "--attn-impl", "pallas"]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    cases = [("server", arch, MESH, _inputs(arch)[1], _inputs(arch)[2], MAX_LEN, STEPS,
              "float32") for arch in ARCHS]
    cases.append(("serve_cli", CLI + ["--mesh", "2x2"]))
    out = run_ranks(torch_mesh_ranks.suite, MESH[0] * MESH[1], cases, timeout=TIMEOUT,
                    store_dir=tmp_path_factory.mktemp("store"))[0]
    return dict(zip(ARCHS + ("cli",), out))


@pytest.mark.parametrize("arch", ARCHS)
def test_server_on_a_mesh_matches_jax(served, arch):
    """The cache's 256 slots lie 128 a ``model`` rank; the prompt fills
    119 of rank 0's, the decode writes positions 120..134, so rank 1's
    shard is empty for the first 8 steps and merges with rank 0's after."""
    assert PROMPT < MAX_LEN // MESH[1] < PROMPT + STEPS - 1
    cfg, params, prompt = _inputs(arch)
    tokens, logits = served[arch]
    assert tokens.shape == (B, STEPS) and logits.shape == (B, STEPS, cfg.vocab_size)
    p = jax.tree.map(jnp.asarray, params)
    half = B // MESH[0]
    shards = [_jax_generate(cfg, p, prompt[r * half:(r + 1) * half]) for r in range(MESH[0])]
    np.testing.assert_array_equal(tokens, np.concatenate([s[0] for s in shards]))
    np.testing.assert_allclose(logits, np.concatenate([s[1] for s in shards]), rtol=1e-5,
                               atol=1e-5)


def test_serve_cli_on_a_mesh(served, capsys):
    """``python -m repro_torch.launch.serve --mesh 2x2`` (each rank; under
    ``torchrun`` the process group comes from its environment): the plan
    and the greedy tokens of the unsharded CLI."""
    from repro_torch.launch.serve import main

    main(CLI)
    plain = capsys.readouterr().out
    printed = served["cli"]
    assert "mesh 2x2" in printed, printed
    sample = [line for line in printed.splitlines() if line.startswith("sample:")]
    assert sample and sample[0] in plain.splitlines(), (printed, plain)
    assert printed.splitlines()[0] == plain.splitlines()[0]  # the per-model plan


@pytest.fixture(scope="module")
def one_rank_served(tmp_path_factory):
    cases = [(arch, dtype, _inputs(arch)[1], _inputs(arch)[2][:2, :64])
             for arch in ARCHS for dtype in TORCH_DTYPES]
    return run_ranks(torch_mesh_ranks.server_one_rank, 1, cases, MAX_LEN, 6, timeout=TIMEOUT,
                     store_dir=tmp_path_factory.mktemp("store"))[0]


@pytest.mark.parametrize("dtype", list(TORCH_DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_mesh_server_is_the_unsharded_server_bitwise(one_rank_served, arch, dtype):
    (mtok, mlog), (utok, ulog) = one_rank_served[arch, dtype]
    np.testing.assert_array_equal(mtok, utok)
    np.testing.assert_array_equal(mlog, ulog)


class _Ranks:
    """A stand-in mesh of ``n`` ranks (the refusal reads its size only)."""

    def __init__(self, n):
        self.n = n

    def size(self, dim=None):
        return self.n


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "recurrentgemma_2b", "whisper_large_v3"])
def test_server_refuses_the_other_families_on_several_ranks(arch):
    """ssm, hybrid and encdec on a mesh of several ranks raise, naming item
    6.2; none is served unsharded in silence.  On one rank they serve as
    on no mesh."""
    cfg = get_smoke_config(arch)
    with pytest.raises(NotImplementedError, match="6.2"):
        Server(cfg, device="cpu", mesh=_Ranks(4))
    assert Server(cfg, device="cpu", mesh=_Ranks(1)).mesh is None
