"""Sharded serving on the CPU, against the JAX package on the same inputs:

  * flash-decode's plain version with its log-sum-exp
    (``decode_attention_ref(with_lse=True)``): the output against JAX's
    ``decode_attention_ref``, the lse against ``logsumexp`` of JAX's scaled,
    masked f32 scores; two halves of a cache (one of them empty) merged by
    ``models.layers.merge_partials`` against JAX over the whole cache; the
    same for the hybrid's ring: the plain masked attention with its lse on
    two ring halves, merged, against JAX's ``_masked_decode_attention`` over
    the whole ring, before, at and after the wrap;
  * ``Server(mesh=)`` on a 2x2 gloo mesh (f32, ``attn_impl="pallas"``)
    against JAX's unsharded prefill and ``decode_step`` on each data
    shard's rows: chatglm3's and qwen3-moe's smoke configs (a 256-slot
    cache whose 128-slot shards take flash-decode's route; a prompt of 120
    and 16 greedy tokens, so the ``model``-1 shard starts empty and fills
    during the run; the MoE EP path routes a data shard's tokens under their
    own capacity, as JAX's does), whisper's (the same self cache and
    prompt, the cross k/v over the encoder's frames), falcon-mamba's (the
    states split over ``model``) and recurrentgemma's (the states over
    ``model`` and its 8-slot ring 4 a ``model`` rank, a prompt of 12 so
    that the ring wraps before and during the decode);
  * the batch-1 ``long`` layout on the same mesh (falcon-mamba and
    recurrentgemma: the states over ``data`` and ``model``, the ring over
    ``data``) and on a (2, 2, 1) ("pod", "data", "model") mesh (the states
    over all three axes, the ring over ("pod", "data") taken as one
    flattened axis, pod-major, its 8 slots 2 a rank, wrapping), against
    JAX at batch 1;
  * ``to_decode_layout``'s cache on each rank, slot for slot, against its
    part of the prefill cache, and its refusals;
  * the serve CLI with ``--mesh 2x2`` printing the unsharded CLI's tokens;
  * ``Server`` on a 1x1 mesh bitwise the unsharded ``Server``, f32 and bf16,
    for every family.
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
from repro_torch.launch.spawn import run_ranks  # noqa: E402
from repro_torch.models.layers import merge_partials  # noqa: E402
import torch_mesh_ranks  # noqa: E402

TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# a dense model; the MoE EP path; then one of each other family
ARCHS = ("chatglm3_6b", "qwen3_moe_30b_a3b", "whisper_large_v3", "falcon_mamba_7b",
         "recurrentgemma_2b")
LONG = ("falcon_mamba_7b", "recurrentgemma_2b")  # the batch-1 layout: subquadratic families
MESH = (2, 2)
POD_MESH = (2, 2, 1)  # ("pod", "data", "model"): the multi-pod mesh's axes, at 4 ranks
B, PROMPT, STEPS, MAX_LEN = 4, 120, 16, 256  # positions 120..134 cross the shards' 128
# a prompt longer than recurrentgemma's 8-slot window (JAX's hybrid server
# does not pad its ring: a shorter prompt would leave it off its sound path)
SHORT = 12
TIMEOUT = 300.0


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


def _inputs(arch, seed=0, batch=B):
    """(JAX config, parameters, prompt batch of numpy arrays): ``PROMPT``
    tokens for the attention families, ``SHORT`` for the recurrent ones;
    encdec's audio ``frames`` too."""
    cfg = jget_smoke(arch).replace(compute_dtype="float32", attn_impl="pallas")
    params = _np(JModel(cfg).init_params(jax.random.PRNGKey(seed)))
    rng = np.random.RandomState(2)
    S = SHORT if cfg.family in ("ssm", "hybrid") else PROMPT
    prompt = {"inputs": rng.randint(0, cfg.vocab_size, (batch, S)).astype(np.int32)}
    if cfg.family == "encdec":
        prompt["frames"] = (0.02 * rng.randn(batch, cfg.enc_positions, cfg.d_model)
                            ).astype(np.float32)
    return cfg, params, prompt


def _rows(batch, lo, hi):
    return {k: v[lo:hi] for k, v in batch.items()}


def _jax_generate(cfg, params, batch):
    """JAX's unsharded prefill, then greedy ``decode_step``s: (tokens [b,
    STEPS], logits [b, STEPS, vocab]).  The self-attention cache (dense,
    moe, encdec) is padded to MAX_LEN slots, as JAX's server pads it; the
    hybrid's ring keeps its window, the states and cross k/v their
    shapes."""
    model = JModel(cfg)
    logits, cache = jax.jit(model.prefill)(params, jax.tree.map(jnp.asarray, batch))
    S = batch["inputs"].shape[1]
    if cfg.family in ("dense", "moe", "encdec"):
        pad = [(0, 0), (0, 0), (0, MAX_LEN - S), (0, 0), (0, 0)]
        cache = {k: jnp.pad(c, pad) if k in ("k", "v") else c for k, c in cache.items()}
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


CLI_ARCHS = ("chatglm3_6b", "falcon_mamba_7b")
CLI = {"chatglm3_6b": ["--arch", "chatglm3_6b", "--smoke", "--device", "cpu", "--batch", "4",
                       "--prompt-len", "128", "--gen", "8", "--attn-impl", "pallas"],
       "falcon_mamba_7b": ["--arch", "falcon_mamba_7b", "--smoke", "--device", "cpu",
                           "--batch", "4", "--prompt-len", "16", "--gen", "8", "--attn-impl",
                           "pallas"]}
LAYOUT_ARCHS = ("whisper_large_v3", "falcon_mamba_7b", "recurrentgemma_2b")


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """One 4-rank run for every multi-rank case of this file: {name: what
    rank 0 returned} (``decode_layout``: every rank's)."""
    names, cases = [], []
    for arch in ARCHS:
        _, params, batch = _inputs(arch)
        names.append(arch)
        cases.append(("server", arch, MESH, params, batch, MAX_LEN, STEPS, "float32"))
    for arch in LONG:
        _, params, batch = _inputs(arch, batch=1)
        for mesh, tag in ((MESH, "long"), (POD_MESH, "long_pod")):
            names.append((tag, arch))
            cases.append(("server", arch, mesh, params, batch, MAX_LEN, STEPS, "float32"))
    _, params, batch = _inputs("recurrentgemma_2b", batch=1)
    names.append("slots")
    cases.append(("long_slots", "recurrentgemma_2b", POD_MESH, params, batch, MAX_LEN))
    for arch in CLI_ARCHS:
        names.append(("cli", arch))
        cases.append(("serve_cli", CLI[arch] + ["--mesh", "2x2"]))
    for arch in LAYOUT_ARCHS:
        _, params, batch = _inputs(arch)
        names.append(("layout", arch))
        cases.append(("decode_layout", arch, MESH, params, batch, MAX_LEN))
    out = run_ranks(torch_mesh_ranks.suite, MESH[0] * MESH[1], cases, timeout=TIMEOUT,
                    store_dir=tmp_path_factory.mktemp("store"))
    got = dict(zip(names, out[0]))
    for i, name in enumerate(names):
        if name == "slots" or isinstance(name, tuple) and name[0] == "layout":
            got[name] = [rank[i] for rank in out]
    return got


@pytest.mark.parametrize("arch", ARCHS)
def test_server_on_a_mesh_matches_jax(served, arch):
    """The attention families' 256 slots lie 128 a ``model`` rank; the
    prompt fills 119 of rank 0's, the decode writes positions 120..134, so
    rank 1's shard is empty for the first 8 steps and merges with rank 0's
    after; each 128-slot shard takes flash-decode's route
    (``_kernel_route``: its plain version with lse on the CPU), whisper's
    self cache too.  recurrentgemma's 8-slot ring lies 4 a ``model`` rank;
    the prompt of 12 has wrapped it once and the decode (positions 12..26)
    wraps it twice more, every slot passing from one rank's half to the
    other's.  falcon-mamba's and recurrentgemma's states lie over
    ``model``."""
    from repro_torch.models.transformer import _kernel_route

    assert PROMPT < MAX_LEN // MESH[1] < PROMPT + STEPS - 1
    cfg, params, batch = _inputs(arch)
    shard = torch.empty((B, MAX_LEN // MESH[1], 1, 1), device="meta")
    assert _kernel_route(cfg, shard)
    if cfg.family == "hybrid":
        assert cfg.local_window < SHORT and SHORT + STEPS - 1 > 3 * cfg.local_window
    tokens, logits = served[arch]
    assert tokens.shape == (B, STEPS) and logits.shape == (B, STEPS, cfg.vocab_size)
    p = jax.tree.map(jnp.asarray, params)
    half = B // MESH[0]
    shards = [_jax_generate(cfg, p, _rows(batch, r * half, (r + 1) * half))
              for r in range(MESH[0])]
    np.testing.assert_array_equal(tokens, np.concatenate([s[0] for s in shards]))
    np.testing.assert_allclose(logits, np.concatenate([s[1] for s in shards]), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("arch", LONG)
def test_long_layout_at_batch_one_matches_jax(served, arch):
    """Batch 1 on the 2x2 mesh: the decode rules' ``long`` layout (states
    over ``data`` and ``model``, the ring's sequence over ``data``, heads
    whole), the prompt's rows whole in the prefill; and on the (2, 2, 1)
    pod mesh: the states over ("pod", "data", "model"), the ring's 8 slots
    over ("pod", "data"), 2 a rank, wrapped by the prompt of 12 and twice
    more by the decode; both against JAX at batch 1."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.shardings import PSpec, cache_pspecs, logical_rules

    mesh = _FakeMesh({"data": 2, "model": 2})
    pcfg = get_smoke_config(arch)
    rules = logical_rules(pcfg, ShapeConfig("d", "decode", MAX_LEN, 1), mesh)
    assert rules["batch"] is None and rules["ff"] == ("data", "model")
    specs = cache_pspecs(pcfg, ShapeConfig("d", "decode", MAX_LEN, 1), mesh)
    assert specs["conv"] == PSpec(None, None, None, ("data", "model"))
    if pcfg.family == "hybrid":
        assert specs["k"] == PSpec(None, None, "data", None, None)
    pod = _FakeMesh({"pod": 2, "data": 2, "model": 1})
    rules = logical_rules(pcfg, ShapeConfig("d", "decode", MAX_LEN, 1), pod)
    assert rules["batch"] is None and rules["ff"] == ("pod", "data", "model")
    specs = cache_pspecs(pcfg, ShapeConfig("d", "decode", MAX_LEN, 1), pod)
    if pcfg.family == "hybrid":
        assert specs["k"] == PSpec(None, None, ("pod", "data"), None, None)
        assert SHORT > pcfg.local_window and pcfg.local_window % 4 == 0
    cfg, params, batch = _inputs(arch, batch=1)
    want_tok, want_logits = _jax_generate(cfg, jax.tree.map(jnp.asarray, params), batch)
    for tag in ("long", "long_pod"):
        tokens, logits = served[tag, arch]
        np.testing.assert_array_equal(tokens, want_tok)
        np.testing.assert_allclose(logits, want_logits, rtol=1e-5, atol=1e-5)


def test_pod_mesh_ring_slots_are_pod_major(served):
    """On the (2, 2, 1) mesh the ring's sequence over ("pod", "data") is one
    flattened axis, pod-major: the rank at (pod p, data d) holds slots
    [r n, (r + 1) n) with r = 2 p + d, so (1, 0) holds [2n, 3n); the
    shards tile the whole ring.  Each shard is held bitwise against the
    slots of an unsharded ``Server``'s prefill cache on the same weights
    and prompt."""
    ranks = served["slots"]
    assert sorted(c for c, _, _ in ranks) == [(p, d, 0) for p in (0, 1) for d in (0, 1)]
    for (p, d, _), local, whole in ranks:
        n = local.shape[2]
        assert n * 4 == whole.shape[2] == get_smoke_config("recurrentgemma_2b").local_window
        r = 2 * p + d
        np.testing.assert_array_equal(local, whole[:, :, r * n:(r + 1) * n])
        assert np.abs(local).max() > 0  # the prompt of 12 filled every slot
    (_, local, whole), = [x for x in ranks if x[0] == (1, 0, 0)]
    np.testing.assert_array_equal(local, whole[:, :, 4:6])


@pytest.mark.parametrize("arch", LAYOUT_ARCHS)
def test_decode_layout_is_the_prefill_cache_slot_for_slot(served, arch):
    """On every rank each entry of ``to_decode_layout``'s cache is its part
    of the mesh's prefill cache (the self cache and the ring padded with
    zeros to the decode's slots), in ``cache_pspecs``' placements; a ring
    whose slots do not divide over ``model`` raises ``ValueError`` naming
    both; an int position past the cache's slots raises ``IndexError``
    on every rank (whisper), where a bound twice too wide let it pass and
    write nowhere."""
    keys = {"encdec": ("k", "v", "cross_k", "cross_v"), "ssm": ("conv", "ssm"),
            "hybrid": ("conv", "rec", "k", "v")}[get_smoke_config(arch).family]
    for rank in served["layout", arch]:
        assert all(rank[k] is True for k in keys), rank
        assert rank["odd_ring"] is (True if arch == "recurrentgemma_2b" else None), rank
        assert rank["outside"] is (True if arch == "whisper_large_v3" else None), rank


class _FakeMesh:
    """Shape-only stand-in (the rules read nothing else)."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.size = int(np.prod(list(shape.values())))


@pytest.mark.parametrize("arch", CLI_ARCHS)
def test_serve_cli_on_a_mesh(served, arch, capsys):
    """``python -m repro_torch.launch.serve --mesh 2x2`` (each rank; under
    ``torchrun`` the process group comes from its environment): the plan
    and the greedy tokens of the unsharded CLI."""
    from repro_torch.launch.serve import main

    main(CLI[arch])
    plain = capsys.readouterr().out
    printed = served["cli", arch]
    assert "mesh 2x2" in printed, printed
    sample = [line for line in printed.splitlines() if line.startswith("sample:")]
    assert sample and sample[0] in plain.splitlines(), (printed, plain)
    assert printed.splitlines()[0] == plain.splitlines()[0]  # the per-model plan


@pytest.fixture(scope="module")
def one_rank_served(tmp_path_factory):
    cases = []
    for arch in ARCHS:
        _, params, batch = _inputs(arch)
        S = 64 if "frames" in batch or batch["inputs"].shape[1] > SHORT else SHORT
        cases += [(arch, dtype, params, {k: v[:2, :S] if k == "inputs" else v[:2]
                                         for k, v in batch.items()})
                  for dtype in TORCH_DTYPES]
    return run_ranks(torch_mesh_ranks.server_one_rank, 1, cases, MAX_LEN, 6, timeout=TIMEOUT,
                     store_dir=tmp_path_factory.mktemp("store"))[0]


def test_kernel_wrappers_refuse_a_dtensor(one_rank_served):
    """The guard every kernel wrapper applies to its tensors on the card
    (the flash pair, flash-decode, the gather and the four scans) raises
    ``TypeError`` on a DTensor: the kernels take local shards, which the
    ``shard_map`` boundaries hand them."""
    assert one_rank_served["dtensor_refused"] is True


@pytest.mark.parametrize("dtype", list(TORCH_DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_mesh_server_is_the_unsharded_server_bitwise(one_rank_served, arch, dtype):
    (mtok, mlog), (utok, ulog) = one_rank_served[arch, dtype]
    np.testing.assert_array_equal(mtok, utok)
    np.testing.assert_array_equal(mlog, ulog)


def _ring_valid(pos, start, n, S, W):
    """JAX's ring mask (``_decode_attn``) for slots [start, start + n) of an
    S-slot ring at position ``pos``."""
    idx = np.arange(start, start + n)
    ring_pos = pos - ((pos % W - idx) % S)
    return (ring_pos >= 0) & (ring_pos >= pos - W + 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos", [2, 7, 8, 13])
def test_ring_halves_with_lse_merge_to_jax_over_the_whole_ring(dtype, pos):
    """recurrentgemma's 8-slot ring in two halves of 4 (the ``model``
    split): each half attended with the plain masked attention and its
    log-sum-exp under the mask of the absolute position each slot holds,
    merged by ``merge_partials``, against JAX's ``_masked_decode_attention``
    over the whole ring.  At position 2 the second half holds nothing
    valid (lse -1e30); 7 fills the ring, 8 and 13 have wrapped it.  f32
    at 1e-5, bf16 at 2e-2."""
    from repro.models.transformer import _masked_decode_attention as jmasked
    from repro_torch.models.transformer import _masked_decode_attention

    cfg = get_smoke_config("recurrentgemma_2b").replace(compute_dtype=dtype)
    W = S = cfg.local_window
    rng = np.random.RandomState(pos)
    q = rng.randn(3, 1, cfg.n_heads, cfg.head_dim).astype(np.float32)
    k, v = (rng.randn(3, S, cfg.n_kv_heads, cfg.head_dim).astype(np.float32) for _ in "kv")
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, dtype) for a in (q, k, v))
    parts = []
    for start in (0, S // 2):
        valid = torch.from_numpy(_ring_valid(pos, start, S // 2, S, W))
        o, lse = _masked_decode_attention(qt, kt[:, start:start + S // 2],
                                          vt[:, start:start + S // 2], valid, cfg,
                                          with_lse=True)
        assert o.dtype == qt.dtype and lse.dtype == torch.float32
        assert tuple(lse.shape) == (3, cfg.n_heads)
        if not bool(valid.any()):
            assert float(lse.max()) <= -1e29
        parts.append((o[:, 0], lse))
    assert (pos < S // 2) == (float(parts[1][1].max()) <= -1e29)
    got = merge_partials(torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts]),
                         qt.dtype)
    want = jmasked(qj, kj, vj, jnp.asarray(_ring_valid(pos, 0, S, S, W)), jget_smoke(
        "recurrentgemma_2b"))[:, 0]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **TOL[dtype])
