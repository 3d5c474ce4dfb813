"""The port's continuous batcher (``repro_torch.runtime.scheduler``) against
the JAX package's (``repro.runtime.scheduler``) on the CPU.

Parameters come from JAX's ``init_params`` through
``repro_torch.convert.from_numpy_tree``; prompts, tokens and caches from
numpy seeds.  The twins of the three JAX batcher tests
(tests/test_scheduler.py:40, :58, :77) give JAX's tokens in f32; the
per-slot decode step gives the logits and the cache of JAX's
``ContinuousBatcher._decode_step`` at mixed positions with a free slot
among them, on the plain masked route and the flash-decode route (its
plain version here), for the dense smoke configs (yi, chatglm3, qwen2-vl
with M-RoPE over token ids) and both moe ones, whose f32 expert choices
must be JAX's, free rows included.  Flash-decode's plain version and op
take a ``[B]`` ``kv_len``; the batcher refuses the families it does not
take, and CUDA where there is none.  Tolerances: 1e-5 at f32, 2e-2 at bf16
(tests/test_kernels.py:14), relative to the largest value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # beside the other test workers on the CPU

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.runtime.scheduler import ContinuousBatcher as JBatcher  # noqa: E402
from repro.runtime.scheduler import Request as JRequest  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import from_numpy_tree  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.decode_attention import device_kv_len  # noqa: E402
from repro_torch.launch.serve import Server  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.runtime.scheduler import ContinuousBatcher, Request  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(arch: str, dtype: str = "float32", impl: str = "chunked"):
    """(JAX model, JAX params, port model, port params) of the smoke config,
    the port's parameters JAX's, copied."""
    jcfg = jget_smoke(arch).replace(compute_dtype=dtype, attn_impl=impl)
    cfg = get_smoke_config(arch).replace(compute_dtype=dtype, attn_impl=impl)
    jmodel = JModel(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    params = from_numpy_tree(jax.tree.map(np.asarray, jparams), device="cpu")
    return jmodel, jparams, Model(cfg, device="cpu"), params


@pytest.fixture(scope="module")
def yi():
    return _pair("yi_34b")


def _run_both(yi, make_requests, batch_size: int, max_len: int):
    """Drain the same requests through JAX's batcher and the port's:
    (JAX's finished requests, the port's, the port's batcher)."""
    jmodel, jparams, model, params = yi
    jb = JBatcher(jmodel, jparams, batch_size=batch_size, max_len=max_len)
    for r in make_requests(JRequest):
        jb.submit(r)
    b = ContinuousBatcher(model, params, batch_size=batch_size, max_len=max_len, device="cpu")
    for r in make_requests(Request):
        b.submit(r)
    return jb.run_until_drained(), b.run_until_drained(), b


def _outputs(finished) -> dict:
    return {r.rid: r.output for r in finished}


def test_batcher_matches_sequential(yi):
    """Twin of test_scheduler.py:40: three prompts through two slots give
    the tokens of each prompt decoded alone (the port's ``Server``), and
    JAX's batcher's tokens."""
    _, _, model, params = yi
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, model.cfg.vocab_size, size=s).astype(np.int32) for s in (6, 9, 4)]
    n_new = 5
    jfin, fin, _ = _run_both(
        yi, lambda R: [R(rid=i, prompt=p, max_new_tokens=n_new) for i, p in enumerate(prompts)],
        batch_size=2, max_len=32)
    assert len(fin) == 3
    got = _outputs(fin)
    assert got == _outputs(jfin)
    server = Server(model.cfg, device="cpu", max_len=32)
    for i, p in enumerate(prompts):
        alone = server.generate_eager(params, {"inputs": torch.from_numpy(p[None]).long()}, n_new)
        assert got[i] == alone[0].tolist(), f"request {i}"


def test_batcher_slot_churn_more_requests_than_slots(yi):
    """Twin of test_scheduler.py:58: five requests through two slots."""
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, yi[2].cfg.vocab_size, size=5).astype(np.int32) for _ in range(5)]
    jfin, fin, b = _run_both(
        yi, lambda R: [R(rid=i, prompt=p, max_new_tokens=3 + (i % 3))
                       for i, p in enumerate(prompts)],
        batch_size=2, max_len=24)
    assert {r.rid for r in fin} == set(range(5))
    for r in fin:
        assert len(r.output) == r.max_new_tokens
    # continuous batching: total decode steps far below sequential sum
    assert b.steps < sum(r.max_new_tokens for r in fin)
    assert _outputs(fin) == _outputs(jfin)
    assert [r.rid for r in fin] == [r.rid for r in jfin]  # retired in JAX's order


def test_batcher_eos_stops_early(yi):
    """Twin of test_scheduler.py:77: a request stops at its EOS token."""
    _, _, model, params = yi
    rng = np.random.RandomState(2)
    prompt = rng.randint(0, model.cfg.vocab_size, size=6).astype(np.int32)
    probe = Request(rid=0, prompt=prompt, max_new_tokens=4)
    b1 = ContinuousBatcher(model, params, batch_size=1, max_len=24, device="cpu")
    b1.submit(probe)
    b1.run_until_drained()
    eos = probe.output[1]

    jfin, fin, _ = _run_both(
        yi, lambda R: [R(rid=1, prompt=prompt, max_new_tokens=10, eos_id=eos)],
        batch_size=1, max_len=24)
    req = fin[0]
    assert req.output[1] == eos
    assert len(req.output) == 2  # stopped at EOS, not max_new_tokens
    assert req.output == jfin[0].output


def test_batcher_retires_at_the_cache_end(yi):
    """A request retires once its slot reaches ``max_len - 1``
    (scheduler.py:182-191), as in JAX, before its ``max_new_tokens``."""
    rng = np.random.RandomState(3)
    prompt = rng.randint(0, yi[2].cfg.vocab_size, size=10).astype(np.int32)
    jfin, fin, _ = _run_both(yi, lambda R: [R(rid=0, prompt=prompt, max_new_tokens=50)],
                             batch_size=2, max_len=16)
    assert len(fin[0].output) == 16 - 1 - 10 + 1
    assert fin[0].output == jfin[0].output


# -- the per-slot decode step against JAX's _decode_step ----------------------

STEP_ARCHS = ["yi_34b", "chatglm3_6b", "qwen2_vl_2b", "qwen3_moe_30b_a3b",
              "granite_moe_1b_a400m"]
B, MAX_LEN, TICKS = 4, 128, 3  # 128 slots: the pallas route takes flash-decode
LENS0 = np.array([37, 0, 5, 90])  # slot 1 is free: token 0 at position 0
BUSY = LENS0 > 0


def _rel(got: torch.Tensor, want) -> float:
    w = np.asarray(jnp.asarray(want, jnp.float32))
    return float(np.abs(got.float().numpy() - w).max() / np.abs(w).max())


def _recorder(module, log: list):
    topk = module.router_topk

    def recording(*args, **kw):
        top_p, top_i = topk(*args, **kw)
        log.append(np.sort(np.asarray(top_i), axis=-1))
        return top_p, top_i

    return recording


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_slot_decode_step_matches_jax(arch, dtype, impl, monkeypatch):
    """TICKS teacher-forced ticks of the per-slot step from one cache at
    mixed positions (a free slot decoding token 0 at 0): each tick's logits
    and cache against JAX's ``_decode_step``, run op by op so that the moe
    configs' expert choices can be recorded: in f32 every router call must
    choose JAX's experts for every row."""
    jmodel, jparams, model, params = _pair(arch, dtype, impl)
    cfg = model.cfg
    rng = np.random.RandomState(7)
    shape = (cfg.n_layers, B, MAX_LEN, cfg.n_kv_heads, cfg.head_dim)
    live = np.arange(MAX_LEN)[None, :, None, None] < LENS0[:, None, None, None]
    kv = {key: (rng.randn(*shape) * live).astype(np.float32) for key in ("k", "v")}
    forced = rng.randint(0, cfg.vocab_size, (TICKS, B)) * BUSY
    jcache = {key: jnp.asarray(a, JDT[dtype]) for key, a in kv.items()}
    cache = {key: torch.from_numpy(a).to(TDT[dtype]) for key, a in kv.items()}
    jb = JBatcher(jmodel, jparams, batch_size=B, max_len=MAX_LEN)
    b = ContinuousBatcher(model, params, batch_size=B, max_len=MAX_LEN, device="cpu")
    jlog, log = [], []
    monkeypatch.setattr(jmoe, "router_topk", _recorder(jmoe, jlog))
    monkeypatch.setattr(moe, "router_topk", _recorder(moe, log))
    for t in range(TICKS):
        lens = (LENS0 + t) * BUSY
        tokens = forced[t][:, None]
        with jax.disable_jit():
            jlogits, jcache = jb._decode_step(jparams, jcache, jnp.asarray(tokens, jnp.int32),
                                              jnp.asarray(lens, jnp.int32))
        logits, cache = b._decode_step(params, cache, torch.from_numpy(tokens),
                                       torch.from_numpy(lens))
        assert logits.shape == (B, 1, cfg.vocab_size) and logits.dtype == torch.float32
        assert _rel(logits, jlogits) <= TOL[dtype], f"tick {t} logits"
        for key in ("k", "v"):
            assert _rel(cache[key], jcache[key]) <= TOL[dtype], f"tick {t} cache {key}"
    if cfg.family == "moe":
        assert len(log) == len(jlog) == TICKS * cfg.n_layers
        assert all(a.shape[0] == B for a in log)  # every row routed, the free one too
        if dtype == "float32":
            for i, (a, ja) in enumerate(zip(log, jlog)):
                assert np.array_equal(a, ja), f"router call {i}"


def test_slot_decode_step_takes_flash_decode_on_the_pallas_route(monkeypatch):
    """With ``attn_impl="pallas"`` and a cache of a multiple of 128 slots the
    step attends through ``ops.decode_attention`` with ``kv_len = lens + 1``
    as a [B] int32; otherwise through the masked einsum."""
    seen = []
    real = ops.decode_attention

    def spy(q, k, v, kv_len):
        seen.append(kv_len.clone())
        return real(q, k, v, kv_len)

    monkeypatch.setattr(ops, "decode_attention", spy)
    lens = torch.tensor([3, 0, 9, 1])
    tokens = torch.zeros((4, 1), dtype=torch.int64)
    for impl, max_len, n in (("pallas", 128, 2), ("pallas", 96, 0), ("chunked", 128, 0)):
        seen.clear()
        _, _, model, params = _pair("chatglm3_6b", "float32", impl)
        b = ContinuousBatcher(model, params, batch_size=4, max_len=max_len, device="cpu")
        with torch.inference_mode():  # the batcher's cache is an inference tensor
            b._decode_step(params, b.cache, tokens, lens)
        assert len(seen) == n
        for kv_len in seen:
            assert kv_len.dtype == torch.int32 and kv_len.tolist() == [4, 1, 10, 2]


def test_admission_writes_the_prompt_and_zeros_the_rest_of_the_row():
    """Admission copies the prefill's k/v into the slot's row and zeros the
    row past the prompt, whatever an earlier occupant left there."""
    _, _, model, params = _pair("chatglm3_6b")
    b = ContinuousBatcher(model, params, batch_size=2, max_len=32, device="cpu")
    with torch.inference_mode():  # the batcher's cache is an inference tensor
        for c in b.cache.values():
            c.fill_(float("nan"))
    prompt = np.arange(1, 8)
    b.submit(Request(rid=0, prompt=prompt, max_new_tokens=2))
    b._admit()
    _, cache1 = model.prefill(params, {"inputs": torch.from_numpy(prompt[None])})
    for key in ("k", "v"):
        assert torch.equal(b.cache[key][:, 0, :7], cache1[key][:, 0])
        assert not b.cache[key][:, 0, 7:].any()
        assert torch.isnan(b.cache[key][:, 1]).all()  # the free slot's row is untouched
    assert b.slots[0].pos == 7 and b.slots[0].generated == 1


@pytest.mark.parametrize("n", [0, 32, 40])
def test_submit_refuses_a_prompt_the_cache_cannot_take(yi, n):
    b = ContinuousBatcher(yi[2], yi[3], batch_size=1, max_len=32, device="cpu")
    with pytest.raises(ValueError, match="max_len=32"):
        b.submit(Request(rid=0, prompt=np.zeros(n, np.int32)))


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "recurrentgemma_2b", "whisper_large_v3"])
def test_batcher_refuses_other_families(arch):
    cfg = get_smoke_config(arch)
    model = Model(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match=cfg.family):
        ContinuousBatcher(model, {}, batch_size=2, max_len=32, device="cpu")


def test_batcher_raises_without_cuda_unless_given_the_cpu(yi, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousBatcher(yi[2], yi[3], batch_size=2, max_len=32)
    b = ContinuousBatcher(yi[2], yi[3], batch_size=2, max_len=32, device="cpu")
    assert b.cache["k"].device.type == "cpu" and b._graph is None


# -- flash-decode with a length per row ----------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_ref_takes_a_length_per_row(dtype):
    """``ref.decode_attention_ref`` with a [B] ``kv_len`` against JAX's
    oracle given it as [B, 1, 1, 1], lengths 1 to S; and the op."""
    rng = np.random.RandomState(5)
    Bq, S, H, KV, D = 5, 64, 8, 2, 32
    q, k, v = (rng.randn(*s).astype(np.float32) for s in ((Bq, H, D), (Bq, S, KV, D),
                                                          (Bq, S, KV, D)))
    lens = np.array([1, 17, 64, 33, 2], np.int32)
    jq, jk, jv = (jnp.asarray(a, JDT[dtype]) for a in (q, k, v))
    want = jref.decode_attention_ref(jq, jk, jv, jnp.asarray(lens)[:, None, None, None])
    tq, tk, tv = (torch.from_numpy(a).to(TDT[dtype]) for a in (q, k, v))
    got = ref.decode_attention_ref(tq, tk, tv, torch.from_numpy(lens))
    assert _rel(got, want) <= TOL[dtype]
    assert torch.equal(ops.decode_attention(tq, tk, tv, torch.from_numpy(lens)), got)
    for b in range(Bq):  # each row is the scalar form at its own length
        alone = ref.decode_attention_ref(tq[b : b + 1], tk[b : b + 1], tv[b : b + 1], int(lens[b]))
        assert torch.equal(got[b : b + 1], alone)


@pytest.mark.parametrize("L", [1, 20, 64])
def test_decode_attention_ref_per_row_at_one_length_is_the_scalar_form(L):
    gen = torch.Generator().manual_seed(L)
    q = torch.randn((3, 4, 16), generator=gen)
    k = torch.randn((3, 64, 2, 16), generator=gen)
    v = torch.randn((3, 64, 2, 16), generator=gen)
    lens = torch.full((3,), L, dtype=torch.int32)
    want = ref.decode_attention_ref(q, k, v, L)
    assert torch.equal(ref.decode_attention_ref(q, k, v, lens), want)


def test_device_kv_len_takes_a_length_per_row():
    """A [B] int32 is taken as it is where the batch has B rows; any other
    length, or another dtype, is refused."""
    cpu = torch.device("cpu")
    lens = torch.tensor([3, 9, 1], dtype=torch.int32)
    assert device_kv_len(lens, 64, cpu, B=3) is lens
    for bad in (lens, lens.long(), lens[:, None]):
        with pytest.raises(ValueError, match="one per batch row"):
            device_kv_len(bad, 64, cpu, B=4 if bad is lens else 3)
