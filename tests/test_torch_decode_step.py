"""The decode step at a device position, on the CPU: the half of the
captured decode step (``launch.steps.CapturedDecode``) that runs without a
card.

A decode loop driven by a 0-d tensor ``pos`` gives the int-``pos`` loop's
logits and caches bit for bit (dense on the flash-decode route and the
plain one, both moe smoke configs, ssm, hybrid with its ring wrapping), and
JAX's jitted
``Model.decode_step`` with ``pos`` a traced int32, from the same weights
(``repro_torch.convert``) and numpy-seeded tokens.  The hybrid is held
against JAX only after a prompt at least its window long: after a shorter
one JAX's decode is wrong (repro/launch/serve.py:60-69), so there the
tensor path is held against the int path alone.  Flash-decode's op and
plain version take a tensor ``kv_len``; the launch counters' bookkeeping
for graph replays; the server's host check of ``max_len``.  Tolerances:
1e-5 at f32, 2e-2 at bf16 (tests/test_kernels.py:14), logits relative to
the largest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # beside the other test workers on the CPU

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.launch.serve import Server as JServer  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import from_numpy_tree  # noqa: E402
from repro_torch.kernels import counters, ops, ref  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention_fwd, device_kv_len  # noqa: E402
from repro_torch.launch.serve import Server  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
B, STEPS = 2, 10  # 10 steps take the hybrid's ring (window 8) round once more

# (arch, attn_impl, prompt, max_len): the dense cache at 128 slots takes the
# flash-decode route (ops.decode_attention), at 40 the plain masked one
CASES = [
    ("chatglm3_6b", "pallas", 16, 128),
    ("chatglm3_6b", "naive", 16, 40),
    ("qwen3_moe_30b_a3b", "pallas", 16, 128),
    ("granite_moe_1b_a400m", "pallas", 16, 128),
    ("falcon_mamba_7b", "pallas", 16, 26),
    ("recurrentgemma_2b", "pallas", 16, 26),
]


def _setup(arch, impl, dtype, max_len):
    jcfg = jget_smoke(arch).replace(compute_dtype=dtype, attn_impl=impl)
    cfg = get_smoke_config(arch).replace(compute_dtype=dtype, attn_impl=impl)
    jparams = JModel(jcfg).init_params(jax.random.PRNGKey(0))
    params = from_numpy_tree(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, cfg, jparams, params, Server(cfg, device="cpu", max_len=max_len)


def _tokens(cfg, prompt):
    rng = np.random.RandomState(0)
    return (rng.randint(0, cfg.vocab_size, (B, prompt)),
            rng.randint(0, cfg.vocab_size, (B, STEPS)))


def _port_chain(server, params, inputs, forced, pos_of):
    """Prefill, then STEPS teacher-forced decode steps at ``pos_of(p)``:
    [(logits, cache)] after each step."""
    prompt = inputs.shape[1]
    logits, cache = server.prefill_fn(params, {"inputs": torch.from_numpy(inputs)})
    cache = server._pad_cache(cache)
    out = []
    for i in range(STEPS):
        logits, cache = server.decode_fn(params, cache, torch.from_numpy(forced[:, i : i + 1]),
                                         pos_of(prompt + i))
        out.append((logits, {k: v.clone() for k, v in cache.items()}))
    return out


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max() / np.abs(want).max())


@pytest.mark.parametrize("pos_dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("arch,impl,prompt,max_len", CASES + [
    ("recurrentgemma_2b", "pallas", 4, 14),  # a prompt shorter than the window
])
def test_device_pos_decode_is_bitwise_the_int_pos_decode(arch, impl, prompt, max_len,
                                                         pos_dtype):
    _, cfg, _, params, server = _setup(arch, impl, "float32", max_len)
    inputs, forced = _tokens(cfg, prompt)
    want = _port_chain(server, params, inputs, forced, lambda p: p)
    got = _port_chain(server, params, inputs, forced,
                      lambda p: torch.tensor(p, dtype=pos_dtype))
    for (logits, cache), (wl, wc) in zip(got, want):
        assert torch.equal(logits, wl)
        assert cache.keys() == wc.keys()
        for key in cache:
            assert torch.equal(cache[key], wc[key]), key


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,impl,prompt,max_len", CASES)
def test_device_pos_decode_matches_jax_jitted_decode_step(arch, impl, prompt, max_len, dtype):
    """JAX's ``Model.decode_step`` under ``jax.jit`` with ``pos`` a traced
    int32 (the JAX server's compiled step), from its own padded cache."""
    jcfg, cfg, jparams, params, server = _setup(arch, impl, dtype, max_len)
    inputs, forced = _tokens(cfg, prompt)
    got = _port_chain(server, params, inputs, forced, lambda p: torch.tensor(p))
    jm = JModel(jcfg)
    _, jc = jax.jit(jm.prefill)(jparams, {"inputs": jnp.asarray(inputs, jnp.int32)})
    jc = JServer(jcfg, max_len=max_len)._pad_cache(jc, prompt)
    jstep = jax.jit(jm.decode_step)
    for i, (logits, _) in enumerate(got):
        jl, jc = jstep(jparams, jc, jnp.asarray(forced[:, i : i + 1], jnp.int32),
                       jnp.asarray(prompt + i, jnp.int32))
        assert logits.shape == (B, 1, cfg.vocab_size)
        assert _rel(logits, jl) <= TOL[dtype], i


@pytest.mark.parametrize("kv_len", [1, 37, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_takes_a_tensor_kv_len(kv_len, dtype):
    """``ops.decode_attention`` and ``ref.decode_attention_ref`` give the int
    form's output for a 0-d or one-element int32 (or int64) ``kv_len``."""
    gen = torch.Generator().manual_seed(kv_len)
    q = torch.randn((2, 8, 32), generator=gen).to(dtype)
    k = torch.randn((2, 64, 2, 32), generator=gen).to(dtype)
    v = torch.randn((2, 64, 2, 32), generator=gen).to(dtype)
    want = ops.decode_attention(q, k, v, kv_len)
    assert torch.equal(want, ref.decode_attention_ref(q, k, v, kv_len))
    for t in (torch.tensor(kv_len, dtype=torch.int32), torch.tensor([kv_len], dtype=torch.int32),
              torch.tensor(kv_len)):
        assert torch.equal(ops.decode_attention(q, k, v, t), want)
        assert torch.equal(ref.decode_attention_ref(q, k, v, t), want)


def test_device_kv_len_checks_what_the_host_can_see():
    """An int is range-checked and written to the device; a tensor is
    checked for shape, dtype and device only (its value is never read)."""
    cpu = torch.device("cpu")
    t = device_kv_len(17, 64, cpu)
    assert t.dtype == torch.int32 and t.shape == (1,) and int(t) == 17
    for bad in (0, 65):
        with pytest.raises(ValueError, match="outside"):
            device_kv_len(bad, 64, cpu)
    for bad in (torch.tensor(3), torch.tensor([3, 4], dtype=torch.int32)):
        with pytest.raises(ValueError, match="one int32"):
            device_kv_len(bad, 64, cpu)
    with pytest.raises(ValueError, match="lies on"):
        device_kv_len(torch.tensor(3, dtype=torch.int32), 64, torch.device("meta"))
    big = torch.tensor(1000, dtype=torch.int32)  # past S: left to the kernel's clamp
    assert device_kv_len(big, 64, cpu) is big


def test_launch_counts_of_a_capture_move_with_its_replays():
    """What a capture counted is taken back once and added per replay."""
    dec = decode_attention_fwd
    before = counters.snapshot()
    dec.launches += 3  # what running the wrappers under a capture does
    dec.launches_mma += 3
    counters.rglru_gated_fwd.launches += 2
    delta = counters.since(before)
    assert delta == {(dec, "launches"): 3, (dec, "launches_mma"): 3,
                     (counters.rglru_gated_fwd, "launches"): 2}
    counters.add(delta, -1)
    assert counters.snapshot() == before
    for _ in range(4):  # four replays
        counters.add(delta)
    assert counters.since(before) == {k: 4 * n for k, n in delta.items()}
    counters.add(delta, -4)
    assert counters.snapshot() == before


def test_every_counted_wrapper_is_in_the_bookkeeping():
    import importlib
    import pkgutil

    import repro_torch.kernels as pkg

    found = set()
    for m in pkgutil.iter_modules(pkg.__path__):
        mod = importlib.import_module(f"repro_torch.kernels.{m.name}")
        found |= {f for f in vars(mod).values() if callable(f) and hasattr(f, "launches")}
    assert found == set(counters.WRAPPERS)
    assert all(isinstance(n, int) for n in counters.snapshot().values())


def test_generate_on_the_cpu_is_the_eager_loop():
    cfg = get_smoke_config("chatglm3_6b").replace(compute_dtype="float32", attn_impl="pallas")
    server = Server(cfg, device="cpu", max_len=128)
    params = server.model.init_params(seed=0)
    inputs = torch.from_numpy(np.random.RandomState(1).randint(0, cfg.vocab_size, (B, 16)))
    tokens, logits = server.generate(params, {"inputs": inputs}, 5, with_logits=True)
    want_tokens, want_logits = server.generate_eager(params, {"inputs": inputs}, 5,
                                                     with_logits=True)
    assert tokens.shape == (B, 5) and logits.shape == (B, 5, cfg.vocab_size)
    assert torch.equal(tokens, want_tokens) and torch.equal(logits, want_logits)
    assert torch.equal(tokens, logits.argmax(-1))
    assert torch.equal(server.generate(params, {"inputs": inputs}, 5), tokens)
    assert not server._captured  # nothing is captured off the card


def test_captured_generate_checks_max_len_on_the_host(monkeypatch):
    """On the card the cache is written at a device position, which the
    host cannot check at each step: ``generate`` refuses a prompt and a
    length that overrun ``max_len`` before it touches the device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    server = Server(get_smoke_config("chatglm3_6b"), device="cuda", max_len=20)
    with pytest.raises(ValueError, match="max_len=20"):
        server.generate({}, {"inputs": torch.zeros((B, 16), dtype=torch.int64)}, 6)
