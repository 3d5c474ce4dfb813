"""The port's server, entry points and weight conversion on the CPU."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # beside the other test workers on the CPU

from repro.configs import get_smoke_config as jget_smoke
from repro.launch.serve import Server as JServer
from repro_torch.configs import get_smoke_config
from repro_torch.convert import from_numpy_tree, to_tensor
from repro_torch.launch.serve import Server, main

SRC = str(Path(__file__).resolve().parents[1] / "src")


def test_generate_matches_jax_tokens():
    """Greedy tokens of the port's Server equal JAX's on the chatglm3 smoke
    config at f32 compute, kernel branch (plain versions on the CPU)."""
    jcfg = jget_smoke("chatglm3_6b").replace(compute_dtype="float32", attn_impl="pallas")
    cfg = get_smoke_config("chatglm3_6b").replace(compute_dtype="float32", attn_impl="pallas")
    jserver = JServer(jcfg, max_len=512)
    jparams = jserver.model.init_params(jax.random.PRNGKey(0))
    inputs = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 128))
    want = np.asarray(jserver.generate(jparams, {"inputs": jnp.asarray(inputs, jnp.int32)}, 8))

    server = Server(cfg, device="cpu", max_len=512)
    params = from_numpy_tree(jax.tree.map(np.asarray, jparams), device="cpu")
    got = server.generate(params, {"inputs": torch.from_numpy(inputs)}, 8)
    assert got.shape == (2, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    # serving from compute-dtype params gives the same tokens
    cast = server.generate(server.model.compute_params(params),
                           {"inputs": torch.from_numpy(inputs)}, 8)
    torch.testing.assert_close(cast, got)


def test_entry_points_raise_without_cuda(monkeypatch):
    """No silent drop to the CPU: without a CUDA device the default
    device="cuda" raises, in the Server, the Model and the CLI."""
    from repro_torch.models.model import Model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("chatglm3_6b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Server(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--arch", "chatglm3_6b", "--smoke"])


def test_convert_defaults_to_the_card(monkeypatch):
    """Like every entry point, the conversions make tensors on the card by
    default and raise without one; ``device="cpu"`` takes the CPU."""
    from repro_torch.convert import from_bits

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tree = {"a": {"b": np.zeros((2, 3), np.float32)}}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from_numpy_tree(tree)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        to_tensor(np.zeros(3, np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from_bits(np.zeros(3, np.uint16), "bfloat16")
    assert from_numpy_tree(tree, device="cpu")["a"]["b"].device.type == "cpu"


@pytest.mark.parametrize("arch,plan", [
    ("falcon_mamba_7b", "access plan: 13 records, 10 collections"),
    ("recurrentgemma_2b", "access plan: 24 records, 0 collections"),
])
def test_serve_cli_on_cpu_recurrent(capsys, arch, plan):
    main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
          "--prompt-len", "12", "--gen", "4", "--attn-impl", "pallas"])
    out = capsys.readouterr().out
    assert "generated (2, 4) tokens" in out and "on cpu" in out
    assert plan in out and "  hint: embed\n" in out


def test_serve_cli_on_cpu(capsys):
    main(["--arch", "qwen1_5_4b", "--smoke", "--device", "cpu", "--batch", "2",
          "--prompt-len", "128", "--gen", "4", "--attn-impl", "pallas"])
    out = capsys.readouterr().out
    assert "generated (2, 4) tokens" in out and "on cpu" in out
    # the access plan of one decode step, printed before serving
    assert "access plan: 15 records, 12 collections" in out
    assert "  hint: embed\n" in out and "  hint: layers.ln1[]" in out


def test_port_imports_no_jax_and_nothing_of_repro():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
        for n in names:
            importlib.import_module(n)
        new = {"repro_torch.core.access_plan", "repro_torch.obs.metrics",
               "repro_torch.obs.spans", "repro_torch.predict.registry",
               "repro_torch.predict.stream", "repro_torch.runtime.prefetch",
               "repro_torch.kernels.prefetch_gather", "repro_torch.kernels.mamba_scan",
               "repro_torch.kernels.rglru_scan", "repro_torch.models.ssm",
               "repro_torch.models.rglru", "repro_torch.configs.falcon_mamba_7b",
               "repro_torch.configs.recurrentgemma_2b", "repro_torch.models.moe",
               "repro_torch.configs.qwen3_moe_30b_a3b",
               "repro_torch.configs.granite_moe_1b_a400m",
               "repro_torch.configs.whisper_large_v3", "repro_torch.configs.qwen2_vl_2b",
               "repro_torch.runtime.scheduler", "repro_torch.launch.mesh",
               "repro_torch.launch.shardings", "repro_torch.launch.compat",
               "repro_torch.launch.pipeline", "repro_torch.launch.spawn",
               "repro_torch.optim.grad_compress", "repro_torch.launch.dryrun",
               "repro_torch.launch.costmodel", "repro_torch.launch.roofline",
               "repro_torch.kernels.pricing"}
        assert new <= set(names), sorted(new - set(names))
        assert len(names) >= 52, names
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.") or m == "repro"
                     or m.startswith("repro."))
        assert not bad, bad
        import torch.distributed as dist
        assert not dist.is_initialized()  # importing starts no process group
        print("OK", len(names))
    """)
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("OK")


def test_convert_is_bit_exact_for_bf16_and_fp8():
    """Every bf16 and every fp8 e4m3 bit pattern (NaNs, infinities and
    subnormals included) crosses from a JAX array unchanged."""
    bf16_bits = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    a = np.asarray(jnp.asarray(bf16_bits.view(ml_dtypes.bfloat16)))
    t = to_tensor(a, device="cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16), bf16_bits)

    fp8_bits = np.arange(256, dtype=np.uint16).astype(np.uint8)
    a = np.asarray(jnp.asarray(fp8_bits.view(ml_dtypes.float8_e4m3fn)))
    t = to_tensor(a, device="cpu")
    assert t.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(t.view(torch.uint8).numpy(), fp8_bits)

    tree = from_numpy_tree({"a": {"b": np.arange(6, dtype=np.float32).reshape(2, 3)}},
                           device="cpu")
    assert tree["a"]["b"].dtype == torch.float32 and tree["a"]["b"].shape == (2, 3)
