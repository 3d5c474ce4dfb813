"""The port's pipeline parallelism and gradient compression: ``gpipe`` on 4
gloo ranks against the sequential stages (twin of ``test_pipeline.py``);
the int8 quantization, error feedback and the compressed all-reduce (twins
of ``test_runtime_substrate.py``'s, held to JAX's functions), the
all-reduce over 4 ranks with different gradients against JAX's
quantization of each."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # beside the other test workers on the CPU

from repro.optim import grad_compress as jgc  # noqa: E402
from repro_torch.launch.spawn import run_ranks  # noqa: E402
from repro_torch.optim.grad_compress import (  # noqa: E402
    compress_leaf,
    dequantize_int8,
    quantize_int8,
)
import torch_mesh_ranks  # noqa: E402

S, L_PER, M, MB, D = 4, 2, 8, 2, 16


def _stage_ref(sp, x):
    for i in range(sp.shape[0]):
        x = np.tanh(x @ sp[i])
    return x


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    rng = np.random.RandomState(0)
    ws = (rng.randn(S, L_PER, D, D) * 0.3).astype(np.float32)
    xs = rng.randn(M, MB, D).astype(np.float32)
    grads = [{"w": (rng.randn(8, 8) * (r + 1)).astype(np.float32),
              "n": {"b": rng.randn(5).astype(np.float32)}} for r in range(S)]
    residuals = [{"w": (rng.randn(8, 8) * 1e-3).astype(np.float32),
                  "n": {"b": np.zeros(5, np.float32)}} for r in range(S)]
    out = run_ranks(torch_mesh_ranks.pipeline_and_compression, S, ws, xs, grads, residuals,
                    timeout=120.0, store_dir=tmp_path_factory.mktemp("store"))[0]
    return ws, xs, grads, residuals, out


def test_gpipe_matches_sequential(ranks):
    ws, xs, _, _, (got, _, _) = ranks
    want = []
    for m in range(M):
        x = xs[m]
        for s in range(S):
            x = _stage_ref(ws[s], x)
        want.append(x)
    np.testing.assert_allclose(got, np.stack(want), rtol=1e-5, atol=1e-5)


def test_compressed_allreduce_matches_jax_quantization(ranks):
    """Each rank's leaf quantized as JAX quantizes it; the mean of the
    dequantized payloads on every rank, and each rank's own residual."""
    _, _, grads, residuals, (_, every, _) = ranks
    for path in ("w", "n.b"):
        def leaf(tree):
            for k in path.split("."):
                tree = tree[k]
            return tree

        parts = []
        for r in range(S):
            g32 = jnp.asarray(leaf(grads[r])) + jnp.asarray(leaf(residuals[r]))
            q, scale = jgc.quantize_int8(g32)
            deq = np.asarray(jgc.dequantize_int8(q, scale))
            parts.append(deq)
            np.testing.assert_allclose(leaf(every[r][1]), np.asarray(g32) - deq,
                                       rtol=1e-6, atol=1e-7)
        mean = np.mean(parts, axis=0)
        for r in range(S):
            np.testing.assert_allclose(leaf(every[r][0]), mean, rtol=1e-6, atol=1e-7)


def test_compressed_allreduce_of_equal_gradients(ranks):
    """Twin of ``test_compressed_allreduce_in_shard_map``: gradients of 0.5
    on each of 4 ranks come back as 0.5."""
    np.testing.assert_allclose(ranks[-1][2], 0.5, rtol=1e-2)


def test_int8_quantization_roundtrip_bounds():
    rng = np.random.RandomState(0)
    x = rng.randn(128, 64).astype(np.float32)
    q, scale = quantize_int8(torch.from_numpy(x))
    jq, jscale = jgc.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(scale) == pytest.approx(float(jscale), rel=1e-7)
    err = np.abs(dequantize_int8(q, scale).numpy() - x)
    assert err.max() <= float(scale) * 0.5 + 1e-6


def test_error_feedback_accumulates_lost_precision():
    """With error feedback, the sum of the decompressed gradients over many
    steps tracks the true sum, step for step as JAX's ``compress_leaf``."""
    rng = np.random.RandomState(1)
    true_sum = np.zeros((32,), np.float32)
    sent_sum = np.zeros((32,), np.float32)
    residual, jresidual = torch.zeros(32), jnp.zeros((32,), jnp.float32)
    for _ in range(50):
        g = (rng.randn(32) * 1e-3).astype(np.float32)
        true_sum += g
        sent, residual = compress_leaf(torch.from_numpy(g), residual)
        jsent, jresidual = jgc.compress_leaf(jnp.asarray(g), jresidual)
        np.testing.assert_allclose(sent.numpy(), np.asarray(jsent), rtol=1e-6, atol=1e-9)
        sent_sum += sent.numpy()
    np.testing.assert_allclose(sent_sum + residual.numpy(), true_sum, rtol=1e-4, atol=1e-6)
