"""The port's differentiable flash attention on the CPU (its plain forward and
backward versions) against the JAX package: ``jax.grad`` through
``repro.kernels.ops.flash_attention_trainable``, whose backward runs the
Pallas kernels of ``flash_attention_bwd.py`` in interpret mode off-TPU, and
``flash_attention_bwd_kernel`` itself, per query head before the group sum.

Inputs come from a numpy seed and go to both packages as numpy arrays.
Tolerances, relative to each gradient's largest magnitude: 1e-4 in f32
(sums in another order), 2e-2 in bf16 (the port sums each KV head's query
group in f32 and rounds once; JAX rounds each query head's dk, dv to bf16
before the sum).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # beside the other test workers on the CPU

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.flash_attention import flash_attention_kernel  # noqa: E402
from repro.kernels.flash_attention_bwd import flash_attention_bwd_kernel  # noqa: E402
from repro_torch.convert import to_tensor  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention_bwd import attention_delta  # noqa: E402

REL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
NP_DTYPES = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}

CASES = [  # B, Sq, Sk, H, KV, D, causal, q_offset
    (1, 128, 128, 2, 2, 64, True, 0),      # H/KV = 1
    (2, 128, 128, 4, 2, 64, False, 0),     # H/KV = 2
    (1, 256, 256, 8, 2, 128, True, 0),     # H/KV = 4, D 128
    (1, 128, 256, 4, 1, 64, True, 128),    # q_offset
    (1, 128, 256, 4, 2, 128, False, 0),    # Sq != Sk
    (1, 128, 128, 4, 2, 8, True, 0),       # D 8 (the yi smoke config's head dim)
    (2, 128, 128, 4, 2, 16, False, 0),     # D 16 (the chatglm3 smoke config's)
    (1, 128, 256, 4, 1, 96, True, 128),    # D 96, between the kernels' 64 and 128
]


def _pair(a, dtype):
    a = np.asarray(a, np.float32).astype(NP_DTYPES[dtype])
    return jnp.asarray(a), to_tensor(a, device="cpu")


def _fold(x):
    """[B, S, H, D] -> [B*H, S, D], the JAX kernels' layout."""
    B, S, H, D = x.shape
    return x.transpose(0, 2, 1, 3).reshape(B * H, S, D)


def _unfold(xf, B):
    BH, S, D = xf.shape
    return np.asarray(xf, np.float32).reshape(B, BH // B, S, D).transpose(0, 2, 1, 3)


def _close_rel(got: torch.Tensor, want, tol: float):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _inputs(case, dtype, seed):
    B, Sq, Sk, H, KV, D, causal, q_offset = case
    rng = np.random.RandomState(seed)
    return (_pair(rng.randn(B, Sq, H, D), dtype), _pair(rng.randn(B, Sk, KV, D), dtype),
            _pair(rng.randn(B, Sk, KV, D), dtype), rng.randn(B, Sq, H, D).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_trainable_grads_match_jax(case, dtype):
    """dq, dk, dv of sum(o * w) through the port's autograd Function and
    through JAX's custom_vjp."""
    causal, q_offset = case[6], case[7]
    (qj, qt), (kj, kt), (vj, vt), w = _inputs(case, dtype, seed=0)

    def f(q, k, v):
        o = jops.flash_attention_trainable(q, k, v, causal, q_offset)
        return jnp.sum(o.astype(jnp.float32) * w)

    want = jax.grad(f, argnums=(0, 1, 2))(qj, kj, vj)
    leaves = [t.clone().requires_grad_() for t in (qt, kt, vt)]
    o = ops.flash_attention_trainable(*leaves, causal, q_offset)
    assert o.dtype == qt.dtype and o.shape == qt.shape
    (o.float() * torch.from_numpy(w)).sum().backward()
    for leaf, wj in zip(leaves, want):
        assert leaf.grad.dtype == leaf.dtype
        _close_rel(leaf.grad, wj, REL_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_bwd_ref_matches_jax_kernel_per_query_head(case, dtype):
    """``flash_attention_bwd_ref(group_sum=False)`` against the Pallas
    backward kernels on the same q, k, v, do, lse and delta."""
    B, Sq, Sk, H, KV, D, causal, q_offset = case
    (qj, qt), (kj, kt), (vj, vt), w = _inputs(case, dtype, seed=1)
    doj, dot = _pair(w, dtype)
    of, lse = flash_attention_kernel(_fold(qj), _fold(kj), _fold(vj), causal=causal,
                                     q_offset=q_offset, interpret=True, with_lse=True)
    delta = jnp.sum(_fold(doj).astype(jnp.float32) * of.astype(jnp.float32), axis=-1)
    dq, dk, dv = flash_attention_bwd_kernel(
        _fold(qj), _fold(kj), _fold(vj), _fold(doj), lse, delta, causal=causal,
        q_offset=q_offset, interpret=True,
    )
    got = ref.flash_attention_bwd_ref(qt, kt, vt, dot, to_tensor(np.asarray(lse), device="cpu"),
                                      to_tensor(np.asarray(delta), device="cpu"), causal=causal,
                                      q_offset=q_offset, group_sum=False)
    for g, want, like in zip(got, (dq, dk, dv), (qt, kt, vt)):
        assert g.dtype == like.dtype
        _close_rel(g, _unfold(want, B), REL_TOL[dtype])


def test_delta_layout_matches_lse():
    """delta = rowsum(do * o) comes out [B*H, Sq], b-major, like lse."""
    rng = np.random.RandomState(2)
    o = torch.from_numpy(rng.randn(2, 5, 3, 4).astype(np.float32))
    do = torch.from_numpy(rng.randn(2, 5, 3, 4).astype(np.float32))
    d = attention_delta(o, do)
    assert d.shape == (6, 5)
    torch.testing.assert_close(d[1 * 3 + 2, 4], (o[1, 4, 2] * do[1, 4, 2]).sum())
