"""The port's attention ops on the CPU (their plain PyTorch versions)
against the JAX package: ``repro.kernels.ops`` (the Pallas kernels, in
interpret mode off-TPU) and ``repro.kernels.ref``.

Inputs come from a numpy seed and go to both packages as numpy arrays.
Tolerances are those of tests/test_kernels.py: 1e-5 at f32, 2e-2 at bf16.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

torch.set_num_threads(2)  # beside the other test workers on the CPU

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_kernel
from repro_torch.kernels import ops, ref

TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
NP_DTYPES = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16,
             "float8_e4m3fn": ml_dtypes.float8_e4m3fn}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and as a CPU tensor, in ``dtype``."""
    from repro_torch.convert import to_tensor

    a = np.asarray(a, np.float32).astype(NP_DTYPES[dtype])
    return jnp.asarray(a), to_tensor(a, device="cpu")


def _close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


# ---------------------------------------------------------------------------
# flash attention: the sweep of tests/test_kernels.py, causal only where
# Sq == Sk (as there), plus a q_offset case
# ---------------------------------------------------------------------------

SHAPES = [
    (1, 128, 128, 4, 4, 64),
    (2, 128, 256, 4, 2, 64),
    (1, 256, 256, 8, 1, 128),
    (2, 64, 64, 2, 2, 128),
]
FLASH_CASES = [
    (shape, dtype, causal)
    for shape in SHAPES
    for dtype in ("float32", "bfloat16")
    for causal in (True, False)
    if not (causal and shape[1] != shape[2])
]


@pytest.mark.parametrize("shape,dtype,causal", FLASH_CASES)
def test_flash_attention_matches_jax(shape, dtype, causal):
    B, Sq, Sk, H, KV, D = shape
    rng = np.random.RandomState(0)
    qj, qt = _pair(rng.randn(B, Sq, H, D), dtype)
    kj, kt = _pair(rng.randn(B, Sk, KV, D), dtype)
    vj, vt = _pair(rng.randn(B, Sk, KV, D), dtype)
    got = ops.flash_attention(qt, kt, vt, causal=causal)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    _close(got, jops.flash_attention(qj, kj, vj, causal=causal, block_q=64, block_k=64),
           **TOL[dtype])
    _close(got, jref.flash_attention_ref(qj, kj, vj, causal=causal), **TOL[dtype])


def test_flash_attention_q_offset_matches_jax():
    rng = np.random.RandomState(1)
    B, Sq, Sk, H, D = 1, 64, 256, 2, 64
    qj, qt = _pair(rng.randn(B, Sq, H, D), "float32")
    kj, kt = _pair(rng.randn(B, Sk, H, D), "float32")
    vj, vt = _pair(rng.randn(B, Sk, H, D), "float32")
    got = ops.flash_attention(qt, kt, vt, causal=True, q_offset=192)
    _close(got, jops.flash_attention(qj, kj, vj, causal=True, q_offset=192, block_q=64,
                                     block_k=64), **TOL["float32"])
    _close(got, jref.flash_attention_ref(qj, kj, vj, causal=True, q_offset=192),
           **TOL["float32"])


@pytest.mark.parametrize("causal,q_offset,Sq", [(True, 0, 128), (False, 0, 128), (True, 64, 64)])
def test_flash_attention_lse_matches_jax_kernel(causal, q_offset, Sq):
    """The f32 log-sum-exp against the TPU kernel's ``with_lse`` output
    (folded [B*H, Sq] layout)."""
    rng = np.random.RandomState(2)
    B, Sk, H, KV, D = 2, 128, 4, 2, 64
    qj, qt = _pair(rng.randn(B, Sq, H, D), "float32")
    kj, kt = _pair(rng.randn(B, Sk, KV, D), "float32")
    vj, vt = _pair(rng.randn(B, Sk, KV, D), "float32")
    o, lse = ops.flash_attention(qt, kt, vt, causal=causal, q_offset=q_offset, with_lse=True)
    fold = lambda x: x.transpose(0, 2, 1, 3).reshape(-1, x.shape[1], x.shape[3])
    o_j, lse_j = flash_attention_kernel(
        fold(qj), fold(kj), fold(vj), causal=causal, q_offset=q_offset, block_q=64,
        block_k=64, interpret=True, with_lse=True,
    )
    assert lse.dtype == torch.float32 and lse.shape == (B * H, Sq)
    _close(lse, lse_j, **TOL["float32"])
    _close(o, np.asarray(o_j).reshape(B, H, Sq, D).transpose(0, 2, 1, 3), **TOL["float32"])


# ---------------------------------------------------------------------------
# decode attention: the sweep of tests/test_kernels.py, an fp8 cache, and a
# cache length that the JAX wrapper's block assertion refuses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,S,H,KV,D,kv_len", [
    (1, 512, 4, 4, 64, 512),
    (2, 512, 8, 2, 64, 300),
    (1, 1024, 4, 1, 128, 7),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_jax(B, S, H, KV, D, kv_len, dtype):
    rng = np.random.RandomState(3)
    qj, qt = _pair(rng.randn(B, H, D), dtype)
    kj, kt = _pair(rng.randn(B, S, KV, D), dtype)
    vj, vt = _pair(rng.randn(B, S, KV, D), dtype)
    got = ops.decode_attention(qt, kt, vt, kv_len)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    _close(got, jops.decode_attention(qj, kj, vj, kv_len, block_k=128), **TOL[dtype])
    _close(got, jref.decode_attention_ref(qj, kj, vj, kv_len), **TOL[dtype])


@pytest.mark.parametrize("kv_len", [1, 300, 512])
def test_decode_attention_fp8_cache_matches_jax(kv_len):
    """A float8_e4m3fn cache with bf16 queries: the JAX kernel upcasts it;
    JAX's ref refuses implicit fp8 promotion, so it gets the cache upcast to
    bf16 (exact) by hand, as the port's plain version does itself."""
    rng = np.random.RandomState(4)
    B, S, H, KV, D = 2, 512, 8, 2, 64
    qj, qt = _pair(rng.randn(B, H, D), "bfloat16")
    kj, kt = _pair(rng.randn(B, S, KV, D), "float8_e4m3fn")
    vj, vt = _pair(rng.randn(B, S, KV, D), "float8_e4m3fn")
    got = ops.decode_attention(qt, kt, vt, kv_len)
    assert got.dtype == torch.bfloat16
    _close(got, jops.decode_attention(qj, kj, vj, kv_len, block_k=128), **TOL["bfloat16"])
    want = jref.decode_attention_ref(qj, kj.astype(jnp.bfloat16), vj.astype(jnp.bfloat16), kv_len)
    _close(got, want, **TOL["bfloat16"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_cache_not_multiple_of_512(dtype):
    """S = 640: the JAX wrapper asserts ``S % min(512, S) == 0`` here, so
    the port is held against JAX's ref alone."""
    rng = np.random.RandomState(5)
    B, S, H, KV, D, kv_len = 2, 640, 8, 2, 64, 600
    qj, qt = _pair(rng.randn(B, H, D), dtype)
    kj, kt = _pair(rng.randn(B, S, KV, D), dtype)
    vj, vt = _pair(rng.randn(B, S, KV, D), dtype)
    got = ops.decode_attention(qt, kt, vt, kv_len)
    _close(got, jref.decode_attention_ref(qj, kj, vj, kv_len), **TOL[dtype])
    with pytest.raises(AssertionError):
        jops.decode_attention(qj, kj, vj, kv_len)


def test_plain_ops_on_cpu_launch_no_kernel():
    """On CPU tensors the ops run the plain versions: the launch counters of
    the CUDA kernels stay where they were."""
    from repro_torch.kernels.decode_attention import decode_attention_fwd
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.prefetch_gather import prefetch_gather_fwd

    counters = (flash_attention_fwd, decode_attention_fwd, prefetch_gather_fwd)
    before = [c.launches for c in counters]
    q = torch.randn(1, 128, 4, 64)
    k = torch.randn(1, 128, 2, 64)
    torch.testing.assert_close(ops.flash_attention(q, k, k), ref.flash_attention_ref(q, k, k))
    torch.testing.assert_close(ops.decode_attention(q[:, 0], k, k, 9),
                               ref.decode_attention_ref(q[:, 0], k, k, 9))
    idx = torch.tensor([3, 0, 3])
    assert torch.equal(ops.prefetch_gather(k[0, :, 0], idx), k[0, idx, 0])
    assert [c.launches for c in counters] == before


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers take CUDA tensors only; the plain versions are
    reached through ``ops`` by the device of the tensors, never by a
    fallback inside a wrapper."""
    from repro_torch.kernels.decode_attention import decode_attention_fwd
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.prefetch_gather import prefetch_gather_fwd

    counters = (flash_attention_fwd, decode_attention_fwd, prefetch_gather_fwd)
    before = [c.launches for c in counters]
    q = torch.randn(1, 128, 4, 64)
    k = torch.randn(1, 128, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_fwd(q, k, k)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention_fwd(q[:, 0], k, k, 9)
    with pytest.raises(ValueError, match="CUDA"):
        prefetch_gather_fwd(k[0, :, 0], torch.tensor([1]))
    assert [c.launches for c in counters] == before


def test_kernel_build_dir_is_keyed_by_sources_and_ignored():
    from pathlib import Path

    from repro_torch.kernels import _build

    d = _build.build_dir()
    assert d.parent == _build.BUILD_ROOT and len(d.name) == 16 and d == _build.build_dir()
    assert sorted(p.name for p in _build.CSRC.glob("*.cu")) == [
        "decode_attention.cu", "flash_attention.cu", "flash_attention_bwd.cu",
        "mamba_scan.cu", "prefetch_gather.cu", "rglru_scan.cu", "selective_scan.cu"]
    repo = Path(__file__).resolve().parents[1]
    ignored = (repo / ".gitignore").read_text().split()
    assert str(_build.BUILD_ROOT.relative_to(repo)) + "/" in ignored


# ---------------------------------------------------------------------------
# prefetch gather: the sweep of tests/test_kernels.py:88-110, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("N,D,B", [(64, 128, 8), (1000, 384, 17), (16, 130, 5)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_prefetch_gather_matches_jax(N, D, B, dtype, idx_dtype):
    """The port's plain gather (what ``ops.prefetch_gather`` runs on the CPU)
    against JAX's ``ops.prefetch_gather`` (the Pallas kernel in interpret
    mode, D padded to a lane multiple and sliced back): equal bits."""
    from repro_torch.convert import to_numpy

    rng = np.random.RandomState(3)
    tj, tt = _pair(rng.randn(N, D), dtype)
    idx = rng.randint(0, N, size=B)
    want = jops.prefetch_gather(tj, jnp.asarray(idx, jnp.int32))
    got = ops.prefetch_gather(tt, torch.from_numpy(idx).to(idx_dtype))
    assert got.dtype == tt.dtype and got.shape == (B, D)
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))
    np.testing.assert_array_equal(to_numpy(ref.prefetch_gather_ref(tt, torch.from_numpy(idx))),
                                  np.asarray(jref.prefetch_gather_ref(tj, jnp.asarray(idx))))


@settings(max_examples=25, deadline=None)
@given(n=st.integers(2, 64), b=st.integers(1, 16), d=st.integers(1, 200), data=st.data())
def test_prefetch_gather_property(n, b, d, data):
    """Hint-driven gather == direct indexing, for any hint set and width."""
    idx = data.draw(st.lists(st.integers(0, n - 1), min_size=b, max_size=b))
    table = torch.arange(n * d, dtype=torch.float32).reshape(n, d)
    got = ops.prefetch_gather(table, torch.tensor(idx))
    np.testing.assert_array_equal(got.numpy(), table.numpy()[idx])


@pytest.mark.parametrize("arch", ["chatglm3_6b", "minitron_8b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_embed_matches_jax(arch, dtype):
    """``Model.embed`` (the gather path: no autograd) equals JAX's
    ``jnp.take`` lookup, bit for bit, at f32 and bf16 compute; under
    autograd the port keeps indexing, with the same values."""
    import jax

    from repro.configs import get_smoke_config as jget_smoke
    from repro.models.model import Model as JModel
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import from_numpy_tree, to_numpy
    from repro_torch.models.model import Model

    jmodel = JModel(jget_smoke(arch).replace(compute_dtype=dtype))
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    model = Model(get_smoke_config(arch).replace(compute_dtype=dtype), device="cpu")
    params = from_numpy_tree({"embed": np.asarray(jparams["embed"])}, device="cpu")
    tokens = np.random.RandomState(4).randint(0, model.cfg.vocab_size, (3, 7))
    want = np.asarray(jmodel.embed(jparams, jnp.asarray(tokens, jnp.int32)))
    with torch.inference_mode():
        got = model.embed(params, torch.from_numpy(tokens))
    assert tuple(got.shape) == (3, 7, model.cfg.d_model)
    np.testing.assert_array_equal(to_numpy(got), want)
    table = params["embed"].requires_grad_()
    with torch.enable_grad():
        grad_path = model.embed({"embed": table}, torch.from_numpy(tokens))
    assert grad_path.requires_grad
    np.testing.assert_array_equal(to_numpy(grad_path.detach()), want)
