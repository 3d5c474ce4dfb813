"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Run on a machine with an H100:  PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
Without a CUDA device every test skips (the fixture decides, at run time).

Tolerances: f32 1e-5 (rtol and atol; the kernels sum in another order than
the plain version; the scans: the mamba scan's N-term sum of y in another
order), bf16 2e-2 (the plain version rounds the normalised P to
bf16 and its PV product to bf16, the kernels round the unnormalised P and
keep f32 sums; the tensor-core flash-decode keeps P in f32 as a bf16 pair),
the f32 log-sum-exp 1e-4 absolute (sums of up to 2048 exponentials in
another order).  The backward kernels: f32 1e-4 and bf16
2e-2 of each gradient's largest magnitude (sums over up to 16 query heads
and 1024 rows in another order; bf16 rounds P and dS before products, as
the plain version does, but the GQA group sum stays in f32).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # beside the other test workers on the CPU

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention_fwd  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_fwd  # noqa: E402
from repro_torch.kernels.flash_attention_bwd import (  # noqa: E402
    attention_delta,
    flash_attention_bwd_dkdv,
    flash_attention_bwd_dq,
)

pytestmark = pytest.mark.gpu

TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5), torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (an H100); run with -m gpu on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, dtype=torch.float32, device=device).to(dtype)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), **tol)


@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,dtype,causal,q_offset", [
    (4, 512, 512, 32, 2, 128, torch.bfloat16, True, 0),   # chatglm3-6b prefill
    (2, 256, 256, 8, 2, 128, torch.float32, True, 0),
    (2, 128, 256, 4, 2, 64, torch.float32, False, 0),
    (1, 64, 256, 2, 2, 64, torch.float32, True, 192),
    (2, 256, 256, 8, 1, 64, torch.bfloat16, True, 0),
    (1, 100, 100, 4, 2, 64, torch.float32, True, 0),       # ragged edges
    (2, 128, 256, 4, 2, 64, torch.bfloat16, False, 0),
    (1, 64, 256, 2, 2, 128, torch.bfloat16, True, 192),
    (1, 100, 100, 4, 2, 128, torch.bfloat16, True, 0),     # ragged edges
])
def test_flash_attention_kernel_matches_ref(cuda, B, Sq, Sk, H, KV, D, dtype, causal, q_offset):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = _randn(gen, (B, Sq, H, D), dtype, cuda)
    k = _randn(gen, (B, Sk, KV, D), dtype, cuda)
    v = _randn(gen, (B, Sk, KV, D), dtype, cuda)
    o, lse = flash_attention_fwd(q, k, v, causal=causal, q_offset=q_offset)
    o_ref, lse_ref = ref.flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                                             return_lse=True)
    torch.cuda.synchronize()
    assert o.dtype == dtype and o.shape == q.shape
    _close(o, o_ref, **TOL[dtype])
    _close(lse, lse_ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float32, torch.float8_e4m3fn])
@pytest.mark.parametrize("kv_len", [1, 7, 513, 1024])
def test_decode_attention_kernel_matches_ref(cuda, kv_dtype, kv_len):
    B, S, H, KV, D = 4, 1024, 32, 2, 128  # chatglm3-6b decode
    q_dtype = torch.float32 if kv_dtype == torch.float32 else torch.bfloat16
    gen = torch.Generator(device=cuda).manual_seed(1)
    q = _randn(gen, (B, H, D), q_dtype, cuda)
    k = _randn(gen, (B, S, KV, D), kv_dtype, cuda)
    v = _randn(gen, (B, S, KV, D), kv_dtype, cuda)
    got = decode_attention_fwd(q, k, v, kv_len)
    want = ref.decode_attention_ref(q, k, v, kv_len)
    torch.cuda.synchronize()
    assert got.dtype == q_dtype
    _close(got, want, **TOL[q_dtype])


@pytest.mark.parametrize("B,S,H,KV,D,kv_len", [
    (2, 640, 8, 2, 64, 600),   # S not a multiple of 512
    (1, 256, 4, 4, 128, 200),  # MHA (G = 1)
])
def test_decode_attention_kernel_other_shapes(cuda, B, S, H, KV, D, kv_len):
    gen = torch.Generator(device=cuda).manual_seed(2)
    q = _randn(gen, (B, H, D), torch.float32, cuda)
    k = _randn(gen, (B, S, KV, D), torch.float32, cuda)
    v = _randn(gen, (B, S, KV, D), torch.float32, cuda)
    _close(decode_attention_fwd(q, k, v, kv_len), ref.decode_attention_ref(q, k, v, kv_len),
           **TOL[torch.float32])


DECODE_LENS = (1, 15, 16, 17, 63, 64, 65, 528, 1024)


@pytest.mark.parametrize("B,S,H,KV,D,kv_len", [
    (4, 1024, 12, 2, 128, 528),  # qwen2-vl-2b decode: G = 6
    (4, 256, 20, 20, 64, 144),   # whisper-large-v3 decoder: G = 1, D 64
])
def test_decode_tensor_core_variant_serving_shapes(cuda, B, S, H, KV, D, kv_len):
    """Flash-decode at the two new models' serving shapes, bf16 query and
    cache: the tensor-core variant, within the tolerance of the plain
    version at the serving length, at 1 and at S."""
    from repro_torch.kernels import decode_attention as dec

    assert dec.variant(torch.bfloat16, torch.bfloat16, D) == "mma"
    gen = torch.Generator(device=cuda).manual_seed(14)
    q = _randn(gen, (B, H, D), torch.bfloat16, cuda)
    k = _randn(gen, (B, S, KV, D), torch.bfloat16, cuda)
    v = _randn(gen, (B, S, KV, D), torch.bfloat16, cuda)
    n = decode_attention_fwd.launches_mma
    for length in (1, kv_len, S):
        _close(decode_attention_fwd(q, k, v, length), ref.decode_attention_ref(q, k, v, length),
               **TOL[torch.bfloat16])
    assert decode_attention_fwd.launches_mma == n + 3


@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float8_e4m3fn])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 4, 7, 16, 32])
def test_decode_tensor_core_variant_matches_ref(cuda, G, D, kv_dtype):
    """The tensor-core flash-decode (a bf16 query over a bf16 or fp8 cache)
    for query groups that leave rows of its 16-head tile empty (G = 1, 4,
    7), fill it (16) or take two tiles (32), at lengths around its 16-key
    steps and splits."""
    from repro_torch.kernels import decode_attention as dec

    B, KV, S = 2, 2, 1024
    gen = torch.Generator(device=cuda).manual_seed(7)
    q = _randn(gen, (B, KV * G, D), torch.bfloat16, cuda)
    k = _randn(gen, (B, S, KV, D), kv_dtype, cuda)
    v = _randn(gen, (B, S, KV, D), kv_dtype, cuda)
    n0 = decode_attention_fwd.launches_mma
    for kv_len in DECODE_LENS:
        got = decode_attention_fwd(q, k, v, kv_len)
        want = ref.decode_attention_ref(q, k, v, kv_len)
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16 and torch.isfinite(got).all(), kv_len
        _close(got, want, **TOL[torch.bfloat16])
    assert decode_attention_fwd.launches_mma == n0 + len(DECODE_LENS)
    assert int(dec._COUNTERS[cuda.index or 0].abs().sum()) == 0  # tickets reset


@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float8_e4m3fn])
def test_decode_tensor_core_variant_long_cache(cuda, kv_dtype):
    """A 32768-slot cache read to its end and to one slot short of it."""
    B, S, H, KV, D = 1, 32768, 32, 2, 128
    gen = torch.Generator(device=cuda).manual_seed(8)
    q = _randn(gen, (B, H, D), torch.bfloat16, cuda)
    k = _randn(gen, (B, S, KV, D), kv_dtype, cuda)
    v = _randn(gen, (B, S, KV, D), kv_dtype, cuda)
    for kv_len in (S, S - 1):
        _close(decode_attention_fwd(q, k, v, kv_len), ref.decode_attention_ref(q, k, v, kv_len),
               **TOL[torch.bfloat16])


def test_decode_launch_counts_per_variant(cuda):
    """bf16 over a bf16 cache runs the tensor cores; an f32 query, or an f32
    cache, the CUDA cores; the total counts both."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    k16 = _randn(gen, (2, 64, 2, 128), torch.bfloat16, cuda)
    q16 = _randn(gen, (2, 8, 128), torch.bfloat16, cuda)
    f = decode_attention_fwd
    n, n_mma, n_simt = f.launches, f.launches_mma, f.launches_simt
    f(q16, k16, k16, 40)
    assert (f.launches, f.launches_mma, f.launches_simt) == (n + 1, n_mma + 1, n_simt)
    f(q16.float(), k16.float(), k16.float(), 40)
    f(q16, k16.float(), k16.float(), 40)
    assert (f.launches, f.launches_mma, f.launches_simt) == (n + 3, n_mma + 1, n_simt + 2)


def test_decode_tickets_survive_cuda_graph_replay(cuda):
    """The split merge's per-tile tickets are reset by the kernel itself, so
    a captured decode gives the same result on every replay."""
    from repro_torch.kernels import decode_attention as dec

    gen = torch.Generator(device=cuda).manual_seed(10)
    q = _randn(gen, (4, 32, 128), torch.bfloat16, cuda)
    k = _randn(gen, (4, 1024, 2, 128), torch.bfloat16, cuda)
    v = _randn(gen, (4, 1024, 2, 128), torch.bfloat16, cuda)
    want = decode_attention_fwd(q, k, v, 528)
    assert dec.mma_split_plan(4, 2, 1, 1024, dec._sm_count(cuda.index or 0))[1] > 1
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        decode_attention_fwd(q, k, v, 528)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = decode_attention_fwd(q, k, v, 528)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)
    assert int(dec._COUNTERS[cuda.index or 0].abs().sum()) == 0


def test_decode_reads_the_cache_in_place(cuda):
    """The per-layer slice of a stacked cache goes in as a strided view;
    rows past kv_len are never read (NaN there changes nothing)."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    cache = _randn(gen, (3, 2, 256, 2, 64), torch.bfloat16, cuda)
    cache[:, :, 100:] = float("nan")
    q = _randn(gen, (2, 8, 64), torch.bfloat16, cuda)
    got = decode_attention_fwd(q, cache[1], cache[2], 100)
    want = ref.decode_attention_ref(q, cache[1][:, :100], cache[2][:, :100], 100)
    assert torch.isfinite(got).all()
    _close(got, want, **TOL[torch.bfloat16])


def test_ops_launch_the_kernels_on_cuda(cuda):
    gen = torch.Generator(device=cuda).manual_seed(4)
    q = _randn(gen, (1, 128, 4, 64), torch.bfloat16, cuda)
    k = _randn(gen, (1, 128, 2, 64), torch.bfloat16, cuda)
    f0, d0 = flash_attention_fwd.launches, decode_attention_fwd.launches
    ops.flash_attention(q, k, k, causal=True)
    ops.decode_attention(q[:, 0], k, k, 50)
    assert flash_attention_fwd.launches == f0 + 1
    assert decode_attention_fwd.launches == d0 + 1


def test_logits_bf16_gemm_matches_widened_product(cuda):
    """On the card the head is one bf16 GEMM with an f32 output: the same
    products as widening both operands to f32, summed in another order."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import Model

    cfg = get_smoke_config("chatglm3_6b")
    model = Model(cfg, device="cuda")
    params = model.compute_params(model.init_params(seed=0))
    gen = torch.Generator(device=cuda).manual_seed(5)
    h = _randn(gen, (3, 2, cfg.d_model), torch.bfloat16, cuda)
    got = model.logits(params, h)
    assert got.dtype == torch.float32 and got.shape == (3, 2, params["lm_head"].shape[1])
    _close(got, h.float() @ params["lm_head"].float(), **TOL[torch.float32])


def test_kernels_refuse_what_they_cannot_take(cuda):
    message = "head_dim 1032: the attention kernels take 1 <= D <= 1024"
    for dtype in (torch.bfloat16, torch.float32):  # D = 1032: past the one bound of all three
        q = torch.zeros((1, 128, 4, 1032), dtype=dtype, device=cuda)
        with pytest.raises(ValueError, match=message):
            flash_attention_fwd(q, q[:, :, :2], q[:, :, :2])
        lse = torch.zeros((4, 128), dtype=torch.float32, device=cuda)
        with pytest.raises(ValueError, match=message):
            flash_attention_bwd_dkdv(q, q[:, :, :2], q[:, :, :2], q, lse, lse)
        with pytest.raises(ValueError, match=message):
            decode_attention_fwd(q[:, 0], q[:, :, :2], q[:, :, :2], 10)
    odd = torch.zeros((1, 128, 4, 68), dtype=torch.bfloat16, device=cuda)[..., :64]
    with pytest.raises(ValueError):  # rows not 16-byte aligned
        flash_attention_fwd(odd, odd[:, :, :2], odd[:, :, :2])
    q16 = torch.zeros((1, 4, 64), dtype=torch.float16, device=cuda)
    k16 = torch.zeros((1, 128, 2, 64), dtype=torch.float16, device=cuda)
    with pytest.raises(TypeError):
        decode_attention_fwd(q16, k16, k16, 10)


@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,causal,q_offset", [
    (2, 200, 200, 2, 2, 128, True, 0),      # G = 1 (128 rows a block), Sq % 128 != 0
    (2, 200, 200, 2, 2, 64, False, 0),
    (1, 77, 269, 14, 2, 128, True, 192),    # G = 7 (one head of a pair idle), q_offset
    (1, 130, 130, 7, 1, 64, False, 0),
    (2, 300, 300, 32, 2, 64, True, 0),      # G = 16, D = 64
    (1, 100, 356, 32, 2, 128, True, 256),
    (2, 2048, 2048, 32, 2, 128, True, 0),   # chatglm3-6b training shape
    (4, 512, 512, 12, 2, 128, True, 0),     # qwen2-vl-2b prefill: G = 6
    (4, 128, 128, 20, 20, 64, True, 0),     # whisper-large-v3 decoder prefill: G = 1
    # whisper-large-v3's encoder and cross-attention at 1500 frames: their
    # main path on the card (lengths not multiples of 128)
    (4, 1500, 1500, 20, 20, 64, False, 0),
    (4, 128, 1500, 20, 20, 64, False, 0),
])
def test_flash_attention_wgmma_kernel_matches_ref(cuda, B, Sq, Sk, H, KV, D, causal, q_offset):
    """The bf16 forward (TMA, wgmma, warp-specialised, persistent) for each
    way it packs query heads and rows into its warpgroups."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    q = _randn(gen, (B, Sq, H, D), torch.bfloat16, cuda)
    k = _randn(gen, (B, Sk, KV, D), torch.bfloat16, cuda)
    v = _randn(gen, (B, Sk, KV, D), torch.bfloat16, cuda)
    o, lse = flash_attention_fwd(q, k, v, causal=causal, q_offset=q_offset)
    o_ref, lse_ref = ref.flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                                             return_lse=True)
    torch.cuda.synchronize()
    assert o.dtype == torch.bfloat16 and o.shape == q.shape
    _close(o, o_ref, **TOL[torch.bfloat16])
    _close(lse, lse_ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [8, 16, 20, 96, 136, 256, 320, 512])
def test_flash_attention_takes_every_head_dim(cuda, D, dtype):
    """Head dims below 64 run on the D = 64 build, those between 64 and 128
    on the D = 128 build and those up to 256 on the CUDA cores' D = 256
    build, whose extra columns are zero; past 256 (320, 512) that build in
    pieces of 256 columns; a bf16 D of 20 (40-byte rows, no TMA) runs on the
    CUDA cores."""
    gen = torch.Generator(device=cuda).manual_seed(13)
    q = _randn(gen, (2, 200, 8, D), dtype, cuda)
    k = _randn(gen, (2, 200, 2, D), dtype, cuda)
    v = _randn(gen, (2, 200, 2, D), dtype, cuda)
    o, lse = flash_attention_fwd(q, k, v, causal=True, q_offset=0)
    o_ref, lse_ref = ref.flash_attention_ref(q, k, v, causal=True, return_lse=True)
    torch.cuda.synchronize()
    assert o.dtype == dtype and o.shape == q.shape
    _close(o, o_ref, **TOL[dtype])
    _close(lse, lse_ref, rtol=0, atol=1e-4)


def test_flash_attention_takes_strided_views(cuda):
    """q, k, v as slices of one fused projection output [B, S, H + 2 KV, D]
    and o written in the model layout: the tensor maps carry the strides."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    qkv = _randn(gen, (2, 192, 36, 128), torch.bfloat16, cuda)
    q, k, v = qkv[:, :, :32], qkv[:, :, 32:34], qkv[:, :, 34:]
    o, lse = flash_attention_fwd(q, k, v, causal=True)
    o_ref, lse_ref = ref.flash_attention_ref(q, k, v, causal=True, return_lse=True)
    torch.cuda.synchronize()
    _close(o, o_ref, **TOL[torch.bfloat16])
    _close(lse, lse_ref, rtol=0, atol=1e-4)


GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _close_rel(got, want, tol):
    """max |got - want| within ``tol`` of max |want|."""
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * float(want.float().abs().max()), (err, float(want.abs().max()))


BWD_CASES = [  # B, Sq, Sk, H, KV, D, dtype, causal, q_offset
    (2, 256, 256, 32, 2, 128, torch.bfloat16, True, 0),   # chatglm3-6b heads
    (2, 256, 256, 8, 2, 128, torch.float32, True, 0),
    (1, 128, 256, 4, 2, 64, torch.float32, False, 0),
    (1, 128, 256, 4, 2, 64, torch.bfloat16, False, 0),
    (1, 64, 256, 4, 4, 64, torch.float32, True, 192),
    (1, 64, 256, 4, 1, 128, torch.bfloat16, True, 128),
    (2, 100, 100, 4, 2, 64, torch.float32, True, 0),      # ragged edges
    (2, 100, 100, 4, 2, 128, torch.bfloat16, True, 0),
    (1, 77, 200, 8, 2, 64, torch.bfloat16, True, 123),    # ragged, q_offset
    (1, 77, 200, 8, 2, 128, torch.float32, True, 123),
]


@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,dtype,causal,q_offset", BWD_CASES)
def test_flash_attention_bwd_kernels_match_ref(cuda, B, Sq, Sk, H, KV, D, dtype, causal,
                                               q_offset):
    gen = torch.Generator(device=cuda).manual_seed(6)
    q = _randn(gen, (B, Sq, H, D), dtype, cuda)
    k = _randn(gen, (B, Sk, KV, D), dtype, cuda)
    v = _randn(gen, (B, Sk, KV, D), dtype, cuda)
    do = _randn(gen, (B, Sq, H, D), dtype, cuda)
    o, lse = flash_attention_fwd(q, k, v, causal=causal, q_offset=q_offset)
    delta = attention_delta(o, do)
    kw = dict(causal=causal, q_offset=q_offset)
    dk, dv = flash_attention_bwd_dkdv(q, k, v, do, lse, delta, **kw)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    want = ref.flash_attention_bwd_ref(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    for got, w, like in zip((dq, dk, dv), want, (q, k, v)):
        assert got.dtype == like.dtype and got.shape == like.shape
        assert torch.isfinite(got).all()
        _close_rel(got, w, GRAD_TOL[dtype])


def _bwd_inputs(gen, B, Sq, Sk, H, KV, D, dtype, causal, q_offset, device):
    q = _randn(gen, (B, Sq, H, D), dtype, device)
    k = _randn(gen, (B, Sk, KV, D), dtype, device)
    v = _randn(gen, (B, Sk, KV, D), dtype, device)
    do = _randn(gen, (B, Sq, H, D), dtype, device)
    o, lse = flash_attention_fwd(q, k, v, causal=causal, q_offset=q_offset)
    return q, k, v, do, lse, attention_delta(o, do)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [8, 16, 20, 64, 96, 128, 136, 256, 320, 512])
@pytest.mark.parametrize("B,Sq,Sk,G,KV,causal,q_offset", [
    (2, 256, 256, 1, 2, True, 0),       # G = 1: one head a cluster
    (1, 77, 200, 7, 2, True, 123),      # G = 7 over clusters of 4, ragged, q_offset
    (1, 130, 300, 16, 1, False, 0),     # G = 16, not causal, ragged
    (2, 192, 192, 16, 2, True, 0),      # chatglm3-6b's group, causal
])
def test_flash_attention_bwd_kernels_every_head_dim(cuda, B, Sq, Sk, G, KV, causal, q_offset, D,
                                                    dtype):
    """Both backward kernels at every head dim class the flash kernels take
    (the tensor-core builds, and the CUDA cores' for bf16 D 20, 136 and
    256, and 320 and 512 in pieces), for each way dK/dV splits a query
    group over a cluster."""
    gen = torch.Generator(device=cuda).manual_seed(14)
    q, k, v, do, lse, delta = _bwd_inputs(gen, B, Sq, Sk, G * KV, KV, D, dtype, causal,
                                          q_offset, cuda)
    kw = dict(causal=causal, q_offset=q_offset)
    dk, dv = flash_attention_bwd_dkdv(q, k, v, do, lse, delta, **kw)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    want = ref.flash_attention_bwd_ref(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    for got, w, like in zip((dq, dk, dv), want, (q, k, v)):
        assert got.dtype == like.dtype and got.shape == like.shape
        assert torch.isfinite(got).all()
        assert float(w.float().abs().max()) > 0
        _close_rel(got, w, GRAD_TOL[dtype])


def test_flash_attention_bwd_kernels_repeat_bitwise_in_cuda_graphs(cuda):
    """dq, dk and dv from two replays of one captured backward are equal bit
    for bit: no atomics, every sum in a fixed order (the dK/dV clusters sum
    their partials in rank order)."""
    gen = torch.Generator(device=cuda).manual_seed(15)
    q, k, v, do, lse, delta = _bwd_inputs(gen, 2, 1024, 1024, 32, 2, 128, torch.bfloat16,
                                          True, 0, cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capturing stream
        flash_attention_bwd_dkdv(q, k, v, do, lse, delta)
        flash_attention_bwd_dq(q, k, v, do, lse, delta)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        dk, dv = flash_attention_bwd_dkdv(q, k, v, do, lse, delta)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta)
    graph.replay()
    torch.cuda.synchronize()
    first = [t.clone() for t in (dq, dk, dv)]
    for t in (dq, dk, dv):
        t.zero_()
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(first, (dq, dk, dv)):
        assert torch.equal(a, b)
    want = ref.flash_attention_bwd_ref(q, k, v, do, lse, delta)
    for got, w in zip(first, want):
        _close_rel(got, w, GRAD_TOL[torch.bfloat16])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_trainable_grads_on_cuda(cuda, dtype):
    """Gradients of the kernel path against autograd through the plain
    forward, which keeps every [Sq, Sk] intermediate."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    B, S, H, KV, D = 2, 256, 8, 2, 128
    q = _randn(gen, (B, S, H, D), dtype, cuda).requires_grad_()
    k = _randn(gen, (B, S, KV, D), dtype, cuda).requires_grad_()
    v = _randn(gen, (B, S, KV, D), dtype, cuda).requires_grad_()
    w = _randn(gen, (B, S, H, D), dtype, cuda)
    n_kv, n_q = flash_attention_bwd_dkdv.launches, flash_attention_bwd_dq.launches
    got = torch.autograd.grad((ops.flash_attention_trainable(q, k, v, True, 0) * w).sum(),
                              (q, k, v))
    assert flash_attention_bwd_dkdv.launches == n_kv + 1
    assert flash_attention_bwd_dq.launches == n_q + 1
    want = torch.autograd.grad((ref.flash_attention_ref(q, k, v, causal=True) * w).sum(),
                               (q, k, v))
    for g, r in zip(got, want):
        _close_rel(g, r, GRAD_TOL[dtype])


def test_bwd_kernels_refuse_what_they_cannot_take(cuda):
    q = torch.zeros((1, 128, 4, 64), dtype=torch.bfloat16, device=cuda)
    lse = torch.zeros((4, 128), dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError):  # lse of the wrong shape
        flash_attention_bwd_dq(q, q[:, :, :2], q[:, :, :2], q, lse[:2], lse)
    with pytest.raises(ValueError):  # do in another dtype
        flash_attention_bwd_dkdv(q, q[:, :, :2], q[:, :, :2], q.float(), lse, lse)


@pytest.mark.parametrize("S", [128, 200])
@pytest.mark.parametrize("arch", ["chatglm3_6b", "yi_34b", "qwen2_vl_2b"])
def test_smoke_configs_train_through_the_flash_kernels(cuda, arch, S):
    """The smoke configs, unmodified (head_dim 16, 8 and 16), train through
    both backward kernels, at a sequence length that is a multiple of 128
    and at one that is not: one step's gradients in f32 against the plain
    chunked path, each leaf within 1e-4 of its largest magnitude (the key
    bias, whose gradient is zero in exact arithmetic, of the whole tree's);
    qwen2-vl from precomputed embeddings at 3-stream positions."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import concrete_batch, loss_and_grads
    from repro_torch.models.common import tree_items
    from repro_torch.models.model import Model

    cfg = get_smoke_config(arch).replace(compute_dtype="float32")
    params = Model(cfg, "cuda").init_params(seed=0)
    batch = concrete_batch(cfg, 2, S, device="cuda")
    n_kv, n_q = flash_attention_bwd_dkdv.launches, flash_attention_bwd_dq.launches
    _, got = loss_and_grads(Model(cfg.replace(attn_impl="pallas"), "cuda"), params, batch)
    assert flash_attention_bwd_dkdv.launches == n_kv + cfg.n_layers
    assert flash_attention_bwd_dq.launches == n_q + cfg.n_layers
    _, want = loss_and_grads(Model(cfg.replace(attn_impl="chunked"), "cuda"), params, batch)
    got, want = dict(tree_items(got)), dict(tree_items(want))
    tree_max = max(float(w.abs().max()) for w in want.values())
    for path, w in want.items():
        scale = tree_max if path == "layers.attn.bk" else float(w.abs().max())
        assert float((got[path] - w).abs().max()) <= GRAD_TOL[torch.float32] * scale, path


@pytest.mark.parametrize("policy", ["full", "dots", "save_collectives"])
def test_remat_policies_on_the_kernel_path(cuda, policy):
    """Each remat policy gives ``none``'s gradients on the kernel path
    (chatglm3-smoke, f32), bit for bit but for the order of sums; each
    recomputes the flash forward (``dots`` keeps only the products' outputs,
    and the kernel's ``autograd.Function`` is no product), so it launches
    twice per layer where ``none`` launches once, and the backward kernels
    once per layer under every policy."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import concrete_batch, loss_and_grads
    from repro_torch.models.common import tree_items
    from repro_torch.models.model import Model

    cfg = get_smoke_config("chatglm3_6b").replace(compute_dtype="float32", attn_impl="pallas")
    params = Model(cfg, "cuda").init_params(seed=0)
    batch = concrete_batch(cfg, 2, 128, device="cuda")
    grads, launches = {}, {}
    for p in ("none", policy):
        before = (flash_attention_fwd.launches, flash_attention_bwd_dkdv.launches,
                  flash_attention_bwd_dq.launches)
        _, g = loss_and_grads(Model(cfg.replace(remat=p), "cuda"), params, batch)
        grads[p] = dict(tree_items(g))
        launches[p] = tuple(n - b for n, b in zip(
            (flash_attention_fwd.launches, flash_attention_bwd_dkdv.launches,
             flash_attention_bwd_dq.launches), before))
    L = cfg.n_layers
    assert launches["none"] == (L, L, L)
    assert launches[policy] == (2 * L, L, L)
    for path, w in grads["none"].items():
        torch.testing.assert_close(grads[policy][path], w, rtol=1e-6, atol=1e-9, msg=path)


# ---------------------------------------------------------------------------
# the row gather, the pinned host store and a streamed decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("N,D,B,dtype,idx_dtype", [
    (65280, 4096, 4, torch.bfloat16, torch.int64),     # chatglm3-6b decode
    (65280, 4096, 2048, torch.bfloat16, torch.int64),  # its prefill
    (64, 128, 8, torch.float32, torch.int32),
    (1000, 384, 17, torch.bfloat16, torch.int32),
    (16, 130, 5, torch.float32, torch.int64),          # 8-byte copies
    (16, 130, 5, torch.bfloat16, torch.int32),         # 4-byte copies
    (7, 1, 9, torch.bfloat16, torch.int64),            # 2-byte copies
    (33, 3, 6, torch.uint8, torch.int32),              # 1-byte copies
])
def test_prefetch_gather_kernel_is_bitwise_the_plain_gather(cuda, N, D, B, dtype, idx_dtype):
    from repro_torch.kernels.prefetch_gather import prefetch_gather_fwd

    gen = torch.Generator(device=cuda).manual_seed(8)
    item = torch.empty((), dtype=dtype).element_size()
    table = torch.randint(0, 256, (N, D * item), generator=gen, device=cuda,
                          dtype=torch.uint8).view(dtype)  # any bits, NaNs included
    idx = torch.randint(0, N, (B,), generator=gen, device=cuda).to(idx_dtype)
    idx[0] = N - 1  # the last row
    if B > 2:
        idx[1] = idx[2]  # a repeated row
    got = prefetch_gather_fwd(table, idx)
    want = ref.prefetch_gather_ref(table, idx)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (B, D)
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


def test_prefetch_gather_takes_strided_tables_and_indices(cuda):
    from repro_torch.kernels.prefetch_gather import prefetch_gather_fwd

    base = torch.arange(40 * 12, dtype=torch.float32, device=cuda).reshape(40, 12)
    table = base[:, 2:9]  # rows 48 bytes apart, 28 bytes long, offset 8
    idx = torch.tensor([[3, 1], [39, 0], [5, 5]], device=cuda)[:, 0]  # stride 2
    n0 = prefetch_gather_fwd.launches
    got = ops.prefetch_gather(table, idx)
    assert prefetch_gather_fwd.launches == n0 + 1
    assert torch.equal(got, table[idx])


def test_host_param_store_round_trips_the_bytes(cuda):
    from repro_torch.runtime.prefetch import HostParamStore

    gen = torch.Generator(device=cuda).manual_seed(9)
    params = {"a": _randn(gen, (33, 7), torch.bfloat16, cuda),
              "b": {"c": _randn(gen, (5,), torch.float32, cuda),
                    "d": torch.randint(0, 9, (3, 3), generator=gen, device=cuda)}}
    store = HostParamStore(params, device="cuda")
    assert store.pinned_bytes >= sum(store.nbytes(p) for p in store.arrays)
    for path, want in (("a", params["a"]), ("b.c", params["b"]["c"]), ("b.d", params["b"]["d"])):
        assert store.arrays[path].is_pinned()
        got = store.fetch(path)
        assert got.is_cuda and got.dtype == want.dtype
        assert torch.equal(got, want)


def test_streamed_decode_equals_resident_decode(cuda):
    """A decode step whose weights stream from pinned host memory under each
    mode gives the resident step's logits, bit for bit, and runs both
    kernels of the step."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.prefetch_gather import prefetch_gather_fwd
    from repro_torch.launch.serve import Server
    from repro_torch.launch.steps import concrete_batch
    from repro_torch.runtime.prefetch import HostParamStore, WeightStreamer

    cfg = get_smoke_config("chatglm3_6b").replace(attn_impl="pallas")  # head_dim 16
    server = Server(cfg, device="cuda", max_len=256)
    params = server.model.compute_params(server.model.init_params(seed=0))
    batch = concrete_batch(cfg, 2, 128, device="cuda")
    batch.pop("targets")
    logits, cache = server.prefill_fn(params, batch)
    cache = server._pad_cache(cache)
    tok = torch.argmax(logits, dim=-1)
    want, _ = server.decode_fn(params, {k: v.clone() for k, v in cache.items()}, tok, 128)
    plan = server.plan(2)
    store = HostParamStore(params, device="cuda")
    for mode in (None, "rop", "capre", "markov", "hybrid"):
        ws = WeightStreamer(store, plan, mode=mode, k_ahead=3, workers=8,
                            warm_group_trace=[-1, 0, 1, 2, 3])
        g0, d0 = prefetch_gather_fwd.launches, decode_attention_fwd.launches
        got, _ = server.stream_decode(ws, {k: v.clone() for k, v in cache.items()}, tok, 128)
        ws.close()
        torch.cuda.synchronize()
        assert prefetch_gather_fwd.launches == g0 + 1
        assert decode_attention_fwd.launches == d0 + cfg.n_layers
        assert ws.metrics.fetch_timeouts == 0 and ws.metrics.fetches == len(plan.records)
        assert torch.equal(got, want), mode


# ---------------------------------------------------------------------------
# the recurrent scans (mamba, RG-LRU)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,S,Ch,N", [
    (4, 512, 8192, 16),  # falcon-mamba-7b prefill: two threads per channel
    (16, 64, 8192, 16),  # one thread per channel
    (4, 1, 8192, 16),    # falcon-mamba-7b decode
    (2, 7, 300, 16),     # channels not a multiple of the block
    (1, 128, 97, 4),     # N below a warp's share
    (3, 33, 64, 5),      # N not a power of two
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_h0", [False, True])
def test_mamba_scan_kernel_matches_ref(cuda, B, S, Ch, N, dtype, with_h0):
    from repro_torch.kernels.mamba_scan import mamba_scan_fwd

    gen = torch.Generator(device=cuda).manual_seed(10)
    dA = (0.3 + 0.69 * torch.rand((B, S, Ch, N), generator=gen, device=cuda)).to(dtype)
    dBu = (0.1 * torch.randn((B, S, Ch, N), generator=gen, device=cuda)).to(dtype)
    C = torch.randn((B, S, N), generator=gen, device=cuda).to(dtype)
    h0 = torch.randn((B, Ch, N), generator=gen, device=cuda) if with_h0 else None
    y, h = mamba_scan_fwd(dA, dBu, C, h0, with_state=True)
    y_ref, h_ref = ref.mamba_scan_ref(dA, dBu, C, h0, with_state=True)
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.shape == (B, S, Ch) and h.dtype == torch.float32
    _close(y, y_ref, **TOL[dtype])
    _close(h, h_ref, **TOL[torch.float32])  # the state is f32 for either input


@pytest.mark.parametrize("B,S,W", [
    (4, 512, 2560),   # recurrentgemma-2b prefill
    (4, 1, 2560),     # recurrentgemma-2b decode
    (2, 7, 300),      # channels not a multiple of the block
    (3, 129, 384),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_kernel_matches_ref(cuda, B, S, W, dtype, with_h0):
    from repro_torch.kernels.rglru_scan import rglru_scan_fwd

    gen = torch.Generator(device=cuda).manual_seed(11)
    a = (0.5 + 0.49 * torch.rand((B, S, W), generator=gen, device=cuda)).to(dtype)
    g = (0.1 * torch.randn((B, S, W), generator=gen, device=cuda)).to(dtype)
    h0 = torch.randn((B, W), generator=gen, device=cuda) if with_h0 else None
    y = rglru_scan_fwd(a, g, h0)
    want = ref.rglru_scan_ref(a, g, h0)
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.shape == (B, S, W)
    if dtype == torch.float32:  # the same products and sums, rounded alike
        assert torch.equal(y, want)
    _close(y, want, **TOL[dtype])


def test_scan_ops_launch_the_kernels_and_refuse_what_they_cannot_take(cuda):
    from repro_torch.kernels.mamba_scan import mamba_scan_fwd
    from repro_torch.kernels.rglru_scan import rglru_scan_fwd

    x = torch.rand((2, 3, 16, 8), device=cuda)
    m0, r0 = mamba_scan_fwd.launches, rglru_scan_fwd.launches
    ops.mamba_scan(x, x, x[..., 0, :])
    ops.rglru_scan(x[..., 0], x[..., 0])
    assert (mamba_scan_fwd.launches, rglru_scan_fwd.launches) == (m0 + 1, r0 + 1)
    with pytest.raises(ValueError):  # N > 32
        mamba_scan_fwd(torch.zeros((1, 2, 4, 33), device=cuda),
                       torch.zeros((1, 2, 4, 33), device=cuda),
                       torch.zeros((1, 2, 33), device=cuda))
    with pytest.raises(TypeError):
        rglru_scan_fwd(x[..., 0].half(), x[..., 0].half())
    with pytest.raises(ValueError):  # h0 must be f32
        rglru_scan_fwd(x[..., 0], x[..., 0], torch.zeros((2, 16), device=cuda).bfloat16())


def _mamba_inputs(gen, B, S, Ch, N, dtype, with_h0, device, R=5):
    """The selective scan's inputs as the model makes them: B and C strided
    slices of one projection, A and D in f32, dt softplus'd."""
    proj = _randn(gen, (B, S, R + 2 * N), dtype, device)
    return {
        "u": _randn(gen, (B, S, Ch), dtype, device),
        "dt": ref.softplus(_randn(gen, (B, S, Ch), torch.float32, device) - 1.0).to(dtype),
        "A": -torch.exp(0.5 * _randn(gen, (Ch, N), torch.float32, device)),
        "B_ssm": proj[..., R:R + N], "C_ssm": proj[..., R + N:],
        "D": _randn(gen, (Ch,), torch.float32, device),
        "h0": _randn(gen, (B, Ch, N), torch.float32, device) if with_h0 else None,
    }


@pytest.mark.parametrize("B,S,Ch,N", [
    (4, 512, 8192, 16),  # falcon-mamba-7b prefill: two threads per channel
    (16, 64, 8192, 16),  # one thread per channel
    (4, 1, 8192, 16),    # falcon-mamba-7b decode
    (2, 7, 301, 16),     # channels not a multiple of the block
    (1, 128, 97, 4),     # N below 16
    (3, 33, 64, 5),      # N not a power of two
    (2, 1, 45, 13),      # decode with N not a multiple of 4
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_h0", [False, True])
def test_selective_scan_kernel_matches_ref(cuda, B, S, Ch, N, dtype, with_h0):
    """The fused selective scan against its plain version: y within 1e-5
    (f32) and 2e-2 (bf16) of the largest |y| (the N-term sum of y in
    another order), the last state within 1e-5 of the largest |h|.  The
    shapes take every split of a channel's states over threads that
    ``scan_lanes`` makes on an H100: 1 (B 16), 2 (B 4) and 4 (the narrow
    widths) at S > 1."""
    from repro_torch.kernels.selective_scan import selective_scan_fwd

    gen = torch.Generator(device=cuda).manual_seed(16)
    x = _mamba_inputs(gen, B, S, Ch, N, dtype, with_h0, cuda)
    y, h = selective_scan_fwd(**x)
    y_ref, h_ref = ref.selective_scan_ref(**x)
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.shape == (B, S, Ch)
    assert h.dtype == torch.float32 and h.shape == (B, Ch, N)
    _close_rel(y, y_ref, TOL[dtype]["atol"])
    _close_rel(h, h_ref, TOL[torch.float32]["atol"])


@pytest.mark.parametrize("S", [1, 7])
def test_selective_scan_kernel_updates_the_state_in_place(cuda, S):
    """With h_out = h0 the kernel writes the last state over the initial one
    (each thread reads its state before it writes it), as the decode does
    with its cache: the same y and state as the out-of-place call."""
    from repro_torch.kernels.selective_scan import selective_scan_fwd

    gen = torch.Generator(device=cuda).manual_seed(17)
    x = _mamba_inputs(gen, 4, S, 8192, 16, torch.bfloat16, True, cuda)
    y, h = selective_scan_fwd(**x)
    state = x["h0"].clone()
    y2, h2 = selective_scan_fwd(**dict(x, h0=state), h_out=state)
    torch.cuda.synchronize()
    assert h2.data_ptr() == state.data_ptr()
    assert torch.equal(h2, h) and torch.equal(y2, y)


@pytest.mark.parametrize("B,S,W", [
    (4, 512, 2560),   # recurrentgemma-2b prefill
    (4, 1, 2560),     # recurrentgemma-2b decode
    (2, 7, 300),      # channels not a multiple of the block; bf16 rows not 16-byte aligned
    (3, 129, 384),
    (1, 300, 2500),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_gated_kernel_is_bitwise_its_plain_version(cuda, B, S, W, dtype, with_h0):
    """The fused RG-LRU kernel forms the gates with the plain version's
    rounding points (expf, products and sums rounded apart), so y and the
    last state are its plain version's bit for bit, in f32 and in bf16."""
    from repro_torch.kernels.rglru_scan import rglru_gated_fwd

    gen = torch.Generator(device=cuda).manual_seed(18)
    x = _randn(gen, (B, S, W), dtype, cuda)
    r = torch.sigmoid(_randn(gen, (B, S, W), torch.float32, cuda)).to(dtype)
    i = torch.sigmoid(_randn(gen, (B, S, W), torch.float32, cuda)).to(dtype)
    lam = _randn(gen, (W,), torch.float32, cuda)
    h0 = _randn(gen, (B, W), torch.float32, cuda) if with_h0 else None
    y, h = rglru_gated_fwd(x, r, i, ref.rglru_decay(lam), h0)
    y_ref, h_ref = ref.rglru_gated_scan_ref(x, r, i, lam, h0)
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.shape == (B, S, W) and h.shape == (B, W)
    assert torch.equal(y, y_ref) and torch.equal(h, h_ref)


def test_fused_scan_ops_launch_the_kernels(cuda):
    from repro_torch.kernels.rglru_scan import rglru_gated_fwd
    from repro_torch.kernels.selective_scan import selective_scan_fwd

    gen = torch.Generator(device=cuda).manual_seed(19)
    x = _mamba_inputs(gen, 2, 3, 40, 8, torch.float32, True, cuda)
    s0, g0 = selective_scan_fwd.launches, rglru_gated_fwd.launches
    ops.selective_scan(**x)
    w = torch.rand((2, 3, 40), device=cuda)
    ops.rglru_gated_scan(w, w, w, w[0, 0])
    assert (selective_scan_fwd.launches, rglru_gated_fwd.launches) == (s0 + 1, g0 + 1)
    with pytest.raises(ValueError):  # N > 32
        selective_scan_fwd(**_mamba_inputs(gen, 1, 2, 4, 33, torch.float32, False, cuda))
    with pytest.raises(ValueError):  # h_out not contiguous
        selective_scan_fwd(**x, h_out=torch.zeros((2, 8, 40), device=cuda).transpose(1, 2))
    with pytest.raises(TypeError):
        rglru_gated_fwd(w.half(), w.half(), w.half(), w[0, 0])


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "recurrentgemma_2b"])
def test_recurrent_kernel_path_matches_plain_path(cuda, arch):
    """The smoke models in f32 on the card: prefill and three decode steps
    on the kernel path (``attn_impl="pallas"``: the fused scan kernels)
    against the plain loop over time (``"chunked"``), within 1e-5 of the
    largest logit, with one fused scan launch per recurrent layer per
    call."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.rglru_scan import rglru_gated_fwd
    from repro_torch.kernels.selective_scan import selective_scan_fwd
    from repro_torch.launch.serve import Server
    from repro_torch.launch.steps import concrete_batch
    from repro_torch.models.transformer import block_kinds

    base = get_smoke_config(arch).replace(compute_dtype="float32")
    counter = selective_scan_fwd if base.family == "ssm" else rglru_gated_fwd
    per_call = (base.n_layers if base.family == "ssm"
                else block_kinds(base).count("rec"))
    params = Server(base, device="cuda").model.init_params(seed=0)
    batch = concrete_batch(base, 2, 16, device="cuda")
    out = {}
    for impl in ("pallas", "chunked"):
        server = Server(base.replace(attn_impl=impl), device="cuda", max_len=19)
        n0 = counter.launches
        logits, cache = server.prefill_fn(params, {"inputs": batch["inputs"]})
        cache = server._pad_cache(cache)
        steps = [logits]
        for i in range(3):
            logits, cache = server.decode_fn(params, cache, batch["targets"][:, i : i + 1],
                                             16 + i)
            steps.append(logits)
        out[impl] = torch.cat(steps, dim=1)
        assert counter.launches - n0 == (4 * per_call if impl == "pallas" else 0)
    scale = float(out["chunked"].abs().max())
    assert float((out["pallas"] - out["chunked"]).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b", "granite_moe_1b_a400m"])
def test_moe_kernel_path_matches_plain_path(cuda, arch):
    """The moe smoke models in f32 on the card: prefill and three decode
    steps through the flash kernels (``attn_impl="pallas"``) against the
    plain chunked path, within 1e-5 of the largest logit, with the same
    router choices on both paths, one flash forward per layer and one
    flash-decode per layer per step."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import Server
    from repro_torch.launch.steps import concrete_batch
    from repro_torch.models import moe

    base = get_smoke_config(arch).replace(compute_dtype="float32")
    params = Server(base, device="cuda").model.init_params(seed=0)
    batch = concrete_batch(base, 2, 128, device="cuda")  # any length takes the flash kernels
    routes = {}
    topk = moe.router_topk

    def recording(*args, **kw):
        top_p, top_i = topk(*args, **kw)
        routes[impl].append(torch.sort(top_i, dim=-1).values)
        return top_p, top_i

    out = {}
    try:
        moe.router_topk = recording
        for impl in ("pallas", "chunked"):
            routes[impl] = []
            server = Server(base.replace(attn_impl=impl), device="cuda", max_len=256)
            f0, d0 = flash_attention_fwd.launches, decode_attention_fwd.launches
            logits, cache = server.prefill_fn(params, {"inputs": batch["inputs"]})
            cache = server._pad_cache(cache)
            steps = [logits]
            for i in range(3):
                logits, cache = server.decode_fn(params, cache,
                                                 batch["targets"][:, i : i + 1], 128 + i)
                steps.append(logits)
            out[impl] = torch.cat(steps, dim=1)
            on_path = impl == "pallas"
            assert flash_attention_fwd.launches - f0 == (base.n_layers if on_path else 0)
            assert decode_attention_fwd.launches - d0 == (3 * base.n_layers if on_path else 0)
    finally:
        moe.router_topk = topk
    assert len(routes["pallas"]) == len(routes["chunked"]) == 4 * base.n_layers
    for a, b in zip(routes["pallas"], routes["chunked"]):
        assert torch.equal(a, b)
    scale = float(out["chunked"].abs().max())
    assert float((out["pallas"] - out["chunked"]).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("arch", ["whisper_large_v3", "qwen2_vl_2b"])
def test_encdec_and_mrope_kernel_path_matches_plain_path(cuda, arch):
    """whisper-smoke (at 256 frames; its encoder and cross-attention take the
    flash kernel at any length on the card) and qwen2vl-smoke (prompt as embeddings at
    3-stream positions) in f32 on the card: prefill and three decode steps
    through the flash kernels against the plain chunked path, within 1e-5
    of the largest logit; flash forwards: one per attention of the prefill
    (whisper: encoder, decoder and cross-attention per layer), flash-decode
    one per layer per step."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import Server
    from repro_torch.launch.steps import concrete_batch

    base = get_smoke_config(arch).replace(compute_dtype="float32")
    if base.family == "encdec":
        base = base.replace(enc_positions=256)
        n_flash = base.enc_layers + 2 * base.n_layers
    else:
        n_flash = base.n_layers
    params = Server(base, device="cuda").model.init_params(seed=0)
    batch = concrete_batch(base, 2, 128, device="cuda")
    targets = batch.pop("targets")
    out = {}
    for impl in ("pallas", "chunked"):
        server = Server(base.replace(attn_impl=impl), device="cuda", max_len=256)
        f0, d0 = flash_attention_fwd.launches, decode_attention_fwd.launches
        logits, cache = server.prefill_fn(params, batch)
        cache = server._pad_cache(cache)
        steps = [logits]
        for i in range(3):
            logits, cache = server.decode_fn(params, cache, targets[:, i : i + 1], 128 + i)
            steps.append(logits)
        out[impl] = torch.cat(steps, dim=1)
        on_path = impl == "pallas"
        assert flash_attention_fwd.launches - f0 == (n_flash if on_path else 0)
        assert decode_attention_fwd.launches - d0 == (3 * base.n_layers if on_path else 0)
    scale = float(out["chunked"].abs().max())
    assert float((out["pallas"] - out["chunked"]).abs().max()) <= 1e-5 * scale


# (arch, prompt tokens, audio frames or 0): chatglm3-smoke's causal prefill
# at lengths that are not multiples of 128, and whisper-smoke's encoder
# (300 x 300) and cross-attention (130 x 300), which are not causal
RAGGED_PREFILLS = [("chatglm3_6b", 100, 0), ("chatglm3_6b", 333, 0), ("chatglm3_6b", 1000, 0),
                   ("whisper_large_v3", 130, 300)]


@pytest.mark.parametrize("arch,S,frames", RAGGED_PREFILLS)
def test_ragged_prefill_runs_the_flash_forward(cuda, arch, S, frames):
    """A batch-1 ``Model.prefill`` in f32 at ragged lengths: on the card the
    flash forward runs once per attention (whisper: decoder, encoder and
    cross-attention per layer), where the JAX package's 128-multiple guard
    would send it to the chunked path; its logits and every cache tensor
    within 1e-5 of the largest magnitude of the plain chunked path's."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import concrete_batch
    from repro_torch.models.model import Model

    base = get_smoke_config(arch).replace(compute_dtype="float32")
    n_flash = base.n_layers
    if frames:
        base = base.replace(enc_positions=frames)
        n_flash += base.enc_layers + base.n_layers
    params = Model(base, "cuda").init_params(seed=0)
    batch = concrete_batch(base, 1, S, device="cuda")
    batch.pop("targets")
    out = {}
    for impl in ("pallas", "chunked"):
        f0 = flash_attention_fwd.launches
        with torch.inference_mode():
            out[impl] = Model(base.replace(attn_impl=impl), "cuda").prefill(params, batch)
        assert flash_attention_fwd.launches - f0 == (n_flash if impl == "pallas" else 0)
    (got, got_cache), (want, want_cache) = out["pallas"], out["chunked"]
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert sorted(got_cache) == sorted(want_cache)
    for key, w in want_cache.items():
        scale = float(w.abs().max())
        assert float((got_cache[key] - w).abs().max()) <= 1e-5 * scale, key


def test_batcher_admission_of_ragged_prompts_counts_the_flash_forward(cuda):
    """The continuous batcher given an ``EngineTrace``: each ``engine.admit``
    span of a prompt that is not a multiple of 128 (7, 100 and 129 tokens)
    records ``flash`` equal to the layers, the count that the benchmark's
    flash-forward coverage reads."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import Model
    from repro_torch.obs.engine import EngineTrace
    from repro_torch.runtime.scheduler import ContinuousBatcher, Request

    cfg = get_smoke_config("chatglm3_6b").replace(compute_dtype="bfloat16", attn_impl="pallas")
    model = Model(cfg, device="cuda")
    params = model.compute_params(model.init_params(seed=0))
    trace = EngineTrace()
    b = ContinuousBatcher(model, params, batch_size=2, max_len=256, trace=trace)
    rng = np.random.RandomState(0)
    lens = (100, 7, 129)
    for rid, S in enumerate(lens):
        b.submit(Request(rid=rid, prompt=rng.randint(0, cfg.vocab_size, size=S),
                         max_new_tokens=3))
    b.run_until_drained()
    admits = {s.rid: s.attrs for s in trace.take() if s.name == "engine.admit"}
    assert {rid: (a["S"], a["flash"]) for rid, a in admits.items()} == {
        rid: (S, cfg.n_layers) for rid, S in enumerate(lens)}


# ---------------------------------------------------------------------------
# flash-decode's kv_len in device memory, and the captured decode step
# ---------------------------------------------------------------------------


def _kv(n, device):
    return torch.full((1,), n, dtype=torch.int32, device=device)


@pytest.mark.parametrize("q_dtype,kv_dtype,D", [
    (torch.bfloat16, torch.bfloat16, 128),      # tensor cores
    (torch.bfloat16, torch.float8_e4m3fn, 64),  # tensor cores, fp8 cache
    (torch.float32, torch.bfloat16, 128),       # CUDA cores
    (torch.float32, torch.float8_e4m3fn, 64),   # CUDA cores, fp8 cache
])
def test_decode_device_kv_len_is_bitwise_the_int_form(cuda, q_dtype, kv_dtype, D):
    """kv_len read from device memory, at 1, around the 16-key steps and the
    splits of the capacity-sized grid, and at S: the int form's output bit
    for bit, and the plain version's within the tolerance."""
    from repro_torch.kernels import decode_attention as dec

    B, S, H, KV = 4, 1024, 32, 2
    gen = torch.Generator(device=cuda).manual_seed(11)
    q = _randn(gen, (B, H, D), q_dtype, cuda)
    k = _randn(gen, (B, S, KV, D), kv_dtype, cuda)
    v = _randn(gen, (B, S, KV, D), kv_dtype, cuda)
    n_sm = dec._sm_count(cuda.index or 0)
    if dec.variant(q_dtype, kv_dtype, D) == "mma":
        split_len = dec.mma_split_plan(B, KV, dec.n_head_tiles(H, KV), S, n_sm)[0]
    else:
        split_len = dec.split_plan(B, KV, S, n_sm)[0]
    lens = sorted({1, 15, 16, 17, split_len - 1, split_len, split_len + 1, 528, S - 1, S})
    for kv_len in lens:
        want = decode_attention_fwd(q, k, v, kv_len)
        got = decode_attention_fwd(q, k, v, _kv(kv_len, cuda))
        torch.cuda.synchronize()
        assert torch.equal(got, want), kv_len
        _close(got, ref.decode_attention_ref(q, k, v, kv_len), **TOL[q_dtype])
    assert int(dec._COUNTERS[cuda.index or 0].abs().sum()) == 0


@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
def test_decode_capture_replays_at_every_kv_len(cuda, q_dtype):
    """One captured flash-decode, its length written into the device int
    between replays, equals a fresh call at each length."""
    from repro_torch.kernels import decode_attention as dec

    gen = torch.Generator(device=cuda).manual_seed(12)
    q = _randn(gen, (4, 32, 128), q_dtype, cuda)
    k = _randn(gen, (4, 1024, 2, 128), torch.bfloat16, cuda)
    v = _randn(gen, (4, 1024, 2, 128), torch.bfloat16, cuda)
    kv = _kv(1, cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        decode_attention_fwd(q, k, v, kv)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = decode_attention_fwd(q, k, v, kv)
    for kv_len in (1, 17, 528, 64, 1024, 2, 528):
        kv.fill_(kv_len)
        graph.replay()
        want = decode_attention_fwd(q, k, v, kv_len)
        torch.cuda.synchronize()
        assert torch.equal(out, want), kv_len
    assert int(dec._COUNTERS[cuda.index or 0].abs().sum()) == 0


GRAPH_CASES = [("chatglm3_6b", "bfloat16"), ("chatglm3_6b", "float32"),
               ("qwen3_moe_30b_a3b", "bfloat16"), ("granite_moe_1b_a400m", "float32"),
               ("falcon_mamba_7b", "bfloat16"), ("recurrentgemma_2b", "bfloat16"),
               ("recurrentgemma_2b", "float32"), ("whisper_large_v3", "bfloat16"),
               ("qwen2_vl_2b", "bfloat16")]


@pytest.mark.parametrize("arch,dtype", GRAPH_CASES)
def test_captured_generate_is_bitwise_the_eager_loop(cuda, arch, dtype):
    """``Server.generate`` on the card replays one captured step: its tokens
    and the logits of every step equal the eager loop's bit for bit (the
    same kernels at the same grids), with the hybrid's ring wrapping, and
    with whisper's cross k/v and qwen2-vl's embedded prompt."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import Server
    from repro_torch.launch.steps import concrete_batch

    cfg = get_smoke_config(arch).replace(compute_dtype=dtype, attn_impl="pallas")
    server = Server(cfg, device="cuda", max_len=256)
    params = server.model.compute_params(server.model.init_params(seed=0))
    batch = concrete_batch(cfg, 2, 16, device="cuda")
    batch.pop("targets")
    for _ in range(2):  # the first call captures, the second reuses
        tokens, logits = server.generate(params, batch, 12, with_logits=True)
        want_tokens, want_logits = server.generate_eager(params, batch, 12, with_logits=True)
        torch.cuda.synchronize()
        assert torch.equal(tokens, want_tokens)
        assert torch.equal(logits, want_logits)
    assert list(server._captured) == [2]


@pytest.mark.parametrize("arch", ["chatglm3_6b", "qwen3_moe_30b_a3b", "falcon_mamba_7b",
                                  "recurrentgemma_2b"])
def test_captured_generate_counts_the_eager_launches(cuda, arch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import counters
    from repro_torch.launch.serve import Server
    from repro_torch.launch.steps import concrete_batch

    cfg = get_smoke_config(arch).replace(compute_dtype="bfloat16", attn_impl="pallas")
    server = Server(cfg, device="cuda", max_len=256)
    params = server.model.compute_params(server.model.init_params(seed=0))
    batch = {"inputs": concrete_batch(cfg, 2, 16, device="cuda")["inputs"]}
    server.generate(params, batch, 2)  # captures
    counted = {}
    for run in (server.generate_eager, server.generate):
        before = counters.snapshot()
        run(params, batch, 9)
        counted[run.__name__] = counters.since(before)
    assert counted["generate"] == counted["generate_eager"]
    assert counted["generate"][(counters.prefetch_gather_fwd, "launches")] == 9


# ---------------------------------------------------------------------------
# flash-decode with a length per row, and the continuous batcher's captured step
# ---------------------------------------------------------------------------

ROW_CASES = [
    (torch.bfloat16, torch.bfloat16, 128),      # tensor cores
    (torch.bfloat16, torch.float8_e4m3fn, 128),  # tensor cores, fp8 cache
    (torch.bfloat16, torch.bfloat16, 96),       # CUDA cores (a head dim the mma builds lack)
    (torch.float32, torch.float32, 128),        # CUDA cores
    (torch.float32, torch.float8_e4m3fn, 64),   # CUDA cores, fp8 cache
]


def _row_lens(B, S, split_len, device):
    """Mixed lengths per row: 1, S, around a split edge and a 16-key step."""
    lens = [1, S, split_len, split_len + 1, 17, 528, S - 1, 16][:B]
    return torch.tensor(lens, dtype=torch.int32, device=device)


@pytest.mark.parametrize("q_dtype,kv_dtype,D", ROW_CASES)
def test_decode_per_row_kv_len_matches_ref(cuda, q_dtype, kv_dtype, D):
    """A [B] int32 kv_len, each row at its own length (1 and S among them),
    against the plain version with the same lengths, on both variants; the
    tickets are zero afterwards."""
    from repro_torch.kernels import decode_attention as dec

    B, S, H, KV = 8, 1024, 32, 2
    gen = torch.Generator(device=cuda).manual_seed(21)
    q = _randn(gen, (B, H, D), q_dtype, cuda)
    k = _randn(gen, (B, S, KV, D), kv_dtype, cuda)
    v = _randn(gen, (B, S, KV, D), kv_dtype, cuda)
    n_sm = dec._sm_count(cuda.index or 0)
    if dec.variant(q_dtype, kv_dtype, D) == "mma":
        split_len = dec.mma_split_plan(B, KV, dec.n_head_tiles(H, KV), S, n_sm)[0]
    else:
        split_len = dec.split_plan(B, KV, S, n_sm)[0]
    lens = _row_lens(B, S, split_len, cuda)
    got = decode_attention_fwd(q, k, v, lens)
    torch.cuda.synchronize()
    _close(got, ref.decode_attention_ref(q, k, v, lens), **TOL[q_dtype])
    for b in range(B):  # row b is the scalar form at its own length
        alone = decode_attention_fwd(q[b : b + 1], k[b : b + 1], v[b : b + 1], int(lens[b]))
        _close(got[b : b + 1], alone, **TOL[q_dtype])
    assert int(dec._COUNTERS[cuda.index or 0].abs().sum()) == 0


@pytest.mark.parametrize("q_dtype,kv_dtype,D", ROW_CASES)
def test_decode_per_row_kv_len_at_one_length_is_bitwise_the_scalar_form(cuda, q_dtype, kv_dtype,
                                                                        D):
    """Every row at one length: the [B] form gives the scalar form's output
    bit for bit, and counts its launch the same way."""
    B, S, H, KV = 8, 1024, 32, 2
    gen = torch.Generator(device=cuda).manual_seed(22)
    q = _randn(gen, (B, H, D), q_dtype, cuda)
    k = _randn(gen, (B, S, KV, D), kv_dtype, cuda)
    v = _randn(gen, (B, S, KV, D), kv_dtype, cuda)
    for L in (1, 17, 528, S):
        want = decode_attention_fwd(q, k, v, _kv(L, cuda))
        n = (decode_attention_fwd.launches, decode_attention_fwd.launches_mma,
             decode_attention_fwd.launches_simt)
        got = decode_attention_fwd(q, k, v, torch.full((B,), L, dtype=torch.int32, device=cuda))
        torch.cuda.synchronize()
        assert torch.equal(got, want), L
        moved = (decode_attention_fwd.launches - n[0], decode_attention_fwd.launches_mma - n[1],
                 decode_attention_fwd.launches_simt - n[2])
        assert moved[0] == 1 and moved[1] + moved[2] == 1


def test_decode_per_row_capture_replays_at_every_mix_of_lengths(cuda):
    """One captured flash-decode with a [B] kv_len, rewritten between
    replays, equals a fresh call at each mix."""
    gen = torch.Generator(device=cuda).manual_seed(23)
    q = _randn(gen, (4, 32, 128), torch.bfloat16, cuda)
    k = _randn(gen, (4, 1024, 2, 128), torch.bfloat16, cuda)
    lens = torch.ones((4,), dtype=torch.int32, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        decode_attention_fwd(q, k, k, lens)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = decode_attention_fwd(q, k, k, lens)
    for mix in ((1, 1024, 17, 528), (64, 2, 1024, 1), (528, 528, 528, 528)):
        lens.copy_(torch.tensor(mix, dtype=torch.int32))
        graph.replay()
        want = decode_attention_fwd(q, k, k, lens.clone())
        torch.cuda.synchronize()
        assert torch.equal(out, want), mix


@pytest.mark.parametrize("arch,dtype", [("chatglm3_6b", "bfloat16"), ("chatglm3_6b", "float32"),
                                        ("qwen3_moe_30b_a3b", "bfloat16")])
def test_captured_batcher_is_bitwise_the_eager_batcher(cuda, arch, dtype):
    """The continuous batcher's captured per-slot step against its eager
    step over the same request stream: every tick's logits bit for bit and
    every request's tokens; the captured run counts the eager run's
    launches; flash-decode once per layer and tick, the gather once per
    admission and tick."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import counters
    from repro_torch.models.model import Model
    from repro_torch.runtime.scheduler import ContinuousBatcher, Request

    cfg = get_smoke_config(arch).replace(compute_dtype=dtype, attn_impl="pallas")
    model = Model(cfg, device="cuda")
    params = model.compute_params(model.init_params(seed=0))
    rng = np.random.RandomState(0)
    spec = [(rng.randint(0, cfg.vocab_size, size=s), n)
            for s, n in ((128, 9), (40, 5), (256, 12), (7, 3), (128, 6), (99, 8))]
    runs = {}
    for captured in (True, False):
        b = ContinuousBatcher(model, params, batch_size=4, max_len=512, captured=captured)
        for i, (p, n) in enumerate(spec):
            b.submit(Request(rid=i, prompt=p, max_new_tokens=n))
        before = counters.snapshot()
        ticks = []
        while b.queue or any(s.busy for s in b.slots):
            b.step()
            ticks.append(b.logits.clone())
        runs[captured] = ({r.rid: r.output for r in b.finished}, torch.stack(ticks),
                          counters.since(before), b.steps)
    (tok_g, log_g, n_g, steps), (tok_e, log_e, n_e, _) = runs[True], runs[False]
    assert tok_g == tok_e
    assert torch.equal(log_g, log_e)
    assert n_g == n_e
    assert n_g[(counters.decode_attention_fwd, "launches")] == steps * cfg.n_layers
    assert n_g[(counters.prefetch_gather_fwd, "launches")] == steps + len(spec)
    # every prompt of more than one token, ragged or not
    assert n_g[(counters.flash_attention_fwd, "launches")] == len(spec) * cfg.n_layers


def test_captured_batcher_tick_has_no_host_sync(cuda):
    """One captured tick's copies in and replay under
    ``torch.cuda.set_sync_debug_mode("error")``: only the read of the next
    tokens waits for the device."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import Model
    from repro_torch.runtime.scheduler import ContinuousBatcher

    cfg = get_smoke_config("chatglm3_6b").replace(compute_dtype="bfloat16", attn_impl="pallas")
    model = Model(cfg, device="cuda")
    params = model.compute_params(model.init_params(seed=0))
    b = ContinuousBatcher(model, params, batch_size=4, max_len=256)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            b._replay(np.full((4, 1), 3, np.int64), np.array([5, 0, 9, 100], np.int64))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(b._graph.logits).all())


# ---------------------------------------------------------------------------
# flash-decode's log-sum-exp and sharded serving
# ---------------------------------------------------------------------------

# (q dtype, cache dtype, B, S, H, KV, D): the tensor-core variant at
# chatglm3-6b's decode (one split and several), the CUDA-core one in f32
# and in bf16 at a head dim the tensor cores do not take
LSE_CASES = [
    ("mma", torch.bfloat16, torch.bfloat16, 4, 512, 32, 2, 128),
    ("mma", torch.bfloat16, torch.float8_e4m3fn, 2, 256, 8, 2, 64),
    ("simt", torch.float32, torch.float32, 4, 512, 32, 2, 128),
    ("simt", torch.bfloat16, torch.bfloat16, 2, 256, 8, 2, 96),
]


def _lse_inputs(cuda, q_dtype, kv_dtype, B, S, H, KV, D, seed=30):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return (_randn(gen, (B, H, D), q_dtype, cuda), _randn(gen, (B, S, KV, D), kv_dtype, cuda),
            _randn(gen, (B, S, KV, D), kv_dtype, cuda))


@pytest.mark.parametrize("form", ["int", "device", "per_row"])
@pytest.mark.parametrize("variant,q_dtype,kv_dtype,B,S,H,KV,D", LSE_CASES)
def test_decode_lse_matches_ref(cuda, variant, q_dtype, kv_dtype, B, S, H, KV, D, form):
    """Both variants' lse against the plain version's at the int, device
    and per-row ``kv_len``; o with lse asked for is bitwise o without."""
    from repro_torch.kernels import decode_attention as dec

    assert dec.variant(q_dtype, kv_dtype, D) == variant
    q, k, v = _lse_inputs(cuda, q_dtype, kv_dtype, B, S, H, KV, D)
    for length in (1, 17, S // 2 + 3, S):
        if form == "int":
            kv = length
        elif form == "device":
            kv = torch.full((1,), length, dtype=torch.int32, device=cuda)
        else:
            kv = torch.tensor([length, 1, S, S // 3][:B], dtype=torch.int32, device=cuda)
        o, lse = decode_attention_fwd(q, k, v, kv, with_lse=True)
        plain_o = decode_attention_fwd(q, k, v, kv)
        want_o, want_lse = ref.decode_attention_ref(q, k, v, kv, with_lse=True)
        torch.cuda.synchronize()
        assert lse.dtype == torch.float32 and tuple(lse.shape) == (B, H)
        assert torch.equal(o, plain_o), (form, length)
        _close(o, want_o, **TOL[q_dtype])
        _close(lse, want_lse, **TOL[q_dtype])


@pytest.mark.parametrize("variant,q_dtype,kv_dtype,B,S,H,KV,D", LSE_CASES)
def test_decode_empty_rows_weigh_nothing(cuda, variant, q_dtype, kv_dtype, B, S, H, KV, D):
    """A per-row ``kv_len`` of 0 or below (a shard that holds no live key)
    gives zero o and lse <= -1e29; merged with a live part it weighs exactly
    0, with no NaN."""
    from repro_torch.models.layers import merge_partials

    q, k, v = _lse_inputs(cuda, q_dtype, kv_dtype, B, S, H, KV, D)
    lens = torch.tensor([0, -5, 7, S][:B], dtype=torch.int32, device=cuda)
    o, lse = decode_attention_fwd(q, k, v, lens, with_lse=True)
    live_o, live_lse = decode_attention_fwd(q, k, v, S, with_lse=True)
    torch.cuda.synchronize()
    for row in range(min(B, 2)):
        assert float(o[row].abs().max()) == 0.0
        assert float(lse[row].max()) <= -1e29
    got = merge_partials(torch.stack([o, live_o]), torch.stack([lse, live_lse]), q_dtype)
    assert torch.isfinite(got).all()
    for row in range(min(B, 2)):
        assert torch.equal(got[row], live_o[row])


@pytest.mark.parametrize("variant,q_dtype,kv_dtype,B,S,H,KV,D", LSE_CASES)
def test_decode_merged_halves_match_the_whole_cache(cuda, variant, q_dtype, kv_dtype, B, S, H,
                                                     KV, D):
    """Two halves of the cache, each attended with its own live length
    (``kv_len - S/2`` for the second: negative, zero or partial), merged,
    against the kernel and its plain version over the whole cache."""
    from repro_torch.models.layers import merge_partials

    q, k, v = _lse_inputs(cuda, q_dtype, kv_dtype, B, S, H, KV, D)
    h = S // 2
    for length in (1, h - 1, h, h + 1, S - 5, S):
        parts = [decode_attention_fwd(q, k[:, s:s + h], v[:, s:s + h],
                                      torch.full((1,), length - s, dtype=torch.int32,
                                                 device=cuda), with_lse=True)
                 for s in (0, h)]
        got = merge_partials(torch.stack([p[0] for p in parts]),
                             torch.stack([p[1] for p in parts]), q_dtype)
        torch.cuda.synchronize()
        _close(got, decode_attention_fwd(q, k, v, length), **TOL[q_dtype])
        _close(got, ref.decode_attention_ref(q, k, v, length), **TOL[q_dtype])


def _one_rank_group(tmp_path, backend):
    import datetime

    import torch.distributed as dist

    dist.init_process_group(backend, store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))


@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_server_on_a_one_rank_mesh_is_the_unsharded_server(cuda, tmp_path, backend):
    """``Server(mesh=)`` on a 1x1 CUDA mesh, chatglm3's smoke config in bf16
    with ``attn_impl="pallas"``: over NCCL the captured ``generate`` (its
    all-gathers inside the graph), over gloo ``generate_eager`` (and
    ``generate`` refuses, naming it), tokens equal and logits bitwise the
    unsharded ``Server.generate``'s."""
    import torch.distributed as dist

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import Server
    from repro_torch.launch.steps import concrete_batch

    cfg = get_smoke_config("chatglm3_6b").replace(attn_impl="pallas")
    _one_rank_group(tmp_path, backend)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device="cuda", backend=backend)
        plain = Server(cfg, device="cuda", max_len=256)
        params = plain.model.compute_params(plain.model.init_params(seed=0))
        batch = concrete_batch(cfg, 2, 128, device=cuda)
        batch.pop("targets")
        want_t, want_l = plain.generate(params, batch, 12, with_logits=True)
        server = Server(cfg, device="cuda", max_len=256, mesh=mesh)
        placed = server.place(params)
        if backend == "gloo":
            with pytest.raises(RuntimeError, match="generate_eager"):
                server.generate(placed, batch, 12)
            got_t, got_l = server.generate_eager(placed, batch, 12, with_logits=True)
        else:
            got_t, got_l = server.generate(placed, batch, 12, with_logits=True)
            again_t, _ = server.generate(placed, batch, 12, with_logits=True)
            assert torch.equal(again_t.full_tensor(), got_t.full_tensor())
        assert torch.equal(got_t.full_tensor(), want_t)
        assert torch.equal(got_l.full_tensor(), want_l)
    finally:
        dist.destroy_process_group()
