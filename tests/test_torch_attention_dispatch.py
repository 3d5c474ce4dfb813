"""What the attention kernels' wrappers decide on the host, held on the CPU:
flash-decode's split plan and its choice of variant, and the flash forward's
tensor-map stride check.  None of these functions touches CUDA (the tests
make every CUDA query raise while they run); the kernels themselves are held
against their plain versions on the card, in ``tests/test_torch_gpu.py``.
"""

import pytest
import torch

torch.set_num_threads(2)  # beside the other test workers on the CPU

from repro_torch.kernels import decode_attention as dec  # noqa: E402
from repro_torch.kernels.flash_attention import tma_aligned  # noqa: E402

H100_SMS = 132


@pytest.fixture(autouse=True)
def no_cuda(monkeypatch):
    """Any CUDA query from the functions under test fails the test."""
    def refuse(*args, **kwargs):
        raise AssertionError("a host-side decision made a CUDA call")

    for name in ("current_device", "get_device_properties", "current_stream",
                 "device_count", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, refuse)


@pytest.mark.parametrize("kv_len", [1, 7, 16, 17, 528, 1024, 32768])
@pytest.mark.parametrize("B,KV", [(4, 2), (1, 8), (2, 20)])
@pytest.mark.parametrize("n_mt", [1, 2])
def test_decode_split_plan_covers_the_cache_in_whole_steps(kv_len, B, KV, n_mt):
    split_len, n_split = dec.mma_split_plan(B, KV, n_mt, kv_len, H100_SMS)
    steps = -(-kv_len // dec.STEP)
    # whole 16-key steps, every split non-empty, together exactly [0, kv_len)
    assert split_len % dec.STEP == 0 and split_len > 0
    assert (n_split - 1) * split_len < kv_len <= n_split * split_len
    assert 1 <= n_split <= steps
    # one wave on the card, at least half of it where there are steps enough
    blocks = B * KV * n_mt * n_split
    assert blocks <= max(H100_SMS, B * KV * n_mt)
    if n_split < steps:
        assert blocks > H100_SMS // 2


def test_decode_split_plan_at_the_serving_shape():
    # chatglm3-6b decode: B=4, KV=2, G=16 (one 16-head tile), kv_len 528:
    # 33 steps in 11 splits of 3, 88 blocks
    assert dec.n_head_tiles(32, 2) == 1
    assert dec.mma_split_plan(4, 2, 1, 528, H100_SMS) == (48, 11)
    assert dec.mma_split_plan(4, 2, 1, 1, H100_SMS) == (16, 1)


@pytest.mark.parametrize("H,KV,tiles", [(32, 2, 1), (8, 8, 1), (28, 4, 1), (56, 8, 1),
                                        (64, 2, 2), (40, 2, 2), (96, 2, 3)])
def test_decode_head_tiles(H, KV, tiles):
    """G query heads per KV head fill ceil(G / 16) 16-row tiles (G = 1, 7,
    16, 20, 32, 48 among them)."""
    assert dec.n_head_tiles(H, KV) == tiles


Q_DTYPES = [torch.float32, torch.bfloat16, torch.float16]
KV_DTYPES = [torch.float32, torch.bfloat16, torch.float8_e4m3fn]


@pytest.mark.parametrize("q_dtype", Q_DTYPES)
@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
@pytest.mark.parametrize("head_dim", [32, 64, 96, 128, 256])
def test_decode_variant_by_dtype_and_head_dim(q_dtype, kv_dtype, head_dim):
    """The tensor cores take a bf16 query over a bf16 or fp8 cache at head_dim
    64 or 128; everything else runs on the CUDA cores (an fp16 query is
    refused by the wrapper's dtype check before any launch)."""
    want = ("mma" if q_dtype == torch.bfloat16 and kv_dtype != torch.float32
            and head_dim in (64, 128) else "simt")
    assert dec.variant(q_dtype, kv_dtype, head_dim) == want


def test_decode_counts_launches_per_variant():
    f = dec.decode_attention_fwd
    assert all(isinstance(getattr(f, n), int)
               for n in ("launches", "launches_mma", "launches_simt"))


def _bf16(shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("make,ok", [
    (lambda: _bf16((2, 64, 4, 128)), True),                          # contiguous
    (lambda: _bf16((2, 4, 64, 128)).transpose(1, 2), True),          # head-major storage
    (lambda: _bf16((2, 64, 3 * 4, 128))[:, :, 4:8], True),           # a slice of fused qkv
    (lambda: _bf16((1, 64, 4, 68))[..., :64], False),                # 136-byte head stride
    (lambda: _bf16((1, 64, 4, 72))[..., 8:72], True),                # base 16 bytes in
    (lambda: _bf16((1, 64, 4, 72))[..., 1:65], False),               # base 2 bytes in
    (lambda: _bf16((3, 64, 4, 64))[1:], True),                       # a later batch row
    (lambda: _bf16((2, 65, 4, 64))[:, 1:], True),                    # rows from the second
])
def test_forward_tensor_map_stride_check(make, ok):
    """The bf16 forward describes q, k and v to TMA: their base address and
    their batch, row and head strides must be multiples of 16 bytes."""
    assert tma_aligned(make()) is ok


def test_forward_tensor_map_stride_check_counts_bytes():
    """The check is in bytes: an f32 row stride of 4 elements is 16 bytes."""
    t = torch.zeros((1, 8, 2, 4), dtype=torch.float32)
    assert tma_aligned(t)
    assert not tma_aligned(torch.zeros((1, 8, 2, 6), dtype=torch.float32)[..., :4])
