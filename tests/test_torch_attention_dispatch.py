"""What the attention kernels' wrappers decide on the host, held on the CPU:
flash-decode's split plan and its choice of variant, the flash forward's
tensor-map stride check, the flash kernels' route (tensor or CUDA cores)
and build for each D and the head dims they refuse, and how the dK/dV
kernel splits a KV head's query group over the blocks of a cluster, and
which attention ``models.layers.local_attention`` runs with
``impl="pallas"``: on the card (a ``meta`` tensor under ``pricing``) the
flash kernels at every length, off it the JAX package's 128-multiple guard.
None of these functions touches CUDA (the tests make every CUDA query raise while they run); the
kernels themselves are held against their plain versions on the card, in
``tests/test_torch_gpu.py``.
"""

import pytest
import torch

torch.set_num_threads(2)  # beside the other test workers on the CPU

from repro_torch.kernels import decode_attention as dec  # noqa: E402
from repro_torch.kernels import ops, pricing  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as bwd  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    check_head_dim,
    padded_head_dim,
    tma_aligned,
)
from repro_torch.kernels.flash_attention import route as flash_route  # noqa: E402
from repro_torch.models import layers  # noqa: E402

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


@pytest.mark.parametrize("D,dtypes,want", [
    *[(D, (torch.float32, torch.bfloat16), want)
      for D, want in [(8, 64), (16, 64), (56, 64), (64, 64), (72, 128), (96, 128), (120, 128),
                      (128, 128)]],
    *[(D, (torch.float32,), 64 if D <= 64 else 128) for D in (1, 4, 20, 33, 100, 127)],
])
def test_flash_head_dim_runs_on_the_padded_build(D, dtypes, want):
    """A head dim up to 64 runs on the D = 64 build, one up to 128 on the D =
    128 build (the smoke configs' 8 and 16, the full configs' 64 and 128);
    f32 takes any D, bf16 a multiple of 8."""
    for dtype in dtypes:
        assert padded_head_dim(D, dtype) == want


@pytest.mark.parametrize("D,dtype", [(0, torch.float32), (1025, torch.float32),
                                     (1032, torch.bfloat16), (1032, torch.float32),
                                     (0, torch.bfloat16), (1536, torch.bfloat16),
                                     (2048, torch.float32)])
def test_flash_head_dims_refused(D, dtype):
    """D outside 1..1024 raises, in either dtype, with the one message of
    the three attention kernels (flash-decode's ``_check`` calls the same
    ``check_head_dim``)."""
    message = f"head_dim {D}: the attention kernels take 1 <= D <= 1024$"
    with pytest.raises(ValueError, match=message):
        padded_head_dim(D, dtype)
    with pytest.raises(ValueError, match=message):
        check_head_dim(D)


@pytest.mark.parametrize("D,dtype,build,route", [
    (20, torch.bfloat16, 64, "simt"),     # a bf16 row of 40 bytes: no TMA
    (4, torch.bfloat16, 64, "simt"),
    (100, torch.bfloat16, 128, "simt"),
    (136, torch.bfloat16, 256, "simt"),   # past the tensor-core builds
    (136, torch.float32, 256, "simt"),
    (256, torch.bfloat16, 256, "simt"),   # recurrentgemma-2b's head_dim
    (256, torch.float32, 256, "simt"),
    (129, torch.float32, 256, "simt"),
    (320, torch.bfloat16, 256, "simt"),   # past 256: the D = 256 build in two pieces
    (512, torch.float32, 256, "simt"),
    (1024, torch.bfloat16, 256, "simt"),  # flash-decode's bound, four pieces
    (8, torch.bfloat16, 64, "wgmma"),
    (128, torch.bfloat16, 128, "wgmma"),
    (64, torch.float32, 64, "simt"),
])
def test_flash_head_dims_route_by_shape(D, dtype, build, route):
    """bf16 with D % 8 == 0 up to 128 runs on the tensor cores; every other
    head dim up to 1024, and f32, on the CUDA cores, whose builds are D = 64,
    128 and 256 (walking a larger D in pieces of 256)."""
    assert padded_head_dim(D, dtype) == build
    assert flash_route(D, dtype) == route


def test_backward_aligns_rows_only_on_the_tensor_core_route():
    """The backward's row check asks for 16-byte rows only where TMA reads
    them: a bf16 head dim of 20 (40-byte rows) passes on the CUDA cores."""
    assert bwd._aligned(_bf16((1, 8, 2, 20)))
    assert not bwd._aligned(_bf16((1, 8, 2, 68))[..., :64])
    assert bwd._aligned(_bf16((1, 8, 2, 264))[..., :256])


def test_dkdv_split_at_the_training_shape():
    # chatglm3-6b training: B=2, KV=2, G=16, Sk=2048: 64 key tiles of 128,
    # split over clusters of 4 blocks, 256 blocks for 132 SMs
    assert bwd.dkdv_split(2, 2, 16, 2048, H100_SMS) == 4
    assert bwd.dkdv_split(1, 2, 2, 128, H100_SMS) == 2    # capped by G
    assert bwd.dkdv_split(1, 1, 1, 128, H100_SMS) == 1    # one query head
    assert bwd.dkdv_split(8, 8, 16, 4096, H100_SMS) == 1  # items enough


@pytest.mark.parametrize("B,KV,G,Sk", [(2, 2, 16, 2048), (1, 2, 7, 200), (1, 8, 32, 256),
                                       (4, 1, 3, 1000), (1, 1, 1, 100)])
def test_dkdv_split_is_the_smallest_that_fills_the_card(B, KV, G, Sk):
    split = bwd.dkdv_split(B, KV, G, Sk, H100_SMS)
    items = B * KV * -(-Sk // bwd.KV_TILE)
    assert split & (split - 1) == 0 and split <= min(G, bwd.MAX_SPLIT)
    assert items * split >= H100_SMS or 2 * split > min(G, bwd.MAX_SPLIT)
    assert split == 1 or items * split // 2 < H100_SMS


@pytest.mark.parametrize("causal,q_offset", [(True, 0), (True, 77), (False, 0)])
@pytest.mark.parametrize("B,KV,G,Sq,Sk,split", [(2, 2, 16, 2048, 2048, 4),
                                                (1, 2, 7, 77, 200, 4), (1, 1, 3, 130, 130, 2)])
def test_dkdv_steps_cover_every_head_and_tile_once(B, KV, G, Sq, Sk, split, causal, q_offset):
    """The blocks' (query head, q tile) steps add up to every pair of a query
    head and a 64-row q tile that meets the block's keys, the ranks of a
    cluster differ by at most one head, and causal key tiles come heaviest
    first."""
    steps = bwd.dkdv_steps(B, KV, G, Sq, Sk, causal, q_offset, split)
    n_kt, n_q = -(-Sk // bwd.KV_TILE), -(-Sq // bwd.Q_TILE)
    assert len(steps) == n_kt * B * KV * split
    want = 0
    for kt in range(n_kt):
        # q tiles holding a query position at or past the tile's first key
        tiles = [i for i in range(n_q)
                 if not causal or q_offset + min((i + 1) * bwd.Q_TILE, Sq) - 1 >= kt * bwd.KV_TILE]
        want += B * KV * G * len(tiles)
    assert sum(steps) == want
    for c in range(0, len(steps), split):
        cluster = steps[c:c + split]
        per_head = max(cluster) // -(-G // split) if max(cluster) else 0
        assert max(cluster) - min(cluster) <= per_head
    per_item = [sum(steps[c:c + split]) for c in range(0, len(steps), split)]
    assert per_item == sorted(per_item, reverse=True)


def test_dkdv_steps_at_the_training_shape():
    """Key tile j of 128 keys meets 32 - 2 j q tiles of each head; with 4
    heads a block, the heaviest block walks 128 steps and the lightest 8,
    against 17,408 in all (131.9 per SM of an H100)."""
    steps = bwd.dkdv_steps(2, 2, 16, 2048, 2048, True, 0, 4)
    assert (max(steps), min(steps), sum(steps), len(steps)) == (128, 8, 17408, 256)


# (B, Sq, Sk, H, KV, D, causal, q_offset): ragged lengths, causal and not,
# with an offset; a chunk of 64 keys, so that the chunked path pads its last
ROUTE_CASES = [(1, 100, 100, 4, 2, 16, True, 0), (1, 333, 333, 4, 2, 16, True, 0),
               (2, 130, 300, 4, 2, 16, False, 0), (1, 77, 200, 8, 2, 16, True, 123)]


def _attention(B, Sq, Sk, H, KV, D, dtype, device):
    gen = torch.Generator().manual_seed(Sq * 1000 + Sk)
    return tuple(torch.randn(shape, generator=gen).to(dtype).to(device)
                 for shape in ((B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,causal,q_offset", ROUTE_CASES)
def test_pallas_route_off_the_card_keeps_ragged_lengths_chunked(monkeypatch, B, Sq, Sk, H, KV, D,
                                                                causal, q_offset, dtype):
    """CPU tensors keep the JAX package's guard: ``impl="pallas"`` at
    lengths that are not multiples of 128 is the plain chunked path bit for
    bit, and never reaches the flash wrapper, as JAX's Pallas branch falls
    back there; so the JAX parity tests see the route they always saw."""
    q, k, v = _attention(B, Sq, Sk, H, KV, D, dtype, "cpu")

    def refuse(*args):
        raise AssertionError("a ragged CPU attention took the flash branch")

    monkeypatch.setattr(ops, "flash_attention_trainable", refuse)
    got = layers.local_attention(q, k, v, causal=causal, impl="pallas", chunk=64,
                                 q_offset=q_offset, local_window=0, kv_len=None)
    want = layers._attn_chunked(q.reshape(B, Sq, KV, H // KV, D), k, v, 1.0 / D**0.5, causal,
                                q_offset, 0, None, 64).reshape(B, Sq, H, D)
    assert torch.equal(got, want)


@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,causal,q_offset", ROUTE_CASES)
def test_pallas_route_on_the_card_takes_every_length(B, Sq, Sk, H, KV, D, causal, q_offset):
    """Tensors on the card's route (``meta`` under ``pricing``) take the
    flash kernels at ragged lengths: one forward, and under autograd one
    dK/dV and one dQ kernel, each priced at its products; a window or a
    ``kv_len`` keeps the plain path there too."""
    q, k, v = (t.requires_grad_() for t in _attention(B, Sq, Sk, H, KV, D, torch.bfloat16,
                                                      "meta"))
    kw = dict(causal=causal, impl="pallas", chunk=64, q_offset=q_offset)
    records = []
    with pricing.pricing(lambda name, flops, nbytes, dot: records.append((name, dot))):
        o = layers.local_attention(q, k, v, local_window=0, kv_len=None, **kw)
        torch.autograd.grad(o.sum(), (q, k, v))
        assert tuple(o.shape) == (B, Sq, H, D)
        n = len(records)
        layers.local_attention(q, k, v, local_window=16, kv_len=None, **kw)
        layers.local_attention(q, k, v, local_window=0, kv_len=Sk - 1, **kw)
    per_pair = 4 * B * H * Sq * Sk * D
    assert records[:n] == [("flash_attention_fwd", per_pair),
                           ("flash_attention_bwd_dkdv", 2 * per_pair),
                           ("flash_attention_bwd_dq", 1.5 * per_pair)]
    assert len(records) == n
