"""decode_attention — the CUDA flash-decode (``csrc/decode_attention.cu``),
counterpart of ``repro.kernels.decode_attention``.

``decode_attention_fwd`` launches one of two variants on CUDA tensors in the
model layouts, chosen by ``variant`` from the dtypes and the head dim alone:

* ``"mma"``: a bf16 query over a bf16 or fp8 e4m3 cache with head_dim 64 or
  128 (the serving path): tensor cores over the packed query heads of each
  KV head, one launch (the last block of each tile to finish merges the
  splits);
* ``"simt"``: everything else (an f32 query or cache, other head dims): the
  CUDA-core split pass and its merge pass.

Both read ``kv_len`` from device memory: one int32, as the TPU kernel
takes it as a scalar-prefetch operand, or one int32 per batch row (a
``[B]`` tensor: the continuous batcher's slots, each at its own position,
``runtime.scheduler``).  They plan their splits from the cache's capacity
S, so the grid is the same at every length and every mix of lengths, and a
captured decode step replays at any position (``launch.steps.CapturedDecode``).

On request (``with_lse``) both also write each head's f32 log-sum-exp of
its scaled scores over the live keys ([B, H]; -1e30 for a row with no live
key), which merges the outputs of caches that split one sequence (sharded
serving: ``models.layers.merge_partials``); the output is bitwise the same
with and without it.

Launches are counted in ``decode_attention_fwd.launches`` (both) and in
``launches_mma`` and ``launches_simt``.  The plain version is
``ref.decode_attention_ref``; ``ops.decode_attention`` chooses between it and
the kernels by the tensors' device.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from . import _build, pricing
from .flash_attention import check_head_dim

_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}
TILE = 32  # cache rows per tile of the CUDA-core kernel (TK)
STEP = 16  # keys per warp step of the tensor-core kernel: splits are whole steps
_MMA_KV = (torch.bfloat16, torch.float8_e4m3fn)
_MMA_HEAD_DIMS = (64, 128)


def variant(q_dtype: torch.dtype, kv_dtype: torch.dtype, head_dim: int) -> str:
    """The kernel a CUDA call runs, from the dtypes and the head dim alone:
    "mma" (tensor cores) for a bf16 query over a bf16 or fp8 e4m3 cache at
    head_dim 64 or 128, "simt" (CUDA cores) otherwise."""
    if q_dtype == torch.bfloat16 and kv_dtype in _MMA_KV and head_dim in _MMA_HEAD_DIMS:
        return "mma"
    return "simt"


def _lib(name: str):
    fn = getattr(_build.load("decode_attention"), name)
    if fn.argtypes is None:
        # q and cache dtypes (the mma variant's q is bf16), then q, k, v, o,
        # lse (or null), the split merge's scratch ((acc, m l) or (partials,
        # tickets)) and the device kv_len
        head = [ctypes.c_int] * (2 if name == "decode_attention_fwd" else 1)
        head += [ctypes.c_void_p] * 8
        # B, H, KV, D, S, split_len, n_split and kv_len's element stride
        fn.argtypes = (head + [ctypes.c_int] * 8 + [ctypes.c_int64] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def split_plan(B: int, KV: int, S: int, n_sm: int) -> tuple[int, int]:
    """The CUDA-core kernel's (split_len, n_split): cut the cache's ``S``
    slots (its capacity, not the live length) into whole tiles per block so
    that B * KV * n_split blocks fill the card about twice over."""
    want = max(1, -(-2 * n_sm // (B * KV)))
    split_len = TILE * max(1, -(-S // (TILE * want)))
    return split_len, -(-S // split_len)


def n_head_tiles(H: int, KV: int) -> int:
    """16-head tiles per KV head of the tensor-core kernel (ceil(G / 16))."""
    return -(-(H // KV) // 16)


def mma_split_plan(B: int, KV: int, n_mt: int, S: int, n_sm: int) -> tuple[int, int]:
    """The tensor-core kernel's (split_len, n_split): cut the cache's ``S``
    slots (its capacity, not the live length) into splits of whole STEP-key
    steps so that the B * KV * n_mt * n_split blocks are one wave on
    ``n_sm`` SMs, at least half of it where there are steps enough (never
    more splits than steps).  At a live length kv_len < S only the first
    ceil(kv_len / split_len) splits do work."""
    steps = -(-S // STEP)
    want = max(1, n_sm // (B * KV * n_mt))
    per = -(-steps // want)
    return STEP * per, -(-steps // per)


# per device: the int32 tickets of the tensor-core kernel's split merge, zero
# between launches (the last block of each tile resets its own)
_COUNTERS: dict[int, torch.Tensor] = {}


def _counters(device: torch.device, n: int) -> torch.Tensor:
    buf = _COUNTERS.get(device.index)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
        _COUNTERS[device.index] = buf
    return buf


def _check(q, k, v):
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("decode_attention_fwd takes CUDA tensors")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")
    if q.dtype not in _Q_DTYPES:
        raise TypeError(f"q dtype {q.dtype} not in {list(_Q_DTYPES)}")
    if k.dtype not in _KV_DTYPES or v.dtype != k.dtype:
        raise TypeError(f"k, v must share one of {list(_KV_DTYPES)}; got {k.dtype}, {v.dtype}")
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("q [B, H, D]; k, v [B, S, KV, D]")
    B, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"shapes q {tuple(q.shape)} and k {tuple(k.shape)} do not match")
    check_head_dim(D)
    if q.stride(2) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("the head dim of q, k and v must be contiguous")
    if variant(q.dtype, k.dtype, D) == "mma":
        per16 = 16 // k.element_size()  # elements per 16 bytes
        for t in (k, v):
            if t.data_ptr() % 16 or any(st % per16 for st in t.stride()[:3]):
                raise ValueError("the tensor-core decode copies cache rows 16 bytes at a "
                                 "time: k and v rows must start on 16-byte boundaries")


def device_kv_len(kv_len, S: int, device: torch.device, B: int = 1) -> torch.Tensor:
    """``kv_len`` as the int32s in device memory that the kernels read: one
    for every row, or one per batch row (a ``[B]`` int32 tensor).  A Python
    int is checked against [1, S] here and written by a fill kernel (no
    blocking host-to-device copy); a tensor, which the host cannot read
    without waiting for the device, is checked for its shape, dtype and
    device only (the kernels clamp it to [0, S])."""
    if isinstance(kv_len, torch.Tensor):
        per_row = kv_len.dim() == 1 and kv_len.numel() == B
        if (kv_len.numel() != 1 and not per_row) or kv_len.dtype != torch.int32:
            raise ValueError(f"a tensor kv_len is one int32, or one per batch row ([{B}] "
                             f"int32); got {kv_len.dtype} {tuple(kv_len.shape)}")
        if kv_len.device != device:
            raise ValueError(f"kv_len lies on {kv_len.device}, the cache on {device}")
        return kv_len
    kv_len = int(kv_len)
    if not 1 <= kv_len <= S:
        raise ValueError(f"kv_len {kv_len} outside [1, {S}]")
    return torch.full((1,), kv_len, dtype=torch.int32, device=device)


def decode_attention_fwd(q, k, v, kv_len, with_lse: bool = False):
    """q [B, H, D]; k, v [B, S, KV, D] (CUDA; q f32 or bf16, the cache f32,
    bf16 or fp8 e4m3; any strides with a contiguous last dim, the tensor-core
    variant's cache rows 16-byte aligned); attends to the first ``kv_len``
    cache rows -> [B, H, D] in q's dtype, and with ``with_lse`` also the f32
    log-sum-exp [B, H] of each head's scaled scores over those rows (-1e30
    where there is none).  ``kv_len`` is a Python int, a one-element int32
    tensor on q's device, or a ``[B]`` int32 tensor there (row b attends to
    its first ``kv_len[b]`` rows; ``device_kv_len``; the kernels clamp a
    tensor's values to [0, S]); the grid depends on S alone, so one launch
    and its replays serve every length and every mix of lengths.  A
    ``meta`` q is priced (``pricing``: 4 B H S D, the cache's S slots), not
    launched."""
    if q.is_meta:
        B, H, D = q.shape
        kv = kv_len if isinstance(kv_len, torch.Tensor) else pricing.empty((1,), torch.int32)
        out = (pricing.empty(q.shape, q.dtype),
               pricing.empty((B, H), torch.float32) if with_lse else None)
        o, lse = pricing.priced("decode_attention_fwd", (kv, q, k, v), out,
                                4 * B * H * k.shape[1] * D, dot=True)
        return (o, lse) if with_lse else o
    _check(q, k, v)
    B, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    kv = device_kv_len(kv_len, S, q.device, B)
    kv_stride = 0 if kv.numel() == 1 else kv.stride(0)  # 0: one length for every row
    dev = q.device.index
    kind = variant(q.dtype, k.dtype, D)
    o = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H), dtype=torch.float32, device=q.device) if with_lse else None
    lse_ptr = 0 if lse is None else lse.data_ptr()
    # the launch needs the tensors' device current; entering a device
    # context costs host time on every decode call, so only when it is not
    on_dev = contextlib.nullcontext() if dev == torch.cuda.current_device() else \
        torch.cuda.device(dev)
    strides = (q.stride(0), q.stride(1), k.stride(0), k.stride(1), k.stride(2),
               v.stride(0), v.stride(1), v.stride(2))
    with on_dev:
        stream = torch.cuda.current_stream(dev).cuda_stream
        if kind == "mma":
            n_mt = n_head_tiles(H, KV)
            split_len, n_split = mma_split_plan(B, KV, n_mt, S, _sm_count(dev))
            # f32 partials: acc [B, KV, n_mt, n_split, 16, D], then (M, L)
            # [B, KV, n_mt, n_split, 16, 2]; none with one split
            part = (torch.empty(B * KV * n_mt * n_split * 16 * (D + 2), dtype=torch.float32,
                                device=q.device) if n_split > 1 else None)
            err = _lib("decode_attention_mma_fwd")(
                _KV_DTYPES[k.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse_ptr, 0 if part is None else part.data_ptr(),
                _counters(q.device, B * KV * n_mt).data_ptr(), kv.data_ptr(),
                B, H, KV, D, S, split_len, n_split, kv_stride, *strides, 1.0 / (D**0.5), stream,
            )
        else:
            split_len, n_split = split_plan(B, KV, S, _sm_count(dev))
            # the split pass's scratch, in one allocation: acc [B, KV, n_split,
            # G, D] then (m, l) [B, KV, n_split, G, 2], all f32
            rows = B * H * n_split
            part = torch.empty(rows * (D + 2), dtype=torch.float32, device=q.device)
            part_acc = part.data_ptr()
            err = _lib("decode_attention_fwd")(
                _Q_DTYPES[q.dtype], _KV_DTYPES[k.dtype], q.data_ptr(), k.data_ptr(),
                v.data_ptr(), o.data_ptr(), lse_ptr, part_acc, part_acc + 4 * rows * D,
                kv.data_ptr(),
                B, H, KV, D, S, split_len, n_split, kv_stride, *strides, 1.0 / (D**0.5), stream,
            )
    if err != 0:
        raise RuntimeError(f"decode_attention_fwd ({kind}) launch failed: cudaError_t {err}")
    decode_attention_fwd.launches += 1
    if kind == "mma":
        decode_attention_fwd.launches_mma += 1
    else:
        decode_attention_fwd.launches_simt += 1
    return (o, lse) if with_lse else o


decode_attention_fwd.launches = 0
decode_attention_fwd.launches_mma = 0
decode_attention_fwd.launches_simt = 0
