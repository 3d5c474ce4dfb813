"""decode_attention — the CUDA flash-decode (``csrc/decode_attention.cu``),
counterpart of ``repro.kernels.decode_attention``.

``decode_attention_fwd`` launches the kernel pair (split pass and merge
pass) on CUDA tensors in the model layouts and counts its launches in
``decode_attention_fwd.launches``.  The plain version is
``ref.decode_attention_ref``; ``ops.decode_attention`` chooses between the
two by the tensors' device.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from . import _build

_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}
TILE = 32  # cache rows per tile in the kernel (TK)


def _lib():
    lib = _build.load("decode_attention")
    fn = lib.decode_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
            + [ctypes.c_int64] * 8 + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def split_plan(B: int, KV: int, kv_len: int, n_sm: int) -> tuple[int, int]:
    """(split_len, n_split): cut the first ``kv_len`` cache rows into whole
    tiles per block so that B * KV * n_split blocks fill the card about
    twice over."""
    want = max(1, -(-2 * n_sm // (B * KV)))
    split_len = TILE * max(1, -(-kv_len // (TILE * want)))
    return split_len, -(-kv_len // split_len)


def _check(q, k, v, kv_len):
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
    if not 1 <= kv_len <= k.shape[1]:
        raise ValueError(f"kv_len {kv_len} outside [1, {k.shape[1]}]")
    if D > 1024:
        raise ValueError(f"head_dim {D} > 1024")
    if q.stride(2) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("the head dim of q, k and v must be contiguous")


def decode_attention_fwd(q, k, v, kv_len: int):
    """q [B, H, D]; k, v [B, S, KV, D] (CUDA; q f32 or bf16, the cache f32,
    bf16 or fp8 e4m3; any strides with a contiguous last dim); attends to
    the first ``kv_len`` cache rows -> [B, H, D] in q's dtype."""
    kv_len = int(kv_len)
    _check(q, k, v, kv_len)
    B, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    dev = q.device.index
    split_len, n_split = split_plan(B, KV, kv_len, _sm_count(dev))
    o = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    # the split pass's scratch, in one allocation: acc [B, KV, n_split, G, D]
    # then (m, l) [B, KV, n_split, G, 2], all f32
    rows = B * KV * n_split * G
    part = torch.empty(rows * (D + 2), dtype=torch.float32, device=q.device)
    part_acc = part.data_ptr()
    part_ml = part_acc + 4 * rows * D
    fn = _lib()
    # the launch needs the tensors' device current; entering a device
    # context costs host time on every decode call, so only when it is not
    on_dev = contextlib.nullcontext() if dev == torch.cuda.current_device() else \
        torch.cuda.device(dev)
    with on_dev:
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            _Q_DTYPES[q.dtype], _KV_DTYPES[k.dtype], q.data_ptr(), k.data_ptr(),
            v.data_ptr(), o.data_ptr(), part_acc, part_ml,
            B, H, KV, D, kv_len, split_len, n_split,
            q.stride(0), q.stride(1),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            1.0 / (D**0.5), stream,
        )
    if err != 0:
        raise RuntimeError(f"decode_attention_fwd launch failed: cudaError_t {err}")
    decode_attention_fwd.launches += 1
    return o


decode_attention_fwd.launches = 0
