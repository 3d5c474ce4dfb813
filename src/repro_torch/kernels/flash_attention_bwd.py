"""flash_attention_bwd — the CUDA flash-attention backward (``csrc/
flash_attention_bwd.cu``), counterpart of ``repro.kernels.flash_attention_bwd``.

Two kernels, each with its wrapper and launch counter:

  * ``flash_attention_bwd_dkdv`` -> (dk, dv) per KV head, the GQA group
    summed in f32 inside the kernel (``.launches``);
  * ``flash_attention_bwd_dq``   -> dq (``.launches``).

``flash_attention_bwd`` computes ``delta = rowsum(do * o)`` and runs both.
The plain version is ``ref.flash_attention_bwd_ref``; ``ops.
flash_attention_trainable`` chooses between the two by the tensors' device.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .flash_attention import _DTYPES, _check, tma_aligned

_INT64_STRIDES = 18  # batch, seq, head strides of the six (dkdv) tensors


def _fn(name: str, n_tensors: int, n_strides: int):
    lib = _build.load("flash_attention_bwd")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * n_tensors + [ctypes.c_int] * 6
            + [ctypes.c_int64] * n_strides
            + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def _aligned(t) -> bool:
    """A contiguous last dim and, in bf16, 16-byte aligned rows."""
    return t.stride(3) == 1 and (t.dtype != torch.bfloat16 or tma_aligned(t))


def _check_bwd(q, k, v, do, lse, delta, q_offset):
    _check(q, k, v)
    if q_offset < 0:
        raise ValueError(f"q_offset {q_offset} < 0")
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"do {tuple(do.shape)} {do.dtype} must match q {tuple(q.shape)} "
                         f"{q.dtype} on {q.device}")
    if not _aligned(do):
        raise ValueError("do needs a contiguous head dim and, in bf16, 16-byte aligned rows")
    B, Sq, H, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.shape != (B * H, Sq) or t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != q.device):
            raise ValueError(f"{name} must be a contiguous f32 [B*H, Sq] = [{B * H}, {Sq}] "
                             f"tensor on {q.device}; got {tuple(t.shape)} {t.dtype}")


def _strides(*ts):
    return [s for t in ts for s in t.stride()[:3]]


def _launch(fn, args, what: str):
    with torch.cuda.device(args[1].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args], stream)
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError_t {err}")


def flash_attention_bwd_dkdv(q, k, v, do, lse, delta, *, causal: bool = True,
                             q_offset: int = 0):
    """q, do [B, Sq, H, D]; k, v [B, Sk, KV, D]; lse, delta [B*H, Sq] f32 (CUDA;
    f32 or bf16, contiguous last dim, bf16 rows 16-byte aligned) -> (dk, dv)
    [B, Sk, KV, D] in k's dtype, summed over each KV head's query group."""
    _check_bwd(q, k, v, do, lse, delta, q_offset)
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    dk = torch.empty((B, Sk, KV, D), dtype=k.dtype, device=k.device)
    dv = torch.empty((B, Sk, KV, D), dtype=v.dtype, device=v.device)
    fn = _fn("flash_attention_bwd_dkdv", 8, _INT64_STRIDES)
    _launch(fn, [_DTYPES[q.dtype], q, k, v, do, lse, delta, dk, dv, B, H, KV, Sq, Sk, D,
                 *_strides(q, k, v, do, dk, dv), int(causal), int(q_offset), 1.0 / (D**0.5)],
            "flash_attention_bwd_dkdv")
    flash_attention_bwd_dkdv.launches += 1
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *, causal: bool = True, q_offset: int = 0):
    """The same inputs as ``flash_attention_bwd_dkdv`` -> dq [B, Sq, H, D] in
    q's dtype."""
    _check_bwd(q, k, v, do, lse, delta, q_offset)
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    dq = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    fn = _fn("flash_attention_bwd_dq", 7, _INT64_STRIDES - 3)
    _launch(fn, [_DTYPES[q.dtype], q, k, v, do, lse, delta, dq, B, H, KV, Sq, Sk, D,
                 *_strides(q, k, v, do, dq), int(causal), int(q_offset), 1.0 / (D**0.5)],
            "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dkdv.launches = 0
flash_attention_bwd_dq.launches = 0


def attention_delta(o, do):
    """delta = rowsum(do * o) in f32, laid out [B*H, Sq] like the forward's
    lse (o, do [B, Sq, H, D])."""
    B, Sq, H, _ = o.shape
    d = (do.float() * o.float()).sum(-1)  # [B, Sq, H]
    return d.permute(0, 2, 1).reshape(B * H, Sq).contiguous()


def flash_attention_bwd(q, k, v, o, do, lse, *, causal: bool = True, q_offset: int = 0):
    """(dq, dk, dv) of flash attention from the forward's inputs, its output
    ``o`` and f32 ``lse``, and the output's cotangent ``do``; ``do`` is made
    contiguous once if its rows are not aligned for the kernels."""
    if not _aligned(do):
        do = do.contiguous()
    delta = attention_delta(o, do)
    dk, dv = flash_attention_bwd_dkdv(q, k, v, do, lse, delta, causal=causal, q_offset=q_offset)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=causal, q_offset=q_offset)
    return dq, dk, dv
