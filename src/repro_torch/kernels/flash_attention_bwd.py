"""flash_attention_bwd — the CUDA flash-attention backward (``csrc/
flash_attention_bwd.cu``), counterpart of ``repro.kernels.flash_attention_bwd``.

Two kernels, each with its wrapper and launch counter:

  * ``flash_attention_bwd_dkdv`` -> (dk, dv) per KV head, the GQA group
    summed in f32 inside the kernel (``.launches``);
  * ``flash_attention_bwd_dq``   -> dq (``.launches``).

``flash_attention_bwd`` computes ``delta = rowsum(do * o)`` and runs both.
The plain version is ``ref.flash_attention_bwd_ref``; ``ops.
flash_attention_trainable`` chooses between the two by the tensors' device.

The tensor-core dK/dV kernel (``flash_attention.route``) gives each block
128 keys of one KV head and splits the KV head's query heads over the
``dkdv_split`` blocks of a thread-block cluster, which sum their partial dK
and dV in a fixed order; ``dkdv_steps`` lists each block's (query head,
64-row q tile) steps.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, pricing
from .decode_attention import _sm_count
from .flash_attention import _DTYPES, _check, route, tma_aligned

_INT64_STRIDES = 18  # batch, seq, head strides of the six (dkdv) tensors
KV_TILE = 128  # keys per dK/dV block (64 per consumer warpgroup)
Q_TILE = 64    # query rows per streamed dK/dV step
MAX_SPLIT = 8  # blocks per cluster (the portable cluster size)


def _fn(name: str, n_tensors: int, n_strides: int, n_tail: int):
    lib = _build.load("flash_attention_bwd")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * n_tensors + [ctypes.c_int] * 6
            + [ctypes.c_int64] * n_strides
            + [ctypes.c_int, ctypes.c_int, ctypes.c_float] + [ctypes.c_int] * n_tail
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def dkdv_split(B: int, KV: int, G: int, Sk: int, n_sm: int) -> int:
    """Blocks per dK/dV work item (one thread-block cluster), each taking
    every split-th of the G query heads: the smallest power of two, up to
    min(G, 8), with which the B * KV * ceil(Sk / 128) items give every SM a
    block."""
    items = B * KV * -(-Sk // KV_TILE)
    split = 1
    while 2 * split <= min(G, MAX_SPLIT) and items * split < n_sm:
        split *= 2
    return split


def dkdv_steps(B: int, KV: int, G: int, Sq: int, Sk: int, causal: bool, q_offset: int,
               split: int) -> list[int]:
    """The (query head, 64-row q tile) steps of each dK/dV block, in launch
    order: key tiles from the first (causal: the heaviest), then batch row
    and KV head, then the block's rank in its cluster."""
    n_q = -(-Sq // Q_TILE)
    steps = []
    for kt in range(-(-Sk // KV_TILE)):
        i0 = max(0, (kt * KV_TILE - q_offset) // Q_TILE) if causal else 0
        per_head = max(0, n_q - i0)
        for _ in range(B * KV):
            steps += [len(range(r, G, split)) * per_head for r in range(split)]
    return steps


def _aligned(t) -> bool:
    """A contiguous last dim and, on the tensor-core route, 16-byte aligned
    rows."""
    return t.stride(3) == 1 and (route(t.shape[3], t.dtype) != "wgmma" or tma_aligned(t))


def _check_bwd(q, k, v, do, lse, delta, q_offset):
    _check(q, k, v)
    if q_offset < 0:
        raise ValueError(f"q_offset {q_offset} < 0")
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"do {tuple(do.shape)} {do.dtype} must match q {tuple(q.shape)} "
                         f"{q.dtype} on {q.device}")
    if not _aligned(do):
        raise ValueError("do needs a contiguous head dim and, on the tensor cores, 16-byte "
                         "aligned rows")
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
    f32 or bf16, 1 <= D <= 1024, contiguous last dim, rows 16-byte aligned on
    the tensor-core route) -> (dk, dv) [B, Sk, KV, D] in k's dtype, summed
    over each KV head's query group.  ``meta`` inputs are priced
    (``pricing``), not launched."""
    if q.is_meta:
        B, Sq, H, D = q.shape
        dk, dv = pricing.empty(k.shape, k.dtype), pricing.empty(v.shape, v.dtype)
        return pricing.priced("flash_attention_bwd_dkdv", (q, k, v, do, lse, delta), (dk, dv),
                              8 * B * H * Sq * k.shape[1] * D, dot=True)
    _check_bwd(q, k, v, do, lse, delta, q_offset)
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    dk = torch.empty((B, Sk, KV, D), dtype=k.dtype, device=k.device)
    dv = torch.empty((B, Sk, KV, D), dtype=v.dtype, device=v.device)
    split = 1
    if route(D, q.dtype) == "wgmma":
        split = dkdv_split(B, KV, H // KV, Sk, _sm_count(q.device.index))
    fn = _fn("flash_attention_bwd_dkdv", 8, _INT64_STRIDES, 1)
    _launch(fn, [_DTYPES[q.dtype], q, k, v, do, lse, delta, dk, dv, B, H, KV, Sq, Sk, D,
                 *_strides(q, k, v, do, dk, dv), int(causal), int(q_offset), 1.0 / (D**0.5),
                 split], "flash_attention_bwd_dkdv")
    flash_attention_bwd_dkdv.launches += 1
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *, causal: bool = True, q_offset: int = 0):
    """The same inputs as ``flash_attention_bwd_dkdv`` -> dq [B, Sq, H, D] in
    q's dtype (``meta`` inputs: priced)."""
    if q.is_meta:
        B, Sq, H, D = q.shape
        dq, = pricing.priced("flash_attention_bwd_dq", (q, k, v, do, lse, delta),
                             (pricing.empty(q.shape, q.dtype),),
                             6 * B * H * Sq * k.shape[1] * D, dot=True)
        return dq
    _check_bwd(q, k, v, do, lse, delta, q_offset)
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    dq = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    fn = _fn("flash_attention_bwd_dq", 7, _INT64_STRIDES - 3, 0)
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
    if not do.is_meta and not _aligned(do):
        do = do.contiguous()
    delta = attention_delta(o, do)
    dk, dv = flash_attention_bwd_dkdv(q, k, v, do, lse, delta, causal=causal, q_offset=q_offset)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=causal, q_offset=q_offset)
    return dq, dk, dv
