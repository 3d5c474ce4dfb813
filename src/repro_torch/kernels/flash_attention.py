"""flash_attention — the CUDA flash-attention forward (``csrc/
flash_attention.cu``), counterpart of ``repro.kernels.flash_attention``.

``flash_attention_fwd`` launches the kernel on CUDA tensors in the model
layouts and counts its launches in ``flash_attention_fwd.launches``.  The
plain version is ``ref.flash_attention_ref``; ``ops.flash_attention``
chooses between the two by the tensors' device.

The kernels (forward and backward) take every head dim up to 1024,
flash-decode's bound, which all three attention kernels state as one
(``check_head_dim``).  Two kernels serve each pass, chosen by shape
(``route``): the tensor-core one (TMA, wgmma) for bf16 with D % 8 == 0 up
to 128, the CUDA-core one for f32 and for every other bf16 D;
``padded_head_dim`` says which build of it runs (past 256 the D = 256 build
walks the head dim in pieces of 256 columns) and refuses D > 1024.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, pricing

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 1024
MAX_TENSOR_CORE_HEAD_DIM = 128


def check_head_dim(D: int) -> None:
    """The one head-dim bound of the attention kernels (the flash forward,
    its backward pair and flash-decode): ``ValueError`` outside 1..1024."""
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {D}: the attention kernels take 1 <= D <= {MAX_HEAD_DIM}")


def route(D: int, dtype: torch.dtype) -> str:
    """Which kernel of a flash pass runs head dim ``D``: ``"wgmma"`` (the
    tensor cores, through TMA tensor maps) for bf16 with D % 8 == 0 (16-byte
    row strides) and D <= 128, else ``"simt"`` (the CUDA cores), f32
    included.  A dispatch by shape between two kernels, not a fallback."""
    if dtype == torch.bfloat16 and D % 8 == 0 and D <= MAX_TENSOR_CORE_HEAD_DIM:
        return "wgmma"
    return "simt"


def padded_head_dim(D: int, dtype: torch.dtype) -> int:
    """The head dim of the kernel build that runs ``D``: 64 for D <= 64, 128
    up to 128 and (on the CUDA cores) 256 above, in ceil(D / 256) pieces
    past 256; the columns past D are zeros in the kernels' tiles.  Raises
    ``ValueError`` for D outside 1..1024."""
    check_head_dim(D)
    return 64 if D <= 64 else 128 if D <= 128 else 256


def _lib():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
            + [ctypes.c_int64] * 12 + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def tma_aligned(t) -> bool:
    """Whether the bf16 kernel's tensor maps can describe ``t`` [B, S,
    heads, D]: TMA takes a base address and strides (batch, row, head) in
    multiples of 16 bytes."""
    return t.data_ptr() % 16 == 0 and all(s * t.element_size() % 16 == 0 for s in t.stride()[:3])


def _check(q, k, v):
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention_fwd takes CUDA tensors")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one of {list(_DTYPES)}; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("q [B, Sq, H, D]; k, v [B, Sk, KV, D]")
    B, Sq, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"shapes q {tuple(q.shape)} and k {tuple(k.shape)} do not match")
    if Sq == 0 or k.shape[1] == 0:
        raise ValueError("empty query or key sequence")
    padded_head_dim(D, q.dtype)
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("the head dim of q, k and v must be contiguous")
    if route(D, q.dtype) == "wgmma" and not all(tma_aligned(t) for t in (q, k, v)):
        raise ValueError("bf16 q, k and v need 16-byte aligned bases and strides "
                         "(the tensor-core kernel loads them through TMA tensor maps)")


def flash_attention_fwd(q, k, v, *, causal: bool = True, q_offset: int = 0):
    """q [B, Sq, H, D]; k, v [B, Sk, KV, D] (CUDA, f32 or bf16, 1 <= D <=
    1024, any strides with a contiguous last dim; on the tensor-core route,
    bases and strides 16-byte aligned) -> (o [B, Sq, H, D] in q's dtype,
    lse [B*H, Sq] f32).  ``route`` says which kernel runs: bf16 on the
    tensor cores (wgmma, TMA, warp specialisation) where D allows, the rest
    on the CUDA cores.  A ``meta`` q is priced (``pricing``), not launched."""
    if q.is_meta:
        B, Sq, H, D = q.shape
        o, lse = pricing.empty(q.shape, q.dtype), pricing.empty((B * H, Sq), torch.float32)
        return pricing.priced("flash_attention_fwd", (q, k, v), (o, lse),
                              4 * B * H * Sq * k.shape[1] * D, dot=True)
    _check(q, k, v)
    if q_offset < 0:
        raise ValueError(f"q_offset {q_offset} < 0")
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    o = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, Sq), dtype=torch.float32, device=q.device)
    fn = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, H, KV, Sq, Sk, D,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            o.stride(0), o.stride(1), o.stride(2),
            int(causal), int(q_offset), 1.0 / (D**0.5), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: cudaError_t {err}")
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0
