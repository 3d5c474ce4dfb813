"""selective_scan — the CUDA mamba-1 selective scan with the discretisation
formed inside the kernel (``csrc/selective_scan.cu``), counterpart of the
JAX model's ``repro.models.ssm.selective_scan``.

``selective_scan_fwd`` launches the kernel on CUDA tensors in the model
layouts and counts its launches in ``selective_scan_fwd.launches``.  The
plain version is ``ref.selective_scan_ref``; ``ops.selective_scan`` chooses
between the two by the tensors' device.  Unlike ``mamba_scan_fwd`` (the TPU
kernel's contract: dA and dBu materialised as [B, S, Ch, N] tensors) it
reads dt, u, A, B, C and D, so neither [B, S, Ch, N] tensor exists.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, pricing
from .decode_attention import _sm_count

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_N = 32
_MAX_GRID_Y = 65535


def scan_lanes(B: int, Ch: int, n_sm: int = 132) -> int:
    """Threads per channel of the prefill kernel (1, 2 or 4): one, each
    thread holding a channel's N states, unless B * Ch channel threads give
    the card fewer than 8 warps per SM; then the states are split over 2 or
    4 lanes.  At falcon-mamba-7b's serving prefill (B * Ch = 32,768, 7.75
    warps per SM with one lane) two lanes ran 0.37 ms on an H100, one 0.44
    and four 0.63 (the shuffle and the per-step work repeated per lane)."""
    lanes = 1
    while lanes < 4 and B * Ch * lanes < 8 * 32 * n_sm:
        lanes *= 2
    return lanes


def _lib():
    lib = _build.load("selective_scan")
    fn = lib.selective_scan_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                       + [ctypes.c_int64] * 4 + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(u, dt, A, B_ssm, C_ssm, D, h0, h_out):
    ts = [t for t in (u, dt, A, B_ssm, C_ssm, D, h0, h_out) if t is not None]
    if not all(t.is_cuda for t in ts):
        raise ValueError("selective_scan_fwd takes CUDA tensors")
    if any(t.device != u.device for t in ts):
        raise ValueError("the inputs of selective_scan_fwd must lie on one device")
    if u.dim() != 3 or dt.shape != u.shape:
        raise ValueError(f"u, dt must be [B, S, Ch] alike; got {tuple(u.shape)}, "
                         f"{tuple(dt.shape)}")
    Bsz, S, Ch = u.shape
    if A.dim() != 2 or A.shape[0] != Ch:
        raise ValueError(f"A must be [Ch, N] with Ch = {Ch}; got {tuple(A.shape)}")
    N = A.shape[1]
    for name, t in (("B_ssm", B_ssm), ("C_ssm", C_ssm)):
        if tuple(t.shape) != (Bsz, S, N) or t.stride(2) != 1:
            raise ValueError(f"{name} must be [B, S, N] = {(Bsz, S, N)} with a contiguous "
                             f"last dim; got {tuple(t.shape)} strides {t.stride()}")
    if u.dtype not in _DTYPES or any(t.dtype != u.dtype for t in (dt, B_ssm, C_ssm)):
        raise TypeError(f"u, dt, B_ssm, C_ssm must share one of {list(_DTYPES)}; got "
                        f"{u.dtype}, {dt.dtype}, {B_ssm.dtype}, {C_ssm.dtype}")
    if A.dtype != torch.float32 or D.dtype != torch.float32 or tuple(D.shape) != (Ch,):
        raise TypeError(f"A [Ch, N] and D [Ch] must be f32; got {A.dtype} "
                        f"{tuple(A.shape)}, {D.dtype} {tuple(D.shape)}")
    if not 1 <= N <= MAX_N:
        raise ValueError(f"the state size N = {N} is outside 1..{MAX_N}")
    if Bsz > _MAX_GRID_Y or max(u.numel(), 1) >= 2**62:
        raise ValueError(f"selective_scan_fwd: {tuple(u.shape)} exceeds the grid")
    for name, t in (("h0", h0), ("h_out", h_out)):
        if t is not None and (t.dtype != torch.float32 or tuple(t.shape) != (Bsz, Ch, N)):
            raise ValueError(f"{name} must be [B, Ch, N] = {(Bsz, Ch, N)} f32; got "
                             f"{tuple(t.shape)} {t.dtype}")
    if h_out is not None and not h_out.is_contiguous():
        raise ValueError("h_out must be contiguous (the kernel writes the state in place)")


def selective_scan_fwd(u, dt, A, B_ssm, C_ssm, D, h0=None, *, h_out=None, _lanes=None):
    """u, dt [B, S, Ch], B_ssm, C_ssm [B, S, N] (CUDA, f32 or bf16, one dtype;
    B and C with any batch and step strides); A [Ch, N], D [Ch] f32; h0 [B,
    Ch, N] f32 or None (zeros) -> (y [B, S, Ch] in u's dtype, h_S [B, Ch, N]
    f32): h_t = exp(dt_t A) h_{t-1} + (dt_t u_t) B_t, y_t = h_t . C_t + D
    u_t.  With ``h_out`` (contiguous, possibly ``h0`` itself) the last state
    is written there and returned.  ``_lanes`` overrides ``scan_lanes``, for
    timing the splits side by side (``chip_smoke.py``'s ``[scans]`` sweep).
    ``meta`` inputs are priced (``pricing``), not launched."""
    if u.is_meta:
        y = pricing.empty(u.shape, u.dtype)
        h = h_out if h_out is not None else pricing.empty(
            (u.shape[0], u.shape[2], A.shape[1]), torch.float32)
        return pricing.priced("selective_scan_fwd", (u, dt, A, B_ssm, C_ssm, D, h0), (y, h),
                              y.numel() + h.numel())
    _check(u, dt, A, B_ssm, C_ssm, D, h0, h_out)
    Bsz, S, Ch = u.shape
    N = A.shape[1]
    y = torch.empty((Bsz, S, Ch), dtype=u.dtype, device=u.device)
    if h_out is None:
        h_out = torch.empty((Bsz, Ch, N), dtype=torch.float32, device=u.device)
    if S == 0 or Bsz == 0 or Ch == 0:  # nothing to launch
        if h0 is None:
            return y, h_out.zero_()
        return y, (h_out if h_out.data_ptr() == h0.data_ptr() else h_out.copy_(h0))
    lanes = scan_lanes(Bsz, Ch, _sm_count(u.device.index)) if _lanes is None else _lanes
    if lanes not in (1, 2, 4):
        raise ValueError(f"lanes {lanes}: the kernel takes 1, 2 or 4 threads per channel")
    u, dt, A, D = u.contiguous(), dt.contiguous(), A.contiguous(), D.contiguous()
    h0 = None if h0 is None else h0.contiguous()
    fn = _lib()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(_DTYPES[u.dtype], u.data_ptr(), dt.data_ptr(), A.data_ptr(),
                 B_ssm.data_ptr(), C_ssm.data_ptr(), D.data_ptr(),
                 None if h0 is None else h0.data_ptr(), y.data_ptr(), h_out.data_ptr(),
                 Bsz, S, Ch, N, B_ssm.stride(0), B_ssm.stride(1), C_ssm.stride(0),
                 C_ssm.stride(1), lanes, stream)
    if err != 0:
        raise RuntimeError(f"selective_scan_fwd launch failed: cudaError_t {err}")
    selective_scan_fwd.launches += 1
    return y, h_out


selective_scan_fwd.launches = 0
