"""mamba_scan — the CUDA mamba-1 selective scan (``csrc/mamba_scan.cu``),
counterpart of ``repro.kernels.mamba_scan``.

``mamba_scan_fwd`` launches the kernel on CUDA tensors in the model layout
and counts its launches in ``mamba_scan_fwd.launches``.  The plain version
is ``ref.mamba_scan_ref``; ``ops.mamba_scan`` chooses between the two by the
tensors' device.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, pricing

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_N = 32  # the lanes of one channel's state must fit a warp
_MAX_GRID_Y = 65535


def _lib():
    lib = _build.load("mamba_scan")
    fn = lib.mamba_scan_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(dA, dBu, C, h0):
    ts = (dA, dBu, C) + (() if h0 is None else (h0,))
    if not all(t.is_cuda for t in ts):
        raise ValueError("mamba_scan_fwd takes CUDA tensors")
    if any(t.device != dA.device for t in ts):
        raise ValueError("dA, dBu, C and h0 must lie on one device")
    if dA.dim() != 4 or dBu.shape != dA.shape:
        raise ValueError(f"dA, dBu must be [B, S, Ch, N] alike; got {tuple(dA.shape)}, "
                         f"{tuple(dBu.shape)}")
    B, S, Ch, N = dA.shape
    if tuple(C.shape) != (B, S, N):
        raise ValueError(f"C must be [B, S, N] = {(B, S, N)}; got {tuple(C.shape)}")
    if dA.dtype not in _DTYPES or dBu.dtype != dA.dtype or C.dtype != dA.dtype:
        raise TypeError(f"dA, dBu, C must share one of {list(_DTYPES)}; got {dA.dtype}, "
                        f"{dBu.dtype}, {C.dtype}")
    if N > MAX_N:
        raise ValueError(f"the state size N = {N} exceeds {MAX_N}")
    if B > _MAX_GRID_Y or max(dA.numel(), 1) >= 2**62:
        raise ValueError(f"mamba_scan_fwd: {tuple(dA.shape)} exceeds the grid")
    if h0 is not None and (h0.dtype != torch.float32 or tuple(h0.shape) != (B, Ch, N)):
        raise ValueError(f"h0 must be [B, Ch, N] = {(B, Ch, N)} f32; got "
                         f"{tuple(h0.shape)} {h0.dtype}")


def mamba_scan_fwd(dA, dBu, C, h0=None, with_state: bool = False):
    """dA, dBu [B, S, Ch, N], C [B, S, N] (CUDA, f32 or bf16, one dtype);
    h0 [B, Ch, N] f32 or None (zeros) -> y [B, S, Ch] in dA's dtype, with
    h_t = dA_t * h_{t-1} + dBu_t and y_t = h_t . C_t in f32; and, with
    ``with_state``, the last state h_S [B, Ch, N] f32 as well (``meta``
    inputs: priced, ``pricing``)."""
    if dA.is_meta:
        B, S, Ch, N = dA.shape
        out = (pricing.empty((B, S, Ch), dA.dtype),
               pricing.empty((B, Ch, N), torch.float32) if with_state else None)
        y, h = pricing.priced("mamba_scan_fwd", (dA, dBu, C, h0), out,
                              sum(t.numel() for t in out if t is not None))
        return (y, h) if with_state else y
    _check(dA, dBu, C, h0)
    B, S, Ch, N = dA.shape
    y = torch.empty((B, S, Ch), dtype=dA.dtype, device=dA.device)
    h_out = torch.empty((B, Ch, N), dtype=torch.float32, device=dA.device) if with_state else None
    if S == 0 or B == 0 or Ch == 0 or N == 0:  # nothing to launch
        if not with_state:
            return y
        return y, (h_out.zero_() if h0 is None else h_out.copy_(h0))
    dA, dBu, C = dA.contiguous(), dBu.contiguous(), C.contiguous()
    h0 = None if h0 is None else h0.contiguous()
    fn = _lib()
    with torch.cuda.device(dA.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(_DTYPES[dA.dtype], dA.data_ptr(), dBu.data_ptr(), C.data_ptr(),
                 None if h0 is None else h0.data_ptr(), y.data_ptr(),
                 None if h_out is None else h_out.data_ptr(), B, S, Ch, N, stream)
    if err != 0:
        raise RuntimeError(f"mamba_scan_fwd launch failed: cudaError_t {err}")
    mamba_scan_fwd.launches += 1
    return (y, h_out) if with_state else y


mamba_scan_fwd.launches = 0
