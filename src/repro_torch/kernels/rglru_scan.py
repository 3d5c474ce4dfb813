"""rglru_scan — the CUDA RG-LRU recurrence (``csrc/rglru_scan.cu``),
counterpart of ``repro.kernels.rglru_scan``.

``rglru_scan_fwd`` launches the kernel on CUDA tensors in the model layout
[B, S, W] and counts its launches in ``rglru_scan_fwd.launches``.  The
plain version is ``ref.rglru_scan_ref``; ``ops.rglru_scan`` chooses between
the two by the tensors' device.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535


def _lib():
    lib = _build.load("rglru_scan")
    fn = lib.rglru_scan_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(a, g, h0):
    ts = (a, g) + (() if h0 is None else (h0,))
    if not all(t.is_cuda for t in ts):
        raise ValueError("rglru_scan_fwd takes CUDA tensors")
    if any(t.device != a.device for t in ts):
        raise ValueError("a, g and h0 must lie on one device")
    if a.dim() != 3 or g.shape != a.shape:
        raise ValueError(f"a, g must be [B, S, W] alike; got {tuple(a.shape)}, "
                         f"{tuple(g.shape)}")
    if a.dtype not in _DTYPES or g.dtype != a.dtype:
        raise TypeError(f"a, g must share one of {list(_DTYPES)}; got {a.dtype}, {g.dtype}")
    B, S, W = a.shape
    if B > _MAX_GRID_Y or max(a.numel(), 1) >= 2**62:
        raise ValueError(f"rglru_scan_fwd: {tuple(a.shape)} exceeds the grid")
    if h0 is not None and (h0.dtype != torch.float32 or tuple(h0.shape) != (B, W)):
        raise ValueError(f"h0 must be [B, W] = {(B, W)} f32; got {tuple(h0.shape)} {h0.dtype}")


def rglru_scan_fwd(a, g, h0=None):
    """a, g [B, S, W] (CUDA, f32 or bf16, one dtype); h0 [B, W] f32 or None
    (zeros) -> y [B, S, W] in a's dtype, y_t = h_t = a_t * h_{t-1} + g_t
    with an f32 state."""
    _check(a, g, h0)
    B, S, W = a.shape
    y = torch.empty((B, S, W), dtype=a.dtype, device=a.device)
    if y.numel() == 0:
        return y
    a, g = a.contiguous(), g.contiguous()
    h0 = None if h0 is None else h0.contiguous()
    fn = _lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(_DTYPES[a.dtype], a.data_ptr(), g.data_ptr(),
                 None if h0 is None else h0.data_ptr(), y.data_ptr(), B, S, W, stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan_fwd launch failed: cudaError_t {err}")
    rglru_scan_fwd.launches += 1
    return y


rglru_scan_fwd.launches = 0
