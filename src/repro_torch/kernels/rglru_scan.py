"""rglru_scan — the CUDA RG-LRU recurrence (``csrc/rglru_scan.cu``), in two
forms:

  * ``rglru_scan_fwd``: the materialised form, counterpart of
    ``repro.kernels.rglru_scan`` (a and g in); plain version
    ``ref.rglru_scan_ref``, chosen by ``ops.rglru_scan``;
  * ``rglru_gated_fwd``: the fused form, counterpart of the JAX model's
    ``repro.models.rglru.rglru_scan`` (x, r, i and the decay coefficient c
    in, the gates formed inside the kernel); plain version
    ``ref.rglru_gated_scan_ref``, chosen by ``ops.rglru_gated_scan``.

Both take CUDA tensors in the model layout [B, S, W] and count their
launches in ``.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, pricing

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535


def _check(what: str, ins, h0, c=None):
    """``ins``: the [B, S, W] inputs of one dtype; ``c`` [W] f32 (fused)."""
    x = ins[0]
    ts = list(ins) + [t for t in (h0, c) if t is not None]
    if not all(t.is_cuda for t in ts):
        raise ValueError(f"{what} takes CUDA tensors")
    if any(t.device != x.device for t in ts):
        raise ValueError(f"the inputs of {what} must lie on one device")
    if x.dim() != 3 or any(t.shape != x.shape for t in ins):
        raise ValueError(f"{what}: the inputs must be [B, S, W] alike; got "
                         f"{[tuple(t.shape) for t in ins]}")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in ins):
        raise TypeError(f"{what}: the inputs must share one of {list(_DTYPES)}; got "
                        f"{[t.dtype for t in ins]}")
    B, S, W = x.shape
    if B > _MAX_GRID_Y or max(x.numel(), 1) >= 2**62:
        raise ValueError(f"{what}: {tuple(x.shape)} exceeds the grid")
    if h0 is not None and (h0.dtype != torch.float32 or tuple(h0.shape) != (B, W)):
        raise ValueError(f"h0 must be [B, W] = {(B, W)} f32; got {tuple(h0.shape)} {h0.dtype}")
    if c is not None and (c.dtype != torch.float32 or tuple(c.shape) != (W,)):
        raise ValueError(f"c must be [W] = [{W}] f32; got {tuple(c.shape)} {c.dtype}")


def _launch(name: str, n_ptrs: int, args):
    lib = _build.load("rglru_scan")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(args[1].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*[a if isinstance(a, int) else ptr(a) for a in args], stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def rglru_scan_fwd(a, g, h0=None):
    """a, g [B, S, W] (CUDA, f32 or bf16, one dtype); h0 [B, W] f32 or None
    (zeros) -> y [B, S, W] in a's dtype, y_t = h_t = a_t * h_{t-1} + g_t
    with an f32 state (``meta`` inputs: priced, ``pricing``)."""
    if a.is_meta:
        y = pricing.empty(a.shape, a.dtype)
        return pricing.priced("rglru_scan_fwd", (a, g, h0), (y,), y.numel())[0]
    _check("rglru_scan_fwd", (a, g), h0)
    B, S, W = a.shape
    y = torch.empty((B, S, W), dtype=a.dtype, device=a.device)
    if y.numel() == 0:
        return y
    a, g = a.contiguous(), g.contiguous()
    h0 = None if h0 is None else h0.contiguous()
    _launch("rglru_scan_fwd", 4, [_DTYPES[a.dtype], a, g, h0, y, B, S, W])
    rglru_scan_fwd.launches += 1
    return y


def rglru_gated_fwd(x, r, i, c, h0=None):
    """x, r, i [B, S, W] (CUDA, f32 or bf16, one dtype); c [W] f32, the decay
    coefficient -8 softplus(lam); h0 [B, W] f32 or None (zeros) -> (y [B, S,
    W] in x's dtype, h_S [B, W] f32), with a_t = exp(c r_t), g_t = (i_t x_t)
    sqrt(max(1 - a_t^2, 1e-12)) and h_t = a_t h_{t-1} + g_t in f32
    (``meta`` inputs: priced, ``pricing``)."""
    if x.is_meta:
        y, h = pricing.empty(x.shape, x.dtype), pricing.empty((x.shape[0], x.shape[2]),
                                                               torch.float32)
        return pricing.priced("rglru_gated_fwd", (x, r, i, c, h0), (y, h), y.numel() + h.numel())
    _check("rglru_gated_fwd", (x, r, i), h0, c)
    B, S, W = x.shape
    y = torch.empty((B, S, W), dtype=x.dtype, device=x.device)
    h_out = torch.empty((B, W), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y, (h_out.zero_() if h0 is None else h_out.copy_(h0))
    x, r, i, c = x.contiguous(), r.contiguous(), i.contiguous(), c.contiguous()
    h0 = None if h0 is None else h0.contiguous()
    _launch("rglru_gated_fwd", 7, [_DTYPES[x.dtype], x, r, i, c, h0, y, h_out, B, S, W])
    rglru_gated_fwd.launches += 1
    return y, h_out


rglru_scan_fwd.launches = 0
rglru_gated_fwd.launches = 0
