"""prefetch_gather — the CUDA hint-driven row gather (``csrc/
prefetch_gather.cu``), counterpart of ``repro.kernels.prefetch_gather``.

``prefetch_gather_fwd`` launches the kernel on CUDA tensors and counts its
launches in ``prefetch_gather_fwd.launches``.  The plain version is
``ref.prefetch_gather_ref``; ``ops.prefetch_gather`` chooses between the
two by the tensors' device.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, pricing

_IDX_DTYPES = {torch.int32: 0, torch.int64: 1}
_UNITS = (16, 8, 4, 2, 1)  # copy widths in bytes, widest first
_NT = 256  # threads per block (units per chunk) in the kernel
_MAX_CHUNKS = 65535  # grid.y


def _lib():
    lib = _build.load("prefetch_gather")
    fn = lib.prefetch_gather
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p]
            + [ctypes.c_int64] * 4 + [ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def _copy_unit(row_bytes: int, table_row_bytes: int, *ptrs: int) -> int:
    """The widest copy width (bytes) that divides the row's bytes, the
    table's row stride and every base address."""
    for u in _UNITS:
        if all(x % u == 0 for x in (row_bytes, table_row_bytes, *ptrs)):
            return u
    return 1


def _check(table, idx):
    if not (table.is_cuda and idx.is_cuda):
        raise ValueError("prefetch_gather_fwd takes CUDA tensors")
    if table.device != idx.device:
        raise ValueError("table and idx must lie on one device")
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"table [N, D] and idx [B]; got {tuple(table.shape)}, "
                         f"{tuple(idx.shape)}")
    if idx.dtype not in _IDX_DTYPES:
        raise TypeError(f"idx dtype {idx.dtype} not in {list(_IDX_DTYPES)}")
    if table.shape[1] > 1 and table.stride(1) != 1:
        raise ValueError("the rows of table must be contiguous")


def prefetch_gather_fwd(table, idx):
    """table [N, D] (CUDA, any dtype, contiguous rows, any row stride); idx
    [B] int32 or int64 on the same device, each in [0, N) -> out [B, D] =
    table[idx], bit for bit.  The indices are read on the device only; one
    outside [0, N) fails a device-side assert.  A ``meta`` table is priced
    (``pricing``), not launched."""
    if table.is_meta:
        out = pricing.empty((idx.shape[0], table.shape[1]), table.dtype)
        return pricing.priced("prefetch_gather_fwd", (table, idx), (out,), out.numel())[0]
    _check(table, idx)
    N, D = table.shape
    B = idx.shape[0]
    out = torch.empty((B, D), dtype=table.dtype, device=table.device)
    if B == 0 or D == 0:
        return out
    if N == 0:
        raise IndexError("prefetch_gather_fwd: gather from an empty table")
    item = table.element_size()
    row_bytes, table_row_bytes = D * item, table.stride(0) * item
    unit = _copy_unit(row_bytes, table_row_bytes, table.data_ptr(), out.data_ptr())
    if -(-row_bytes // (unit * _NT)) > _MAX_CHUNKS or B >= 2**31:
        raise ValueError(f"prefetch_gather_fwd: [{B}, {D}] {table.dtype} exceeds the grid")
    fn = _lib()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(table.data_ptr(), idx.data_ptr(), _IDX_DTYPES[idx.dtype], idx.stride(0),
                 out.data_ptr(), N, B, row_bytes, table_row_bytes, unit, stream)
    if err != 0:
        raise RuntimeError(f"prefetch_gather_fwd launch failed: cudaError_t {err}")
    prefetch_gather_fwd.launches += 1
    return out


prefetch_gather_fwd.launches = 0
