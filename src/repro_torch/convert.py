"""Carry arrays across between the packages: a nested dict of numpy arrays
(what ``jax.tree.map(np.asarray, params)`` gives) becomes the port's tensor
tree on a given device, leaf by leaf under the same keys
(``from_numpy_tree``), and back (``to_numpy_tree``).

bfloat16 and float8_e4m3fn arrays (``ml_dtypes`` types in numpy) go across
bit for bit, through an integer view of the same width, never through a
float cast.  The caller does the JAX-side flattening, so this module imports
no JAX.  Like every entry point of the port, the functions that make
tensors default to ``device="cuda"`` and raise without a card unless given
``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device

# numpy dtype name -> (unsigned view of the same width, torch dtype)
_BIT_VIEWS = {
    "bfloat16": (np.uint16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
}
# torch dtype -> (numpy dtype name, signed torch view of the same width)
_TORCH_BITS = {
    torch.bfloat16: ("bfloat16", torch.int16),
    torch.float8_e4m3fn: ("float8_e4m3fn", torch.int8),
}


def to_tensor(a, device="cuda") -> torch.Tensor:
    """One numpy array -> a tensor on ``device`` with the same bits."""
    dev = resolve_device(device)
    a = np.asarray(a)
    view = _BIT_VIEWS.get(a.dtype.name)
    if view is not None:
        bits, tdt = view
        return torch.from_numpy(a.view(bits).copy()).view(tdt).to(dev)
    return torch.from_numpy(a.copy()).to(dev)


def from_numpy_tree(tree, device="cuda"):
    """A nested dict of numpy arrays -> the same tree of tensors on
    ``device``."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: from_numpy_tree(v, dev) for k, v in tree.items()}
    return to_tensor(tree, dev)


def tensor_bits(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """(a host numpy array holding ``t``'s values, ``t``'s numpy dtype name).

    For bf16 and fp8 the array holds the raw bits as a void dtype of the
    same width, which is how ``np.save`` stores the ``ml_dtypes`` types;
    other dtypes come back as themselves."""
    t = t.detach().cpu()
    bits = _TORCH_BITS.get(t.dtype)
    if bits is None:
        a = t.numpy()
        return a, a.dtype.name
    name, view = bits
    a = t.contiguous().view(view).numpy()
    return a.view(np.dtype(f"V{a.itemsize}")), name


def from_bits(a: np.ndarray, dtype_name: str, device="cuda") -> torch.Tensor:
    """The inverse of ``tensor_bits``: a raw-bits (void), ``ml_dtypes`` or
    plain numpy array whose values are of dtype ``dtype_name`` -> a tensor."""
    dev = resolve_device(device)
    view = _BIT_VIEWS.get(dtype_name)
    if view is None:
        return to_tensor(a, dev)
    bits, tdt = view
    return torch.from_numpy(np.ascontiguousarray(a).view(bits).copy()).view(tdt).to(dev)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """One tensor -> a host numpy array with the same bits; bf16 and fp8
    become ``ml_dtypes`` arrays (imported only for them)."""
    a, name = tensor_bits(t)
    if a.dtype.kind != "V":
        return a
    import ml_dtypes  # numpy's bf16 and fp8 types

    return a.view(getattr(ml_dtypes, name))


def to_numpy_tree(tree):
    """A nested dict of tensors -> the same tree of host numpy arrays, bit
    for bit."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return to_numpy(tree)
