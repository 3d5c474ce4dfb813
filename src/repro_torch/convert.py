"""Carry arrays across from the JAX package: a nested dict of numpy arrays
(what ``jax.tree.map(np.asarray, params)`` gives) becomes the port's tensor
tree on a given device, leaf by leaf under the same keys.

bfloat16 and float8_e4m3fn arrays (``ml_dtypes`` types in numpy) go across
bit for bit, through an unsigned-integer view, never through a float cast.
The caller does the JAX-side flattening, so this module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

# numpy dtype name -> (unsigned view of the same width, torch dtype)
_BIT_VIEWS = {
    "bfloat16": (np.uint16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
}


def to_tensor(a, device="cpu") -> torch.Tensor:
    """One numpy array -> a tensor on ``device`` with the same bits."""
    a = np.asarray(a)
    view = _BIT_VIEWS.get(a.dtype.name)
    if view is not None:
        bits, tdt = view
        return torch.from_numpy(a.view(bits).copy()).view(tdt).to(device)
    return torch.from_numpy(a.copy()).to(device)


def from_numpy_tree(tree, device="cpu"):
    """A nested dict of numpy arrays -> the same tree of tensors on
    ``device``."""
    if isinstance(tree, dict):
        return {k: from_numpy_tree(v, device) for k, v in tree.items()}
    return to_tensor(tree, device)
