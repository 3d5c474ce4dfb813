"""The kernels' prices, for the cost model (``launch.costmodel``).

A step traced on the ``meta`` device runs nothing, so the hand-written
kernels it would launch on the card cannot be seen by counting aten ops.
Under ``pricing(record)`` (which ``launch.costmodel.step_cost`` opens) the
model takes the card's route for ``meta`` tensors (``on_card``), and each
kernel wrapper given ``meta`` tensors calls ``priced``: it records the
kernel by its wrapper's name (the ``kernels.counters`` names) with the
JAX cost model's ``_pallas_cost`` formulas, and returns empty ``meta``
results of the kernel's output shapes.  Bytes are the operands plus the
results (a kernel streams each operand through memory once and keeps its
intermediates on chip); FLOPs are the products' for the attention kernels
(4 BH Sq Sk D for the flash forward, 8 and 6 BH Sq Sk D for dK/dV and dQ,
4 BH Sk D for flash-decode, Sk the cache's slots) and the outputs'
elements for the gather and the scans.

No real tensor takes this branch: a CUDA tensor launches its kernel, a CPU
tensor takes the plain version, and a ``meta`` tensor that reaches a kernel
wrapper outside ``pricing`` raises.  The context is process-wide, as
``models.common.activate_sharding`` is, so that a backward run on the
autograd engine's thread sees it.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch

_RECORDS: list = []  # the record functions of the open pricing contexts


@contextlib.contextmanager
def pricing(record: Callable):
    """Within: ``meta`` tensors take the card's route, and each kernel they
    reach calls ``record(name, flops, nbytes, dot_flops)`` instead of
    launching."""
    _RECORDS.append(record)
    try:
        yield
    finally:
        _RECORDS.remove(record)


def active() -> bool:
    return bool(_RECORDS)


def on_card(t) -> bool:
    """Whether ``t`` takes the card's route: a CUDA tensor, or a ``meta``
    tensor under ``pricing``."""
    return t.is_cuda or (t.is_meta and bool(_RECORDS))


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def priced(name: str, operands: tuple, results: tuple, flops: float, dot: bool = False):
    """Record kernel ``name`` (its ``operands`` and ``results``: tensors,
    None for an absent one) at ``flops`` (``dot``: all of them products) and
    return ``results``.  Outside ``pricing`` it raises: the kernels take
    CUDA tensors."""
    if not _RECORDS:
        raise ValueError(f"{name} takes CUDA tensors; a meta tensor is priced only under "
                         "launch.costmodel.step_cost")
    _RECORDS[-1](name, float(flops), _nbytes(operands) + _nbytes(results),
                 float(flops) if dot else 0.0)
    return results


def empty(shape, dtype):
    """An empty ``meta`` result."""
    return torch.empty(shape, dtype=dtype, device="meta")
