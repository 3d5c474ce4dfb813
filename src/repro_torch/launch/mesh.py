"""Mesh construction over ``torch.distributed``.  Counterpart of
``repro.launch.mesh``.

A mesh is a ``DeviceMesh`` whose dimension names are the JAX package's
axis names: ``("data", "model")`` on one pod, ``("pod", "data", "model")``
across pods (the pod axis carries pure data parallelism).

The process group's backend is the caller's choice, never a guess: NCCL
with one rank per card is the production backend; gloo is taken only where
it is asked for (the CPU tests, and several ranks sharing one card, which
NCCL refuses).  A process group that already exists must have the backend
asked for.  Nothing here runs at import: the functions touch the process
group only when called.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def _default_backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def make_mesh(shape: tuple, axes: tuple, device="cuda",
              backend: Optional[str] = None) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over every rank of the
    process group.  ``backend``: ``"nccl"`` (one rank per card; the default
    on CUDA) or ``"gloo"`` (the default on the CPU, and the only one for
    several ranks on one card).  Without a process group, one is started
    from the environment (``torchrun``'s ``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``) with that backend; with one, its
    backend must be ``backend``."""
    device_type = torch.device(device).type
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh was asked for but torch.cuda.is_available() is False")
    backend = backend or _default_backend(device_type)
    if not dist.is_initialized():
        dist.init_process_group(backend)
    have = dist.get_backend()  # "gloo", "nccl", or per device "cpu:gloo,cuda:nccl"
    if backend not in have:
        raise RuntimeError(f"the process group runs {have!r}, the mesh asks for {backend!r}")
    n = 1
    for s in shape:
        n *= s
    if dist.get_world_size() != n:
        raise RuntimeError(f"a {shape} mesh needs {n} ranks, the process group has "
                           f"{dist.get_world_size()}")
    if backend == "gloo" and device_type == "cuda":
        route_all_gather("CUDA")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


_ROUTED: dict = {}  # dispatch key -> the library that holds the override


def route_all_gather(dispatch_key: str) -> None:
    """Send the functional all-gather (``_c10d_functional.all_gather_into_tensor``,
    which DTensor's Shard -> Replicate redistributions call) of a gloo group
    through c10d's ``all_gather_into_tensor`` for tensors of ``dispatch_key``.

    Over gloo, CUDA tensors take every collective DTensor and the MoE
    paths use (all-reduce, reduce-scatter, all-to-all, c10d's all-gather)
    except the functional all-gather, whose coalesced gloo path kills the
    process (measured on an H100 with PyTorch 2.11); this keeps the same
    gather, synchronous, on the path gloo takes.  The override holds for the
    process, so a group of another backend (NCCL) keeps the functional op's
    own path: the coalesced all-gather, its work registered for
    ``wait_tensor``."""
    if dispatch_key in _ROUTED:
        return
    import torch.distributed.distributed_c10d as c10d
    from torch._C._distributed_c10d import _register_work

    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor

    def all_gather_into_tensor(input, group_size, group_name):
        group = c10d._resolve_process_group(group_name)
        input = input.contiguous()
        out = input.new_empty((input.shape[0] * group_size, *input.shape[1:]))
        if group._get_backend(input.device).name() != "gloo":
            _register_work(out, group.allgather_into_tensor_coalesced([out], [input]))
            return out
        gather(out, input, group=group)
        return out

    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", all_gather_into_tensor, dispatch_key)
    _ROUTED[dispatch_key] = lib


def make_production_mesh(*, multi_pod: bool = False, device="cuda",
                         backend: Optional[str] = None) -> DeviceMesh:
    """The production mesh: (16, 16) ``("data", "model")``, or with
    ``multi_pod`` (2, 16, 16) ``("pod", "data", "model")``.  Raises when the
    process group has too few ranks."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    n = 1
    for s in shape:
        n *= s
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < n:
        raise RuntimeError(f"need {n} ranks for the production mesh, have {have}")
    return make_mesh(shape, axes, device, backend)


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or of a shape-only stand-in
    with a ``shape`` dict (the rules read nothing else)."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def data_axes(mesh) -> tuple:
    """The axes that carry batch data parallelism."""
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)


def model_axis(mesh) -> str:
    return "model"
