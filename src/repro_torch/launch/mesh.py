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


def entry_axes(entry) -> tuple:
    """The axes a spec entry names (None, an axis, or a tuple of axes)."""
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def entry_size(mesh, entry) -> int:
    """The number of ranks a spec entry spans: the product of its axes'
    sizes (1 for None)."""
    n = 1
    for a in entry_axes(entry):
        n *= mesh.size(mesh.mesh_dim_names.index(a))
    return n


def entry_rank(mesh, entry) -> int:
    """This rank's index along a spec entry: for a tuple of axes the index
    of the one flattened axis, in JAX's order (the first axis major):
    ``pod_rank * |data| + data_rank`` for ``("pod", "data")``.  That is
    the order in which DTensor nests a dim split over those axes, so rank
    ``r``'s shard of ``n`` rows starts at ``r * n``."""
    r = 0
    for a in entry_axes(entry):
        r = r * mesh.size(mesh.mesh_dim_names.index(a)) + mesh.get_local_rank(a)
    return r


def entry_group(mesh, entry):
    """The process group of a spec entry's ranks: one axis's group, or for
    a tuple the group of the axes flattened into one (``DeviceMesh._flatten``,
    made once and kept by the mesh), whose ranks run in ``entry_rank``'s
    order.  A collective over it is one call, not one per axis."""
    names = entry_axes(entry)
    if len(names) == 1:
        return mesh.get_group(names[0])
    return mesh[names]._flatten().get_group()


def data_axes(mesh) -> tuple:
    """The axes that carry batch data parallelism."""
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)


def model_axis(mesh) -> str:
    return "model"
