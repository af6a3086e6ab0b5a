"""Device meshes (factory functions: importing this module touches no
device and no process group).

Port of ``repro.launch.mesh``. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the default process
group, one process per device: NCCL on CUDA devices, gloo on the CPU.
The production meshes are JAX's: a single pod (16, 16) ("data", "model"),
two pods (2, 16, 16) ("pod", "data", "model"), the "pod" axis carrying
pure data parallelism.

A process group the caller (or ``torchrun``) initialized is used as it
is; its world size must equal the mesh's size. With none, a mesh of one
device gets a one-rank group over an in-memory store
(``torch.distributed.HashStore``: no network, no launcher), which
:func:`release` destroys; a larger mesh raises.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

#: The process group this module initialized for a one-device mesh, if any.
_OWNED: list = []


def backend_for(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def make_mesh(shape, axes, device=None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default process
    group, on ``device``'s type (``core.solver.resolve_device``: CUDA unless
    the caller asks for the CPU). Raises where the group's world size is
    not the mesh's size, or where a mesh of more than one device has no
    group to run on."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.solver import resolve_device

    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    dev = resolve_device(device)
    size = math.prod(shape)
    if not dist.is_initialized():
        if size != 1:
            raise RuntimeError(
                f"a mesh of {size} devices needs an initialized process group "
                "(torch.distributed.init_process_group, or torchrun); none is")
        if dev.type == "cuda" and dev.index is not None:
            torch.cuda.set_device(dev)
        dist.init_process_group(backend_for(dev.type), store=dist.HashStore(), rank=0,
                                world_size=1)
        _OWNED.append(dist.group.WORLD)
    if dist.get_world_size() != size:
        raise ValueError(f"mesh {dict(zip(axes, shape))} has {size} devices; the process group "
                         f"has {dist.get_world_size()} ranks")
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def release() -> None:
    """Destroy the process group :func:`make_mesh` created, if any (a group
    the caller initialized is the caller's)."""
    while _OWNED:
        _OWNED.pop()
        if dist.is_initialized():
            dist.destroy_process_group()


def host_device_counts() -> dict:
    """JAX's keys for this process: ``n_devices`` (the world size),
    ``n_local`` (ranks on this host), ``process_index`` (the rank) and
    ``process_count`` (the world size). JAX runs one process per host
    driving every local device; the port runs one process per device, so
    a rank is a process and ``n_local`` counts this host's ranks
    (``LOCAL_WORLD_SIZE`` as torchrun sets it, else 1). Without a process
    group: one device, one process."""
    if not dist.is_initialized():
        return {"n_devices": 1, "n_local": 1, "process_index": 0, "process_count": 1}
    import os

    world = dist.get_world_size()
    return {"n_devices": world, "n_local": int(os.environ.get("LOCAL_WORLD_SIZE", 1)),
            "process_index": dist.get_rank(), "process_count": world}
