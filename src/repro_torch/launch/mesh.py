"""Device meshes (port of ``repro.launch.mesh``) on the process group that
already exists: the caller runs ``torch.distributed.init_process_group``
(its address, world size and rank given explicitly) before building one.

``make_production_mesh`` is a FUNCTION (not a module constant), so
importing this module touches no device and no process group.
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..models.model import resolve_device


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """16x16 ``("data", "model")`` (256 ranks) or 2x16x16 ``("pod",
    "data", "model")`` (512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_debug_mesh(shape=(2, 2), axes=("data", "model"),
                    device_type: str = "cuda") -> DeviceMesh:
    """A small mesh (CPU gloo worlds in the tests, a (1, 1) mesh on one
    card)."""
    return _mesh(tuple(shape), tuple(axes), device_type)


def _mesh(shape: tuple, axes: tuple, device_type: str) -> DeviceMesh:
    resolve_device(device_type)
    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, "
                         f"the world has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)
