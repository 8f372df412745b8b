"""Device meshes over the process group this process already joined.

Counterpart of ``repro/launch/mesh.py``.  The reference lays
``jax.devices()`` out as a ``jax.sharding.Mesh``; the port builds a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the default
process group, which the caller initialises first
(``torch.distributed.init_process_group`` with an address, world size and
rank of its own: nothing here reads a cluster's environment).  Building a
mesh is collective: every rank of the group calls it with the same
arguments.

The device is explicit: ``"cuda"`` (the group's backend NCCL) by default,
``"cpu"`` (gloo) when the caller asks.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch import resolve_device


def _mesh(shape, axes, device) -> DeviceMesh:
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} has {len(shape)} axes, "
                         f"names {tuple(axes)} {len(axes)}")
    n = math.prod(shape)
    world = dist.get_world_size()
    if world < n:
        raise RuntimeError(f"mesh {tuple(shape)} needs {n} ranks, the "
                           f"process group has {world}")
    ranks = torch.arange(n).reshape(tuple(shape))
    return DeviceMesh(resolve_device(device).type, ranks,
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """Single pod: (16, 16) ("data", "model") = 256 ranks.
    Multi-pod: (2, 16, 16) ("pod", "data", "model") = 512 ranks.
    Raises ``RuntimeError`` when the process group is smaller."""
    if multi_pod:
        return _mesh((2, 16, 16), ("pod", "data", "model"), device)
    return _mesh((16, 16), ("data", "model"), device)


def make_test_mesh(shape=(2, 2), axes=("data", "model"), device: str = "cuda"):
    """Small mesh for multi-process tests: the group's first
    ``prod(shape)`` ranks laid out as ``shape``."""
    return _mesh(tuple(shape), tuple(axes), device)
