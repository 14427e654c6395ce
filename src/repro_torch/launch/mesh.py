"""Device meshes (the JAX package's ``launch/mesh.py``): a ``DeviceMesh``
over the ranks of the default process group, which the caller has
initialised (``torch.distributed.init_process_group`` with its address,
world size and rank). One rank a device; the mesh takes every rank."""
from __future__ import annotations

import math
from typing import Sequence

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(shape: Sequence[int], axes: Sequence[str], device_type: str) -> DeviceMesh:
    """A mesh of ``shape`` with axis names ``axes`` on ``device_type``
    (``"cuda"`` or ``"cpu"``); the process group must have exactly
    ``prod(shape)`` ranks."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks; the process group "
                         f"has {dist.get_world_size()}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """The production layout: 16x16 = 256 devices a pod, 2 pods = 512.

    Axes: ``data`` (batch / FSDP), ``model`` (TP / EP), and in multi-pod
    runs ``pod`` (a second pure-data axis across the inter-pod links)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)
