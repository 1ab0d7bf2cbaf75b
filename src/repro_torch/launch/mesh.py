"""Meshes of ranks, the counterpart of ``repro.launch.mesh``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the
reference's axis names, ``("data", "model")`` or ``("pod", "data",
"model")``, over the ranks of the default process group in order (rank
r at the row-major coordinate of r, as the reference lays its devices
out). Nothing here starts a process group: the launcher (``torchrun``
and ``launch/train.py``) or the caller does, and a mesh refuses to build
without one of its size. ``device_type="cuda"`` needs a card for each
rank.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def _mesh(shape, axes, device_type: str) -> DeviceMesh:
    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(f"a {shape} mesh needs a process group of {n} "
                           f"ranks; none is initialised")
    if dist.get_world_size() != n:
        raise RuntimeError(f"a {shape} mesh needs {n} ranks; the process "
                           f"group has {dist.get_world_size()}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a cuda mesh needs a CUDA device; pass "
                           "device_type='cpu' for the gloo CPU mesh")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod",
    "data", "model") with ``multi_pod``: 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_mesh_for(n_devices: int, model_parallel: int = 1,
                  device_type: str = "cuda") -> DeviceMesh:
    """The (n_devices / model_parallel, model_parallel) mesh over
    ("data", "model")."""
    if n_devices % model_parallel:
        raise ValueError(f"{n_devices} ranks do not split into model "
                         f"groups of {model_parallel}")
    return _mesh((n_devices // model_parallel, model_parallel),
                 ("data", "model"), device_type)
