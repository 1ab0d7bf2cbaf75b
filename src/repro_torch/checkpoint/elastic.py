"""Elastic re-scaling: load a checkpoint saved on mesh A onto mesh B, the
counterpart of ``repro.checkpoint.elastic``.

Checkpoints are mesh-agnostic (whole leaves as ``.npy`` files and a
manifest, ``manager.py``), so elasticity is "load with the new
placements": each rank memory-maps every leaf and reads only its block
under the placements of ``like``'s DTensor leaves. The failure modes are
handled explicitly: shape mismatches reported per leaf, missing leaves
tolerated only when asked (``strict=False``: a config that legitimately
adds state), and the data pipeline's step restored with the rest.
"""
from __future__ import annotations

import json
import os
from typing import Any, List, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import as_dtensor, local_slices
from .manager import _flatten_with_names, _unflatten_like


def _manifest(path: str) -> dict:
    with open(os.path.join(path, "manifest.json")) as f:
        return {m["name"]: m for m in json.load(f)}


def validate_compat(path: str, like: Any) -> Tuple[List[str], List[str]]:
    """Returns (missing_in_ckpt, shape_mismatches)."""
    manifest = _manifest(path)
    names, leaves = _flatten_with_names(like)
    missing, mismatched = [], []
    for name, leaf in zip(names, leaves):
        if name not in manifest:
            missing.append(name)
        elif list(leaf.shape) != manifest[name]["shape"]:
            mismatched.append(f"{name}: ckpt{manifest[name]['shape']} vs "
                              f"new{list(leaf.shape)}")
    return missing, mismatched


def _read(arr: np.ndarray, leaf):
    """``leaf``'s part of the (memory-mapped) stored array: a DTensor
    leaf's block on its rank and device, a tensor leaf whole on its
    device (the CPU for meta), anything else a numpy array."""
    if isinstance(leaf, DTensor):
        mesh = leaf.device_mesh
        sl = local_slices(leaf.shape, leaf.placements, mesh.shape,
                          mesh.get_coordinate())
        local = torch.from_numpy(np.ascontiguousarray(arr[sl])).to(
            device=leaf.to_local().device, dtype=leaf.dtype)
        return as_dtensor(local, mesh, leaf.placements, leaf.shape)
    if isinstance(leaf, torch.Tensor):
        dev = "cpu" if leaf.device.type == "meta" else leaf.device
        return torch.from_numpy(np.array(arr)).to(device=dev,
                                                  dtype=leaf.dtype)
    return np.array(arr)


def reshard_checkpoint(path: str, like: Any, strict: bool = True) -> Any:
    """Load ``path`` into ``like``'s structure, each DTensor leaf as this
    rank's block under its placements (read from the memory-mapped file,
    nothing else of it touched).

    With ``strict=False``, leaves missing from the checkpoint keep their
    value from ``like`` (for added state), still erroring on shape
    mismatches (a real incompatibility)."""
    missing, mismatched = validate_compat(path, like)
    if mismatched:
        raise ValueError("elastic reshard: shape mismatches:\n  "
                         + "\n  ".join(mismatched))
    if missing and strict:
        raise ValueError(f"elastic reshard: {len(missing)} leaves missing "
                         f"from checkpoint: {missing[:5]}...")
    manifest = _manifest(path)
    names, leaves = _flatten_with_names(like)
    out = []
    for name, leaf in zip(names, leaves):
        if name in manifest:
            arr = np.load(os.path.join(path,
                                       f"leaf_{manifest[name]['i']}.npy"),
                          mmap_mode="r")
            out.append(_read(arr, leaf))
        else:
            out.append(leaf)
    return _unflatten_like(like, out)
