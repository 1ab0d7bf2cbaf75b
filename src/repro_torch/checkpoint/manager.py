"""Fault-tolerant checkpointing with the reference's on-disk layout, the
counterpart of ``repro.checkpoint.manager``.

A checkpoint is a directory of ``leaf_{i}.npy`` files and a
``manifest.json`` listing each leaf's index, name, dtype and shape. The
names are the reference's ``jax.tree_util.keystr`` strings of nested
dict keys (``['params']['embed']['embed']``), leaves numbered in sorted
key order as JAX flattens dicts; bf16 leaves are stored as fp32 with
``"dtype": "bfloat16"`` (``np.save`` has no bf16). So a checkpoint
written by either package loads in the other.

Guarantees, as in the reference: atomic (written to ``<dir>.tmp``,
fsynced, then renamed, so a crash never leaves a half checkpoint under
the final name); asynchronous (the device-to-host copy is synchronous,
the file IO runs on a background thread); the last ``keep`` kept.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Mapping, Optional

import numpy as np
import torch


def _flatten_with_names(tree: Any):
    """(names, leaves) of a tree of nested dicts, keys sorted."""
    names, leaves = [], []

    def walk(node, path):
        if isinstance(node, Mapping):
            for k in sorted(node):
                walk(node[k], path + (k,))
        else:
            names.append("".join(f"[{k!r}]" for k in path))
            leaves.append(node)
    walk(tree, ())
    return names, leaves


def _unflatten_like(tree: Any, leaves):
    it = iter(leaves)

    def walk(node):
        if isinstance(node, Mapping):
            return {k: walk(node[k]) for k in sorted(node)}
        return next(it)
    return walk(tree)


def _to_host(leaf):
    """A snapshot of ``leaf`` on the host that later updates cannot
    change: CPU tensors and numpy arrays are copied."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        return leaf.cpu() if leaf.device.type != "cpu" else leaf.clone()
    return np.array(leaf)


def _as_numpy(leaf):
    """(array, dtype name) of a leaf on the host; bf16 widened to fp32."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        dtype = str(leaf.dtype).replace("torch.", "")
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.numpy(), dtype
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save_pytree(tree: Any, path: str) -> None:
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    names, leaves = _flatten_with_names(tree)
    manifest = []
    for i, (name, leaf) in enumerate(zip(names, leaves)):
        arr, dtype = _as_numpy(leaf)
        np.save(os.path.join(tmp, f"leaf_{i}.npy"), arr)
        manifest.append({"i": i, "name": name, "dtype": dtype,
                         "shape": list(arr.shape)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)


def load_pytree(path: str, like: Any) -> Any:
    """Load into the structure of ``like``: a tensor leaf of ``like``
    gives a tensor of its dtype on its device (on the CPU for a meta
    tensor), any other leaf a numpy array as stored."""
    with open(os.path.join(path, "manifest.json")) as f:
        by_name = {m["name"]: m for m in json.load(f)}
    names, leaves = _flatten_with_names(like)
    out = []
    for name, leaf in zip(names, leaves):
        if name not in by_name:
            raise KeyError(f"{path}: no leaf {name}")
        arr = np.load(os.path.join(path, f"leaf_{by_name[name]['i']}.npy"))
        if isinstance(leaf, torch.Tensor):
            dev = "cpu" if leaf.device.type == "meta" else leaf.device
            arr = torch.from_numpy(arr).to(device=dev, dtype=leaf.dtype)
        out.append(arr)
    return _unflatten_like(like, out)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._inflight: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        os.makedirs(directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:09d}")

    def steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def wait(self):
        """Wait for the save in flight; raise its error, if it failed."""
        if self._inflight is not None:
            self._inflight.join()
            self._inflight = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint save failed") from err

    def save(self, step: int, tree: Any) -> None:
        self.wait()
        # snapshot to host synchronously (consistent view), IO async
        names, leaves = _flatten_with_names(tree)
        host_tree = _unflatten_like(tree, [_to_host(x) for x in leaves])

        def _do():
            try:
                save_pytree(host_tree, self._step_dir(step))
                self._gc()
            except Exception as e:       # raised again by wait()
                self._error = e

        if self.async_save:
            self._inflight = threading.Thread(target=_do, daemon=True)
            self._inflight.start()
        else:
            _do()
            self.wait()

    def restore(self, like: Any, step: Optional[int] = None) -> Any:
        step = self.latest() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        return load_pytree(self._step_dir(step), like), step

    def _gc(self):
        for s in self.steps()[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
