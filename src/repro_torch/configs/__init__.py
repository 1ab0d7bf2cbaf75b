"""Architecture registry: ``get(name)`` -> ArchConfig; ``ARCHS`` lists the
configurations this package runs (llama3-8b serves, mamba2-1.3b trains;
the rest of the reference's registry comes with ROADMAP slice D).
"""
from __future__ import annotations

import importlib

ARCHS = ["llama3_8b", "mamba2_13b"]

_ALIASES = {"llama3-8b": "llama3_8b", "mamba2-1.3b": "mamba2_13b"}


def _module(name: str):
    mod = _ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    if mod not in ARCHS:
        raise KeyError(f"{name!r} is not ported yet; this package runs "
                       f"{ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get(name: str):
    return _module(name).CONFIG


def get_reduced(name: str):
    return _module(name).reduced()


__all__ = ["ARCHS", "get", "get_reduced"]
