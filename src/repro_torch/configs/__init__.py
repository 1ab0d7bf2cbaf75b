"""Architecture registry: ``get(name)`` -> ArchConfig; ``ARCHS`` lists the
configurations this package serves (the dense ones; the rest of the
reference's registry comes with ROADMAP slice D).
"""
from __future__ import annotations

import importlib

ARCHS = ["llama3_8b"]

_ALIASES = {"llama3-8b": "llama3_8b"}


def _module(name: str):
    mod = _ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    if mod not in ARCHS:
        raise KeyError(f"{name!r} is not ported yet; this package serves "
                       f"{ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get(name: str):
    return _module(name).CONFIG


def get_reduced(name: str):
    return _module(name).reduced()


__all__ = ["ARCHS", "get", "get_reduced"]
