"""Architecture registry: ``get(name)`` -> ArchConfig; ``ARCHS`` lists the
configurations this package runs: the dense GQA decoders (llama3-8b,
yi-9b, phi3-medium-14b, granite-3-8b), the MoE decoders
deepseek-v2-lite-16b (MLA) and phi3.5-moe-42b (GQA) and the Mamba-2 stack
mamba2-1.3b, which serve and train, and the hybrid jamba-v0.1-52b, which
serves (training it at full width needs more than one card: ROADMAP
slice G). The rest of the reference's registry (enc-dec, VLM) comes with
ROADMAP queue 1's slice D.
"""
from __future__ import annotations

import importlib

ARCHS = ["llama3_8b", "yi_9b", "phi3_medium_14b", "granite_3_8b",
         "mamba2_13b", "deepseek_v2_lite_16b", "phi35_moe_42b",
         "jamba_v01_52b"]

_ALIASES = {"llama3-8b": "llama3_8b", "yi-9b": "yi_9b",
            "phi3-medium-14b": "phi3_medium_14b",
            "granite-3-8b": "granite_3_8b", "mamba2-1.3b": "mamba2_13b",
            "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
            "phi3.5-moe-42b-a6.6b": "phi35_moe_42b",
            "phi3.5-moe-42b": "phi35_moe_42b",
            "jamba-v0.1-52b": "jamba_v01_52b"}


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
