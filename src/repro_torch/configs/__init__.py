"""Architecture registry: ``get(name)`` -> ArchConfig; ``ARCHS`` lists the
reference's ten configurations, all of which this package runs: the
dense GQA decoders (llama3-8b, yi-9b, phi3-medium-14b, granite-3-8b),
the MoE decoders deepseek-v2-lite-16b (MLA) and phi3.5-moe-42b (GQA),
the encoder-decoder whisper-medium, the VLM qwen2-vl-2b (M-RoPE and the
patch stub) and the Mamba-2 stack mamba2-1.3b, which serve and train,
and the hybrid jamba-v0.1-52b, which serves (training it at full width
needs more than one card: ROADMAP slice G). Every module exports
``CONFIG`` and ``reduced()``, as the reference's do. ``shapes.py``
defines the assigned input-shape set and ``input_specs()``.
"""
from __future__ import annotations

import importlib

ARCHS = ["llama3_8b", "yi_9b", "phi3_medium_14b", "granite_3_8b",
         "mamba2_13b", "deepseek_v2_lite_16b", "phi35_moe_42b",
         "jamba_v01_52b", "whisper_medium", "qwen2_vl_2b"]

_ALIASES = {"llama3-8b": "llama3_8b", "yi-9b": "yi_9b",
            "phi3-medium-14b": "phi3_medium_14b",
            "granite-3-8b": "granite_3_8b", "mamba2-1.3b": "mamba2_13b",
            "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
            "phi3.5-moe-42b-a6.6b": "phi35_moe_42b",
            "phi3.5-moe-42b": "phi35_moe_42b",
            "jamba-v0.1-52b": "jamba_v01_52b",
            "whisper-medium": "whisper_medium", "qwen2-vl-2b": "qwen2_vl_2b"}


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


from .shapes import SHAPES, input_specs, shape_applicable  # noqa: E402

__all__ = ["ARCHS", "get", "get_reduced", "SHAPES", "input_specs",
           "shape_applicable"]
