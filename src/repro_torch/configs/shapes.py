"""The assigned input shapes and their meta-tensor stand-ins for the dry
run; the counterpart of ``repro.configs.shapes``.

Shapes (the reference's four, as they are):
  train_4k     seq_len=4096   global_batch=256   (training: the train step)
  prefill_32k  seq_len=32768  global_batch=32    (inference prefill)
  decode_32k   seq_len=32768  global_batch=128   (decode: one new token
                                                  against a 32k cache)
  long_500k    seq_len=524288 global_batch=1     (long-context decode;
                                                  SSM/hybrid archs only)

Where the reference describes an input with a ``jax.ShapeDtypeStruct``,
this module makes an empty tensor on the meta device: the shape and dtype
with no storage. ``input_specs(cfg, shape)`` returns them for one cell;
decode cells carry the cache (``Model.init_cache`` on the meta device)
and ``fill``, which the port's decode takes as an int: the new token goes
into the cache's last slot.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.models import ArchConfig, Model


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: str) -> tuple[bool, str]:
    """(applicable?, reason-if-not), the reference's reasons word for
    word."""
    if shape == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, ("long_500k requires sub-quadratic attention; "
                       f"{cfg.name} is pure full-attention (assignment: "
                       "run for SSM/hybrid only)")
    return True, ""


def _spec(shape, dtype, device):
    return torch.empty(shape, dtype=dtype, device=device)


def batch_specs(cfg: ArchConfig, b: int, s: int,
                device="meta") -> Dict[str, Any]:
    """A training or prefill batch of one arch, in the reference's dtypes."""
    specs = {"tokens": _spec((b, s), torch.int32, device),
             "labels": _spec((b, s), torch.int32, device)}
    if cfg.encoder_decoder:
        specs["enc_embeds"] = _spec((b, cfg.enc_seq, cfg.d_model),
                                    torch.bfloat16, device)
    if cfg.n_patches:
        specs["img_embeds"] = _spec((b, cfg.n_patches, cfg.d_model),
                                    torch.bfloat16, device)
        specs["loss_mask"] = _spec((b, s), torch.float32, device)
    if cfg.mrope:
        specs["pos3"] = _spec((3, b, s), torch.int32, device)
    return specs


def cache_specs(cfg: ArchConfig, b: int, s: int, device="meta"):
    """The decode cache of ``s`` slots: the port's per-layer list."""
    return Model(cfg).init_cache(b, s, torch.bfloat16, device=device)


def input_specs(cfg: ArchConfig, shape_name: str,
                device="meta") -> Dict[str, Any]:
    """All inputs (minus params) of the step function of this cell."""
    sh = SHAPES[shape_name]
    b, s = sh.global_batch, sh.seq_len
    if sh.kind in ("train", "prefill"):
        return {"batch": batch_specs(cfg, b, s, device)}
    # decode: one new token against a cache of seq_len
    return {"tokens": _spec((b, 1), torch.int32, device),
            "cache": cache_specs(cfg, b, s, device),
            "fill": s - 1}


def param_specs(cfg: ArchConfig):
    """The parameters on the meta device (``Model.init``)."""
    return Model(cfg).init(0, device="meta")


def count_params(cfg: ArchConfig) -> int:
    return sum(p.numel() for p in param_specs(cfg).parameters())


def active_params(cfg: ArchConfig) -> int:
    """Active parameters per token (MoE: top_k + shared experts only)."""
    total = count_params(cfg)
    if not cfg.moe:
        return total
    # subtract inactive routed-expert parameters
    e, k = cfg.n_experts, cfg.top_k
    expert_p = 3 * cfg.d_model * cfg.d_ff_expert
    n_moe_layers = sum(1 for i in range(cfg.n_layers) if cfg.is_moe_layer(i))
    inactive = n_moe_layers * (e - k) * expert_p
    return total - inactive
