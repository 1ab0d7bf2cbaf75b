"""Unified model API for the ported families (dense decoders, MLA / MoE
decoders, the Mamba-2 stack and the hybrid), the counterpart of
``repro.models.api``:

    model = Model(cfg)
    params = model.init(seed, device="cuda", trainable=True)
    loss, metrics = model.loss(params, batch)          # train
    logits, cache, fill = model.prefill(params, batch)  # inference prefill
    cache = model.init_cache(batch_size, seq_len)
    logits, cache = model.decode(params, tokens, cache, fill)

Work runs on the device the parameters and tokens are on; every family
serves and trains.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from .common import ArchConfig, check_ported
from . import transformer


class Model:
    def __init__(self, cfg: ArchConfig):
        check_ported(cfg)
        self.cfg = cfg

    # -- parameters ----------------------------------------------------
    def init(self, seed: int = 0, device="cuda",
             trainable: bool = False) -> transformer.Transformer:
        return transformer.init_params(self.cfg, seed, device, trainable)

    # -- training ------------------------------------------------------
    def loss(self, params, batch: Dict[str, Any]):
        return transformer.loss_fn(self.cfg, params, batch)

    # -- inference -----------------------------------------------------
    def init_cache(self, batch: int, seq: int, dtype=torch.bfloat16,
                   device="cuda"):
        return transformer.init_cache(self.cfg, batch, seq, dtype, device)

    def prefill(self, params, batch: Dict[str, Any],
                cache_len: int | None = None):
        return transformer.prefill(self.cfg, params, batch, cache_len)

    def decode(self, params, tokens, cache, fill: int,
               absorbed_mla: bool = False):
        return transformer.decode_step(self.cfg, params, tokens, cache, fill,
                                       absorbed_mla=absorbed_mla)
