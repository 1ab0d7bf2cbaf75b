"""Unified model API (dense decoders), the counterpart of
``repro.models.api``:

    model = Model(cfg)
    params = model.init(seed, device="cuda")
    logits, cache, fill = model.prefill(params, batch)  # inference prefill
    cache = model.init_cache(batch_size, seq_len)
    logits, cache = model.decode(params, tokens, cache, fill)

Work runs on the device the parameters and tokens are on.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from .common import ArchConfig, check_dense
from . import transformer


class Model:
    def __init__(self, cfg: ArchConfig):
        check_dense(cfg)
        self.cfg = cfg

    # -- parameters ----------------------------------------------------
    def init(self, seed: int = 0, device="cuda") -> transformer.Transformer:
        return transformer.init_params(self.cfg, seed, device)

    # -- inference -----------------------------------------------------
    def init_cache(self, batch: int, seq: int, dtype=torch.bfloat16,
                   device="cuda"):
        return transformer.init_cache(self.cfg, batch, seq, dtype, device)

    def prefill(self, params, batch: Dict[str, Any],
                cache_len: int | None = None):
        return transformer.prefill(self.cfg, params, batch, cache_len)

    def decode(self, params, tokens, cache, fill: int):
        return transformer.decode_step(self.cfg, params, tokens, cache, fill)
