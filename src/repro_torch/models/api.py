"""Unified model API for every family (dense, MLA / MoE and VLM decoders,
the Mamba-2 stack, the hybrid and the encoder-decoder), the counterpart
of ``repro.models.api``:

    model = Model(cfg)
    params = model.init(seed, device="cuda", trainable=True)
    loss, metrics = model.loss(params, batch)          # train
    logits, cache, fill = model.prefill(params, batch)  # inference prefill
    cache = model.init_cache(batch_size, seq_len)
    logits, cache = model.decode(params, tokens, cache, fill)

Work runs on the device the parameters and tokens are on; every family
serves and trains. ``cfg.encoder_decoder`` dispatches to ``encdec``,
everything else to ``transformer``, as the reference does; the decode
signature is the same for both.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from .common import ArchConfig, check_ported
from . import encdec, transformer


class Model:
    def __init__(self, cfg: ArchConfig):
        check_ported(cfg)
        self.cfg = cfg
        self._mod = encdec if cfg.encoder_decoder else transformer

    # -- parameters ----------------------------------------------------
    def init(self, seed: int = 0, device="cuda", trainable: bool = False):
        return self._mod.init_params(self.cfg, seed, device, trainable)

    # -- training ------------------------------------------------------
    def loss(self, params, batch: Dict[str, Any]):
        return self._mod.loss_fn(self.cfg, params, batch)

    # -- inference -----------------------------------------------------
    def init_cache(self, batch: int, seq: int, dtype=torch.bfloat16,
                   device="cuda"):
        return self._mod.init_cache(self.cfg, batch, seq, dtype, device)

    def prefill(self, params, batch: Dict[str, Any],
                cache_len: int | None = None):
        return self._mod.prefill(self.cfg, params, batch, cache_len)

    def decode(self, params, tokens, cache, fill: int,
               absorbed_mla: bool = False):
        return self._mod.decode_step(self.cfg, params, tokens, cache, fill,
                                     absorbed_mla=absorbed_mla)
