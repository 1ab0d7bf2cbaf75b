"""The dense decoder-only LM (the ``attn_mlp`` layer kind): parameters,
prefill and KV-cache decode.

Counterpart of ``repro.models.transformer`` for dense GQA models. The
reference scans over layer stacks; here the layers are a Python loop
over per-layer modules. The KV cache is a list of per-layer bf16
``{"k", "v"}`` tensors (bf16 whatever the compute dtype, as the
reference keeps it), filled in place.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
from torch import nn

from .common import (ArchConfig, Embed, MLP, Norm, apply_mlp, apply_norm,
                     check_dense, embed_params, embed_tokens, mlp_params,
                     norm_params, unembed)
from . import attention as attn

Cache = List[Dict[str, torch.Tensor]]


class Block(nn.Module):
    """One ``attn_mlp`` layer: norm1, GQA mixer, norm2, MLP."""

    def __init__(self, norm1: Norm, mixer: attn.GQA, norm2: Norm, ffn: MLP):
        super().__init__()
        self.norm1, self.mixer, self.norm2, self.ffn = norm1, mixer, norm2, ffn


class Transformer(nn.Module):
    """The parameters: embeddings, the layer list and the final norm."""

    def __init__(self, embed: Embed, layers: List[Block], final_norm: Norm):
        super().__init__()
        self.embed = embed
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm


def init_params(cfg: ArchConfig, seed: int = 0,
                device="cuda") -> Transformer:
    """Random weights from the reference's distributions, drawn with a
    ``torch.Generator`` on ``device`` (not the reference's numbers: use
    ``convert.from_reference`` for those)."""
    check_dense(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    embed = embed_params(cfg, gen)
    layers = []
    for _ in range(cfg.n_layers):
        layers.append(Block(norm_params(cfg, cfg.d_model, device),
                            attn.gqa_params(cfg, gen),
                            norm_params(cfg, cfg.d_model, device),
                            mlp_params(cfg, gen, cfg.d_model, cfg.d_ff)))
    return Transformer(embed, layers, norm_params(cfg, cfg.d_model, device))


def init_cache(cfg: ArchConfig, batch: int, seq: int,
               dtype=torch.bfloat16, device="cuda") -> Cache:
    return [attn.gqa_init_cache(cfg, batch, seq, dtype, device)
            for _ in range(cfg.n_layers)]


def positions(batch: Dict[str, Any]) -> torch.Tensor:
    b, s = batch["tokens"].shape
    return torch.arange(s, device=batch["tokens"].device)[None].expand(b, s)


def decode_step(cfg: ArchConfig, params: Transformer, tokens: torch.Tensor,
                cache: Cache, fill: int):
    """tokens: (b, s_new) -> (logits (b, s_new, vocab), cache). The new
    keys/values are written into ``cache`` in place at ``fill``."""
    b, s = tokens.shape
    x = embed_tokens(cfg, params.embed, tokens)
    pos = (fill + torch.arange(s, device=tokens.device))[None].expand(b, s)
    for layer, c in zip(params.layers, cache):
        h = apply_norm(cfg, layer.norm1, x)
        o, _ = attn.gqa_decode(cfg, layer.mixer, h, pos, c, fill)
        x = x + o
        h = apply_norm(cfg, layer.norm2, x)
        x = apply_mlp(cfg, layer.ffn, h, residual=x)
    h = apply_norm(cfg, params.final_norm, x)
    return unembed(cfg, params.embed, h), cache


def prefill(cfg: ArchConfig, params: Transformer, batch: Dict[str, Any],
            cache_len: Optional[int] = None):
    """Full-sequence forward that also fills a new cache of ``cache_len``
    slots. Returns (last-position logits, cache, fill)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    cache_len = cache_len or s
    x = embed_tokens(cfg, params.embed, tokens)
    pos = positions(batch)
    cache = init_cache(cfg, b, cache_len, torch.bfloat16, tokens.device)
    for layer, c in zip(params.layers, cache):
        h = apply_norm(cfg, layer.norm1, x)
        o, (k, v) = attn.gqa_forward(cfg, layer.mixer, h, pos)
        c["k"][:, :, :s] = k.to(torch.bfloat16)
        c["v"][:, :, :s] = v.to(torch.bfloat16)
        x = x + o
        h = apply_norm(cfg, layer.norm2, x)
        x = apply_mlp(cfg, layer.ffn, h, residual=x)
    h = apply_norm(cfg, params.final_norm, x)
    logits = unembed(cfg, params.embed, h[:, -1:])
    return logits[:, 0], cache, s
