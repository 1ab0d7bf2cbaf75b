"""The decoder-only LM of the ported families: parameters, the training
loss, and (dense only) prefill and KV-cache decode.

Counterpart of ``repro.models.transformer`` for two layer kinds:
``attn_mlp`` (dense GQA with an MLP) and ``ssm_none`` (a Mamba-2 mixer
alone). The reference scans over layer stacks stored per kind; here the
layers are a Python loop over per-layer modules, each wrapped by
``remat_wrap``. The KV cache is a list of per-layer bf16 ``{"k", "v"}``
tensors (bf16 whatever the compute dtype, as the reference keeps it),
filled in place.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
from torch import nn

from .common import (ArchConfig, Embed, MLP, Norm, apply_mlp, apply_norm,
                     check_ported, chunked_xent, embed_params, embed_tokens,
                     mlp_params, norm_params, remat_wrap, unembed)
from . import attention as attn
from . import ssm as ssm_mod

Cache = List[Dict[str, torch.Tensor]]


# ----------------------------------------------------------------------
# Layer schedule
# ----------------------------------------------------------------------
def _kind_of(cfg: ArchConfig, i: int) -> str:
    mixer = "attn" if cfg.is_attn_layer(i) else "ssm"
    if cfg.is_moe_layer(i):
        ffn = "moe"
    elif cfg.d_ff:
        ffn = "mlp"
    else:
        ffn = "none"
    return f"{mixer}_{ffn}"


def layer_schedule(cfg: ArchConfig):
    """Returns (sched, kinds, idx_in_kind): per-layer kind name, the ordered
    unique kinds, and each layer's index within its kind's stack."""
    sched = [_kind_of(cfg, i) for i in range(cfg.n_layers)]
    kinds = list(dict.fromkeys(sched))
    counters = {k: 0 for k in kinds}
    idx_in_kind: List[int] = []
    for k in sched:
        idx_in_kind.append(counters[k])
        counters[k] += 1
    return sched, kinds, idx_in_kind


class Block(nn.Module):
    """One layer: norm1 and the mixer (GQA or Mamba-2), then, for kinds
    with an FFN (``attn_mlp``), norm2 and the MLP. An ``ssm_none`` layer
    has no norm2 or ffn (both None)."""

    def __init__(self, norm1: Norm, mixer: nn.Module,
                 norm2: Optional[Norm] = None, ffn: Optional[MLP] = None):
        super().__init__()
        self.norm1, self.mixer, self.norm2, self.ffn = norm1, mixer, norm2, ffn


class Transformer(nn.Module):
    """The parameters: embeddings, the layer list and the final norm."""

    def __init__(self, embed: Embed, layers: List[Block], final_norm: Norm):
        super().__init__()
        self.embed = embed
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm


def init_params(cfg: ArchConfig, seed: int = 0, device="cuda",
                trainable: bool = False) -> Transformer:
    """Random weights from the reference's distributions, drawn with a
    ``torch.Generator`` on ``device`` (not the reference's numbers: use
    ``convert.from_reference`` for those). ``trainable`` turns on
    ``requires_grad`` for every parameter."""
    check_ported(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    embed = embed_params(cfg, gen)
    layers = []
    for kind in layer_schedule(cfg)[0]:
        norm1 = norm_params(cfg, cfg.d_model, device)
        if kind == "ssm_none":
            layers.append(Block(norm1, ssm_mod.ssm_params(cfg, gen)))
        else:
            layers.append(Block(norm1, attn.gqa_params(cfg, gen),
                                norm_params(cfg, cfg.d_model, device),
                                mlp_params(cfg, gen, cfg.d_model, cfg.d_ff)))
    params = Transformer(embed, layers, norm_params(cfg, cfg.d_model, device))
    return params.requires_grad_(trainable)


def _require_dense(cfg: ArchConfig, what: str) -> None:
    if cfg.ssm:
        raise NotImplementedError(
            f"{what} for the ssm family comes with SSM serving (ROADMAP "
            f"queue 1, item 14)")


# ----------------------------------------------------------------------
# Forward (training)
# ----------------------------------------------------------------------
def _apply_layer(cfg: ArchConfig, layer: Block, x: torch.Tensor, pos):
    h = apply_norm(cfg, layer.norm1, x)
    if isinstance(layer.mixer, ssm_mod.SSM):
        o = ssm_mod.ssm_forward(cfg, layer.mixer, h)
    else:
        o, _ = attn.gqa_forward(cfg, layer.mixer, h, pos)
    x = x + o
    if layer.ffn is None:
        return x
    h = apply_norm(cfg, layer.norm2, x)
    # residual add fused into the MLP's second-GEMM store epilogue
    return apply_mlp(cfg, layer.ffn, h, residual=x)


def backbone(cfg: ArchConfig, params: Transformer, x: torch.Tensor, pos):
    """Embedded inputs -> (final hidden states, MoE aux loss). A loop over
    the layers, each wrapped by ``remat_wrap`` (the reference's remat
    around its scan body); the aux loss is 0 without MoE layers."""
    for layer in params.layers:
        x = remat_wrap(cfg, lambda xx, ll=layer: _apply_layer(
            cfg, ll, xx, pos))(x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return apply_norm(cfg, params.final_norm, x), aux


def embed_inputs(cfg: ArchConfig, params: Transformer,
                 batch: Dict[str, Any]) -> torch.Tensor:
    return embed_tokens(cfg, params.embed, batch["tokens"])


def loss_fn(cfg: ArchConfig, params: Transformer, batch: Dict[str, Any]):
    """Mean next-token cross-entropy (+ 0.01 x MoE aux). Returns
    ``(total, {"xent", "moe_aux"})``."""
    x = embed_inputs(cfg, params, batch)
    pos = positions(cfg, batch)
    h, aux = backbone(cfg, params, x, pos)
    loss = chunked_xent(cfg, params.embed, h, batch["labels"],
                        batch.get("loss_mask"))
    total = loss + 0.01 * aux
    return total, {"xent": loss, "moe_aux": aux}


def init_cache(cfg: ArchConfig, batch: int, seq: int,
               dtype=torch.bfloat16, device="cuda") -> Cache:
    _require_dense(cfg, "the decode cache")
    return [attn.gqa_init_cache(cfg, batch, seq, dtype, device)
            for _ in range(cfg.n_layers)]


def positions(cfg: ArchConfig, batch: Dict[str, Any]) -> torch.Tensor:
    b, s = batch["tokens"].shape
    return torch.arange(s, device=batch["tokens"].device)[None].expand(b, s)


def decode_step(cfg: ArchConfig, params: Transformer, tokens: torch.Tensor,
                cache: Cache, fill: int):
    """tokens: (b, s_new) -> (logits (b, s_new, vocab), cache). The new
    keys/values are written into ``cache`` in place at ``fill``."""
    _require_dense(cfg, "decode")
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
    _require_dense(cfg, "prefill")
    tokens = batch["tokens"]
    b, s = tokens.shape
    cache_len = cache_len or s
    x = embed_tokens(cfg, params.embed, tokens)
    pos = positions(cfg, batch)
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
