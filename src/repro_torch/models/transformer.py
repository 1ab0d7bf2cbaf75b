"""The decoder-only LM of the ported families: parameters, the training
loss, prefill and cache decode.

Counterpart of ``repro.models.transformer`` for its five decoder layer
kinds, a mixer and an FFN: ``attn_mlp`` (GQA with an MLP), ``attn_moe``
(MLA or GQA with the MoE FFN; deepseek-v2, phi3.5-moe), ``ssm_none`` (a
Mamba-2 mixer alone; mamba2), and jamba's ``ssm_mlp`` and ``ssm_moe``,
which it interleaves with ``attn_mlp`` on a period of 8. The reference
scans over layer stacks stored per kind; here the layers are a Python
loop over per-layer modules, each wrapped by ``remat_wrap``. The cache is
a list of per-layer dicts filled in place: bf16 ``{"k", "v"}`` for GQA,
the latent ``{"c_kv", "k_rope"}`` for MLA (bf16 whatever the compute
dtype, as the reference keeps them), and for a Mamba-2 layer the fp32
state ``{"s"}`` beside the bf16 conv tails ``{"cx", "cb", "cc"}``, which
have no sequence axis. The VLM (qwen2-vl) adds the patch stub (the first
``n_patches`` positions take precomputed ``img_embeds`` through
``img_proj``) and M-RoPE's (3, b, s) positions ``pos3``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch
from torch import nn

from .common import (ArchConfig, Embed, Norm, _param, apply_mlp, apply_norm,
                     cache_write, check_ported, chunked_xent, data_share,
                     embed_params, rank_ranges,
                     embed_tokens, make_generator, mlp_params, norm_params,
                     remat_wrap, sp_constrain, unembed)
from . import attention as attn
from . import moe as moe_mod
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


def period_len(cfg: ArchConfig) -> int:
    """Shortest period of the layer-kind pattern (the dry run's delta
    method)."""
    p = 1
    if cfg.attn_period:
        p = cfg.attn_period
    if cfg.moe and cfg.moe_every > 1:
        p = math.lcm(p, cfg.moe_every)
    return p


def n_periods(cfg: ArchConfig) -> int:
    p = period_len(cfg)
    if cfg.n_layers % p:
        raise ValueError(f"{cfg.n_layers} layers are not whole periods of "
                         f"{p}")
    return cfg.n_layers // p


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
    """One layer: norm1 and the mixer (GQA, MLA or Mamba-2), then, for
    kinds with an FFN (``*_mlp``, ``*_moe``), norm2 and the MLP or the
    MoE. A ``ssm_none`` layer has no norm2 or ffn (both None)."""

    def __init__(self, norm1: Norm, mixer: nn.Module,
                 norm2: Optional[Norm] = None,
                 ffn: Optional[nn.Module] = None):
        super().__init__()
        self.norm1, self.mixer, self.norm2, self.ffn = norm1, mixer, norm2, ffn


class Transformer(nn.Module):
    """The parameters: embeddings, the layer list, the final norm and,
    with the patch stub (``cfg.n_patches``), the (d, d) ``img_proj``."""

    def __init__(self, embed: Embed, layers: List[Block], final_norm: Norm,
                 img_proj: Optional[torch.Tensor] = None):
        super().__init__()
        self.embed = embed
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm
        self.img_proj = _param(img_proj) if img_proj is not None else None


def init_params(cfg: ArchConfig, seed: int = 0, device="cuda",
                trainable: bool = False) -> Transformer:
    """Random weights from the reference's distributions, drawn with a
    ``torch.Generator`` on ``device`` (not the reference's numbers: use
    ``convert.from_reference`` for those). ``trainable`` turns on
    ``requires_grad`` for every parameter."""
    check_ported(cfg)
    gen = make_generator(device, seed)
    embed = embed_params(cfg, gen)
    layers = []
    for kind in layer_schedule(cfg)[0]:
        mixer_kind, ffn_kind = kind.split("_")
        norm1 = norm_params(cfg, cfg.d_model, device)
        if mixer_kind == "ssm":
            mixer = ssm_mod.ssm_params(cfg, gen)
        else:
            mixer = (attn.mla_params(cfg, gen) if cfg.mla
                     else attn.gqa_params(cfg, gen))
        if ffn_kind == "none":
            layers.append(Block(norm1, mixer))
            continue
        ffn = (moe_mod.moe_params(cfg, gen) if ffn_kind == "moe"
               else mlp_params(cfg, gen, cfg.d_model, cfg.d_ff))
        layers.append(Block(norm1, mixer,
                            norm_params(cfg, cfg.d_model, device), ffn))
    img_proj = (torch.eye(cfg.d_model, dtype=cfg.pdtype, device=device)
                if cfg.n_patches else None)
    params = Transformer(embed, layers, norm_params(cfg, cfg.d_model, device),
                         img_proj)
    return params.requires_grad_(trainable)


# ----------------------------------------------------------------------
# Forward (training)
# ----------------------------------------------------------------------
def _mixer_forward(cfg: ArchConfig, mixer: nn.Module, h: torch.Tensor, pos):
    """A full-sequence attention mixer: (out, cache entries)."""
    if isinstance(mixer, attn.MLA):
        return attn.mla_forward(cfg, mixer, h, pos)
    return attn.gqa_forward(cfg, mixer, h, pos)


def _apply_ffn(cfg: ArchConfig, layer: Block, x: torch.Tensor, aux):
    """norm2 and the FFN with its residual, if the layer has one: (x, aux
    + the MoE aux loss; aux None counts from the first MoE layer's)."""
    if layer.ffn is None:
        return x, aux
    h = apply_norm(cfg, layer.norm2, x)
    if isinstance(layer.ffn, moe_mod.MoE):
        o, a = moe_mod.apply_moe(cfg, layer.ffn, h)
        return x + o, a if aux is None else aux + a
    # residual add fused into the MLP's second-GEMM store epilogue
    return apply_mlp(cfg, layer.ffn, h, residual=x), aux


def _apply_layer(cfg: ArchConfig, layer: Block, x: torch.Tensor, pos, aux):
    h = apply_norm(cfg, layer.norm1, x)
    if isinstance(layer.mixer, ssm_mod.SSM):
        o = ssm_mod.ssm_forward(cfg, layer.mixer, h)
    else:
        o, _ = _mixer_forward(cfg, layer.mixer, h, pos)
    return _apply_ffn(cfg, layer, x + o, aux)


def backbone(cfg: ArchConfig, params: Transformer, x: torch.Tensor, pos):
    """Embedded inputs -> (final hidden states, MoE aux loss). A loop over
    the layers, each wrapped by ``remat_wrap`` (the reference's remat
    around its scan body); the aux loss, fp32, sums the MoE layers' (0
    without them). On a mesh with the sequence-parallel residual the
    layers carry this rank's block of the sequence (``sp_constrain``)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.sp_residual:
        x = sp_constrain(x)
    for layer in params.layers:
        x, aux = remat_wrap(cfg, lambda xx, aa, ll=layer: _apply_layer(
            cfg, ll, xx, pos, aa))(x, aux)
    return apply_norm(cfg, params.final_norm, x), aux


def embed_inputs(cfg: ArchConfig, params: Transformer,
                 batch: Dict[str, Any]) -> torch.Tensor:
    """Token embeddings; with the patch stub the first ``n_patches``
    positions are ``batch["img_embeds"] @ img_proj`` instead."""
    x = embed_tokens(cfg, params.embed, batch["tokens"])
    if cfg.n_patches:
        dt = cfg.cdtype
        img = batch["img_embeds"].to(dt) @ params.img_proj.to(dt)
        x = torch.cat([img, x[:, cfg.n_patches:]], 1)
    return x


def loss_fn(cfg: ArchConfig, params: Transformer, batch: Dict[str, Any]):
    """Mean next-token cross-entropy (+ 0.01 x MoE aux). Returns
    ``(total, {"xent", "moe_aux"})``; on a mesh, this data rank's share
    of the global mean."""
    x = embed_inputs(cfg, params, batch)
    pos = positions(cfg, batch)
    h, aux = backbone(cfg, params, x, pos)
    loss = chunked_xent(cfg, params.embed, h, batch["labels"],
                        batch.get("loss_mask"))
    total = loss + 0.01 * data_share(aux)
    return total, {"xent": loss, "moe_aux": aux}


def init_cache(cfg: ArchConfig, batch: int, seq: int,
               dtype=torch.bfloat16, device="cuda") -> Cache:
    """Each layer's empty cache by its mixer, as the reference's
    ``_kind_cache`` builds them (``seq`` slots for attention; a Mamba-2
    layer's state and conv tails have no sequence axis)."""
    def one(kind: str):
        if kind.startswith("ssm"):
            return ssm_mod.ssm_init_cache(cfg, batch, dtype, device)
        make = attn.mla_init_cache if cfg.mla else attn.gqa_init_cache
        return make(cfg, batch, seq, dtype, device)
    return [one(kind) for kind in layer_schedule(cfg)[0]]


def positions(cfg: ArchConfig, batch: Dict[str, Any]) -> torch.Tensor:
    """(b, s) positions; with M-RoPE ``batch["pos3"]`` (3, b, s), or
    ``arange(s)`` in all three streams."""
    b, s = batch["tokens"].shape
    pos = torch.arange(s, device=batch["tokens"].device)[None].expand(b, s)
    if cfg.mrope:
        return batch["pos3"] if "pos3" in batch else pos[None].expand(3, b, s)
    return pos


def decode_step(cfg: ArchConfig, params: Transformer, tokens: torch.Tensor,
                cache: Cache, fill: int, absorbed_mla: bool = False):
    """tokens: (b, s_new) -> (logits (b, s_new, vocab), cache). The new
    cache entries are written into ``cache`` in place at ``fill``. A model
    with a Mamba-2 layer takes one token a step (s_new 1) and raises
    ValueError on more. ``absorbed_mla``: MLA
    layers attend in the latent space instead of expanding the cache (the
    reference's default is the expanded form)."""
    b, s = tokens.shape
    if s != 1 and any(isinstance(layer.mixer, ssm_mod.SSM)
                      for layer in params.layers):
        raise ValueError(f"a Mamba-2 layer decodes one token a step; got "
                         f"tokens of shape {tuple(tokens.shape)}")
    x = embed_tokens(cfg, params.embed, tokens)
    pos = (fill + torch.arange(s, device=tokens.device))[None].expand(b, s)
    if cfg.mrope:
        pos = pos[None].expand(3, b, s)
    aux = None
    for layer, c in zip(params.layers, cache):
        h = apply_norm(cfg, layer.norm1, x)
        if isinstance(layer.mixer, ssm_mod.SSM):
            o, _ = ssm_mod.ssm_decode(cfg, layer.mixer, h, c)
        elif isinstance(layer.mixer, attn.MLA):
            o, _ = attn.mla_decode(cfg, layer.mixer, h, pos, c, fill,
                                   absorbed=absorbed_mla)
        else:
            o, _ = attn.gqa_decode(cfg, layer.mixer, h, pos, c, fill)
        x, aux = _apply_ffn(cfg, layer, x + o, aux)
    h = apply_norm(cfg, params.final_norm, x)
    return unembed(cfg, params.embed, h), cache


def _write_cache(cfg: ArchConfig, c: Dict[str, torch.Tensor],
                 entries) -> None:
    """A prefilled layer's cache entries, in the cache's dtypes: into the
    first s slots (k, v) (b, hkv, s, hd) for GQA, (c_kv (b, s, r), k_rope
    (b, 1, s, dr)) for MLA, in bf16; a Mamba-2 layer's dict as a whole,
    the state staying fp32 and the conv tails cast to bf16. On a mesh
    each rank writes its block of each leaf as ``cache_specs`` places it
    (:func:`~.common.cache_write`): the entries are the rank's kv heads
    (GQA's head split), SSD heads and d_inner channels (the state, the x
    conv tail), or whole (MLA's latent, B and C's tails, the
    context-parallel k and v), and a part is exchanged where the leaf
    splits another dimension."""
    if "s" in c:
        nh, dh = cfg.ssm_heads, cfg.ssm_headdim
        cache_write(c["s"], entries["s"], part=(1, rank_ranges(nh)))
        cache_write(c["cx"], entries["cx"], part=(2, rank_ranges(nh, dh)))
        for name in ("cb", "cc"):
            cache_write(c[name], entries[name])
    elif "c_kv" in c:
        c_kv, k_rope = entries
        cache_write(c["c_kv"], c_kv, 1, 0)
        cache_write(c["k_rope"], k_rope, 2, 0)
    else:
        write_kv(cfg, c, "k", "v", entries)


def write_kv(cfg: ArchConfig, c: Dict[str, torch.Tensor], kname: str,
             vname: str, kv) -> None:
    """Prefilled GQA keys and values (b, heads, s, hd) into the cache's
    first s slots: the rank's kv heads (:func:`attention.gqa_heads`), or
    every head."""
    k, v = kv
    part = (None if k.shape[1] == cfg.n_kv_heads
            else (1, attn.gqa_head_ranges(cfg)))
    cache_write(c[kname], k, 2, 0, part=part)
    cache_write(c[vname], v, 2, 0, part=part)


def prefill(cfg: ArchConfig, params: Transformer, batch: Dict[str, Any],
            cache_len: Optional[int] = None, cache: Optional[Cache] = None):
    """Full-sequence forward that also fills a new cache of ``cache_len``
    slots. Returns (last-position logits, cache, fill). With
    ``cfg.prefill_microbatch`` mb > 1 dividing the batch, the requests are
    prefilled in mb sequential chunks and the caches joined along the
    batch, as the reference's chunked prefill does (each batch row is its
    own MoE routing group, so the chunks compute what one batch would;
    every cache leaf, a Mamba-2 state included, has the batch first).
    ``pos3`` (3, b, s) is split along its batch axis, 1. ``cache``: an
    empty cache to fill instead (the mesh's, its leaves DTensors under
    ``cache_specs``; in one piece)."""
    mb = max(1, cfg.prefill_microbatch)
    b = batch["tokens"].shape[0]
    if mb == 1 or b % mb or cache is not None:
        return _prefill_impl(cfg, params, batch, cache_len, cache)
    parts = [_prefill_impl(cfg, params, {
        k: v.chunk(mb, dim=1 if k == "pos3" else 0)[i]
        for k, v in batch.items()}, cache_len) for i in range(mb)]
    logits = torch.cat([p[0] for p in parts])
    cache = [{k: torch.cat([p[1][i][k] for p in parts]) for k in c}
             for i, c in enumerate(parts[0][1])]
    return logits, cache, parts[0][2]


def _prefill_impl(cfg: ArchConfig, params: Transformer,
                  batch: Dict[str, Any], cache_len: Optional[int] = None,
                  cache: Optional[Cache] = None):
    tokens = batch["tokens"]
    b, s = tokens.shape
    cache_len = cache_len or s
    x = embed_inputs(cfg, params, batch)
    pos = positions(cfg, batch)
    if cache is None:
        cache = init_cache(cfg, b, cache_len, torch.bfloat16, tokens.device)
    aux = None
    for layer, c in zip(params.layers, cache):
        h = apply_norm(cfg, layer.norm1, x)
        if isinstance(layer.mixer, ssm_mod.SSM):
            o, entries = ssm_mod.ssm_forward(cfg, layer.mixer, h,
                                             return_state=True)
        else:
            o, entries = _mixer_forward(cfg, layer.mixer, h, pos)
        _write_cache(cfg, c, entries)
        x, aux = _apply_ffn(cfg, layer, x + o, aux)
    h = apply_norm(cfg, params.final_norm, x)
    logits = unembed(cfg, params.embed, h[:, -1:])
    return logits[:, 0], cache, s
