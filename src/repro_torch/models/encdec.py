"""The encoder-decoder (whisper class): parameters, the training loss,
prefill and cache decode.

Counterpart of ``repro.models.encdec``, function for function. The audio
conv frontend is a stub, as in the reference: the inputs carry
precomputed frame embeddings ``enc_embeds`` (b, enc_seq, d_model). The
encoder adds fixed sinusoids and runs non-causal self-attention and GELU
MLPs under LayerNorm; each decoder layer runs causal self-attention, then
cross-attention on the encoder states, then the MLP, with sinusoids at
its absolute positions and no rotary embedding. The reference scans over
stacked layers; here the layers are Python loops over per-layer modules,
each wrapped by ``remat_wrap`` for training. The cache is a list of
per-decoder-layer dicts written in place: the self-attention's ``k``,
``v`` (b, hkv, cache_len, hd) and the cross-attention's ``ck``, ``cv``
(b, hkv, enc_seq, hd), all four stored in bf16 whatever the compute
dtype, as the reference stores them.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
from torch import nn

from .common import (ArchConfig, Embed, MLP, Norm, apply_mlp, apply_norm,
                     cache_zeros, check_ported, chunked_xent, embed_params,
                     embed_tokens,
                     make_generator, make_tensor_parallel, mlp_params,
                     norm_params, remat_wrap, sinusoidal_pos,
                     sp_constrain, take_heads, tensor_parallel, tp_copy,
                     tp_state, tp_whole, unembed)
from . import attention as attn
from .transformer import write_kv

Cache = List[Dict[str, torch.Tensor]]


class EncBlock(nn.Module):
    """norm1, non-causal self-attention, norm2, the MLP."""

    def __init__(self, norm1: Norm, attn_: attn.GQA, norm2: Norm, ffn: MLP):
        super().__init__()
        self.norm1, self.attn, self.norm2, self.ffn = norm1, attn_, norm2, ffn


class DecBlock(nn.Module):
    """norm1, causal self-attention, norm_x, cross-attention on the
    encoder states, norm2, the MLP."""

    def __init__(self, norm1: Norm, self_attn: attn.GQA, norm_x: Norm,
                 cross_attn: attn.GQA, norm2: Norm, ffn: MLP):
        super().__init__()
        self.norm1, self.self_attn, self.norm_x = norm1, self_attn, norm_x
        self.cross_attn, self.norm2, self.ffn = cross_attn, norm2, ffn


class EncDec(nn.Module):
    """The parameters: the (shared) embeddings, the encoder and decoder
    layer lists and their final norms."""

    def __init__(self, embed: Embed, enc_layers: List[EncBlock],
                 dec_layers: List[DecBlock], enc_norm: Norm, dec_norm: Norm):
        super().__init__()
        self.embed = embed
        self.enc_layers = nn.ModuleList(enc_layers)
        self.dec_layers = nn.ModuleList(dec_layers)
        self.enc_norm, self.dec_norm = enc_norm, dec_norm


def init_params(cfg: ArchConfig, seed: int = 0, device="cuda",
                trainable: bool = False) -> EncDec:
    """Random weights from the reference's distributions, drawn with a
    ``torch.Generator`` on ``device`` (not the reference's numbers: use
    ``convert.from_reference`` for those). ``trainable`` turns on
    ``requires_grad`` for every parameter."""
    check_ported(cfg)
    gen = make_generator(device, seed)
    norm = lambda: norm_params(cfg, cfg.d_model, device)
    mlp = lambda: mlp_params(cfg, gen, cfg.d_model, cfg.d_ff)
    embed = embed_params(cfg, gen)
    enc = [EncBlock(norm(), attn.gqa_params(cfg, gen), norm(), mlp())
           for _ in range(cfg.n_enc_layers)]
    dec = [DecBlock(norm(), attn.gqa_params(cfg, gen), norm(),
                    attn.gqa_params(cfg, gen), norm(), mlp())
           for _ in range(cfg.n_layers)]
    params = EncDec(embed, enc, dec, norm(), norm())
    return params.requires_grad_(trainable)


def _sinusoidal_at(pos_ids: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal embeddings at the positions ``pos_ids`` (s,), in fp32:
    (s, d) [sin | cos]."""
    i = torch.arange(d // 2, dtype=torch.float32, device=pos_ids.device)
    ang = pos_ids.float()[:, None] / (10000.0 ** (2 * i[None, :] / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


def _enc_layer(cfg: ArchConfig, layer: EncBlock, x: torch.Tensor):
    h = apply_norm(cfg, layer.norm1, x)
    o, _ = attn.gqa_forward(cfg, layer.attn, h, None, causal=False)
    x = x + o
    h = apply_norm(cfg, layer.norm2, x)
    return apply_mlp(cfg, layer.ffn, h, residual=x)


def encode(cfg: ArchConfig, params: EncDec,
           enc_embeds: torch.Tensor) -> torch.Tensor:
    """(b, s_enc, d) frame embeddings -> the encoder states (b, s_enc, d)
    in the compute dtype.

    On a mesh the encoder runs under a context of its own: its residual
    is sequence-parallel only where its frames divide over ``model``
    (:func:`make_tensor_parallel` at s_enc; whisper's 1500 do not divide
    by 8), whatever the decoder's tokens do. Its states come out whole on
    every rank (:func:`tp_whole`) for the decoder's cross-attention."""
    dt = cfg.cdtype
    _, s, d = enc_embeds.shape
    x = enc_embeds.to(dt) + sinusoidal_pos(s, d, enc_embeds.device).to(
        dt)[None]
    tp = tp_state()
    etp = None if tp is None else make_tensor_parallel(cfg, tp.mesh, s)
    def layer(x, ll):
        # the context set inside the layer: remat's recomputation in the
        # backward runs under the step's context otherwise
        with tensor_parallel(etp):
            return _enc_layer(cfg, ll, x)

    with tensor_parallel(etp):
        if cfg.sp_residual:
            x = sp_constrain(x)
        for ll in params.enc_layers:
            x = remat_wrap(cfg, lambda xx, ll=ll: layer(xx, ll))(x)
        return tp_whole(apply_norm(cfg, params.enc_norm, x))


def _cross_kv(cfg: ArchConfig, p: attn.GQA, enc: torch.Tensor):
    """The cross-attention's keys and values of the encoder states, in
    (b, hkv, s_enc, hd) layout. On a model axis the rank projects the kv
    heads its q heads read (:func:`attention.gqa_heads`), from the whole
    encoder states entering through :func:`tp_copy`."""
    dt = cfg.cdtype
    b, s, _ = enc.shape
    hd, hkv = cfg.hd, cfg.n_kv_heads
    _, _, lo, hi = attn.gqa_heads(cfg)
    cols = lambda w: take_heads(w, -1, hkv, hd, lo, hi, dt)
    enc = tp_copy(enc)
    k = (enc @ cols(p.wk)).reshape(b, s, hi - lo, hd)
    v = (enc @ cols(p.wv)).reshape(b, s, hi - lo, hd)
    if cfg.qkv_bias:
        k = k + cols(p.bk).reshape(1, 1, hi - lo, hd)
        v = v + cols(p.bv).reshape(1, 1, hi - lo, hd)
    return k.transpose(1, 2), v.transpose(1, 2)


def _embed_at(cfg: ArchConfig, params: EncDec, tokens: torch.Tensor,
              start: int) -> torch.Tensor:
    """Token embeddings plus the sinusoids at ``start + arange(s)``."""
    s = tokens.shape[1]
    pos = start + torch.arange(s, device=tokens.device)
    return embed_tokens(cfg, params.embed, tokens) + _sinusoidal_at(
        pos, cfg.d_model).to(cfg.cdtype)[None]


def _dec_layer(cfg: ArchConfig, layer: DecBlock, x: torch.Tensor,
               enc: torch.Tensor, cache: Optional[Dict] = None):
    """One decoder layer over a full sequence; with ``cache`` (prefill)
    its self-attention keys and values and the cross-attention's are
    written into the cache's first slots, in bf16."""
    h = apply_norm(cfg, layer.norm1, x)
    o, (k, v) = attn.gqa_forward(cfg, layer.self_attn, h, None, causal=True)
    x = x + o
    h = apply_norm(cfg, layer.norm_x, x)
    ck, cv = _cross_kv(cfg, layer.cross_attn, enc)
    o, _ = attn.gqa_forward(cfg, layer.cross_attn, h, None, causal=False,
                            kv=(ck, cv))
    x = x + o
    if cache is not None:
        write_kv(cfg, cache, "k", "v", (k, v))
        write_kv(cfg, cache, "ck", "cv", (ck, cv))
    h = apply_norm(cfg, layer.norm2, x)
    return apply_mlp(cfg, layer.ffn, h, residual=x)


def _decoder(cfg: ArchConfig, params: EncDec, tokens: torch.Tensor,
             enc: torch.Tensor) -> torch.Tensor:
    """The decoder over a full sequence (training): the final hidden
    states."""
    x = _embed_at(cfg, params, tokens, 0)
    if cfg.sp_residual:
        x = sp_constrain(x)
    for layer in params.dec_layers:
        x = remat_wrap(cfg, lambda xx, ee, ll=layer: _dec_layer(
            cfg, ll, xx, ee))(x, enc)
    return apply_norm(cfg, params.dec_norm, x)


def loss_fn(cfg: ArchConfig, params: EncDec, batch: Dict[str, Any]):
    """Mean next-token cross-entropy of the decoder (masked by
    ``loss_mask`` where given). Returns ``(loss, {"xent", "moe_aux"})``,
    the aux loss 0."""
    enc = encode(cfg, params, batch["enc_embeds"])
    h = _decoder(cfg, params, batch["tokens"], enc)
    loss = chunked_xent(cfg, params.embed, h, batch["labels"],
                        batch.get("loss_mask"))
    return loss, {"xent": loss,
                  "moe_aux": torch.zeros((), dtype=torch.float32,
                                         device=h.device)}


def cache_shapes(cfg: ArchConfig, batch: int, seq: int,
                 dtype=torch.bfloat16,
                 enc_seq: Optional[int] = None) -> List[Dict[str, tuple]]:
    """Each decoder layer's cache leaves as ``{name: (shape, dtype)}``:
    ``k``, ``v`` (batch, hkv, seq, hd) and ``ck``, ``cv`` (batch, hkv,
    enc_seq, hd), ``enc_seq`` defaulting to the config's."""
    enc_seq = cfg.enc_seq if enc_seq is None else enc_seq
    kv = lambda s: ((batch, cfg.n_kv_heads, s, cfg.hd), dtype)
    return [{"k": kv(seq), "v": kv(seq), "ck": kv(enc_seq),
             "cv": kv(enc_seq)} for _ in range(cfg.n_layers)]


def init_cache(cfg: ArchConfig, batch: int, seq: int,
               dtype=torch.bfloat16, device="cuda",
               enc_seq: Optional[int] = None) -> Cache:
    """Each decoder layer's empty cache (:func:`cache_shapes`)."""
    return [cache_zeros(layer, device)
            for layer in cache_shapes(cfg, batch, seq, dtype, enc_seq)]


def prefill(cfg: ArchConfig, params: EncDec, batch: Dict[str, Any],
            cache_len: Optional[int] = None, cache: Optional[Cache] = None):
    """Encode ``batch["enc_embeds"]``, run the decoder over
    ``batch["tokens"]`` and fill a new bf16 cache of ``cache_len`` slots
    (the cross-attention's keys and values at the encoder's length), or
    the given empty ``cache`` (the mesh's). Returns (last-position
    logits, cache, fill)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    cache_len = cache_len or s
    enc = encode(cfg, params, batch["enc_embeds"])
    if cache is None:
        cache = init_cache(cfg, b, cache_len, torch.bfloat16, tokens.device,
                           enc_seq=enc.shape[1])
    x = _embed_at(cfg, params, tokens, 0)
    for layer, c in zip(params.dec_layers, cache):
        x = _dec_layer(cfg, layer, x, enc, c)
    h = apply_norm(cfg, params.dec_norm, x)
    logits = unembed(cfg, params.embed, h[:, -1:])
    return logits[:, 0], cache, s


def decode_step(cfg: ArchConfig, params: EncDec, tokens: torch.Tensor,
                cache: Cache, fill: int, **_):
    """tokens: (b, s_new) -> (logits (b, s_new, vocab), cache). The
    self-attention's new keys and values are written into ``cache`` in
    place at ``fill``; the cross-attention reads the cached encoder keys
    and values in the compute dtype (:func:`attention.cross_decode`)."""
    x = _embed_at(cfg, params, tokens, fill)
    for layer, c in zip(params.dec_layers, cache):
        h = apply_norm(cfg, layer.norm1, x)
        o, _ = attn.gqa_decode(cfg, layer.self_attn, h, None, c, fill)
        x = x + o
        h = apply_norm(cfg, layer.norm_x, x)
        x = x + attn.cross_decode(cfg, layer.cross_attn, h, c)
        h = apply_norm(cfg, layer.norm2, x)
        x = apply_mlp(cfg, layer.ffn, h, residual=x)
    h = apply_norm(cfg, params.dec_norm, x)
    return unembed(cfg, params.embed, h), cache
