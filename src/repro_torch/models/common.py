"""Shared model components of every ported family: config, RMSNorm and
LayerNorm, RoPE and M-RoPE, sinusoidal positions, the MLP, the
embeddings (tied or not), the cross-entropy and activation
recomputation.

Counterpart of ``repro.models.common``, its activation-sharding hooks
included (``set_activation_sharding``, ``sp_constrain``, and the
context-parallel ``ctx_constrain_q`` / ``ctx_replicate_kv``). On a mesh,
each rank runs the model as the reference's SPMD partitioner would split
it (:class:`TensorParallel`): the parameters it reads are its own
blocks, and the layers call differentiable collectives over the mesh's
``model`` group where the blocks meet. Serving on a mesh keeps each
layer's cache as DTensors under the reference's ``cache_specs``
(:func:`cache_split`, :func:`cache_take`, :func:`cache_write`), and a
decode over a sequence-sharded cache merges the ranks' partial
attention by their log-sum-exps (:func:`merge_partials`). Parameters
are ``nn.Module``s whose tensors keep the reference's layouts
((d_in, d_out) weights used as ``x @ w``), so converted weights and the
functions below compute what the reference computes. The QKV, WO and
unembed products are plain ``x @ w`` as in the reference; the MLP goes
through ``ops.fused_mlp`` (the GEMM kernel with fused epilogues).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.kernels import ops

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


# ----------------------------------------------------------------------
# Config
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """The reference's architecture config, field for field, so configs
    are declared the same way in both packages."""
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1e4
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    act: str = "swiglu"            # swiglu | gelu
    tie_embeddings: bool = False
    # --- MoE ---
    moe: bool = False
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    moe_every: int = 1             # MoE FFN on layers where i % moe_every == moe_offset
    moe_offset: int = 0
    capacity_factor: float = 1.25
    # --- MLA (deepseek) ---
    mla: bool = False
    kv_lora_rank: int = 0
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128
    # --- SSM (mamba2) ---
    ssm: bool = False
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 64
    # --- hybrid (jamba) ---
    attn_period: int = 0           # attention at layers i % attn_period == attn_offset
    attn_offset: int = 0
    # --- enc-dec (whisper) ---
    encoder_decoder: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 1500            # stub frontend: precomputed frame embeds
    # --- vlm (qwen2-vl) ---
    mrope: bool = False
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    n_patches: int = 0             # stub frontend: precomputed patch embeds
    # --- numerics / training ---
    compute_dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    remat: str = "full"            # full | dots | none
    logits_chunk: int = 0          # 0 = unchunked cross-entropy
    grad_accum: int = 1            # microbatch accumulation (memory knob)
    prefill_microbatch: int = 1    # chunked prefill (inference memory knob)
    sp_residual: bool = True       # sequence-parallel residual carry
    mla_absorb: bool = False       # absorbed-matmul MLA decode
    ctx_parallel: bool = False     # context-parallel attention (seq-
                                   # sharded q, replicated attn weights)
    ctx_replicate_weights: bool = True  # False: keep attn weights sharded
                                   # (transient per-layer gathers instead)
    cache_shard: str = "seq"       # decode-cache layout: seq|latent|heads
    unroll: bool = False           # unroll layer loops (dry-run delta method)
    # reduced-config smoke marker
    notes: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Embedding tables padded to a multiple of 256, as the reference
        pads them (labels never reference the padded ids)."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def is_attn_layer(self, i: int) -> bool:
        if not self.attn_period:
            return not self.ssm
        return i % self.attn_period == self.attn_offset

    def is_moe_layer(self, i: int) -> bool:
        return self.moe and (i % self.moe_every == self.moe_offset)

    @property
    def cdtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    @property
    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    def scaled(self, **overrides) -> "ArchConfig":
        return dataclasses.replace(self, **overrides)


def check_ported(cfg: ArchConfig) -> None:
    """This package runs every family of the reference's registry: dense
    GQA and MLA / MoE decoders, the attention-free Mamba-2 stack
    (``family == "ssm"``), the hybrid (jamba: Mamba-2 and GQA layers on a
    period), the encoder-decoder (whisper) and the VLM (qwen2-vl, M-RoPE
    and the patch stub). It refuses the combinations no family has: an
    encoder-decoder runs GQA layers with MLPs only."""
    ssm_family = cfg.family in ("ssm", "hybrid")
    unsupported = [name for name, on in (
        ("ssm outside the ssm and hybrid families",
         cfg.ssm and not ssm_family),
        ("ssm family without ssm layers",
         cfg.family == "ssm" and not cfg.ssm),
        ("attn_period outside the hybrid family",
         bool(cfg.attn_period) and cfg.family != "hybrid"),
        ("encoder_decoder with ssm, mla, moe, mrope or patches",
         cfg.encoder_decoder and (cfg.ssm or cfg.mla or cfg.moe
                                  or cfg.mrope or bool(cfg.n_patches)))
    ) if on]
    if unsupported:
        raise NotImplementedError(f"{cfg.name}: {unsupported} not "
                                  f"supported")


# ----------------------------------------------------------------------
# Initialisation helpers (the reference's distributions)
# ----------------------------------------------------------------------
class _MetaGenerator(torch.Generator):
    """A CPU generator that reports the meta device, so the parameters
    drawn with it are shapes only."""

    @property
    def device(self):
        return torch.device("meta")


def make_generator(device, seed: int) -> torch.Generator:
    """The init's generator on ``device``, seeded with ``seed``. On the
    meta device the draws land on meta tensors: a full config's
    parameters, counted without memory."""
    if torch.device(device).type == "meta":
        return _MetaGenerator().manual_seed(seed)
    return torch.Generator(device=device).manual_seed(seed)


def _trunc_normal(shape, std: float, dtype, gen: torch.Generator):
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(std).to(dtype)


def dense_init(shape, gen: torch.Generator, in_axis: int = 0,
               dtype=torch.float32) -> torch.Tensor:
    """Truncated normal at +-2 sigma scaled by 1/sqrt(fan_in)."""
    return _trunc_normal(shape, 1.0 / np.sqrt(shape[in_axis]), dtype, gen)


def embed_init(shape, gen: torch.Generator,
               dtype=torch.float32) -> torch.Tensor:
    return _trunc_normal(shape, 0.02, dtype, gen)


def _param(t: torch.Tensor, requires_grad: bool = False) -> nn.Parameter:
    """A parameter, frozen unless asked: serving never needs gradients;
    ``Model.init(..., trainable=True)`` and the Trainer turn them on."""
    return nn.Parameter(t, requires_grad=requires_grad)


# ----------------------------------------------------------------------
# Norms
# ----------------------------------------------------------------------
class Norm(nn.Module):
    """RMSNorm's ``scale``, and LayerNorm's ``scale`` and ``bias``."""

    def __init__(self, scale: torch.Tensor,
                 bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.scale = _param(scale)
        self.bias = _param(bias) if bias is not None else None


def norm_params(cfg: ArchConfig, d: int, device) -> Norm:
    ones = torch.ones(d, dtype=cfg.pdtype, device=device)
    if cfg.norm == "layernorm":
        return Norm(ones, torch.zeros(d, dtype=cfg.pdtype, device=device))
    return Norm(ones)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5):
    """The reference's LayerNorm, written out in its order: the mean and
    then the mean of the squared deviations in fp32, scale and bias
    applied in fp32, one cast back."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * scale.float() + bias.float()).to(dt)


def rmsnorm_split(x: torch.Tensor, scale: torch.Tensor, width: int,
                  eps: float = 1e-6):
    """:func:`rmsnorm` over a feature axis of ``width`` split over the
    ``model`` axis, ``x`` and ``scale`` this rank's block of it: the sum
    of squares is summed over ``model`` and divided by the full
    ``width``, so each rank normalises its block as the whole axis would
    be (its gradient reaches every rank's block: :func:`tp_copy`).
    :func:`rmsnorm` without a model axis."""
    tp = _TP
    if tp is None or tp.nm == 1:
        return rmsnorm(x, scale, eps)
    dt = x.dtype
    x = x.float()
    ss = tp_copy(model_sum((x * x).sum(-1, keepdim=True)))
    x = x * torch.rsqrt(ss / width + eps)
    return (x * scale.float()).to(dt)


def apply_norm(cfg: ArchConfig, p: Norm, x: torch.Tensor) -> torch.Tensor:
    """The residual stream's norm. Under the sequence-parallel residual a
    rank sees its block of the sequence, so the scale and bias enter
    through :func:`tp_copy` and their gradients come out whole."""
    scale, bias = p.scale, p.bias
    tp = _TP
    if tp is not None and tp.sp:
        scale = tp_copy(scale)
        bias = None if bias is None else tp_copy(bias)
    if cfg.norm == "layernorm":
        return layernorm(x, scale, bias)
    return rmsnorm(x, scale)


# ----------------------------------------------------------------------
# RoPE / M-RoPE / sinusoidal positions
# ----------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, pos: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (b, h, s, d); pos: (b, s) absolute positions. Rotates the split
    halves (not interleaved pairs), as the reference does."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                 # (d/2,)
    ang = pos[:, None, :, None].float() * freqs            # (b,1,s,d/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, pos3: torch.Tensor, theta: float,
                sections: Tuple[int, int, int]) -> torch.Tensor:
    """Multimodal RoPE (qwen2-vl). x: (b, h, s, d); pos3: (3, b, s), the
    (t, h, w) position streams. The d/2 frequency slots fall into three
    sections, slot j rotated by position stream ``sec[j]``."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                 # (d/2,)
    sec = np.concatenate([np.full(s, i) for i, s in enumerate(sections)])
    if sec.shape[0] != d // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to "
                         f"head_dim / 2 = {d // 2}")
    sec = torch.as_tensor(sec, device=x.device)
    pos = pos3.permute(1, 2, 0).float()[:, :, sec]         # (b, s, d/2)
    ang = pos[:, None] * freqs                             # (b,1,s,d/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def sinusoidal_pos(seq: int, d: int, device=None) -> torch.Tensor:
    """(seq, d) fp32 sinusoids [sin | cos], the table built in float64
    numpy as the reference builds it, then rounded once."""
    pos = np.arange(seq)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / (10000 ** (2 * i / d))
    emb = np.concatenate([np.sin(ang), np.cos(ang)], -1)
    return torch.as_tensor(emb.astype(np.float32), device=device)


# ----------------------------------------------------------------------
# MLPs
# ----------------------------------------------------------------------
class MLP(nn.Module):
    def __init__(self, w1, w2, w3=None):
        super().__init__()
        self.w1, self.w2 = _param(w1), _param(w2)
        self.w3 = _param(w3) if w3 is not None else None


def mlp_params(cfg: ArchConfig, gen: torch.Generator, d: int,
               ff: int) -> MLP:
    w1 = dense_init((d, ff), gen, 0, cfg.pdtype)
    w2 = dense_init((ff, d), gen, 0, cfg.pdtype)
    w3 = (dense_init((d, ff), gen, 0, cfg.pdtype) if cfg.act == "swiglu"
          else None)
    return MLP(w1, w2, w3)


def apply_mlp(cfg: ArchConfig, p: MLP, x: torch.Tensor,
              residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MLP through ``ops.fused_mlp``: the activation, the SwiGLU gate and
    the caller's residual add run as GEMM store epilogues. Passing
    ``residual`` returns ``residual + mlp(x)``."""
    dt = cfg.cdtype
    x = x.to(dt)
    w3 = p.w3.to(dt) if cfg.act == "swiglu" else None
    tp = _TP
    if tp is not None and tp.nm > 1:
        # column-parallel w1 / w3, row-parallel w2 on this rank's block of
        # d_ff; the residual is added once, after the sum over model
        out = tp_exit(ops.fused_mlp(tp_enter(x), p.w1.to(dt), p.w2.to(dt),
                                    w3=w3, act=cfg.act))
        return out if residual is None else residual + out
    return ops.fused_mlp(x, p.w1.to(dt), p.w2.to(dt), w3=w3, act=cfg.act,
                         residual=residual)


# ----------------------------------------------------------------------
# Embedding / unembedding
# ----------------------------------------------------------------------
class Embed(nn.Module):
    """The (vocab, d) table and, unless the embeddings are tied, the
    (d, vocab) unembedding (tied: ``unembed`` is None and the table's
    transpose unembeds)."""

    def __init__(self, embed: torch.Tensor,
                 unembed: Optional[torch.Tensor] = None):
        super().__init__()
        self.embed = _param(embed)
        self.unembed = _param(unembed) if unembed is not None else None


def embed_params(cfg: ArchConfig, gen: torch.Generator) -> Embed:
    v = cfg.padded_vocab
    embed = embed_init((v, cfg.d_model), gen, cfg.pdtype)
    if cfg.tie_embeddings:
        return Embed(embed)
    return Embed(embed, dense_init((cfg.d_model, v), gen, 0, cfg.pdtype))


def embed_tokens(cfg: ArchConfig, p: Embed,
                 tokens: torch.Tensor) -> torch.Tensor:
    """The rows of ``tokens``. On a model axis the table is
    vocab-parallel: each rank looks up the tokens in its block of rows,
    zeros elsewhere, and the blocks are summed over ``model``."""
    tp = _TP
    if tp is None or tp.nm == 1:
        return p.embed[tokens].to(cfg.cdtype)
    lo, hi = shard_range(cfg.padded_vocab, tp.nm, tp.rank)
    local = tokens - lo
    own = ((local >= 0) & (local < hi - lo))[..., None]
    x = p.embed[local.clamp(0, hi - lo - 1)] * own.to(p.embed.dtype)
    return model_sum(x.to(cfg.cdtype))


def unembed(cfg: ArchConfig, p: Embed, x: torch.Tensor) -> torch.Tensor:
    """Logits; on a model axis, this rank's block of the vocabulary."""
    w = p.embed.t() if cfg.tie_embeddings else p.unembed
    return x.to(cfg.cdtype) @ w.to(cfg.cdtype)


# ----------------------------------------------------------------------
# Loss
# ----------------------------------------------------------------------
def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross-entropy. logits (b, s, v); labels (b, s)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, -1)
    ll = torch.take_along_dim(logits, labels[..., None].long(), -1)[..., 0]
    nll = lse - ll
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def chunked_xent(cfg: ArchConfig, p: Embed, h: torch.Tensor,
                 labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cross-entropy without materialising the full (b, s, v) logits: the
    sequence is cut into ``cfg.logits_chunk`` slices, each unembedded and
    reduced on its own (the reference's ``lax.scan`` is a loop here).

    On a mesh (:class:`TensorParallel`) it is this data rank's share of
    the global mean: its tokens' summed loss over the mask's global
    count, so the shares sum over the data axes to the reference's mean.
    On a model axis the hidden states enter the vocab-parallel
    unembedding whole (:func:`tp_enter`), and the log-sum-exp and the
    label's logit are reduced over ``model``: the max (a constant of the
    gradient) and the sum of exponentials, and the logit from the rank
    that owns the label."""
    tp = _TP
    chunk = cfg.logits_chunk
    whole = not chunk or h.shape[1] % chunk
    if tp is None and whole:
        return softmax_xent(unembed(cfg, p, h), labels, mask)
    split = tp is not None and tp.nm > 1
    if split:
        h = tp_enter(h)
        lo, hi = shard_range(cfg.padded_vocab, tp.nm, tp.rank)
    step = h.shape[1] if whole else chunk
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for s0 in range(0, h.shape[1], step):
        sl = slice(s0, s0 + step)
        logits = unembed(cfg, p, h[:, sl]).float()
        lab = labels[:, sl, None].long()
        if not split:
            lse = torch.logsumexp(logits, -1)
            ll = torch.take_along_dim(logits, lab, -1)[..., 0]
        else:
            m = logits.detach().amax(-1)
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=tp.group)
            lse = torch.log(model_sum(torch.exp(logits - m[..., None])
                                      .sum(-1))) + m
            local = lab - lo
            own = (local >= 0) & (local < hi - lo)
            ll = model_sum((torch.take_along_dim(
                logits, local.clamp(0, hi - lo - 1), -1) * own)[..., 0])
        mx = (mask[:, sl].float() if mask is not None
              else torch.ones_like(lse))
        tot = tot + ((lse - ll) * mx).sum()
        cnt = cnt + mx.sum()
    if tp is not None:
        cnt = cnt.detach().clone()
        for g in tp.data_groups:
            dist.all_reduce(cnt, group=g)
    return tot / torch.clamp_min(cnt, 1.0)


# ----------------------------------------------------------------------
# Activation sharding and the tensor-parallel context
# ----------------------------------------------------------------------
_ACT_SHARDING: Dict[str, Any] = {}


def set_activation_sharding(mesh=None, data_axes=(), model_axis=None):
    """Enable the sequence-parallel residual (Megatron-SP) on meshes:
    between layers each rank keeps the (b, s / model, d) block of the
    residual stream (:func:`sp_constrain`), all-gathered before the
    column-parallel products and reduce-scattered after the row-parallel
    ones. Called with no args to disable. The reference's launcher turns
    it on for every mesh; ``cfg.sp_residual`` can turn it off."""
    global _ACT_SHARDING
    if mesh is None:
        _ACT_SHARDING = {}
    else:
        _ACT_SHARDING = {"mesh": mesh, "data_axes": tuple(data_axes),
                         "model_axis": model_axis}


def shard_range(total: int, n: int, r: int) -> Tuple[int, int]:
    """[lo, hi) of block r of ``total`` in n blocks as ``torch.chunk``
    cuts it (DTensor's rule for a sharded dimension)."""
    size = -(-total // n)
    lo = min(r * size, total)
    return lo, min(lo + size, total)


def balanced_range(total: int, n: int, r: int) -> Tuple[int, int]:
    """[lo, hi) of part r of ``total`` in n parts that differ by at most
    one (the attention heads a rank computes)."""
    base, extra = divmod(total, n)
    lo = r * base + min(r, extra)
    return lo, lo + base + (r < extra)


def rank_heads(n: int) -> Tuple[int, int]:
    """[lo, hi) of the ``n`` heads (attention or SSD) this rank computes:
    split as evenly as they go over the model axis
    (:func:`balanced_range`); every head without one."""
    tp = _TP
    return (0, n) if tp is None else balanced_range(n, tp.nm, tp.rank)


def take_heads(w: torch.Tensor, dim: int, heads: int, size: int, lo: int,
               hi: int, dt) -> torch.Tensor:
    """Heads [lo, hi) of ``heads`` heads of ``size`` along dimension
    ``dim`` of the weight whose model-axis block this rank holds as
    ``w`` (:meth:`TensorParallel.take`), in ``dt``; ``w`` itself without
    a model axis."""
    tp = _TP
    if tp is not None:
        w = tp.take(w, dim % w.ndim, heads * size, lo * size, hi * size)
    return w.to(dt)


@dataclasses.dataclass
class TensorParallel:
    """A rank's view of its mesh for the model's layers: the ``model``
    group (its size ``nm`` and this rank's index in it), the data
    groups, and whether the residual between layers is sequence-sharded
    (``sp``: the activation-sharding context set, ``cfg.sp_residual``
    and the sequence dividing over ``model``; decided from static shapes
    so that every rank takes the same branches, a recomputation
    included)."""
    mesh: Any
    sp: bool

    def __post_init__(self):
        names = self.mesh.mesh_dim_names
        self.nm = self.mesh.size(names.index("model"))
        self.model_mesh = self.mesh["model"]
        self.group = self.mesh.get_group("model")
        self.rank = self.model_mesh.get_local_rank()
        data_axes = [a for a in names if a != "model"]
        self.data_groups = [self.mesh.get_group(a) for a in data_axes]
        self.n_data = int(np.prod([self.mesh.size(names.index(a))
                                   for a in data_axes]))

    def take(self, w: torch.Tensor, dim: int, total: int, lo: int,
             hi: int) -> torch.Tensor:
        """Indices [lo, hi) of dimension ``dim`` of the weight whose
        model-axis block this rank holds as ``w``: the block itself where
        it is that range, else the weight gathered over ``model`` (a
        DTensor redistribution, whose backward reduce-scatters the
        gradient) and cut. A weight stored replicated (``w`` already
        whole) is cut, its gradient summed over ``model``."""
        if self.nm > 1 and w.shape[dim] == total:
            # stored replicated (the context-parallel layout): the rank's
            # share of the gradient summed over model, as tp_copy does
            return _Comm.apply(w, "identity", "all_reduce", self).narrow(
                dim, lo, hi - lo)
        if shard_range(total, self.nm, self.rank) == (lo, hi):
            return w
        shape = list(w.shape)
        shape[dim] = total
        full = DTensor.from_local(
            w, self.model_mesh, [Shard(dim)], run_check=False,
            shape=torch.Size(shape),
            stride=tuple(torch.empty(shape, device="meta").stride()))
        full = full.redistribute(self.model_mesh, [Replicate()]).to_local(
            grad_placements=[Partial()])
        return full.narrow(dim, lo, hi - lo)


_TP: Optional[TensorParallel] = None


def tp_state() -> Optional[TensorParallel]:
    """The tensor-parallel context of the running step, or None."""
    return _TP


@contextlib.contextmanager
def tensor_parallel(tp: Optional[TensorParallel]):
    """Run the model's layers as ``tp``'s rank (a mesh step keeps it set
    through its backward, where remat recomputes the layers)."""
    global _TP
    old, _TP = _TP, tp
    try:
        yield tp
    finally:
        _TP = old


def make_tensor_parallel(cfg: ArchConfig, mesh, seq: int) -> TensorParallel:
    """The context of a step on ``mesh`` over sequences of ``seq`` (the
    encoder-decoder's encoder takes its own, from its frames)."""
    tp = TensorParallel(mesh, sp=False)
    tp.sp = bool(_ACT_SHARDING) and cfg.sp_residual and seq % tp.nm == 0
    return tp


def _seq_gather(x, tp):
    xt = x.movedim(1, 0).contiguous()
    out = xt.new_empty((tp.nm * xt.shape[0], *xt.shape[1:]))
    _ALL_GATHER(out, xt, group=tp.group)
    return out.movedim(0, 1).contiguous()


def _seq_reduce_scatter(x, tp):
    xt = x.movedim(1, 0).contiguous()
    out = xt.new_empty((xt.shape[0] // tp.nm, *xt.shape[1:]))
    _REDUCE_SCATTER(out, xt, group=tp.group)
    return out.movedim(0, 1).contiguous()


def _all_reduce(x, tp):
    x = x.contiguous().clone()
    dist.all_reduce(x, group=tp.group)
    return x


def _seq_split(x, tp):
    s = x.shape[1] // tp.nm
    return x[:, tp.rank * s:(tp.rank + 1) * s].contiguous()


_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor
_COMMS = {"gather": _seq_gather, "reduce_scatter": _seq_reduce_scatter,
          "all_reduce": _all_reduce, "split": _seq_split,
          "identity": lambda x, tp: x.view_as(x)}


class _Comm(torch.autograd.Function):
    """A collective over the ``model`` group in the forward and its dual
    in the backward."""

    @staticmethod
    def forward(ctx, x, fwd: str, bwd: str, tp: TensorParallel):
        ctx.bwd, ctx.tp = bwd, tp
        return _COMMS[fwd](x, tp)

    @staticmethod
    def backward(ctx, g):
        return _COMMS[ctx.bwd](g, ctx.tp), None, None, None


def tp_enter(x: torch.Tensor) -> torch.Tensor:
    """Into a column-parallel product: the sequence-sharded residual
    all-gathered (backward: reduce-scattered), or the replicated one
    as it is (backward: the gradient all-reduced over ``model``); the
    identity without a model axis."""
    tp = _TP
    if tp is None or tp.nm == 1:
        return x
    if tp.sp:
        return _Comm.apply(x, "gather", "reduce_scatter", tp)
    return _Comm.apply(x, "identity", "all_reduce", tp)


def tp_copy(x: torch.Tensor) -> torch.Tensor:
    """A replicated tensor into a model-split region (Megatron's "f"):
    the identity, whose backward all-reduces the rank's partial gradient
    over ``model``, so every replicated leaf and activation upstream
    takes its whole gradient on every rank; the identity without a model
    axis."""
    tp = _TP
    if tp is None or tp.nm == 1:
        return x
    return _Comm.apply(x, "identity", "all_reduce", tp)


def tp_whole(x: torch.Tensor) -> torch.Tensor:
    """The whole sequence of the residual stream, for work every rank
    does alike (routing, MLA's latent, Mamba-2's B and C): the
    sequence-sharded residual all-gathered, whose backward keeps this
    rank's block of the (whole) gradient; as it is otherwise.
    ``tp_copy(tp_whole(x))`` is :func:`tp_enter`."""
    tp = _TP
    if tp is None or tp.nm == 1 or not tp.sp:
        return x
    return _Comm.apply(x, "gather", "split", tp)


def tp_exit(x: torch.Tensor) -> torch.Tensor:
    """Out of a row-parallel product: the partial sums reduce-scattered
    over the sequence (backward: all-gathered), or all-reduced
    (backward: as it is); the identity without a model axis."""
    tp = _TP
    if tp is None or tp.nm == 1:
        return x
    if tp.sp:
        return _Comm.apply(x, "reduce_scatter", "gather", tp)
    return _Comm.apply(x, "all_reduce", "identity", tp)


def model_sum(x: torch.Tensor) -> torch.Tensor:
    """Partial values summed over ``model``, the result used alike on
    every rank (backward: as it is)."""
    return _Comm.apply(x, "all_reduce", "identity", _TP)


def sp_constrain(x: torch.Tensor) -> torch.Tensor:
    """Residual stream (b, s, d) -> this rank's (b, s / model, d) block
    when the step's residual is sequence-parallel (backward: the blocks'
    gradients all-gathered); identity otherwise, as in the reference
    where the dims do not divide."""
    tp = _TP
    if tp is None or tp.nm == 1 or not tp.sp or x.ndim != 3:
        return x
    return _Comm.apply(x, "split", "gather", tp)


# ----------------------------------------------------------------------
# Context parallelism (the reference's ctx_constrain_q / ctx_replicate_kv)
# ----------------------------------------------------------------------
def ctx_parallel_on(cfg: ArchConfig, x: torch.Tensor) -> bool:
    """True where a self-attention layer on the residual ``x`` takes the
    context-parallel path: ``cfg.ctx_parallel`` on a model axis over 1
    and a whole sequence (this rank's block times the model axis under
    the sequence-parallel residual) that divides over it, the
    reference's own test (``ctx_constrain_q``)."""
    tp = _TP
    if not cfg.ctx_parallel or tp is None or tp.nm == 1:
        return False
    s = x.shape[1] * (tp.nm if tp.sp else 1)
    return s % tp.nm == 0


def ctx_constrain_q(x: torch.Tensor) -> torch.Tensor:
    """(b, s, d) -> this rank's block of the sequence, where the
    attention's queries are computed: the sequence-parallel residual is
    that block already; a replicated one is split (backward: the
    blocks' gradients all-gathered)."""
    tp = _TP
    if tp.sp:
        return x
    return _Comm.apply(x, "split", "gather", tp)


def ctx_replicate_kv(x: torch.Tensor) -> torch.Tensor:
    """(b, h, s / model, d) keys or values of this rank's block -> the
    whole sequence on every rank (backward: reduce-scattered, each
    block's gradient summed over the ranks whose queries read it)."""
    tp = _TP
    return _Comm.apply(x.transpose(1, 2), "gather", "reduce_scatter",
                       tp).transpose(1, 2)


def ctx_constrain_out(x: torch.Tensor) -> torch.Tensor:
    """A context-parallel layer's output block (b, s / model, d) back to
    the residual's layout: as it is under the sequence-parallel residual,
    else all-gathered (backward: this rank's block)."""
    tp = _TP
    if tp.sp:
        return x
    return _Comm.apply(x, "gather", "split", tp)


def whole_weight(w: torch.Tensor, dim: int, total: int, dt) -> torch.Tensor:
    """All ``total`` entries of dimension ``dim`` of a weight whose
    model-axis block this rank holds as ``w``, in ``dt``: a replicated
    weight entering through :func:`tp_copy` (its gradient, a partial over
    the rank's block of the sequence, summed over ``model`` once), a
    sharded one gathered (:meth:`TensorParallel.take`, backward:
    reduce-scattered)."""
    tp = _TP
    if tp is not None and tp.nm > 1:
        w = (tp_copy(w) if w.shape[dim] == total
             else tp.take(w, dim % w.ndim, total, 0, total))
    return w.to(dt)


# ----------------------------------------------------------------------
# Partial attention over blocks of the keys, and caches on a mesh
# ----------------------------------------------------------------------
def combine_partials(o: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """Plain merge of attention over n blocks of the keys: ``o`` (n, b,
    h, s, d) each block's normalised output, ``lse`` (n, b, h, s) fp32
    its rows' log-sum-exp (-inf and o 0 for a block without a valid
    key) -> (b, h, s, d) in o's dtype: ``sum_z w_z o_z / sum_z w_z``,
    ``w_z = exp(lse_z - max_z lse_z)``, in fp32. :func:`merge_partials`
    runs it on every rank's pair. A block without a valid key weighs 0,
    and a row without one in any block comes out 0, not NaN."""
    m = lse.amax(0)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.where(torch.isfinite(lse), torch.exp(lse - m),
                    torch.zeros_like(lse))
    num = (o.float() * w[..., None]).sum(0)
    den = w.sum(0)
    return (num / torch.where(den == 0, torch.ones_like(den),
                              den)[..., None]).to(o.dtype)


def merge_partials(o: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """The attention over every model rank's block of the keys, on every
    rank, from this rank's ``(o, lse)`` (b, h, s, d) and (b, h, s): every
    rank's pair all-gathered over ``model`` (a decode step's rows: small)
    and merged by :func:`combine_partials` (no TPU kernel computes it,
    the reference gets it from its partitioner). ``o`` without a model
    axis."""
    tp = _TP
    if tp is None or tp.nm == 1:
        return o
    pack = torch.cat([o.float().reshape(-1), lse.float().reshape(-1)])
    out = pack.new_empty((tp.nm * pack.numel(),))
    _ALL_GATHER(out, pack, group=tp.group)
    out = out.view(tp.nm, -1)
    n = o.numel()
    return combine_partials(out[:, :n].reshape(tp.nm, *o.shape),
                            out[:, n:].reshape(tp.nm, *lse.shape)
                            ).to(o.dtype)


def rank_ranges(n: int, per: int = 1) -> list:
    """Every model rank's [lo, hi) of ``n`` heads of ``per`` entries
    (:func:`rank_heads`), in rank order; one range without a model
    axis."""
    tp = _TP
    if tp is None:
        return [(0, n * per)]
    return [(lo * per, hi * per) for lo, hi in
            (balanced_range(n, tp.nm, r) for r in range(tp.nm))]


def gather_part(x: torch.Tensor, axis: int, ranges) -> torch.Tensor:
    """Dimension ``axis`` whole on every rank from each model rank's
    ``[lo, hi)`` part of it (``ranges``: every rank's, in rank order;
    parts may differ in size and overlap, as kv heads shared by two
    ranks' q heads do): a padded all-gather over ``model``, then the parts
    placed in rank order (an overlap takes the later rank's copy), so
    every rank holds the same bytes. Serving only (no backward)."""
    tp = _TP
    if tp is None or tp.nm == 1:
        return x
    total = max(hi for _, hi in ranges)
    w = max(hi - lo for lo, hi in ranges)
    xt = x.movedim(axis, 0)
    pad = xt.new_zeros((w, *xt.shape[1:]))
    pad[:xt.shape[0]] = xt
    out = pad.new_empty((tp.nm * w, *xt.shape[1:]))
    _ALL_GATHER(out, pad, group=tp.group)
    whole = xt.new_empty((total, *xt.shape[1:]))
    for r, (lo, hi) in enumerate(ranges):
        whole[lo:hi] = out[r * w:r * w + hi - lo]
    return whole.movedim(0, axis)


def cache_local(t: torch.Tensor) -> torch.Tensor:
    """This rank's block of a cache leaf: a mesh's DTensor's local tensor
    (written in place), the tensor itself otherwise."""
    return t.to_local() if isinstance(t, DTensor) else t


def cache_split(t: torch.Tensor):
    """``(dim, lo, hi)``: the dimension of a cache leaf that the
    ``model`` axis splits (its spec from ``cache_specs``) and this rank's
    range of it; None for a leaf whole on every model rank (or off a
    mesh)."""
    tp = _TP
    if tp is None or not isinstance(t, DTensor):
        return None
    pl = t.placements[t.device_mesh.mesh_dim_names.index("model")]
    if not isinstance(pl, Shard):
        return None
    return (pl.dim, *shard_range(t.shape[pl.dim], tp.nm, tp.rank))


def cache_take(t: torch.Tensor, axis: int, lo: int, hi: int):
    """Entries [lo, hi) of dimension ``axis`` of a cache leaf (the other
    dimensions as this rank holds them): the rank's block where it is
    that range, a cut of it where the leaf is whole, else the leaf
    gathered over ``model`` and cut."""
    if _TP is None:
        return t.narrow(axis, lo, hi - lo)
    loc = cache_local(t)
    split = cache_split(t)
    if split is None:
        return loc.narrow(axis, lo, hi - lo)
    dim, blo, bhi = split
    if dim == axis and (blo, bhi) == (lo, hi):
        return loc
    tp = _TP
    whole = gather_part(loc, dim, [shard_range(t.shape[dim], tp.nm, r)
                                   for r in range(tp.nm)])
    return whole.narrow(axis, lo, hi - lo)


def _blocks_in_order(ranges, total: int) -> bool:
    """True where ``ranges`` are equal, disjoint, in rank order and cover
    [0, total): each rank's part is its own block."""
    w = ranges[0][1] - ranges[0][0]
    return all(r == (i * w, (i + 1) * w) for i, r in enumerate(ranges)) \
        and ranges[-1][1] == total


def _parts_to_seq(loc, src, axis: int, seq_axis: int, start: int,
                  total_seq: int) -> None:
    """The heads-to-sequence exchange of a prefill (an all-to-all over
    ``model``): ``src`` holds this rank's block of dimension ``axis``
    (every rank's the same size, in rank order) at positions [start,
    start + n) of ``seq_axis``; the rank sends each rank the positions of
    that rank's block of the sequence and writes what it receives, every
    rank's block of ``axis`` side by side, into its block ``loc``."""
    tp = _TP
    n = src.shape[seq_axis]
    blocks = [shard_range(total_seq, tp.nm, r) for r in range(tp.nm)]

    def span(lo, hi):
        a = max(start, lo)
        return a, max(0, min(start + n, hi) - a)
    sends = [span(lo, hi) for lo, hi in blocks]
    mine_at, mine = sends[tp.rank]
    xt = src.movedim(seq_axis, 0)
    inp = torch.cat([xt[a - start:a - start + m] for a, m in sends])
    ax = axis + 1 if axis < seq_axis else axis
    out = xt.new_empty((tp.nm * mine, *xt.shape[1:]))
    dist.all_to_all_single(out, inp.contiguous(),
                           output_split_sizes=[mine] * tp.nm,
                           input_split_sizes=[m for _, m in sends],
                           group=tp.group)
    if not mine:
        return
    got = torch.cat(out.split(mine), dim=ax).movedim(0, seq_axis)
    lo = blocks[tp.rank][0]
    loc.narrow(seq_axis, mine_at - lo, mine).copy_(got.to(loc.dtype))


def cache_write(t: torch.Tensor, src: torch.Tensor, seq_axis=None,
                start: int = 0, part=None) -> None:
    """Write ``src`` into the cache leaf ``t`` in place, cast to its
    dtype: ``src``'s dimension ``seq_axis`` holds positions ``[start,
    start + n)`` of ``t``'s (None: ``src`` is all of ``t``). ``part``
    ``(axis, ranges)``: ``src`` holds only this rank's ``ranges[rank]``
    of that dimension (``ranges``: every model rank's); else it is
    whole. The rank writes its block of ``t``: a part as it is where
    ``t`` splits that dimension at that range, otherwise gathered whole
    first (:func:`gather_part`), so that every rank holding a replicated
    leaf writes the same bytes; positions outside the rank's block of a
    sequence-split leaf are dropped. A sequence-split leaf written from
    parts that are every rank's own block (kv heads that divide over
    ``model``) takes the heads-to-sequence all-to-all instead
    (:func:`_parts_to_seq`). Off a mesh ``src`` is the leaf's own
    positions, copied in directly."""
    if _TP is None:
        if seq_axis is not None:
            t = t.narrow(seq_axis, start, src.shape[seq_axis])
        t.copy_(src.to(t.dtype))
        return
    loc = cache_local(t)
    split = cache_split(t)
    if part is not None:
        axis, ranges = part
        tp = _TP
        mine = ranges[0] if tp is None else ranges[tp.rank]
        if (split is not None and seq_axis is not None
                and split[0] == seq_axis and tp.nm > 1
                and _blocks_in_order(ranges, t.shape[axis])):
            _parts_to_seq(loc, src, axis, seq_axis, start,
                          t.shape[seq_axis])
            return
        if split is None or split[0] != axis or split[1:] != tuple(mine):
            src = gather_part(src, axis, ranges)
        else:
            split = None                  # src is the block already
    if seq_axis is not None:
        n = src.shape[seq_axis]
        blo, bhi = ((split[1], split[2]) if split and split[0] == seq_axis
                    else (0, loc.shape[seq_axis]))
        a, b = max(start, blo), min(start + n, bhi)
        if a >= b:
            return
        src = src.narrow(seq_axis, a - start, b - a)
        loc = loc.narrow(seq_axis, a - blo, b - a)
        if split and split[0] == seq_axis:
            split = None
    if split is not None:
        dim, lo, hi = split
        src = src.narrow(dim, lo, hi - lo)
    loc.copy_(src.to(loc.dtype))


def data_share(x: torch.Tensor) -> torch.Tensor:
    """A batch-mean term as this data rank's share of the global mean
    (the data ranks hold equal batches)."""
    return x if _TP is None else x / _TP.n_data


# ----------------------------------------------------------------------
# Activation recomputation
# ----------------------------------------------------------------------
#: the products without batch dims, whose outputs ``remat="dots"`` saves
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    return create_selective_checkpoint_contexts(_save_dots)


def remat_wrap(cfg: ArchConfig, fn: Callable) -> Callable:
    """``"full"``: recompute ``fn``'s activations in the backward
    (``torch.utils.checkpoint``, non-reentrant); ``"dots"``: keep the
    outputs of the products without batch dims (``aten.mm`` /
    ``aten.addmm``, the reference's ``checkpoint_dots_with_no_batch_dims``)
    and recompute the rest, through a selective-checkpoint policy (the
    values are those of ``"full"``); ``"none"``: keep them all."""
    if cfg.remat == "none":
        return fn
    kw = {"context_fn": _dots_context} if cfg.remat == "dots" else {}

    def wrapped(*args):
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return wrapped
