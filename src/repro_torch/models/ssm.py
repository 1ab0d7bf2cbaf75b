"""Mamba-2 block (SSD): projections, causal conv, the SSD scan, gated
output.

Counterpart of ``repro.models.ssm``. The SSD scan runs through
``ops.ssd`` (training) or ``ops.ssd_with_state`` (prefill, which also
hands the final state to decode): the CUDA kernel on the card, its plain
version on the CPU. As in the reference, the projections z, x, B, C and
dt are separate, a width-``d_conv`` depthwise causal conv runs over x, B
and C, A is a scalar decay per head and the output is RMSNorm-gated.
Decode is the single-token recurrence in plain PyTorch, as the reference
computes it outside any kernel, on a cache of the fp32 state and the
last ``d_conv - 1`` pre-conv rows of x, B and C, updated in place.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from .common import (ArchConfig, _param, cache_local, cache_take,
                     cache_write, cache_zeros, dense_init, rank_heads,
                     rank_ranges, rmsnorm_split, take_heads, tp_copy, tp_exit,
                     tp_whole)


class SSM(nn.Module):
    """One Mamba-2 mixer's parameters, named and shaped as the
    reference's ``ssm_params`` dict ((d_in, d_out) weights, (k, c) conv
    taps)."""

    NAMES = ("wz", "wx", "wb", "wc", "wdt", "dt_bias", "conv_x", "conv_x_b",
             "conv_b", "conv_b_b", "conv_c", "conv_c_b", "A_log", "D",
             "norm", "wo")

    def __init__(self, **tensors: torch.Tensor):
        super().__init__()
        if set(tensors) != set(self.NAMES):
            raise ValueError(f"SSM parameters {sorted(tensors)} != "
                             f"{sorted(self.NAMES)}")
        for name in self.NAMES:
            setattr(self, name, _param(tensors[name]))


def ssm_params(cfg: ArchConfig, gen: torch.Generator) -> SSM:
    """The reference's distributions, drawn from ``gen`` (on its device):
    truncated-normal projections and conv taps, zero biases, unit D and
    norm, and ``A_log = log(exp(U(log 1/4, log 4)))``."""
    d, di, n, nh, k = (cfg.d_model, cfg.d_inner, cfg.d_state,
                       cfg.ssm_heads, cfg.d_conv)
    pd, dev = cfg.pdtype, gen.device
    u = torch.rand(nh, generator=gen, device=dev, dtype=torch.float32)
    a_init = torch.exp(np.log(0.25) + u * (np.log(4.0) - np.log(0.25)))
    zeros = lambda c: torch.zeros(c, dtype=pd, device=dev)
    return SSM(
        wz=dense_init((d, di), gen, 0, pd), wx=dense_init((d, di), gen, 0, pd),
        wb=dense_init((d, n), gen, 0, pd), wc=dense_init((d, n), gen, 0, pd),
        wdt=dense_init((d, nh), gen, 0, pd), dt_bias=zeros(nh),
        conv_x=dense_init((k, di), gen, 0, pd), conv_x_b=zeros(di),
        conv_b=dense_init((k, n), gen, 0, pd), conv_b_b=zeros(n),
        conv_c=dense_init((k, n), gen, 0, pd), conv_c_b=zeros(n),
        A_log=torch.log(a_init).to(pd),
        D=torch.ones(nh, dtype=pd, device=dev),
        norm=torch.ones(di, dtype=pd, device=dev),
        wo=dense_init((di, d), gen, 0, pd))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` everywhere
    (``F.softplus`` switches to the identity above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(w: torch.Tensor, b: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv of width k as k shifted terms, summed in the
    reference's order. w: (k, c); b: (c,); x: (bsz, l, c)."""
    k, l = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = None
    for j in range(k):
        term = w[j] * pad[:, j:j + l]
        out = term if out is None else out + term
    return F.silu(out + b)


def ssm_forward(cfg: ArchConfig, p: SSM, u: torch.Tensor,
                return_state: bool = False):
    """u: (bsz, l, d) -> (bsz, l, d); with ``return_state`` also the
    decode cache ``{"s": the state after the last step (bsz, nh, n, dh)
    fp32, "cx", "cb", "cc": the last d_conv - 1 pre-conv rows of x, B, C
    (zeros before the first)}``.

    On a mesh's model axis (:class:`TensorParallel`) the rank computes
    its block of the SSD heads (:func:`rank_heads`): z, x, dt, the
    x conv, A, D and the scan on its heads, ``wz`` / ``wx`` / ``wdt``
    column-parallel, ``wo`` row-parallel (its partial output summed over
    ``model`` by :func:`tp_exit`). B and C are computed whole on every
    rank (:func:`tp_whole`, the replicated ``wb`` / ``wc`` and their
    convs) and enter the scan through :func:`tp_copy`; the gated norm
    normalises over all of d_inner (:func:`rmsnorm_split`)."""
    cdt, f32 = cfg.cdtype, torch.float32
    di, nh, dh = cfg.d_inner, cfg.ssm_heads, cfg.ssm_headdim
    lo, hi = rank_heads(nh)

    def own(w, per_head: int, dt, dim: int = -1):
        """This rank's heads along dimension ``dim`` of ``w``, in ``dt``."""
        return take_heads(w, dim, nh, per_head, lo, hi, dt)

    u = tp_whole(u.to(cdt))
    bsz, l, _ = u.shape
    us = tp_copy(u)
    z = us @ own(p.wz, dh, cdt)
    x_pre = us @ own(p.wx, dh, cdt)
    B_pre = u @ p.wb.to(cdt)
    C_pre = u @ p.wc.to(cdt)
    dt = softplus((us @ own(p.wdt, 1, cdt)).float() + own(p.dt_bias, 1, f32))
    x = _causal_conv(own(p.conv_x, dh, cdt), own(p.conv_x_b, dh, cdt), x_pre)
    B = tp_copy(_causal_conv(p.conv_b.to(cdt), p.conv_b_b.to(cdt), B_pre))
    C = tp_copy(_causal_conv(p.conv_c.to(cdt), p.conv_c_b.to(cdt), C_pre))
    A = -torch.exp(own(p.A_log, 1, f32))                        # (nh,)
    xh = x.reshape(bsz, l, hi - lo, dh)
    if return_state:
        y, state = ops.ssd_with_state(xh, dt, A, B, C, chunk=cfg.ssm_chunk)
    else:
        y = ops.ssd(xh, dt, A, B, C, chunk=cfg.ssm_chunk, work_dtype=cdt)
    y = y + own(p.D, 1, cdt)[None, None, :, None] * xh
    y = y.reshape(bsz, l, (hi - lo) * dh)
    y = rmsnorm_split(y * F.silu(z), own(p.norm, dh, f32), di)
    out = tp_exit(y @ own(p.wo, dh, cdt, dim=0))
    if not return_state:
        return out
    k = cfg.d_conv
    tail = lambda t: F.pad(t, (0, 0, k - 1, 0))[:, l:l + k - 1]
    return out, {"s": state, "cx": tail(x_pre), "cb": tail(B_pre),
                 "cc": tail(C_pre)}


def ssm_cache_shapes(cfg: ArchConfig, batch: int, dtype):
    """A Mamba-2 layer's cache leaves as ``{name: (shape, dtype)}``: the
    fp32 state and the conv tails in ``dtype``."""
    nh, n, dh, k = cfg.ssm_heads, cfg.d_state, cfg.ssm_headdim, cfg.d_conv
    return {"s": ((batch, nh, n, dh), torch.float32),
            "cx": ((batch, k - 1, cfg.d_inner), dtype),
            "cb": ((batch, k - 1, n), dtype), "cc": ((batch, k - 1, n), dtype)}


def ssm_init_cache(cfg: ArchConfig, batch: int, dtype, device="cuda"):
    """An empty decode cache (:func:`ssm_cache_shapes`)."""
    return cache_zeros(ssm_cache_shapes(cfg, batch, dtype), device)


def _conv_step(w: torch.Tensor, b: torch.Tensor,
               hist: torch.Tensor) -> torch.Tensor:
    """hist: (bsz, k, c) -> the conv output at the newest position."""
    return F.silu((hist * w[None]).sum(1) + b)


def ssm_decode(cfg: ArchConfig, p: SSM, u: torch.Tensor, cache):
    """One recurrent step. u: (bsz, 1, d) -> ((bsz, 1, d), cache): the
    state advances by s <- exp(dt A) s + dt B (x) x in fp32 and the conv
    tails shift by one row, both written into ``cache`` in place (the
    tails cast to its dtype).

    On a mesh's model axis the rank steps its SSD heads, as
    :func:`ssm_forward` splits them: the state's heads and the x conv
    tail's channels of d_inner are its own (``cache_specs`` splits them
    over ``model``; a leaf left whole is cut, and every rank writes the
    same bytes back into it), B, C and their tails are whole on every
    rank, the gated norm normalises over all of d_inner and ``wo`` is
    row-parallel."""
    cdt = cfg.cdtype
    bsz = u.shape[0]
    di, nh, dh = cfg.d_inner, cfg.ssm_heads, cfg.ssm_headdim
    lo, hi = rank_heads(nh)
    heads = (1, rank_ranges(nh))
    chans = (2, rank_ranges(nh, dh))

    def own(w, per_head: int, dt, dim: int = -1):
        return take_heads(w, dim, nh, per_head, lo, hi, dt)

    u1 = u.to(cdt)[:, 0]
    z = u1 @ own(p.wz, dh, cdt)
    tails = {"cx": cache_take(cache["cx"], 2, lo * dh, hi * dh),
             "cb": cache_local(cache["cb"]), "cc": cache_local(cache["cc"])}
    hist = [torch.cat([tails[c].to(cdt), (u1 @ w)[:, None]], 1)
            for c, w in (("cx", own(p.wx, dh, cdt)), ("cb", p.wb.to(cdt)),
                         ("cc", p.wc.to(cdt)))]
    x, B, C = (_conv_step(w, b, h) for w, b, h in zip(
        (own(p.conv_x, dh, cdt), p.conv_b.to(cdt), p.conv_c.to(cdt)),
        (own(p.conv_x_b, dh, cdt), p.conv_b_b.to(cdt), p.conv_c_b.to(cdt)),
        hist))
    dt = softplus((u1 @ own(p.wdt, 1, cdt)).float()
                  + own(p.dt_bias, 1, torch.float32))
    A = -torch.exp(own(p.A_log, 1, torch.float32))
    # the recurrence: s <- e^{dt A} s + dt B (outer) x; y = C . s
    decay = torch.exp(dt * A)                                    # (bsz, nh)
    xh = x.reshape(bsz, hi - lo, dh).float()
    upd = dt[..., None] * xh                                     # (bsz,nh,dh)
    s = decay[..., None, None] * cache_take(cache["s"], 1, lo, hi) + \
        B.float()[:, None, :, None] * upd[:, :, None, :]
    y = torch.einsum("bn,bhnd->bhd", C.float(), s)
    y = y + own(p.D, 1, torch.float32)[None, :, None] * xh
    y = y.reshape(bsz, (hi - lo) * dh).to(cdt)
    y = rmsnorm_split(y * F.silu(z), own(p.norm, dh, torch.float32), di)
    out = tp_exit(y @ own(p.wo, dh, cdt, dim=0))[:, None]
    cache_write(cache["s"], s, part=heads)
    cache_write(cache["cx"], hist[0][:, 1:], part=chans)
    for c, h in zip(("cb", "cc"), hist[1:]):
        cache_write(cache[c], h[:, 1:])
    return out, cache
