"""Mamba-2 block (SSD): projections, causal conv, the SSD scan, gated
output.

Counterpart of ``repro.models.ssm`` (the training forward). The SSD scan
runs through ``ops.ssd``: the CUDA kernel on the card, its plain version
on the CPU. As in the reference, the projections z, x, B, C and dt are
separate, a width-``d_conv`` depthwise causal conv runs over x, B and C,
A is a scalar decay per head and the output is RMSNorm-gated. The
serving half (``return_state``, the recurrent cache, single-token
decode) comes with the SSM serving slice (ROADMAP queue 1, item 10).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from .common import ArchConfig, _param, dense_init, rmsnorm


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


def _project(cfg: ArchConfig, p: SSM, u: torch.Tensor):
    cdt = cfg.cdtype
    z = u @ p.wz.to(cdt)
    x = u @ p.wx.to(cdt)
    B = u @ p.wb.to(cdt)
    C = u @ p.wc.to(cdt)
    dt = softplus((u @ p.wdt.to(cdt)).float() + p.dt_bias.float())
    return z, x, B, C, dt


def ssm_forward(cfg: ArchConfig, p: SSM, u: torch.Tensor,
                return_state: bool = False) -> torch.Tensor:
    """u: (bsz, l, d) -> (bsz, l, d)."""
    if return_state:
        raise NotImplementedError(
            "SSM prefill with a recurrent cache comes with SSM serving "
            "(ROADMAP queue 1, item 10)")
    cdt = cfg.cdtype
    bsz, l, _ = u.shape
    di, nh, dh = cfg.d_inner, cfg.ssm_heads, cfg.ssm_headdim
    u = u.to(cdt)
    z, x_pre, B_pre, C_pre, dt = _project(cfg, p, u)
    x = _causal_conv(p.conv_x.to(cdt), p.conv_x_b.to(cdt), x_pre)
    B = _causal_conv(p.conv_b.to(cdt), p.conv_b_b.to(cdt), B_pre)
    C = _causal_conv(p.conv_c.to(cdt), p.conv_c_b.to(cdt), C_pre)
    A = -torch.exp(p.A_log.float())                             # (nh,)
    xh = x.reshape(bsz, l, nh, dh)
    y = ops.ssd(xh, dt, A, B, C, chunk=cfg.ssm_chunk, work_dtype=cdt)
    y = y + p.D.to(cdt)[None, None, :, None] * xh
    y = y.reshape(bsz, l, di)
    y = rmsnorm(y * F.silu(z), p.norm)
    return y @ p.wo.to(cdt)


def ssm_init_cache(cfg: ArchConfig, batch: int, dtype, device="cuda"):
    raise NotImplementedError("the SSM decode cache comes with SSM serving "
                              "(ROADMAP queue 1, item 10)")


def ssm_decode(cfg: ArchConfig, p: SSM, u: torch.Tensor, cache):
    raise NotImplementedError("SSM single-token decode comes with SSM "
                              "serving (ROADMAP queue 1, item 10)")
