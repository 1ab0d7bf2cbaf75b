"""Mixture-of-Experts FFN with sort-based, static-shape dispatch.

Counterpart of ``repro.models.moe``: top-k softmax gating, first-wins
capacity dropping (``_capacity`` slots per expert and sequence), the
Switch-style load-balance auxiliary loss, a scatter of each group's
tokens into per-expert capacity buffers, the expert FFNs as batched
products over the expert axis, and a scatter-add combine. Each batch row
is one routing group, as in the reference. The bits that decide which
tokens are dropped follow the reference exactly: the routing logits are
fp32 after the product in the compute dtype; ``jax.lax.top_k`` takes
ties in index order (here a stable descending sort); ``jnp.argsort`` is
stable; segment starts are ``searchsorted(side="left")``; dropped
entries go to the slot ``e * cap`` of a buffer of ``e * cap + 1`` rows.
The expert and shared-expert products are plain einsum / matmul, as the
reference leaves them to XLA. Training differentiates all of it with
PyTorch autograd, as the reference takes ``jax.grad``: the gate's
gradient reaches the probabilities through the top-k values and the
renormalisation, the drop slot's row is cut off before the experts and
takes no gradient, and the aux loss's top-1 counts (a one-hot) take
none either.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import (MLP, ArchConfig, _param, dense_init, shard_range,
                     tp_copy, tp_exit, tp_state, tp_whole)


class MoE(nn.Module):
    """The router (d, e), the stacked experts w1 / w3 (e, d, ffe) and w2
    (e, ffe, d), and the shared experts (an :class:`MLP` of width ffe x
    n_shared, or None)."""

    def __init__(self, router, w1, w2, w3, shared: Optional[MLP] = None):
        super().__init__()
        self.router = _param(router)
        self.w1, self.w2, self.w3 = _param(w1), _param(w2), _param(w3)
        self.shared = shared


def moe_params(cfg: ArchConfig, gen: torch.Generator) -> MoE:
    d, ffe, e = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    init = lambda shape, axis: dense_init(shape, gen, axis, cfg.pdtype)
    shared = None
    if cfg.n_shared_experts:
        ff_sh = ffe * cfg.n_shared_experts
        shared = MLP(init((d, ff_sh), 0), init((ff_sh, d), 0),
                     init((d, ff_sh), 0))
    return MoE(init((d, e), 0), init((e, d, ffe), 1), init((e, ffe, d), 1),
               init((e, d, ffe), 1), shared)


def _capacity(cfg: ArchConfig, s: int) -> int:
    c = int(cfg.top_k * s * cfg.capacity_factor / cfg.n_experts)
    return max(cfg.top_k, c)


def route(cfg: ArchConfig, p: MoE, x: torch.Tensor):
    """Routing of x (b, s, d) in the compute dtype: ``(probs (b, s, e)
    fp32, gate (b, s, k) renormalised, expert (b, s, k))``, the top k
    in descending order with ties taken in index order."""
    logits = (x @ p.router.to(x.dtype)).float()
    probs = torch.softmax(logits, -1)
    top = torch.sort(probs, stable=True, dim=-1, descending=True)
    gate = top.values[..., :cfg.top_k]
    expert = top.indices[..., :cfg.top_k]
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    return probs, gate, expert


def apply_moe(cfg: ArchConfig, p: MoE,
              x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (b, s, d) -> (y, aux_loss). Groups = batch rows.

    On a mesh's model axis (:class:`TensorParallel`, experts sharded over
    ``model``) every rank routes the whole data-local token set alike
    (:func:`tp_whole`; the router is replicated), so the capacity slots
    and the dropped tokens are the single device's, and computes the aux
    loss whole. It fills the capacity buffers of its own experts
    (``shard_range(n_experts)``, their stored block) and runs their
    products; the tokens and the gates enter through :func:`tp_copy`, so
    the router's gradient through the gates is summed over ``model``
    while the aux loss's is counted once. Its experts' outputs, with the
    shared experts' partial (a tensor-parallel MLP), are summed over
    ``model`` by one :func:`tp_exit`."""
    dt = cfg.cdtype
    tp = tp_state()
    x = tp_whole(x.to(dt))
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    lo, hi = (0, e) if tp is None else shard_range(e, tp.nm, tp.rank)
    ne = hi - lo
    cap = _capacity(cfg, s)
    probs, gate, expert = route(cfg, p, x)

    # load-balance aux loss (Switch-style): e * sum_e f_e * p_e, f_e from
    # the top-1 expert only
    me = probs.mean(1)                                          # (b, e)
    ce = F.one_hot(expert[..., 0], e).float().mean(1)
    aux = (me * ce).sum(-1).mean() * e
    xs, gate = tp_copy(x), tp_copy(gate)

    # dispatch: sort each group's (token, choice) entries by expert
    flat_e = expert.reshape(b, s * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    e_sorted = torch.take_along_dim(flat_e, order, -1)
    tok_sorted = order // k                                     # source token
    gate_sorted = torch.take_along_dim(gate.reshape(b, s * k), order, -1)

    # each sorted entry's position in its expert's capacity buffer; the
    # rank keeps the entries of its experts
    arange_e = torch.arange(e, device=x.device).expand(b, e).contiguous()
    seg_start = torch.searchsorted(e_sorted, arange_e, side="left")
    pos_in_e = (torch.arange(s * k, device=x.device)[None]
                - torch.take_along_dim(seg_start, e_sorted, -1))
    keep = (pos_in_e < cap) & (e_sorted >= lo) & (e_sorted < hi)
    drop = torch.full_like(e_sorted, ne * cap)
    slot = torch.where(keep, (e_sorted - lo) * cap + pos_in_e, drop)

    # gather tokens into (b, ne * cap, d) expert buffers; dropped entries
    # (and other ranks' experts') land on the extra row, which is cut off
    src = torch.take_along_dim(xs, tok_sorted[..., None], 1)    # (b, sk, d)
    rows = torch.arange(b, device=x.device)[:, None] * (ne * cap + 1) + slot
    buf = x.new_zeros((b * (ne * cap + 1), d))
    buf[rows.reshape(-1)] = src.reshape(-1, d)
    buf = buf.view(b, ne * cap + 1, d)[:, :ne * cap].reshape(b, ne, cap, d)

    # expert FFN (batched products over the expert axis)
    h = (F.silu(torch.einsum("becd,edf->becf", buf, p.w1.to(dt)))
         * torch.einsum("becd,edf->becf", buf, p.w3.to(dt)))
    y_e = torch.einsum("becf,efd->becd", h, p.w2.to(dt))
    y_flat = torch.cat([y_e.reshape(b, ne * cap, d),
                        x.new_zeros((b, 1, d))], 1)

    # combine: gather back, weight, scatter-add onto each source token
    out_tok = torch.take_along_dim(y_flat, slot[..., None], 1)  # (b, sk, d)
    out_tok = out_tok * (gate_sorted * keep).to(dt)[..., None]
    y = x.new_zeros((b * s, d))
    tok_rows = torch.arange(b, device=x.device)[:, None] * s + tok_sorted
    y.index_add_(0, tok_rows.reshape(-1), out_tok.reshape(-1, d))
    y = y.view(b, s, d)

    if p.shared is not None:
        sh = p.shared
        hs = F.silu(xs @ sh.w1.to(dt)) * (xs @ sh.w3.to(dt))
        y = y + hs @ sh.w2.to(dt)
    return tp_exit(y), aux.float()
