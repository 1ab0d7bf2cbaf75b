"""AdamW built from the NTX elementwise command set, the counterpart of
``repro.optim.adamw``.

Mixed precision as in the reference: the stored params may be bf16 (the
compute copy); the optimizer state carries the fp32 master plus the fp32
moments m and v and a host step counter. Parameters, gradients and each
part of the state are mappings from a parameter's name
(``module.named_parameters()``) to a tensor, so updates are per tensor
and the state converts to the reference's stacked tree with
``models.convert.to_reference``.

Scalars are fp32, as the reference computes them: ``lr_schedule``, the
bias corrections and the global norm are fp32 tensors (the first two on
the CPU, from the host step, so the fused kernel takes them as launch
arguments without waiting for the card).

``use_fused=True`` sends every 2-D tensor through ``ops.adamw_update``
(the ``csrc/ntx_adamw.cu`` kernel on the card), as the reference sends
its 2-D leaves to ``adamw_pallas``. The reference stacks layer weights
per kind, so its 2-D leaves are the embeddings and the stacked vectors;
here every layer's weight matrices are 2-D and take the kernel while the
per-layer vectors take the plain path. The two paths differ only by
rounding (the kernel multiplies by the reciprocal bias corrections).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Tuple

import torch

from repro_torch.kernels import ops

Named = Mapping[str, torch.Tensor]
_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay, an fp32 0-d CPU tensor."""
    step = torch.as_tensor(step, dtype=_F32)
    warm = step / max(cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params: Named) -> dict:
    """fp32 master copy and zero moments per parameter, step 0."""
    with torch.no_grad():
        master = {n: p.detach().to(_F32, copy=True)
                  for n, p in params.items()}
        return {"master": master,
                "m": {n: torch.zeros_like(p) for n, p in master.items()},
                "v": {n: torch.zeros_like(p) for n, p in master.items()},
                "step": 0}


def global_norm(grads: Named) -> torch.Tensor:
    leaves = [torch.sum(g.float() ** 2) for g in grads.values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(grads: Named,
                        max_norm: float) -> Tuple[Dict[str, torch.Tensor],
                                                  torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-12), max=1.0)
    return {n: g.float() * scale for n, g in grads.items()}, norm


def apply_updates(cfg: AdamWConfig, params: Named, grads: Named,
                  state: dict, use_fused: bool = False, gnorm=None):
    """One AdamW step. Returns ``(new_params, new_state)``: new tensors
    (params in their storage dtype), nothing updated in place. Gradients
    may be in any float dtype; each is clipped (``clip_by_global_norm``'s
    fp32 ``g * scale``) as its tensor is updated, so no second copy of
    all the gradients is held. ``gnorm``: the global norm, where the
    gradients given are blocks of the whole (a mesh step sums it over
    every block); by default ``global_norm(grads)``."""
    step = int(state["step"]) + 1
    lr = lr_schedule(cfg, step)
    b1, b2, eps, wd = cfg.b1, cfg.b2, cfg.eps, cfg.weight_decay
    stepf = torch.tensor(step, dtype=_F32)
    bc1 = 1.0 - torch.tensor(b1, dtype=_F32) ** stepf
    bc2 = 1.0 - torch.tensor(b2, dtype=_F32) ** stepf
    master, new_m, new_v = {}, {}, {}
    with torch.no_grad():
        if gnorm is None:
            gnorm = global_norm(grads)
        scale = torch.clamp(cfg.grad_clip / torch.clamp_min(gnorm, 1e-12),
                            max=1.0)
        for n, pm in state["master"].items():
            g, m, v = grads[n].float() * scale, state["m"][n], state["v"][n]
            if use_fused and pm.ndim == 2:
                pm, m, v = ops.adamw_update(pm, g, m, v, step, lr=lr, b1=b1,
                                            b2=b2, eps=eps, wd=wd)
            else:
                m = b1 * m + (1 - b1) * g
                v = b2 * v + (1 - b2) * g * g
                mhat = m / bc1
                vhat = v / bc2
                pm = pm - lr * (mhat / (torch.sqrt(vhat) + eps) + wd * pm)
            master[n], new_m[n], new_v[n] = pm, m, v
        new_params = {n: master[n].to(p.dtype) for n, p in params.items()}
    return new_params, {"master": master, "m": new_m, "v": new_v,
                        "step": step}
