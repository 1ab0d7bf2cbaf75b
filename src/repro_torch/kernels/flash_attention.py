"""Flash attention forward: the plain version and the launcher of
``csrc/flash_attention.cu``.

Counterpart of ``repro.kernels.flash_attention``: online-softmax
attention as the NTX MAX+MAC streaming reduction, with GQA (``h // g``),
a runtime ``kv_len`` and the causal query position ``kv_len - sq + i``.
The CUDA kernel masks ragged sequence edges itself, so unlike the
Pallas kernel it takes any sq and skv.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import f32, mha

#: head dims the CUDA kernel is instantiated for
HEAD_DIMS = (64, 128)


def flash_attention_plain(q, k, v, *, causal: bool = True, scale=None,
                          kv_len: int | None = None) -> torch.Tensor:
    """Plain version: reference attention with query i at absolute
    position kv_len - sq + i (which also hides cache slots >= kv_len
    under causal masking)."""
    eff = k.shape[2] if kv_len is None else kv_len
    return mha(q, k, v, causal=causal, scale=scale,
               q_offset=eff - q.shape[2])


def flash_attention_cuda(q, k, v, *, causal: bool = True, scale=None,
                         kv_len: int | None = None) -> torch.Tensor:
    """Launch ``csrc/flash_attention.cu``. q: (b, hq, sq, d); k/v:
    (b, hkv, skv, d), all fp32 or all bf16, d in ``HEAD_DIMS``."""
    b, hq, sq, d = q.shape
    _, hkv, skv, dk = k.shape
    if k.shape != v.shape or dk != d or k.shape[0] != b or hq % hkv:
        raise ValueError(f"flash attention shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (
            torch.float32, torch.bfloat16):
        raise ValueError(f"flash attention takes fp32 or bf16 q/k/v, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    kv_len = skv if kv_len is None else int(kv_len)
    scale = (d ** -0.5) if scale is None else scale
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    lib = _build.library()
    with torch.cuda.device(q.device):
        code = lib.ntx_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, hq,
            hkv, sq, skv, d, kv_len, int(causal), f32(scale),
            int(q.dtype == torch.bfloat16), _build.stream_of(q))
    _build.check(code, "ntx_flash_attention")
    return o
