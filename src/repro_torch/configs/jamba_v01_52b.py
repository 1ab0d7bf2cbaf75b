"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2, Mamba+attention 1:7 interleave
[arXiv:2403.19887; hf].

Period-8 layer schedule: attention at position 4, mamba elsewhere; MoE FFN
on odd positions (16 of 32 layers), dense FFN on even. Jamba's mamba blocks
use d_state=16.
"""
from repro_torch.models import ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=65536, rope_theta=1e4,
    moe=True, n_experts=16, top_k=2, d_ff_expert=14336, moe_every=2,
    moe_offset=1,
    ssm=True, d_state=16, d_conv=4, expand=2, ssm_headdim=64, ssm_chunk=128,
    attn_period=8, attn_offset=4,
    grad_accum=16, prefill_microbatch=8,
)


def reduced() -> ArchConfig:
    return CONFIG.scaled(n_layers=16, d_model=128, n_heads=4, n_kv_heads=2,
                         d_ff=256, vocab=512, n_experts=4, top_k=2,
                         d_ff_expert=256, d_state=16, ssm_headdim=32,
                         ssm_chunk=16, notes="reduced smoke config")
