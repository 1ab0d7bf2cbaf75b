"""phi3.5-moe-42b-a6.6b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=6400
vocab=32064, MoE 16 experts top-2 [hf:microsoft/Phi-3.5-MoE-instruct; hf]."""
from repro_torch.models import ArchConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=6400, vocab=32064, rope_theta=1e4,
    moe=True, n_experts=16, top_k=2, d_ff_expert=6400,
    grad_accum=8, prefill_microbatch=8,
)


def reduced() -> ArchConfig:
    return CONFIG.scaled(n_layers=4, d_model=128, n_heads=8, n_kv_heads=2,
                         d_ff=128, vocab=512, n_experts=4, top_k=2,
                         d_ff_expert=128, notes="reduced smoke config")
