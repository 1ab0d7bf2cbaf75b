"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H d_ff=1408(expert)
vocab=102400, MLA kv_lora=512, MoE 64 routed top-6 + 2 shared
[arXiv:2405.04434; hf]. 64 routed experts, as the HF config and the
paper's table give them."""
from repro_torch.models import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=102400, rope_theta=1e4,
    moe=True, n_experts=64, n_shared_experts=2, top_k=6, d_ff_expert=1408,
    mla=True, kv_lora_rank=512, rope_head_dim=64, nope_head_dim=128,
    v_head_dim=128, grad_accum=4, prefill_microbatch=2,
)


def reduced() -> ArchConfig:
    return CONFIG.scaled(n_layers=3, d_model=128, n_heads=4, n_kv_heads=4,
                         d_ff=64, vocab=512, n_experts=8, top_k=2,
                         d_ff_expert=64, n_shared_experts=1, kv_lora_rank=64,
                         rope_head_dim=16, nope_head_dim=32, v_head_dim=32,
                         notes="reduced smoke config")
