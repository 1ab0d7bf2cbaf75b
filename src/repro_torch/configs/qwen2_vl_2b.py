"""qwen2-vl-2b [vlm]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936. M-RoPE, dynamic resolution (the patch frontend is a stub:
the inputs carry precomputed patch embeddings) [arXiv:2409.12191; hf]."""
from repro_torch.models import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_ff=8960, vocab=151936, rope_theta=1e6, qkv_bias=True,
    mrope=True, mrope_sections=(16, 24, 24), n_patches=256,
)


def reduced() -> ArchConfig:
    return CONFIG.scaled(n_layers=4, d_model=128, n_heads=4, n_kv_heads=2,
                         d_ff=256, vocab=512, mrope_sections=(8, 4, 4),
                         n_patches=16, notes="reduced smoke config")
