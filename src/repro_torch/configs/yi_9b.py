"""yi-9b [dense]: 48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.

Llama-architecture GQA [arXiv:2403.04652; hf].
"""
from repro_torch.models import ArchConfig

CONFIG = ArchConfig(
    name="yi-9b", family="dense",
    n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4,
    d_ff=11008, vocab=64000, rope_theta=5e6,
)


def reduced() -> ArchConfig:
    return CONFIG.scaled(n_layers=4, d_model=128, n_heads=8, n_kv_heads=2,
                         d_ff=256, vocab=512, notes="reduced smoke config")
