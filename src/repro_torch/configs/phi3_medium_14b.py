"""phi3-medium-14b [dense]: 40L d_model=5120 40H (GQA kv=10) d_ff=17920
vocab=100352. RoPE SwiGLU GQA [arXiv:2404.14219; unverified]."""
from repro_torch.models import ArchConfig

CONFIG = ArchConfig(
    name="phi3-medium-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10,
    d_ff=17920, vocab=100352, rope_theta=1e4,
    grad_accum=4,
)


def reduced() -> ArchConfig:
    return CONFIG.scaled(n_layers=4, d_model=160, n_heads=8, n_kv_heads=2,
                         d_ff=320, vocab=512, notes="reduced smoke config")
