"""llama3-8b [dense]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256. GQA, 128k vocab [arXiv:2407.21783; unverified]."""
from repro_torch.models import ArchConfig

CONFIG = ArchConfig(
    name="llama3-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=128256, rope_theta=5e5,
)


def reduced() -> ArchConfig:
    return CONFIG.scaled(n_layers=4, d_model=128, n_heads=8, n_kv_heads=2,
                         d_ff=256, vocab=512, notes="reduced smoke config")
