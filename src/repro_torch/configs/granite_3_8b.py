"""granite-3-8b [dense]: 40L d_model=4096 32H (GQA kv=8) d_ff=12800
vocab=49155. GQA [hf:ibm-granite/granite-3.0-2b-base; hf]."""
from repro_torch.models import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-8b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=12800, vocab=49155, rope_theta=1e4,
)


def reduced() -> ArchConfig:
    return CONFIG.scaled(n_layers=4, d_model=128, n_heads=8, n_kv_heads=2,
                         d_ff=256, vocab=512, notes="reduced smoke config")
