"""mamba2-1.3b [ssm]: 48L d_model=2048 (attention-free) vocab=50280,
ssm_state=128, SSD (state-space duality) [arXiv:2405.21060; unverified].

Mixer-only blocks (no MLP): d_inner = 2*d_model = 4096, headdim 64 ->
64 SSD heads per layer.
"""
from repro_torch.models import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab=50280, ssm=True, d_state=128, d_conv=4, expand=2,
    ssm_headdim=64, ssm_chunk=128,
)


def reduced() -> ArchConfig:
    return CONFIG.scaled(n_layers=4, d_model=128, vocab=512, d_state=32,
                         ssm_headdim=32, ssm_chunk=16,
                         notes="reduced smoke config")
