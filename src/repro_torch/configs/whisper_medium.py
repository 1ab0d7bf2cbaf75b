"""whisper-medium [audio]: 24L d_model=1024 16H d_ff=4096 vocab=51865.

Encoder-decoder; the conv frontend is a stub (the inputs carry
precomputed frame embeddings) [arXiv:2212.04356; unverified]. 24 encoder
+ 24 decoder layers, LayerNorm + GELU, no RoPE (sinusoidal positions).
"""
from repro_torch.models import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=51865,
    encoder_decoder=True, n_enc_layers=24, enc_seq=1500,
    norm="layernorm", act="gelu",
)


def reduced() -> ArchConfig:
    return CONFIG.scaled(n_layers=2, n_enc_layers=2, d_model=128, n_heads=4,
                         n_kv_heads=4, d_ff=256, vocab=512, enc_seq=64,
                         notes="reduced smoke config")
