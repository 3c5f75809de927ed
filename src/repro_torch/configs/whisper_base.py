"""whisper-base [audio]: 6L d_model=512 8H (MHA kv=8) d_ff=2048 vocab=51865.

Encoder-decoder; the conv audio frontend is a STUB (the batch carries
precomputed frame embeddings (B, S_enc, d_model)).  [arXiv:2212.04356]
"""
from .base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base", family="audio",
        n_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
        d_ff=2048, vocab_size=51865, head_dim=64,
        norm="layernorm", act="gelu", use_rope=False,
        encoder_layers=6, frontend="audio",
        tie_embeddings=True,
    )


def get_smoke_config() -> ModelConfig:
    return get_config().replace(
        name="whisper-base-smoke", n_layers=2, encoder_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256)
