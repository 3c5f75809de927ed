"""granite-8b [dense]: 36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152.

Llama-architecture code model.  [arXiv:2405.04324; hf]
"""
from .base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="granite-8b", family="dense",
        n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab_size=49152, head_dim=128,
        norm="rmsnorm", act="silu", rope_theta=10_000.0,
        tie_embeddings=False,
    )


def get_smoke_config() -> ModelConfig:
    return get_config().replace(
        name="granite-8b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256)
