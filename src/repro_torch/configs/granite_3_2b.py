"""granite-3-2b [dense]: 40L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=49155.

GQA llama-family dense decoder.  [hf:ibm-granite/granite-3.0-2b-base; hf]
"""
from .base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-2b", family="dense",
        n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8,
        d_ff=8192, vocab_size=49155, head_dim=64,
        norm="rmsnorm", act="silu", rope_theta=10_000.0,
        tie_embeddings=True,
    )


def get_smoke_config() -> ModelConfig:
    return get_config().replace(
        name="granite-3-2b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256)
