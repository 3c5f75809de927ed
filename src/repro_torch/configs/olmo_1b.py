"""olmo-1b [dense]: 16L d_model=2048 16H (MHA kv=16) d_ff=8192 vocab=50304.

Non-parametric LayerNorm (no learned scale/bias).  [arXiv:2402.00838; hf]
"""
from .base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b", family="dense",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=8192, vocab_size=50304, head_dim=128,
        norm="nonparam_ln", act="silu", rope_theta=10_000.0,
        tie_embeddings=True,
    )


def get_smoke_config() -> ModelConfig:
    return get_config().replace(
        name="olmo-1b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256)
