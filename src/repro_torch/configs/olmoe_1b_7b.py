"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (MHA kv=16) d_ff=1024 vocab=50304,
64 experts top-8.  [arXiv:2409.02060; hf]
"""
from .base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b", family="moe",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1024, vocab_size=50304, head_dim=128,
        norm="rmsnorm", act="silu", rope_theta=10_000.0,
        moe_experts=64, moe_top_k=8,
        tie_embeddings=False,
    )


def get_smoke_config() -> ModelConfig:
    return get_config().replace(
        name="olmoe-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=32, vocab_size=256,
        moe_experts=8, moe_top_k=2)
