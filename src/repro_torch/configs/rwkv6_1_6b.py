"""rwkv6-1.6b [ssm]: 24L d_model=2048 (attention-free) d_ff=7168 vocab=65536.

Finch: data-dependent decay WKV recurrence (no attention).  [arXiv:2404.05892;
unverified]
"""
from .base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b", family="ssm",
        n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=7168, vocab_size=65536, head_dim=64,
        norm="layernorm", act="silu", use_rope=False,
        rwkv=True,
        tie_embeddings=False,
    )


def get_smoke_config() -> ModelConfig:
    return get_config().replace(
        name="rwkv6-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256)
