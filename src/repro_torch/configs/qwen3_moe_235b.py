"""qwen3-moe-235b-a22b [moe]: 94L d_model=4096 64H (GQA kv=4) d_ff=1536
vocab=151936, 128 experts top-8, QK-norm.  [hf:Qwen/Qwen3-30B-A3B; hf]
"""
from .base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b", family="moe",
        n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4,
        d_ff=1536, vocab_size=151936, head_dim=128,
        norm="rmsnorm", act="silu", rope_theta=1_000_000.0,
        qk_norm=True, moe_experts=128, moe_top_k=8,
        tie_embeddings=False,
    )


def get_smoke_config() -> ModelConfig:
    return get_config().replace(
        name="qwen3-moe-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=32, vocab_size=256,
        moe_experts=8, moe_top_k=2)
