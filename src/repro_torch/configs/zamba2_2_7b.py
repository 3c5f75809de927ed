"""zamba2-2.7b [hybrid]: 54L d_model=2560 32H (MHA kv=32) d_ff=10240
vocab=32000, ssm_state=64.  Mamba2 backbone with a SHARED-WEIGHT attention
block applied every 6th layer (weight sharing across applications).
[arXiv:2411.15242; hf]
"""
from .base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b", family="hybrid",
        n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
        d_ff=10240, vocab_size=32000, head_dim=80,
        norm="rmsnorm", act="gelu",
        ssm_state=64, ssm_expand=2, ssm_conv=4,
        shared_attn_every=6,
        tie_embeddings=True,
    )


def get_smoke_config() -> ModelConfig:
    return get_config().replace(
        name="zamba2-2.7b-smoke", n_layers=6, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256,
        ssm_state=16, shared_attn_every=3)
