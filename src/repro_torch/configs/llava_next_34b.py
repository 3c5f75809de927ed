"""llava-next-34b [vlm]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.

The AnyRes tiling vision frontend is a stub, as in the JAX package: the
batch carries precomputed patch embeddings (B, frontend_tokens, d_model),
which the model puts in front of the text tokens.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
"""
from .base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b", family="vlm",
        n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
        d_ff=20480, vocab_size=64000, head_dim=128,
        norm="rmsnorm", act="silu", rope_theta=5_000_000.0,
        tie_embeddings=False,
        frontend="vision", frontend_tokens=576,
    )


def get_smoke_config() -> ModelConfig:
    return get_config().replace(
        name="llava-next-34b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
        frontend_tokens=8)
