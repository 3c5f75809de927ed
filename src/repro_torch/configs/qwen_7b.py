"""Qwen2-7B-class GQA: the paper's GQA evaluation model.  [arXiv:2309.16609]"""
from .base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="qwen-7b", family="dense",
        n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
        d_ff=18944, vocab_size=152064, head_dim=128,
        norm="rmsnorm", act="silu", rope_theta=1_000_000.0,
        tie_embeddings=False,
    )


def get_smoke_config() -> ModelConfig:
    return get_config().replace(
        name="qwen-7b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256)
