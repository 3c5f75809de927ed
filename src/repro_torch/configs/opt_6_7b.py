"""OPT-6.7B: the paper's MHA evaluation model.  [arXiv:2205.01068]"""
from .base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="opt-6.7b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
        d_ff=16384, vocab_size=50272, head_dim=128,
        norm="layernorm", act="gelu", use_rope=False,
        tie_embeddings=True,
    )


def get_smoke_config() -> ModelConfig:
    return get_config().replace(
        name="opt-6.7b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256)
