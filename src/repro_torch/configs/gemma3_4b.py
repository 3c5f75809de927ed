"""gemma3-4b [dense]: 34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144.

5:1 local:global attention (every 6th layer global, rest sliding-window),
128k context, QK-norm.  [hf:google/gemma-3-1b-pt; unverified]
"""
from .base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b", family="dense",
        n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4,
        d_ff=10240, vocab_size=262144, head_dim=256,
        norm="rmsnorm", act="gelu", rope_theta=1_000_000.0,
        qk_norm=True, sliding_window=1024, global_every=6,
        tie_embeddings=True, max_seq=131_072,
    )


def get_smoke_config() -> ModelConfig:
    return get_config().replace(
        name="gemma3-4b-smoke", n_layers=6, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
        sliding_window=32, global_every=3)
