"""Workload descriptions consumed by the dataflow models: a copy of the JAX
package's core/workloads.py (framework-free; the port imports nothing of
the JAX package), for the port's 3D-Flow simulator (core/simulator.py)
and the paper-workload phase of chip_smoke.py.  from_model_config takes
the port's ModelConfig (repro_torch/configs/base.py).

The paper evaluates *attention computation* (Figs 5-7) on OPT (MHA) and Qwen
(GQA) at sequence lengths 1K-64K, and end-to-end inference energy (Table II,
"overall energy") which additionally includes the projection / FFN GEMMs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable


@dataclass(frozen=True)
class AttentionWorkload:
    """One attention *core* (S = QK^T, softmax, PV) for a full model forward.

    Sizes are per-forward over `seq` tokens (prefill-style, as in the paper's
    inference evaluation).
    """

    name: str
    seq: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    n_layers: int
    batch: int = 1

    @property
    def group_size(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def total_head_instances(self) -> float:
        return float(self.n_heads * self.n_layers * self.batch)

    # exact op counts (per full forward, all layers/heads)
    @property
    def qk_macs(self) -> float:
        return self.total_head_instances * self.seq * self.seq * self.head_dim

    @property
    def pv_macs(self) -> float:
        return self.total_head_instances * self.seq * self.seq * self.head_dim

    @property
    def softmax_elems(self) -> float:
        return self.total_head_instances * self.seq * self.seq


@dataclass(frozen=True)
class ModelWorkload:
    """Full transformer forward: attention cores + projection/FFN GEMMs."""

    name: str
    attn: AttentionWorkload
    d_model: int
    d_ff: int
    vocab: int = 0
    # MoE: number of active experts' worth of FFN compute (top_k), 0 = dense
    moe_top_k: int = 0
    moe_experts: int = 0

    @property
    def proj_macs(self) -> float:
        """QKV + output projection MACs for the whole forward."""
        a = self.attn
        d_head_total_q = a.n_heads * a.head_dim
        d_head_total_kv = a.n_kv_heads * a.head_dim
        per_tok = (self.d_model * d_head_total_q            # Q
                   + 2 * self.d_model * d_head_total_kv     # K, V
                   + d_head_total_q * self.d_model)         # O
        return per_tok * a.seq * a.batch * a.n_layers

    @property
    def ffn_macs(self) -> float:
        a = self.attn
        mult = self.moe_top_k if self.moe_top_k else 1
        # gated-MLP (3 matmuls) for modern archs; OPT-style 2-matmul handled
        # as d_ff already folded.  Use 3 matmuls uniformly: up, gate, down.
        per_tok = 3 * self.d_model * self.d_ff * mult
        return per_tok * a.seq * a.batch * a.n_layers

    @property
    def weight_bytes(self) -> float:
        a = self.attn
        d_q = a.n_heads * a.head_dim
        d_kv = a.n_kv_heads * a.head_dim
        attn_w = self.d_model * (2 * d_q + 2 * d_kv)
        n_ffn = self.moe_experts if self.moe_experts else 1
        ffn_w = 3 * self.d_model * self.d_ff * n_ffn
        return (attn_w + ffn_w) * a.n_layers * 2.0  # bf16


# ---------------------------------------------------------------------------
# Paper workloads
# ---------------------------------------------------------------------------

def opt_6_7b(seq: int) -> ModelWorkload:
    """OPT-6.7B: MHA, 32 layers, 32 heads, d_head 128, d_ff 4*d_model."""
    attn = AttentionWorkload("opt-6.7b", seq=seq, n_heads=32, n_kv_heads=32,
                             head_dim=128, n_layers=32)
    return ModelWorkload("opt-6.7b", attn, d_model=4096, d_ff=16384,
                         vocab=50272)


def qwen_7b(seq: int) -> ModelWorkload:
    """Qwen2-7B-class GQA: 28 layers, 28 heads / 4 KV heads, d_head 128."""
    attn = AttentionWorkload("qwen-7b", seq=seq, n_heads=28, n_kv_heads=4,
                             head_dim=128, n_layers=28)
    return ModelWorkload("qwen-7b", attn, d_model=3584, d_ff=18944,
                         vocab=152064)


PAPER_MODELS = {"opt-6.7b": opt_6_7b, "qwen-7b": qwen_7b}
PAPER_SEQS = (1024, 4096, 16384, 65536)


def paper_grid() -> Iterable[ModelWorkload]:
    for mk in PAPER_MODELS.values():
        for s in PAPER_SEQS:
            yield mk(s)


def from_model_config(cfg, seq: int, batch: int = 1) -> AttentionWorkload:
    """Build an attention workload from a repro_torch.configs ModelConfig."""
    n_kv = getattr(cfg, "n_kv_heads", cfg.n_heads) or cfg.n_heads
    return AttentionWorkload(
        name=cfg.name, seq=seq, n_heads=cfg.n_heads, n_kv_heads=n_kv,
        head_dim=cfg.head_dim, n_layers=cfg.n_layers, batch=batch)
