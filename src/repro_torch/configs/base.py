"""Model and serve configuration dataclasses for the PyTorch port.

The port keeps its own copy of the configuration schema: the field names,
defaults and validation rules are those of the JAX package.  ModelConfig
carries the fields of the families the port runs - dense, hybrid (Mamba2
with a shared attention block) and ssm (RWKV6); the MoE, encoder-decoder
and frontend fields come with those families (ROADMAP M13).  ServeConfig
carries every field, so one set of keyword arguments builds either
package's serve config, and the engine refuses the settings it does not
serve yet.  TrainConfig is a copy of the
JAX package's, field for field.  Mesh and shape configs arrive with the
slices that need them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads

    # --- numerics / layers -------------------------------------------------
    norm: str = "rmsnorm"       # rmsnorm | layernorm | nonparam_ln
    act: str = "silu"           # silu | gelu
    dtype: str = "bfloat16"
    tie_embeddings: bool = True
    qk_norm: bool = False       # gemma3-style per-head RMS norm of q and k

    # --- position / attention pattern --------------------------------------
    rope_theta: float = 10_000.0
    rope_scaling: float = 1.0
    sliding_window: int = 0     # 0 = full attention
    global_every: int = 0       # gemma3: every Nth layer is global, rest local
    attn_logit_softcap: float = 0.0
    use_rope: bool = True

    # --- SSM (Mamba2) --------------------------------------------------------
    ssm_state: int = 0
    ssm_heads: int = 0          # 0 -> derived
    ssm_expand: int = 2
    ssm_conv: int = 4

    # --- hybrid (zamba2) ---------------------------------------------------
    shared_attn_every: int = 0  # one shared attn block every k ssm blocks

    # --- RWKV --------------------------------------------------------------
    rwkv: bool = False

    max_seq: int = 524_288

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_heads % max(self.n_kv_heads, 1):
            raise ValueError(
                f"{self.name}: n_heads must be divisible by n_kv_heads")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks), the JAX
        package's formula for the families the port carries (its MoE and
        encoder-decoder terms come with those families)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim
        attn = d * (self.n_heads * hd) * 2 + d * (self.n_kv_heads * hd) * 2
        n_ffn_mats = 3 if self.act == "silu" else 2
        if self.rwkv:
            per_layer = d * d * 4 + d * f * 2 + 10 * d
        elif self.family in ("ssm", "hybrid"):
            # Mamba2 block: in_proj (z, x, B, C, dt), depthwise conv,
            # out_proj; zamba2-style hybrids put the MLP only in the shared
            # attention block
            d_in = self.ssm_expand * d
            per_layer = d * (2 * d_in + 2 * self.ssm_state) + d_in * d
        else:
            per_layer = attn + n_ffn_mats * d * f
        total = self.n_layers * per_layer \
            + v * d * (1 if self.tie_embeddings else 2)
        if self.shared_attn_every:
            total += attn + n_ffn_mats * d * f
        return int(total)

    def active_param_count(self) -> int:
        """Parameters touched per token: all of them for every family the
        port carries (MoE, where it differs, is not ported)."""
        return self.param_count()


@dataclass(frozen=True)
class TrainConfig:
    global_batch: int = 256
    seq_len: int = 4096
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    checkpoint_every: int = 50
    checkpoint_dir: str = "/tmp/repro_ckpt"
    keep_checkpoints: int = 3
    remat: str = "none"         # none | full | dots
    grad_compression: str = ""  # "" | int8
    seed: int = 0
    log_every: int = 10


def pages_for_tokens(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold n_tokens (ceil-div, >= 1)."""
    if page_size < 1:
        raise ValueError(f"page_size must be >= 1, got {page_size}")
    return max(1, -(-n_tokens // page_size))


def dense_equivalent_pages(batch: int, max_len: int, page_size: int) -> int:
    """Pool size matching dense capacity, plus the reserved null page 0."""
    return batch * pages_for_tokens(max_len, page_size) + 1


@dataclass(frozen=True)
class ServeConfig:
    """Serving knobs, field for field those of the JAX package (see its
    configs/base.py for the meaning of each).  The port's engine serves
    every path but request deadlines (default_deadline_tokens), the span
    tracer (telemetry) and tensor parallelism (tp_degree > 1), which it
    refuses at construction (serve/engine.py)."""
    max_batch: int = 8
    max_seq: int = 4096
    prefill_chunk: int = 512
    max_new_tokens: int = 64
    temperature: float = 0.0    # 0 = greedy
    seed: int = 0
    top_k: int = 0
    top_p: float = 1.0
    eos_id: Optional[int] = None

    chunked: bool = False
    tick_token_budget: int = 0
    admission_policy: str = "fifo"   # fifo | sjf
    max_chunks_per_tick: int = 0
    batched: bool = True

    decode_priority: bool = False
    max_prefill_fraction: float = 0.5

    preemption: bool = False
    priority_aging: bool = False
    priority_age_tokens: int = 256

    speculative: bool = False
    spec_k: int = 4
    spec_ngram: int = 3

    paged: bool = False
    page_size: int = 16
    num_pages: int = 0          # 0 = dense-equivalent capacity (+ null page)
    usable_pages: int = 0

    prefix_cache: bool = False
    prefix_evict_watermark: float = 0.0

    default_deadline_tokens: int = 0

    telemetry: bool = False
    telemetry_spans: int = 65536

    tp_degree: int = 1

    def validate(self) -> "ServeConfig":
        """Scheduler-level validation: degenerate knob combinations fail
        here with a clear error instead of hanging the tick loop."""
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, "
                             f"got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 = off), "
                             f"got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.admission_policy not in ("fifo", "sjf"):
            raise ValueError(f"admission_policy must be 'fifo' or 'sjf', "
                             f"got {self.admission_policy!r}")
        if self.chunked:
            if not self.paged:
                raise ValueError(
                    "chunked prefill scheduling requires paged=True (chunks "
                    "prefill through the block-table kernel)")
            if self.prefill_chunk < 1 or self.prefill_chunk % self.page_size:
                raise ValueError(
                    f"prefill_chunk ({self.prefill_chunk}) must be a "
                    f"positive multiple of page_size ({self.page_size}) so "
                    f"every chunk starts on a page boundary")
            if self.tick_token_budget < self.max_batch + self.prefill_chunk:
                raise ValueError(
                    f"tick_token_budget ({self.tick_token_budget}) must be "
                    f">= max_batch + prefill_chunk "
                    f"({self.max_batch} + {self.prefill_chunk}) or prefill "
                    f"can starve behind a full decode batch")
        if self.decode_priority:
            if not self.chunked:
                raise ValueError("decode_priority shaping requires "
                                 "chunked=True (it caps the per-tick "
                                 "prefill share)")
            if not 0.0 < self.max_prefill_fraction <= 1.0:
                raise ValueError(
                    f"max_prefill_fraction must be in (0, 1], got "
                    f"{self.max_prefill_fraction}")
            if int(self.max_prefill_fraction
                   * self.tick_token_budget) < self.prefill_chunk:
                raise ValueError(
                    f"max_prefill_fraction * tick_token_budget "
                    f"({self.max_prefill_fraction} * "
                    f"{self.tick_token_budget}) must fit at least one "
                    f"prefill_chunk ({self.prefill_chunk}) or prefill "
                    f"starves forever")
        if self.max_chunks_per_tick < 0:
            raise ValueError(f"max_chunks_per_tick must be >= 0, got "
                             f"{self.max_chunks_per_tick}")
        if self.speculative:
            if not self.chunked or not self.batched:
                raise ValueError(
                    "speculative decoding requires chunked=True and "
                    "batched=True (draft chains verify through the "
                    "batched chunk path)")
            if self.spec_k < 1:
                raise ValueError(f"spec_k must be >= 1, got {self.spec_k}")
            if self.spec_ngram < 1:
                raise ValueError(f"spec_ngram must be >= 1, "
                                 f"got {self.spec_ngram}")
        if self.default_deadline_tokens < 0:
            raise ValueError(
                f"default_deadline_tokens must be >= 0 (0 = no deadline), "
                f"got {self.default_deadline_tokens}")
        if self.telemetry_spans < 1:
            raise ValueError(f"telemetry_spans must be >= 1, "
                             f"got {self.telemetry_spans}")
        if self.preemption and not self.chunked:
            raise ValueError("preemption requires chunked=True (a preempted "
                             "request resumes through the chunked prefill "
                             "path)")
        if self.priority_aging and self.priority_age_tokens < 1:
            raise ValueError(
                f"priority_age_tokens must be >= 1 when priority_aging is "
                f"on, got {self.priority_age_tokens}")
        if self.tp_degree < 1:
            raise ValueError(f"tp_degree must be >= 1, got {self.tp_degree}")
        if self.tp_degree > 1 and not (self.paged and self.chunked
                                       and self.batched):
            raise ValueError(
                f"tp_degree={self.tp_degree} requires paged=True, "
                f"chunked=True and batched=True (got paged={self.paged}, "
                f"chunked={self.chunked}, batched={self.batched})")
        if self.usable_pages:
            if not self.paged:
                raise ValueError("usable_pages requires paged=True")
            if not 1 <= self.usable_pages <= self.pool_pages() - 1:
                raise ValueError(
                    f"usable_pages ({self.usable_pages}) must be in "
                    f"[1, {self.pool_pages() - 1}] (pool "
                    f"{self.pool_pages()} incl. the null page)")
        return self

    def pages_per_seq(self) -> int:
        return pages_for_tokens(self.max_seq, self.page_size)

    def pool_pages(self) -> int:
        """Actual pool size: configured, or dense-equivalent + null page."""
        return self.num_pages or dense_equivalent_pages(
            self.max_batch, self.max_seq, self.page_size)
