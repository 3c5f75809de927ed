"""Layer loops of every ported family: the dense decoder (full-sequence
forward, and prefill and decode over the dense or the paged KV cache), the
hybrid zamba2 stack (Mamba2 layers with one shared-weight attention block
after every shared_attn_every-th layer) and the RWKV6 stack.

A Python loop over layers takes the place of the JAX package's lax.scan:
layer l reads its slices of the stacked (L, ...) parameters and updates its
strips k[l] / v[l], its slab k_pages[l] / v_pages[l] or its recurrent state
of the cache in place.  The gemma3 local:global pattern and the hybrid
stack's shared block are a Python `if` per layer instead of lax.cond.  The
forwards are also the training forwards: with remat each layer runs under
torch.utils.checkpoint, the counterpart of jax.checkpoint on the scanned
body.  The JAX stacks' grad_cast, optimization_barrier and constrain are
XLA and sharding hints with no counterpart here.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from .attention import (attn_decode, attn_decode_paged, attn_forward,
                        attn_prefill, attn_prefill_chunks_paged,
                        attn_prefill_paged)
from .layers import apply_norm, mlp
from .mamba2 import (mamba2_decode, mamba2_forward, mamba2_init_state,
                     mamba2_prefill)
from .rwkv6 import rwkv6_channel_mix, rwkv6_init_state, rwkv6_time_mix


def _layer_windows(cfg: ModelConfig) -> List[bool]:
    """Per-layer is_global flags for the gemma3 local:global pattern."""
    if cfg.sliding_window and cfg.global_every:
        return [i % cfg.global_every == cfg.global_every - 1
                for i in range(cfg.n_layers)]
    return [True] * cfg.n_layers


def _windowed(cfg: ModelConfig, is_global: bool) -> int:
    """The attention window of a layer: 0 (full) for a global layer of the
    local:global pattern, the config's sliding window otherwise."""
    if cfg.sliding_window and cfg.global_every:
        return 0 if is_global else cfg.sliding_window
    return cfg.sliding_window


def _layer(blocks, l: int):
    """Layer l's parameters out of the stacked (L, ...) tree."""
    return {name: {k: v[l] for k, v in group.items()}
            for name, group in blocks.items()}


def _ffn_tail(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Post-attention half of a block: norm -> mlp -> residual."""
    return x + mlp(p["mlp"], apply_norm(p["n2"], x, cfg), cfg)


def _layers(blocks, n_layers: int):
    """Every layer's parameters out of the stacked (L, ...) tree, with one
    torch.unbind per leaf.  Its backward stacks the L slice gradients into
    the leaf's gradient once; slicing with v[l] (_layer) would instead
    add L zero-padded full-size gradients into each leaf."""
    per_leaf = {name: {k: torch.unbind(v) for k, v in group.items()}
                for name, group in blocks.items()}
    return [{name: {k: v[l] for k, v in group.items()}
             for name, group in per_leaf.items()} for l in range(n_layers)]


def _run(fn, remat: bool, *args):
    """fn(*args), under torch.utils.checkpoint when remat is on."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _block(p, x: torch.Tensor, cfg: ModelConfig, window: int,
           impl: Optional[str]) -> torch.Tensor:
    h = attn_forward(p["attn"], apply_norm(p["n1"], x, cfg), cfg,
                     window=window, impl=impl)
    return _ffn_tail(p, x + h, cfg)


def stack_forward(blocks, x: torch.Tensor, cfg: ModelConfig, *,
                  impl: Optional[str] = None,
                  remat: bool = False) -> torch.Tensor:
    """Causal self-attention blocks over the whole sequence x (B, S, D).
    remat=True keeps only each layer's input for the backward and runs the
    layer again there (the attention forward included)."""
    for p, is_global in zip(_layers(blocks, cfg.n_layers),
                            _layer_windows(cfg)):
        x = _run(_block, remat, p, x, cfg, _windowed(cfg, is_global),
                 impl)
    return x


def stack_prefill(blocks, x: torch.Tensor, cfg: ModelConfig, cache, *,
                  impl: Optional[str] = None) -> torch.Tensor:
    """Prefill from position 0 into the dense cache {"k"/"v": (L, B,
    S_max, Hkv, D)}, updated in place.  x: (B, S, D)."""
    for l, is_global in enumerate(_layer_windows(cfg)):
        p = _layer(blocks, l)
        h = attn_prefill(p["attn"], apply_norm(p["n1"], x, cfg), cfg,
                         cache["k"][l], cache["v"][l],
                         window=_windowed(cfg, is_global), impl=impl)
        x = _ffn_tail(p, x + h, cfg)
    return x


def stack_decode(blocks, x: torch.Tensor, cfg: ModelConfig, cache,
                 lens: torch.Tensor, *, impl: Optional[str] = None,
                 seq_parallel: bool = False) -> torch.Tensor:
    """Batched single-token decode against the dense cache."""
    for l, is_global in enumerate(_layer_windows(cfg)):
        p = _layer(blocks, l)
        h = attn_decode(p["attn"], apply_norm(p["n1"], x, cfg), cfg,
                        cache["k"][l], cache["v"][l], lens,
                        window=_windowed(cfg, is_global), impl=impl,
                        seq_parallel=seq_parallel)
        x = _ffn_tail(p, x + h, cfg)
    return x


def stack_prefill_paged(blocks, x: torch.Tensor, cfg: ModelConfig, cache,
                        page_ids: torch.Tensor, *,
                        impl: Optional[str] = None) -> torch.Tensor:
    """Paged prefill of ONE sequence, x: (1, S, D) with S a multiple of the
    page size, into its pages page_ids (S // page_size,); the block table
    passes through untouched (the engine owns it)."""
    for l, is_global in enumerate(_layer_windows(cfg)):
        p = _layer(blocks, l)
        h = attn_prefill_paged(p["attn"], apply_norm(p["n1"], x, cfg), cfg,
                               cache["k_pages"][l], cache["v_pages"][l],
                               page_ids, window=_windowed(cfg, is_global),
                               impl=impl)
        x = _ffn_tail(p, x + h, cfg)
    return x


def stack_prefill_chunks_paged(blocks, x: torch.Tensor, cfg: ModelConfig,
                               cache, page_tables: torch.Tensor,
                               offsets: torch.Tensor,
                               true_lens: torch.Tensor, *,
                               q_lens: Optional[torch.Tensor] = None,
                               impl: Optional[str] = None) -> torch.Tensor:
    """A ragged batch of mid-prompt chunks through every layer.  x: (K, S,
    D); cache: {"k_pages"/"v_pages": (L, P, page_size, Hkv, D)}, updated in
    place.  Two chunks of one sequence may share the batch (ordered
    offsets): each layer scatters every row's K/V before its attention
    reads the pool."""
    for l, is_global in enumerate(_layer_windows(cfg)):
        p = _layer(blocks, l)
        h = attn_prefill_chunks_paged(
            p["attn"], apply_norm(p["n1"], x, cfg), cfg,
            cache["k_pages"][l], cache["v_pages"][l], page_tables, offsets,
            true_lens, q_lens=q_lens, window=_windowed(cfg, is_global),
            impl=impl)
        x = _ffn_tail(p, x + h, cfg)
    return x


def stack_decode_paged(blocks, x: torch.Tensor, cfg: ModelConfig, cache,
                       lens: torch.Tensor, *,
                       impl: Optional[str] = None) -> torch.Tensor:
    """Batched single-token decode through the block table (all layers
    share one table; each layer owns its own pool slab)."""
    bt = cache["block_table"]
    for l, is_global in enumerate(_layer_windows(cfg)):
        p = _layer(blocks, l)
        h = attn_decode_paged(
            p["attn"], apply_norm(p["n1"], x, cfg), cfg,
            cache["k_pages"][l], cache["v_pages"][l], bt, lens,
            window=_windowed(cfg, is_global), impl=impl)
        x = _ffn_tail(p, x + h, cfg)
    return x


# ===========================================================================
# hybrid stack (zamba2): Mamba2 layers + one shared attention block
# ===========================================================================

def n_shared_applications(cfg: ModelConfig) -> int:
    k = cfg.shared_attn_every
    return cfg.n_layers // k if k else 0


def _shared_at(cfg: ModelConfig, idx: int) -> bool:
    """Whether the shared block follows Mamba2 layer idx."""
    k = cfg.shared_attn_every
    return bool(k) and idx % k == k - 1


def _hybrid_layer(p, shared, x: torch.Tensor, impl: Optional[str], *,
                  cfg: ModelConfig) -> torch.Tensor:
    x = x + mamba2_forward(p, x, cfg, impl=impl)
    if shared is not None:
        x = _block(shared, x, cfg, 0, impl)
    return x


def hybrid_layers(blocks, cfg: ModelConfig) -> List[Callable]:
    """One callable per layer, f(x, impl) -> x: Mamba2 layer l, then the
    shared block where it follows layer l.  blocks: {"mamba": stacked (L,
    ...) Mamba2 leaves, "shared": one attention block (n1, attn, n2, mlp),
    unstacked}."""
    shared = blocks["shared"]
    return [partial(_hybrid_layer, p["mamba"],
                    shared if _shared_at(cfg, idx) else None, cfg=cfg)
            for idx, p in enumerate(_layers({"mamba": blocks["mamba"]},
                                            cfg.n_layers))]


def hybrid_forward(blocks, x: torch.Tensor, cfg: ModelConfig, *,
                   impl: Optional[str] = None,
                   remat: bool = False) -> torch.Tensor:
    """The hybrid stack over the whole sequence x (B, S, D)."""
    for layer in hybrid_layers(blocks, cfg):
        x = _run(layer, remat, x, impl)
    return x


def hybrid_init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                      device):
    """Per-layer conv windows and SSM states (L, batch, ...), and one dense
    K / V strip (A, batch, max_len, Hkv, D) per application of the shared
    block."""
    st = mamba2_init_state(cfg, batch, dtype, device)
    L = cfg.n_layers
    A = max(n_shared_applications(cfg), 1)
    kv = (A, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"conv": st["conv"].new_zeros((L,) + st["conv"].shape),
            "ssm": st["ssm"].new_zeros((L,) + st["ssm"].shape),
            "shared_k": torch.zeros(kv, dtype=dtype, device=device),
            "shared_v": torch.zeros(kv, dtype=dtype, device=device)}


def hybrid_prefill(blocks, x: torch.Tensor, cfg: ModelConfig, cache, *,
                   impl: Optional[str] = None) -> torch.Tensor:
    """Full-sequence prefill from position 0: the chunked SSD scans fill
    the per-layer conv / SSM states, the shared block prefills its K / V
    strips; the cache is updated in place."""
    k = cfg.shared_attn_every
    shared = blocks["shared"]
    for idx in range(cfg.n_layers):
        p = {name: v[idx] for name, v in blocks["mamba"].items()}
        y, st = mamba2_prefill(p, x, cfg)
        x = x + y
        cache["conv"][idx].copy_(st["conv"])
        cache["ssm"][idx].copy_(st["ssm"])
        if _shared_at(cfg, idx):
            h = attn_prefill(shared["attn"],
                             apply_norm(shared["n1"], x, cfg), cfg,
                             cache["shared_k"][idx // k],
                             cache["shared_v"][idx // k], impl=impl)
            x = _ffn_tail(shared, x + h, cfg)
    return x


def hybrid_decode(blocks, x: torch.Tensor, cfg: ModelConfig, cache,
                  lens: torch.Tensor, *,
                  impl: Optional[str] = None) -> torch.Tensor:
    """One token per lane: each Mamba2 layer steps its conv window and SSM
    state, the shared block decodes against its strips at lens (written
    in place)."""
    k = cfg.shared_attn_every
    shared = blocks["shared"]
    for idx in range(cfg.n_layers):
        p = {name: v[idx] for name, v in blocks["mamba"].items()}
        y, st = mamba2_decode(p, x, cfg, {"conv": cache["conv"][idx],
                                          "ssm": cache["ssm"][idx]})
        x = x + y
        cache["conv"][idx].copy_(st["conv"])
        cache["ssm"][idx].copy_(st["ssm"])
        if _shared_at(cfg, idx):
            h = attn_decode(shared["attn"],
                            apply_norm(shared["n1"], x, cfg), cfg,
                            cache["shared_k"][idx // k],
                            cache["shared_v"][idx // k], lens, impl=impl)
            x = _ffn_tail(shared, x + h, cfg)
    return x


# ===========================================================================
# RWKV6 stack
# ===========================================================================

def _rwkv_layer(p, x: torch.Tensor, impl: Optional[str], *,
                cfg: ModelConfig) -> torch.Tensor:
    h, _ = rwkv6_time_mix(p["mix"], apply_norm(p["n1"], x, cfg), cfg,
                          impl=impl)
    x = x + h
    h, _ = rwkv6_channel_mix(p["mix"], apply_norm(p["n2"], x, cfg), cfg)
    return x + h


def rwkv_layers(blocks, cfg: ModelConfig) -> List[Callable]:
    """One callable per layer, f(x, impl) -> x.  blocks: {"n1", "n2",
    "mix"} stacked (L, ...)."""
    return [partial(_rwkv_layer, p, cfg=cfg)
            for p in _layers(blocks, cfg.n_layers)]


def rwkv_forward(blocks, x: torch.Tensor, cfg: ModelConfig, *,
                 impl: Optional[str] = None,
                 remat: bool = False) -> torch.Tensor:
    """The RWKV6 stack over the whole sequence x (B, S, D)."""
    for layer in rwkv_layers(blocks, cfg):
        x = _run(layer, remat, x, impl)
    return x


def rwkv_init_cache(cfg: ModelConfig, batch: int, dtype, device):
    st = rwkv6_init_state(cfg, batch, dtype, device)
    return {k: v.new_zeros((cfg.n_layers,) + v.shape)
            for k, v in st.items()}


def rwkv_prefill(blocks, x: torch.Tensor, cfg: ModelConfig, cache, *,
                 impl: Optional[str] = None) -> torch.Tensor:
    """Full-sequence prefill: the state-returning chunked WKV scan fills
    each layer's wkv state, the last normed inputs its token-shift
    carries; the cache is updated in place."""
    for l in range(cfg.n_layers):
        p = _layer(blocks, l)
        h, (tm_last, wkv) = rwkv6_time_mix(
            p["mix"], apply_norm(p["n1"], x, cfg), cfg, impl=impl,
            return_state=True)
        x = x + h
        h, cm_last = rwkv6_channel_mix(p["mix"], apply_norm(p["n2"], x, cfg),
                                       cfg)
        x = x + h
        cache["wkv"][l].copy_(wkv)
        cache["tm_prev"][l].copy_(tm_last)
        cache["cm_prev"][l].copy_(cm_last)
    return x


def rwkv_decode(blocks, x: torch.Tensor, cfg: ModelConfig, cache,
                lens: torch.Tensor, *,
                impl: Optional[str] = None) -> torch.Tensor:
    """One token per lane through every layer's recurrent state (lens is
    unused: the state carries the position)."""
    for l in range(cfg.n_layers):
        p = _layer(blocks, l)
        h, (tm_last, wkv) = rwkv6_time_mix(
            p["mix"], apply_norm(p["n1"], x, cfg), cfg,
            x_prev=cache["tm_prev"][l], wkv_state=cache["wkv"][l],
            impl=impl)
        x = x + h
        h, cm_last = rwkv6_channel_mix(p["mix"], apply_norm(p["n2"], x, cfg),
                                       cfg, x_prev=cache["cm_prev"][l])
        x = x + h
        cache["wkv"][l].copy_(wkv)
        cache["tm_prev"][l].copy_(tm_last)
        cache["cm_prev"][l].copy_(cm_last)
    return x
