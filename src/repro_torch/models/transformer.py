"""Layer loops of the dense decoder: the full-sequence forward, and prefill
and decode over the dense or the paged KV cache.

A Python loop over layers takes the place of the JAX package's lax.scan:
layer l reads its slices of the stacked (L, ...) parameters and updates its
strips k[l] / v[l] or its slab k_pages[l] / v_pages[l] of the cache in
place.  The gemma3 local:global pattern is a Python `if` per layer instead
of lax.cond.  stack_forward is also the training forward: with remat each
layer runs under torch.utils.checkpoint, the counterpart of jax.checkpoint
on the scanned body.
"""
from __future__ import annotations

from typing import List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from .attention import (attn_decode, attn_decode_paged, attn_forward,
                        attn_prefill, attn_prefill_chunks_paged,
                        attn_prefill_paged)
from .layers import apply_norm, mlp


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
        window = _windowed(cfg, is_global)
        if remat:
            x = checkpoint(_block, p, x, cfg, window, impl,
                           use_reentrant=False)
        else:
            x = _block(p, x, cfg, window, impl)
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
