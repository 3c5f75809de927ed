"""Attention layers of the dense decoder: QKV projection, RoPE, the K/V
write into the cache (dense strips or the page pool), the attention
kernel, and the output projection.

The caches are updated IN PLACE (JAX returns new arrays; here layer l
writes into its (B, S_max, Hkv, D) strips or its (P, page_size, Hkv, D)
slab of the model's pool).  The write is issued before the attention
kernel on the same stream, so the kernel always reads the cache with this
step's K/V already in it.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ModelConfig
from ..kernels import ops
from .layers import dense, rms_head_norm, rope


def _qkv(params, x: torch.Tensor, cfg: ModelConfig):
    B, S = x.shape[:2]
    q = dense(params["wq"], x).reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = dense(params["wk"], x).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = dense(params["wv"], x).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_head_norm(q, params["q_norm"])
        k = rms_head_norm(k, params["k_norm"])
    return q, k, v


def attn_forward(params, x: torch.Tensor, cfg: ModelConfig, *,
                 causal: bool = True, window: int = 0,
                 positions: Optional[torch.Tensor] = None,
                 impl: Optional[str] = None) -> torch.Tensor:
    """Full-sequence self-attention (training / teacher forcing).  x: (B,
    S, D); positions (S,) default arange(S).  Returns (B, S, D)."""
    q, k, v = _qkv(params, x, cfg)
    B, S = x.shape[:2]
    if cfg.use_rope:
        pos = positions if positions is not None \
            else torch.arange(S, device=x.device)
        q = rope(q, pos, cfg.rope_theta, cfg.rope_scaling)
        k = rope(k, pos, cfg.rope_theta, cfg.rope_scaling)
    o = ops.flash_attention(q, k, v, causal=causal, window=window,
                            logit_softcap=cfg.attn_logit_softcap, impl=impl)
    return dense(params["wo"], o.reshape(B, S, cfg.n_heads * cfg.head_dim))


def attn_prefill(params, x: torch.Tensor, cfg: ModelConfig,
                 cache_k: torch.Tensor, cache_v: torch.Tensor, *,
                 window: int = 0, impl: Optional[str] = None
                 ) -> torch.Tensor:
    """Prefill from position 0: full causal attention over x (B, S, D),
    and its K/V written into positions [0, S) of the (B, S_max, Hkv, D)
    strips.  Returns (B, S, D)."""
    q, k, v = _qkv(params, x, cfg)
    B, S = x.shape[:2]
    if cfg.use_rope:
        pos = torch.arange(S, device=x.device)
        q = rope(q, pos, cfg.rope_theta, cfg.rope_scaling)
        k = rope(k, pos, cfg.rope_theta, cfg.rope_scaling)
    cache_k[:, :S] = k.to(cache_k.dtype)
    cache_v[:, :S] = v.to(cache_v.dtype)
    o = ops.flash_attention(q, k, v, causal=True, window=window,
                            logit_softcap=cfg.attn_logit_softcap, impl=impl)
    return dense(params["wo"], o.reshape(B, S, cfg.n_heads * cfg.head_dim))


def attn_prefill_paged(params, x: torch.Tensor, cfg: ModelConfig,
                       k_pages: torch.Tensor, v_pages: torch.Tensor,
                       page_ids: torch.Tensor, *, window: int = 0,
                       impl: Optional[str] = None) -> torch.Tensor:
    """Prefill one sequence's prompt into its pages.  x: (1, S, D) with S a
    multiple of the page size (trailing pad K/V is masked by the lengths at
    decode time and overwritten as decode advances); page_ids: (S //
    page_size,) the sequence's pages, position-major.  Attention runs over
    the prompt's own contiguous K/V.  Returns (1, S, D)."""
    q, k, v = _qkv(params, x, cfg)
    S = x.shape[1]
    ps = k_pages.shape[1]
    if cfg.use_rope:
        pos = torch.arange(S, device=x.device)
        q = rope(q, pos, cfg.rope_theta, cfg.rope_scaling)
        k = rope(k, pos, cfg.rope_theta, cfg.rope_scaling)
    idx = page_ids.long()
    k_pages[idx] = k[0].reshape(-1, ps, cfg.n_kv_heads,
                                cfg.head_dim).to(k_pages.dtype)
    v_pages[idx] = v[0].reshape(-1, ps, cfg.n_kv_heads,
                                cfg.head_dim).to(v_pages.dtype)
    o = ops.flash_attention(q, k, v, causal=True, window=window,
                            logit_softcap=cfg.attn_logit_softcap, impl=impl)
    return dense(params["wo"], o.reshape(1, S, cfg.n_heads * cfg.head_dim))


def attn_decode(params, x: torch.Tensor, cfg: ModelConfig,
                cache_k: torch.Tensor, cache_v: torch.Tensor,
                lens: torch.Tensor, *, window: int = 0,
                impl: Optional[str] = None,
                seq_parallel: bool = False) -> torch.Tensor:
    """Single-token decode against the dense strips.  x: (B, 1, D);
    caches (B, S_max, Hkv, D); lens (B,) int32 current lengths - the new
    token's K/V goes to position lens of its own strip.  An idle lane
    (lens 0) writes position 0 of its strip and attends over that one
    position, as the JAX package's decode does.  Returns (B, 1, D)."""
    if seq_parallel:
        raise NotImplementedError(
            "sequence-parallel decode is not ported yet (ROADMAP M11)")
    B = x.shape[0]
    q, k, v = _qkv(params, x, cfg)
    if cfg.use_rope:
        q = rope(q, lens[:, None], cfg.rope_theta, cfg.rope_scaling)
        k = rope(k, lens[:, None], cfg.rope_theta, cfg.rope_scaling)
    bidx = torch.arange(B, device=x.device)
    cache_k[bidx, lens.long()] = k[:, 0].to(cache_k.dtype)
    cache_v[bidx, lens.long()] = v[:, 0].to(cache_v.dtype)
    o = ops.flash_decode(q, cache_k, cache_v, lens + 1, window=window,
                         logit_softcap=cfg.attn_logit_softcap, impl=impl)
    return dense(params["wo"], o.reshape(B, 1, cfg.n_heads * cfg.head_dim))


def attn_decode_paged(params, x: torch.Tensor, cfg: ModelConfig,
                      k_pages: torch.Tensor, v_pages: torch.Tensor,
                      block_table: torch.Tensor, lens: torch.Tensor, *,
                      window: int = 0, impl: Optional[str] = None
                      ) -> torch.Tensor:
    """Single-token decode through the block table.  x: (B, 1, D);
    block_table: (B, n_max) int32; lens: (B,) int32 current lengths - the
    new token's K/V goes to page lens // page_size at offset
    lens % page_size.  Idle slots (lens 0, zeroed table row) write into the
    null page 0.  Returns the attention block's output (B, 1, D)."""
    B = x.shape[0]
    q, k, v = _qkv(params, x, cfg)
    if cfg.use_rope:
        q = rope(q, lens[:, None], cfg.rope_theta, cfg.rope_scaling)
        k = rope(k, lens[:, None], cfg.rope_theta, cfg.rope_scaling)
    ps, n_max = k_pages.shape[1], block_table.shape[1]
    # an out-of-range page index clamps, as the JAX gather does
    pidx = torch.clamp(lens // ps, max=n_max - 1).long()
    page = torch.gather(block_table, 1, pidx[:, None])[:, 0].long()
    off = (lens % ps).long()
    k_pages[page, off] = k[:, 0].to(k_pages.dtype)
    v_pages[page, off] = v[:, 0].to(v_pages.dtype)
    o = ops.paged_flash_decode(q, k_pages, v_pages, block_table, lens + 1,
                               window=window,
                               logit_softcap=cfg.attn_logit_softcap,
                               impl=impl)
    return dense(params["wo"], o.reshape(B, 1, cfg.n_heads * cfg.head_dim))


def attn_prefill_chunks_paged(params, x: torch.Tensor, cfg: ModelConfig,
                              k_pages: torch.Tensor, v_pages: torch.Tensor,
                              page_tables: torch.Tensor,
                              offsets: torch.Tensor, true_lens: torch.Tensor,
                              *, q_lens: Optional[torch.Tensor] = None,
                              window: int = 0, impl: Optional[str] = None
                              ) -> torch.Tensor:
    """A ragged batch of K mid-prompt chunks in one pass.  x: (K, S, D), row
    k at absolute positions offsets[k] + arange(S), zero-padded past
    true_lens[k].  Each row's K/V scatters token by token through its table
    row, PAD positions redirected to the null page 0 (two chunks of one
    sequence in one batch never collide); then every row's queries attend
    through the offset-causal batched kernel.  Dead rows (true_len 0,
    all-null table row) write only to the null page.  Returns (K, S, D)."""
    q, k, v = _qkv(params, x, cfg)
    K, S = x.shape[:2]
    ps, n_max = k_pages.shape[1], page_tables.shape[1]
    pos = offsets[:, None] + torch.arange(S, dtype=offsets.dtype,
                                          device=x.device)[None, :]
    if cfg.use_rope:
        q = rope(q, pos, cfg.rope_theta, cfg.rope_scaling)
        k = rope(k, pos, cfg.rope_theta, cfg.rope_scaling)
    valid = pos < true_lens[:, None]
    pidx = torch.clamp(pos // ps, max=n_max - 1).long()
    pages = torch.where(valid, torch.gather(page_tables, 1, pidx), 0).long()
    offs = torch.where(valid, pos % ps, 0).long()
    k_pages[pages, offs] = k.to(k_pages.dtype)
    v_pages[pages, offs] = v.to(v_pages.dtype)
    o = ops.batched_paged_prefill_attention(
        q, k_pages, v_pages, page_tables, offsets, true_lens, q_lens,
        window=window, logit_softcap=cfg.attn_logit_softcap, impl=impl)
    return dense(params["wo"], o.reshape(K, S, cfg.n_heads * cfg.head_dim))


def attn_prefill_chunk_paged(params, x: torch.Tensor, cfg: ModelConfig,
                             k_pages: torch.Tensor, v_pages: torch.Tensor,
                             page_row: torch.Tensor, offset: int, *,
                             window: int = 0, impl: Optional[str] = None
                             ) -> torch.Tensor:
    """One mid-prompt chunk of one sequence, the K=1 case: x (1, S, D) at
    positions offset + arange(S), every position real."""
    off = torch.full((1,), int(offset), dtype=torch.int32, device=x.device)
    return attn_prefill_chunks_paged(
        params, x, cfg, k_pages, v_pages,
        page_row.reshape(1, -1).to(torch.int32), off, off + x.shape[1],
        window=window, impl=impl)
