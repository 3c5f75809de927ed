"""Paged attention layers of the dense decoder: QKV projection, RoPE, the
K/V scatter into the page pool, the paged attention kernel, and the output
projection.

The page pools are updated IN PLACE (JAX returns new arrays; here layer l
writes into its (P, page_size, Hkv, D) slab of the model's pool).  The
scatter is issued before the attention kernel on the same stream, so the
kernel always reads the pool with this step's K/V already in it.
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
