"""Attention layers: QKV projection (K and V from the encoder output for
cross-attention), RoPE, the K/V write into the cache (dense strips or the
page pool), the attention kernel, and the output projection.

The caches are updated IN PLACE (JAX returns new arrays; here layer l
writes into its (B, S_max, Hkv, D) strips or its (P, page_size, Hkv, D)
slab of the model's pool).  The write is issued before the attention
kernel on the same stream, so the kernel always reads the cache with this
step's K/V already in it.

On a (data, model) mesh (serve/serve_step.py's mesh steps) the dense
prefill and decode take a CacheShard: the rank's strips hold its block of
the KV heads, of the sequence, or of both (sharding/rules.py cache_spec's
three layouts), and the rank writes and reads that block only - whisper's
cross strips as its self-attention strips, written by the prefill and
only read by the decode.  The same CacheShard carries the recurrent
families' state blocks (CacheShard.state, state_axis, state_range): the
dims of the Mamba2 / RWKV6 state leaves that the rank holds a block of,
and the mesh axis each is split over.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..kernels import ops
from .layers import dense, rms_head_norm, rope


def _q(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    B, S = x.shape[:2]
    q = dense(params["wq"], x).reshape(B, S, cfg.n_heads, cfg.head_dim)
    return rms_head_norm(q, params["q_norm"]) if cfg.qk_norm else q


def _qkv(params, x: torch.Tensor, cfg: ModelConfig,
         kv_x: Optional[torch.Tensor] = None):
    """q from x; k and v from kv_x (cross-attention: the encoder output),
    or from x when it is None."""
    src = x if kv_x is None else kv_x
    B, S = src.shape[:2]
    k = dense(params["wk"], src).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = dense(params["wv"], src).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        k = rms_head_norm(k, params["k_norm"])
    return _q(params, x, cfg), k, v


def attn_forward(params, x: torch.Tensor, cfg: ModelConfig, *,
                 causal: bool = True, window: int = 0,
                 positions: Optional[torch.Tensor] = None,
                 kv_x: Optional[torch.Tensor] = None,
                 impl: Optional[str] = None, tp_mesh=None) -> torch.Tensor:
    """Full-sequence attention (training / teacher forcing).  x: (B, S,
    D); positions (S,) default arange(S).  kv_x (B, S_kv, D): cross-
    attention, K and V from kv_x and no RoPE (whisper's decoder over its
    encoder output, with causal=False).  tp_mesh (the sharded train
    step's model axis, a ServeMesh of size N > 1): the projections stay
    replicated, and the attention runs on this rank's head shard
    (ops.head_sharded_attention: K4 / K5; cross-attention's keys are the
    encoder's S_kv positions), gathered back to every head.
    Returns (B, S, D)."""
    q, k, v = _qkv(params, x, cfg, kv_x)
    B, S = x.shape[:2]
    if cfg.use_rope and kv_x is None:
        pos = positions if positions is not None \
            else torch.arange(S, device=x.device)
        q = rope(q, pos, cfg.rope_theta, cfg.rope_scaling)
        k = rope(k, pos, cfg.rope_theta, cfg.rope_scaling)
    o = ops.flash_attention(q, k, v, causal=causal, window=window,
                            logit_softcap=cfg.attn_logit_softcap, impl=impl,
                            tp_mesh=tp_mesh)
    return dense(params["wo"], o.reshape(B, S, cfg.n_heads * cfg.head_dim))


def attn_prefill_cross(params, x: torch.Tensor, cfg: ModelConfig,
                       enc_out: torch.Tensor, cache_k: torch.Tensor,
                       cache_v: torch.Tensor, *,
                       impl: Optional[str] = None,
                       shard: Optional[CacheShard] = None) -> torch.Tensor:
    """Cross-attention of a decoder prefill: K and V of the encoder output
    enc_out (B, S_enc, D) written into positions [0, S_enc) of the (B,
    S_cross, Hkv, D) cross strips, then x (B, S, D) attends over all of
    them, non-causal.  (The JAX package projects enc_out twice, for the
    strips and for its attn_forward(kv_x=), to the same values.)  shard
    (a mesh step): the strips are the rank's block, which gets its KV
    heads and positions of the encoder's K/V (_kv_block, _write_prompt),
    and the attention runs on the model rank's head shard (K4 over the
    encoder's S_enc keys), gathered back to every head.  Returns (B, S,
    D)."""
    q, k, v = _qkv(params, x, cfg, enc_out)
    B, S = x.shape[:2]
    _write_prompt(cache_k, _kv_block(k, shard), shard)
    _write_prompt(cache_v, _kv_block(v, shard), shard)
    o = ops.flash_attention(q, k, v, causal=False,
                            logit_softcap=cfg.attn_logit_softcap, impl=impl,
                            tp_mesh=shard.model if shard else None)
    return dense(params["wo"], o.reshape(B, S, cfg.n_heads * cfg.head_dim))


@dataclass(frozen=True)
class CacheShard:
    """A rank's block of the dense (B, S_max, Hkv, D) strips on a (data,
    model) mesh, each field a launch/mesh.py ServeMesh (group, rank, size)
    or None:
      model  the model axis (None at size 1): the attention runs on this
             rank's query heads and gathers them back over it
             (ops.head_sharded_attention, ops._tp_head_sharded);
      heads  True when the strips hold the model rank's block of the KV
             heads (cache_spec's default and sequence-over-data layouts),
             False when they hold every head;
      seq    the axis the strips' sequence is split over (None: whole):
             the rank holds positions [seq.rank S_local, (seq.rank + 1)
             S_local), and the decode is ops.seq_parallel_decode over it.
      state  the recurrent state leaves' split dims (launch/specs.py
             state_blocks): {leaf: {dim: ServeMesh}}, dim a dim of the
             cache leaf (L, B, ...) past the rows, the axis its entries
             are split over; a dim not named is whole (its spec leaves it
             replicated, as sanitize does where an axis does not divide
             the dim).  Each leaf follows its own spec: the JAX package's
             layout puts conv's channels and ssm's heads on the model
             axis, and lays wkv (L, B, H, K, V) out as the attention
             strips (its name ends in "v"): K over the model axis, or H
             over the axis the strips' sequence is split over.
    The batch rows a rank holds need nothing here: rows are independent,
    and the step gets this rank's rows of tokens, lens, strips and
    states."""
    model: Any = None
    heads: bool = False
    seq: Any = None
    state: Dict[str, Dict[int, Any]] = field(default_factory=dict)


def state_axis(shard: Optional[CacheShard], leaf: str, dim: int):
    """The mesh axis (a ServeMesh) that splits dim `dim` of the cache's
    recurrent state leaf `leaf` (L, B, ...), or None where the rank holds
    the whole dim."""
    return None if shard is None else shard.state.get(leaf, {}).get(dim)


def state_range(shard: Optional[CacheShard], leaf: str, dim: int,
                full: int, local: Optional[int] = None) -> Tuple[int, int]:
    """(start, size) of the block of dim `dim` (`full` long) of state leaf
    `leaf` that the rank holds (state_axis).  local: the dim's length in
    the rank's tensor, checked against the block."""
    ax = state_axis(shard, leaf, dim)
    n = ax.size if ax is not None else 1
    if full % n or (local is not None and local * n != full):
        raise ValueError(f"state leaf {leaf!r} dim {dim}: a block of "
                         f"{local} does not split {full} over {n} ranks")
    return (ax.rank * (full // n) if ax is not None else 0), full // n


def _kv_block(t: torch.Tensor, shard: Optional[CacheShard]) -> torch.Tensor:
    """The KV heads (axis 2) of a (B, S, Hkv, D) projection that the
    rank's strips hold."""
    if shard is None or not shard.heads:
        return t
    return ops.shard_heads(t, shard.model)


def _write_prompt(cache: torch.Tensor, new: torch.Tensor,
                  shard: Optional[CacheShard]) -> None:
    """new (B, S, h, D) at positions [0, S) of the strips, into the rank's
    slice of them only when the sequence is sharded."""
    S = new.shape[1]
    if shard is None or shard.seq is None:
        cache[:, :S] = new.to(cache.dtype)
        return
    S_loc = cache.shape[1]
    start = shard.seq.rank * S_loc
    n = max(0, min(S - start, S_loc))
    if n:
        cache[:, :n] = new[:, start:start + n].to(cache.dtype)


def _write_token(cache: torch.Tensor, new: torch.Tensor, lens: torch.Tensor,
                 shard: Optional[CacheShard]) -> None:
    """new (B, h, D) at position lens[b] of lane b's strip.  With the
    sequence sharded, only the rank whose slice holds lens[b] writes lane
    b; every other rank leaves the lane as it is (the JAX scatter, which
    XLA routes to the shard holding the position)."""
    B = cache.shape[0]
    bidx = torch.arange(B, device=cache.device)
    if shard is None or shard.seq is None:
        cache[bidx, lens.long()] = new.to(cache.dtype)
        return
    S_loc = cache.shape[1]
    local = lens.long() - shard.seq.rank * S_loc
    mine = ((local >= 0) & (local < S_loc))[:, None, None]
    idx = torch.clamp(local, 0, S_loc - 1)
    cache[bidx, idx] = torch.where(mine, new.to(cache.dtype),
                                   cache[bidx, idx])


def attn_prefill(params, x: torch.Tensor, cfg: ModelConfig,
                 cache_k: torch.Tensor, cache_v: torch.Tensor, *,
                 window: int = 0, impl: Optional[str] = None,
                 shard: Optional[CacheShard] = None) -> torch.Tensor:
    """Prefill from position 0: full causal attention over x (B, S, D),
    and its K/V written into positions [0, S) of the (B, S_max, Hkv, D)
    strips.  shard (a mesh step): the strips are the rank's block, which
    gets its KV heads and positions of the prompt, and the attention runs
    on the model rank's head shard (K4), gathered back to every head.
    Returns (B, S, D)."""
    q, k, v = _qkv(params, x, cfg)
    B, S = x.shape[:2]
    if cfg.use_rope:
        pos = torch.arange(S, device=x.device)
        q = rope(q, pos, cfg.rope_theta, cfg.rope_scaling)
        k = rope(k, pos, cfg.rope_theta, cfg.rope_scaling)
    _write_prompt(cache_k, _kv_block(k, shard), shard)
    _write_prompt(cache_v, _kv_block(v, shard), shard)
    o = ops.flash_attention(q, k, v, causal=True, window=window,
                            logit_softcap=cfg.attn_logit_softcap, impl=impl,
                            tp_mesh=shard.model if shard else None)
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
                impl: Optional[str] = None, seq_parallel: bool = False,
                cross: bool = False,
                shard: Optional[CacheShard] = None) -> torch.Tensor:
    """Single-token decode against the dense strips.  x: (B, 1, D);
    caches (B, S_max, Hkv, D); lens (B,) int32 current lengths - the new
    token's K/V goes to position lens of its own strip.  An idle lane
    (lens 0) writes position 0 of its strip and attends over that one
    position, as the JAX package's decode does.  cross=True: cross-
    attention over the encoder's K/V already in the strips, the first
    lens positions of each; nothing is written and no RoPE applied.
    seq_parallel=True: the attention is ops.decode_attention_naive over
    the whole strips, as in the JAX package - which takes no window, so a
    sliding window is dropped there (ROADMAP §3).  shard (a mesh step):
    the strips are the rank's block; the new token's K/V goes into its
    KV heads, by the rank whose slice holds the position (_kv_block,
    _write_token; never for cross), and the attention is _mesh_attend's,
    lens then counting the whole strip's positions.  Returns (B, 1,
    D)."""
    B = x.shape[0]
    if cross:
        q = _q(params, x, cfg)
        attend = lens
    else:
        q, k, v = _qkv(params, x, cfg)
        if cfg.use_rope:
            q = rope(q, lens[:, None], cfg.rope_theta, cfg.rope_scaling)
            k = rope(k, lens[:, None], cfg.rope_theta, cfg.rope_scaling)
        if shard is not None:
            _write_token(cache_k, _kv_block(k, shard)[:, 0], lens, shard)
            _write_token(cache_v, _kv_block(v, shard)[:, 0], lens, shard)
        else:
            bidx = torch.arange(B, device=x.device)
            cache_k[bidx, lens.long()] = k[:, 0].to(cache_k.dtype)
            cache_v[bidx, lens.long()] = v[:, 0].to(cache_v.dtype)
        attend = lens + 1
    if shard is not None:
        o = _mesh_attend(q, cache_k, cache_v, attend, cfg, window=window,
                         impl=impl, shard=shard)
    elif seq_parallel:
        o = ops.decode_attention_naive(q, cache_k, cache_v, attend,
                                       logit_softcap=cfg.attn_logit_softcap)
    else:
        o = ops.flash_decode(q, cache_k, cache_v, attend, window=window,
                             logit_softcap=cfg.attn_logit_softcap,
                             impl=impl)
    return dense(params["wo"], o.reshape(B, 1, cfg.n_heads * cfg.head_dim))


def _mesh_attend(q: torch.Tensor, cache_k: torch.Tensor,
                 cache_v: torch.Tensor, attend: torch.Tensor,
                 cfg: ModelConfig, *, window: int, impl: Optional[str],
                 shard: CacheShard) -> torch.Tensor:
    """q (B, 1, Hq, D) over the first attend[b] positions of the rank's
    block of the strips (attend counts the whole strip's positions).  A
    whole sequence (the default layout): K3 on the model rank's head
    shard, the heads gathered back over the model axis
    (ops._tp_head_sharded).  A sharded sequence: ops.seq_parallel_decode
    over the sequence's axis, on the rank's heads when the strips hold a
    head block (gathered back as above), on every head otherwise - no
    window, as the JAX package's sequence-sharded decode (ROADMAP §3).
    Returns (B, 1, Hq, D)."""
    softcap = cfg.attn_logit_softcap
    if shard.seq is None:
        def fn(qq, kc, vc, n):
            return ops.flash_decode(qq, kc, vc, n, window=window,
                                    logit_softcap=softcap, impl=impl)
    else:
        def fn(qq, kc, vc, n):
            return ops.seq_parallel_decode(qq, kc, vc, n,
                                           group=shard.seq.group,
                                           logit_softcap=softcap)
    if shard.heads:
        return ops._tp_head_sharded(fn, shard.model, q, cache_k, cache_v,
                                    attend)
    return fn(q, cache_k, cache_v, attend)


def _local_kv(k: torch.Tensor, v: torch.Tensor, tp_mesh):
    """The K/V heads this rank's pools hold: all of them without a mesh,
    its contiguous head block under tensor parallelism.  The counterpart
    of the JAX package's _tp_pool_constrain: k and v come from replicated
    activations, so writing a rank's slice into its own pools is pure
    data movement and changes no attention result."""
    if not ops._tp_active(tp_mesh):
        return k, v
    return ops.shard_heads(k, tp_mesh), ops.shard_heads(v, tp_mesh)


def attn_decode_paged(params, x: torch.Tensor, cfg: ModelConfig,
                      k_pages: torch.Tensor, v_pages: torch.Tensor,
                      block_table: torch.Tensor, lens: torch.Tensor, *,
                      window: int = 0, impl: Optional[str] = None,
                      tp_mesh=None) -> torch.Tensor:
    """Single-token decode through the block table.  x: (B, 1, D);
    block_table: (B, n_max) int32; lens: (B,) int32 current lengths - the
    new token's K/V goes to page lens // page_size at offset
    lens % page_size.  Idle slots (lens 0, zeroed table row) write into the
    null page 0.  tp_mesh (a serve mesh of size N > 1): the pools are this
    rank's (P, page_size, Hkv / N, D) head shard; q, k and v are computed
    for every head from the replicated x, the rank writes its KV heads
    and runs the decode on its head shard (ops.paged_flash_decode), and
    the gathered output goes through wo replicated.  Returns the
    attention block's output (B, 1, D)."""
    B = x.shape[0]
    q, k, v = _qkv(params, x, cfg)
    if cfg.use_rope:
        q = rope(q, lens[:, None], cfg.rope_theta, cfg.rope_scaling)
        k = rope(k, lens[:, None], cfg.rope_theta, cfg.rope_scaling)
    k, v = _local_kv(k, v, tp_mesh)
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
                               impl=impl, tp_mesh=tp_mesh)
    return dense(params["wo"], o.reshape(B, 1, cfg.n_heads * cfg.head_dim))


def attn_prefill_chunks_paged(params, x: torch.Tensor, cfg: ModelConfig,
                              k_pages: torch.Tensor, v_pages: torch.Tensor,
                              page_tables: torch.Tensor,
                              offsets: torch.Tensor, true_lens: torch.Tensor,
                              *, q_lens: Optional[torch.Tensor] = None,
                              window: int = 0, impl: Optional[str] = None,
                              tp_mesh=None) -> torch.Tensor:
    """A ragged batch of K mid-prompt chunks in one pass.  x: (K, S, D), row
    k at absolute positions offsets[k] + arange(S), zero-padded past
    true_lens[k].  Each row's K/V scatters token by token through its table
    row, PAD positions redirected to the null page 0 (two chunks of one
    sequence in one batch never collide); then every row's queries attend
    through the offset-causal batched kernel.  Dead rows (true_len 0,
    all-null table row) write only to the null page.  tp_mesh: as in
    attn_decode_paged.  Returns (K, S, D)."""
    q, k, v = _qkv(params, x, cfg)
    K, S = x.shape[:2]
    ps, n_max = k_pages.shape[1], page_tables.shape[1]
    pos = offsets[:, None] + torch.arange(S, dtype=offsets.dtype,
                                          device=x.device)[None, :]
    if cfg.use_rope:
        q = rope(q, pos, cfg.rope_theta, cfg.rope_scaling)
        k = rope(k, pos, cfg.rope_theta, cfg.rope_scaling)
    k, v = _local_kv(k, v, tp_mesh)
    valid = pos < true_lens[:, None]
    pidx = torch.clamp(pos // ps, max=n_max - 1).long()
    pages = torch.where(valid, torch.gather(page_tables, 1, pidx), 0).long()
    offs = torch.where(valid, pos % ps, 0).long()
    k_pages[pages, offs] = k.to(k_pages.dtype)
    v_pages[pages, offs] = v.to(v_pages.dtype)
    o = ops.batched_paged_prefill_attention(
        q, k_pages, v_pages, page_tables, offsets, true_lens, q_lens,
        window=window, logit_softcap=cfg.attn_logit_softcap, impl=impl,
        tp_mesh=tp_mesh)
    return dense(params["wo"], o.reshape(K, S, cfg.n_heads * cfg.head_dim))


def attn_prefill_chunk_paged(params, x: torch.Tensor, cfg: ModelConfig,
                             k_pages: torch.Tensor, v_pages: torch.Tensor,
                             page_row: torch.Tensor, offset: int, *,
                             window: int = 0, impl: Optional[str] = None,
                             tp_mesh=None) -> torch.Tensor:
    """One mid-prompt chunk of one sequence, the K=1 case: x (1, S, D) at
    positions offset + arange(S), every position real."""
    off = torch.full((1,), int(offset), dtype=torch.int32, device=x.device)
    return attn_prefill_chunks_paged(
        params, x, cfg, k_pages, v_pages,
        page_row.reshape(1, -1).to(torch.int32), off, off + x.shape[1],
        window=window, impl=impl, tp_mesh=tp_mesh)


# the prefix-cache suffix is the final-chunk special case
attn_prefill_suffix_paged = attn_prefill_chunk_paged
