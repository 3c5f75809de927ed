"""Plain PyTorch versions of the attention kernels.

These are the ground truth the hand-written CUDA kernels are held against
(chip_smoke.py's parity phase) and the path every kernel wrapper takes for
a tensor that lies on the CPU.  They follow the JAX package's reference
oracles (repro/kernels/ref.py) line for line: fp32 accumulation whatever
the input dtype, the exp2(x * LOG2E) exponent form, and the NEG_INF /
m_safe guards that make fully masked rows come out exactly zero.

Conventions:
  q, k, v: (batch, seq, heads, head_dim); pools: (num_pages, page_size,
  Hkv, head_dim); GQA when Hkv < Hq (query head j reads KV head j // G).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30
LOG2E = 1.4426950408889634


def _group(h_q: int, h_kv: int) -> int:
    if h_q % h_kv:
        raise ValueError(f"{h_q} query heads do not group over {h_kv} KV "
                         f"heads")
    return h_q // h_kv


def _as_lens(x, n: int, device) -> torch.Tensor:
    x = torch.as_tensor(x, device=device)
    return x.expand(n) if x.dim() == 0 else x


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    logit_softcap: float = 0.0,
                    scale: Optional[float] = None,
                    block_kv: int = 512):
    """Chunked attention over contiguous K/V: an online softmax over KV
    blocks of block_kv positions.  q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv,
    D).  The causal mask is top-left aligned (k_pos <= q_pos, q_pos from
    0) even when Sq != Skv; window > 0 keeps k_pos > q_pos - window and
    implies causal.  Scores are (q . k) * scale in fp32; the weights are
    rounded to q's dtype before the PV product, as the JAX reference does.
    Returns (o (B, Sq, Hq, D) in q's dtype, lse (B, Sq, Hq) fp32 natural
    log-sum-exp of each row, the JAX ops._lse_ref of the same blocks)."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = _group(Hq, Hkv)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    dev = q.device
    qf = q.float().reshape(B, Sq, Hkv, G, D)
    q_pos = torch.arange(Sq, device=dev)
    m = torch.full((B, Sq, Hkv, G), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Sq, Hkv, G), dtype=torch.float32, device=dev)
    o = torch.zeros((B, Sq, Hkv, G, D), dtype=torch.float32, device=dev)
    for j0 in range(0, Skv, block_kv):
        kblk = k[:, j0:j0 + block_kv].float()
        vblk = v[:, j0:j0 + block_kv].float()
        k_pos = j0 + torch.arange(kblk.shape[1], device=dev)
        s = torch.einsum("bqhgd,bkhd->bqhgk", qf, kblk) * scale
        if logit_softcap > 0.0:
            s = logit_softcap * torch.tanh(s / logit_softcap)
        mask = torch.ones((Sq, kblk.shape[1]), dtype=torch.bool, device=dev)
        if causal or window > 0:
            mask = mask & (k_pos[None, :] <= q_pos[:, None])
        if window > 0:
            mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
        mask = mask[None, :, None, None, :]
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        m_safe = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
        p = torch.where(mask, torch.exp2((s - m_safe[..., None]) * LOG2E),
                        0.0)
        alpha = torch.where(m <= NEG_INF / 2, 0.0,
                            torch.exp2((m - m_new) * LOG2E))
        l = l * alpha + p.sum(-1)
        pv = torch.einsum("bqhgk,bkhd->bqhgd", p.to(q.dtype).float(), vblk)
        o = o * alpha[..., None] + pv
        m = m_new
    lc = torch.clamp_min(l, 1e-20)
    o = o / lc[..., None]
    lse = m + torch.log(lc)
    return (o.reshape(B, Sq, Hq, D).to(q.dtype), lse.reshape(B, Sq, Hq))


def flash_decode(q, k_cache, v_cache, cache_len, *,
                 scale: Optional[float] = None, window: int = 0,
                 logit_softcap: float = 0.0,
                 block_kv: int = 1024) -> torch.Tensor:
    """q: (B, 1, Hq, D); k_cache/v_cache: (B, S_max, Hkv, D); cache_len:
    (B,) valid prefix length per sequence.  Online softmax over KV blocks
    of block_kv positions.  Returns (B, 1, Hq, D) in q's dtype."""
    B, Sq, Hq, D = q.shape
    if Sq != 1:
        raise ValueError(f"decode takes one query token, got {Sq}")
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = _group(Hq, Hkv)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    lens = _as_lens(cache_len, B, q.device)
    qf = (q.float() * scale).reshape(B, Hkv, G, D)
    m = torch.full((B, Hkv, G), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Hkv, G), dtype=torch.float32, device=q.device)
    o = torch.zeros((B, Hkv, G, D), dtype=torch.float32, device=q.device)
    for j0 in range(0, S, block_kv):
        kblk = k_cache[:, j0:j0 + block_kv].float()
        vblk = v_cache[:, j0:j0 + block_kv].float()
        pos = j0 + torch.arange(kblk.shape[1], device=q.device)
        s = torch.einsum("bhgd,bkhd->bhgk", qf, kblk)
        if logit_softcap > 0.0:
            s = logit_softcap * torch.tanh(s / logit_softcap)
        mask = pos[None, :] < lens[:, None]
        if window > 0:
            mask = mask & (pos[None, :] >= lens[:, None] - window)
        mask = mask[:, None, None, :]
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        m_safe = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
        p = torch.where(mask, torch.exp2((s - m_safe[..., None]) * LOG2E),
                        0.0)
        alpha = torch.where(m <= NEG_INF / 2, 0.0,
                            torch.exp2((m - m_new) * LOG2E))
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + torch.einsum("bhgk,bkhd->bhgd", p, vblk)
        m = m_new
    o = o / torch.clamp_min(l, 1e-20)[..., None]
    return o.reshape(B, 1, Hq, D).to(q.dtype)


def paged_flash_decode(q, k_pages, v_pages, block_table, cache_len, *,
                       scale: Optional[float] = None, window: int = 0,
                       logit_softcap: float = 0.0) -> torch.Tensor:
    """Decode against a paged KV cache: gather each sequence's pages
    through its block-table row into a contiguous strip, then the chunked
    dense decode above.  q: (B, 1, Hq, D); pools: (P, page_size, Hkv, D);
    block_table: (B, n_max) page ids; cache_len: (B,) or scalar."""
    B = q.shape[0]
    _, ps, Hkv, D = k_pages.shape
    idx = block_table.long()
    k = k_pages[idx].reshape(B, -1, Hkv, D)
    v = v_pages[idx].reshape(B, -1, Hkv, D)
    return flash_decode(q, k, v, cache_len, scale=scale, window=window,
                        logit_softcap=logit_softcap)


def batched_paged_prefill_attention(q, k_pages, v_pages, page_tables,
                                    q_offsets, true_lens, q_lens=None, *,
                                    scale: Optional[float] = None,
                                    window: int = 0,
                                    logit_softcap: float = 0.0
                                    ) -> torch.Tensor:
    """Ragged batch of K mid-prompt chunks, each at its own absolute
    offset, attending through its own block-table row.

    q: (K, S, Hq, D), row k at positions q_offsets[k] + arange(S);
    page_tables: (K, n_max); true_lens: (K,) each row's cursor after its
    last real token (columns at or past it are masked; a dead row with
    true_len 0 returns exactly zero); q_lens: (K,) real query count per
    row (lanes at or past it come back exactly zero), by default
    clip(true_lens - q_offsets, 0, S).  Mask: col <= offset + r, and with
    a window col > offset + r - window."""
    K, S, Hq, D = q.shape
    _, ps, Hkv, _ = k_pages.shape
    G = _group(Hq, Hkv)
    sc = scale if scale is not None else 1.0 / math.sqrt(D)
    dev = q.device
    idx = page_tables.long()
    k = k_pages[idx].reshape(K, -1, Hkv, D).float()
    v = v_pages[idx].reshape(K, -1, Hkv, D).float()
    skv = k.shape[1]
    qf = (q.float() * sc).reshape(K, S, Hkv, G, D)
    s = torch.einsum("bshgd,bkhd->bshgk", qf, k)
    if logit_softcap > 0.0:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    off = torch.as_tensor(q_offsets, device=dev).to(torch.int32)
    tl = torch.as_tensor(true_lens, device=dev).to(torch.int32)
    row = off[:, None] + torch.arange(S, device=dev, dtype=torch.int32)
    col = torch.arange(skv, device=dev, dtype=torch.int32)
    mask = (col[None, None, :] <= row[:, :, None]) \
        & (col[None, None, :] < tl[:, None, None])
    if window > 0:
        mask = mask & (col[None, None, :] > row[:, :, None] - window)
    mask = mask[:, :, None, None, :]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    m_safe = torch.where(m <= NEG_INF / 2, 0.0, m)
    p = torch.where(mask, torch.exp2((s - m_safe) * LOG2E), 0.0)
    l = torch.clamp_min(p.sum(-1, keepdim=True), 1e-20)
    o = torch.einsum("bshgk,bkhd->bshgd", p / l, v)
    ql = torch.clamp(tl - off, 0, S) if q_lens is None \
        else torch.as_tensor(q_lens, device=dev).to(torch.int32)
    qpos = torch.arange(S, device=dev, dtype=torch.int32)[None, :]
    o = torch.where((qpos < ql[:, None])[:, :, None, None, None], o, 0.0)
    return o.reshape(K, S, Hq, D).to(q.dtype)


def paged_prefill_attention(q, k_pages, v_pages, page_row, q_offset, *,
                            scale: Optional[float] = None, window: int = 0,
                            logit_softcap: float = 0.0) -> torch.Tensor:
    """Single-sequence chunk prefill: the K=1 case of the batched version,
    every chunk position real (true_len = q_offset + S).  q: (1, S, Hq, D);
    page_row: (n_max,)."""
    off = torch.as_tensor(q_offset, device=q.device).to(torch.int32)
    off = off.reshape(1)
    return batched_paged_prefill_attention(
        q, k_pages, v_pages, page_row.reshape(1, -1), off, off + q.shape[1],
        scale=scale, window=window, logit_softcap=logit_softcap)


def naive_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    logit_softcap: float = 0.0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Quadratic attention over contiguous (B, S, H, D) tensors: the
    small-shape oracle the paged versions are checked against."""
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    G = _group(Hq, Hkv)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, Sq, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bqhgk", qf * scale, k.float())
    if logit_softcap > 0.0:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal or window > 0:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqhgk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, Hq, D).to(q.dtype)
