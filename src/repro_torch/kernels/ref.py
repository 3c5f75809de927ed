"""Plain PyTorch versions of the kernels: attention, and the Mamba2 and
RWKV6 scans.

These are the ground truth the hand-written CUDA kernels are held against
(chip_smoke.py's parity phase) and the path every kernel wrapper takes for
a tensor that lies on the CPU.  They follow the JAX package's reference
oracles (repro/kernels/ref.py) line for line: fp32 accumulation whatever
the input dtype, the exp2(x * LOG2E) exponent form, and the NEG_INF /
m_safe guards that make fully masked rows come out exactly zero.

Conventions:
  q, k, v: (batch, seq, heads, head_dim); pools: (num_pages, page_size,
  Hkv, head_dim); GQA when Hkv < Hq (query head j reads KV head j // G).
  Scans: x (B, S, H, P), dt (B, S, H), A (H,), Bm / Cm (B, S, N) for
  Mamba2; r, k, w (B, S, H, K), v (B, S, H, V), u (H, K) for RWKV6; the
  recurrent state is float32 whatever the input dtype.
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


# a flat CPU tensor padded to a multiple of this many elements (see _lanes)
_LANE_PAD = 64


def _lanes(fn, x: torch.Tensor) -> torch.Tensor:
    """fn(x) for an elementwise transcendental fn (exp2, tanh), each
    element's result independent of where it sits in x.  On the CPU ATen
    computes float32 exp2 and tanh in vector lanes over a contiguous run
    and the run's last n mod (2 x lanes) elements in scalar code, whose
    results differ from the lanes' in the last bit; a head shard of a
    tensor (tensor-parallel serving) puts other elements in that tail than
    the whole tensor does, so the paged attentions' per-head results
    would depend on the head count.  Padding the flat tensor to a multiple
    of _LANE_PAD elements keeps every element in the lanes (when ATen runs
    the op as one run: one thread, or fewer elements than its parallel
    grain of 32768).  On the GPU fn runs as it is."""
    if x.device.type != "cpu":
        return fn(x)
    flat = x.reshape(-1)
    pad = -flat.numel() % _LANE_PAD
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return fn(flat)[:x.numel()].view(x.shape)


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


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0, logit_softcap: float = 0.0,
                        scale: Optional[float] = None, block_kv: int = 512,
                        terms: bool = False):
    """FlashAttention-2 backward, recomputed from (q, k, v, o, lse) over KV
    blocks of block_kv positions - the JAX package's CPU oracle
    (repro/kernels/ops.py _flash_bwd_rule, the non-Pallas branch) line for
    line.  q, o, do: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D); lse: (B, Sq,
    Hq) natural log, as flash_attention returns it; masks as there.
    delta = rowsum(do . o) in fp32 from do rounded to q's dtype; p =
    exp2((s - lse) * LOG2E) masked; ds = p * (dp - delta), times (1 - t^2)
    under the softcap; p and ds are rounded to q's dtype before the dv, dq
    and dk products (the oracle's pb / dsb; the TPU kernel keeps them in
    fp32), every product accumulates in fp32, and dk / dv sum over the
    GQA group.  Returns (dq, dk, dv) in the dtypes of q, k, v.

    terms=True returns instead the magnitude of the terms each gradient
    sums (every product taken over absolute values, in fp32): one rounding
    step of it is the bfloat16 bar of a kernel that rounds p and ds as this
    function does, since an ulp of difference in a score can flip one of
    those roundings."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = _group(Hq, Hkv)
    sc = scale if scale is not None else 1.0 / math.sqrt(D)
    dev = q.device
    mag = torch.abs if terms else (lambda t: t)
    qb = q.reshape(B, Sq, Hkv, G, D).float()
    dob = do.to(q.dtype).reshape(B, Sq, Hkv, G, D).float()
    lsef = lse.float().reshape(B, Sq, Hkv, G)
    delta = torch.sum(dob * o.reshape(B, Sq, Hkv, G, D).float(), -1)
    q_pos = torch.arange(Sq, device=dev)
    dq = torch.zeros((B, Sq, Hkv, G, D), dtype=torch.float32, device=dev)
    dk, dv = [], []
    for j0 in range(0, Skv, block_kv):
        kblk = k[:, j0:j0 + block_kv].float()
        vblk = v[:, j0:j0 + block_kv].float()
        k_pos = j0 + torch.arange(kblk.shape[1], device=dev)
        s = torch.einsum("bqhgd,bkhd->bqhgk", qb, kblk) * sc
        if logit_softcap > 0.0:
            t = torch.tanh(s / logit_softcap)
            s = logit_softcap * t
        mask = torch.ones((Sq, kblk.shape[1]), dtype=torch.bool, device=dev)
        if causal or window > 0:
            mask = mask & (k_pos[None, :] <= q_pos[:, None])
        if window > 0:
            mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
        mask = mask[None, :, None, None, :]
        p = torch.exp2((s - lsef[..., None]) * LOG2E)
        p = torch.where(mask, p, 0.0)
        pb = p.to(q.dtype).float()
        dv.append(torch.einsum("bqhgk,bqhgd->bkhd", pb, mag(dob)))
        dp = torch.einsum("bqhgd,bkhd->bqhgk", dob, vblk)
        ds = p * (dp - delta[..., None])
        if logit_softcap > 0.0:
            ds = ds * (1.0 - t * t)
        dsb = mag(ds.to(q.dtype).float())
        dq = dq + torch.einsum("bqhgk,bkhd->bqhgd", dsb, mag(kblk)) * sc
        dk.append(torch.einsum("bqhgk,bqhgd->bkhd", dsb, mag(qb)) * sc)
    empty = torch.zeros((B, 0, Hkv, D), dtype=torch.float32, device=dev)
    dk = torch.cat(dk, 1) if dk else empty
    dv = torch.cat(dv, 1) if dv else empty
    if terms:
        return dq.reshape(B, Sq, Hq, D), dk, dv
    return (dq.reshape(B, Sq, Hq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


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
            s = logit_softcap * _lanes(torch.tanh, s / logit_softcap)
        mask = pos[None, :] < lens[:, None]
        if window > 0:
            mask = mask & (pos[None, :] >= lens[:, None] - window)
        mask = mask[:, None, None, :]
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        m_safe = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
        p = torch.where(mask, _lanes(torch.exp2, (s - m_safe[..., None])
                                     * LOG2E), 0.0)
        alpha = torch.where(m <= NEG_INF / 2, 0.0,
                            _lanes(torch.exp2, (m - m_new) * LOG2E))
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


def combine_partial_softmax(m_parts, l_parts, o_parts):
    """Merge per-split partial (m, l, o) triples, the JAX package's
    combine_partial_softmax (repro/kernels/ref.py) line for line: m is the
    largest m_i, alpha_i = exp2((m_i - m_safe) * LOG2E) and 0 for an empty
    partial (m_i = NEG_INF), l = sum l_i alpha_i, o = sum o_i alpha_i.
    m_parts, l_parts: (P, ...); o_parts: (P, ..., D).  Returns (m, l, o),
    o unnormalised."""
    m = torch.amax(m_parts, 0)
    m_safe = torch.where(m <= NEG_INF / 2, 0.0, m)
    alpha = torch.exp2((m_parts - m_safe[None]) * LOG2E)
    alpha = torch.where(m_parts <= NEG_INF / 2, 0.0, alpha)
    l = torch.sum(l_parts * alpha, 0)
    o = torch.sum(o_parts * alpha[..., None], 0)
    return m, l, o


def flash_decode_split(q, k_cache, v_cache, cache_len, *, split: int,
                       scale: Optional[float] = None, window: int = 0,
                       logit_softcap: float = 0.0) -> torch.Tensor:
    """The split-KV form of flash_decode, as the split kernel of K2 and K3
    (csrc/split_decode.cuh) computes it: sequence b's strip of S positions
    is cut into ceil(S / split) parts of `split`; each part's visible
    positions ([max(0, len - window), len)) give an unnormalised partial
    (m, l, o) - m = NEG_INF, l = 0 where none is visible - and
    combine_partial_softmax merges them in split order, o / max(l, 1e-20).
    Same arguments and result as flash_decode.  Only tests use it: it
    holds the kernel's summation structure against the JAX package on the
    CPU."""
    B, _, Hq, D = q.shape
    Hkv = k_cache.shape[2]
    G = _group(Hq, Hkv)
    sc = scale if scale is not None else 1.0 / math.sqrt(D)
    dev = q.device
    k, v = k_cache.float(), v_cache.float()
    lens = _as_lens(cache_len, B, dev)
    qf = (q.float() * sc).reshape(B, Hkv, G, D)
    ms, ls, os_ = [], [], []
    for j0 in range(0, k.shape[1], split):
        kblk, vblk = k[:, j0:j0 + split], v[:, j0:j0 + split]
        pos = j0 + torch.arange(kblk.shape[1], device=dev)
        s = torch.einsum("bhgd,bkhd->bhgk", qf, kblk)
        if logit_softcap > 0.0:
            s = logit_softcap * torch.tanh(s / logit_softcap)
        mask = pos[None, :] < lens[:, None]
        if window > 0:
            mask = mask & (pos[None, :] >= lens[:, None] - window)
        mask = mask[:, None, None, :]
        s = torch.where(mask, s, NEG_INF)
        m = s.amax(-1)
        m_safe = torch.where(m <= NEG_INF / 2, 0.0, m)
        p = torch.where(mask, torch.exp2((s - m_safe[..., None]) * LOG2E),
                        0.0)
        ms.append(m)
        ls.append(p.sum(-1))
        os_.append(torch.einsum("bhgk,bkhd->bhgd", p, vblk))
    if not ms:                   # an empty strip: every lane exactly 0
        return torch.zeros_like(q)
    _, l, o = combine_partial_softmax(torch.stack(ms), torch.stack(ls),
                                      torch.stack(os_))
    o = o / torch.clamp_min(l, 1e-20)[..., None]
    return o.reshape(B, 1, Hq, D).to(q.dtype)


def paged_flash_decode_split(q, k_pages, v_pages, block_table, cache_len, *,
                             split: int, scale: Optional[float] = None,
                             window: int = 0,
                             logit_softcap: float = 0.0) -> torch.Tensor:
    """The split-KV form of paged_flash_decode: each sequence's pages
    gathered through its block-table row into a strip of n_max *
    page_size positions, then flash_decode_split.  Same arguments and
    result as paged_flash_decode; only tests use it."""
    B = q.shape[0]
    _, ps, Hkv, D = k_pages.shape
    idx = block_table.long()
    return flash_decode_split(
        q, k_pages[idx].reshape(B, -1, Hkv, D),
        v_pages[idx].reshape(B, -1, Hkv, D), cache_len, split=split,
        scale=scale, window=window, logit_softcap=logit_softcap)


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
        s = logit_softcap * _lanes(torch.tanh, s / logit_softcap)
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
    p = torch.where(mask, _lanes(torch.exp2, (s - m_safe) * LOG2E), 0.0)
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


# ===========================================================================
# Mamba2 (SSD) selective state space
# ===========================================================================

def mamba2_scan(x, dt, A, Bm, Cm) -> torch.Tensor:
    """Mamba2 SSD recurrence, one step at a time (per-head scalar decay):

      h_t = exp(-dt_t * A) * h_{t-1} + dt_t * (x_t outer B_t)
      y_t = h_t . C_t

    x: (B, S, H, P); dt: (B, S, H) positive step sizes (after softplus);
    A: (H,) positive decay rates; Bm / Cm: (B, S, N), shared by the heads.
    Returns y (B, S, H, P) in x's dtype."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    h = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        h, y = mamba2_step(h, x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t])
        ys.append(y)
    return torch.stack(ys, 1) if ys else x.new_zeros(x.shape)


def mamba2_step(h, x_t, dt_t, A, B_t, C_t):
    """Single decode step.  h: (B, H, P, N) float32 state; x_t (B, H, P);
    dt_t (B, H); B_t / C_t (B, N).  Returns (h', y_t (B, H, P) in x_t's
    dtype)."""
    decay = torch.exp(-dt_t.float() * A.float()[None])
    inject = (dt_t.float()[..., None] * x_t.float())[..., None] \
        * B_t.float()[:, None, None, :]
    h = h * decay[..., None, None] + inject
    y = torch.einsum("bhpn,bn->bhp", h, C_t.float())
    return h, y.to(x_t.dtype)


def mamba2_scan_chunked_state(x, dt, A, Bm, Cm, *, chunk: int = 128):
    """Chunked SSD returning (y, final state (B, H, P, N) float32) - the
    prefill's scan."""
    return _mamba2_chunked(x, dt, A, Bm, Cm, chunk=chunk)


def mamba2_scan_chunked(x, dt, A, Bm, Cm, *, chunk: int = 128):
    """Chunked SSD: the plain version of K6 (csrc/mamba2_scan.cu)."""
    return _mamba2_chunked(x, dt, A, Bm, Cm, chunk=chunk)[0]



def _acc(t: torch.Tensor) -> torch.dtype:
    """The chunked scans' working dtype: float32 for float32 and bfloat16
    inputs, float64 for float64 ones (the plain backwards)."""
    return torch.promote_types(t.dtype, torch.float32)


def _grad_through(fn, inputs, dy):
    """torch.autograd.grad of fn(*inputs) against dy, in float64, on
    detached float64 copies of the inputs (the caller's graph untouched):
    the gradients rounded to the inputs' dtypes once.  float64 because
    the chunked forms' float32 gradient of the decay parameters loses
    digits: each csum_t - csum_s difference of cumulative log decays, and
    its gradient, is the difference of two sums that grow over the chunk,
    so Mamba2's dA lands 1e-5 (dt A ~0.3) to 4e-4 (dt A ~6) of its
    largest element from the float64 one, where the step-by-step
    recurrence - the float32 backward kernels' form - stays within 1e-6
    (tests/test_torch_scan_backward.py), and the bf16 K6_bwd's chunked
    form, which never subtracts two such sums, within 2e-6
    (mamba2_scan_bwd_chunk_parallel, tests/
    test_torch_mamba2_bwd_parts.py)."""
    with torch.enable_grad():
        ins = [t.detach().double().requires_grad_(True) for t in inputs]
        y = fn(*ins)
        grads = torch.autograd.grad(y, ins, dy.to(y.dtype))
    return tuple(g.to(t.dtype) for g, t in zip(grads, inputs))


def mamba2_scan_bwd(x, dt, A, Bm, Cm, dy, *, chunk: int = 128):
    """The plain backward of the Mamba2 scan, the plain version of the
    backward kernel csrc/mamba2_scan_bwd.cu: torch.autograd.grad through
    mamba2_scan_chunked (the function the JAX package differentiates,
    with the exponents masked before the exp), in float64
    (_grad_through).  dy: (B, S, H, P).
    Returns (dx, ddt, dA, dBm, dCm), each in its input's dtype (dt and A
    float32)."""
    return _grad_through(
        lambda *a: mamba2_scan_chunked(*a, chunk=chunk), (x, dt, A, Bm, Cm),
        dy)

def _mamba2_chunked(x, dt, A, Bm, Cm, *, chunk: int = 128):
    """Chunked matrix-form SSD, the JAX package's _mamba2_chunked: within a
    chunk of T steps y = (C B^T * L) (dt x) with L[t, s] = exp(csum_t -
    csum_s) for s <= t, plus the carry-in exp(csum_t) C_t . h; the (P, N)
    state crosses chunk boundaries.  S is zero-padded to a chunk multiple
    (dt = 0: a no-op step).  The pairs above the diagonal are masked
    before the exp (the JAX version multiplies by the mask after it, which
    turns an overflowing exp(csum_t - csum_s), t < s, into 0 * inf = NaN
    at large dt * A); every value it keeps is the same."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    pad = (-S) % chunk
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        Bm = torch.nn.functional.pad(Bm, (0, 0, 0, pad))
        Cm = torch.nn.functional.pad(Cm, (0, 0, 0, pad))
    acc = _acc(x)
    Af = A.to(acc)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    h = torch.zeros((Bsz, H, P, N), dtype=acc, device=x.device)
    ys = []
    for c0 in range(0, S + pad, chunk):
        xf = x[:, c0:c0 + chunk].to(acc)
        dtf = dt[:, c0:c0 + chunk].to(acc)
        bf = Bm[:, c0:c0 + chunk].to(acc)
        cf = Cm[:, c0:c0 + chunk].to(acc)
        log_a = -dtf * Af[None, None]                        # (B, T, H)
        csum = torch.cumsum(log_a, 1)
        diff = csum[:, :, None] - csum[:, None, :]           # (B, T, T, H)
        M = torch.exp(torch.where(tri[None, :, :, None], diff,
                                  float("-inf")))
        CB = torch.einsum("btn,bsn->bts", cf, bf)
        xw = xf * dtf[..., None]                             # (B, T, H, P)
        y = torch.einsum("btsh,bshp->bthp", CB[..., None] * M, xw)
        y = y + torch.exp(csum)[..., None] \
            * torch.einsum("btn,bhpn->bthp", cf, h)
        wout = torch.exp(csum[:, -1][:, None] - csum)[..., None] * xw
        h_new = torch.einsum("bthp,btn->bhpn", wout, bf)
        h = torch.exp(csum[:, -1])[..., None, None] * h + h_new
        ys.append(y.to(x.dtype))
    y = torch.cat(ys, 1) if ys else x
    return y[:, :S], h


def mamba2_scan_chunk_parallel(x, dt, A, Bm, Cm, *, chunk: int = 128,
                               operand=None):
    """The chunk-parallel form of the chunked SSD whose arithmetic K6's bf16
    kernel runs (csrc/mamba2_scan.cu: passes 1 and 2 in one launch, serial
    over the chunks with the state in registers, pass 3 in a second), in
    three passes.  With csum the inclusive cumulative sum of -dt * A within
    each chunk of `chunk` steps and e_c = exp(csum_last) the chunk's total
    decay:

      1. chunk-local, every chunk at once: the chunk's state contribution
         dH_c = sum_s (x_s w_s) outer B_s, w_s = exp(csum_last - csum_s)
         dt_s;
      2. state, serial over the chunks only: H_c = e_c H_{c-1} + dH_c from
         H_{-1} = 0, which gives each chunk its carry-in state H_{c-1};
      3. output, every chunk at once: y_t = sum_{s <= t} W[t, s] x_s +
         exp(csum_t) C_t . H_{c-1}, W[t, s] = (C_t . B_s) exp(csum_t -
         csum_s) dt_s, the pairs above the diagonal masked before the exp
         (only differences of csum are exponentiated, so nothing
         overflows); y rounded to x's dtype once.

    S is zero-padded to a chunk multiple (dt = 0: a no-op step).  operand
    (identity by default) is applied to each float32 operand of a product -
    x w, W and H - before it: tests pass the kernel's bf16 parts to emulate
    its tensor-core arithmetic.  Returns y (B, S, H, P) in x's dtype; the
    same function as mamba2_scan_chunked."""
    op = operand if operand is not None else (lambda t: t)
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    pad = (-S) % chunk
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        Bm = torch.nn.functional.pad(Bm, (0, 0, 0, pad))
        Cm = torch.nn.functional.pad(Cm, (0, 0, 0, pad))
    nc = (S + pad) // chunk
    xf = x.float().reshape(Bsz, nc, chunk, H, P)
    dtf = dt.float().reshape(Bsz, nc, chunk, H)
    bf = Bm.float().reshape(Bsz, nc, chunk, N)
    cf = Cm.float().reshape(Bsz, nc, chunk, N)
    csum = torch.cumsum(-dtf * A.float(), 2)                # (B, nc, T, H)
    last = csum[:, :, -1]                                   # (B, nc, H)
    # 1. chunk-local state contributions
    w = torch.exp(last[:, :, None] - csum) * dtf
    dH = torch.einsum("bcthp,bctn->bchpn", op(xf * w[..., None]), bf)
    # 2. the state pass, serial over chunks
    h = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = torch.exp(last[:, c])[..., None, None] * h + dH[:, c]
    h_in = torch.stack(h_in, 1) if h_in else dH
    # 3. intra-chunk products and the carry-in
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))[None, None, :, :, None]
    diff = csum[:, :, :, None] - csum[:, :, None]            # (B, nc, t, s, H)
    L = torch.exp(torch.where(tri, diff, float("-inf")))
    CB = torch.einsum("bctn,bcsn->bcts", cf, bf)
    W = op(CB[..., None] * L * dtf[:, :, None])
    y = torch.einsum("bctsh,bcshp->bcthp", W, xf) + torch.exp(csum)[
        ..., None] * torch.einsum("bctn,bchpn->bcthp", cf, op(h_in))
    return y.to(x.dtype).reshape(Bsz, nc * chunk, H, P)[:, :S]


def _csum_pairs(log_a):
    """The inclusive cumulative sum over dim 2 as two parts of log_a's
    dtype, hi + lo: hi the running sum, lo the running sum of hi's
    rounding errors (each exact by TwoSum), the compensated sum
    csrc/mamba2_scan_bwd.cu takes within a chunk."""
    hi = torch.zeros_like(log_a[:, :, 0])
    lo = torch.zeros_like(hi)
    his, los = [], []
    for t in range(log_a.shape[2]):
        a = log_a[:, :, t]
        s = hi + a
        bp = s - hi
        lo = lo + ((hi - (s - bp)) + (a - bp))
        hi = s
        his.append(hi)
        los.append(lo)
    return torch.stack(his, 2), torch.stack(los, 2)


def mamba2_scan_bwd_chunk_parallel(x, dt, A, Bm, Cm, dy, *,
                                   chunk: int = 128, operand=None):
    """The chunked backward of the Mamba2 scan whose arithmetic K6_bwd's
    bf16 kernel runs (csrc/mamba2_scan_bwd.cu), in float32 (float64 for
    float64 inputs).  With csum the inclusive cumulative sum of -dt * A
    within each chunk, e_c = exp(csum_last), the adjoint g_t = dL/dh_t:

      1. carry-in states H_{c-1}, serial over the chunks (K6's state pass);
      2. adjoint carries G_c = dL/dh at chunk c's end from the later chunks
         only, serial over the chunks in reverse: G_{c-1} = e_c G_c +
         sum_t exp(csum_t) dy_t outer C_t, from G_last = 0;
      3. every chunk at once: gB_t = sum_n g_t B_t = sum_{t' >= t}
         (C_t' . B_t) exp(csum_t' - csum_t) dy_t' + exp(csum_last -
         csum_t) G_c B_t, so dx_t = dt_t gB_t and ddt's first term is x_t .
         gB_t; with Q[t', s] = (dy_t' . x_s) exp(csum_t' - csum_s) dt_s
         (s <= t', masked before the exp), dC_t' = sum_heads Q B +
         exp(csum_t') dy_t' H_{c-1} and dB_s = sum_heads Q^T C + exp(
         csum_last - csum_s) dt_s x_s G_c;
      4. the decay term X_t = a_t <h_{t-1}, g_t>, for ddt's second term -A
         X_t and dA = -sum dt_t X_t, as sums of products that never
         subtract two sums growing over the chunk: the pairs s < t <= t'
         of M[t', s] = Q[t', s] (C_t' . B_s) (a suffix over t', then a sum
         over s < t), plus the carry terms sum_{s < t} u_s + sum_{t' >= t}
         v_t' + exp(csum_last) <H_{c-1}, G_c>, u_s = B_s . (dB_s's carry
         term), v_t' = C_t' . (dC_t''s carry term).

    The carries' passes take csum as K6's state pass does, one float32
    cumulative sum.  Steps 3 and 4 take it as two float32 parts, hi + lo
    (a compensated sum, _csum_pairs), and each exponent as (hi_t - hi_s) +
    (lo_t - lo_s): at dt A ~6 a step csum reaches ~-800 within a chunk,
    where one float32's rounding puts exp(csum_t - csum_s) ~1e-4 off, and
    ddt and dA 2e-5 of their largest element off the float64 gradient.

    S is zero-padded to a chunk multiple (dt = 0: a no-op step).  operand
    (identity by default) is applied to each float32 operand of a product
    - x w and dy exp(csum) in the carries' passes, the two T x T weights
    (C . B) exp(.) and Q, and H, G - before it: tests pass the kernel's
    bf16 parts to emulate its tensor-core arithmetic.  Returns (dx, ddt,
    dA, dBm, dCm) as mamba2_scan_bwd: dx, dBm, dCm in x's dtype, ddt and
    dA in dt's."""
    op = operand if operand is not None else (lambda t: t)
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    pad = (-S) % chunk
    if pad:
        x, dy = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                 for t in (x, dy))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        Bm, Cm = (torch.nn.functional.pad(t, (0, 0, 0, pad))
                  for t in (Bm, Cm))
    nc, T = (S + pad) // chunk, chunk
    acc = _acc(x)
    xf = x.to(acc).reshape(Bsz, nc, T, H, P)
    dyf = dy.to(acc).reshape(Bsz, nc, T, H, P)
    dtf = dt.to(acc).reshape(Bsz, nc, T, H)
    bf = Bm.to(acc).reshape(Bsz, nc, T, N)
    cf = Cm.to(acc).reshape(Bsz, nc, T, N)
    log_a = -dtf * A.to(acc)
    csum = torch.cumsum(log_a, 2)                           # (B, nc, T, H)
    last = csum[:, :, -1]                                   # (B, nc, H)
    # 1. / 2. the carries, serial over the chunks
    w = torch.exp(last[:, :, None] - csum) * dtf
    dH = torch.einsum("bcthp,bctn->bchpn", op(xf * w[..., None]), bf)
    dG = torch.einsum("bcthp,bctn->bchpn",
                      op(dyf * torch.exp(csum)[..., None]), cf)
    h_in, g_out = [None] * nc, [None] * nc
    h = torch.zeros((Bsz, H, P, N), dtype=acc, device=x.device)
    g = torch.zeros_like(h)
    for c in range(nc):
        h_in[c] = h
        h = torch.exp(last[:, c])[..., None, None] * h + dH[:, c]
    for c in reversed(range(nc)):
        g_out[c] = g
        g = torch.exp(last[:, c])[..., None, None] * g + dG[:, c]
    Hn = op(torch.stack(h_in, 1)) if nc else dH
    Gn = op(torch.stack(g_out, 1)) if nc else dG
    # 3. every chunk at once, csum as two parts; [t', s] pairs, s <= t'
    hi, lo = _csum_pairs(log_a)
    e_cs = torch.exp(hi + lo)                               # exp(cs_t)
    e_last = e_cs[:, :, -1]
    e_end = torch.exp((hi[:, :, -1:] - hi) + (lo[:, :, -1:] - lo))
    w = e_end * dtf
    tri = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device)
                     )[None, None, :, :, None]
    diff = (hi[:, :, :, None] - hi[:, :, None]) \
        + (lo[:, :, :, None] - lo[:, :, None])              # (B, nc, t', s, H)
    L = torch.exp(torch.where(tri, diff, float("-inf")))
    CB = torch.einsum("bcun,bcsn->bcus", cf, bf)            # C_t' . B_s
    gB = torch.einsum("bcush,bcuhp->bcshp", op(CB[..., None] * L), dyf) \
        + e_end[..., None] * torch.einsum("bcsn,bchpn->bcshp", bf, Gn)
    Q = torch.einsum("bcuhp,bcshp->bcush", dyf, xf) * L * dtf[:, :, None]
    Qo = op(Q)
    carry_c = e_cs[..., None] * torch.einsum(
        "bcuhp,bchpn->bcuhn", dyf, Hn)
    carry_b = w[..., None] * torch.einsum("bcshp,bchpn->bcshn", xf, Gn)
    dC = torch.einsum("bcush,bcsn->bcun", Qo, bf) + carry_c.sum(3)
    dB = torch.einsum("bcush,bcun->bcsn", Qo, cf) + carry_b.sum(3)
    # 4. the decay term: suffix over t' of M[t', s], summed over s < t
    M = Q * CB[..., None]
    suf = torch.flip(torch.cumsum(torch.flip(M, (2,)), 2), (2,))
    below = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                  device=x.device), -1)[None, None, :, :, None]
    X = torch.where(below, suf, 0.0).sum(3)                 # (B, nc, T, H)
    u = (carry_b * bf[:, :, :, None]).sum(-1)
    v = (carry_c * cf[:, :, :, None]).sum(-1)
    u_before = torch.cumsum(u, 2)
    X = X + torch.cat([torch.zeros_like(u[:, :, :1]), u_before[:, :, :-1]],
                      2)
    X = X + torch.flip(torch.cumsum(torch.flip(v, (2,)), 2), (2,))
    X = X + (e_last * (Hn * Gn).sum((-2, -1)))[:, :, None]
    ddt = (xf * gB).sum(-1) - A.to(acc) * X
    dA = -(dtf * X).sum((0, 1, 2))
    unchunk = lambda t: t.reshape(Bsz, nc * T, *t.shape[3:])[:, :S]
    return (unchunk(dtf[..., None] * gB).to(x.dtype),
            unchunk(ddt).to(dt.dtype), dA.to(A.dtype),
            unchunk(dB).to(Bm.dtype), unchunk(dC).to(Cm.dtype))


# ===========================================================================
# RWKV6 (Finch) WKV recurrence with data-dependent decay
# ===========================================================================

def rwkv6_scan(r, k, v, w, u) -> torch.Tensor:
    """WKV6, one step at a time:

      S_t = diag(w_t) S_{t-1} + k_t^T v_t
      y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

    r, k, w: (B, S, H, K), w the decay in (0, 1); v: (B, S, H, V); u:
    (H, K) bonus.  Returns y (B, S, H, V) in r's dtype."""
    Bsz, S, H, K = r.shape
    V = v.shape[-1]
    st = torch.zeros((Bsz, H, K, V), dtype=torch.float32, device=r.device)
    ys = []
    for t in range(S):
        st, y = rwkv6_step(st, r[:, t], k[:, t], v[:, t], w[:, t], u)
        ys.append(y)
    return torch.stack(ys, 1) if ys else r.new_zeros(v.shape)


def rwkv6_step(state, r_t, k_t, v_t, w_t, u):
    """Single decode step.  state: (B, H, K, V) float32; r_t / k_t / w_t
    (B, H, K); v_t (B, H, V).  Returns (state', y_t (B, H, V) in r_t's
    dtype)."""
    kv = k_t.float()[..., :, None] * v_t.float()[..., None, :]
    y = torch.einsum("bhk,bhkv->bhv", r_t.float(),
                     state + u.float()[None, :, :, None] * kv)
    state = state * w_t.float()[..., :, None] + kv
    return state, y.to(r_t.dtype)


def rwkv6_scan_chunked_state(r, k, v, w, u, *, chunk: int = 32):
    """Chunked WKV6 returning (y, final state (B, H, K, V) float32) - the
    prefill's scan."""
    return _rwkv6_chunked(r, k, v, w, u, chunk=chunk)


def rwkv6_scan_chunked(r, k, v, w, u, *, chunk: int = 32):
    """Chunked WKV6: the plain version of K7 (csrc/rwkv6_scan.cu)."""
    return _rwkv6_chunked(r, k, v, w, u, chunk=chunk)[0]



def rwkv6_scan_bwd(r, k, v, w, u, dy, *, chunk: int = 32):
    """The plain backward of the RWKV6 scan, the plain version of the
    backward kernel csrc/rwkv6_scan_bwd.cu: torch.autograd.grad through
    rwkv6_scan_chunked (the function the JAX package differentiates), in
    float64 (_grad_through).
    dy: (B, S, H, V).  Returns (dr, dk, dv, dw, du), each in its input's
    dtype (w and u float32)."""
    return _grad_through(
        lambda *a: rwkv6_scan_chunked(*a, chunk=chunk), (r, k, v, w, u), dy)

def _rwkv6_chunked(r, k, v, w, u, *, chunk: int = 32):
    """Chunked matrix-form WKV6, the JAX package's _rwkv6_chunked: with cw
    the inclusive cumulative log decay of a chunk, y_t = sum_{s<t} (r_t
    e^{cw_{t-1}}) . (k_s e^{-cw_s}) v_s + (r_t u . k_t) v_t + (r_t
    e^{cw_{t-1}}) S_in.  e^{-cw} stays finite in float32 only while
    chunk * |log w| stays below ~88: the model clamps w >= exp(-exp(0.75))
    and the chunk is 32.  S is padded to a chunk multiple with w = 1 (a
    no-op decay)."""
    Bsz, S, H, K = r.shape
    V = v.shape[-1]
    pad = (-S) % chunk
    if pad:
        zp = (0, 0, 0, 0, 0, pad)
        r = torch.nn.functional.pad(r, zp)
        k = torch.nn.functional.pad(k, zp)
        v = torch.nn.functional.pad(v, zp)
        w = torch.nn.functional.pad(w, zp, value=1.0)
    acc = _acc(r)
    uf = u.to(acc)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=acc,
                                device=r.device), -1)
    st = torch.zeros((Bsz, H, K, V), dtype=acc, device=r.device)
    ys = []
    for c0 in range(0, S + pad, chunk):
        rt, kt, vt, wt = (t[:, c0:c0 + chunk].to(acc) for t in (r, k, v, w))
        logw = torch.log(torch.clamp_min(wt, 1e-30))
        cw = torch.cumsum(logw, 1)
        cw_prev = cw - logw
        r_dec = rt * torch.exp(cw_prev)
        k_dec = kt * torch.exp(-cw)
        A = torch.einsum("bthk,bshk->bhts", r_dec, k_dec) * tri[None, None]
        y = torch.einsum("bhts,bshv->bthv", A, vt)
        diag = torch.sum(rt * uf[None, None] * kt, -1, keepdim=True)
        y = y + diag * vt
        y = y + torch.einsum("bthk,bhkv->bthv", r_dec, st)
        k_out = k_dec * torch.exp(cw[:, -1])[:, None]
        s_new = torch.einsum("bthk,bthv->bhkv", k_out, vt)
        st = torch.exp(cw[:, -1])[..., None] * st + s_new
        ys.append(y.to(r.dtype))
    y = torch.cat(ys, 1) if ys else r.new_zeros(v.shape)
    return y[:, :S], st


def rwkv6_scan_chunk_parallel(r, k, v, w, u, *, chunk: int = 64,
                              operand=None):
    """The chunk-parallel form of the chunked WKV6 whose arithmetic K7's
    bf16 kernel runs (csrc/rwkv6_scan.cu: passes 1 and 2 in one launch,
    serial over the chunks with the state in registers, pass 3 in a
    second), in three passes.  With cw the inclusive cumulative sum of
    log w within each chunk of `chunk` steps, per key channel, and cw_last
    its value at the chunk's last step:

      1. chunk-local, every chunk at once: the chunk's state contribution
         dS_c = sum_s (k_s e^{cw_last - cw_s})^T v_s and its decay
         e^{cw_last};
      2. state, serial over the chunks only: S_c = diag(e^{cw_last})
         S_{c-1} + dS_c from S_{-1} = 0, which gives each chunk its
         carry-in state S_{c-1};
      3. output, every chunk at once: y_t = sum_{s<t} A[t, s] v_s + (r_t
         u . k_t) v_t + (r_t e^{cw_{t-1}}) S_{c-1}, with the intra-chunk
         weights A[t, s] = sum_c r_tc k_sc e^{cw_{t-1,c} - cw_{s,c}}.

    Pass 3 cuts the chunk into sub-chunks of 16 steps, the kernel's m-tile
    (the secondary chunking of Yang et al., arXiv:2312.06635; `chunk` is
    a multiple of 16): between two sub-chunks A
    is the product of r_t e^{cw_{t-1} - b} and k_s e^{b - cw_s}, b the cw
    just before t's sub-chunk; inside one, each weight is formed from its
    own difference, the pairs s >= t masked before the exp.  Only
    differences of cw are exponentiated and none is positive, so no
    factor exceeds 1 and the result stays finite for any w in (0, 1] (the
    chunked form's e^{-cw} overflows below the model's clamp).

    operand(name, t) (identity by default) is applied to each float32
    operand of a product before it: "r_sub" (r_t e^{cw_{t-1} - b}),
    "k_sub" (k_s e^{b - cw_s}), "weights" (A, with the bonus (r_t u . k_t)
    on its diagonal), "r_dec" (r_t e^{cw_{t-1}}), "state" (S_{c-1}) and
    "k_out" (k_s e^{cw_last - cw_s}); tests pass the kernel's bf16 parts
    to emulate its tensor-core arithmetic.  S is padded to a chunk
    multiple with w = 1 (a no-op decay).  Returns y (B, S, H, V) in r's
    dtype; the same function as rwkv6_scan_chunked."""
    sub = 16
    if chunk % sub:
        raise ValueError(f"chunk {chunk} is no multiple of {sub}")
    op = operand if operand is not None else (lambda name, t: t)
    Bsz, S, H, K = r.shape
    V = v.shape[-1]
    pad = (-S) % chunk
    if pad:
        zp = (0, 0, 0, 0, 0, pad)
        r, k, v = (torch.nn.functional.pad(t, zp) for t in (r, k, v))
        w = torch.nn.functional.pad(w, zp, value=1.0)
    nc, ns = (S + pad) // chunk, chunk // sub
    rf, kf, wf = (t.float().reshape(Bsz, nc, chunk, H, K) for t in (r, k, w))
    vf = v.float().reshape(Bsz, nc, chunk, H, V)
    logw = torch.log(torch.clamp_min(wf, 1e-30))
    cw = torch.cumsum(logw, 2)                              # (B, nc, T, H, K)
    # cw_{t-1}, shifted (not cw - log w, whose rounding at |cw| ~ 400 moves
    # the weight of s = t - 1, exactly 1, by ~3e-5)
    cwp = torch.nn.functional.pad(cw[:, :, :-1], (0, 0, 0, 0, 1, 0))
    last = cw[:, :, -1]                                     # (B, nc, H, K)
    # 1. / 2. chunk-local state contributions, then the state pass
    s_in = _rwkv6_carries(kf, vf, cw, op)                   # (B, nc, H, K, V)
    # 3. the intra-chunk weights, sub-chunk by sub-chunk
    sh = (Bsz, nc, ns, sub, H, K)
    rs, ks, cws, cwps = (t.reshape(sh) for t in (rf, kf, cw, cwp))
    b = cwps[:, :, :, :1]                # cw before each sub-chunk
    r_sub = op("r_sub", rs * torch.exp(cwps - b))
    A = torch.zeros((Bsz, nc, H, chunk, chunk), dtype=torch.float32,
                    device=r.device)
    for i in range(ns):
        for j in range(i):
            k_sub = op("k_sub", ks[:, :, j] * torch.exp(b[:, :, i]
                                                        - cws[:, :, j]))
            A[..., i * sub:(i + 1) * sub, j * sub:(j + 1) * sub] = \
                torch.einsum("bcthk,bcshk->bchts", r_sub[:, :, i], k_sub)
    lower = torch.tril(torch.ones((sub, sub), dtype=torch.bool,
                                  device=r.device), -1)[:, :, None, None]
    diff = cwps[:, :, :, :, None] - cws[:, :, :, None]      # (.., t, s, H, K)
    L = torch.exp(torch.where(lower, diff, float("-inf")))
    D = torch.einsum("bcnthk,bcnshk,bcntshk->bcnhts", rs, ks, L)
    bonus = torch.einsum("bcnthk,hk,bcnthk->bcnht", rs, u.float(), ks)
    D = D + torch.diag_embed(bonus)
    for i in range(ns):
        A[..., i * sub:(i + 1) * sub, i * sub:(i + 1) * sub] = D[:, :, i]
    y = torch.einsum("bchts,bcshv->bcthv", op("weights", A), vf) \
        + torch.einsum("bcthk,bchkv->bcthv", op("r_dec", rf * torch.exp(cwp)),
                       op("state", s_in))
    return y.to(r.dtype).reshape(Bsz, nc * chunk, H, V)[:, :S]


def _rwkv6_carries(kf, vf, cw, op):
    """Passes 1 and 2 of rwkv6_scan_chunk_parallel: each chunk's carry-in
    state (B, nc, H, K, V), from kf (B, nc, T, H, K), vf (B, nc, T, H, V)
    and cw, the chunks' inclusive cumulative log decays."""
    Bsz, nc, _, H, K = kf.shape
    last = cw[:, :, -1]
    k_out = op("k_out", kf * torch.exp(last[:, :, None] - cw))
    dS = torch.einsum("bcthk,bcthv->bchkv", k_out, vf)
    st = torch.zeros((Bsz, H, K, vf.shape[-1]), dtype=torch.float32,
                     device=kf.device)
    s_in = []
    for c in range(nc):
        s_in.append(st)
        st = torch.exp(last[:, c])[..., None] * st + dS[:, c]
    return torch.stack(s_in, 1)


def rwkv6_scan_bwd_chunk_parallel(r, k, v, w, u, dy, *, chunk: int = 64,
                                  operand=None):
    """The chunked backward of the RWKV6 scan whose arithmetic K7_bwd's
    bf16 kernel runs (csrc/rwkv6_scan_bwd.cu), in float32.  With cw the
    inclusive cumulative log decay within each chunk of `chunk` steps per
    key channel, S_{t-1} the state before step t and G_t = dL/dS_t:

      1. carries, serial over the chunks: S_in = S_{c-1}, each chunk's
         carry-in (rwkv6_scan_chunk_parallel's passes 1 and 2), and, in
         reverse, G_out, the adjoint at each chunk's last step from the
         later chunks: the same passes on the time-reversed sequence with
         r in place of k and dy in place of v, since G_{t-1} = diag(w_t)
         G_t + r_t^T dy_t is the forward recurrence read backward;
      2. dv_t = G_t^T k_t + (k_t u . r_t) dy_t: the reversed sequence's
         forward output (rwkv6_scan_chunk_parallel on it, with k and r
         swapped, dy as v and the carries of step 1);
      3. every chunk at once, per key channel, P[m][t'] = v_m . dy_t',
         X = dy S_in^T, Y = v G_out^T and H_t'(m) = (S_{m-1} dy_t')[c]
         from H(0) = X, H(m + 1) = w_m H(m) + k_m P[m][.]:
           dr_m = H_m(m) + u k_m (v_m . dy_m),
           dk_m = sum_{t' > m} E_t'(m) r_t' P[m][t'] + e_m Y_m
                  + r_m u (v_m . dy_m),
           dw_m = S_{m-1}[c] . G_m[c] = sum_{t' > m} E_t'(m) r_t' H_t'(m)
                  + e_m (S_{m-1} . G_out)[c],
         with E_t'(m) = prod_{q=m+1}^{t'-1} w_q and e_m = prod_{q>m} w_q:
         each term a product of w over a span that leaves w_m out, so
         nothing is divided by w and nothing cancels (GLA's d log w, the
         reverse cumulative sum of r dr - k dk over w, subtracts two sums
         that grow over the chunk: tests/test_torch_rwkv6_bwd_parts.py);
         du = sum r_m k_m (v_m . dy_m).

    The kernel forms E and e as running products of w; here they are
    cumulative products too, and S_{m-1} . G_out runs beside H from S_in .
    G_out.  S is padded to a chunk multiple with w = 1 (a no-op step).
    operand(name, t) (identity by default) is applied to each float32
    operand of a tensor-core product before it: "k_out" and "r_in" (the
    carries' contributions, k_s e^{cw_last - cw_s} and r_t e^{cw_{t-1}}),
    "state" and "adjoint" (S_in and G_out, in X, Y, S_in . G_out and dv's
    carry-in), and dv's other four as rwkv6_scan_chunk_parallel names them
    with "dv_" before ("dv_r_sub", "dv_k_sub", "dv_weights", "dv_r_dec");
    tests pass the kernel's bf16 parts to emulate its arithmetic.  Returns
    (dr, dk, dv, dw, du) as rwkv6_scan_bwd: dr, dk, dv in r's dtype, dw
    and du float32."""
    op = operand if operand is not None else (lambda name, t: t)
    Bsz, S, H, K = r.shape
    V = v.shape[-1]
    pad = (-S) % chunk
    if pad:
        zp = (0, 0, 0, 0, 0, pad)
        r, k, v, dy = (torch.nn.functional.pad(t, zp) for t in (r, k, v, dy))
        w = torch.nn.functional.pad(w, zp, value=1.0)
    nc, T = (S + pad) // chunk, chunk
    rf, kf, wf = (t.float().reshape(Bsz, nc, T, H, K) for t in (r, k, w))
    vf, dyf = (t.float().reshape(Bsz, nc, T, H, V) for t in (v, dy))
    uf = u.float()
    logw = torch.log(torch.clamp_min(wf, 1e-30))
    cw = torch.cumsum(logw, 2)
    # 1. the carries; the adjoint's from the reversed chunks' cumulative
    # log decays
    s_in = op("state", _rwkv6_carries(kf, vf, cw, op))
    rev = lambda t: t.flip(1).flip(2)       # chunks and steps reversed
    cw_r = torch.cumsum(rev(logw), 2)
    g_out = _rwkv6_carries(
        rev(rf), rev(dyf), cw_r,
        lambda name, t: op("r_in" if name == "k_out" else name, t)).flip(1)
    g_out = op("adjoint", g_out)
    # 2. dv: the reversed sequence's forward output, its carries g_out's
    names = {"k_out": "r_in", "state": "adjoint"}
    flat = lambda t: t.reshape(Bsz, nc * T, *t.shape[3:]).flip(1)
    dv = rwkv6_scan_chunk_parallel(
        flat(kf).to(r.dtype), flat(rf).to(r.dtype), flat(dyf).to(r.dtype),
        flat(wf), u, chunk=chunk,
        operand=lambda name, t: op(names.get(name, "dv_" + name), t))
    dv = dv.flip(1)[:, :S]
    # 3. dr, dk, dw per channel; P[m][t'] = v_m . dy_t'
    P = torch.einsum("bcmhv,bcthv->bcmth", vf, dyf)         # (B, nc, T, T, H)
    X = torch.einsum("bcthv,bchkv->bcthk", dyf, s_in)
    Y = torch.einsum("bcshv,bchkv->bcshk", vf, g_out)
    hg = (s_in * g_out).sum(-1)                             # S_{-1} . G_out
    vdy = torch.diagonal(P, dim1=2, dim2=3).permute(0, 1, 3, 2)[..., None]
    ones = torch.ones_like(wf[:, :, :1])
    # e_m = prod_{q > m} w_q
    e = torch.cat([torch.flip(torch.cumprod(torch.flip(wf[:, :, 1:], (2,)),
                                            2), (2,)), ones], 2)
    Hc = X
    dr, dk, dw = [], [], []
    for m in range(T):
        # E_t'(m) for t' > m: 1, w_{m+1}, w_{m+1} w_{m+2}, ...
        E = torch.cumprod(torch.cat([ones, wf[:, :, m + 1:T - 1]], 2),
                          2)[:, :, :T - 1 - m]
        Pm = P[:, :, m, m + 1:, :, None]                    # (B, nc, t', H, 1)
        rt = rf[:, :, m + 1:]
        dr.append(Hc[:, :, m])
        dk.append((E * rt * Pm).sum(2) + e[:, :, m] * Y[:, :, m])
        dw.append((E * rt * Hc[:, :, m + 1:]).sum(2) + e[:, :, m] * hg)
        Hc = wf[:, :, m:m + 1] * Hc + kf[:, :, m:m + 1] * P[:, :, m, :, :,
                                                              None]
        hg = wf[:, :, m] * hg + kf[:, :, m] * Y[:, :, m]
    dr = torch.stack(dr, 2) + uf * kf * vdy
    dk = torch.stack(dk, 2) + rf * uf * vdy
    dw = torch.stack(dw, 2)
    du = (rf * kf * vdy).sum((0, 1, 2))
    unchunk = lambda t: t.reshape(Bsz, nc * T, *t.shape[3:])[:, :S]
    return (unchunk(dr).to(r.dtype), unchunk(dk).to(r.dtype), dv,
            unchunk(dw), du)
