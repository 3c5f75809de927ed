"""Kernel dispatch: the hand-written kernel or its plain version.

impl=None (every caller on the serving and training paths): a CUDA tensor
launches the hand-written CUDA kernel (kernels/flash_attention.py,
kernels/flash_backward.py, kernels/paged_prefill.py, kernels/
flash_decode.py, kernels/mamba2_scan.py, kernels/rwkv6_scan.py) and a CPU
tensor takes the plain PyTorch version; there is no fallback from one to
the other.  impl="ref" forces the plain version on any device - the tests
and chip_smoke.py's parity phases use it to hold the kernels against it.
Where autograd needs a gradient, attention goes through _FlashAttention
(K4 forward, K5 backward) and the scans through _Scan (K6 / K7
forward, their backward kernels), so no CUDA autograd path reaches
kernels/ref.py.
The scans also take impl="naive", the step-by-step recurrence, as the
JAX package's ops do.  The single-step decode updates of the recurrent
states (mamba2_step, rwkv6_step) and the sequence-parallel decode
(decode_attention_naive, _decode_partials, seq_parallel_decode) are plain
PyTorch on any device, as they are plain jnp in the JAX package: no TPU
kernel stands behind them.

Tensor-parallel serving (tp_mesh=, a launch/mesh.py ServeMesh of size >
1): paged_flash_decode and batched_paged_prefill_attention run their
kernel on this rank's head shard and all-gather the output over the
mesh's group (_tp_head_sharded), as the JAX package's shard_map does.
The sharded train step's attention (flash_attention(tp_mesh=),
head_sharded_attention) runs K4 / K5 on the model axis's head shard the
same way, with the gradients carried across the group.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import flash_attention as fa
from . import flash_backward as fb
from . import flash_decode as fd
from . import mamba2_scan as m2
from . import paged_prefill as pp
from . import ref
from . import rwkv6_scan as r6

IMPLS = (None, "ref")
SCAN_IMPLS = (None, "ref", "naive")


def _check_impl(impl):
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")


class _FlashAttention(torch.autograd.Function):
    """Attention with the FA-2 backward: the counterpart of the JAX
    package's custom_vjp ops._flash_attention.  The forward is K4 (or its
    plain version) and keeps (q, k, v, o, lse); the backward is K5 (or its
    plain version) recomputing from them, so no (Sq, Skv) score matrix is
    ever kept for the backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale, impl):
        fwd = ref.flash_attention if impl == "ref" else fa.flash_attention_fwd
        o, lse = fwd(q, k, v, causal=causal, window=window,
                     logit_softcap=softcap, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = (causal, window, softcap, scale, impl)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, softcap, scale, impl = ctx.opts
        bwd = ref.flash_attention_bwd if impl == "ref" \
            else fb.flash_attention_bwd
        dq, dk, dv = bwd(q, k, v, o, lse, do.to(q.dtype).contiguous(),
                         causal=causal, window=window,
                         logit_softcap=softcap, scale=scale)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    logit_softcap: float = 0.0,
                    scale: Optional[float] = None,
                    impl: Optional[str] = None,
                    tp_mesh=None) -> torch.Tensor:
    """Fused attention.  q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) (GQA
    allowed).  Returns o.  Where autograd needs a gradient of q, k or v,
    the call goes through _FlashAttention (K4 forward, K5 backward);
    otherwise - every serving caller, under torch.no_grad() - it is one
    forward call and the kernel's lse is dropped.  tp_mesh (a ServeMesh
    of size > 1 over the model axis): head_sharded_attention."""
    _check_impl(impl)
    if _tp_active(tp_mesh):
        return head_sharded_attention(
            q, k, v, tp_mesh, causal=causal, window=window,
            logit_softcap=logit_softcap, scale=scale, impl=impl)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, logit_softcap,
                                     scale, impl)
    fn = ref.flash_attention if impl == "ref" else fa.flash_attention_fwd
    return fn(q, k, v, causal=causal, window=window,
              logit_softcap=logit_softcap, scale=scale)[0]


def flash_decode(q, k_cache, v_cache, cache_len, *, window: int = 0,
                 logit_softcap: float = 0.0, scale: Optional[float] = None,
                 impl: Optional[str] = None) -> torch.Tensor:
    """Decode against dense caches.  q: (B, 1, Hq, D); caches (B, S, Hkv,
    D); cache_len (B,) valid lengths, or one int for every lane."""
    _check_impl(impl)
    fn = ref.flash_decode if impl == "ref" else fd.flash_decode
    return fn(q, k_cache, v_cache, cache_len, window=window,
              logit_softcap=logit_softcap, scale=scale)


def _tp_active(tp_mesh) -> bool:
    """True when a serve mesh actually shards the head axis."""
    return tp_mesh is not None and tp_mesh.size > 1


def shard_heads(t: torch.Tensor, tp_mesh) -> torch.Tensor:
    """This rank's contiguous block of the head axis (axis 2) of a (B, S,
    H, D) activation or a (P, page_size, H, D) pool: heads [rank H / N,
    (rank + 1) H / N), a view."""
    n = t.shape[2] // tp_mesh.size
    return t.narrow(2, tp_mesh.rank * n, n)


def _gather_heads(o: torch.Tensor, tp_mesh, owners=None,
                  sizes=None) -> torch.Tensor:
    """Every rank's (B, S, h, D) head block, all-gathered over the mesh's
    group into (N B, S, h, D) and put back in rank order on the head axis
    (the JAX all_gather's tiled=True): (B, S, N h, D).  owners: keep only
    these ranks' blocks (ranks that share a query block hold the same
    one).  sizes (the uneven split of _head_blocks): rank r's block holds
    sizes[r] heads, padded with zeros to h = max(sizes) for the gather,
    and the pad is dropped."""
    import torch.distributed as dist
    n = tp_mesh.size
    B, S, h, D = o.shape
    sizes = sizes or [h] * n
    if max(sizes) > h:
        o = torch.nn.functional.pad(o, (0, 0, 0, max(sizes) - h))
    out = o.new_empty((n,) + tuple(o.shape))
    dist.all_gather_into_tensor(out.view(n * B, *o.shape[1:]),
                                o.contiguous(), group=tp_mesh.group)
    keep = owners if owners is not None else range(n)
    return torch.cat([out[r, :, :, :sizes[r]] for r in keep], 2)


def _tp_head_sharded(fn, tp_mesh, q, k_pages, v_pages, *rest):
    """Run a paged attention function on this rank's head shard and gather
    the full head axis back, the JAX package's _tp_head_sharded (shard_map
    over the "model" axis).  q (B, S, Hq, D) is the replicated query of
    every head; k_pages / v_pages are this rank's pools, (P, page_size,
    Hkv / N, D); `rest` (block tables, offsets, lengths) is replicated.
    The rank takes query heads [rank Hq / N, (rank + 1) Hq / N), the
    groups of its KV heads [rank Hkv / N, (rank + 1) Hkv / N), as a
    contiguous tensor, and fn computes their exact per-head result: per-
    head attention never mixes heads.  The outputs are gathered in rank
    order (_gather_heads), so the result is the unsharded function's, bit
    for bit, on every rank."""
    n = tp_mesh.size
    Hq = q.shape[2]
    hkv = k_pages.shape[2]
    if Hq % n or (Hq // n) % hkv:
        raise ValueError(f"{Hq} query heads over {n} ranks do not group "
                         f"over this rank's {hkv} KV heads")
    o = fn(shard_heads(q, tp_mesh).contiguous(), k_pages, v_pages, *rest)
    return _gather_heads(o, tp_mesh)


def _head_blocks(hq: int, hkv: int, n: int):
    """Per rank r of n, (query heads, KV heads) it attends with, each a
    (start, stop) range: query heads [r hq / n, (r + 1) hq / n) and the KV
    heads of their groups - hkv / n of them when n divides hkv, else the
    one KV head all its queries share (n a multiple of hkv).  With more
    ranks than query heads (n a multiple of hq: gemma3-4b's 8 heads on a
    model axis of 16), each query head goes to n / hq ranks side by side,
    which attend with it alike.  When n is a multiple of hkv but does not
    divide hq (llava-next-34b's 56 / 8 heads on 16 ranks), each KV head's
    G = hq / hkv query heads go to its n / hkv ranks as evenly as they
    go, contiguous inside the group, the larger blocks first (G 7 over 2
    ranks: 4 + 3), so every rank keeps one KV head.  Other splits
    raise."""
    if n % hq == 0:
        per = n // hq
        return [((r // per, r // per + 1),
                 ((r // per) * hkv // hq, (r // per) * hkv // hq + 1))
                for r in range(n)]
    if hq % hkv == 0 and n % hkv == 0 and hq % n \
            and n // hkv <= hq // hkv:
        g, per = hq // hkv, n // hkv
        out = []
        for r in range(n):
            kv, j = divmod(r, per)
            q0 = kv * g + j * (g // per) + min(j, g % per)
            out.append(((q0, q0 + g // per + (j < g % per)), (kv, kv + 1)))
        return out
    if hq % n or not (hkv % n == 0 or n % hkv == 0):
        raise ValueError(f"{hq} query / {hkv} KV heads do not split over "
                         f"{n} ranks: the query heads must divide by the "
                         f"rank count or divide it, or the rank count be a "
                         f"multiple of the KV heads with at most one rank "
                         f"a query head of each group; and the KV heads "
                         f"divide it or be divided by it")
    hq_r, g = hq // n, hq // hkv
    out = []
    for r in range(n):
        q0 = r * hq_r
        k0, k1 = q0 // g, (q0 + hq_r - 1) // g + 1
        out.append(((q0, q0 + hq_r), (k0, k1)))
    return out


def _owners(q_blocks):
    """The ranks whose result stands for their query block: the first of
    the ranks that share one (every rank when none is shared)."""
    seen, out = set(), []
    for r, b in enumerate(q_blocks):
        if b not in seen:
            seen.add(b)
            out.append(r)
    return out


class _HeadSplit(torch.autograd.Function):
    """Forward: this rank's block [lo, hi) of the head axis (axis 2) of a
    (B, S, H, D) tensor every rank of the group holds whole and equal.
    Backward: the gradients of the blocks of the `owners` ranks (one rank
    a query block: ranks sharing a query head compute the same gradient),
    all-gathered over the group (blocks of unequal size padded to the
    largest, the pad dropped) and added at each rank's heads, in rank
    order - so every rank ends with the same whole gradient.  Blocks that
    do not overlap (query heads; KV heads when the ranks divide them) are
    the gathered values, bit for bit; a KV head shared by several owners
    gets the sum of their parts, in rank order."""

    @staticmethod
    def forward(ctx, t, tp_mesh, blocks, owners):
        ctx.tp_mesh, ctx.blocks, ctx.heads = tp_mesh, blocks, t.shape[2]
        ctx.owners = owners
        lo, hi = blocks[tp_mesh.rank]
        return t[:, :, lo:hi].contiguous()

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        n, (B, S, h, D) = ctx.tp_mesh.size, g.shape
        h_max = max(hi - lo for lo, hi in ctx.blocks)
        if h < h_max:
            g = torch.nn.functional.pad(g, (0, 0, 0, h_max - h))
        parts = g.new_empty((n * B, S, h_max, D))
        dist.all_gather_into_tensor(parts, g.contiguous(),
                                    group=ctx.tp_mesh.group)
        parts = parts.view(n, B, S, h_max, D)
        full = g.new_zeros((B, S, ctx.heads, D))
        mine = [ctx.blocks[r] for r in ctx.owners]
        shared = len(set(mine)) < len(mine)
        for r in ctx.owners:
            lo, hi = ctx.blocks[r]
            if shared:
                full[:, :, lo:hi] += parts[r, :, :, :hi - lo]
            else:
                full[:, :, lo:hi] = parts[r, :, :, :hi - lo]
        return full, None, None, None


class _HeadGather(torch.autograd.Function):
    """Forward: every rank's (B, S, h, D) block gathered into the whole
    head axis (_gather_heads), the `owners` ranks' blocks in rank order,
    blocks of sizes[r] heads padded for the gather.  Backward: this
    rank's block of the gradient, which every rank holds whole and
    equal."""

    @staticmethod
    def forward(ctx, o, tp_mesh, lo, owners, sizes):
        ctx.lo, ctx.h = lo, o.shape[2]
        return _gather_heads(o, tp_mesh, owners, sizes)

    @staticmethod
    def backward(ctx, g):
        return (g[:, :, ctx.lo:ctx.lo + ctx.h].contiguous(), None, None,
                None, None)


def head_sharded_attention(q, k, v, tp_mesh, **kw) -> torch.Tensor:
    """flash_attention over this rank's head shard, the output gathered
    back to every head: the attention of the sharded train step on the
    model axis (tp_mesh: a launch/mesh.py ServeMesh over the model axis's
    group) and of the mesh prefill step.  q (B, Sq, Hq, D), k / v (B, Skv,
    Hkv, D) are whole and equal on every rank (the projections stay
    replicated over the model axis; Skv may differ from Sq, as in
    whisper's cross-attention).  The rank attends with its block of the
    query heads and their KV heads (_head_blocks: N / Hq ranks a head
    when N passes Hq; blocks of ceil and floor G / (N / Hkv) heads inside
    each group when N is a multiple of Hkv but does not divide Hq)
    through K4 forward and K5 backward (_FlashAttention); _HeadSplit and
    _HeadGather carry the gradients across the group, so q, k and v get
    the whole gradient on every rank.  Per-head attention never mixes
    heads, so the forward is the unsharded call's per head.  The JAX
    package's constrain("bshd") prefers to split the sequence over the
    model axis; the port splits heads because K4 and K5 take no query
    offset, and a head shard's results are exact."""
    n = tp_mesh.size
    blocks = _head_blocks(q.shape[2], k.shape[2], n)
    qb = [b[0] for b in blocks]
    owners = _owners(qb)
    qs = _HeadSplit.apply(q, tp_mesh, qb, owners)
    ks = _HeadSplit.apply(k, tp_mesh, [b[1] for b in blocks], owners)
    vs = _HeadSplit.apply(v, tp_mesh, [b[1] for b in blocks], owners)
    return _HeadGather.apply(flash_attention(qs, ks, vs, **kw), tp_mesh,
                             qb[tp_mesh.rank][0], owners,
                             [hi - lo for lo, hi in qb])


def paged_flash_decode(q, k_pages, v_pages, block_table, cache_len, *,
                       window: int = 0, logit_softcap: float = 0.0,
                       scale: Optional[float] = None,
                       impl: Optional[str] = None,
                       tp_mesh=None) -> torch.Tensor:
    """Decode against a paged KV cache.  q: (B, 1, Hq, D); pools (P,
    page_size, Hkv, D); block_table (B, n_max) int32; cache_len (B,).
    tp_mesh (a serve mesh of size N > 1): the pools are this rank's head
    shard (P, page_size, Hkv / N, D) and the call runs on it, the output
    gathered back to every head (_tp_head_sharded)."""
    _check_impl(impl)
    fn = ref.paged_flash_decode if impl == "ref" else fd.paged_flash_decode
    kw = dict(window=window, logit_softcap=logit_softcap, scale=scale)
    if _tp_active(tp_mesh):
        return _tp_head_sharded(lambda *a: fn(*a, **kw), tp_mesh, q,
                                k_pages, v_pages, block_table, cache_len)
    return fn(q, k_pages, v_pages, block_table, cache_len, **kw)


def batched_paged_prefill_attention(q, k_pages, v_pages, page_tables,
                                    q_offsets, true_lens, q_lens=None, *,
                                    window: int = 0,
                                    logit_softcap: float = 0.0,
                                    scale: Optional[float] = None,
                                    impl: Optional[str] = None,
                                    tp_mesh=None) -> torch.Tensor:
    """Ragged batch of K mid-prompt chunks through per-row block tables
    (see kernels/ref.py for the contract); q_lens is the verify lane.
    tp_mesh: the pools are this rank's head shard, as in
    paged_flash_decode."""
    _check_impl(impl)
    fn = ref.batched_paged_prefill_attention if impl == "ref" \
        else pp.batched_paged_prefill_attention
    kw = dict(window=window, logit_softcap=logit_softcap, scale=scale)
    if _tp_active(tp_mesh):
        return _tp_head_sharded(lambda *a: fn(*a, **kw), tp_mesh, q,
                                k_pages, v_pages, page_tables, q_offsets,
                                true_lens, q_lens)
    return fn(q, k_pages, v_pages, page_tables, q_offsets, true_lens,
              q_lens, **kw)


def paged_prefill_attention(q, k_pages, v_pages, page_row, q_offset, *,
                            window: int = 0, logit_softcap: float = 0.0,
                            scale: Optional[float] = None,
                            impl: Optional[str] = None) -> torch.Tensor:
    """Single-sequence chunk prefill, the K=1 case of the batched call."""
    _check_impl(impl)
    fn = ref.paged_prefill_attention if impl == "ref" \
        else pp.paged_prefill_attention
    return fn(q, k_pages, v_pages, page_row, q_offset, window=window,
              logit_softcap=logit_softcap, scale=scale)


def decode_attention_naive(q, k_cache, v_cache, cache_len, *,
                           logit_softcap: float = 0.0,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Unchunked decode attention over the whole cache (no window), the
    JAX package's decode_attention_naive: one einsum for the scores, the
    max / sum reductions over the cache's sequence axis, one einsum for
    the output, all in float32.  Under SPMD the JAX package relies on this
    form for a sequence-sharded cache (XLA turns the reductions into
    partial reductions and small all-reduces); here it is the
    single-device form of seq_parallel_decode.  q: (B, 1, Hq, D); caches
    (B, S, Hkv, D); cache_len (B,) or one int.  A lane of length 0 gives
    an exactly zero output.  Returns (B, 1, Hq, D) in q's dtype."""
    B, _, Hq, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    sc = scale if scale is not None else 1.0 / math.sqrt(D)
    cache_len = ref._as_lens(cache_len, B, q.device)
    qf = (q.float() * sc).reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qf, k_cache.float())
    if logit_softcap > 0.0:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    mask = (torch.arange(S, device=q.device)[None, :]
            < cache_len[:, None])[:, None, None, :]
    s = torch.where(mask, s, ref.NEG_INF)
    m = torch.amax(s, -1, keepdim=True)
    p = torch.where(mask, torch.exp2((s - m) * ref.LOG2E), 0.0)
    l = torch.sum(p, -1, keepdim=True)
    o = torch.einsum("bhgk,bkhd->bhgd", p / torch.clamp_min(l, 1e-20),
                     v_cache.float())
    return o.reshape(B, 1, Hq, D).to(q.dtype)


def _decode_partials(q, kc, vc, valid_len, *,
                     scale: Optional[float] = None, block_kv: int = 1024,
                     logit_softcap: float = 0.0):
    """The unnormalised partial softmax (m, l, o) of one query token per
    lane over the first valid_len positions of its cache slice, the JAX
    package's _decode_partials: an online softmax over blocks of block_kv
    positions (the slice zero-padded to a whole block), no window; the
    scores softcapped as decode_attention_naive's when logit_softcap > 0
    (the JAX partials take none: the mesh decode's sequence-sharded
    layouts are the JAX naive decode, which does).  q: (B, 1, Hq, D);
    kc, vc (B, S, Hkv, D); valid_len (B,) or one int.  Returns m, l (B, Hkv, G) and o (B, Hkv, G, D), float32; a
    lane with nothing valid has m = NEG_INF, l = 0, o = 0."""
    B, _, Hq, D = q.shape
    S, Hkv = kc.shape[1], kc.shape[2]
    G = Hq // Hkv
    sc = scale if scale is not None else 1.0 / math.sqrt(D)
    valid_len = ref._as_lens(valid_len, B, q.device)
    qf = (q.float() * sc).reshape(B, Hkv, G, D)
    m = torch.full((B, Hkv, G), ref.NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Hkv, G), dtype=torch.float32, device=q.device)
    o = torch.zeros((B, Hkv, G, D), dtype=torch.float32, device=q.device)
    for start in range(0, S, block_kv):
        kblk = kc[:, start:start + block_kv]
        vblk = vc[:, start:start + block_kv]
        pad = block_kv - kblk.shape[1]
        if pad:
            kblk = torch.nn.functional.pad(kblk, (0, 0, 0, 0, 0, pad))
            vblk = torch.nn.functional.pad(vblk, (0, 0, 0, 0, 0, pad))
        pos = start + torch.arange(block_kv, device=q.device)
        mask = (pos[None, :] < valid_len[:, None])[:, None, None, :]
        s = torch.einsum("bhgd,bkhd->bhgk", qf, kblk.float())
        if logit_softcap > 0.0:
            s = logit_softcap * torch.tanh(s / logit_softcap)
        s = torch.where(mask, s, ref.NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, -1))
        m_safe = torch.where(m_new <= ref.NEG_INF / 2, 0.0, m_new)
        p = torch.where(mask, torch.exp2((s - m_safe[..., None])
                                         * ref.LOG2E), 0.0)
        alpha = torch.where(m <= ref.NEG_INF / 2, 0.0,
                            torch.exp2((m - m_new) * ref.LOG2E))
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + torch.einsum("bhgk,bkhd->bhgd", p,
                                                vblk.float())
        m = m_new
    return m, l, o


def seq_parallel_decode(q, k_cache_local, v_cache_local, cache_len, *,
                        group=None, scale: Optional[float] = None,
                        logit_softcap: float = 0.0) -> torch.Tensor:
    """Sequence-parallel decode across the ranks of a torch.distributed
    process group, the JAX package's seq_parallel_decode (there inside
    shard_map): rank r holds positions [r S_local, (r + 1) S_local) of
    every lane's cache, computes the partial (m, l, o) over its
    local_len = clamp(cache_len - r S_local, 0, S_local) valid positions,
    all-gathers the small partials over `group` (the default group when
    None) and merges them with the log-sum-exp combine.  q: (B, 1, Hq, D),
    the same on every rank; caches (B, S_local, Hkv, D), this rank's
    slice; cache_len (B,) or one int, the lanes' whole lengths.  Returns
    (B, 1, Hq, D) in q's dtype, the same on every rank.  logit_softcap:
    as _decode_partials."""
    import torch.distributed as dist
    B, _, Hq, D = q.shape
    S_local = k_cache_local.shape[1]
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    cache_len = ref._as_lens(cache_len, B, q.device)
    local_len = torch.clamp(cache_len - rank * S_local, 0, S_local)
    parts = _decode_partials(q, k_cache_local, v_cache_local, local_len,
                             scale=scale, logit_softcap=logit_softcap)
    gathered = []
    for t in parts:
        out = t.new_empty((world * t.shape[0],) + tuple(t.shape[1:]))
        dist.all_gather_into_tensor(out, t.contiguous(), group=group)
        gathered.append(out.view((world,) + tuple(t.shape)))
    _, l_c, o_c = ref.combine_partial_softmax(*gathered)
    o = o_c / torch.clamp_min(l_c, 1e-20)[..., None]
    return o.reshape(B, 1, Hq, D).to(q.dtype)


def _check_scan_impl(impl):
    if impl not in SCAN_IMPLS:
        raise ValueError(f"impl must be one of {SCAN_IMPLS}, got {impl!r}")


class _Scan(torch.autograd.Function):
    """A scan with its backward kernel: the forward (K6 / K7, or their
    plain versions) keeps only the operands - (x, dt, A, Bm, Cm) or (r,
    k, v, w, u) - and the backward (kernels/mamba2_scan.py
    mamba2_scan_bwd / rwkv6_scan.py rwkv6_scan_bwd, or their plain
    versions) recomputes the states from them.  The JAX package
    differentiates its plain chunked scans (src/repro/kernels/ops.py off
    the TPU); the gradients are the same function's: the decays' and step
    sizes' (dt, A, w, u) in float32, the others in the activations'
    dtype."""

    @staticmethod
    def forward(ctx, fwd, bwd, *operands):
        ctx.save_for_backward(*operands)
        ctx.bwd = bwd
        return fwd(*operands)

    @staticmethod
    def backward(ctx, dy):
        saved = ctx.saved_tensors      # once: remat's unpack allows one
        with torch.no_grad():
            grads = ctx.bwd(*saved, dy.to(saved[0].dtype).contiguous())
        return (None, None, *grads)


def mamba2_scan(x, dt, A, Bm, Cm, *,
                impl: Optional[str] = None) -> torch.Tensor:
    """Mamba2 SSD scan.  x: (B, S, H, P); dt: (B, S, H) float32; A: (H,)
    float32; Bm / Cm: (B, S, N).  Returns y (B, S, H, P) in x's dtype.
    impl=None launches K6 on a CUDA tensor and runs the chunked plain
    version on a CPU tensor, through _Scan, whose backward is the backward
    kernel (on a CPU tensor its plain version).  impl="ref": the plain
    versions on any device; "naive": the step-by-step recurrence,
    differentiated by autograd."""
    _check_scan_impl(impl)
    if impl == "naive":
        return ref.mamba2_scan(x, dt, A, Bm, Cm)
    fns = (ref.mamba2_scan_chunked, ref.mamba2_scan_bwd) \
        if impl == "ref" else (m2.mamba2_scan, m2.mamba2_scan_bwd)
    return _Scan.apply(*fns, x, dt, A, Bm, Cm)


mamba2_step = ref.mamba2_step


def rwkv6_scan(r, k, v, w, u, *,
               impl: Optional[str] = None) -> torch.Tensor:
    """RWKV6 WKV scan.  r, k: (B, S, H, K); v: (B, S, H, V); w: (B, S, H,
    K) float32 decay; u: (H, K) float32.  Returns y (B, S, H, V) in r's
    dtype.  impl=None launches K7 on a CUDA tensor and runs the chunked
    plain version on a CPU tensor, through _Scan, whose backward is the
    backward kernel (on a CPU tensor its plain version).  impl="ref": the
    plain versions on any device; "naive": the step-by-step recurrence,
    differentiated by autograd."""
    _check_scan_impl(impl)
    if impl == "naive":
        return ref.rwkv6_scan(r, k, v, w, u)
    fns = (ref.rwkv6_scan_chunked, ref.rwkv6_scan_bwd) \
        if impl == "ref" else (r6.rwkv6_scan, r6.rwkv6_scan_bwd)
    return _Scan.apply(*fns, r, k, v, w, u)


rwkv6_step = ref.rwkv6_step
