"""K2 and K3: paged and dense flash-decode, hand-written for Hopper.

The CUDA kernels are csrc/paged_decode.cu (K2, against a page pool through
a block table) and csrc/dense_decode.cu (K3, against contiguous (B, S,
Hkv, D) caches), one split-KV kernel (csrc/split_decode.cuh) with two ways
of turning a position into an address; the note at the top of each says
which TPU kernel it replaces, what bounds it, and how it is laid out.
This module holds their wrappers and, beside them, their plain PyTorch
versions (`reference` and `dense_reference`, from kernels/ref.py).  A
wrapper launches its kernel for CUDA tensors and takes the plain version
only for tensors on the CPU; `launches` (K2) and `dense_launches` (K3)
count kernel launches and nothing else.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import build, ref
from ._checks import HEAD_DIMS_64_128, check_operands

# kernel launches made by the wrappers below (CPU calls do not count)
launches = 0            # K2, paged_flash_decode
dense_launches = 0      # K3, flash_decode

reference = ref.paged_flash_decode
dense_reference = ref.flash_decode

# most query heads per KV head the kernels' register layout holds
MAX_GROUP = 16
# The split-KV kernel K2 and K3 share (csrc/split_decode.cuh): the
# positions one block owns (a multiple of its 64-position tile).  Fixed, so
# a sequence's output bits do not depend on the batch it decodes in or on
# the card.  128 timed fastest of 64, 128, 256 and 512 for K2 at the paged
# serving shape on an H100 (PERF.md).
SPLIT = 128


def _scratch(q, B, Hkv, G, D, n_pos):
    """fp32 scratch for the split kernel's partials (unnormalised o, m, l of
    each of the ceil(n_pos / SPLIT) splits), merged by the kernel's second
    pass."""
    n_split = -(-n_pos // SPLIT)
    return torch.empty(B * Hkv * n_split * G * (D + 2), dtype=torch.float32,
                       device=q.device)


def flash_decode(q, k_cache, v_cache, cache_len, *, window: int = 0,
                 scale: Optional[float] = None,
                 logit_softcap: float = 0.0) -> torch.Tensor:
    """One query token per sequence against its dense cache strip.  q:
    (B, 1, Hq, D); k_cache / v_cache (B, S, Hkv, D); cache_len (B,) int32
    valid lengths on the device, or one int for every lane (0 gives an
    exactly zero output).  Returns (B, 1, Hq, D) in q's dtype."""
    if q.device.type == "cpu":
        return dense_reference(q, k_cache, v_cache, cache_len,
                               window=window, scale=scale,
                               logit_softcap=logit_softcap)
    B, Sq, Hq, D = q.shape
    if isinstance(cache_len, int):
        cache_len = torch.full((B,), cache_len, dtype=torch.int32,
                               device=q.device)
    elif cache_len.dim() == 0:
        cache_len = cache_len.expand(B).contiguous()
    check_operands("flash_decode", q, k_cache, v_cache,
                   {"cache_len": (cache_len, (B,))},
                   layout="(B, S, Hkv, D)")
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape[0] != B:
        raise ValueError(f"flash_decode: q has batch {B}, the caches have "
                         f"{k_cache.shape[0]}")
    if Sq != 1:
        raise ValueError(f"flash_decode: one query token per sequence, "
                         f"got {Sq}")
    G = Hq // Hkv
    if G > MAX_GROUP:
        raise ValueError(f"flash_decode: {G} query heads per KV head, the "
                         f"kernel holds at most {MAX_GROUP}")
    out = torch.empty_like(q)
    # one launch count for the split and the combine kernel
    scratch = _scratch(q, B, Hkv, G, D, S)
    err = build.kernel("dense_decode")(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        cache_len.data_ptr(), out.data_ptr(), scratch.data_ptr(), B, S, Hkv,
        G, D, SPLIT, int(window),
        scale if scale is not None else 1.0 / math.sqrt(D),
        float(logit_softcap), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check("dense_decode", err)
    global dense_launches
    dense_launches += 1
    return out


def paged_flash_decode(q, k_pages, v_pages, block_table, cache_len, *,
                       window: int = 0, scale: Optional[float] = None,
                       logit_softcap: float = 0.0) -> torch.Tensor:
    """One query token per sequence against its pages.  q: (B, 1, Hq, D);
    pools (P, page_size, Hkv, D); block_table (B, n_max) int32; cache_len
    (B,) int32 valid lengths (0 gives an exactly zero output).  Returns
    (B, 1, Hq, D) in q's dtype."""
    if q.device.type == "cpu":
        return reference(q, k_pages, v_pages, block_table, cache_len,
                         window=window, scale=scale,
                         logit_softcap=logit_softcap)
    B, Sq, Hq, D = q.shape
    n_max = block_table.shape[-1]
    check_operands("paged_flash_decode", q, k_pages, v_pages, {
        "block_table": (block_table, (B, n_max)),
        "cache_len": (cache_len, (B,))}, head_dims=HEAD_DIMS_64_128)
    ps, Hkv = k_pages.shape[1], k_pages.shape[2]
    if Sq != 1:
        raise ValueError(f"paged_flash_decode: one query token per "
                         f"sequence, got {Sq}")
    G = Hq // Hkv
    if G > MAX_GROUP:
        raise ValueError(f"paged_flash_decode: {G} query heads per KV "
                         f"head, the kernel holds at most {MAX_GROUP}")
    out = torch.empty_like(q)
    # one launch count for the split and the combine kernel
    scratch = _scratch(q, B, Hkv, G, D, n_max * ps)
    err = build.kernel("paged_decode")(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_table.data_ptr(), cache_len.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), B, Hkv, G, D, ps, n_max, SPLIT,
        int(window), scale if scale is not None else 1.0 / math.sqrt(D),
        float(logit_softcap), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check("paged_decode", err)
    global launches
    launches += 1
    return out
