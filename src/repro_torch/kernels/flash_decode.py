"""K2: paged flash-decode, hand-written for Hopper.

The CUDA kernel is csrc/paged_decode.cu (see the note at its top: the TPU
kernel it replaces, what bounds it, and how it is laid out).  This module
holds its wrapper and, beside it, its plain PyTorch version (`reference`,
from kernels/ref.py).  The wrapper launches the kernel for CUDA tensors
and takes the plain version only for tensors on the CPU; `launches`
counts kernel launches and nothing else.  The dense-cache decode of the
JAX package (its flash_decode kernel) is not ported yet.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import build, ref
from ._checks import check_operands

# kernel launches made by the wrapper below (CPU calls do not count)
launches = 0

reference = ref.paged_flash_decode

# most query heads per KV head the kernel's register layout holds
MAX_GROUP = 16


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
        "cache_len": (cache_len, (B,))})
    ps, Hkv = k_pages.shape[1], k_pages.shape[2]
    if Sq != 1:
        raise ValueError(f"paged_flash_decode: one query token per "
                         f"sequence, got {Sq}")
    if Hq // Hkv > MAX_GROUP:
        raise ValueError(f"paged_flash_decode: {Hq // Hkv} query heads per "
                         f"KV head, the kernel holds at most {MAX_GROUP}")
    out = torch.empty_like(q)
    err = build.kernel("paged_decode")(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_table.data_ptr(), cache_len.data_ptr(), out.data_ptr(), B,
        Hkv, Hq // Hkv, D, ps, n_max, int(window),
        scale if scale is not None else 1.0 / math.sqrt(D),
        float(logit_softcap), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check("paged_decode", err)
    global launches
    launches += 1
    return out
