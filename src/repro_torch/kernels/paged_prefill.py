"""K1: ragged batched paged chunk prefill, hand-written for Hopper.

The CUDA kernel is csrc/paged_prefill.cu (see the note at its top: the TPU
kernel it replaces, what bounds it, and how it is laid out).  This module
holds its wrapper and, beside it, its plain PyTorch version (`reference`,
from kernels/ref.py).  The wrapper launches the kernel for CUDA tensors
and takes the plain version only for tensors on the CPU; `launches`
counts kernel launches and nothing else.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import build, ref
from ._checks import HEAD_DIMS_64_128, check_operands

# kernel launches made by the wrapper below (CPU calls do not count)
launches = 0

reference = ref.batched_paged_prefill_attention


def batched_paged_prefill_attention(q, k_pages, v_pages, page_tables,
                                    q_offsets, true_lens, q_lens=None, *,
                                    window: int = 0,
                                    scale: Optional[float] = None,
                                    logit_softcap: float = 0.0
                                    ) -> torch.Tensor:
    """K chunks of K sequences in one launch.  q: (K, S, Hq, D) with row k
    at absolute positions q_offsets[k] + arange(S); pools (P, page_size,
    Hkv, D); page_tables (K, n_max), q_offsets / true_lens / q_lens (K,)
    int32 (q_lens defaults to clip(true_lens - q_offsets, 0, S)).  Rows at
    or past q_lens and dead rows (true_lens == 0) come back exactly zero.
    Returns (K, S, Hq, D) in q's dtype."""
    if q.device.type == "cpu":
        return reference(q, k_pages, v_pages, page_tables, q_offsets,
                         true_lens, q_lens, window=window, scale=scale,
                         logit_softcap=logit_softcap)
    K, S, Hq, D = q.shape
    if q_lens is None:
        q_lens = torch.clamp(true_lens - q_offsets, 0, S).to(torch.int32)
    n_max = page_tables.shape[-1]
    check_operands("batched_paged_prefill_attention", q, k_pages, v_pages, {
        "page_tables": (page_tables, (K, n_max)),
        "q_offsets": (q_offsets, (K,)), "true_lens": (true_lens, (K,)),
        "q_lens": (q_lens, (K,))}, head_dims=HEAD_DIMS_64_128)
    ps, Hkv = k_pages.shape[1], k_pages.shape[2]
    out = torch.empty_like(q)
    err = build.kernel("paged_prefill")(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_tables.data_ptr(), q_offsets.data_ptr(), true_lens.data_ptr(),
        q_lens.data_ptr(), out.data_ptr(), K, S, Hkv, Hq // Hkv, D, ps,
        n_max, int(window),
        scale if scale is not None else 1.0 / math.sqrt(D),
        float(logit_softcap), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check("paged_prefill", err)
    global launches
    launches += 1
    return out


def paged_prefill_attention(q, k_pages, v_pages, page_row, q_offset, *,
                            window: int = 0, scale: Optional[float] = None,
                            logit_softcap: float = 0.0) -> torch.Tensor:
    """Single-sequence chunk prefill, the K=1 case: q (1, S, Hq, D) at
    positions q_offset + arange(S), every position real; page_row
    (n_max,).  Runs the batched kernel (and counts as its launch)."""
    off = torch.as_tensor(q_offset, dtype=torch.int32,
                          device=q.device).reshape(1)
    return batched_paged_prefill_attention(
        q, k_pages, v_pages, page_row.reshape(1, -1).to(torch.int32), off,
        off + q.shape[1], window=window, scale=scale,
        logit_softcap=logit_softcap)
