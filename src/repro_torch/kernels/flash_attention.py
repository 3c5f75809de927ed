"""K4: FlashAttention-2 forward over contiguous K/V, hand-written for Hopper.

The CUDA kernel is csrc/flash_attention.cu (see the note at its top: the
TPU kernel it replaces, what bounds it, and how it is laid out).  This
module holds its wrapper and, beside it, its plain PyTorch version
(`reference`, from kernels/ref.py).  The wrapper launches the kernel for
CUDA tensors and takes the plain version only for tensors on the CPU;
`launches` counts kernel launches and nothing else.  The tile sizes are
constants of the source: the TPU kernel's block chooser has no part here.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import build, ref
from ._checks import check_operands

# kernel launches made by the wrapper below (CPU calls do not count)
launches = 0

reference = ref.flash_attention


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                        logit_softcap: float = 0.0,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D), contiguous.  Causal mask
    top-left aligned (k_pos <= q_pos); window > 0 keeps k_pos > q_pos -
    window and implies causal.  Returns (o (B, Sq, Hq, D) in q's dtype,
    lse (B, Sq, Hq) float32, natural log)."""
    if q.device.type == "cpu":
        return reference(q, k, v, causal=causal, window=window,
                         logit_softcap=logit_softcap, scale=scale)
    check_operands("flash_attention_fwd", q, k, v, {},
                   layout="(B, Skv, Hkv, D)")
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B:
        raise ValueError(f"flash_attention_fwd: q has batch {B}, k/v have "
                         f"{k.shape[0]}")
    o = torch.empty_like(q)
    lse = torch.empty((B, Sq, Hq), dtype=torch.float32, device=q.device)
    err = build.kernel("flash_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), B, Sq, Skv, Hkv, Hq // Hkv, D, int(bool(causal)),
        int(window), scale if scale is not None else 1.0 / math.sqrt(D),
        float(logit_softcap), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check("flash_attention", err)
    global launches
    launches += 1
    return o, lse
