"""K5: FlashAttention-2 backward over contiguous K/V, hand-written for Hopper.

The CUDA kernels are csrc/flash_backward.cu (see the note at its top: the
TPU kernels they replace, what bounds them, and how they are laid out): a
dq kernel, which also writes delta = rowsum(do . o), then a dk/dv kernel,
launched one after the other on the current stream by one C call.  This
module holds their wrapper and, beside it, the plain PyTorch version
(`reference`, from kernels/ref.py).  The wrapper launches the kernels for
CUDA tensors and takes the plain version only for tensors on the CPU.
`launches` counts wrapper calls that launched: one per backward, which is
the dq kernel and the dk/dv kernel together.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import build, ref
from ._checks import check_operands

# backward calls that launched the kernels (CPU calls do not count); one
# count is the dq launch and the dk/dv launch of that call together
launches = 0

reference = ref.flash_attention_bwd


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0, logit_softcap: float = 0.0,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, o, do: (B, Sq, Hq, D) in one dtype; k, v: (B, Skv, Hkv, D); lse:
    (B, Sq, Hq) float32, the natural-log row log-sum-exp K4 returns; all
    contiguous.  Masks as flash_attention_fwd.  Returns (dq, dk, dv) in the
    input dtype."""
    if q.device.type == "cpu":
        return reference(q, k, v, o, lse, do, causal=causal, window=window,
                         logit_softcap=logit_softcap, scale=scale)
    check_operands("flash_attention_bwd", q, k, v, {},
                   layout="(B, Skv, Hkv, D)")
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B:
        raise ValueError(f"flash_attention_bwd: q has batch {B}, k/v have "
                         f"{k.shape[0]}")
    for arg, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_attention_bwd: {arg} must be q's shape "
                             f"{tuple(q.shape)} and dtype {q.dtype} on "
                             f"{q.device}, got {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_bwd: {arg} must be contiguous")
    if (lse.shape != (B, Sq, Hq) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_bwd: lse must be a contiguous "
                         f"float32 ({B}, {Sq}, {Hq}) tensor on {q.device}, "
                         f"got {lse.dtype} {tuple(lse.shape)}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, Sq, Hq), dtype=torch.float32, device=q.device)
    err = build.kernel("flash_backward")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), delta.data_ptr(), B, Sq, Skv, Hkv, Hq // Hkv, D,
        int(bool(causal)), int(window),
        scale if scale is not None else 1.0 / math.sqrt(D),
        float(logit_softcap), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check("flash_backward", err)
    global launches
    launches += 1
    return dq, dk, dv
