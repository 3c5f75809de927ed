"""Kernel dispatch: the hand-written kernel or its plain version.

impl=None (every caller on the serving and training paths): a CUDA tensor
launches the hand-written CUDA kernel (kernels/flash_attention.py,
kernels/flash_backward.py, kernels/paged_prefill.py, kernels/
flash_decode.py, kernels/mamba2_scan.py, kernels/rwkv6_scan.py) and a CPU
tensor takes the plain PyTorch version; there is no fallback from one to
the other.  impl="ref" forces the plain version on any device - the tests
and chip_smoke.py's parity phases use it to hold the kernels against it.
The scans also take impl="naive", the step-by-step recurrence, as the
JAX package's ops do.  The single-step decode updates of the recurrent
states (mamba2_step, rwkv6_step) are plain PyTorch, as in the JAX
package: no TPU kernel stands behind them.
"""
from __future__ import annotations

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
                    impl: Optional[str] = None) -> torch.Tensor:
    """Fused attention.  q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) (GQA
    allowed).  Returns o.  Where autograd needs a gradient of q, k or v,
    the call goes through _FlashAttention (K4 forward, K5 backward);
    otherwise - every serving caller, under torch.no_grad() - it is one
    forward call and the kernel's lse is dropped."""
    _check_impl(impl)
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


def paged_flash_decode(q, k_pages, v_pages, block_table, cache_len, *,
                       window: int = 0, logit_softcap: float = 0.0,
                       scale: Optional[float] = None,
                       impl: Optional[str] = None) -> torch.Tensor:
    """Decode against a paged KV cache.  q: (B, 1, Hq, D); pools (P,
    page_size, Hkv, D); block_table (B, n_max) int32; cache_len (B,)."""
    _check_impl(impl)
    fn = ref.paged_flash_decode if impl == "ref" else fd.paged_flash_decode
    return fn(q, k_pages, v_pages, block_table, cache_len, window=window,
              logit_softcap=logit_softcap, scale=scale)


def batched_paged_prefill_attention(q, k_pages, v_pages, page_tables,
                                    q_offsets, true_lens, q_lens=None, *,
                                    window: int = 0,
                                    logit_softcap: float = 0.0,
                                    scale: Optional[float] = None,
                                    impl: Optional[str] = None
                                    ) -> torch.Tensor:
    """Ragged batch of K mid-prompt chunks through per-row block tables
    (see kernels/ref.py for the contract)."""
    _check_impl(impl)
    fn = ref.batched_paged_prefill_attention if impl == "ref" \
        else pp.batched_paged_prefill_attention
    return fn(q, k_pages, v_pages, page_tables, q_offsets, true_lens,
              q_lens, window=window, logit_softcap=logit_softcap,
              scale=scale)


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


def _check_scan_impl(impl):
    if impl not in SCAN_IMPLS:
        raise ValueError(f"impl must be one of {SCAN_IMPLS}, got {impl!r}")


def mamba2_scan(x, dt, A, Bm, Cm, *,
                impl: Optional[str] = None) -> torch.Tensor:
    """Mamba2 SSD scan.  x: (B, S, H, P); dt: (B, S, H) float32; A: (H,)
    float32; Bm / Cm: (B, S, N).  Returns y (B, S, H, P) in x's dtype.
    impl=None launches K6 on a CUDA tensor (which raises where autograd
    would need its gradient) and runs the chunked plain version, which
    autograd differentiates, on a CPU tensor."""
    _check_scan_impl(impl)
    if impl == "naive":
        return ref.mamba2_scan(x, dt, A, Bm, Cm)
    if impl == "ref":
        return ref.mamba2_scan_chunked(x, dt, A, Bm, Cm)
    return m2.mamba2_scan(x, dt, A, Bm, Cm)


mamba2_step = ref.mamba2_step


def rwkv6_scan(r, k, v, w, u, *,
               impl: Optional[str] = None) -> torch.Tensor:
    """RWKV6 WKV scan.  r, k: (B, S, H, K); v: (B, S, H, V); w: (B, S, H,
    K) float32 decay; u: (H, K) float32.  Returns y (B, S, H, V) in r's
    dtype.  impl=None launches K7 on a CUDA tensor (which raises where
    autograd would need its gradient) and runs the chunked plain version,
    which autograd differentiates, on a CPU tensor."""
    _check_scan_impl(impl)
    if impl == "naive":
        return ref.rwkv6_scan(r, k, v, w, u)
    if impl == "ref":
        return ref.rwkv6_scan_chunked(r, k, v, w, u)
    return r6.rwkv6_scan(r, k, v, w, u)


rwkv6_step = ref.rwkv6_step
