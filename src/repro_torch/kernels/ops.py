"""Attention dispatch: the hand-written kernel or its plain version.

impl=None (every caller on the serving path): a CUDA tensor launches the
hand-written CUDA kernel (kernels/flash_attention.py, kernels/
paged_prefill.py, kernels/flash_decode.py) and a CPU tensor takes the
plain PyTorch version; there is no fallback from one to the other.
impl="ref" forces the plain version on any device - the tests and
chip_smoke.py's parity phase use it to hold the kernels against it.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import flash_attention as fa
from . import flash_decode as fd
from . import paged_prefill as pp
from . import ref

IMPLS = (None, "ref")


def _check_impl(impl):
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    logit_softcap: float = 0.0,
                    scale: Optional[float] = None,
                    impl: Optional[str] = None) -> torch.Tensor:
    """Fused attention forward.  q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv,
    D) (GQA allowed).  Returns o; the kernel's lse is dropped here (the
    training path will keep it for the backward)."""
    _check_impl(impl)
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
