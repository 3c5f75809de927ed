"""K4: FlashAttention-2 forward over contiguous K/V, hand-written for Hopper.

The CUDA kernel is csrc/flash_attention.cu (see the note at its top: the
TPU kernel it replaces, what bounds it, and how it is laid out).  This
module holds its wrapper and, beside it, its plain PyTorch version
(`reference`, from kernels/ref.py).  The wrapper launches the kernel for
CUDA tensors and takes the plain version only for tensors on the CPU;
`launches` counts kernel launches and nothing else.  A tensor on the meta
device launches nothing: the wrapper checks it as it would a CUDA tensor,
returns empty meta outputs and reports the kernel's work to
launch/cost.py (the dry run).

The tile: as the TPU kernel sizes its Pallas blocks with the paper's
latency-balanced chooser when block_q or block_kv is 0, the wrapper asks
core/hopper_mapping.py choose_block_config(D, max(Sq, Skv), dtype) for
the bf16 kernel's (block_q flattened query rows, block_kv KV positions)
among the three tiles the source instantiates at the head dim
(hopper_mapping.K4_TILES).  The float32 kernel, on the CUDA cores, has
one tile a head dim (hopper_mapping.f32_tile): its fp32 q, K and V tiles
in shared memory and a thread's block of scores and outputs in registers
were sized together, and no other shape was built; the chooser returns
it.  A tile given that the source does not instantiate raises
ValueError on any device: nothing substitutes another.  The plain
version, on a CPU tensor, asks no chooser and takes no tile: a tile
changes how the kernel walks the work, not the function.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from functools import lru_cache

from ..core.hopper_mapping import K4_TILES, choose_block_config, f32_tile
from ..launch import cost
from . import build, ref
from ._checks import check_operands

# kernel launches made by the wrapper below (CPU and meta calls do not count)
launches = 0

reference = ref.flash_attention


@lru_cache(maxsize=4096)
def _chosen(head_dim: int, seq_len: int, dtype: str) -> Tuple[int, int]:
    bc = choose_block_config(head_dim, seq_len, dtype)
    return bc.block_q, bc.block_kv


def tile(head_dim: int, seq_len: int, dtype: torch.dtype,
         block_q: int = 0, block_kv: int = 0) -> Tuple[int, int]:
    """The (block_q, block_kv) K4 launches: the chooser's when either is
    0, else the pair given, which must be one the source instantiates for
    this dtype and head dim."""
    name = "bfloat16" if dtype == torch.bfloat16 else "float32"
    if not block_q or not block_kv:
        return _chosen(head_dim, seq_len, name)
    built = K4_TILES.get(head_dim, ()) if name == "bfloat16" \
        else (f32_tile(head_dim),)
    if (block_q, block_kv) not in built:
        raise ValueError(f"flash_attention_fwd: no {name} tile (block_q="
                         f"{block_q}, block_kv={block_kv}) at head dim "
                         f"{head_dim}; csrc/flash_attention.cu instantiates "
                         f"{list(built)}")
    return block_q, block_kv


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                        logit_softcap: float = 0.0,
                        scale: Optional[float] = None, block_q: int = 0,
                        block_kv: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D), contiguous.  Causal mask
    top-left aligned (k_pos <= q_pos); window > 0 keeps k_pos > q_pos -
    window and implies causal.  block_q / block_kv: the kernel's tile, 0
    for the chooser's (the module docstring).  Returns (o (B, Sq, Hq, D)
    in q's dtype, lse (B, Sq, Hq) float32, natural log)."""
    seq_len = max(q.shape[1], k.shape[1])
    if q.device.type == "cpu":
        if block_q or block_kv:
            tile(q.shape[-1], seq_len, q.dtype, block_q, block_kv)
        return reference(q, k, v, causal=causal, window=window,
                         logit_softcap=logit_softcap, scale=scale)
    check_operands("flash_attention_fwd", q, k, v, {},
                   layout="(B, Skv, Hkv, D)")
    bq, bkv = tile(q.shape[-1], seq_len, q.dtype, block_q, block_kv)
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B:
        raise ValueError(f"flash_attention_fwd: q has batch {B}, k/v have "
                         f"{k.shape[0]}")
    o = torch.empty_like(q)
    lse = torch.empty((B, Sq, Hq), dtype=torch.float32, device=q.device)
    if q.device.type == "meta":
        nbytes, flops = cost.k4_work(q.shape, k.shape, q.element_size(),
                                     causal, window)
        cost.record_kernel("K4", nbytes, flops, flops // (4 * D))
        return o, lse
    err = build.kernel("flash_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), B, Sq, Skv, Hkv, Hq // Hkv, D, int(bool(causal)),
        int(window), bq, bkv,
        scale if scale is not None else 1.0 / math.sqrt(D),
        float(logit_softcap), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check("flash_attention", err)
    global launches
    launches += 1
    return o, lse
