"""Gradient compression with error feedback: the JAX package's
optim/compression.py on trees of torch tensors.

int8 per-tensor quantization before the gradient all-reduce, with an
error-feedback residual so the quantization error is re-injected next
step.  The quantize -> dequantize pair is value-faithful to the wire
format (on one card there is no all-reduce to run it on).  The residual
and the gradients are updated in place.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from ..tree import leaves, map_tree


def ef_init(params) -> Any:
    return map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp_min(torch.max(torch.abs(x)), 1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def compress_grads(grads, ef_buf):
    """Returns (grads dequantized as seen after the int8 all-reduce, the
    new error-feedback buffer): both trees given, overwritten."""
    for g, e in zip(leaves(grads), leaves(ef_buf)):
        e.add_(g.float())                 # e now holds g + e
        q, scale = _quantize_int8(e)
        deq = q.float() * scale
        g.copy_(deq)
        e.sub_(deq)
    return grads, ef_buf


def compressed_bytes(params) -> int:
    """Wire bytes per all-reduce with int8 payload (vs 4x for fp32)."""
    return sum(int(p.numel()) + 4 for p in leaves(params))
