"""Argument checks shared by the CUDA kernel wrappers: everything the
kernels do not take is refused here, before a pointer reaches C."""
from __future__ import annotations

import torch

HEAD_DIMS = (64, 128)
DTYPES = (torch.float32, torch.bfloat16)


def check_operands(name: str, q: torch.Tensor, k_pages: torch.Tensor,
                   v_pages: torch.Tensor, index_tensors):
    """q and both pools: same CUDA device, same float32/bfloat16 dtype,
    contiguous, head dim 64 or 128, q's heads a multiple of the pools' KV
    heads.  index_tensors: {arg name: (tensor, expected shape)}, each a
    contiguous int32 tensor on the same device."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel needs CUDA tensors, got "
                         f"q on {dev}")
    if q.dtype not in DTYPES:
        raise TypeError(f"{name}: q must be float32 or bfloat16, got "
                        f"{q.dtype}")
    for arg, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.device != dev or t.dtype != q.dtype:
            raise ValueError(f"{name}: {arg} is {t.dtype} on {t.device}, "
                             f"q is {q.dtype} on {dev}")
        if t.dim() != 4 or t.shape != k_pages.shape:
            raise ValueError(f"{name}: pools must both be (P, page_size, "
                             f"Hkv, D), got {tuple(t.shape)}")
    for arg, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    D, Hkv = k_pages.shape[3], k_pages.shape[2]
    if q.dim() != 4 or q.shape[3] != D:
        raise ValueError(f"{name}: q must be (B, S, Hq, {D}), got "
                         f"{tuple(q.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D} not supported (kernel "
                         f"takes {HEAD_DIMS})")
    if Hkv < 1 or q.shape[2] % Hkv:
        raise ValueError(f"{name}: {q.shape[2]} query heads do not group "
                         f"over {Hkv} KV heads")
    for arg, (t, shape) in index_tensors.items():
        if t.device != dev or t.dtype != torch.int32:
            raise ValueError(f"{name}: {arg} must be int32 on {dev}, got "
                             f"{t.dtype} on {t.device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {arg} must have shape {tuple(shape)},"
                             f" got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
