"""Argument checks shared by the CUDA kernel wrappers: everything the
kernels do not take is refused here, before a pointer reaches C."""
from __future__ import annotations

import torch

# head dims of the dense-cache kernels K3 and K4 (80: zamba2's shared
# attention block); the paged kernels K1, K2 and the backward K5 take
# HEAD_DIMS_64_128 (no path runs them at 80)
HEAD_DIMS = (64, 80, 128)
HEAD_DIMS_64_128 = (64, 128)
DTYPES = (torch.float32, torch.bfloat16)


def check_operands(name: str, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, index_tensors, *,
                   layout: str = "(P, page_size, Hkv, D)",
                   head_dims=HEAD_DIMS):
    """q and the K/V operands (page pools, or contiguous (B, S, Hkv, D)
    caches - `layout` names which in the messages): same CUDA device,
    same float32/bfloat16 dtype, contiguous, head dim in `head_dims`, q's
    heads a multiple of the KV heads.  index_tensors: {arg name: (tensor,
    expected shape)}, each a contiguous int32 tensor on the same
    device."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel needs CUDA tensors, got "
                         f"q on {dev}")
    if q.dtype not in DTYPES:
        raise TypeError(f"{name}: q must be float32 or bfloat16, got "
                        f"{q.dtype}")
    for arg, t in (("k", k), ("v", v)):
        if t.device != dev or t.dtype != q.dtype:
            raise ValueError(f"{name}: {arg} is {t.dtype} on {t.device}, "
                             f"q is {q.dtype} on {dev}")
        if t.dim() != 4 or t.shape != k.shape:
            raise ValueError(f"{name}: k and v must both be {layout}, got "
                             f"{tuple(t.shape)}")
    for arg, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    D, Hkv = k.shape[3], k.shape[2]
    if q.dim() != 4 or q.shape[3] != D:
        raise ValueError(f"{name}: q must be (B, S, Hq, {D}), got "
                         f"{tuple(q.shape)}")
    if D not in head_dims:
        raise ValueError(f"{name}: head dim {D} not supported (kernel "
                         f"takes {head_dims})")
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


def check_scan_operands(name: str, acts, f32s, shapes):
    """The operands of a scan kernel (K6, K7): `acts` {arg: tensor} in one
    float32/bfloat16 dtype, `f32s` {arg: tensor} float32 (decays and step
    sizes are never rounded to bfloat16), all contiguous on one CUDA
    device, each of the shape `shapes` names.  The kernels have no
    backward, so a call autograd would have to differentiate raises."""
    first = next(iter(acts.values()))
    dev = first.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel needs CUDA tensors, got "
                         f"{dev}")
    if first.dtype not in DTYPES:
        raise TypeError(f"{name}: activations must be float32 or bfloat16, "
                        f"got {first.dtype}")
    everything = dict(acts, **f32s)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in everything.values()):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward (nor has the TPU "
            f"kernel it replaces), and its result would carry no gradient; "
            f"run the plain version (impl='ref') to differentiate")
    for arg, t in everything.items():
        want = first.dtype if arg in acts else torch.float32
        if t.device != dev or t.dtype != want:
            raise ValueError(f"{name}: {arg} must be {want} on {dev}, got "
                             f"{t.dtype} on {t.device}")
        if tuple(t.shape) != tuple(shapes[arg]):
            raise ValueError(f"{name}: {arg} must have shape "
                             f"{tuple(shapes[arg])}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
