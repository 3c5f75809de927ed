"""K7: the RWKV6 (Finch) WKV scan, hand-written for Hopper.

The CUDA kernel is csrc/rwkv6_scan.cu (see the note at its top: the TPU
kernel it replaces, what bounds it, and how it is laid out).  This module
holds its wrapper and, beside it, its plain PyTorch version (`reference`,
the chunked scan of kernels/ref.py).  The wrapper launches the kernel for
CUDA tensors and takes the plain version only for tensors on the CPU;
`launches` counts kernel launches and nothing else.  The kernel has no
backward (neither has the TPU kernel): a CUDA call that autograd would
need to differentiate raises instead of returning a result cut off from
the graph.
"""
from __future__ import annotations

import torch

from . import build, ref
from ._checks import check_scan_operands

# kernel launches made by the wrapper below (CPU calls do not count)
launches = 0

reference = ref.rwkv6_scan_chunked

# key sizes K the kernel is instantiated for
KEY_SIZES = (16, 32, 64)


def rwkv6_scan(r, k, v, w, u) -> torch.Tensor:
    """r, k: (B, S, H, K) and v: (B, S, H, V) in one dtype (float32 or
    bfloat16); w: (B, S, H, K) decay in (0, 1] and u: (H, K) bonus,
    float32; all contiguous.  Returns y (B, S, H, V) in r's dtype."""
    if r.device.type == "cpu":
        return reference(r, k, v, w, u)
    if r.dim() != 4:
        raise ValueError(f"rwkv6_scan: r must be (B, S, H, K), got "
                         f"{tuple(r.shape)}")
    Bsz, S, H, K = r.shape
    V = v.shape[-1]
    check_scan_operands("rwkv6_scan", {"r": r, "k": k, "v": v},
                        {"w": w, "u": u},
                        {"r": (Bsz, S, H, K), "k": (Bsz, S, H, K),
                         "v": (Bsz, S, H, V), "w": (Bsz, S, H, K),
                         "u": (H, K)})
    if K not in KEY_SIZES:
        raise ValueError(f"rwkv6_scan: key size {K} not supported (kernel "
                         f"takes {KEY_SIZES})")
    y = torch.empty_like(v)
    err = build.kernel("rwkv6_scan")(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u.data_ptr(), y.data_ptr(), Bsz, S, H, K, V,
        int(r.dtype == torch.bfloat16),
        torch.cuda.current_stream(r.device).cuda_stream)
    build.check("rwkv6_scan", err)
    global launches
    launches += 1
    return y
