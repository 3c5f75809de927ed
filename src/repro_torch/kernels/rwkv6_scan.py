"""K7: the RWKV6 (Finch) WKV scan, hand-written for Hopper.

The CUDA kernel is csrc/rwkv6_scan.cu (see the note at its top: the TPU
kernel it replaces, what bounds it, and how it is laid out): in bfloat16
the chunked form on the tensor cores, a state scan over chunks and then
every chunk's output in parallel (the plain form of its arithmetic is
kernels/ref.py rwkv6_scan_chunk_parallel), in float32 the recurrence on
the CUDA cores.  This module holds its wrapper and, beside it, its plain
PyTorch version (`reference`, the chunked scan of kernels/ref.py).  The wrapper launches the kernel for
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
# time steps of a chunk of the bf16 kernel's chunk-parallel form
CHUNK = 64


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
    # bf16: each chunk's carry-in state as two bf16 parts, between the
    # kernel's two launches (one launch count for both); float32 needs none
    bf16 = r.dtype == torch.bfloat16
    scratch = torch.empty(Bsz * H * -(-S // CHUNK) * 2 * K * V if bf16
                          else 0, dtype=torch.bfloat16, device=r.device)
    err = build.kernel("rwkv6_scan")(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u.data_ptr(), y.data_ptr(), scratch.data_ptr(), Bsz, S, H, K, V,
        int(bf16), torch.cuda.current_stream(r.device).cuda_stream)
    build.check("rwkv6_scan", err)
    global launches
    launches += 1
    return y
