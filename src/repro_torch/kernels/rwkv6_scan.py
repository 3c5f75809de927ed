"""K7: the RWKV6 (Finch) WKV scan, hand-written for Hopper.

The CUDA kernel is csrc/rwkv6_scan.cu (see the note at its top: the TPU
kernel it replaces, what bounds it, and how it is laid out): in bfloat16
the chunked form on the tensor cores, a state scan over chunks and then
every chunk's output in parallel (the plain form of its arithmetic is
kernels/ref.py rwkv6_scan_chunk_parallel), in float32 the recurrence on
the CUDA cores.  This module holds its wrapper and, beside it, its plain
PyTorch version (`reference`, the chunked scan of kernels/ref.py).  The wrapper launches the kernel for
CUDA tensors and takes the plain version only for tensors on the CPU;
`launches` counts kernel launches and nothing else.  A direct CUDA call
that autograd would need to differentiate raises instead of returning a
result cut off from the graph: the gradient goes through
kernels/ops.py's autograd Function, whose backward is rwkv6_scan_bwd
below.

rwkv6_scan_bwd is the scan's backward, hand-written for Hopper too
(csrc/rwkv6_scan_bwd.cu; the TPU kernel has no backward - the JAX
package differentiates the plain chunked scan - so it replaces none),
beside its plain version (`reference_bwd`: torch.autograd.grad through
the chunked scan); `bwd_launches` counts its launches.  In bfloat16 it is
the chunked backward in K7's 64-step chunks (the plain form of its
arithmetic is kernels/ref.py rwkv6_scan_bwd_chunk_parallel): K7's state
scan forward and, for the adjoint, in reverse over the chunks; dv as K7's
output launch on the reversed sequence; dr, dk and dw from every chunk at
once, the pair sums on the CUDA cores; in float32 the recurrence on the
CUDA cores, walking every step.  Its scratch is bwd_scratch's.  Bytes
bound it (launch/cost.py k7_bwd_work); on the card it runs ~8.6x from
that bound at rwkv6's training shape, held by the launch of the pair sums
(one block an SM, its loads with no work in flight), PERF.md.
A tensor on the meta device launches nothing: the wrapper checks it as
it would a CUDA tensor, returns empty meta outputs and reports its
kernel's work to launch/cost.py (the dry run, launch/dryrun.py).
"""
from __future__ import annotations

import torch

from ..launch import cost
from . import build, ref
from ._checks import check_scan_grad, check_scan_operands

# kernel launches made by the wrappers below (CPU and meta calls do not
# count): the forward's, and the backward's
launches = 0
bwd_launches = 0

reference = ref.rwkv6_scan_chunked
reference_bwd = ref.rwkv6_scan_bwd

# key sizes K the kernel is instantiated for
KEY_SIZES = (16, 32, 64)
# time steps of a chunk of the bf16 kernel's chunk-parallel form
CHUNK = 64
# the backward kernel: value sizes V it is instantiated for, and, for its
# float32 recurrence, key channels (state rows) a block owns and time steps
# between its saved states (csrc/rwkv6_scan_bwd.cu ROWS, TS)
BWD_VALUE_SIZES = (16, 32, 64)
BWD_ROWS = 16
BWD_STEPS = 16


def _check(name, r, k, v, w, u):
    """The operands' checks of both kernels; returns (B, S, H, K, V)."""
    if r.dim() != 4:
        raise ValueError(f"{name}: r must be (B, S, H, K), got "
                         f"{tuple(r.shape)}")
    Bsz, S, H, K = r.shape
    V = v.shape[-1]
    check_scan_operands(name, {"r": r, "k": k, "v": v},
                        {"w": w, "u": u},
                        {"r": (Bsz, S, H, K), "k": (Bsz, S, H, K),
                         "v": (Bsz, S, H, V), "w": (Bsz, S, H, K),
                         "u": (H, K)})
    if K not in KEY_SIZES:
        raise ValueError(f"{name}: key size {K} not supported (kernel "
                         f"takes {KEY_SIZES})")
    return Bsz, S, H, K, V


def rwkv6_scan(r, k, v, w, u) -> torch.Tensor:
    """r, k: (B, S, H, K) and v: (B, S, H, V) in one dtype (float32 or
    bfloat16); w: (B, S, H, K) decay in (0, 1] and u: (H, K) bonus,
    float32; all contiguous.  Returns y (B, S, H, V) in r's dtype."""
    if r.device.type == "cpu":
        return reference(r, k, v, w, u)
    Bsz, S, H, K, V = _check("rwkv6_scan", r, k, v, w, u)
    y = torch.empty_like(v)
    if r.device.type == "meta":
        nbytes, flops = cost.k7_work(r.shape, V, r.element_size())
        cost.record_kernel("K7", nbytes, flops, Bsz * S * H * K)
        return y
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


def rwkv6_scan_bwd(r, k, v, w, u, dy):
    """The scan's gradient from the forward's operands (as rwkv6_scan
    takes them) and dy = dL/dy (B, S, H, V) in r's dtype, contiguous;
    value size V in BWD_VALUE_SIZES.  Returns (dr, dk, dv, dw, du): dr,
    dk, dv in r's dtype, dw and du float32."""
    if r.device.type == "cpu":
        return reference_bwd(r, k, v, w, u, dy)
    Bsz, S, H, K, V = _check("rwkv6_scan_bwd", r, k, v, w, u)
    check_scan_grad("rwkv6_scan_bwd", dy, v.shape, r.dtype, r.device)
    if V not in BWD_VALUE_SIZES:
        raise ValueError(f"rwkv6_scan_bwd: value size {V} not supported "
                         f"(kernel takes {BWD_VALUE_SIZES})")
    dr, dk, dv, dw, du = (torch.empty_like(t) for t in (r, k, v, w, u))
    if r.device.type == "meta":
        nbytes, flops = cost.k7_bwd_work(r.shape, V, r.element_size())
        cost.record_kernel("K7_bwd", nbytes, flops)
        return dr, dk, dv, dw, du
    ckpt, part_v, part_u = bwd_scratch(Bsz, S, H, K, V, r.dtype, r.device)
    err = build.kernel("rwkv6_scan_bwd")(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u.data_ptr(), dy.data_ptr(), dr.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), dw.data_ptr(), du.data_ptr(), ckpt.data_ptr(),
        part_v.data_ptr(), part_u.data_ptr(), Bsz, S, H, K, V,
        int(r.dtype == torch.bfloat16),
        torch.cuda.current_stream(r.device).cuda_stream)
    build.check("rwkv6_scan_bwd", err)
    global bwd_launches
    bwd_launches += 1
    return dr, dk, dv, dw, du


def bwd_scratch(Bsz, S, H, K, V, dtype, device):
    """The backward kernel's three scratch tensors (ckpt, part_v, part_u),
    from torch.empty.  bfloat16: each chunk's carry-in state S_in and
    adjoint carry G_out as two bf16 parts, no dv partials, and du's fp32
    partials per (sequence, chunk) - 135 MB at rwkv6's training shape (4,
    2048, 32, 64, V 64).  float32: each block's state at every BWD_STEPS-th
    step, the per-(key block) partial sums of dv and the per-sequence ones
    of du (537 MB there).  The kernel sums every set of partials in a
    fixed order."""
    f32 = dict(dtype=torch.float32, device=device)
    if dtype == torch.bfloat16:
        nc = -(-S // CHUNK)
        return (torch.empty(2 * Bsz * H * nc * 2 * K * V,
                            dtype=torch.bfloat16, device=device),
                torch.empty(0, **f32), torch.empty(Bsz * nc * H * K, **f32))
    nck = -(-S // BWD_STEPS)
    return (torch.empty(Bsz * H * nck * K * V, **f32),
            torch.empty(Bsz * S * H * (K // BWD_ROWS) * V, **f32),
            torch.empty(Bsz * H * K, **f32))
