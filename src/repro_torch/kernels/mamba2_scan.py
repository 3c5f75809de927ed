"""K6: the Mamba2 (SSD) selective scan, hand-written for Hopper.

The CUDA kernel is csrc/mamba2_scan.cu (see the note at its top: the TPU
kernel it replaces, what bounds it, and how it is laid out): in bfloat16
the chunked form on the tensor cores, a state scan over chunks and then
every chunk's output in parallel (the plain form of its arithmetic is
kernels/ref.py mamba2_scan_chunk_parallel), in float32 the recurrence on
the CUDA cores.  This module holds its wrapper and, beside
it, its plain PyTorch version (`reference`, the chunked scan of
kernels/ref.py).  The wrapper launches the kernel for
CUDA tensors and takes the plain version only for tensors on the CPU;
`launches` counts kernel launches and nothing else.  A direct CUDA call
that autograd would need to differentiate raises instead of returning a
result cut off from the graph: the gradient goes through
kernels/ops.py's autograd Function, whose backward is mamba2_scan_bwd
below.

mamba2_scan_bwd is the scan's backward, hand-written for Hopper too
(csrc/mamba2_scan_bwd.cu; the TPU kernel has no backward - the JAX
package differentiates the plain chunked scan - so it replaces none): in
bfloat16 the chunked backward on the tensor cores, serial over the
chunks only (the plain form of its arithmetic is kernels/ref.py
mamba2_scan_bwd_chunk_parallel), in float32 the recurrence on the CUDA
cores.  Beside it stands its plain version (`reference_bwd`:
torch.autograd.grad through the chunked scan); `bwd_launches` counts its
launches.
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

reference = ref.mamba2_scan_chunked
reference_bwd = ref.mamba2_scan_bwd

# state sizes N the kernel is instantiated for
STATE_SIZES = (16, 32, 64, 128)
# time steps of a chunk of the bf16 kernels' chunk-parallel forms (the
# forward's and the backward's)
CHUNK = 128
# the bf16 backward: heads whose dB / dC one block sums before its group's
# partials go to scratch (csrc/mamba2_scan_bwd.cu HEADS)
BWD_HEADS = 10
# the float32 backward: state rows (of P) a block owns, and time steps
# between its saved states (csrc/mamba2_scan_bwd.cu ROWS, TS)
BWD_ROWS = 16
BWD_STEPS = 16


def _check(name, x, dt, A, Bm, Cm):
    """The operands' checks of both kernels; returns (B, S, H, P, N)."""
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be (B, S, H, P), got "
                         f"{tuple(x.shape)}")
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    check_scan_operands(name, {"x": x, "Bm": Bm, "Cm": Cm},
                        {"dt": dt, "A": A},
                        {"x": (Bsz, S, H, P), "Bm": (Bsz, S, N),
                         "Cm": (Bsz, S, N), "dt": (Bsz, S, H), "A": (H,)})
    if N not in STATE_SIZES:
        raise ValueError(f"{name}: state size {N} not supported "
                         f"(kernel takes {STATE_SIZES})")
    return Bsz, S, H, P, N


def mamba2_scan(x, dt, A, Bm, Cm) -> torch.Tensor:
    """x: (B, S, H, P) and Bm / Cm: (B, S, N) in one dtype (float32 or
    bfloat16); dt: (B, S, H) and A: (H,) float32; all contiguous.
    Returns y (B, S, H, P) in x's dtype."""
    if x.device.type == "cpu":
        return reference(x, dt, A, Bm, Cm)
    Bsz, S, H, P, N = _check("mamba2_scan", x, dt, A, Bm, Cm)
    y = torch.empty_like(x)
    if x.device.type == "meta":
        nbytes, flops = cost.k6_work(x.shape, N, x.element_size(), CHUNK)
        cost.record_kernel("K6", nbytes, flops, Bsz * S * H)
        return y
    # bf16: each chunk's carry-in state as two bf16 parts, between the
    # kernel's two launches (one launch count for both); float32 needs none
    bf16 = x.dtype == torch.bfloat16
    scratch = torch.empty(Bsz * H * -(-S // CHUNK) * 2 * P * N if bf16
                          else 0, dtype=torch.bfloat16, device=x.device)
    err = build.kernel("mamba2_scan")(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), y.data_ptr(), scratch.data_ptr(), Bsz, S, H, P, N,
        int(bf16), torch.cuda.current_stream(x.device).cuda_stream)
    build.check("mamba2_scan", err)
    global launches
    launches += 1
    return y


def mamba2_scan_bwd(x, dt, A, Bm, Cm, dy):
    """The scan's gradient from the forward's operands (as mamba2_scan
    takes them) and dy = dL/dy (B, S, H, P) in x's dtype, contiguous.
    Returns (dx, ddt, dA, dBm, dCm): dx, dBm, dCm in x's dtype, ddt and
    dA float32."""
    if x.device.type == "cpu":
        return reference_bwd(x, dt, A, Bm, Cm, dy)
    Bsz, S, H, P, N = _check("mamba2_scan_bwd", x, dt, A, Bm, Cm)
    check_scan_grad("mamba2_scan_bwd", dy, x.shape, x.dtype, x.device)
    dx, dB, dC = (torch.empty_like(t) for t in (x, Bm, Cm))
    ddt, dA = torch.empty_like(dt), torch.empty_like(A)
    if x.device.type == "meta":
        nbytes, flops = cost.k6_bwd_work(x.shape, N, x.element_size())
        cost.record_kernel("K6_bwd", nbytes, flops, 3 * Bsz * S * H)
        return dx, ddt, dA, dB, dC
    s1, s2, s3 = bwd_scratch(Bsz, S, H, P, N, x.dtype, x.device)
    err = build.kernel("mamba2_scan_bwd")(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), dy.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
        dA.data_ptr(), dB.data_ptr(), dC.data_ptr(), s1.data_ptr(),
        s2.data_ptr(), s3.data_ptr(), Bsz, S, H, P, N,
        int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check("mamba2_scan_bwd", err)
    global bwd_launches
    bwd_launches += 1
    return dx, ddt, dA, dB, dC


def bwd_scratch(Bsz, S, H, P, N, dtype, device):
    """The backward kernel's three scratch tensors, from torch.empty.
    bfloat16: each chunk's carry-in state and adjoint carry as two bf16
    parts, the head groups' fp32 partials of dBm and dCm, and dA's fp32
    partials per (sequence, chunk, head) - 201 MB at zamba2's training
    shape (4, 2048, 80, 64, N 64).  float32: each block's state at every
    BWD_STEPS-th step, then the per-(head, row block) partial sums of dBm
    and dCm and of ddt's two terms.  The kernel sums every set of
    partials in a fixed order."""
    f32 = dict(dtype=torch.float32, device=device)
    if dtype == torch.bfloat16:
        nc, groups = -(-S // CHUNK), -(-H // BWD_HEADS)
        return (torch.empty(2 * Bsz * H * nc * 2 * P * N,
                            dtype=torch.bfloat16, device=device),
                torch.empty(2 * groups * Bsz * S * N, **f32),
                torch.empty(Bsz * nc * H, **f32))
    npb, nck = -(-P // BWD_ROWS), -(-S // BWD_STEPS)
    return (torch.empty(Bsz * H * npb * nck * BWD_ROWS * N, **f32),
            torch.empty(2 * Bsz * S * H * npb * N, **f32),
            torch.empty(2 * Bsz * S * H * npb, **f32))
