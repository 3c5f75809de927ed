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

reference = ref.mamba2_scan_chunked

# state sizes N the kernel is instantiated for
STATE_SIZES = (16, 32, 64, 128)
# time steps of a chunk of the bf16 kernel's chunk-parallel form
CHUNK = 128


def mamba2_scan(x, dt, A, Bm, Cm) -> torch.Tensor:
    """x: (B, S, H, P) and Bm / Cm: (B, S, N) in one dtype (float32 or
    bfloat16); dt: (B, S, H) and A: (H,) float32; all contiguous.
    Returns y (B, S, H, P) in x's dtype."""
    if x.device.type == "cpu":
        return reference(x, dt, A, Bm, Cm)
    if x.dim() != 4:
        raise ValueError(f"mamba2_scan: x must be (B, S, H, P), got "
                         f"{tuple(x.shape)}")
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    check_scan_operands("mamba2_scan", {"x": x, "Bm": Bm, "Cm": Cm},
                        {"dt": dt, "A": A},
                        {"x": (Bsz, S, H, P), "Bm": (Bsz, S, N),
                         "Cm": (Bsz, S, N), "dt": (Bsz, S, H), "A": (H,)})
    if N not in STATE_SIZES:
        raise ValueError(f"mamba2_scan: state size {N} not supported "
                         f"(kernel takes {STATE_SIZES})")
    y = torch.empty_like(x)
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
