"""Why the bf16 K6 (csrc/mamba2_scan.cu) feeds each float32 operand of its
tensor-core products as two bf16 parts.

K6's plain version (kernels/ref.py mamba2_scan_chunked), like the TPU
kernel, keeps every intermediate in float32, and the card tests hold the
bf16 kernel to it within one rounding step of the output, 2**-7 |y|, plus
1e-5 of the largest term (tests/test_torch_kernels_cuda.py scan_close).
The kernel computes the chunk-parallel form (kernels/ref.py
mamba2_scan_chunk_parallel) on the tensor cores, which take bf16
operands: x, B and C are bf16 inputs, so C B^T and every product with x
or C on one side is exact, but three operands are float32 - the
dt-weighted x of a chunk's state contribution, the decay-weighted W = C
B^T * L * dt, and the carried state H.  The kernel splits each into bf16
parts, hi = bf16(v), then bf16 of each exact remainder, and sums their
products in one float32 accumulator.  This file emulates that arithmetic
on the CPU (bf16 x / B / C, the float32 operands as k bf16 parts, float32
sums, y rounded to bf16 once) on the card tests' MAMBA_CASES shapes that
fit the CPU (every one but the full zamba2 width), and holds it to the
card bar.

Two parts carry each operand to ~2**-16 of itself, and the products'
float32 error stays near 2e-6 of the largest term (at most 1.7e-6 on
these cases; 1.9e-6 at zamba2's length on 8 of its heads) - 5x inside the
1e-5 term of the bar - so two parts hold it in every case; the rounding
of y is covered by the 2**-7 |y| term.  One part (a bf16 operand, ~2**-8)
misses the bar by far, which is why the kernel pays for the second
product; a third would buy precision the bar does not ask for.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from test_torch_kernels_cuda import MAMBA_CASES, mamba_args

CPU_CASES = [c for c in MAMBA_CASES if c != "full_zamba2"]
CPU = torch.device("cpu")


def bf16_parts(k):
    """The float32 value the kernel's k bf16 parts of an operand sum to."""
    def operand(t):
        out, rest = torch.zeros_like(t), t
        for _ in range(k):
            part = rest.to(torch.bfloat16).float()
            out, rest = out + part, rest - part
        return out
    return operand


def past_the_bar(case, parts):
    """Elements of the emulation past the card tests' bf16 bar."""
    a = mamba_args(CPU, torch.bfloat16, *MAMBA_CASES[case])
    want = ref.mamba2_scan_chunked(**a).float()
    terms = ref.mamba2_scan_chunked(a["x"].abs(), a["dt"], a["A"],
                                    a["Bm"].abs(), a["Cm"].abs())
    got = ref.mamba2_scan_chunk_parallel(**a, operand=bf16_parts(parts))
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    bar = 2.0 ** -7 * want.abs() + 1e-5 * float(terms.float().abs().max())
    return int(((got.float() - want).abs() > bar).sum())


@pytest.mark.parametrize("case", CPU_CASES)
def test_two_parts_hold_the_bar(case):
    assert past_the_bar(case, parts=2) == 0


def test_one_part_misses_the_bar():
    assert all(past_the_bar(case, parts=1) > 0 for case in CPU_CASES)


def test_parts_sum_to_the_operand():
    """hi + the bf16 of its remainder is the float32 value to ~2**-16 of
    itself, three parts to float32's own precision."""
    rng = np.random.default_rng(0)
    v = torch.from_numpy((rng.standard_normal(4096) * 10.0 ** rng.uniform(
        -6, 6, 4096)).astype(np.float32))
    rel = lambda k: float(((bf16_parts(k)(v) - v).abs() / v.abs()).max())
    assert rel(1) <= 2.0 ** -8 and rel(2) <= 2.0 ** -16
    assert rel(3) <= 2.0 ** -23
