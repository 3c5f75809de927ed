"""Why the bf16 K7 (csrc/rwkv6_scan.cu) feeds each float32 operand of its
tensor-core products as two bf16 parts.

K7's plain version (kernels/ref.py rwkv6_scan_chunked), like the TPU
kernel, keeps every intermediate in float32, and the card tests hold the
bf16 kernel to it within one rounding step of the output, 2**-7 |y|, plus
1e-5 of the largest term (tests/test_torch_kernels_cuda.py scan_close;
below the model's decay clamp, to the naive scan).  The kernel computes
the chunk-parallel form (kernels/ref.py rwkv6_scan_chunk_parallel, at the
kernel's chunk and sub-chunk) on the tensor cores, which take bf16
operands: r, k and v are bf16 inputs, so every product with one of them
on one side is exact, but six operands are float32 - the decayed r_t
e^{cw_{t-1} - b} and k_s e^{b - cw_s} of the products between sub-chunks
("r_sub", "k_sub"), the intra-chunk weights with the bonus on their
diagonal ("weights"), the decayed r_t e^{cw_{t-1}} and the carry-in state
of the carry-in product ("r_dec", "state"), and the k_s e^{cw_last -
cw_s} of the state update ("k_out").  The kernel splits each into bf16
parts, hi = bf16(x), then bf16 of the exact remainder, and sums their
products in float32 (r_sub against k_sub and r_dec against the state as
hi.hi + hi.lo + lo.hi).  This file emulates that arithmetic on the CPU
(bf16 r / k / v, the float32 operands as bf16 parts, float32 sums, y
rounded to bf16 once) on the card tests' RWKV_CASES shapes that fit the
CPU (every one but the full rwkv6 width), and holds it to the card bar.

Two parts of each operand keep the emulation within 1e-6 of the largest
term past the output's rounding (2**-7 |y|), 10x inside the bar's 1e-5
term, in every case.  One part of any single operand (a bf16 operand,
~2**-8) misses the bar: every one of the six does over the 16 chunks of
many_chunks_v100, which is why the kernel pays for each second part.
"""
import pytest
import torch

from repro_torch.kernels import ref, rwkv6_scan
from test_torch_kernels_cuda import RWKV_CASES, rwkv_args
from test_torch_mamba2_parts import bf16_parts

CPU_CASES = [c for c in RWKV_CASES if c != "full_rwkv6"]
OPERANDS = ("r_sub", "k_sub", "weights", "r_dec", "state", "k_out")


def past_the_bar(case, parts, margin=1e-5):
    """Elements of the emulation past the card tests' bf16 bar (its
    second term margin x the largest term), with parts[name] bf16 parts
    of each float32 operand."""
    a = rwkv_args(torch.device("cpu"), torch.bfloat16, *RWKV_CASES[case])
    plain = ref.rwkv6_scan if RWKV_CASES[case][5] == "below" \
        else ref.rwkv6_scan_chunked
    want = plain(**a).float()
    terms = plain(a["r"].abs(), a["k"].abs(), a["v"].abs(), a["w"],
                  a["u"].abs())
    got = ref.rwkv6_scan_chunk_parallel(
        **a, chunk=rwkv6_scan.CHUNK,
        operand=lambda name, t: bf16_parts(parts[name])(t))
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    bar = 2.0 ** -7 * want.abs() + margin * float(terms.float().abs().max())
    return int(((got.float() - want).abs() > bar).sum())


@pytest.mark.parametrize("case", CPU_CASES)
def test_two_parts_hold_the_bar(case):
    # with a tenth of the card bar's 1e-5 term: two parts hold it 10x over
    assert past_the_bar(case, dict.fromkeys(OPERANDS, 2), margin=1e-6) == 0


@pytest.mark.parametrize("operand", OPERANDS)
def test_one_part_of_any_operand_misses_the_bar(operand):
    parts = dict(dict.fromkeys(OPERANDS, 2), **{operand: 1})
    assert past_the_bar("many_chunks_v100", parts) > 0
