"""The arithmetic of the bf16 K6_bwd (csrc/mamba2_scan_bwd.cu), the
chunked backward of the Mamba2 scan, on the CPU: its plain form
kernels/ref.py mamba2_scan_bwd_chunk_parallel.

In float32 the form is held against jax.grad of the JAX naive scan
(src/repro/kernels/ref.py mamba2_scan) and against the plain backward
ref.mamba2_scan_bwd (autograd through the chunked scan in float64), all
five gradients, within 1e-5 of each gradient's largest element: on a
sequence that is no chunk multiple, one shorter than a chunk, and one
with dt * A about 6 a step across chunk boundaries.  There the float32
autograd form - the decay's gradient as the reverse cumulative sum of d
csum, the difference of two sums that grow over the chunk - misses dA by
far (seen 2.7e-4 of its largest element, 27x the bar, and ddt 1.9e-5):
why the kernel takes the decay term as the sum over the pairs s < t <=
t' instead (seen within 1.3e-6 of either yardstick here).

The kernel's tensor cores take bf16 operands: x, dy, B and C are bf16
inputs, but the products' float32 operands - the carries' x w and dy
exp(csum), the weights W'^T and Q (and Q^T), the carries H and G - enter
as bf16 parts, hi = bf16(v), then bf16 of each exact remainder, summed in
one float32 accumulator.  The second half of the file emulates that (the
float32 operands as k parts, dx, dBm and dCm rounded to bf16 once) on the
card tests' MAMBA_BWD_CASES that fit the CPU and holds it to the card bar
(tests/test_torch_kernels_cuda.py scan_bwd_close: 1e-5 of the larger of
the gradient's largest element and its largest term, plus 2**-7 (|g| +
terms) for a bf16 gradient).  Two parts hold it in every case; one part
(a bf16 operand, ~2**-8 of itself) misses it in every case, on ddt (6 to
268 elements a case), which stays float32 and has only the 1e-5 term -
why the kernel pays for the second product.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref
from test_torch_kernels_cuda import MAMBA_BWD_CASES, mamba_args, \
    mamba_bwd_terms

NAMES = ("dx", "ddt", "dA", "dBm", "dCm")
F32 = 1e-5
CPU = torch.device("cpu")
# (B, S, H, P, N, dt scale): dt = softplus(N(0, 1)) * scale, A in [0.5,
# 1.5] - dt * A near 0.3 at scale 0.4, about 6 at scale 8
CASES = {"ragged": (2, 300, 3, 8, 16, 0.4),
         "short": (2, 37, 2, 8, 16, 0.4),
         "large_dt_a": (1, 300, 2, 8, 16, 8.0)}
# the card cases too large for the CPU
CPU_CASES = [c for c in MAMBA_BWD_CASES
             if c not in ("full_zamba2", "train_zamba2")]


def inputs(B, S, H, P, N, scale, seed=0):
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((B, S, H)))) * scale
          ).astype(np.float32)
    A = (rng.random(H) + 0.5).astype(np.float32)
    return (f32(B, S, H, P), dt, A, f32(B, S, N), f32(B, S, N)), \
        f32(B, S, H, P)


@functools.lru_cache(maxsize=None)
def _naive_vjp():
    return jax.jit(lambda dy, *a: jax.vjp(jref.mamba2_scan, *a)[1](dy))


def naive_grads(ins, dy):
    """jax.grad (the vjp against dy) of the JAX naive scan, float32."""
    return [np.asarray(g) for g in _naive_vjp()(
        jnp.asarray(dy), *map(jnp.asarray, ins))]


def rel_errs(got, want):
    """|got - want|'s largest element over want's, gradient by gradient."""
    out = {}
    for name, g, w in zip(NAMES, got, want):
        g = g.double().numpy() if torch.is_tensor(g) else g.astype(
            np.float64)
        w = w.double().numpy() if torch.is_tensor(w) else w.astype(
            np.float64)
        assert g.shape == w.shape and np.isfinite(g).all(), name
        out[name] = float(np.abs(g - w).max() / np.abs(w).max())
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_chunked_backward_matches_jax_grad_and_the_plain_backward(case):
    ins, dy = inputs(*CASES[case])
    ts = [torch.from_numpy(a) for a in ins]
    got = ref.mamba2_scan_bwd_chunk_parallel(*ts, torch.from_numpy(dy))
    assert [g.dtype for g in got] == [torch.float32] * 5
    for want in (naive_grads(ins, dy),
                 ref.mamba2_scan_bwd(*ts, torch.from_numpy(dy))):
        errs = rel_errs(got, want)
        assert max(errs.values()) <= F32, errs


def test_the_autograd_form_loses_da_at_large_dt_a():
    """The float32 gradient through the chunked scan (d csum, then its
    reverse cumulative sum) against the naive scan's at dt * A ~6: dA far
    past the bar the chunked backward holds."""
    ins, dy = inputs(*CASES["large_dt_a"])
    ts = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    y = ref.mamba2_scan_chunked(*ts)
    auto = torch.autograd.grad(y, ts, torch.from_numpy(dy))
    errs = rel_errs(auto, naive_grads(ins, dy))
    assert errs["dA"] > 10 * F32, errs


def bf16_parts(k):
    """The float32 value the kernel's k bf16 parts of an operand sum to."""
    def operand(t):
        out, rest = torch.zeros_like(t), t
        for _ in range(k):
            part = rest.to(torch.bfloat16).float()
            out, rest = out + part, rest - part
        return out
    return operand


@functools.lru_cache(maxsize=None)
def _plain(case):
    """A card case's bf16 inputs, dy, the plain backward and the terms'
    magnitudes (tests/test_torch_kernels_cuda.py)."""
    a = mamba_args(CPU, torch.bfloat16, *MAMBA_BWD_CASES[case])
    dy = torch.from_numpy(np.random.default_rng(31).standard_normal(
        a["x"].shape).astype(np.float32)).to(torch.bfloat16)
    return a, dy, ref.mamba2_scan_bwd(**a, dy=dy), mamba_bwd_terms(a, dy)


def past_the_bar(case, parts):
    """Elements of the emulation past the card bar, per gradient."""
    a, dy, want, terms = _plain(case)
    got = ref.mamba2_scan_bwd_chunk_parallel(**a, dy=dy,
                                             operand=bf16_parts(parts))
    out = {}
    for name, g, w, t in zip(NAMES, got, want, terms):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        bf16 = g.dtype == torch.bfloat16
        g, w, t = g.float(), w.float(), t.float().abs()
        assert bool(torch.isfinite(g).all()), name
        bar = 1e-5 * max(float(w.abs().max()), float(t.max()))
        if bf16:
            bar = 2.0 ** -7 * (w.abs() + t) + bar
        out[name] = int(((g - w).abs() > bar).sum())
    return out


@pytest.mark.parametrize("case", CPU_CASES)
def test_two_parts_hold_the_card_bar(case):
    assert sum(past_the_bar(case, parts=2).values()) == 0


@pytest.mark.parametrize("case", CPU_CASES)
def test_one_part_misses_the_card_bar(case):
    missed = past_the_bar(case, parts=1)
    assert missed["ddt"] > 0, missed
