"""The arithmetic of the bf16 K7_bwd (csrc/rwkv6_scan_bwd.cu), the
chunked backward of the RWKV6 scan, on the CPU: its plain form
kernels/ref.py rwkv6_scan_bwd_chunk_parallel.

In float32 the form is held against jax.vjp of the JAX naive scan
(src/repro/kernels/ref.py rwkv6_scan) and against the plain backward
ref.rwkv6_scan_bwd (autograd through the chunked scan in float64), all
five gradients, within 1e-5 of each gradient's largest element: on a
sequence that is no chunk multiple, one shorter than a chunk, w at the
model's clamp, w = 1, and w = 1e-3 far below the clamp - there against the
naive scan only, since the chunked form's e^{-cw} overflows in float32.
At w = 1e-3 GLA's d log w - the reverse cumulative sums of r dr and k dk,
subtracted, then divided by w - misses dw by far (seen 3.1e-4 of its
largest element, 31x the bar): its two sums grow over the sequence and
their float32 rounding is divided by w.  The form takes dw_m = S_{m-1} .
G_m as a sum over the pairs that straddle m, each decay a product of w
that leaves w_m out (seen within 3e-7 here).

The kernel's tensor cores take bf16 operands: r, k, v and dy are bf16
inputs, but the products' float32 operands enter as bf16 parts, hi =
bf16(x), then bf16 of each exact remainder, summed in one float32
accumulator: the carries' contributions ("k_out", "r_in"), the carries
S_in and G_out themselves ("state", "adjoint") and dv's four others, K7's
("dv_r_sub", "dv_k_sub", "dv_weights", "dv_r_dec").  The second half of
the file emulates that (dr, dk and dv rounded to bf16 once) on the card
tests' RWKV_BWD_CASES that fit the CPU and holds it to the card bar
(tests/test_torch_kernels_cuda.py scan_bwd_close: 1e-5 of the larger of
the gradient's largest element and its largest term, plus 2**-7 (|g| +
terms) for a bf16 gradient).  Two parts of every operand hold it in every
case.  That bar's rounding step of the terms' magnitude is loose enough
that one part of dv's four operands holds it too (seen on every case
here), while one part of the carries' four misses it on long_clamp.
Against K7's own bar - a rounding step of |g| only, 2**-7 |g|, plus 1e-5
of the largest term, which dv's code, K7's output launch, is built to -
two parts hold dr, dk and dv, and one part of any of the eight operands
misses it on the 1000 clamped steps of long_clamp (seen 1 to 1295
elements): why the kernel pays for each second part.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref, rwkv6_scan
from test_torch_kernels_cuda import CLAMP_W, RWKV_BWD_CASES, _dy, \
    rwkv_args, rwkv_bwd_terms

NAMES = ("dr", "dk", "dv", "dw", "du")
F32 = 1e-5
CPU = torch.device("cpu")
# (B, S, H, K, V, w): w = exp(-exp(N(0, 1) clipped to [-8, 0.75])), or
# every step's w the clamp, 1, or 1e-3
CASES = {"ragged": (2, 300, 3, 16, 16, "random"),
         "short": (2, 37, 2, 16, 32, "random"),
         "w_clamp": (1, 200, 2, 16, 16, "clamp"),
         "w_one": (1, 150, 2, 16, 16, "one"),
         "w_1e-3": (1, 200, 2, 16, 16, "below")}
# the card cases too large for the CPU
CPU_CASES = [c for c in RWKV_BWD_CASES
             if c not in ("full_rwkv6", "train_rwkv6")]
OPERANDS = ("k_out", "r_in", "state", "adjoint", "dv_r_sub", "dv_k_sub",
            "dv_weights", "dv_r_dec")


def inputs(B, S, H, K, V, w_kind, seed=0):
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    w = np.exp(-np.exp(np.clip(rng.standard_normal((B, S, H, K)), -8,
                               0.75))).astype(np.float32)
    if w_kind != "random":
        w[:] = {"one": 1.0, "clamp": CLAMP_W, "below": 1e-3}[w_kind]
    return (f32(B, S, H, K), f32(B, S, H, K), f32(B, S, H, V), w,
            f32(H, K) * np.float32(0.1)), f32(B, S, H, V)


@functools.lru_cache(maxsize=None)
def _naive_vjp():
    return jax.jit(lambda dy, *a: jax.vjp(jref.rwkv6_scan, *a)[1](dy))


def naive_grads(ins, dy):
    """jax.vjp against dy of the JAX naive scan, float32."""
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
    got = ref.rwkv6_scan_bwd_chunk_parallel(*ts, torch.from_numpy(dy),
                                            chunk=rwkv6_scan.CHUNK)
    assert [g.dtype for g in got] == [torch.float32] * 5
    wants = [naive_grads(ins, dy)]
    if CASES[case][5] != "below":     # the chunked e^{-cw} overflows there
        wants.append(ref.rwkv6_scan_bwd(*ts, torch.from_numpy(dy)))
    for want in wants:
        errs = rel_errs(got, want)
        assert max(errs.values()) <= F32, errs


def gla_dw(r, k, v, w, u, dy, dr, dk):
    """GLA's dw from dr and dk (float32): d log w_m = sum_{t > m} r_t dr_t
    - sum_{s >= m} k_s dk_s (the bonus terms taken out), over w_m."""
    vdy = (v * dy).sum(-1, keepdim=True)
    a = r * (dr - u * k * vdy)
    b = k * (dk - r * u * vdy)
    suffix = lambda t: torch.flip(torch.cumsum(torch.flip(t, (1,)), 1), (1,))
    after = torch.cat([suffix(a)[:, 1:], torch.zeros_like(a[:, :1])], 1)
    return (after - suffix(b)) / w


def test_the_gla_difference_form_loses_dw_below_the_clamp():
    """At w = 1e-3 the difference form's dw, from the form's own float32
    dr and dk, lands far past the bar the pair sums hold."""
    ins, dy = inputs(*CASES["w_1e-3"])
    ts = [torch.from_numpy(a) for a in ins]
    dyt = torch.from_numpy(dy)
    got = ref.rwkv6_scan_bwd_chunk_parallel(*ts, dyt,
                                            chunk=rwkv6_scan.CHUNK)
    naive = naive_grads(ins, dy)
    gla = list(got)
    gla[3] = gla_dw(*ts, dyt, got[0], got[1])
    assert rel_errs(gla, naive)["dw"] > 10 * F32
    assert rel_errs(got, naive)["dw"] <= F32


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
    magnitudes (tests/test_torch_kernels_cuda.py): below the clamp the
    naive scan's gradient, as the card test takes it."""
    a = rwkv_args(CPU, torch.bfloat16, *RWKV_BWD_CASES[case])
    dy = _dy(a["v"], 32)
    if RWKV_BWD_CASES[case][5] == "below":
        plain = lambda *x: ref._grad_through(ref.rwkv6_scan, x[:5], x[5])
    else:
        plain = ref.rwkv6_scan_bwd
    return a, dy, plain(*a.values(), dy), rwkv_bwd_terms(a, dy, plain)


def past_the_bar(case, parts, k7_bar=False):
    """Elements of the emulation past the card bar, per gradient, with
    parts[name] bf16 parts of each float32 operand; k7_bar: a bf16
    gradient's rounding step of |g| only, 2**-7 |g|, as K7's own bar
    (scan_close) takes it, not of |g| + terms."""
    a, dy, want, terms = _plain(case)
    got = ref.rwkv6_scan_bwd_chunk_parallel(
        **a, dy=dy, chunk=rwkv6_scan.CHUNK,
        operand=lambda name, t: bf16_parts(parts[name])(t))
    out = {}
    for name, g, w, t in zip(NAMES, got, want, terms):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        bf16 = g.dtype == torch.bfloat16
        g, w, t = g.float(), w.float(), t.float().abs()
        assert bool(torch.isfinite(g).all()), name
        bar = 1e-5 * max(float(w.abs().max()), float(t.max()))
        if bf16:
            bar = 2.0 ** -7 * (w.abs() + (0.0 if k7_bar else t)) + bar
        out[name] = int(((g - w).abs() > bar).sum())
    return out


@pytest.mark.parametrize("case", CPU_CASES)
def test_two_parts_hold_the_card_bar(case):
    missed = past_the_bar(case, dict.fromkeys(OPERANDS, 2))
    assert sum(missed.values()) == 0, missed


@pytest.mark.parametrize("case", ["long_clamp", "ragged"])
def test_two_parts_hold_k7s_own_bar(case):
    missed = past_the_bar(case, dict.fromkeys(OPERANDS, 2), k7_bar=True)
    assert sum(missed.values()) == 0, missed


@pytest.mark.parametrize("operand", OPERANDS)
def test_one_part_of_any_operand_misses_k7s_own_bar(operand):
    parts = dict(dict.fromkeys(OPERANDS, 2), **{operand: 1})
    missed = past_the_bar("long_clamp", parts, k7_bar=True)
    assert sum(missed.values()) > 0, missed
