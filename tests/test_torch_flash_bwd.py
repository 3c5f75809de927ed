"""The plain version of K5 (repro_torch.kernels.ref.flash_attention_bwd)
against the JAX package, and the port's attention gradient on the CPU.

On the cases of tests/test_kernels_flash_bwd.py (GQA, non-causal, window
128, softcap 25, S = 200 padding), and at gemma3-4b's head dim 256 (GQA
with G 2, causal, and with a window of 128), the same numpy q, k, v, do -
with o and lse from the port's forward - go through the port's plain
backward, the JAX oracle ops._flash_bwd_rule (impl "ref") and the JAX
Pallas backward kernels in interpret mode, as the JAX package's own tests
run them.

Bars: float32 within 1e-5 of the largest |gradient|, against both.
bfloat16 against the oracle only: the oracle and the port round p and ds
to bfloat16 before their products (the Pallas kernel keeps them in
float32, so it is a different function in bfloat16), and a one-ulp fp32
difference in a score can flip one of those roundings; the bar is one
rounding step of the summed terms' magnitude, 2**-7 x (|g| + terms) +
1e-6, terms from ref.flash_attention_bwd(terms=True).  The plain backward
against autograd of the naive quadratic attention: 3e-4 of the largest
|gradient|, the JAX test's bar.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.flash_backward import flash_attention_bwd as jbwd_pallas
from repro_torch.kernels import flash_backward, ops, ref

# (B, S, Hq, Hkv, D, causal, window, softcap): tests/test_kernels_flash_bwd.py
CASES = [
    (1, 256, 2, 2, 32, True, 0, 0.0),
    (2, 256, 4, 2, 32, True, 0, 0.0),      # GQA
    (1, 256, 2, 2, 32, False, 0, 0.0),     # non-causal
    (1, 256, 2, 2, 32, True, 128, 0.0),    # sliding window
    (1, 256, 2, 2, 32, True, 0, 25.0),     # softcap
    (1, 200, 2, 1, 32, True, 0, 0.0),      # padding + group 2
    (1, 256, 4, 2, 256, True, 0, 0.0),     # gemma3-4b's head dim, G 2
    (1, 256, 4, 2, 256, True, 128, 0.0),   # and its sliding window
]
IDS = ["causal", "gqa", "full", "window", "softcap", "pad_g2", "d256_g2",
       "d256_window"]


def _inputs(case, dtype=torch.float32, seed=0):
    B, S, Hq, Hkv, D, causal, window, cap = case
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D),
                      (B, S, Hq, D))]
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in arrs)
    kw = dict(causal=causal, window=window, logit_softcap=cap)
    o, lse = ref.flash_attention(q, k, v, **kw)
    return (q, k, v, o, lse, do), kw


def _jax(t):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _f32(x):
    return x.float().numpy() if torch.is_tensor(x) \
        else np.asarray(jnp.asarray(x, jnp.float32))


def _rel(got, want):
    got, want = _f32(got), _f32(want)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_backward_matches_jax_f32(case):
    args, kw = _inputs(case)
    got = ref.flash_attention_bwd(*args, **kw)
    assert [g.dtype for g in got] == [torch.float32] * 3
    assert [g.shape for g in got] == [a.shape for a in args[:3]]
    q, k, v, o, lse, do = (_jax(a) for a in args)
    oracle = jops._flash_bwd_rule(kw["causal"], kw["window"],
                                  kw["logit_softcap"], None, "ref",
                                  (q, k, v, o, lse), do)
    pallas = jbwd_pallas(q, k, v, o, lse, do, **kw)
    for want in (oracle, pallas):
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            assert _rel(g, w) < 1e-5, (name, _rel(g, w))
    # the wrapper takes the plain version for CPU tensors
    again = flash_backward.flash_attention_bwd(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_backward_matches_jax_oracle_bf16(case):
    args, kw = _inputs(case, torch.bfloat16)
    got = ref.flash_attention_bwd(*args, **kw)
    assert [g.dtype for g in got] == [torch.bfloat16] * 3
    terms = ref.flash_attention_bwd(*args, terms=True, **kw)
    q, k, v, o, lse, do = (_jax(a) for a in args)
    want = jops._flash_bwd_rule(kw["causal"], kw["window"],
                                kw["logit_softcap"], None, "ref",
                                (q, k, v, o, lse), do)
    for name, g, w, t in zip(("dq", "dk", "dv"), got, want, terms):
        g, w = _f32(g), _f32(w)
        bar = 2.0 ** -7 * (np.abs(w) + t.numpy()) + 1e-6
        assert (np.abs(g - w) <= bar).all(), (name, np.abs(g - w).max())


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_autograd_through_ops_is_the_plain_rule(case):
    """torch.autograd.grad through ops.flash_attention on CPU tensors: the
    forward keeps (q, k, v, o, lse) and the backward is the plain rule;
    under no_grad the call is the plain forward alone."""
    (q, k, v, o, lse, do), kw = _inputs(case)
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = ops.flash_attention(qg, kg, vg, **kw)
    assert torch.equal(out.detach(), o)
    got = torch.autograd.grad(out, (qg, kg, vg), do)
    want = ref.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with torch.no_grad():
        plain = ops.flash_attention(qg, kg, vg, **kw)
    assert plain.grad_fn is None and torch.equal(plain, o)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_backward_matches_autograd_of_naive(case):
    (q, k, v, o, lse, _), kw = _inputs(case)
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    # the JAX test's loss: sum(o ** 2), so do = 2 o
    loss = torch.sum(ref.naive_attention(qg, kg, vg, **kw) ** 2)
    want = torch.autograd.grad(loss, (qg, kg, vg))
    got = ref.flash_attention_bwd(q, k, v, o, lse, 2.0 * o, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _rel(g, w) < 3e-4, (name, _rel(g, w))
