"""Plain PyTorch versions of K4 (flash_attention) and K3 (dense flash_decode)
against the JAX package: its Pallas kernels run in interpret mode, as
tests/test_kernels_flash.py runs them, and its jnp references (ref.py, and
ops.flash_attention(impl="ref") with ops._lse_ref for the log-sum-exp), on
the same numpy inputs.

Bars: float32 agrees within 1e-5 absolute, o and lse alike.  bfloat16
inputs against the JAX reference: both round each softmax weight to
bfloat16 before the PV product and the output once, so a one-ulp fp32
difference in a score (XLA and ATen sum the dot products in other orders)
can flip one weight's rounding; the bar is one bfloat16 rounding step of
the summed terms' magnitude, 2**-7 x (|o| + the attention of |v|) plus
1e-6.  The decode computes in float32 and rounds only its output: 2**-7
relative plus 1e-6.  A decode lane of length 0 is exactly 0.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_fwd as jfa_pallas
from repro.kernels.flash_decode import flash_decode as jfd_pallas
from repro_torch.kernels import flash_attention, flash_decode, ops, ref

F32_ATOL = 1e-5
BF16_RTOL = 2.0 ** -7
B, HKV, D = 2, 2, 16
# (causal, window, Sq, Skv) per mask mode; Sq = 37 is no tile multiple
MODES = {"causal": (True, 0, 37, 37), "full": (False, 0, 37, 37),
         "window": (True, 8, 37, 37), "short_q": (True, 0, 20, 37),
         "short_q_full": (False, 0, 20, 37)}
# (G, mode, softcap): every mask mode at every group size, each softcap
# setting under every mode, and fewer queries than keys (interpret-mode
# Pallas compiles each case, so the full cross product would be slow)
FA_CASES = [(G, mode, 0.0) for G in (1, 2, 4)
            for mode in ("causal", "full", "window")] + [
    (2, "causal", 30.0), (2, "full", 30.0), (4, "window", 30.0),
    (2, "short_q", 0.0), (1, "short_q_full", 30.0)]


def _fa_case(G, sq, skv, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, sq, HKV * G, D)).astype(np.float32),
            rng.standard_normal((B, skv, HKV, D)).astype(np.float32),
            rng.standard_normal((B, skv, HKV, D)).astype(np.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(a).to(dtype)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not torch.is_tensor(x) \
        else x.float().numpy()


@pytest.mark.parametrize("G,mode,softcap", FA_CASES)
def test_flash_attention_matches_jax_f32(G, mode, softcap):
    causal, window, sq, skv = MODES[mode]
    q, k, v = _fa_case(G, sq, skv)
    kw = dict(causal=causal, window=window, logit_softcap=softcap)
    o, lse = ref.flash_attention(_t(q), _t(k), _t(v), **kw)
    assert o.shape == q.shape and lse.shape == (B, sq, HKV * G)
    assert lse.dtype == torch.float32
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    o_p, lse_p = jfa_pallas(jq, jk, jv, **kw)
    o_r = jops.flash_attention(jq, jk, jv, impl="ref", **kw)
    lse_r = jops._lse_ref(jq, jk, causal, window, softcap, None)
    for want_o, want_lse in ((o_p, lse_p), (o_r, lse_r)):
        np.testing.assert_allclose(_np(o), _np(want_o), atol=F32_ATOL,
                                   rtol=0)
        np.testing.assert_allclose(_np(lse), _np(want_lse), atol=F32_ATOL,
                                   rtol=0)
    # the wrapper and the dispatch take the plain version for CPU tensors
    got = ops.flash_attention(_t(q), _t(k), _t(v), **kw)
    assert torch.equal(got, o)
    assert torch.equal(flash_attention.flash_attention_fwd(
        _t(q), _t(k), _t(v), **kw)[1], lse)


@pytest.mark.parametrize("G", [1, 2, 4])
def test_flash_attention_matches_jax_bf16(G):
    q, k, v = _fa_case(G, 37, 37, seed=1)
    kw = dict(causal=True, window=8, logit_softcap=30.0)
    tq, tk, tv = (_t(a, torch.bfloat16) for a in (q, k, v))
    o, lse = ref.flash_attention(tq, tk, tv, **kw)
    assert o.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = _np(jops.flash_attention(jq, jk, jv, impl="ref", **kw))
    terms = ref.flash_attention(tq, tk, tv.abs(), **kw)[0].float().numpy()
    got = _np(o)
    assert (np.abs(got - want)
            <= BF16_RTOL * (np.abs(want) + terms) + 1e-6).all()
    np.testing.assert_allclose(
        _np(lse), _np(jops._lse_ref(jq, jk, True, 8, 30.0, None)),
        atol=F32_ATOL, rtol=0)


S_CACHE = 40
LENS = np.array([0, 1, S_CACHE, 23], np.int32)
# (window, softcap, one length for every lane) per variant
DECODE_VARIANTS = {"plain": (0, 0.0, None), "window": (8, 0.0, None),
                   "softcap": (0, 30.0, None), "scalar": (0, 0.0, 17)}
DECODE_CASES = [(G, "plain") for G in (1, 2, 4)] + [
    (2, "window"), (4, "softcap"), (1, "scalar")]


def _decode_case(G, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((4, 1, HKV * G, D)).astype(np.float32),
            rng.standard_normal((4, S_CACHE, HKV, D)).astype(np.float32),
            rng.standard_normal((4, S_CACHE, HKV, D)).astype(np.float32))


@pytest.mark.parametrize("G,variant", DECODE_CASES)
def test_flash_decode_matches_jax_f32(G, variant):
    window, softcap, scalar = DECODE_VARIANTS[variant]
    q, k, v = _decode_case(G)
    lens = scalar if scalar is not None else LENS
    t_lens = scalar if scalar is not None else torch.from_numpy(LENS)
    kw = dict(window=window, logit_softcap=softcap)
    got = ops.flash_decode(_t(q), _t(k), _t(v), t_lens, **kw)
    assert torch.equal(got, flash_decode.flash_decode(_t(q), _t(k), _t(v),
                                                      t_lens, **kw))
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    for want in (jfd_pallas(jq, jk, jv, jnp.asarray(lens), **kw),
                 jref.flash_decode(jq, jk, jv, jnp.asarray(lens), **kw)):
        np.testing.assert_allclose(_np(got), _np(want), atol=F32_ATOL,
                                   rtol=0)
    if scalar is None:
        assert not got[0].numpy().any(), "lane of length 0 not exactly 0"


@pytest.mark.parametrize("G", [1, 2, 4])
def test_flash_decode_matches_jax_bf16(G):
    q, k, v = _decode_case(G, seed=3)
    got = ops.flash_decode(*(_t(a, torch.bfloat16) for a in (q, k, v)),
                           torch.from_numpy(LENS), window=8)
    assert got.dtype == torch.bfloat16
    want = jref.flash_decode(*(jnp.asarray(a, jnp.bfloat16)
                               for a in (q, k, v)), jnp.asarray(LENS),
                             window=8)
    np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_RTOL,
                               atol=1e-6)
