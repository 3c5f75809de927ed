"""The split-KV form of the dense decode K3 (csrc/dense_decode.cu, the split
kernel of csrc/split_decode.cuh) in plain PyTorch, against the JAX package
on the CPU: kernels/ref.py flash_decode_split (per-split unnormalised (m,
l, o) over the strip, then combine_partial_softmax) at splits of 16 and
the kernel's own (kernels/flash_decode.py SPLIT) against the JAX Pallas
flash_decode (interpret mode, as tests/test_kernels_flash.py runs it) and
the JAX reference repro.kernels.ref.flash_decode, on a strip of 300
positions (no multiple of either split) with lengths 0 and 1, at and
around the split edges, the whole strip, and past it; with and without a
window that starts inside a split, and with a softcap; GQA groups 1 and 4
at head dims 16 and 80 (zamba2's shared attention block).

A length past the strip is clamped to it (the kernel walks [lo, min(len,
S))), as the Pallas kernel does here, where its KV block is the whole
strip.  The JAX reference instead pads the strip with zeros to its
1024-position block and masks only at len, so a lane longer than the
strip also attends to zero keys there: those lanes are held against the
Pallas kernel alone.

Bar: float32 within 1e-5 absolute (fp32 math on both sides, other
summation order).  A lane of length 0 comes out exactly 0.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_decode import flash_decode as jfd_pallas
from repro_torch.kernels import flash_decode, ref

F32_ATOL = 1e-5
HKV, S = 2, 300
# 0 and 1; around the first and second edge of both splits; the whole
# strip; past it (clamped to S)
LENS = [0, 1, 15, 16, 17, 127, 128, 129, 255, 256, 257, S, S + 1, 1000]
IN_STRIP = [i for i, n in enumerate(LENS) if n <= S]
# (window, softcap) per variant; a window of 100 starts inside a split
VARIANTS = {"plain": (0, 0.0), "window": (100, 0.0), "softcap": (0, 2.0)}


@functools.lru_cache(maxsize=None)
def _case(G, D, seed=5):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((len(LENS), 1, HKV * G, D)).astype(np.float32)
    k = rng.standard_normal((len(LENS), S, HKV, D)).astype(np.float32)
    v = rng.standard_normal((len(LENS), S, HKV, D)).astype(np.float32)
    return q, k, v, np.array(LENS, np.int32)


@functools.lru_cache(maxsize=None)
def _jax(G, D, variant):
    """(Pallas, reference) outputs of the JAX package, as numpy."""
    window, softcap = VARIANTS[variant]
    args = [jnp.asarray(a) for a in _case(G, D)]
    kw = dict(window=window, logit_softcap=softcap)
    return (np.asarray(jfd_pallas(*args, **kw)),
            np.asarray(jref.flash_decode(*args, **kw)))


@pytest.mark.parametrize("split", sorted({16, flash_decode.SPLIT}))
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("G,D", [(1, 16), (4, 16), (1, 80), (4, 80)])
def test_split_form_matches_jax(G, D, variant, split):
    window, softcap = VARIANTS[variant]
    got = ref.flash_decode_split(
        *(torch.from_numpy(a) for a in _case(G, D)), split=split,
        window=window, logit_softcap=softcap).numpy()
    pallas, reference = _jax(G, D, variant)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=F32_ATOL)
    np.testing.assert_allclose(got[IN_STRIP], reference[IN_STRIP], rtol=0,
                               atol=F32_ATOL)
    assert not got[0].any(), "lane of length 0 not exactly zero"


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_split_form_matches_the_plain_decode(variant):
    """The split form against the port's own plain decode (kernels/ref.py
    flash_decode, the kernel's plain version): one length for every lane
    as a Python int, and an empty strip, whose every lane is 0."""
    window, softcap = VARIANTS[variant]
    q, k, v, _ = (torch.from_numpy(a) for a in _case(2, 16))
    kw = dict(window=window, logit_softcap=softcap)
    for n in (0, 129, S, S + 7):
        got = ref.flash_decode_split(q, k, v, n, split=flash_decode.SPLIT,
                                     **kw)
        want = ref.flash_decode(q, k, v, n, **kw)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=F32_ATOL)
        assert n or not got.any()
    empty = ref.flash_decode_split(q, k[:, :0], v[:, :0],
                                   torch.from_numpy(np.array(LENS, np.int32)),
                                   split=flash_decode.SPLIT, **kw)
    assert empty.shape == q.shape and not empty.any()
