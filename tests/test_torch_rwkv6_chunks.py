"""The chunk-parallel form of the RWKV6 WKV scan that K7's bf16 kernel
computes (csrc/rwkv6_scan.cu), in plain PyTorch (kernels/ref.py
rwkv6_scan_chunk_parallel: every chunk's state contribution at once, the
serial state pass over chunks, then every chunk's output at once, its
intra-chunk weights by 16-step sub-chunks), against the JAX package on
the CPU: its Pallas rwkv6_scan (interpret mode, as tests/
test_kernels_scans.py runs it) and its naive step-by-step
repro.kernels.ref.rwkv6_scan, on the same numpy inputs; and against the
port's own chunked and naive scans.  Cases: a sequence shorter than one
chunk, one that is no chunk multiple, one that is a multiple, key sizes K
of 16, 32 and 64, a value size V of 40 (neither K nor a multiple of a
16-column tile), u = 0, w = 1, w at the model's clamp, and w = 1e-3 a
step, far below the clamp: there the chunked forms' e^{-cw} overflows
float32 (the JAX package's output is not finite), while this form, which
exponentiates differences of cw only, matches the naive scans.

Bar: float32 within 1e-5 of the largest |output| - the forms sum in other
orders, and the chunked forms differ from the step-by-step ones by the
rounding of their cumulative sums.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.rwkv6_scan import rwkv6_scan as j_rwkv6_pallas
from repro_torch.kernels import ref

REL = 1e-5
CLAMP_W = float(np.exp(-np.exp(0.75)))
# (B, S, H, K, V, w: "random" | "one" | "clamp" | "below", u zero) per case
CASES = {"short_k16": (2, 20, 3, 16, 16, "random", False),
         "ragged_k32_v40": (1, 100, 2, 32, 40, "random", False),
         "chunk_multiple_k64": (1, 128, 2, 64, 64, "random", False),
         "u_zero": (2, 90, 2, 16, 24, "random", True),
         "w_one": (1, 80, 2, 32, 32, "one", False),
         "w_clamp": (1, 128, 2, 16, 16, "clamp", False)}


def _inputs(B, S, H, K, V, w_kind, u_zero, seed=0):
    rng = np.random.default_rng(seed)
    r, k = (rng.standard_normal((B, S, H, K)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((B, S, H, V)).astype(np.float32)
    w = np.exp(-np.exp(np.clip(rng.standard_normal((B, S, H, K)), -8,
                               0.75))).astype(np.float32)
    if w_kind != "random":
        w[:] = {"one": 1.0, "clamp": CLAMP_W, "below": 1e-3}[w_kind]
    u = (rng.standard_normal((H, K)) * 0.1 * (not u_zero)).astype(np.float32)
    return r, k, v, w, u


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want, np.float32)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=REL * np.abs(want).max())


@pytest.mark.parametrize("case", list(CASES))
def test_chunk_parallel_form_matches_jax(case):
    a = _inputs(*CASES[case])
    got = ref.rwkv6_scan_chunk_parallel(*(torch.from_numpy(t) for t in a))
    assert got.shape == a[2].shape and got.dtype == torch.float32
    ja = [jnp.asarray(t) for t in a]
    _close(got.numpy(), jref.rwkv6_scan(*ja))
    _close(got.numpy(), j_rwkv6_pallas(*ja))


@pytest.mark.parametrize("case", list(CASES))
def test_chunk_parallel_form_matches_the_port_scans(case):
    a = [torch.from_numpy(t) for t in _inputs(*CASES[case], seed=1)]
    got = ref.rwkv6_scan_chunk_parallel(*a)
    for want in (ref.rwkv6_scan_chunked(*a), ref.rwkv6_scan(*a)):
        _close(got.numpy(), want.numpy())


def test_finite_far_below_the_clamp():
    """w = 1e-3 a step: e^{-cw} passes float32's range after 13 steps, so
    the JAX package's chunked forms (Pallas and jnp) and the port's
    chunked scan are not finite; the chunk-parallel form equals the naive
    scans."""
    a = _inputs(2, 150, 2, 32, 40, "below", False)
    ta, ja = [torch.from_numpy(t) for t in a], [jnp.asarray(t) for t in a]
    got = ref.rwkv6_scan_chunk_parallel(*ta).numpy()
    _close(got, jref.rwkv6_scan(*ja))
    _close(got, ref.rwkv6_scan(*ta).numpy())
    for chunked in (j_rwkv6_pallas(*ja), jref.rwkv6_scan_chunked(*ja),
                    ref.rwkv6_scan_chunked(*ta).numpy()):
        assert not np.isfinite(np.asarray(chunked)).all()


@pytest.mark.parametrize("chunk", [16, 32, 128])
def test_the_chunk_size_is_the_kernels_to_choose(chunk):
    """The function does not depend on the chunk: any multiple of the
    16-step sub-chunk gives the naive scan's result (and bf16 inputs come
    back in bf16)."""
    a = [torch.from_numpy(t) for t in _inputs(*CASES["ragged_k32_v40"],
                                              seed=2)]
    _close(ref.rwkv6_scan_chunk_parallel(*a, chunk=chunk).numpy(),
           ref.rwkv6_scan(*a).numpy())
    r16, k16, v16 = (t.to(torch.bfloat16) for t in a[:3])
    y16 = ref.rwkv6_scan_chunk_parallel(r16, k16, v16, a[3], a[4],
                                        chunk=chunk)
    assert y16.dtype == torch.bfloat16 and y16.shape == v16.shape
    with pytest.raises(ValueError, match="multiple"):
        ref.rwkv6_scan_chunk_parallel(*a, chunk=24)
