"""The chunk-parallel form of the Mamba2 scan that K6's bf16 kernel
computes (csrc/mamba2_scan.cu), in plain PyTorch (kernels/ref.py
mamba2_scan_chunk_parallel: every chunk's state contribution at once, the
serial state pass over chunks, then every chunk's intra-chunk products
and carry-in at once), against the JAX package on the CPU: its Pallas
mamba2_scan (interpret mode, as tests/test_kernels_scans.py runs it) and
its naive step-by-step repro.kernels.ref.mamba2_scan, on the same numpy
inputs; and against the port's own chunked and naive scans.  Cases: a
sequence shorter than one chunk, one that is no chunk multiple, one that
is a multiple, head sizes P of 40 and 24 (no multiple of a 16-row tile),
state sizes N of 16, 64 and 128, dt * A near 0 and large (~10 a step,
where exp(-csum) would overflow: the form exponentiates differences
only).

Bar: float32 within 1e-5 of the largest |output| - the forms sum in other
orders, and the chunked forms differ from the step-by-step ones by the
rounding of their cumulative sums.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.mamba2_scan import mamba2_scan as j_mamba2_pallas
from repro_torch.kernels import ref

REL = 1e-5
# (B, S, H, P, N, dt scale) per case: dt = softplus(N(0, 1)) * scale
CASES = {"short": (2, 50, 3, 8, 16, 0.3),
         "ragged_p40_n64": (1, 300, 2, 40, 64, 0.3),
         "p24_n128": (1, 140, 2, 24, 128, 0.3),
         "chunk_multiple": (1, 256, 2, 16, 16, 0.3),
         "dt_near_0": (2, 200, 2, 8, 16, 1e-6),
         "large_dt_a": (2, 200, 2, 8, 16, 10.0)}


def _inputs(B, S, H, P, N, dt_scale, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((B, S, H)))) * dt_scale
          ).astype(np.float32)
    A = (np.abs(rng.standard_normal(H)) + 0.1).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want, np.float32)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=REL * np.abs(want).max())


@pytest.mark.parametrize("case", list(CASES))
def test_chunk_parallel_form_matches_jax(case):
    a = _inputs(*CASES[case])
    got = ref.mamba2_scan_chunk_parallel(*(torch.from_numpy(t) for t in a))
    assert got.shape == a[0].shape and got.dtype == torch.float32
    ja = [jnp.asarray(t) for t in a]
    _close(got.numpy(), jref.mamba2_scan(*ja))
    _close(got.numpy(), j_mamba2_pallas(*ja))


@pytest.mark.parametrize("case", list(CASES))
def test_chunk_parallel_form_matches_the_port_scans(case):
    a = [torch.from_numpy(t) for t in _inputs(*CASES[case], seed=1)]
    got = ref.mamba2_scan_chunk_parallel(*a)
    for want in (ref.mamba2_scan_chunked(*a), ref.mamba2_scan(*a)):
        _close(got.numpy(), want.numpy())


@pytest.mark.parametrize("chunk", [16, 64, 128])
def test_the_chunk_size_is_the_kernels_to_choose(chunk):
    """The function does not depend on the chunk: any chunk size gives the
    naive scan's result (and bf16 inputs come back in bf16)."""
    a = [torch.from_numpy(t) for t in _inputs(*CASES["ragged_p40_n64"],
                                              seed=2)]
    _close(ref.mamba2_scan_chunk_parallel(*a, chunk=chunk).numpy(),
           ref.mamba2_scan(*a).numpy())
    x16 = a[0].to(torch.bfloat16)
    y16 = ref.mamba2_scan_chunk_parallel(x16, a[1], a[2],
                                         a[3].to(torch.bfloat16),
                                         a[4].to(torch.bfloat16), chunk=chunk)
    assert y16.dtype == torch.bfloat16 and y16.shape == x16.shape
