"""The port's plain Mamba2 and RWKV6 scans (repro_torch.kernels.ref) and
their dispatch (repro_torch.kernels.ops) against the JAX package on the
CPU.

The same numpy inputs go through the JAX package's naive, chunked,
chunked-state and step scans (repro.kernels.ref) and the port's, at
sequence lengths below one chunk, not a multiple of the chunk (Mamba2's
128, RWKV6's 32) and a multiple of both; and through the JAX package's
Pallas kernels K6 / K7, run in interpret mode as tests/
test_kernels_scans.py runs them, against the port's chunked scans (the
plain versions of the port's CUDA K6 / K7).  Edge inputs: a large dt * A
(Mamba2), and RWKV6's decay at the model's clamp over whole chunks with
u = 0.  The JAX package's chunked Mamba2 multiplies exp(csum_t - csum_s)
by the causal mask after the exp, so once the pairs above the diagonal
overflow (a chunk's mean dt * A above ~0.7: 88 / 127) its output is
0 * inf = NaN; the port masks before the exp and stays finite.  Inputs
compared with that form keep dt * A near 0.3 (dt_scale); the large-dt
case is compared with the JAX package's step-by-step scan.

Bars, float32: 1e-5 of the largest |output| (or |state|) - the two
frameworks sum the einsums in other orders, and the chunked forms differ
from the step-by-step ones by the rounding of their cumulative sums.
Gradients of the chunked scans (autograd here, jax.grad there): 1e-4 of
each input's largest |gradient| (the backward adds one more reordered
reduction per einsum).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.mamba2_scan import mamba2_scan as j_mamba2_pallas
from repro.kernels.rwkv6_scan import rwkv6_scan as j_rwkv6_pallas
from repro_torch.kernels import mamba2_scan as k6
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import rwkv6_scan as k7

REL = 1e-5
GRAD_REL = 1e-4
CLAMP_W = float(np.exp(-np.exp(0.75)))


def mamba_inputs(S, B=2, H=3, P=8, N=16, seed=0, dt_scale=0.3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((B, S, H)))) * dt_scale
          ).astype(np.float32)
    A = (np.abs(rng.standard_normal(H)) + 0.1).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


def rwkv_inputs(S, B=2, H=3, K=16, seed=0, clamp=False, u_zero=False):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, K)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(np.clip(rng.standard_normal((B, S, H, K)), -8,
                               0.75))).astype(np.float32)
    if clamp:
        w[:] = CLAMP_W
    u = (rng.standard_normal((H, K)) * 0.1).astype(np.float32)
    if u_zero:
        u[:] = 0.0
    return r, k, v, w, u


def _t(arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want, rel=REL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


SCANS = {
    "mamba2": (mamba_inputs, {"naive": "mamba2_scan",
                              "chunked": "mamba2_scan_chunked",
                              "chunked_state": "mamba2_scan_chunked_state"}),
    "rwkv6": (rwkv_inputs, {"naive": "rwkv6_scan",
                            "chunked": "rwkv6_scan_chunked",
                            "chunked_state": "rwkv6_scan_chunked_state"}),
}


@pytest.mark.parametrize("S", [20, 100, 256])
@pytest.mark.parametrize("form", ["naive", "chunked", "chunked_state"])
@pytest.mark.parametrize("scan", list(SCANS))
def test_plain_scans_match_jax(scan, form, S):
    make, names = SCANS[scan]
    a = make(S)
    got = getattr(ref, names[form])(*_t(a))
    want = getattr(jref, names[form])(*_j(a))
    if form == "chunked_state":
        _close(got[1], want[1])
        got, want = got[0], want[0]
    assert got.shape == tuple(want.shape) and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("scan", list(SCANS))
def test_steps_match_jax(scan):
    """Eight single decode steps from a random state."""
    rng = np.random.default_rng(7)
    if scan == "mamba2":
        x, dt, A, Bm, Cm = mamba_inputs(8)
        st = rng.standard_normal((2, 3, 8, 16)).astype(np.float32)
        step, jstep = ref.mamba2_step, jref.mamba2_step
        args = lambda t, f: [f(x[:, t]), f(dt[:, t]), f(A), f(Bm[:, t]),
                             f(Cm[:, t])]
    else:
        r, k, v, w, u = rwkv_inputs(8)
        st = rng.standard_normal((2, 3, 16, 16)).astype(np.float32)
        step, jstep = ref.rwkv6_step, jref.rwkv6_step
        args = lambda t, f: [f(r[:, t]), f(k[:, t]), f(v[:, t]),
                             f(w[:, t]), f(u)]
    ts, js = torch.from_numpy(st), jnp.asarray(st)
    for t in range(8):
        ts, ty = step(ts, *args(t, lambda a: torch.from_numpy(a.copy())))
        js, jy = jstep(js, *args(t, jnp.asarray))
        _close(ty, jy)
        _close(ts, js)


@pytest.mark.parametrize("S", [20, 100])
@pytest.mark.parametrize("scan", list(SCANS))
def test_chunked_scans_match_the_jax_pallas_kernels(scan, S):
    """The port's chunked scans (the plain versions of its K6 / K7)
    against the JAX package's Pallas K6 / K7 in interpret mode."""
    make, names = SCANS[scan]
    a = make(S, seed=1)
    kernel = j_mamba2_pallas if scan == "mamba2" else j_rwkv6_pallas
    _close(getattr(ref, names["chunked"])(*_t(a)), kernel(*_j(a)))


def test_mamba2_chunked_stays_finite_at_large_dt_times_a():
    """dt * A up to ~20 a step: exp(csum_t - csum_s) above the diagonal
    overflows float32 within a 128-step chunk; the port masks those pairs
    before the exp and equals the step-by-step scan, output and final
    state."""
    a = mamba_inputs(200, dt_scale=5.0)
    y, h = ref.mamba2_scan_chunked_state(*_t(a))
    _close(y, jref.mamba2_scan(*_j(a)))
    x, dt, A, Bm, Cm = _j(a)
    hj = jnp.zeros(h.shape, jnp.float32)
    for t in range(200):
        hj, _ = jref.mamba2_step(hj, x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t])
    _close(h, hj)


@pytest.mark.parametrize("S", [64, 100])
def test_rwkv6_chunked_at_the_decay_clamp_with_no_bonus(S):
    """w = exp(-exp(0.75)) over whole chunks (e^{-cw} reaches ~2.6e29 at
    the end of a 32-step chunk) and u = 0: the chunked scan equals the
    JAX package's step-by-step scan."""
    a = rwkv_inputs(S, clamp=True, u_zero=True)
    _close(ref.rwkv6_scan_chunked(*_t(a)), jref.rwkv6_scan(*_j(a)))


# ===========================================================================
# dispatch
# ===========================================================================

@pytest.mark.parametrize("scan", list(SCANS))
def test_dispatch_on_the_cpu(scan):
    """impl=None on CPU tensors runs the chunked plain version (no kernel
    launch counted), "ref" the same, "naive" the step-by-step scan; any
    other impl raises."""
    make, names = SCANS[scan]
    a = _t(make(40, seed=2))
    fn = getattr(ops, f"{scan}_scan")
    mod = k6 if scan == "mamba2" else k7
    n0 = mod.launches
    chunked = getattr(ref, names["chunked"])(*a)
    assert torch.equal(fn(*a), chunked)
    assert torch.equal(fn(*a, impl="ref"), chunked)
    assert torch.equal(fn(*a, impl="naive"), getattr(ref, names["naive"])(*a))
    assert mod.launches == n0
    with pytest.raises(ValueError, match="impl"):
        fn(*a, impl="pallas")


@pytest.mark.parametrize("scan", list(SCANS))
def test_cpu_scans_carry_gradients(scan):
    """The CPU path stays differentiable by autograd, and its gradients
    equal jax.grad of the JAX package's chunked scan (the cotangent is a
    fixed random tensor)."""
    make, names = SCANS[scan]
    a = make(70, seed=4)
    ct = np.random.default_rng(9).standard_normal(
        getattr(jref, names["chunked"])(*_j(a)).shape).astype(np.float32)
    ta = [t.requires_grad_(True) for t in _t(a)]
    y = getattr(ops, f"{scan}_scan")(*ta)
    (y * torch.from_numpy(ct)).sum().backward()
    want = jax.grad(lambda *xs: jnp.sum(getattr(jref, names["chunked"])(*xs)
                                        * ct),
                    argnums=tuple(range(len(a))))(*_j(a))
    for t, w in zip(ta, want):
        assert t.grad is not None
        _close(t.grad, w, GRAD_REL)
