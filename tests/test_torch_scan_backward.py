"""The scans' backward on the CPU against the JAX package: the plain
backwards ref.mamba2_scan_bwd / ref.rwkv6_scan_bwd (the plain versions of
the backward kernels csrc/mamba2_scan_bwd.cu and csrc/rwkv6_scan_bwd.cu)
against jax.grad of the JAX naive scans (src/repro/kernels/ref.py
mamba2_scan, rwkv6_scan) and of the JAX chunked scans where those stay
finite, all five input gradients of each, on numpy-seeded float32 inputs
and a numpy-seeded cotangent; the autograd Function (ops._Scan) on CPU
tensors against the plain backward; its meta path, which records
launch/cost.py k6_bwd_work / k7_bwd_work; and every
parameter gradient of the zamba2 and rwkv6 smoke models' loss against
jax.grad of the JAX Model.loss.

Cases: a sequence that is no chunk multiple (the Mamba2 chunk is 128
steps, the RWKV6 chunk 32), one shorter than a chunk, and, against the
naive form only, a large dt * A (about 6 a step), where the JAX chunked
Mamba2 form multiplies an overflowed exp(csum_t - csum_s) by its mask and
is NaN (ROADMAP §3), while the port's masks before the exp.

Bars: within 1e-5 of each gradient's largest element (the plain
backwards run in float64, kernels/ref.py _grad_through; the JAX scans'
gradients in float32): seen 3.4e-7 against the naive scans - but dA
against the JAX chunked Mamba2 form, 5e-5: its float32 gradient of the
decay sums differences of cumulative log decays that grow over the
128-step chunk, and lands 1.1e-5 of dA's largest element from the naive
form's and from the float64 one at dt * A ~0.3 (seen 1.14e-5; the other
gradients within 2.7e-6).  The smoke models' parameter gradients, of each
leaf's largest |entry|: against the JAX Model.loss with its step-by-step
scans 1e-5 for rwkv6 (seen 7.5e-6) and 1e-4 for zamba2, whose smoke
model amplifies float32 rounding (seen 3.2e-5; tests/
test_torch_recurrent.py); against the JAX Model.loss as it runs, with its
chunked scans, 3e-4 for both: there the JAX package's own float32
chunked gradients lie up to 1.5e-4 (rwkv6: tok/embed) and 5.2e-5
(zamba2) from its step-by-step ones (seen: the port 1.5e-4 and 7.2e-5
from them).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels import ref as jref
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import mamba2_scan, ops, ref, rwkv6_scan
from repro_torch.launch import cost
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.train.train_step import trainable
from repro_torch.tree import leaves_with_paths

F32 = 1e-5
# dA against the JAX chunked form's float32 gradient (the module docstring)
CHUNKED_DA = 5e-5
# the smoke models' parameter gradients, of each leaf's largest |entry|
# (the module docstring)
CHUNKED_LEAF = 3e-4
NAIVE_LEAF = {"zamba2-2.7b": 1e-4, "rwkv6-1.6b": F32}
M_NAMES = ("dx", "ddt", "dA", "dBm", "dCm")
R_NAMES = ("dr", "dk", "dv", "dw", "du")
# (B, S, H, P, N, dt scale, forms): dt = softplus(N(0, 1)) * scale, A in
# [0.5, 1.5]: dt * A near 0.3 at scale 0.4, about 6 at scale 8 (the short
# and large cases share a shape, so the JAX gradient compiles once for
# both)
MAMBA = {"ragged": (2, 150, 3, 8, 16, 0.4, ("naive", "chunked")),
         "short": (2, 37, 2, 8, 16, 0.4, ("naive", "chunked")),
         "large_dt_a": (2, 37, 2, 8, 16, 8.0, ("naive",))}
# (B, S, H, K, V, forms): w = exp(-exp(clip(N(0, 1), -8, 0.75))), the
# model's decay
RWKV = {"ragged": (2, 75, 3, 8, 8, ("naive", "chunked")),
        "short": (2, 19, 2, 8, 16, ("naive", "chunked"))}


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def mamba_inputs(B, S, H, P, N, scale, seed=0):
    rng = np.random.default_rng(seed)
    dt = (np.log1p(np.exp(rng.standard_normal((B, S, H)))) * scale
          ).astype(np.float32)
    A = (rng.random(H) + 0.5).astype(np.float32)
    return (_f32(rng, B, S, H, P), dt, A, _f32(rng, B, S, N),
            _f32(rng, B, S, N)), _f32(rng, B, S, H, P)


def rwkv_inputs(B, S, H, K, V, seed=0):
    rng = np.random.default_rng(seed)
    w = np.exp(-np.exp(np.clip(rng.standard_normal((B, S, H, K)), -8,
                               0.75))).astype(np.float32)
    return (_f32(rng, B, S, H, K), _f32(rng, B, S, H, K),
            _f32(rng, B, S, H, V), w, (0.3 * _f32(rng, H, K))), \
        _f32(rng, B, S, H, V)


@functools.lru_cache(maxsize=None)
def _jax_vjp(fn):
    return jax.jit(lambda dy, *a: jax.vjp(fn, *a)[1](dy))


def jax_grads(fn, inputs, dy):
    """jax.grad (the vjp against dy) of fn at inputs, jitted: one compile
    a shape."""
    return [np.asarray(g) for g in _jax_vjp(fn)(
        jnp.asarray(dy), *map(jnp.asarray, inputs))]


def close(got, want, names, bars=None):
    for name, g, w in zip(names, got, want):
        g = g.detach().float().numpy() if torch.is_tensor(g) else g
        assert g.shape == w.shape, name
        assert np.isfinite(w).all() and np.isfinite(g).all(), name
        bar = (bars or {}).get(name, F32) * np.abs(w).max()
        err = np.abs(g - w).max()
        assert err <= bar, f"{name}: max abs err {err:.3e}, bar {bar:.3e}"


@pytest.mark.parametrize("case", list(MAMBA))
def test_mamba2_plain_backward_matches_jax_grad(case):
    *shape, forms = MAMBA[case]
    inputs, dy = mamba_inputs(*shape)
    got = ref.mamba2_scan_bwd(*map(torch.from_numpy, inputs),
                              torch.from_numpy(dy))
    assert [g.dtype for g in got] == [torch.float32] * 5
    for form in forms:
        fn = jref.mamba2_scan if form == "naive" else jref.mamba2_scan_chunked
        close(got, jax_grads(fn, inputs, dy), M_NAMES,
              {"dA": CHUNKED_DA} if form == "chunked" else None)
    if case == "large_dt_a":
        # the JAX chunked form is not finite here: why it is held against
        # the naive one only
        assert not np.isfinite(np.asarray(jref.mamba2_scan_chunked(
            *map(jnp.asarray, inputs)))).all()


@pytest.mark.parametrize("case", list(RWKV))
def test_rwkv6_plain_backward_matches_jax_grad(case):
    *shape, forms = RWKV[case]
    inputs, dy = rwkv_inputs(*shape)
    got = ref.rwkv6_scan_bwd(*map(torch.from_numpy, inputs),
                             torch.from_numpy(dy))
    for form in forms:
        fn = jref.rwkv6_scan if form == "naive" else jref.rwkv6_scan_chunked
        close(got, jax_grads(fn, inputs, dy), R_NAMES)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["mamba2", "rwkv6"])
def test_autograd_functions_equal_the_plain_backward(kind, dtype):
    """Through ops.*_scan with a gradient needed, on CPU tensors: the
    autograd Function's (ops._Scan) gradients are the plain backward's,
    bit for bit, in each input's dtype (dt, A, w, u float32), and no
    kernel counts a launch; impl="ref" takes the same Function with the
    plain versions."""
    if kind == "mamba2":
        inputs, dy = mamba_inputs(2, 40, 2, 8, 16, 0.4)
        acts, mod, plain = (0, 3, 4), mamba2_scan, ref.mamba2_scan_bwd
    else:
        inputs, dy = rwkv_inputs(2, 40, 2, 8, 8)
        acts, mod, plain = (0, 1, 2), rwkv6_scan, ref.rwkv6_scan_bwd
    ts = [torch.from_numpy(a).to(dtype) if i in acts
          else torch.from_numpy(a) for i, a in enumerate(inputs)]
    dyt = torch.from_numpy(dy).to(dtype)
    want = plain(*ts, dyt)
    counts = (mod.launches, mod.bwd_launches)
    for impl in (None, "ref"):
        leaves = [t.clone().requires_grad_(True) for t in ts]
        y = getattr(ops, f"{kind}_scan")(*leaves, impl=impl)
        assert type(y.grad_fn).__name__.startswith("_Scan")
        got = torch.autograd.grad(y, leaves, dyt)
        for g, w, t in zip(got, want, ts):
            assert g.dtype == t.dtype
            assert torch.equal(g, w)
    assert (mod.launches, mod.bwd_launches) == counts


@pytest.mark.parametrize("kind", ["mamba2", "rwkv6"])
def test_meta_tensors_record_the_backward_kernels_work(kind):
    """On the meta device ops._Scan launches nothing: the forward wrapper
    records K6 / K7 and the backward wrapper K6_bwd / K7_bwd with
    launch/cost.py's formulas, and the gradients come back empty in each
    input's dtype."""
    B, S, H = 2, 300, 4
    if kind == "mamba2":
        P, N = 64, 64
        shapes = [(B, S, H, P), (B, S, H), (H,), (B, S, N), (B, S, N)]
        acts = (0, 3, 4)
        want = {"K6": cost.k6_work((B, S, H, P), N, 2, 128),
                "K6_bwd": cost.k6_bwd_work((B, S, H, P), N, 2)}
    else:
        K = 64
        shapes = [(B, S, H, K)] * 4 + [(H, K)]
        acts = (0, 1, 2)
        want = {"K7": cost.k7_work((B, S, H, K), K, 2),
                "K7_bwd": cost.k7_bwd_work((B, S, H, K), K, 2)}
    leaves = [torch.empty(s, device="meta",
                          dtype=torch.bfloat16 if i in acts
                          else torch.float32).requires_grad_(True)
              for i, s in enumerate(shapes)]
    with cost.StepCost() as c:
        y = getattr(ops, f"{kind}_scan")(*leaves)
        got = torch.autograd.grad(y, leaves, torch.empty_like(y))
    assert [g.dtype for g in got] == [t.dtype for t in leaves]
    assert [g.device.type for g in got] == ["meta"] * 5
    kernels = c.summary()["kernels"]
    assert kernels == {k: {"calls": 1, "bytes": b, "flops": f}
                       for k, (b, f) in want.items()}


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "rwkv6-1.6b"])
def test_smoke_model_gradients_match_jax_grad(arch, monkeypatch):
    """Every parameter gradient of the smoke model's loss (float32, 2 x 40
    numpy-seeded tokens: no chunk multiple of either scan), through
    ops._Scan, against jax.grad of the JAX Model.loss
    from the same weights: the JAX package as it runs off the TPU (its
    chunked scans), within CHUNKED_LEAF; and with its step-by-step scans
    (ref.*_scan_chunked pointed at ref.*_scan for the call), within
    NAIVE_LEAF."""
    jm = jax_build_model(jax_smoke_config(arch).replace(dtype="float32"))
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = get_smoke_config(arch).replace(dtype="float32")
    tm = build_model(cfg, device="cpu")
    tp = trainable(params_from_numpy(jax.device_get(jp), cfg, "cpu"))
    toks = np.random.default_rng(4).integers(0, 256, (2, 40)).astype(
        np.int32)
    tl, _ = tm.loss(tp, {"tokens": torch.from_numpy(toks)})
    tl.backward()
    got = dict(leaves_with_paths(tp))

    def jax_loss_grads():
        (jl, _), jg = jax.jit(jax.value_and_grad(
            lambda p: jm.loss(p, {"tokens": jnp.asarray(toks)}),
            has_aux=True))(jp)
        return float(jl), dict(leaves_with_paths(jax.device_get(jg)))
    chunked = jax_loss_grads()
    monkeypatch.setattr(jref, "mamba2_scan_chunked",
                        lambda *a, **_: jref.mamba2_scan(*a))
    monkeypatch.setattr(jref, "rwkv6_scan_chunked",
                        lambda *a, **_: jref.rwkv6_scan(*a))
    naive = jax_loss_grads()
    for (jl, want), bar in ((chunked, CHUNKED_LEAF),
                            (naive, NAIVE_LEAF[arch])):
        np.testing.assert_allclose(float(tl.detach()), jl, rtol=F32)
        assert sorted(got) == sorted(want)
        for path, p in got.items():
            assert p.grad is not None and p.grad.dtype == p.dtype, path
            g, w = p.grad.numpy(), np.asarray(want[path], np.float32)
            err = np.abs(g - w).max()
            assert err <= bar * np.abs(w).max(), (path, err, bar)
