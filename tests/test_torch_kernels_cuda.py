"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card: the edge cases of test_torch_kernels.py and test_torch_flash.py
(GQA groups 1 / 2 / 4, shuffled block tables, ragged rows, a chunk starting
mid-page, two chunks of one sequence in one batch, dead rows, q_lens pad
lanes, sliding window, softcap; causal and full attention over a length
that is no tile multiple, fewer queries than keys; dense decode lengths 0,
1 and the whole strip, one length for every lane; the FA-2 backward K5
over causal, full, window and softcap attention at S = 200 and 256, and
through autograd) at the kernels' head dims 64 and 128 (K3 and K4 also
80, zamba2's shared attention block); K4 and K5 at the edges of their
tensor-core tiles (lengths 1, 15, 17 and 200, fewer queries than keys,
GQA groups of 1 to 8, a window shorter than one tile, softcap, no key at
all) and K5's bits from call to call; the Mamba2 scan K6 and the RWKV6
scan K7 (a sequence shorter than one chunk, one that is no chunk multiple,
batch 1, an odd head count, dt near 0 and a large dt * A, the decay w = 1
and w at the model's clamp over whole chunks, u = 0, every state and key
size the kernels take, ragged state rows and columns, the full-width
shapes of zamba2 and rwkv6, and the refusal of a call autograd would
have to differentiate), in float32 and bfloat16.

Needs an NVIDIA GPU and nvcc: every test skips with a reason elsewhere.
Run on the card with
`python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py`.

Bars: float32 within 1e-5 absolute (fp32 math in both, other summation
order).  bfloat16: both compute in float32 from the same bfloat16 values
and round the output once, so within 2**-7 relative plus 1e-6 absolute.
K4 in bfloat16 rounds each softmax weight to bfloat16 before the PV
product, as its plain version does; an fp32 difference of an ulp in a
score can flip that rounding for one weight and move the output by one
bfloat16 step of that weight's term, which exceeds 2**-7 of the output
where the terms cancel (seen on the H100: 4 of 37888 elements, 2.4e-4 at
an output of 0.0055).  Its bar is therefore one rounding step of the
terms' magnitude: 2**-7 x (|o| + the attention of |v|) plus 1e-6.  The
log-sum-exp of K4 is float32 in both dtypes: 1e-5 absolute.  K5 rounds
p and ds to bfloat16 before their products, as its plain version does,
so its bfloat16 bar is the same kind: 2**-7 x (|g| + the magnitude of the
summed terms, ref.flash_attention_bwd(terms=True)) + 1e-6; in float32 its
gradients agree within 1e-5 of the largest |gradient|.  Dead rows, pad
lanes and empty decode lanes are exactly 0.  K6 and K7 run the recurrence
step by step, their plain versions the chunked matrix form (cumulative
log decays, exp of their differences): in float32 they agree within 1e-5
of the largest term - `terms` is the plain scan of the inputs' absolute
values, the magnitude of the summed terms - and in bfloat16 within one
rounding step of the output, 2**-7 x |y|, plus that float32 bar.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention, flash_backward, flash_decode
from repro_torch.kernels import mamba2_scan, ops, rwkv6_scan
from repro_torch.kernels import paged_prefill

pytestmark = pytest.mark.cuda

S, HKV, PS, N_PAGES, N_MAX = 8, 2, 4, 40, 8
VARIANTS = {"plain": (0, 0.0), "window": (5, 0.0), "softcap": (0, 2.0),
            "qlens": (0, 0.0)}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the hand-written kernels run only on "
                    "the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    if dtype == torch.bfloat16:
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _close_terms(got, want, terms):
    """bfloat16 K4 output: within 2**-7 x (|want| + terms) + 1e-6, where
    terms is the plain attention of |v| (the magnitude of the summed
    terms p_i |v_i| / l)."""
    got, want = got.float().cpu(), want.float().cpu()
    bar = 2.0 ** -7 * (want.abs() + terms.float().cpu()) + 1e-6
    bad = (got - want).abs() > bar
    assert not bool(bad.any()), (
        f"{int(bad.sum())} elements past the bar, max abs err "
        f"{float((got - want).abs().max()):.3e}")


def _prefill_case(G, D, dev, dtype, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(dev, dtype)
    k, v = f(N_PAGES, PS, HKV, D), f(N_PAGES, PS, HKV, D)
    q = f(6, S, HKV * G, D)
    perm = rng.permutation(np.arange(1, N_PAGES)).astype(np.int32)
    tables = np.zeros((6, N_MAX), np.int32)
    tables[0, :6] = perm[:6]
    tables[1, :8] = perm[6:14]
    tables[2, :4] = perm[14:18]
    tables[4, :5] = perm[18:23]
    tables[5] = tables[4]
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)
    return (q, k, v, i32(tables), i32([4, 17, 0, 0, 0, 8]),
            i32([12, 20, 8, 0, 8, 16]), i32([8, 2, 8, 0, 8, 5]))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("D", [64, 128])
def test_prefill_kernel_matches_plain(dev, D, G, variant, dtype):
    dt = DTYPES[dtype]
    q, k, v, tb, off, tl, ql = _prefill_case(G, D, dev, dt)
    ql = ql if variant == "qlens" else None
    window, softcap = VARIANTS[variant]
    n0 = paged_prefill.launches
    got = ops.batched_paged_prefill_attention(
        q, k, v, tb, off, tl, ql, window=window, logit_softcap=softcap)
    want = ops.batched_paged_prefill_attention(
        q, k, v, tb, off, tl, ql, window=window, logit_softcap=softcap,
        impl="ref")
    torch.cuda.synchronize()
    assert paged_prefill.launches == n0 + 1
    _close(got, want, dt)
    lanes = (ql if ql is not None else torch.clamp(tl - off, 0, S)).cpu()
    for r in range(6):
        assert not got[r, int(lanes[r]):].any(), f"row {r} pad lanes"
    assert not got[3].any(), "dead row not zero"


def _decode_case(G, D, dev, dtype, seed=1):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(dev, dtype)
    k, v = f(N_PAGES, PS, HKV, D), f(N_PAGES, PS, HKV, D)
    q = f(5, 1, HKV * G, D)
    perm = rng.permutation(np.arange(1, N_PAGES)).astype(np.int32)
    bt = np.zeros((5, N_MAX), np.int32)
    bt[0, :1], bt[1, :4], bt[2, :8], bt[3, :1] = (perm[:1], perm[1:5],
                                                  perm[5:13], perm[13:14])
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)
    return q, k, v, i32(bt), i32([3, 14, 32, 4, 0])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("variant", ["plain", "window", "softcap"])
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("D", [64, 128])
def test_decode_kernel_matches_plain(dev, D, G, variant, dtype):
    dt = DTYPES[dtype]
    q, k, v, bt, lens = _decode_case(G, D, dev, dt)
    window, softcap = VARIANTS[variant]
    n0 = flash_decode.launches
    got = ops.paged_flash_decode(q, k, v, bt, lens, window=window,
                                 logit_softcap=softcap)
    want = ops.paged_flash_decode(q, k, v, bt, lens, window=window,
                                  logit_softcap=softcap, impl="ref")
    torch.cuda.synchronize()
    assert flash_decode.launches == n0 + 1
    _close(got, want, dt)
    assert not got[4].any(), "idle lane (length 0) not zero"


@pytest.mark.parametrize("D", [64, 128])
def test_single_row_wrapper_runs_the_kernel(dev, D):
    q, k, v, tb, off, tl, _ = _prefill_case(4, D, dev, torch.float32)
    n0 = paged_prefill.launches
    got = ops.paged_prefill_attention(q[:1], k, v, tb[0], int(off[0]))
    want = ops.paged_prefill_attention(q[:1], k, v, tb[0], int(off[0]),
                                       impl="ref")
    torch.cuda.synchronize()
    assert paged_prefill.launches == n0 + 1
    _close(got, want, torch.float32)


def test_kernels_refuse_what_they_do_not_take(dev):
    q, k, v, tb, off, tl, ql = _prefill_case(2, 64, dev, torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        ops.batched_paged_prefill_attention(q[..., :32].contiguous(),
                                            k[..., :32].contiguous(),
                                            v[..., :32].contiguous(), tb,
                                            off, tl)
    with pytest.raises(ValueError, match="int32"):
        ops.batched_paged_prefill_attention(q, k, v, tb.long(), off, tl)
    with pytest.raises(ValueError):
        ops.batched_paged_prefill_attention(q, k.to(torch.bfloat16), v, tb,
                                            off, tl)
    qd, kd, vd, bt, lens = _decode_case(2, 64, dev, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        ops.paged_flash_decode(qd, kd.transpose(1, 2).contiguous()
                               .transpose(1, 2), vd, bt, lens)


# ---------------------------------------------------------------------------
# K4 flash_attention_fwd and K3 dense flash_decode
# ---------------------------------------------------------------------------

# (causal, window, softcap, Sq, Skv) per variant
FA_VARIANTS = {"causal": (True, 0, 0.0, 37, 37),
               "full": (False, 0, 0.0, 37, 37),
               "window": (True, 8, 0.0, 37, 37),
               "softcap": (True, 0, 30.0, 37, 37),
               "short_q": (True, 0, 0.0, 20, 37)}


def _randn(rng, dev, dtype, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(dev, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("variant", list(FA_VARIANTS))
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("D", [64, 80, 128])
def test_flash_attention_kernel_matches_plain(dev, D, G, variant, dtype):
    dt = DTYPES[dtype]
    causal, window, softcap, sq, skv = FA_VARIANTS[variant]
    rng = np.random.default_rng(2)
    q = _randn(rng, dev, dt, 2, sq, HKV * G, D)
    k, v = _randn(rng, dev, dt, 2, skv, HKV, D), _randn(rng, dev, dt, 2, skv,
                                                        HKV, D)
    kw = dict(causal=causal, window=window, logit_softcap=softcap)
    n0 = flash_attention.launches
    o, lse = flash_attention.flash_attention_fwd(q, k, v, **kw)
    o_ref, lse_ref = flash_attention.reference(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1
    assert o.dtype == dt and lse.dtype == torch.float32
    assert lse.shape == (2, sq, HKV * G)
    if dt == torch.bfloat16:
        _close_terms(o, o_ref, flash_attention.reference(q, k, v.abs(),
                                                         **kw)[0])
    else:
        _close(o, o_ref, dt)
    _close(lse, lse_ref, torch.float32)
    got = ops.flash_attention(q, k, v, **kw)
    assert flash_attention.launches == n0 + 2 and torch.equal(got, o)


DECODE_LENS = [0, 1, 40, 23]
# (window, softcap, one length for every lane) per variant
FD_VARIANTS = {"plain": (0, 0.0, None), "window": (8, 0.0, None),
               "softcap": (0, 30.0, None), "scalar": (0, 0.0, 17)}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("variant", list(FD_VARIANTS))
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("D", [64, 80, 128])
def test_dense_decode_kernel_matches_plain(dev, D, G, variant, dtype):
    dt = DTYPES[dtype]
    window, softcap, scalar = FD_VARIANTS[variant]
    rng = np.random.default_rng(3)
    q = _randn(rng, dev, dt, 4, 1, HKV * G, D)
    k, v = _randn(rng, dev, dt, 4, 40, HKV, D), _randn(rng, dev, dt, 4, 40,
                                                       HKV, D)
    lens = scalar if scalar is not None else torch.tensor(
        DECODE_LENS, dtype=torch.int32, device=dev)
    kw = dict(window=window, logit_softcap=softcap)
    n0, n2 = flash_decode.dense_launches, flash_decode.launches
    got = ops.flash_decode(q, k, v, lens, **kw)
    want = ops.flash_decode(q, k, v, lens, impl="ref", **kw)
    torch.cuda.synchronize()
    assert flash_decode.dense_launches == n0 + 1
    assert flash_decode.launches == n2, "K3 counted as K2"
    _close(got, want, dt)
    if scalar is None:
        assert not got[0].any(), "empty lane (length 0) not zero"


def test_flash_kernels_refuse_what_they_do_not_take(dev):
    rng = np.random.default_rng(4)
    q = _randn(rng, dev, torch.float32, 2, 8, 4, 64)
    k = _randn(rng, dev, torch.float32, 2, 8, 2, 64)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention.flash_attention_fwd(
            q[..., :32].contiguous(), k[..., :32].contiguous(),
            k[..., :32].contiguous())
    with pytest.raises(ValueError, match="batch"):
        flash_attention.flash_attention_fwd(q, k[:1], k[:1])
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention.flash_attention_fwd(q, k.transpose(1, 2).contiguous()
                                            .transpose(1, 2), k)
    with pytest.raises(ValueError):
        flash_attention.flash_attention_fwd(q, k.to(torch.bfloat16), k)
    qd = q[:, :1].contiguous()
    lens = torch.tensor([3, 5], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="int32"):
        flash_decode.flash_decode(qd, k, k, lens.long())
    with pytest.raises(ValueError, match="one query token"):
        flash_decode.flash_decode(q, k, k, lens)
    with pytest.raises(ValueError, match="at most"):
        flash_decode.flash_decode(
            _randn(rng, dev, torch.float32, 2, 1, 34, 64),
            k[:, :, :1].contiguous(), k[:, :, :1].contiguous(), lens)


# ---------------------------------------------------------------------------
# K5 flash_attention_bwd
# ---------------------------------------------------------------------------

# (causal, window, softcap) per variant
BWD_VARIANTS = {"causal": (True, 0, 0.0), "full": (False, 0, 0.0),
                "window": (True, 48, 0.0), "softcap": (True, 0, 25.0)}


def bwd_close(got, want, terms, dtype, names=("dq", "dk", "dv")):
    """K5 against its plain version: float32 within 1e-5 of the largest
    |gradient|; bfloat16 within one rounding step of the summed terms'
    magnitude, 2**-7 x (|want| + terms) + 1e-6 (terms from
    ref.flash_attention_bwd(terms=True)): both round p and ds to bfloat16
    before their products, and an ulp of difference in a score can flip
    one of those roundings."""
    for name, g, w, t in zip(names, got, want, terms):
        g, w = g.float().cpu(), w.float().cpu()
        err = (g - w).abs()
        if dtype == torch.bfloat16:
            bar = 2.0 ** -7 * (w.abs() + t.float().cpu()) + 1e-6
        else:
            bar = torch.full_like(w, 1e-5 * float(w.abs().max()))
        bad = err > bar
        assert not bool(bad.any()), (
            f"{name}: {int(bad.sum())} elements past the bar, max abs err "
            f"{float(err.max()):.3e} (max |{name}| {float(w.abs().max()):.3e})")


@pytest.mark.parametrize("S", [200, 256])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("variant", list(BWD_VARIANTS))
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_backward_kernel_matches_plain(dev, D, G, variant, dtype, S):
    dt = DTYPES[dtype]
    causal, window, softcap = BWD_VARIANTS[variant]
    rng = np.random.default_rng(5)
    q = _randn(rng, dev, dt, 2, S, HKV * G, D)
    k, v = _randn(rng, dev, dt, 2, S, HKV, D), _randn(rng, dev, dt, 2, S,
                                                      HKV, D)
    do = _randn(rng, dev, dt, 2, S, HKV * G, D)
    kw = dict(causal=causal, window=window, logit_softcap=softcap)
    o, lse = flash_attention.flash_attention_fwd(q, k, v, **kw)
    n0 = flash_backward.launches
    got = flash_backward.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = flash_backward.reference(q, k, v, o, lse, do, **kw)
    terms = flash_backward.reference(q, k, v, o, lse, do, terms=True, **kw)
    torch.cuda.synchronize()
    assert flash_backward.launches == n0 + 1
    assert [g.dtype for g in got] == [dt] * 3
    bwd_close(got, want, terms, dt)
    # the same bits again: no atomics, one summation order
    again = flash_backward.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_autograd_runs_k4_then_k5(dev, dtype):
    """A gradient through ops.flash_attention on CUDA tensors launches K4
    once and K5 once, and equals the plain rule's gradient."""
    dt = DTYPES[dtype]
    rng = np.random.default_rng(6)
    q = _randn(rng, dev, dt, 2, 100, 8, 64).requires_grad_(True)
    k = _randn(rng, dev, dt, 2, 100, 2, 64).requires_grad_(True)
    v = _randn(rng, dev, dt, 2, 100, 2, 64).requires_grad_(True)
    do = _randn(rng, dev, dt, 2, 100, 8, 64)
    n4, n5 = flash_attention.launches, flash_backward.launches
    o = ops.flash_attention(q, k, v)
    got = torch.autograd.grad(o, (q, k, v), do)
    torch.cuda.synchronize()
    assert flash_attention.launches == n4 + 1
    assert flash_backward.launches == n5 + 1
    o_r, lse_r = flash_attention.flash_attention_fwd(q.detach(), k.detach(),
                                                     v.detach())
    args = (q.detach(), k.detach(), v.detach(), o_r, lse_r, do)
    bwd_close(got, flash_backward.reference(*args),
              flash_backward.reference(*args, terms=True), dt)


def test_flash_backward_refuses_what_it_does_not_take(dev):
    rng = np.random.default_rng(7)
    q = _randn(rng, dev, torch.float32, 2, 8, 4, 64)
    k = _randn(rng, dev, torch.float32, 2, 8, 2, 64)
    o, lse = flash_attention.flash_attention_fwd(q, k, k)
    with pytest.raises(ValueError, match="do must be"):
        flash_backward.flash_attention_bwd(q, k, k, o, lse,
                                           q.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        flash_backward.flash_attention_bwd(
            q, k, k, o, lse, q.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="lse"):
        flash_backward.flash_attention_bwd(q, k, k, o, lse[:, :4], q)
    with pytest.raises(ValueError, match="head dim"):
        t = q[..., :32].contiguous()
        flash_backward.flash_attention_bwd(t, k[..., :32].contiguous(),
                                           k[..., :32].contiguous(), t, lse,
                                           t)


# ---------------------------------------------------------------------------
# K4 and K5 at the edges of the tensor-core tiles (16-row mma fragments,
# 64-row blocks, 64-position KV tiles)
# ---------------------------------------------------------------------------

# (Sq, Skv): lengths that are no multiple of 16 or 64, one query, fewer
# queries than keys (the causal mask aligned at the top left), and Skv = 0,
# where every row is masked
EDGE_LENS = [(1, 1), (1, 200), (15, 17), (17, 200), (200, 200), (15, 0)]
# (causal, window, softcap): the window is shorter than one 16-row fragment
EDGE_VARIANTS = {"causal": (True, 0, 0.0), "full": (False, 0, 0.0),
                 "window": (True, 5, 0.0), "softcap": (True, 0, 30.0)}
# (D, G): every group size at head dim 64, then the other head dims
FWD_EDGE_DG = [(64, 1), (64, 2), (64, 4), (64, 8), (80, 2), (128, 2)]
BWD_EDGE_DG = [(64, 1), (64, 2), (64, 4), (64, 8), (128, 2)]


def _edge_case(dev, dt, D, G, sq, skv, seed):
    rng = np.random.default_rng(seed)
    q = _randn(rng, dev, dt, 2, sq, HKV * G, D)
    k = _randn(rng, dev, dt, 2, skv, HKV, D)
    v = _randn(rng, dev, dt, 2, skv, HKV, D)
    return rng, q, k, v


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("variant", list(EDGE_VARIANTS))
@pytest.mark.parametrize("lens", EDGE_LENS, ids=lambda x: f"{x[0]}x{x[1]}")
@pytest.mark.parametrize("dg", FWD_EDGE_DG, ids=lambda x: f"D{x[0]}G{x[1]}")
def test_flash_attention_kernel_at_tile_edges(dev, dg, lens, variant, dtype):
    """K4 against its plain version at the bars of
    test_flash_attention_kernel_matches_plain; rows with no key to attend
    (Skv = 0) give o = 0 exactly and lse = -1e30, as the plain version."""
    dt = DTYPES[dtype]
    (D, G), (sq, skv) = dg, lens
    causal, window, softcap = EDGE_VARIANTS[variant]
    _, q, k, v = _edge_case(dev, dt, D, G, sq, skv, seed=8)
    kw = dict(causal=causal, window=window, logit_softcap=softcap)
    n0 = flash_attention.launches
    o, lse = flash_attention.flash_attention_fwd(q, k, v, **kw)
    o_ref, lse_ref = flash_attention.reference(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1
    assert o.shape == q.shape and lse.shape == (2, sq, HKV * G)
    if dt == torch.bfloat16:
        _close_terms(o, o_ref, flash_attention.reference(q, k, v.abs(),
                                                         **kw)[0])
    else:
        _close(o, o_ref, dt)
    _close(lse, lse_ref, torch.float32)
    if skv == 0:
        assert not o.any(), "fully masked rows not exactly 0"


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("variant", list(EDGE_VARIANTS))
@pytest.mark.parametrize("lens", EDGE_LENS, ids=lambda x: f"{x[0]}x{x[1]}")
@pytest.mark.parametrize("dg", BWD_EDGE_DG, ids=lambda x: f"D{x[0]}G{x[1]}")
def test_flash_backward_kernel_at_tile_edges(dev, dg, lens, variant, dtype):
    """K5 against its plain version at the bars of bwd_close, o and lse from
    K4; with Skv = 0 dq is exactly 0 and dk, dv are empty; where every row
    attends one key, dq and dk are rounding noise (single_key_close)."""
    dt = DTYPES[dtype]
    (D, G), (sq, skv) = dg, lens
    causal, window, softcap = EDGE_VARIANTS[variant]
    rng, q, k, v = _edge_case(dev, dt, D, G, sq, skv, seed=9)
    do = _randn(rng, dev, dt, 2, sq, HKV * G, D)
    kw = dict(causal=causal, window=window, logit_softcap=softcap)
    o, lse = flash_attention.flash_attention_fwd(q, k, v, **kw)
    n0 = flash_backward.launches
    got = flash_backward.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = flash_backward.reference(q, k, v, o, lse, do, **kw)
    terms = flash_backward.reference(q, k, v, o, lse, do, terms=True, **kw)
    torch.cuda.synchronize()
    assert flash_backward.launches == n0 + 1
    assert [g.shape for g in got] == [q.shape, k.shape, v.shape]
    if skv == 0:
        assert not got[0].any(), "dq of fully masked rows not exactly 0"
        return
    if skv == 1 or (sq == 1 and causal):
        single_key_close(got, want, terms, q, k, o, do, dt)
        return
    bwd_close(got, want, terms, dt)


def single_key_close(got, want, terms, q, k, o, do, dtype):
    """K5 where every query row attends one key: o is that key's v, so ds =
    p (dp - delta) and with it dq and dk are 0 in exact arithmetic, and
    each version returns the float32 rounding of that cancellation.  dq and
    dk are held within 1e-5 of the cancelled terms' magnitude (scale x
    max sum_d |do o| x max |k| for dq, x max |q| x the rows per KV head
    for dk), plus one bfloat16 step of the value in bfloat16; dv as
    bwd_close holds it."""
    B, Sq, Hq, D = q.shape
    cancelled = float((do.float() * o.float()).abs().sum(-1).max()) / D ** 0.5
    rows = Sq * (Hq // k.shape[2])
    for name, g, w, other in (("dq", got[0], want[0], k),
                              ("dk", got[1], want[1], q)):
        g, w = g.float().cpu(), w.float().cpu()
        bar = 1e-5 * cancelled * float(other.float().abs().max()) \
            * (rows if name == "dk" else 1)
        if dtype == torch.bfloat16:
            bar = bar + 2.0 ** -7 * w.abs()
        err = (g - w).abs()
        assert bool((err <= bar).all()), (
            f"{name}: max abs err {float(err.max()):.3e} past the rounding "
            f"bar of a single attended key")
    bwd_close(got[2:], want[2:], terms[2:], dtype, names=("dv",))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("variant", ["causal", "full"])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_backward_is_bit_deterministic(dev, D, variant, dtype):
    """Three K5 calls on the same inputs give the same bits in dq, dk and
    dv: no atomics, one summation order (remat and resume rely on it)."""
    dt = DTYPES[dtype]
    rng = np.random.default_rng(10)
    q = _randn(rng, dev, dt, 2, 700, 16, D)
    k, v = _randn(rng, dev, dt, 2, 700, 4, D), _randn(rng, dev, dt, 2, 700,
                                                      4, D)
    do = _randn(rng, dev, dt, 2, 700, 16, D)
    kw = dict(causal=variant == "causal")
    o, lse = flash_attention.flash_attention_fwd(q, k, v, **kw)
    first = flash_backward.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    for _ in range(2):
        again = flash_backward.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        for name, a, b in zip(("dq", "dk", "dv"), first, again):
            assert torch.equal(a, b), f"{name}: not the same bits"


def test_bf16_flash_kernels_refuse_misaligned_operands(dev):
    """The bf16 K4 and K5 move operands 16 bytes at a time (cp.async): a
    contiguous tensor that starts 2 bytes past a 16-byte boundary is
    refused with cudaErrorMisalignedAddress (716), not read wrongly."""
    rng = np.random.default_rng(11)
    q = _randn(rng, dev, torch.bfloat16, 1, 17, 4, 64)
    k = _randn(rng, dev, torch.bfloat16, 1, 17, 2, 64)
    shifted = torch.empty(q.numel() + 8, dtype=q.dtype, device=dev)
    odd = shifted[1:1 + q.numel()].view(q.shape)
    odd.copy_(q)
    assert odd.is_contiguous() and odd.data_ptr() % 16
    with pytest.raises(RuntimeError, match="cudaError_t 716"):
        flash_attention.flash_attention_fwd(odd, k, k)
    o, lse = flash_attention.flash_attention_fwd(q, k, k)
    with pytest.raises(RuntimeError, match="cudaError_t 716"):
        flash_backward.flash_attention_bwd(odd, k, k, o, lse, q)


# ---------------------------------------------------------------------------
# K6 mamba2_scan and K7 rwkv6_scan
# ---------------------------------------------------------------------------

CLAMP_W = float(np.exp(-np.exp(0.75)))
# (B, S, H, P, N, dt scale) per case: dt = softplus(N(0, 1)) * scale
MAMBA_CASES = {"short": (1, 50, 3, 64, 64, 1.0),
               "ragged": (2, 300, 5, 40, 64, 1.0),
               "dt_near_0": (2, 200, 3, 64, 64, 1e-6),
               "large_dt_a": (2, 200, 3, 64, 64, 10.0),
               "state16": (2, 150, 2, 64, 16, 1.0),
               "state32": (1, 129, 3, 24, 32, 1.0),
               "state128": (1, 140, 3, 64, 128, 1.0),
               "full_zamba2": (2, 2048, 80, 64, 64, 1.0)}
# (B, S, H, K, V, w: "random" | "one" | "clamp", u zero) per case
RWKV_CASES = {"short": (1, 20, 3, 64, 64, "random", False),
              "ragged": (2, 100, 5, 64, 64, "random", False),
              "w_one": (2, 70, 3, 64, 64, "one", False),
              "w_clamp": (2, 96, 3, 64, 64, "clamp", False),
              "u_zero": (2, 70, 3, 64, 64, "random", True),
              "clamp_u_zero": (1, 64, 3, 64, 64, "clamp", True),
              "key16": (2, 50, 2, 16, 16, "random", False),
              "key32_ragged_cols": (1, 45, 3, 32, 40, "random", False),
              "full_rwkv6": (2, 2048, 32, 64, 64, "random", False)}


def mamba_args(dev, dtype, B, S, H, P, N, dt_scale, seed=0):
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))) * dt_scale
    return dict(x=_randn(rng, dev, dtype, B, S, H, P), dt=f32(dt),
                A=f32(np.abs(rng.standard_normal(H)) + 0.1),
                Bm=_randn(rng, dev, dtype, B, S, N),
                Cm=_randn(rng, dev, dtype, B, S, N))


def rwkv_args(dev, dtype, B, S, H, K, V, w_kind, u_zero, seed=0):
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    w = np.exp(-np.exp(np.clip(rng.standard_normal((B, S, H, K)), -8,
                               0.75)))
    if w_kind != "random":
        w[:] = 1.0 if w_kind == "one" else CLAMP_W
    u = rng.standard_normal((H, K)) * 0.1 * (0.0 if u_zero else 1.0)
    return dict(r=_randn(rng, dev, dtype, B, S, H, K),
                k=_randn(rng, dev, dtype, B, S, H, K),
                v=_randn(rng, dev, dtype, B, S, H, V), w=f32(w), u=f32(u))


def scan_terms(kind, a):
    """The plain scan of the inputs' absolute values: the magnitude of the
    terms each output sums (the decays are positive)."""
    if kind == "mamba2":
        return mamba2_scan.reference(a["x"].abs(), a["dt"], a["A"],
                                     a["Bm"].abs(), a["Cm"].abs())
    return rwkv6_scan.reference(a["r"].abs(), a["k"].abs(), a["v"].abs(),
                                a["w"], a["u"].abs())


def scan_close(got, want, terms, dtype):
    g, w = got.float().cpu(), want.float().cpu()
    bar = 1e-5 * float(terms.float().abs().max())
    if dtype == torch.bfloat16:
        bar = 2.0 ** -7 * w.abs() + bar
    err = (g - w).abs()
    assert bool(torch.isfinite(g).all()), "non-finite kernel output"
    bad = err > bar
    assert not bool(bad.any()), (
        f"{int(bad.sum())} elements past the bar, max abs err "
        f"{float(err.max()):.3e} (max |y| {float(w.abs().max()):.3e}, "
        f"max term {float(terms.float().abs().max()):.3e})")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(MAMBA_CASES))
def test_mamba2_scan_kernel_matches_plain(dev, case, dtype):
    dt = DTYPES[dtype]
    a = mamba_args(dev, dt, *MAMBA_CASES[case])
    n0 = mamba2_scan.launches
    got = ops.mamba2_scan(**a)
    want = ops.mamba2_scan(**a, impl="ref")
    torch.cuda.synchronize()
    assert mamba2_scan.launches == n0 + 1
    assert got.dtype == dt and got.shape == a["x"].shape
    scan_close(got, want, scan_terms("mamba2", a), dt)
    assert torch.equal(mamba2_scan.mamba2_scan(**a), got), "not the same bits"


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(RWKV_CASES))
def test_rwkv6_scan_kernel_matches_plain(dev, case, dtype):
    dt = DTYPES[dtype]
    a = rwkv_args(dev, dt, *RWKV_CASES[case])
    n0 = rwkv6_scan.launches
    got = ops.rwkv6_scan(**a)
    want = ops.rwkv6_scan(**a, impl="ref")
    torch.cuda.synchronize()
    assert rwkv6_scan.launches == n0 + 1
    assert got.dtype == dt and got.shape == a["v"].shape
    scan_close(got, want, scan_terms("rwkv6", a), dt)
    assert torch.equal(rwkv6_scan.rwkv6_scan(**a), got), "not the same bits"


def test_scan_kernels_refuse_what_they_do_not_take(dev):
    m = mamba_args(dev, torch.bfloat16, 1, 8, 2, 64, 64, 1.0)
    r = rwkv_args(dev, torch.bfloat16, 1, 8, 2, 64, 64, "random", False)
    n6, n7 = mamba2_scan.launches, rwkv6_scan.launches
    with pytest.raises(ValueError, match="dt must be torch.float32"):
        mamba2_scan.mamba2_scan(**dict(m, dt=m["dt"].to(torch.bfloat16)))
    with pytest.raises(ValueError, match="w must be torch.float32"):
        rwkv6_scan.rwkv6_scan(**dict(r, w=r["w"].to(torch.bfloat16)))
    with pytest.raises(ValueError, match="Cm must be"):
        mamba2_scan.mamba2_scan(**dict(m, Cm=m["Cm"].float()))
    with pytest.raises(ValueError, match="shape"):
        mamba2_scan.mamba2_scan(**dict(m, Bm=m["Bm"][:, :4].contiguous()))
    with pytest.raises(ValueError, match="contiguous"):
        rwkv6_scan.rwkv6_scan(**dict(r, k=r["k"].transpose(1, 2)
                                     .contiguous().transpose(1, 2)))
    with pytest.raises(ValueError, match="state size"):
        mamba2_scan.mamba2_scan(**mamba_args(dev, torch.float32, 1, 8, 2,
                                             64, 48, 1.0))
    with pytest.raises(ValueError, match="key size"):
        rwkv6_scan.rwkv6_scan(**rwkv_args(dev, torch.float32, 1, 8, 2, 128,
                                          128, "random", False))
    # no backward: a call autograd would differentiate raises, with or
    # without ops in between, instead of returning a detached result
    x = m["x"].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.mamba2_scan(**dict(m, x=x))
    u = r["u"].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.rwkv6_scan(**dict(r, u=u))
    with torch.no_grad():
        ops.mamba2_scan(**dict(m, x=x))
    assert (mamba2_scan.launches, rwkv6_scan.launches) == (n6 + 1, n7)
