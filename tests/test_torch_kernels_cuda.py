"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card: the edge cases of test_torch_kernels.py and test_torch_flash.py
(GQA groups 1 / 2 / 4, shuffled block tables, ragged rows, a chunk starting
mid-page, two chunks of one sequence in one batch, dead rows, q_lens pad
lanes, sliding window, softcap; causal and full attention over a length
that is no tile multiple, fewer queries than keys; dense decode lengths 0,
1 and the whole strip, one length for every lane) at the kernels' head
dims 64 and 128, in float32 and bfloat16.

Needs an NVIDIA GPU and nvcc: every test skips with a reason elsewhere.
Run on the card with `python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py`.

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
log-sum-exp of K4 is float32 in both dtypes: 1e-5 absolute.  Dead rows,
pad lanes and empty decode lanes are exactly 0.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention, flash_decode, ops
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
@pytest.mark.parametrize("D", [64, 128])
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
@pytest.mark.parametrize("D", [64, 128])
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
