"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card: the edge cases of test_torch_kernels.py (GQA groups 1 / 2 / 4,
shuffled block tables, ragged rows, a chunk starting mid-page, two chunks
of one sequence in one batch, dead rows, q_lens pad lanes, sliding window,
softcap) at the kernels' head dims 64 and 128, in float32 and bfloat16.

Needs an NVIDIA GPU and nvcc: every test skips with a reason elsewhere.
Run on the card with `python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py`.

Bars: float32 within 1e-5 absolute (fp32 math in both, other summation
order).  bfloat16: both compute in float32 from the same bfloat16 values
and round the output once, so within 2**-7 relative plus 1e-6 absolute.
Dead rows and pad lanes are exactly 0.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_decode, ops, paged_prefill

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
