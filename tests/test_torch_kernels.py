"""Plain PyTorch versions of the paged attention kernels (repro_torch.kernels)
against the JAX package: its jnp reference (impl="ref") and its Pallas
kernels run in interpret mode (impl="pallas"), on the same numpy inputs.

Bars: float32 agrees within 1e-5 absolute (the bar docs/kernels.md holds
the Pallas kernels to).  bfloat16 inputs: both sides compute in float32
from the same bfloat16 values and round the output to bfloat16 once, so
they agree within one bfloat16 rounding step of the output, 2**-7
relative plus 1e-6 absolute.  Dead rows and pad query lanes are exactly 0.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops, ref

F32_ATOL = 1e-5
BF16_RTOL = 2.0 ** -7

S, HKV, D, PS, N_PAGES, N_MAX = 8, 2, 16, 4, 40, 8
# (window, softcap) per variant; "qlens" passes explicit q_lens
VARIANTS = {"plain": (0, 0.0), "window": (5, 0.0), "softcap": (0, 2.0),
            "qlens": (0, 0.0)}


def _pools(rng, dtype):
    k = rng.standard_normal((N_PAGES, PS, HKV, D)).astype(np.float32)
    v = rng.standard_normal((N_PAGES, PS, HKV, D)).astype(np.float32)
    return k, v


def _prefill_case(G: int, seed: int = 0):
    """Six chunk rows over a shuffled pool: a page-aligned full chunk, a
    ragged chunk starting mid-page, a full chunk at offset 0, a DEAD row,
    and two consecutive chunks of one sequence sharing its table row."""
    rng = np.random.default_rng(seed)
    k, v = _pools(rng, np.float32)
    q = rng.standard_normal((6, S, HKV * G, D)).astype(np.float32)
    perm = rng.permutation(np.arange(1, N_PAGES)).astype(np.int32)
    tables = np.zeros((6, N_MAX), np.int32)
    tables[0, :6] = perm[:6]
    tables[1, :8] = perm[6:14]
    tables[2, :4] = perm[14:18]
    tables[4, :5] = perm[18:23]
    tables[5] = tables[4]
    offs = np.array([4, 17, 0, 0, 0, 8], np.int32)
    tls = np.array([12, 20, 8, 0, 8, 16], np.int32)
    q_lens = np.array([8, 2, 8, 0, 8, 5], np.int32)
    return q, k, v, tables, offs, tls, q_lens


def _decode_case(G: int, seed: int = 1):
    """Five sequences over a shuffled pool: lengths inside a page, across
    pages, a full table, one page exactly, and an idle lane (length 0)."""
    rng = np.random.default_rng(seed)
    k, v = _pools(rng, np.float32)
    q = rng.standard_normal((5, 1, HKV * G, D)).astype(np.float32)
    perm = rng.permutation(np.arange(1, N_PAGES)).astype(np.int32)
    bt = np.zeros((5, N_MAX), np.int32)
    bt[0, :1] = perm[:1]
    bt[1, :4] = perm[1:5]
    bt[2, :8] = perm[5:13]
    bt[3, :1] = perm[13:14]
    lens = np.array([3, 14, 32, 4, 0], np.int32)
    return q, k, v, bt, lens


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(dtype) \
        if np.asarray(a).dtype.kind == "f" else torch.from_numpy(np.asarray(a))


def _j(a, dtype=jnp.float32):
    a = jnp.asarray(a)
    return a.astype(dtype) if jnp.issubdtype(a.dtype, jnp.floating) else a


def _close(got: torch.Tensor, want, bf16: bool):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if bf16:
        np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)


def _port_prefill(case, variant, dtype):
    q, k, v, tables, offs, tls, q_lens = case
    window, softcap = VARIANTS[variant]
    return ops.batched_paged_prefill_attention(
        _t(q, dtype), _t(k, dtype), _t(v, dtype), _t(tables), _t(offs),
        _t(tls), _t(q_lens) if variant == "qlens" else None, window=window,
        logit_softcap=softcap)


def _jax_prefill(case, variant, impl, dtype=jnp.float32):
    q, k, v, tables, offs, tls, q_lens = case
    window, softcap = VARIANTS[variant]
    return jops.batched_paged_prefill_attention(
        _j(q, dtype), _j(k, dtype), _j(v, dtype), _j(tables), _j(offs),
        _j(tls), _j(q_lens) if variant == "qlens" else None, window=window,
        logit_softcap=softcap, impl=impl)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("G", [1, 2, 4])
def test_prefill_matches_jax_f32(G, variant):
    case = _prefill_case(G)
    got = _port_prefill(case, variant, torch.float32)
    _close(got, _jax_prefill(case, variant, "ref"), bf16=False)
    _close(got, _jax_prefill(case, variant, "pallas"), bf16=False)


@pytest.mark.parametrize("G", [1, 2, 4])
def test_prefill_matches_jax_bf16(G):
    case = _prefill_case(G, seed=3)
    got = _port_prefill(case, "window", torch.bfloat16)
    assert got.dtype == torch.bfloat16
    _close(got, _jax_prefill(case, "window", "ref", jnp.bfloat16), bf16=True)


@pytest.mark.parametrize("variant", ["plain", "qlens"])
def test_prefill_dead_rows_and_pad_lanes_exact_zero(variant):
    case = _prefill_case(4)
    q, k, v, tables, offs, tls, q_lens = case
    got = _port_prefill(case, variant, torch.float32).numpy()
    ql = q_lens if variant == "qlens" else np.clip(tls - offs, 0, S)
    for r in range(got.shape[0]):
        assert not got[r, ql[r]:].any(), f"row {r} pad lanes not zero"
    assert not got[3].any(), "dead row not zero"
    assert got[0].any() and got[5, :5].any()


def test_two_chunks_compose_to_one_prefill():
    """Rows 4 and 5 are consecutive chunks of one sequence: together they
    equal one monolithic causal attention over its 16 positions."""
    q, k, v, tables, offs, tls, _ = _prefill_case(2)
    got = _port_prefill((q, k, v, tables, offs, tls, None), "plain",
                        torch.float32)
    idx = torch.from_numpy(tables[4]).long()
    kk = torch.from_numpy(k)[idx].reshape(1, -1, HKV, D)[:, :16]
    vv = torch.from_numpy(v)[idx].reshape(1, -1, HKV, D)[:, :16]
    qq = torch.from_numpy(np.concatenate([q[4], q[5]]))[None]
    want = ref.naive_attention(qq, kk, vv)
    both = torch.cat([got[4], got[5]])[None]
    np.testing.assert_allclose(both.numpy(), want.numpy(), atol=F32_ATOL,
                               rtol=0)


def test_single_row_wrapper_matches_batched_row():
    q, k, v, tables, offs, tls, _ = _prefill_case(2)
    one = ops.paged_prefill_attention(
        _t(q[:1]), _t(k), _t(v), _t(tables[0]), int(offs[0]))
    want = jops.paged_prefill_attention(
        _j(q[:1]), _j(k), _j(v), _j(tables[0]), int(offs[0]), impl="ref")
    _close(one, want, bf16=False)


def _port_decode(case, variant, dtype):
    q, k, v, bt, lens = case
    window, softcap = VARIANTS[variant]
    return ops.paged_flash_decode(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                                  _t(bt), _t(lens), window=window,
                                  logit_softcap=softcap)


def _jax_decode(case, variant, impl, dtype=jnp.float32):
    q, k, v, bt, lens = case
    window, softcap = VARIANTS[variant]
    return jops.paged_flash_decode(_j(q, dtype), _j(k, dtype), _j(v, dtype),
                                   _j(bt), _j(lens), window=window,
                                   logit_softcap=softcap, impl=impl)


@pytest.mark.parametrize("variant", ["plain", "window", "softcap"])
@pytest.mark.parametrize("G", [1, 2, 4])
def test_decode_matches_jax_f32(G, variant):
    case = _decode_case(G)
    got = _port_decode(case, variant, torch.float32)
    _close(got, _jax_decode(case, variant, "ref"), bf16=False)
    _close(got, _jax_decode(case, variant, "pallas"), bf16=False)
    assert not got[4].numpy().any(), "idle lane (length 0) not zero"


@pytest.mark.parametrize("G", [1, 2, 4])
def test_decode_matches_jax_bf16(G):
    case = _decode_case(G, seed=4)
    got = _port_decode(case, "window", torch.bfloat16)
    assert got.dtype == torch.bfloat16
    _close(got, _jax_decode(case, "window", "ref", jnp.bfloat16), bf16=True)


@pytest.mark.parametrize("window", [0, 3])
def test_naive_attention_matches_jax(window):
    from repro.kernels import ref as jref
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 9, 4, D)).astype(np.float32)
    k = rng.standard_normal((2, 9, 2, D)).astype(np.float32)
    v = rng.standard_normal((2, 9, 2, D)).astype(np.float32)
    got = ref.naive_attention(_t(q), _t(k), _t(v), window=window)
    _close(got, jref.naive_attention(_j(q), _j(k), _j(v), window=window),
           bf16=False)


def test_cpu_tensors_never_count_kernel_launches():
    from repro_torch.kernels import (flash_attention, flash_decode,
                                     paged_prefill)
    counts = lambda: (paged_prefill.launches, flash_decode.launches,
                      flash_decode.dense_launches, flash_attention.launches)
    before = counts()
    _port_prefill(_prefill_case(2), "plain", torch.float32)
    _port_decode(_decode_case(2), "plain", torch.float32)
    q = torch.randn(1, 5, 4, D)
    kv = torch.randn(1, 5, 2, D)
    ops.flash_attention(q, kv, kv)
    ops.flash_decode(q[:, :1], kv, kv, torch.tensor([3], dtype=torch.int32))
    assert counts() == before


def test_bad_impl_raises():
    with pytest.raises(ValueError):
        _q, k, v, bt, lens = _decode_case(1)
        ops.paged_flash_decode(_t(_q), _t(k), _t(v), _t(bt), _t(lens),
                               impl="pallas")
