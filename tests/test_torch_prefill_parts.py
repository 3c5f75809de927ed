"""Why the bf16 K1 (csrc/paged_prefill.cu) feeds each softmax weight to its
PV product as three bf16 parts.

K1's plain version (kernels/ref.py batched_paged_prefill_attention), like
the TPU kernel, multiplies V by the fp32 weights, and the card tests hold
the bf16 kernel to it within 2**-7 relative plus 1e-6
(tests/test_torch_kernels_cuda.py).  The tensor cores take bf16 operands,
so the kernel splits each weight p into bf16 parts, hi = bf16(p), then
bf16 of each remainder, and sums their products in one fp32 accumulator.
This file emulates that arithmetic on the CPU (scores in fp32 from the
bf16 q and K, an online softmax over tiles of 64 positions, the parts'
products summed in fp32, the output rounded to bf16 once) on the card
tests' prefill case, and holds it to the same bar: three parts hold it in
every case; two parts (a weight carried to ~2**-16) miss it where the
terms cancel, which is why the kernel pays for the third product.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref

S, HKV, PS, N_PAGES, N_MAX = 8, 2, 4, 40, 8
VARIANTS = {"plain": (0, 0.0), "window": (5, 0.0), "softcap": (0, 2.0)}
BN = 64                          # K1's KV tile


def _prefill_case(G, D, seed=0):
    """tests/test_torch_kernels_cuda.py's prefill case, in bf16."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(torch.bfloat16)
    k, v = f(N_PAGES, PS, HKV, D), f(N_PAGES, PS, HKV, D)
    q = f(6, S, HKV * G, D)
    perm = rng.permutation(np.arange(1, N_PAGES)).astype(np.int32)
    tables = np.zeros((6, N_MAX), np.int32)
    tables[0, :6] = perm[:6]
    tables[1, :8] = perm[6:14]
    tables[2, :4] = perm[14:18]
    tables[4, :5] = perm[18:23]
    tables[5] = tables[4]
    i32 = lambda a: torch.tensor(a, dtype=torch.int32)
    return (q, k, v, i32(tables), i32([4, 17, 0, 0, 0, 8]),
            i32([12, 20, 8, 0, 8, 16]))


def emulate(q, kp, vp, tables, offs, tls, parts, window=0, softcap=0.0):
    """K1's bf16 arithmetic with each weight split into `parts` bf16
    parts."""
    K, Sq, Hq, D = q.shape
    Hkv = kp.shape[2]
    G = Hq // Hkv
    idx = tables.long()
    k = kp[idx].reshape(K, -1, Hkv, D).float()
    v = vp[idx].reshape(K, -1, Hkv, D).float()
    skv = k.shape[1]
    s = torch.einsum("bshgd,bkhd->bshgk", q.float().reshape(K, Sq, Hkv, G, D),
                     k) * (1.0 / math.sqrt(D))
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    row = offs[:, None] + torch.arange(Sq)
    col = torch.arange(skv)
    mask = (col[None, None] <= row[:, :, None]) \
        & (col[None, None] < tls[:, None, None])
    if window > 0:
        mask &= col[None, None] > row[:, :, None] - window
    mask = mask[:, :, None, None, :]
    s = torch.where(mask, s, ref.NEG_INF)
    m = torch.full(s.shape[:-1], ref.NEG_INF)
    l = torch.zeros(s.shape[:-1])
    acc = torch.zeros(s.shape[:-1] + (D,))
    for t0 in range(0, skv, BN):
        st, mk = s[..., t0:t0 + BN], mask[..., t0:t0 + BN]
        m_new = torch.maximum(m, st.amax(-1))
        m_safe = torch.where(m_new <= ref.NEG_INF / 2, 0.0, m_new)
        alpha = torch.where(m <= ref.NEG_INF / 2, 0.0,
                            torch.exp2((m - m_new) * ref.LOG2E))
        p = torch.where(mk, torch.exp2((st - m_safe[..., None]) * ref.LOG2E),
                        0.0)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None]
        rest = p
        for _ in range(parts):
            part = rest.to(torch.bfloat16).float()
            acc = acc + torch.einsum("bshgk,bkhd->bshgd", part,
                                     v[:, t0:t0 + BN])
            rest = rest - part
        m = m_new
    o = acc / torch.clamp_min(l, 1e-20)[..., None]
    ql = torch.clamp(tls - offs, 0, Sq)
    o = torch.where((torch.arange(Sq)[None] < ql[:, None])
                    [:, :, None, None, None], o, 0.0)
    return o.reshape(K, Sq, Hq, D).to(torch.bfloat16)


def past_the_bar(G, D, variant, parts):
    """Elements of the emulation past the card tests' bf16 bar."""
    q, k, v, tb, off, tl = _prefill_case(G, D)
    window, softcap = VARIANTS[variant]
    want = ref.batched_paged_prefill_attention(
        q, k, v, tb, off, tl, window=window, logit_softcap=softcap).float()
    got = emulate(q, k, v, tb, off, tl, parts, window, softcap).float()
    return int(((got - want).abs() > 2.0 ** -7 * want.abs() + 1e-6).sum())


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("D", [64, 128])
def test_three_parts_hold_the_bar(D, G, variant):
    assert past_the_bar(G, D, variant, parts=3) == 0


def test_two_parts_miss_the_bar_where_terms_cancel():
    misses = sum(past_the_bar(G, D, variant, parts=2) for D in (64, 128)
                 for G in (1, 2, 4) for variant in VARIANTS)
    assert misses > 0
