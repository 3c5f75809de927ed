"""The split-KV form of the paged decode K2 (csrc/paged_decode.cu) in plain
PyTorch, against the JAX package on the CPU: the port's copy of
combine_partial_softmax against the JAX one (empty partials and lanes
whose every partial is empty among them), and the split form
(kernels/ref.py paged_flash_decode_split: per-split unnormalised (m, l,
o), then the combine) at splits of 4, 16, 256 and the kernel's own
(kernels/flash_decode.py SPLIT) against the JAX reference
paged_flash_decode, on lengths 0, 1, ragged and at the split edges, with
and without a window that starts inside a split, and with a softcap.

Bar: float32 within 1e-5 absolute (fp32 math on both sides, other
summation order).  A lane of length 0 comes out exactly 0.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import flash_decode, ref

F32_ATOL = 1e-5
HKV, D, PS, N_PAGES, N_MAX = 2, 16, 4, 64, 8
# lengths 0 and 1, inside a page, at and around the 16-position split
# edge, and the whole table (n_max * page_size = 32)
LENS = [0, 1, 3, 15, 16, 17, 32]
# (window, softcap) per variant; a window of 5 starts inside a split
VARIANTS = {"plain": (0, 0.0), "window": (5, 0.0), "softcap": (0, 2.0)}


def _decode_case(G: int, seed: int = 1):
    """One sequence per length over a shuffled pool, unused table entries
    pointing at page 0."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((N_PAGES, PS, HKV, D)).astype(np.float32)
    v = rng.standard_normal((N_PAGES, PS, HKV, D)).astype(np.float32)
    q = rng.standard_normal((len(LENS), 1, HKV * G, D)).astype(np.float32)
    perm = rng.permutation(np.arange(1, N_PAGES)).astype(np.int32)
    bt = np.zeros((len(LENS), N_MAX), np.int32)
    used = 0
    for b, n in enumerate(LENS):
        pages = -(-n // PS)
        bt[b, :pages] = perm[used:used + pages]
        used += pages
    return q, k, v, bt, np.array(LENS, np.int32)


def _partials(P: int, seed: int):
    """P partials of (4 lanes, 3 heads): lane 0 has every partial empty,
    lane 1 only its first, the others a random mix."""
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((P, 4, 3)).astype(np.float32) * 3
    l = rng.uniform(0.5, 40.0, (P, 4, 3)).astype(np.float32)
    o = rng.standard_normal((P, 4, 3, D)).astype(np.float32) * 5
    empty = rng.random((P, 4, 3)) < 0.3
    empty[:, 0] = True
    empty[1:, 1] = True
    m[empty], l[empty], o[empty] = -1e30, 0.0, 0.0
    return m, l, o


@pytest.mark.parametrize("P", [1, 3, 8])
def test_combine_matches_jax(P):
    m, l, o = _partials(P, seed=P)
    got = ref.combine_partial_softmax(*(torch.from_numpy(a)
                                        for a in (m, l, o)))
    want = jref.combine_partial_softmax(*(jnp.asarray(a) for a in (m, l, o)))
    for name, g, w in zip("mlo", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=F32_ATOL, err_msg=name)
    # every partial of lane 0 is empty: nothing to weigh, o and l exactly 0
    assert not got[1][0].any() and not got[2][0].any()


# with the split the kernel runs (kernels/flash_decode.py SPLIT)
@pytest.mark.parametrize("split", sorted({4, 16, 256, flash_decode.SPLIT}))
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("G", [1, 2, 4])
def test_split_form_matches_jax(G, variant, split):
    q, k, v, bt, lens = _decode_case(G)
    window, softcap = VARIANTS[variant]
    got = ref.paged_flash_decode_split(
        *(torch.from_numpy(a) for a in (q, k, v, bt, lens)), split=split,
        window=window, logit_softcap=softcap)
    want = jref.paged_flash_decode(
        *(jnp.asarray(a) for a in (q, k, v, bt, lens)), window=window,
        logit_softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=F32_ATOL)
    assert not got[0].numpy().any(), "lane of length 0 not exactly zero"

