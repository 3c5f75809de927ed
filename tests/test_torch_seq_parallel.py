"""Sequence-parallel decode (M11) of the port against the JAX package on
the CPU: decode_attention_naive, _decode_partials and seq_parallel_decode
(kernels/ops.py), and Model.decode_step(seq_parallel=True) on the smoke
configs of granite-3-2b, zamba2-2.7b, rwkv6-1.6b and gemma3-4b, with the
JAX Model.init weights carried over.

seq_parallel_decode runs in gloo worlds of 1, 2 and 4 processes (one
spawn each, tests/torch_seq_parallel_worker.py), each rank holding its
slice of the cache; the ranks meet through a FileStore under the test's
tmp_path (no TCP port, so parallel test workers never collide), and each
world has 120 s to join and finish, so that a hang fails its test.  The
lanes' lengths are ragged, so that some rank's slice of a lane holds no
valid position (local_len 0).  The merged output is held against the
JAX package's ref.flash_decode over the whole cache within 2e-5 (the bar
of tests/test_distributed.py, which holds the JAX package's own
seq_parallel_decode to its flash_decode); every rank's output must be the
same.

Bars, float32 (the two frameworks sum the einsums in other orders):
decode_attention_naive and the decode steps' logits, and granite's cache
leaves, 1e-5 absolute; _decode_partials' m (a running maximum of the
scores, or NEG_INF where nothing is valid) 1e-5 absolute, l and o within
1e-5 of each one's largest |entry| - they are unnormalised sums of up to
1100 terms, l ~155 here, where float32 rounding alone is ~1e-5 absolute
(seen 3e-5 absolute, 2e-7 relative); the recurrent models' cache leaves
within 2e-4 of each leaf's largest |entry|, the bar of
tests/test_torch_recurrent.py: the zamba2 smoke model amplifies float32
rounding (seen 5.6e-5 absolute in the conv window, 9e-6 of its largest
entry) and rwkv6's WKV state sums long products (seen 7.7e-6 absolute, 1e-6
relative).  gemma3-4b decodes past its 32-token window: with
seq_parallel=True both packages attend over the whole cache, as the JAX
package's decode_attention_naive takes no window (ROADMAP §3), and their
logits agree within 1e-5, while the windowed decode's differ from them by
far more.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_seq_parallel_worker
from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_numpy

F32 = 1e-5
WORLD_BAR = 2e-5
JOIN_S = 120


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _np(x):
    return x.float().numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("G", [1, 2, 4])
def test_decode_attention_naive_matches_jax(G, softcap):
    """Lanes of length 0 (an exactly zero output), mid-strip and S."""
    rng = np.random.default_rng(G)
    B, S, Hkv, D = 3, 40, 2, 16
    q = _rand(rng, B, 1, Hkv * G, D)
    k, v = _rand(rng, B, S, Hkv, D), _rand(rng, B, S, Hkv, D)
    lens = np.array([0, 17, S], np.int32)
    want = jops.decode_attention_naive(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), jnp.asarray(lens),
                                       logit_softcap=softcap)
    got = ops.decode_attention_naive(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lens), logit_softcap=softcap)
    assert got.shape == (B, 1, Hkv * G, D) and got.dtype == torch.float32
    assert not got[0].any()
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=F32)


def test_decode_partials_match_jax_per_shard():
    """Two shards of 1100 positions (not a multiple of block_kv 1024): each
    shard's (m, l, o) over its local lengths, lanes of whole length 0,
    700, 1100 (the second shard empty) and 2000."""
    rng = np.random.default_rng(7)
    B, S_local, Hkv, G, D = 4, 1100, 2, 2, 16
    q = _rand(rng, B, 1, Hkv * G, D)
    lens = np.array([0, 700, 1100, 2000], np.int32)
    for shard in range(2):
        k, v = _rand(rng, B, S_local, Hkv, D), _rand(rng, B, S_local, Hkv, D)
        local = np.clip(lens - shard * S_local, 0, S_local).astype(np.int32)
        want = jops._decode_partials(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(local))
        got = ops._decode_partials(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v),
                                   torch.from_numpy(local))
        for name, g, w in zip("mlo", got, want):
            assert g.shape == w.shape and g.dtype == torch.float32, name
            bar = F32 if name == "m" else F32 * np.abs(_np(w)).max()
            np.testing.assert_allclose(_np(g), _np(w), rtol=0, atol=bar,
                                       err_msg=f"shard {shard} {name}")


def _run_world(world: int, tmp_path, inputs: str):
    """Spawn the world's ranks; each writes its output under tmp_path.
    Fails (and kills the ranks) past JOIN_S seconds."""
    ctx = mp.start_processes(
        torch_seq_parallel_worker.run,
        args=(world, str(tmp_path / "store"), inputs, str(tmp_path)),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_S
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"gloo world of {world} did not finish in {JOIN_S} s")
    return [np.load(tmp_path / f"o{r}.npy") for r in range(world)]


@pytest.mark.parametrize("world", [1, 2, 4])
def test_seq_parallel_decode_in_a_gloo_world_matches_jax(world, tmp_path):
    """96 positions cut into `world` slices; lanes of length 0, 5 (every
    slice but the first empty at 2 and 4 ranks), 40, 61 and 96; 4 query
    heads over 2 KV heads."""
    rng = np.random.default_rng(11)
    B, S, Hkv, G, D = 5, 96, 2, 2, 16
    q = _rand(rng, B, 1, Hkv * G, D)
    k, v = _rand(rng, B, S, Hkv, D), _rand(rng, B, S, Hkv, D)
    lens = np.array([0, 5, 40, 61, 96], np.int32)
    inputs = str(tmp_path / "inputs.npz")
    np.savez(inputs, q=q, k=k, v=v, lens=lens)
    outs = _run_world(world, tmp_path, inputs)
    want = _np(jref.flash_decode(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(lens)))
    for rank, got in enumerate(outs):
        assert got.shape == (B, 1, Hkv * G, D)
        np.testing.assert_array_equal(got, outs[0], err_msg=f"rank {rank}")
    assert not outs[0][0].any()
    np.testing.assert_allclose(outs[0], want, rtol=0, atol=WORLD_BAR)


def _models(arch):
    jcfg = jax_smoke_config(arch).replace(dtype="float32")
    tcfg = get_smoke_config(arch).replace(dtype="float32")
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, device="cpu")
    return jm, jp, tm, params_from_numpy(jax.device_get(jp), tcfg, "cpu")


@pytest.mark.parametrize("arch", ["granite-3-2b", "zamba2-2.7b",
                                  "rwkv6-1.6b"])
def test_seq_parallel_decode_steps_match_jax(arch):
    """Four decode steps from an empty cache, both packages with
    seq_parallel=True (rwkv6 ignores it); logits and the cache leaves."""
    jm, jp, tm, tp = _models(arch)
    jc, tc = jm.init_cache(2, 16), tm.init_cache(2, 16)
    jstep = jax.jit(jm.decode_step, static_argnames=("seq_parallel",))
    rng = np.random.default_rng(3)
    lens = np.array([0, 0], np.int32)
    for _ in range(4):
        nxt = rng.integers(0, 256, (2, 1)).astype(np.int32)
        jd, jc = jstep(jp, jnp.asarray(nxt), jnp.asarray(lens), jc,
                       seq_parallel=True)
        td, tc = tm.decode_step(tp, torch.from_numpy(nxt),
                                torch.from_numpy(lens), tc,
                                seq_parallel=True)
        np.testing.assert_allclose(_np(td), _np(jd), rtol=0, atol=F32)
        lens = lens + 1
    for name, t in tc.items():
        w = _np(jc[name])
        bar = F32 if arch == "granite-3-2b" else 2e-4 * np.abs(w).max()
        np.testing.assert_allclose(_np(t), w, rtol=0, atol=bar, err_msg=name)


def test_gemma3_seq_parallel_drops_the_window_as_the_jax_package_does():
    """gemma3-4b smoke (window 32 on two of every three layers): a 36-token
    prefill, then two decode steps at positions 36 and 37, past the
    window.  seq_parallel=True: port equals JAX; the windowed decode
    (K3's path, the plain version here) differs from both."""
    jm, jp, tm, tp = _models("gemma3-4b")
    assert tm.cfg.sliding_window == 32
    toks = np.random.default_rng(5).integers(0, 256, (2, 36)).astype(
        np.int32)
    jc = jm.init_cache(2, 48)
    _, jc, jlens = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)},
                                       jc)
    caches = {}
    for sp in (True, False):
        tc = tm.init_cache(2, 48)
        _, tc, tlens = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc)
        caches[sp] = (tc, tlens)
    nxt = np.array([[7], [9]], np.int32)
    jcs = jc
    jstep = jax.jit(jm.decode_step, static_argnames=("seq_parallel",))
    for step in range(2):
        jd, jcs = jstep(jp, jnp.asarray(nxt), jlens + step, jcs,
                        seq_parallel=True)
        got = {sp: tm.decode_step(tp, torch.from_numpy(nxt),
                                  caches[sp][1] + step, caches[sp][0],
                                  seq_parallel=sp)[0] for sp in (True, False)}
        np.testing.assert_allclose(_np(got[True]), _np(jd), rtol=0, atol=F32)
        assert np.abs(_np(got[False]) - _np(jd)).max() > 100 * F32


def test_paged_cache_with_seq_parallel_raises():
    tm = build_model(get_smoke_config("granite-3-2b").replace(
        dtype="float32"), device="cpu")
    tp = tm.init(0)
    cache = tm.init_cache(2, 32, page_size=16)
    with pytest.raises(ValueError, match="sequence-parallel"):
        tm.decode_step(tp, torch.zeros((2, 1), dtype=torch.int32),
                       torch.zeros((2,), dtype=torch.int32), cache,
                       seq_parallel=True)
