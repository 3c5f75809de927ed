"""The dense family's remaining configurations in the port against the JAX
package on the CPU, float32, on the JAX Model.init weights carried over by
repro_torch.models.convert: opt-6.7b (the paper's MHA model: LayerNorm
with biases, gelu, sinusoidal absolute positions), qwen-7b (the paper's
GQA model: an untied lm_head), granite-8b, olmo-1b (non-parametric
LayerNorm), each at its smoke config, and qwen-7b's smoke config with 7
query heads over 1 KV head (a GQA group of 7, the full qwen-7b's 28 / 4)
on both sides.  For each: Model.forward; a ragged chunk batch, then
decode steps through the page pool; one conformance trace ("mixed",
tests/conformance.py) through both engines (tests/torch_replay.py).  Then
three train steps of opt-6.7b's smoke config (LayerNorm, gelu and the
position term under autograd), the sinusoidal positions themselves, the
plain K1-K4 at gemma3-4b's head dim 256 against the JAX Pallas kernels in
interpret mode, the Trainer's refusal, on CUDA, of a head dim K5 does not
take (96; zamba2's 80 passes), and gemma3-4b's smoke config at head dim 256: its loss and
gradients (float32 and bfloat16) and one train step.

Bars: logits and written pools 1e-5 absolute (ROADMAP §3: XLA and ATen
sum the projections in other orders); engine outputs equal or the
teacher-forced near tie of tests/traffic.py, every count equal; train
steps as test_train_steps_match_jax without compression (metrics 1e-5
relative, params 1e-5 absolute, m and v 1e-5 of each leaf's largest
|entry|); plain kernels 1e-5 absolute; gemma3-4b's loss and gradients at
head dim 256 as test_loss_and_grads_match_jax (LOSS_BARS: float32 1e-5 on
the loss and of each leaf's largest |gradient|, bfloat16 2e-2).  The
position term: XLA's and ATen's float32 exp give frequencies up to one ulp
apart (ROADMAP §3), and the angle p x f carries that ulp times p and its
own float32 rounding, so the term at position p is held within 1e-6 + p
|f_port - f_jax| + one ulp of p f per frequency - 1e-6 wherever the two
frequencies are equal.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformance import TRACES
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.kernels import ops as jops
from repro.kernels.flash_attention import flash_attention_fwd as jfa_pallas
from repro.kernels.flash_decode import flash_decode as jfd_pallas
from repro.models import build_model as jax_build_model
from repro.models.layers import sinusoidal_positions as j_sinusoidal
from repro.train import init_train_state as j_init_train_state
from repro.train import make_train_step as j_make_train_step
from repro_torch.configs import TrainConfig, get_config, get_smoke_config
from repro_torch.kernels import flash_attention, flash_backward, ref
from repro_torch.launch import train as train_launcher
from repro_torch.models import build_model
from repro_torch.models.convert import (params_from_numpy,
                                        train_state_from_numpy)
from repro_torch.models.layers import MAX_POSITION, sinusoidal_positions
from repro_torch.train import make_train_step, trainable
from repro_torch.train.trainer import Trainer, check_backward
from repro_torch.tree import leaves_with_paths
from torch_replay import (assert_pages_conserved, assert_same_accounting,
                          one_torch_thread, replay_both, trace_kw)

BAR = 1e-5
# name -> (architecture, smoke config overrides, the same on both sides)
CONFIGS = {"opt-6.7b": ("opt-6.7b", {}), "qwen-7b": ("qwen-7b", {}),
           "granite-8b": ("granite-8b", {}), "olmo-1b": ("olmo-1b", {}),
           "qwen-7b-g7": ("qwen-7b", dict(n_heads=7, n_kv_heads=1))}
PS, MAX_LEN, N_PAGES, CHUNK = 4, 48, 37, 16

_threads = pytest.fixture(scope="module", autouse=True)(one_torch_thread)


def _models(name):
    """(JAX model, JAX params, port model, port params), float32, the JAX
    init weights in both; every leaf of the JAX tree must convert."""
    arch, over = CONFIGS[name]
    jcfg = jax_smoke_config(arch).replace(dtype="float32", **over)
    cfg = get_smoke_config(arch).replace(dtype="float32", **over)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(cfg, device="cpu")
    return jm, jp, tm, params_from_numpy(jax.device_get(jp), cfg, "cpu")


@pytest.fixture(scope="module", params=list(CONFIGS))
def models(request):
    return request.param, _models(request.param)


def _np32(x):
    return x.detach().float().numpy() if torch.is_tensor(x) \
        else np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, bar=BAR):
    np.testing.assert_allclose(_np32(got), _np32(want), atol=bar, rtol=0)


def test_forward_matches_jax(models):
    name, (jm, jp, tm, tp) = models
    cfg = tm.cfg
    # the leaves that set the family apart came across
    tok, n1 = tp["tok"], tp["blocks"]["n1"]
    assert ("lm_head" in tok) == (not cfg.tie_embeddings)
    assert sorted(n1) == {"layernorm": ["bias", "scale"], "rmsnorm":
                          ["scale"], "nonparam_ln": []}[cfg.norm]
    toks = np.random.default_rng(4).integers(
        1, cfg.vocab_size, (2, 40)).astype(np.int32)
    jl, _ = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)})
    tl, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    assert tl.shape == (2, 40, cfg.vocab_size)
    _close(tl, jl)


def test_chunks_then_decode_match_jax(models):
    """A ragged chunk batch (two chunks of one sequence, a dead row, a
    chunk starting mid-page), a batch of final chunks, then three decode
    steps with an idle lane: logits and pools after each."""
    name, (jm, jp, tm, tp) = models
    vocab = tm.cfg.vocab_size
    rng = np.random.default_rng(0)
    perm = rng.permutation(np.arange(1, N_PAGES)).astype(np.int32)
    prompts, tables = {}, {}
    for seq, n, pages in (("A", 20, perm[:7]), ("B", 37, perm[7:17])):
        prompts[seq] = rng.integers(1, vocab, n)
        tables[seq] = np.zeros(MAX_LEN // PS, np.int32)
        tables[seq][:len(pages)] = pages
    jcache = jm.init_cache(3, MAX_LEN, page_size=PS, num_pages=N_PAGES)
    tcache = tm.init_cache(3, MAX_LEN, page_size=PS, num_pages=N_PAGES)
    j_chunks = jax.jit(jm.prefill_chunks)
    pools = lambda c, f: [f(c[k])[:, 1:] for k in ("k_pages", "v_pages")]
    for plan in ([("A", 0, 16), ("B", 0, 16), ("B", 16, 16), None],
                 [("A", 16, 4), ("B", 32, 5)]):
        K = len(plan)
        toks = np.zeros((K, CHUNK), np.int32)
        off, tl, tb = (np.zeros(K, np.int32), np.zeros(K, np.int32),
                       np.zeros((K, MAX_LEN // PS), np.int32))
        for r, row in enumerate(plan):
            if row is not None:
                seq, start, n = row
                toks[r, :n] = prompts[seq][start:start + n]
                off[r], tl[r], tb[r] = start, start + n, tables[seq]
        jl, jcache, _ = j_chunks(
            jp, {"tokens": jnp.asarray(toks), "offset": jnp.asarray(off),
                 "true_lens": jnp.asarray(tl)}, jcache, jnp.asarray(tb))
        got, tcache, _ = tm.prefill_chunks(
            tp, {"tokens": torch.from_numpy(toks),
                 "offset": torch.from_numpy(off),
                 "true_lens": torch.from_numpy(tl)}, tcache,
            torch.from_numpy(tb))
        _close(got[tl > 0], np.asarray(jl)[tl > 0])
        for a, b in zip(pools(tcache, _np32), pools(jcache, _np32)):
            _close(a, b)
    bt = np.stack([tables["A"], tables["B"], np.zeros(MAX_LEN // PS,
                                                      np.int32)])
    jcache["block_table"] = jnp.asarray(bt)
    tcache["block_table"] = torch.from_numpy(bt)
    lens = np.array([20, 37, 0], np.int32)
    tok = np.array([[5], [7], [0]], np.int32)
    j_decode = jax.jit(jm.decode_step)
    for _ in range(3):
        jl, jcache = j_decode(jp, jnp.asarray(tok), jnp.asarray(lens),
                              jcache)
        got, tcache = tm.decode_step(tp, torch.from_numpy(tok),
                                     torch.from_numpy(lens), tcache)
        _close(got[:2], np.asarray(jl)[:2])
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        lens = lens + np.array([1, 1, 0], np.int32)
    for a, b in zip(pools(tcache, _np32), pools(jcache, _np32)):
        _close(a, b)


def test_trace_matches_jax(models):
    """The "mixed" conformance trace through both engines (paged, chunked,
    batched): greedy outputs equal, every count equal."""
    _, m = models
    j_eng, t_eng, _ = replay_both(m, TRACES["mixed"].build,
                                  trace_kw("mixed", False))
    assert_same_accounting(j_eng, t_eng)
    assert_pages_conserved(t_eng)


def test_opt_train_steps_match_jax():
    """Three train steps of opt-6.7b's smoke config from one JAX
    TrainState on numpy-seeded batches: loss, grad norm and lr each step,
    then params, m and v."""
    jcfg = jax_smoke_config("opt-6.7b").replace(dtype="float32")
    cfg = get_smoke_config("opt-6.7b").replace(dtype="float32")
    kw = dict(global_batch=2, seq_len=32, learning_rate=1e-3,
              warmup_steps=1, total_steps=10)
    jm = jax_build_model(jcfg)
    jstate = j_init_train_state(jm, jax.random.PRNGKey(0),
                                JaxTrainConfig(**kw))
    host = jax.device_get(jstate)
    rng = np.random.default_rng(7)
    batches = [rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
               for _ in range(3)]
    jstep = jax.jit(j_make_train_step(jm, JaxTrainConfig(**kw)))
    state = train_state_from_numpy(host.params, host.opt, host.ef, cfg,
                                   "cpu")
    step = make_train_step(build_model(cfg, device="cpu"), TrainConfig(**kw))
    for b in batches:
        jstate, want = jstep(jstate, {"tokens": jnp.asarray(b)})
        state, got = step(state, {"tokens": torch.from_numpy(b)})
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
    for name, port, ref_tree in (("params", state.params, jstate.params),
                                 ("m", state.opt.m, jstate.opt.m),
                                 ("v", state.opt.v, jstate.opt.v)):
        want = dict(leaves_with_paths(jax.device_get(ref_tree)))
        for path, t in leaves_with_paths(port):
            w = np.asarray(want[path])
            bar = BAR if name == "params" else BAR * np.abs(w).max()
            assert np.abs(_np32(t) - w).max() <= bar, (name, path)


@pytest.mark.parametrize("offset", [0, 1000, MAX_POSITION - 5])
@pytest.mark.parametrize("d", [64, 4096])
def test_sinusoidal_positions_match_jax(offset, d):
    """The term at offset + arange(16) (clamped at MAX_POSITION as the JAX
    gather clamps: the last offset runs past it) against rows of the JAX
    65536-row table, at the smoke width and opt-6.7b's; and through
    Model._embed, whose chunk / decode start takes the same clamp."""
    half = d // 2
    jf = np.asarray(jnp.exp(-jnp.arange(half, dtype=jnp.float32)
                            * (math.log(10_000.0) / half)))
    tf = torch.exp(-torch.arange(half, dtype=torch.float32)
                   * (math.log(10_000.0) / half)).numpy()
    ulp = np.abs(jf.view(np.int32) - tf.view(np.int32))
    assert ulp.max() <= 1, "frequencies more than one ulp apart"
    pos = np.minimum(np.arange(offset, offset + 16), MAX_POSITION)
    want = np.asarray(j_sinusoidal(65536, d))[pos]
    got = sinusoidal_positions(torch.from_numpy(pos), d)
    assert got.dtype == torch.float32 and got.shape == (16, d)
    # where the frequencies differ, the angles p f (float32) differ by p
    # |f_port - f_jax| and their roundings, at most one ulp of the angle
    df = np.concatenate([np.abs(jf - tf), np.abs(jf - tf)]).astype(np.float64)
    ang = pos[:, None].astype(np.float32) * np.concatenate([jf, jf])[None]
    bar = 1e-6 + np.where(df > 0, pos[:, None] * df + np.spacing(ang), 0.0)
    assert (np.abs(_np32(got) - want) <= bar).all()
    cfg = get_smoke_config("opt-6.7b").replace(dtype="float32", d_model=d)
    m = build_model(cfg, device="meta")
    tok = {"embed": torch.zeros((cfg.vocab_size, d))}
    start = torch.tensor([offset], dtype=torch.int32)
    x = m._embed({"tok": tok}, torch.zeros((1, 16), dtype=torch.int32),
                 start)
    assert torch.equal(x[0], got)


# plain K1-K4 at head dim 256 against the Pallas kernels (interpret mode)
D256, HKV = 256, 2


def _f(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_plain_paged_kernels_at_head_dim_256_match_jax():
    """K1 (a ragged chunk batch with a window) and K2 (decode lanes with an
    idle one) at head dim 256, G 2."""
    rng = np.random.default_rng(20)
    k, v = _f(rng, 24, 4, HKV, D256), _f(rng, 24, 4, HKV, D256)
    q = _f(rng, 3, 8, 2 * HKV, D256)
    perm = rng.permutation(np.arange(1, 24)).astype(np.int32)
    tb = np.zeros((3, 6), np.int32)
    tb[0, :3], tb[1, :6] = perm[:3], perm[3:9]
    offs, tls = np.array([4, 13, 0], np.int32), np.array([12, 21, 0],
                                                         np.int32)
    t, j = (lambda a: torch.from_numpy(a)), jnp.asarray
    got = ref.batched_paged_prefill_attention(
        t(q), t(k), t(v), t(tb), t(offs), t(tls), window=5)
    for impl in ("pallas", "ref"):
        _close(got, jops.batched_paged_prefill_attention(
            j(q), j(k), j(v), j(tb), j(offs), j(tls), window=5, impl=impl))
    assert not got[2].any()
    qd, lens = _f(rng, 3, 1, 2 * HKV, D256), np.array([9, 24, 0], np.int32)
    got = ref.paged_flash_decode(t(qd), t(k), t(v), t(tb), t(lens))
    for impl in ("pallas", "ref"):
        _close(got, jops.paged_flash_decode(j(qd), j(k), j(v), j(tb),
                                            j(lens), impl=impl))
    assert not got[2].any()


def test_plain_dense_kernels_at_head_dim_256_match_jax():
    """K4 (causal, a window, softcap: o and lse) and K3 (lanes of length
    0, 1, inside and the whole strip) at head dim 256, G 2."""
    rng = np.random.default_rng(21)
    q, k, v = (_f(rng, 2, 37, 2 * HKV, D256), _f(rng, 2, 37, HKV, D256),
               _f(rng, 2, 37, HKV, D256))
    kw = dict(causal=True, window=8, logit_softcap=30.0)
    o, lse = flash_attention.reference(*map(torch.from_numpy, (q, k, v)),
                                       **kw)
    o_p, lse_p = jfa_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            **kw)
    _close(o, o_p)
    _close(lse, lse_p)
    lens = np.array([0, 1, 20, 37], np.int32)
    qd, kc, vc = (_f(rng, 4, 1, 2 * HKV, D256), _f(rng, 4, 37, HKV, D256),
                  _f(rng, 4, 37, HKV, D256))
    got = ref.flash_decode(*map(torch.from_numpy, (qd, kc, vc, lens)))
    _close(got, jfd_pallas(*map(jnp.asarray, (qd, kc, vc, lens))))
    assert not got[0].any()


def test_trainer_refuses_head_dim_80_on_cuda():
    """On CUDA the attention gradient is K5, which takes head dims 64,
    80, 128 and 256: zamba2 (80) and a dense config at head dim 80 pass
    check_backward, so the Trainer and the launcher get past it and fail
    only at the device on a machine without a GPU, with no kernel
    launched; a head dim outside the set (96) is still refused by the
    Trainer, naming K5, before a model is built; gemma3-4b's 256
    passes."""
    counts = (flash_attention.launches, flash_backward.launches)
    tcfg = TrainConfig(global_batch=1, seq_len=16, total_steps=1)
    for cfg in (get_config("zamba2-2.7b"),
                get_smoke_config("gemma3-4b").replace(head_dim=80)):
        check_backward(cfg, "cuda")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(cfg, tcfg, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_launcher.main(["--arch", "zamba2-2.7b", "--single-device",
                             "--steps", "1", "--global-batch", "1", "--seq",
                             "16"])
    with pytest.raises(NotImplementedError,
                       match="K5 flash_attention_bwd.*head dim 96"):
        Trainer(get_smoke_config("gemma3-4b").replace(head_dim=96), tcfg,
                device="cuda")
    assert (flash_attention.launches, flash_backward.launches) == counts
    for cfg in (get_config("gemma3-4b"),
                get_smoke_config("gemma3-4b").replace(head_dim=256)):
        check_backward(cfg, "cuda")


# gemma3-4b's smoke config at its full head dim 256, the same .replace in
# both packages: the loss and its gradients, and one train step
# dtype -> (loss bar, gradient bar relative to each leaf's max |grad|), as
# tests/test_torch_train.py LOSS_BARS
LOSS_BARS = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 2e-2)}
# 64 tokens a row: the smoke window of 32 binds
G256_BATCH = (2, 64)


def _gemma256(dtype):
    jcfg = jax_smoke_config("gemma3-4b").replace(dtype=dtype, head_dim=256)
    cfg = get_smoke_config("gemma3-4b").replace(dtype=dtype, head_dim=256)
    return jcfg, cfg


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemma3_head_dim_256_loss_and_grads_match_jax(dtype):
    """Model.loss and every gradient leaf (K4's forward and K5's backward
    rule in their plain versions, QK-norm, the embedding scale, the tied
    unembed) against jax.value_and_grad of the JAX Model.loss, on a
    numpy-seeded batch."""
    jcfg, cfg = _gemma256(dtype)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(cfg, device="cpu")
    tp = trainable(params_from_numpy(jax.device_get(jp), cfg, "cpu"))
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, G256_BATCH).astype(np.int32)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jm.loss(p, {"tokens": jnp.asarray(toks)}),
        has_aux=True)(jp)
    tl, _ = tm.loss(tp, {"tokens": torch.from_numpy(toks)})
    tl.backward()
    loss_bar, grad_bar = LOSS_BARS[dtype]
    assert abs(float(tl.detach()) - float(jl)) <= loss_bar
    want = dict(leaves_with_paths(jax.device_get(jg)))
    paths = [path for path, _ in leaves_with_paths(tp)]
    assert sorted(paths) == sorted(want)
    for path, p in leaves_with_paths(tp):
        assert p.grad is not None and p.grad.dtype == p.dtype, path
        g, w = _np32(p.grad), np.asarray(want[path], np.float32)
        rel = np.abs(g - w).max() / np.abs(w).max()
        assert rel <= grad_bar, (path, rel)


def test_gemma3_head_dim_256_train_step_matches_jax():
    """One train step (float32, remat full) from one JAX TrainState on a
    numpy-seeded batch, at the bars of test_opt_train_steps_match_jax."""
    jcfg, cfg = _gemma256("float32")
    kw = dict(global_batch=G256_BATCH[0], seq_len=G256_BATCH[1],
              learning_rate=1e-3, warmup_steps=1, total_steps=10,
              remat="full")
    jm = jax_build_model(jcfg)
    jstate = j_init_train_state(jm, jax.random.PRNGKey(0),
                                JaxTrainConfig(**kw))
    host = jax.device_get(jstate)
    b = np.random.default_rng(5).integers(
        0, cfg.vocab_size, G256_BATCH).astype(np.int32)
    jstate, want = jax.jit(j_make_train_step(jm, JaxTrainConfig(**kw)))(
        jstate, {"tokens": jnp.asarray(b)})
    state = train_state_from_numpy(host.params, host.opt, host.ef, cfg,
                                   "cpu")
    step = make_train_step(build_model(cfg, device="cpu"), TrainConfig(**kw))
    state, got = step(state, {"tokens": torch.from_numpy(b)})
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    for name, port, ref_tree in (("params", state.params, jstate.params),
                                 ("m", state.opt.m, jstate.opt.m),
                                 ("v", state.opt.v, jstate.opt.v)):
        want_t = dict(leaves_with_paths(jax.device_get(ref_tree)))
        for path, t in leaves_with_paths(port):
            w = np.asarray(want_t[path])
            bar = BAR if name == "params" else BAR * np.abs(w).max()
            assert np.abs(_np32(t) - w).max() <= bar, (name, path)
