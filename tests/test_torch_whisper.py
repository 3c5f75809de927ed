"""whisper-base's encoder-decoder (M13) and cross-attention (M9) of the
port against the JAX package on the CPU, at the smoke config (2 + 2
layers, d_model 64, 4 heads of 16), float32, with the JAX Model.init
weights carried over and every input made by numpy from a seed.

attn_forward(kv_x=) non-causal with fewer queries than keys; Model.forward
logits; the loss and its gradients (loss.backward() against jax.grad);
prefill (last logits and all four caches: the self-attention strips and
the cross strips, here longer than the encoder output); 8 decode steps,
with and without seq_parallel, the lanes attending fewer cross positions
(enc_lens) than the strips hold; the audio host batch of the data
pipeline; the engine (3 requests on 2 slots, stepwise admission): greedy
outputs, launch records and counters; one Trainer step against the JAX
train step.

Bars, float32 (the two frameworks sum the projections and einsums in
other orders): logits, caches and the loss 1e-5 absolute (seen up to
1.7e-6, a cross strip); each gradient leaf within 1e-5 of its largest
|entry|, the bar of tests/test_torch_train.py.  The Trainer step takes the
pipeline's batch, whose audio frames the pipeline hands over in bfloat16
in both packages: the encoder of the float32 model then runs on bfloat16
activations (each projection multiplies in float32 and rounds to
bfloat16, as XLA's promoting dot does), where a summation-order
difference can flip one bfloat16 rounding - which one depends on the
batch, and the pipeline seeds its batches by Python's per-process hash
(ROADMAP §3).  Over 11 hash seeds the loss differed by up to 8.7e-6 and
the gradient norm by up to 5.8e-5 relative; both are held within 5e-4
relative, about 9x the larger.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import ServeConfig as JaxServeConfig
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.data.pipeline import DataPipeline as JaxDataPipeline
from repro.models import attention as jattention
from repro.models import build_model as jax_build_model
from repro.serve import ServeEngine as JaxServeEngine
from repro.train import init_train_state as j_init_train_state
from repro.train import make_train_step as j_make_train_step
from repro_torch.configs import (ServeConfig, TrainConfig, get_config,
                                 get_smoke_config)
from repro_torch.data import DataPipeline
from repro_torch.models import attention, build_model
from repro_torch.models.convert import (params_from_numpy,
                                        train_state_from_numpy)
from repro_torch.serve import ServeEngine
from repro_torch.train import trainable
from repro_torch.train.trainer import Trainer
from repro_torch.tree import leaves_with_paths
from torch_replay import assert_same_accounting, one_torch_thread
from traffic import TrafficItem, replay

ARCH = "whisper-base"
F32 = 1e-5
TRAIN_REL = 5e-4

_one_thread = pytest.fixture(scope="module", autouse=True)(one_torch_thread)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_smoke_config(ARCH).replace(dtype="float32")
    tcfg = get_smoke_config(ARCH).replace(dtype="float32")
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, device="cpu")
    return jm, jp, tm, params_from_numpy(jax.device_get(jp), tcfg, "cpu")


def _np(x):
    return x.detach().float().numpy() if torch.is_tensor(x) \
        else np.asarray(jnp.asarray(x, jnp.float32))


def _inputs(B, S, S_enc, seed=0):
    """(tokens (B, S) int32, audio (B, S_enc, 64) float32 at the
    pipeline's 0.02 scale)."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (B, S)).astype(np.int32),
            (rng.standard_normal((B, S_enc, 64)) * 0.02).astype(np.float32))


def _batches(toks, audio):
    return ({"tokens": jnp.asarray(toks), "audio_embeds": jnp.asarray(audio)},
            {"tokens": torch.from_numpy(toks),
             "audio_embeds": torch.from_numpy(audio)})


def test_config_is_registered_at_the_published_width():
    cfg = get_config(ARCH)
    assert (cfg.family, cfg.n_layers, cfg.encoder_layers, cfg.d_model,
            cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.vocab_size) \
        == ("audio", 6, 6, 512, 8, 8, 64, 51865)
    assert cfg == type(cfg)(**{k: getattr(cfg, k) for k in
                               cfg.__dataclass_fields__})
    jcfg = jax_smoke_config(ARCH)
    assert cfg.param_count() > 0 and get_smoke_config(ARCH).param_count() \
        == jcfg.param_count()


def test_cross_attn_forward_matches_jax(models):
    """5 decoder queries over 9 encoder positions, non-causal, through a
    decoder layer's cross-attention weights."""
    jm, jp, tm, tp = models
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    enc = rng.standard_normal((2, 9, 64)).astype(np.float32)
    jca = jax.tree_util.tree_map(lambda a: a[0],
                                 jp["blocks"]["decoder"]["cross_attn"])
    tca = {k: v[0] for k, v in tp["blocks"]["decoder"]["cross_attn"].items()}
    want = jattention.attn_forward(jca, jnp.asarray(x), jm.cfg, causal=False,
                                   kv_x=jnp.asarray(enc))
    got = attention.attn_forward(tca, torch.from_numpy(x), tm.cfg,
                                 causal=False, kv_x=torch.from_numpy(enc))
    assert got.shape == (2, 5, 64)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=F32)


def test_forward_matches_jax(models):
    jm, jp, tm, tp = models
    jb, tb = _batches(*_inputs(2, 12, 20))
    jl, jaux = jax.jit(jm.forward)(jp, jb)
    tl, taux = tm.forward(tp, tb)
    assert tl.dtype == torch.float32 and tl.shape == (2, 12, 256)
    assert float(taux) == float(jaux) == 0.0
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=0, atol=F32)


def test_loss_and_grads_match_jax(models):
    jm, jp, tm, _ = models
    tp = trainable(params_from_numpy(jax.device_get(jp), tm.cfg, "cpu"))
    jb, tb = _batches(*_inputs(2, 16, 16, seed=2))
    (jl, _), jg = jax.jit(jax.value_and_grad(lambda p: jm.loss(p, jb),
                                             has_aux=True))(jp)
    tl, _ = tm.loss(tp, tb)
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= F32
    want = dict(leaves_with_paths(jax.device_get(jg)))
    got = dict(leaves_with_paths(tp))
    assert sorted(got) == sorted(want)
    assert any("cross_attn" in p for p in got) and any(
        "encoder" in p for p in got)
    for path, p in got.items():
        g, w = _np(p.grad), np.asarray(want[path], np.float32)
        assert np.abs(g - w).max() <= F32 * np.abs(w).max(), path


def _prefilled(models, S_enc=20, cross=24):
    """Both packages prefilled with 6-token prompts over S_enc frames,
    into self strips of 32 and cross strips of `cross` positions."""
    jm, jp, tm, tp = models
    jb, tb = _batches(*_inputs(2, 6, S_enc, seed=3))
    jlp, jc, jlens = jax.jit(jm.prefill)(jp, jb,
                                         jm.init_cache(2, 32, enc_len=cross))
    tlp, tc, tlens = tm.prefill(tp, tb, tm.init_cache(2, 32, enc_len=cross))
    return (jlp, jc, jlens), (tlp, tc, tlens)


def test_prefill_matches_jax(models):
    (jlp, jc, jlens), (tlp, tc, tlens) = _prefilled(models)
    np.testing.assert_allclose(_np(tlp), _np(jlp), rtol=0, atol=F32)
    assert tlens.tolist() == np.asarray(jlens).tolist() == [6, 6]
    assert sorted(tc) == sorted(jc) == ["cross_k", "cross_v", "self_k",
                                        "self_v"]
    for name, t in tc.items():
        assert tuple(t.shape) == jc[name].shape, name
        np.testing.assert_allclose(_np(t), _np(jc[name]), rtol=0, atol=F32,
                                   err_msg=name)
    assert not tc["cross_k"][:, :, 20:].any()


@pytest.mark.parametrize("seq_parallel", [False, True])
def test_decode_steps_match_jax(models, seq_parallel):
    """8 steps after the prefill; the lanes attend 20 and 13 of the 24
    cross positions."""
    jm, jp, tm, tp = models
    (_, jc, jlens), (_, tc, tlens) = _prefilled(models)
    enc_lens = np.array([20, 13], np.int32)
    jstep = jax.jit(jm.decode_step, static_argnames=("seq_parallel",))
    rng = np.random.default_rng(4)
    for _ in range(8):
        nxt = rng.integers(0, 256, (2, 1)).astype(np.int32)
        jd, jc = jstep(jp, jnp.asarray(nxt), jlens, jc,
                       seq_parallel=seq_parallel,
                       enc_lens=jnp.asarray(enc_lens))
        td, tc = tm.decode_step(tp, torch.from_numpy(nxt), tlens, tc,
                                seq_parallel=seq_parallel,
                                enc_lens=torch.from_numpy(enc_lens))
        np.testing.assert_allclose(_np(td), _np(jd), rtol=0, atol=F32)
        jlens, tlens = jlens + 1, tlens + 1
    for name, t in tc.items():
        np.testing.assert_allclose(_np(t), _np(jc[name]), rtol=0, atol=F32,
                                   err_msg=name)


def test_audio_host_batch_matches_jax():
    jp = JaxDataPipeline(jax_smoke_config(ARCH),
                         JaxTrainConfig(global_batch=2, seq_len=16))
    tp = DataPipeline(get_smoke_config(ARCH),
                      TrainConfig(global_batch=2, seq_len=16), device="cpu")
    for step in (0, 3):
        want, got = jp.host_batch(step), tp.host_batch(step)
        assert sorted(got) == sorted(want) == ["audio_embeds", "tokens"]
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        dev = tp.device_batch(step)
        assert dev["tokens"].dtype == torch.int32
        assert dev["audio_embeds"].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            dev["audio_embeds"].float().numpy(),
            _np(jp.device_batch(step)["audio_embeds"]))


def test_engine_matches_jax(models):
    """Three prompts of 5, 3 and 7 tokens on 2 slots (the third reuses a
    freed slot), 6 new tokens each, greedy, dense cache, stepwise
    admission."""
    jm, jp, tm, tp = models
    kw = dict(max_batch=2, max_seq=32, max_new_tokens=6, paged=False,
              chunked=False)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, 256, n).tolist() for n in (5, 3, 7)]
    items = [TrafficItem(0, p) for p in prompts]
    j_eng = JaxServeEngine(jm, jp, JaxServeConfig(**kw))
    j_out, _ = replay(j_eng, items)
    t_eng = ServeEngine(tm, tp, ServeConfig(**kw))
    t_out, _ = replay(t_eng, items)
    assert t_out == j_out and len(t_out) == 3
    assert_same_accounting(j_eng, t_eng)
    assert {r.kind for r in t_eng.launch_records()} == {"stepwise",
                                                        "decode"}


@pytest.mark.parametrize("kw", [dict(paged=True),
                                dict(paged=True, chunked=True),
                                dict(paged=True, chunked=True,
                                     speculative=True)])
def test_engine_refuses_paged_chunked_and_speculative_audio(models, kw):
    _, _, tm, tp = models
    with pytest.raises(ValueError, match="attention family"):
        ServeEngine(tm, tp, ServeConfig(max_batch=2, max_seq=32,
                                        page_size=16, prefill_chunk=16,
                                        tick_token_budget=64, **kw))


def test_trainer_step_matches_jax(models, tmp_path):
    """One step of the port's Trainer, its state replaced by the JAX init
    state, against the JAX train step on the JAX pipeline's batch of the
    same step (audio frames in bfloat16 on both sides)."""
    jm, _, tm, _ = models
    kw = dict(global_batch=2, seq_len=16, learning_rate=1e-3,
              warmup_steps=1, total_steps=4, log_every=1, remat="full")
    jtcfg = JaxTrainConfig(**kw)
    jstate = j_init_train_state(jm, jax.random.PRNGKey(0), jtcfg)
    host = jax.device_get(jstate)
    batch = JaxDataPipeline(jm.cfg, jtcfg).device_batch(0)
    _, out = jax.jit(j_make_train_step(jm, jtcfg))(jstate, batch)
    tr = Trainer(tm.cfg, TrainConfig(checkpoint_dir=str(tmp_path), **kw),
                 device="cpu")
    tr.state = train_state_from_numpy(host.params, host.opt, host.ef,
                                      tm.cfg, "cpu")
    got = tr.run(n_steps=1)["metrics"][0]
    assert got["step"] == 0
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[k], float(out[k]), rtol=TRAIN_REL,
                                   err_msg=k)
    np.testing.assert_allclose(got["lr"], float(out["lr"]), rtol=F32)
