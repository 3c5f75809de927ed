"""The vision-language family (M13) of the port against the JAX package on
the CPU, at the llava-next-34b smoke config (2 layers, d_model 64, 4 / 2
heads of 16, 8 image positions, vocab 256), in float32 and bfloat16, with
the JAX Model.init weights carried over and every input made by numpy
from a seed.

The configs field for field and their parameter counts; Model.forward
with and without the image (batch["vision_embeds"], the frontend stub's
patch embeddings, ahead of the text); the loss, ce and every gradient
(the image positions' logits dropped); the dense prefill with images and
4 decode steps - logits, lens (image positions included) and both
strips - unpadded and with prompts padded past their real length
(true_lens), where the last logit lies image-many positions after the
text's last real token; the vlm host batch of the data pipeline and
its device dtypes; three Trainer steps against three JAX train steps
on numpy-seeded batches; the engine serving the smoke model (paged +
chunked + batched, monolithic on the dense cache, speculative: text
only, as in the JAX engine, ROADMAP §3), its greedy outputs, launch
records and counters.

Bars (the two frameworks sum the projections and einsums in other
orders): float32 logits, strips and the loss 1e-5 absolute, each gradient
leaf within 1e-5 of its largest |entry|, the Trainer's loss and grad norm
1e-5 relative (tests/test_torch_train.py's bars); bfloat16 logits, loss
and gradients 2e-2 (the two frameworks round bf16 activations at other
places: tests/test_torch_train.py saw 1.5e-2 on the gradients).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import ServeConfig as JaxServeConfig
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.data.pipeline import DataPipeline as JaxDataPipeline
from repro.models import build_model as jax_build_model
from repro.serve import ServeEngine as JaxServeEngine
from repro.train import init_train_state as j_init_train_state
from repro.train import make_train_step as j_make_train_step
from repro_torch.configs import (ServeConfig, TrainConfig, get_config,
                                 get_smoke_config)
from repro_torch.data import DataPipeline
from repro_torch.models import build_model
from repro_torch.models.convert import (params_from_numpy,
                                        train_state_from_numpy)
from repro_torch.serve import ServeEngine
from repro_torch.train import trainable
from repro_torch.train.trainer import Trainer
from repro_torch.tree import leaves_with_paths
from torch_replay import (assert_pages_conserved, assert_same_accounting,
                          one_torch_thread)
from traffic import TrafficItem, assert_greedy_equivalent, replay

ARCH = "llava-next-34b"
P = 8                                   # the smoke config's image positions
BARS = {"float32": 1e-5, "bfloat16": 2e-2}

_one_thread = pytest.fixture(scope="module", autouse=True)(one_torch_thread)


def _models(dtype):
    jcfg = jax_smoke_config(ARCH).replace(dtype=dtype)
    cfg = get_smoke_config(ARCH).replace(dtype=dtype)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(cfg, device="cpu")
    return jm, jp, tm, params_from_numpy(jax.device_get(jp), cfg, "cpu")


@pytest.fixture(scope="module")
def models():
    return _models("float32")


@pytest.fixture(scope="module")
def models16():
    return _models("bfloat16")


def _np(x):
    return x.detach().float().numpy() if torch.is_tensor(x) \
        else np.asarray(jnp.asarray(x, jnp.float32))


def _inputs(B, S, seed=0):
    """(tokens (B, S) int32, images (B, P, 64) float32 at the pipeline's
    0.02 scale)."""
    rng = np.random.default_rng(seed)
    return (rng.integers(1, 256, (B, S)).astype(np.int32),
            (rng.standard_normal((B, P, 64)) * 0.02).astype(np.float32))


def _batches(toks, images=None, **extra):
    """The same batch for both packages; images None: text only."""
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if images is not None:
        jb["vision_embeds"] = jnp.asarray(images)
        tb["vision_embeds"] = torch.from_numpy(images)
    for k, v in extra.items():
        jb[k], tb[k] = jnp.asarray(v), torch.from_numpy(v)
    return jb, tb


@pytest.mark.parametrize("smoke", [False, True])
def test_configs_match_jax(smoke):
    get, jget = (get_smoke_config, jax_smoke_config) if smoke \
        else (get_config, jax_config)
    cfg, jcfg = get(ARCH), jget(ARCH)
    want = dataclasses.asdict(jcfg)
    assert dataclasses.asdict(cfg) == {k: want[k] for k in
                                       dataclasses.asdict(cfg)}
    assert (cfg.family, cfg.frontend, cfg.frontend_tokens) == (
        "vlm", "vision", P if smoke else 576)
    assert cfg.param_count() == jcfg.param_count()
    if not smoke:
        assert cfg.param_count() == 34_388_049_920


def test_model_builds_the_dense_tree_with_its_lm_head(models):
    jm, jp, tm, tp = models
    got = sorted(p for p, _ in leaves_with_paths(tp))
    assert got == sorted(p for p, _ in leaves_with_paths(
        jax.device_get(jp)))
    assert "tok/lm_head" in got and "blocks/mlp/w_gate" in got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("images", [True, False])
def test_forward_matches_jax(models, models16, dtype, images):
    jm, jp, tm, tp = models if dtype == "float32" else models16
    toks, img = _inputs(2, 12, seed=1)
    jb, tb = _batches(toks, img if images else None)
    jl, _ = jax.jit(jm.forward)(jp, jb)
    tl, taux = tm.forward(tp, tb)
    assert tl.dtype == torch.float32
    assert tl.shape == (2, 12 + P * images, 256) and float(taux) == 0.0
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=0, atol=BARS[dtype])


def test_image_moves_the_text_logits(models):
    """The text's logits with the image differ from those without by far
    more than the bar: the image is not dropped."""
    _, _, tm, tp = models
    toks, img = _inputs(2, 12, seed=1)
    with_img = tm.forward(tp, _batches(toks, img)[1])[0][:, P:]
    without = tm.forward(tp, _batches(toks)[1])[0]
    assert float((with_img - without).abs().max()) > 1e3 * BARS["float32"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_jax(models, models16, dtype):
    jm, jp, _, _ = models if dtype == "float32" else models16
    tm = (models if dtype == "float32" else models16)[2]
    tp = trainable(params_from_numpy(jax.device_get(jp), tm.cfg, "cpu"))
    toks, img = _inputs(2, 16, seed=2)
    jb, tb = _batches(toks, img)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(lambda p: jm.loss(p, jb),
                                                has_aux=True))(jp)
    tl, tmet = tm.loss(tp, tb)
    tl.backward()
    bar = BARS[dtype]
    assert abs(float(tl.detach()) - float(jl)) <= bar
    assert abs(float(tmet["ce"].detach()) - float(jmet["ce"])) <= bar
    want = dict(leaves_with_paths(jax.device_get(jg)))
    got = dict(leaves_with_paths(tp))
    assert sorted(got) == sorted(want)
    for path, p in got.items():
        assert p.grad is not None and p.grad.dtype == p.dtype, path
        g, w = _np(p.grad), np.asarray(want[path], np.float32)
        assert np.abs(g - w).max() <= bar * np.abs(w).max(), path


@pytest.mark.parametrize("padded", [False, True])
def test_prefill_and_decode_match_jax(models, padded):
    """Two prompts of 16 text tokens behind 8 image positions into strips
    of 40, then 4 decode steps: logits, lens and both strips.  Padded:
    the rows hold 11 and 16 real tokens (true_lens), so the first row's
    last logit is that of position 8 + 11 - 1 and its decode writes from
    position 19."""
    jm, jp, tm, tp = models
    toks, img = _inputs(2, 16, seed=3)
    tl_ = np.array([11, 16] if padded else [16, 16], np.int32)
    toks[0, tl_[0]:] = 0
    extra = {"true_lens": tl_} if padded else {}
    jb, tb = _batches(toks, img, **extra)
    jlp, jc, jlens = jax.jit(jm.prefill)(jp, jb, jm.init_cache(2, 40))
    tlp, tc, tlens = tm.prefill(tp, tb, tm.init_cache(2, 40))
    np.testing.assert_allclose(_np(tlp), _np(jlp), rtol=0, atol=BARS[
        "float32"])
    assert tlens.dtype == torch.int32
    assert tlens.tolist() == np.asarray(jlens).tolist() == (tl_ + P).tolist()
    # the row alone, cut to its real length, has the same last logits
    alone, _, lens0 = tm.prefill(tp, _batches(toks[:1, :tl_[0]], img[:1])[1],
                                 tm.init_cache(1, 40))
    assert lens0.tolist() == [tl_[0] + P]
    np.testing.assert_allclose(_np(tlp[:1]), _np(alone), rtol=0,
                               atol=BARS["float32"])
    jstep = jax.jit(jm.decode_step)
    rng = np.random.default_rng(4)
    for _ in range(4):
        nxt = rng.integers(1, 256, (2, 1)).astype(np.int32)
        jd, jc = jstep(jp, jnp.asarray(nxt), jlens, jc)
        td, tc = tm.decode_step(tp, torch.from_numpy(nxt), tlens, tc)
        np.testing.assert_allclose(_np(td), _np(jd), rtol=0,
                                   atol=BARS["float32"])
        jlens, tlens = jlens + 1, tlens + 1
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), rtol=0,
                                   atol=BARS["float32"], err_msg=name)


def test_host_batch_matches_jax():
    jcfg, cfg = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    jp = JaxDataPipeline(jcfg, JaxTrainConfig(global_batch=2, seq_len=24))
    tp = DataPipeline(cfg, TrainConfig(global_batch=2, seq_len=24),
                      device="cpu")
    for step in (0, 3, 17):
        want, got = jp.host_batch(step), tp.host_batch(step)
        assert sorted(got) == sorted(want) == ["tokens", "vision_embeds"]
        assert got["tokens"].shape == (2, 24 - P)
        assert got["vision_embeds"].shape == (2, P, 64)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        dev, jdev = tp.device_batch(step), jp.device_batch(step)
        assert dev["tokens"].dtype == torch.int32
        assert dev["vision_embeds"].dtype == torch.bfloat16
        assert str(jdev["vision_embeds"].dtype) == "bfloat16"
        np.testing.assert_array_equal(dev["vision_embeds"].float().numpy(),
                                      _np(jdev["vision_embeds"]))


def test_trainer_steps_match_jax(models, tmp_path):
    """Three steps of the port's Trainer, its state the JAX init state, on
    numpy-seeded batches (the pipelines seed by Python's per-process
    hash: ROADMAP §3), images in bfloat16 as the pipeline hands them
    over, against three JAX train steps: loss, ce, grad norm and lr of
    every step."""
    jm, _, tm, _ = models
    kw = dict(global_batch=2, seq_len=16 + P, learning_rate=1e-3,
              warmup_steps=1, total_steps=6, log_every=1, remat="full")
    jtcfg = JaxTrainConfig(**kw)
    jstate = j_init_train_state(jm, jax.random.PRNGKey(0), jtcfg)
    host = jax.device_get(jstate)
    batches = [_batches(*_inputs(2, 16, seed=10 + i)) for i in range(3)]
    for _, tb in batches:
        tb["vision_embeds"] = tb["vision_embeds"].to(torch.bfloat16)
    jstep = jax.jit(j_make_train_step(jm, jtcfg))
    want = []
    for jb, _ in batches:
        jb["vision_embeds"] = jb["vision_embeds"].astype(jnp.bfloat16)
        jstate, out = jstep(jstate, jb)
        want.append({k: float(v) for k, v in out.items()})
    tr = Trainer(tm.cfg, TrainConfig(checkpoint_dir=str(tmp_path), **kw),
                 device="cpu")
    tr.state = train_state_from_numpy(host.params, host.opt, host.ef,
                                      tm.cfg, "cpu")
    tr.pipeline.device_batch = lambda step: batches[step][1]
    got = tr.run(n_steps=3)["metrics"]
    assert [m["step"] for m in got] == [0, 1, 2]
    for g, w in zip(got, want):
        for k in ("loss", "ce", "grad_norm", "lr"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)


ENGINES = {
    "paged_chunked_batched": dict(paged=True, chunked=True, batched=True),
    "dense_monolithic": dict(paged=False, chunked=False),
    "speculative": dict(paged=True, chunked=True, batched=True,
                        speculative=True, spec_k=3, spec_ngram=2)}


@pytest.mark.parametrize("engine", list(ENGINES))
def test_engine_matches_jax(models, engine):
    """Three text prompts of 11, 23 and 30 tokens (each a repeated 5-gram,
    so the drafter finds matches) on 2 slots - the third reuses a freed
    slot - 6 new tokens each, greedy: outputs, launch records and every
    counter equal to the JAX engine's."""
    jm, jp, tm, tp = models
    kw = dict(max_batch=2, max_seq=48, max_new_tokens=6, page_size=8,
              prefill_chunk=16, tick_token_budget=20, **ENGINES[engine])
    rng = np.random.default_rng(7)
    prompts = [(rng.integers(1, 256, 5).tolist() * 6)[:n]
               for n in (11, 23, 30)]
    items = lambda: [TrafficItem(0, list(p)) for p in prompts]
    j_eng = JaxServeEngine(jm, jp, JaxServeConfig(**kw))
    j_out, _ = replay(j_eng, items())
    t_eng = ServeEngine(tm, tp, ServeConfig(**kw))
    t_out, t_done = replay(t_eng, items())
    assert len(t_out) == 3
    if t_out != j_out:
        assert_greedy_equivalent(jm, jp, t_done, j_out)
    assert_same_accounting(j_eng, t_eng)
    assert_pages_conserved(t_eng)
    kinds = {r.kind for r in t_eng.launch_records()}
    assert kinds >= {"paged_chunked_batched": {"chunk_batch", "decode"},
                     "dense_monolithic": {"prefill", "decode"}}.get(
        engine, {"spec_verify"}), kinds
