"""The port's training path against the JAX package on the CPU: AdamW, the
global-norm clip, the cosine schedule and int8 compression on the same
numpy trees; the data pipeline's batches; Model.loss and its gradients;
and whole train steps from a converted JAX TrainState.

Bars:
- optimizer pieces, float32: 1e-6 absolute (the same operations in the
  same order; the frameworks may still fuse a multiply-add differently).
- data: the same arrays, bit for bit (the port copies SyntheticCorpus).
- loss and gradients on the granite-3-2b smoke config: float32 loss 1e-5
  absolute and each leaf's gradient within 1e-5 of its largest |entry|
  (seen: 5e-7 and 1.5e-6 - XLA and ATen sum the projections in other
  orders); bfloat16 2e-2, both (seen: 2.5e-4 on the loss, 1.5e-2 on the
  gradients - the two frameworks round the bf16 activations at other
  places).
- three train steps, float32, each from the same state on both sides:
  loss, grad_norm and lr within 1e-5 relative; parameters within 1e-5
  absolute and m / v within 1e-5 of each leaf's largest |entry|; with
  int8 compression the entries at a rounding boundary of the quantizer
  may differ by one quantum's effect, for the reason
  test_train_steps_match_jax gives.  The port with remat on and off: the
  same bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.data.pipeline import DataPipeline as JaxDataPipeline
from repro.models import build_model as jax_build_model
from repro.optim import (adamw_init as j_adamw_init,
                         adamw_update as j_adamw_update,
                         clip_by_global_norm as j_clip,
                         compress_grads as j_compress,
                         compressed_bytes as j_compressed_bytes,
                         cosine_schedule as j_cosine, ef_init as j_ef_init,
                         global_norm as j_global_norm)
from repro.train import init_train_state as j_init_train_state
from repro.train import make_train_step as j_make_train_step
from repro_torch.configs import TrainConfig, get_smoke_config
from repro_torch.data import DataPipeline
from repro_torch.models import build_model
from repro_torch.models.convert import (params_from_numpy,
                                        train_state_from_numpy)
from repro_torch.optim import (adamw_init, adamw_update, clip_by_global_norm,
                               compress_grads, compressed_bytes,
                               cosine_schedule, ef_init, global_norm)
from repro_torch.train import make_train_step, trainable
from repro_torch.tree import leaves_with_paths


def _tree(seed=0, scale=1.0):
    """A small parameter-like tree: a stacked 3-d leaf (updated layer by
    layer), a 2-d and a 1-d leaf."""
    rng = np.random.default_rng(seed)
    return {"blocks": {"w": (rng.standard_normal((3, 4, 5)) * scale
                             ).astype(np.float32),
                       "n": (rng.standard_normal((3, 5)) * scale
                             ).astype(np.float32)},
            "emb": (rng.standard_normal((7,)) * scale).astype(np.float32)}


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True))


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _assert_trees(port, ref, atol):
    want = dict(leaves_with_paths(jax.device_get(ref)))
    got = dict(leaves_with_paths(port))
    assert sorted(got) == sorted(want)
    for path, t in got.items():
        np.testing.assert_allclose(t.detach().float().numpy(),
                                   np.asarray(want[path], np.float32),
                                   atol=atol, rtol=0, err_msg=path)


def test_norm_clip_and_adamw_match_jax():
    params = _tree(0)
    jp, tp = _jax_tree(params), _torch_tree(params)
    jst, tst = j_adamw_init(jp), adamw_init(tp)
    assert tst.step.dtype == torch.int32 and tst.step.dim() == 0
    for step in range(3):
        g = _tree(10 + step, scale=3.0)
        jg, tg = _jax_tree(g), _torch_tree(g)
        np.testing.assert_allclose(float(global_norm(tg)),
                                   float(j_global_norm(jg)), rtol=1e-6)
        jg, jn = j_clip(jg, 1.0)
        tg, tn = clip_by_global_norm(tg, 1.0)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        _assert_trees(tg, jg, 1e-6)
        lr = j_cosine(jst.step, base_lr=1e-2, warmup=1, total=10)
        tlr = cosine_schedule(tst.step, base_lr=1e-2, warmup=1, total=10)
        np.testing.assert_allclose(float(tlr), float(lr), rtol=1e-6)
        jp, jst = j_adamw_update(jg, jst, jp, lr=lr)
        tp, tst = adamw_update(tg, tst, tp, lr=tlr)
        assert int(tst.step) == int(jst.step) == step + 1
        _assert_trees(tp, jp, 1e-6)
        _assert_trees(tst.m, jst.m, 1e-6)
        _assert_trees(tst.v, jst.v, 1e-6)


@pytest.mark.parametrize("step", [0, 3, 10, 55, 100, 150])
def test_cosine_schedule_matches_jax(step):
    kw = dict(base_lr=3e-4, warmup=10, total=100)
    want = float(j_cosine(jnp.array(step, jnp.int32), **kw))
    got = cosine_schedule(torch.tensor(step, dtype=torch.int32), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-12)


def test_int8_compression_matches_jax():
    g0 = _tree(2)
    jef, tef = j_ef_init(_jax_tree(g0)), ef_init(_torch_tree(g0))
    for step in range(3):
        g = _tree(20 + step)
        jg, jef = j_compress(_jax_tree(g), jef)
        tg, tef = compress_grads(_torch_tree(g), tef)
        _assert_trees(tg, jg, 1e-6)
        _assert_trees(tef, jef, 1e-6)
    assert compressed_bytes(_torch_tree(g0)) == \
        j_compressed_bytes(_jax_tree(g0))


def test_host_batches_match_jax():
    jcfg = jax_smoke_config("granite-3-2b")
    cfg = get_smoke_config("granite-3-2b")
    jp = JaxDataPipeline(jcfg, JaxTrainConfig(global_batch=4, seq_len=32))
    tp = DataPipeline(cfg, TrainConfig(global_batch=4, seq_len=32),
                      device="cpu")
    for step in (0, 5, 17):
        want, got = jp.host_batch(step), tp.host_batch(step)
        assert sorted(got) == sorted(want) == ["tokens"]
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        dev = tp.device_batch(step)["tokens"]
        assert dev.dtype == torch.int32 and dev.device.type == "cpu"
        np.testing.assert_array_equal(dev.numpy(), want["tokens"])
    tp.start(3)
    assert [tp.next()[0] for _ in range(3)] == [3, 4, 5]
    tp.stop()
    # the vlm batch: seq_len - frontend_tokens text tokens and the seeded
    # image embeddings, the same arrays in both packages
    jv = JaxDataPipeline(jax_smoke_config("llava-next-34b"),
                         JaxTrainConfig(global_batch=2, seq_len=32))
    tv = DataPipeline(get_smoke_config("llava-next-34b"),
                      TrainConfig(global_batch=2, seq_len=32), device="cpu")
    want, got = jv.host_batch(4), tv.host_batch(4)
    assert sorted(got) == sorted(want) == ["tokens", "vision_embeds"]
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _models(dtype):
    jcfg = jax_smoke_config("granite-3-2b").replace(dtype=dtype)
    cfg = get_smoke_config("granite-3-2b").replace(dtype=dtype)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(cfg, device="cpu")
    tp = trainable(params_from_numpy(jax.device_get(jp), cfg, "cpu"))
    return jm, jp, tm, tp


# dtype -> (loss bar, gradient bar relative to each leaf's max |grad|)
LOSS_BARS = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 2e-2)}


@pytest.mark.parametrize("dtype,masked", [("float32", False),
                                          ("float32", True),
                                          ("bfloat16", False)])
def test_loss_and_grads_match_jax(dtype, masked):
    jm, jp, tm, tp = _models(dtype)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 256, (2, 32)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if masked:
        mask = (rng.random((2, 32)) > 0.3).astype(np.float32)
        jb["loss_mask"], tb["loss_mask"] = (jnp.asarray(mask),
                                            torch.from_numpy(mask))
    (jl, jmet), jg = jax.value_and_grad(lambda p: jm.loss(p, jb),
                                        has_aux=True)(jp)
    tl, tmet = tm.loss(tp, tb)
    tl.backward()
    loss_bar, grad_bar = LOSS_BARS[dtype]
    assert abs(float(tl.detach()) - float(jl)) <= loss_bar
    assert abs(float(tmet["ce"].detach()) - float(jmet["ce"])) <= loss_bar
    assert float(tmet["aux"]) == float(jmet["aux"]) == 0.0
    want = dict(leaves_with_paths(jax.device_get(jg)))
    for path, p in leaves_with_paths(tp):
        assert p.grad is not None and p.grad.dtype == p.dtype, path
        g, w = p.grad.float().numpy(), np.asarray(want[path], np.float32)
        rel = np.abs(g - w).max() / np.abs(w).max()
        assert rel <= grad_bar, (path, rel)


TCFG = dict(global_batch=2, seq_len=32, learning_rate=1e-3, warmup_steps=1,
            total_steps=10)
# the int8 quantizer's input e / scale moves by at most this between the
# packages: e = the clipped gradient + ef, whose entries agree within 1e-5
# of the leaf's largest |entry| (test_loss_and_grads_match_jax), and scale
# = max|e| / 127 within the same, each moving e / scale by up to 127e-5
QUANT_MARGIN = 2 * 127e-5


def _batches(vocab):
    """Three batches seeded by numpy: the same in every process (the
    pipeline's are hash-seeded, ROADMAP §3)."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, (TCFG["global_batch"], TCFG["seq_len"]))
            .astype(np.int32) for _ in range(3)]


def _run_port(jstate, cfg, tcfg, batches):
    state = train_state_from_numpy(jstate.params, jstate.opt, jstate.ef, cfg,
                                   "cpu")
    model = build_model(cfg, device="cpu")
    step = make_train_step(model, tcfg)
    outs = []
    for b in batches:
        state, out = step(state, {"tokens": torch.from_numpy(b)})
        outs.append({k: float(v) for k, v in out.items()})
    return state, outs


def _quantizer_inputs(jm, jstate, batch, jtcfg):
    """path -> (e, quantum) of the JAX step's int8 quantizer from this state
    and batch: e = the clipped gradient + ef, quantum = max|e| / 127."""
    remat = jtcfg.remat != "none"

    @jax.jit
    def clipped(params):
        g, _ = jax.grad(lambda p: jm.loss(p, {"tokens": batch}, remat=remat),
                        has_aux=True)(params)
        return j_clip(g, jtcfg.grad_clip)[0]

    g = dict(leaves_with_paths(jax.device_get(clipped(jstate.params))))
    ef = dict(leaves_with_paths(jax.device_get(jstate.ef)))
    out = {}
    for path, gl in g.items():
        e = np.asarray(gl, np.float32) + np.asarray(ef[path], np.float32)
        out[path] = (e, np.float32(max(np.abs(e).max(), 1e-12) / 127.0))
    return out


@pytest.mark.parametrize("remat,compression", [("none", ""), ("full", ""),
                                               ("none", "int8")])
def test_train_steps_match_jax(remat, compression):
    """Three train steps (float32) on numpy-seeded batches, each started on
    both sides from the same state - the JAX run's, converted - so no
    difference carries from one step into the next: per-step metrics
    within 1e-5 relative, then params within 1e-5 absolute, m and v within
    1e-5 of each leaf's largest |entry|, ef within 1e-5 of the quantizer
    input's.
    With int8 compression the quantizer rounds e / quantum to the nearest
    integer (e = the clipped gradient + ef).  Where the JAX side's e /
    quantum lies within QUANT_MARGIN of a rounding boundary (a half
    integer), the two packages' inputs may fall on either side of it and
    round one quantum apart; there, and only there, ef may differ by one
    quantum, m by (1 - b1) quanta, v by (1 - b2) (2|e| + quantum) quanta
    and the parameter by up to 2 lr - every other entry holds the bars
    above.  The port with remat on and off: the same bits."""
    jcfg = jax_smoke_config("granite-3-2b").replace(dtype="float32")
    cfg = get_smoke_config("granite-3-2b").replace(dtype="float32")
    jtcfg = JaxTrainConfig(remat=remat, grad_compression=compression, **TCFG)
    tcfg = TrainConfig(remat=remat, grad_compression=compression, **TCFG)
    jm = jax_build_model(jcfg)
    jstate = j_init_train_state(jm, jax.random.PRNGKey(0), jtcfg)
    host0 = jax.device_get(jstate)
    batches = _batches(cfg.vocab_size)
    jstep = jax.jit(j_make_train_step(jm, jtcfg))
    for b in batches:
        host = jax.device_get(jstate)
        quant = _quantizer_inputs(jm, jstate, jnp.asarray(b), jtcfg) \
            if compression else {}
        jstate, out = jstep(jstate, {"tokens": jnp.asarray(b)})
        want = {k: float(v) for k, v in out.items()}
        state, (got,) = _run_port(host, cfg, tcfg, [b])
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-7, err_msg=k)
        lr = want["lr"]
        trees = {"params": (state.params, jstate.params),
                 "m": (state.opt.m, jstate.opt.m),
                 "v": (state.opt.v, jstate.opt.v)}
        if compression:
            trees["ef"] = (state.ef, jstate.ef)
        for name, (port, ref) in trees.items():
            jt = dict(leaves_with_paths(jax.device_get(ref)))
            for path, t in leaves_with_paths(port):
                arr, w = t.detach().numpy(), np.asarray(jt[path])
                err = np.abs(arr - w)
                bar = {"params": 1e-5,
                       "ef": 1e-5 * 127 * quant.get(path, (0, 0))[1]}.get(
                    name, 1e-5 * np.abs(w).max())
                near = np.zeros(arr.shape, bool)
                if compression:
                    e, qu = quant[path]
                    t_in = e / qu
                    near = np.abs(t_in - np.floor(t_in) - 0.5) \
                        <= QUANT_MARGIN
                    flip = {"params": 2 * lr, "ef": qu,
                            "m": (1 - tcfg.b1) * qu,
                            "v": (1 - tcfg.b2) * (2 * np.abs(e) + qu) * qu
                            }[name]
                    assert (err[near] <= (bar + flip if np.ndim(flip) == 0
                                          else bar + flip[near])).all(), (
                        name, path, "at a rounding boundary")
                assert (err[~near] <= bar).all(), (
                    name, path, int((err[~near] > bar).sum()),
                    float(err[~near].max()))
    assert int(state.opt.step) == int(jstate.opt.step) == 3
    if remat == "full":
        # the port with remat on and off from the same state: the same bits
        on, got_on = _run_port(host0, cfg, tcfg, batches)
        off, got_off = _run_port(host0, cfg, TrainConfig(**TCFG), batches)
        assert got_off == got_on
        for (_, a), (_, b) in zip(leaves_with_paths(off),
                                  leaves_with_paths(on)):
            assert torch.equal(a, b)
