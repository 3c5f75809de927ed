"""The port's recurrent families against the JAX package on the CPU: the
hybrid zamba2 (Mamba2 layers with a shared attention block) and the RWKV6
rwkv6, at their smoke configs, with the weights of the JAX Model.init tree
carried over by repro_torch.models.convert.

Model: forward logits, prefill then three decode steps (logits and every
cache leaf), init_cache's shapes and dtypes, one train step (loss, gradient
norm, learning rate and the updated parameters).  Engine: three prompts of
5, 3 and 7 tokens through two slots (so one slot is reused), six new
tokens each, greedy.  The port's outputs must equal those of the JAX
engine serving each request alone (a fresh engine with max_batch=1 per
request: its stepwise admission then has no other lane to disturb and no
used slot to reuse) and the greedy continuation by Model.forward; the
host counters must equal the JAX batched engine's (they do not depend on
the state).  The JAX batched engine's own outputs are not compared: its
stepwise admission advances the other lanes' recurrent state and keeps a
reused slot's old state (ROADMAP section 3).

Bars, float32 (the two frameworks sum the projections and the scans'
einsums in other orders): forward logits 1e-5 absolute (seen 3e-6); the
train step's loss and lr 1e-5 relative.  The zamba2 smoke model amplifies
float32 rounding - in the JAX package alone, its chunked and its naive
scans give gradients up to 1.4e-4 apart (relative to each leaf's largest
entry) - so after prefill and decode steps the logits are held to 5e-5
absolute (seen 1.3e-5), the cache leaves to 2e-4 of their largest |entry|
(seen 4.9e-5, the SSM state), and the step's gradient norm to 2e-4
relative (seen 4.1e-5).  bfloat16 logits, mixed-dtype trees: the two
frameworks round the bf16 activations at other places, and at the zamba2
smoke config that moves the logits by up to 0.21 in the JAX package
alone (its bf16 forward against its float32 forward on the same
bf16-valued weights; rwkv6 0.026); so the port's bf16 logits must lie
within that distance of the JAX package's bf16 logits (seen 0.065 and
0.013).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import ServeConfig as JaxServeConfig
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.models import build_model as jax_build_model
from repro.serve import ServeEngine as JaxServeEngine
from repro.train import init_train_state as j_init_train_state
from repro.train import make_train_step as j_make_train_step
from repro_torch.configs import (ServeConfig, TrainConfig, get_config,
                                 get_smoke_config)
from repro_torch.models import build_model
from repro_torch.models.convert import (params_from_numpy,
                                        train_state_from_numpy)
from repro_torch.serve import ServeEngine
from repro_torch.train import make_train_step
from repro_torch.tree import leaves_with_paths

ARCHS = ["zamba2-2.7b", "rwkv6-1.6b"]
F32_REL = 1e-5
STEP_BAR = 5e-5          # logits after prefill and decode steps
STATE_BAR = 2e-4         # cache leaves, of their largest |entry|
GRAD_NORM_BAR = 2e-4     # relative


def _models(arch, dtype="float32"):
    jcfg = jax_smoke_config(arch).replace(dtype=dtype)
    tcfg = get_smoke_config(arch).replace(dtype=dtype)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, device="cpu")
    return jm, jp, tm, params_from_numpy(jax.device_get(jp), tcfg, "cpu")


def _np32(x):
    return x.float().numpy() if torch.is_tensor(x) \
        else np.asarray(jnp.asarray(x, jnp.float32))


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch, dtype):
    """bfloat16 carries the mixed tree across: the float32 leaves (A_log,
    dt_bias; w_base, u) stay float32 in both packages."""
    jm, jp, tm, tp = _models(arch, dtype)
    toks = _tokens((2, 37))
    jl, jaux = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    tl, taux = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    assert tl.dtype == torch.float32 and tl.shape == (2, 37, 256)
    assert float(taux) == float(jaux) == 0.0
    bar = 1e-5
    if dtype == "bfloat16":
        jm32 = jax_build_model(jax_smoke_config(arch).replace(
            dtype="float32"))
        jp32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
        jl32, _ = jm32.forward(jp32, {"tokens": jnp.asarray(toks)})
        bar = float(np.abs(_np32(jl) - _np32(jl32)).max())
    np.testing.assert_allclose(_np32(tl), _np32(jl), rtol=0, atol=bar)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_match_jax(arch):
    jm, jp, tm, tp = _models(arch)
    toks = _tokens((2, 21), seed=1)
    jc, tc = jm.init_cache(2, 32), tm.init_cache(2, 32)
    jlp, jc, jlens = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jc)
    tlp, tc, tlens = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc)
    np.testing.assert_allclose(_np32(tlp), _np32(jlp), rtol=0,
                               atol=STEP_BAR)
    assert tlens.tolist() == np.asarray(jlens).tolist() == [21, 21]
    rng = np.random.default_rng(2)
    for _ in range(3):
        nxt = rng.integers(0, 256, (2, 1)).astype(np.int32)
        jd, jc = jm.decode_step(jp, jnp.asarray(nxt), jlens, jc)
        td, tc = tm.decode_step(tp, torch.from_numpy(nxt), tlens, tc)
        np.testing.assert_allclose(_np32(td), _np32(jd), rtol=0,
                                   atol=STEP_BAR)
        jlens, tlens = jlens + 1, tlens + 1
    assert sorted(tc) == sorted(jc)
    for name in tc:
        want = _np32(jc[name])
        err = np.abs(_np32(tc[name]) - want).max() / np.abs(want).max()
        assert err <= STATE_BAR, (name, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_jax(arch):
    jm = jax_build_model(jax_smoke_config(arch))
    tm = build_model(get_smoke_config(arch), device="cpu")
    jc, tc = jm.init_cache(3, 40), tm.init_cache(3, 40)
    assert sorted(tc) == sorted(jc)
    for name, t in tc.items():
        assert tuple(t.shape) == jc[name].shape, name
        assert str(t.dtype).split(".")[-1] == str(jc[name].dtype), name
        assert not t.any(), name


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    """One train step from one JAX TrainState, converted, on a numpy
    batch: loss and lr within 1e-5 relative, grad_norm within
    GRAD_NORM_BAR.  On the CPU the scans are the chunked plain versions,
    differentiated by autograd, as JAX differentiates its jnp scans."""
    kw = dict(global_batch=2, seq_len=24, learning_rate=1e-3,
              warmup_steps=1, total_steps=10)
    jm = jax_build_model(jax_smoke_config(arch).replace(dtype="float32"))
    jstate = j_init_train_state(jm, jax.random.PRNGKey(0),
                                JaxTrainConfig(**kw))
    host = jax.device_get(jstate)
    batch = _tokens((2, 24), seed=3)
    jstate, want = jax.jit(j_make_train_step(jm, JaxTrainConfig(**kw)))(
        jstate, {"tokens": jnp.asarray(batch)})
    cfg = get_smoke_config(arch).replace(dtype="float32")
    state = train_state_from_numpy(host.params, host.opt, host.ef, cfg,
                                   "cpu")
    step = make_train_step(build_model(cfg, device="cpu"), TrainConfig(**kw))
    state, got = step(state, {"tokens": torch.from_numpy(batch)})
    for k, bar in (("loss", F32_REL), ("grad_norm", GRAD_NORM_BAR),
                   ("lr", F32_REL)):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=bar,
                                   err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("device", ["cuda", "meta"])
def test_trainer_refuses_the_scans_off_the_cpu(arch, device):
    """Nothing refuses zamba2 or rwkv6 off the CPU any more: the scans'
    gradients are their backward kernels (csrc/mamba2_scan_bwd.cu,
    csrc/rwkv6_scan_bwd.cu) and K5 takes zamba2's head dim 80, so
    check_backward passes both families on the card and the meta device.
    On a machine without a GPU the Trainer and the launcher get past it
    and fail only at the device (building the model), with no kernel
    launch counted; on the meta device the train step runs (remat full)
    and costs each scan twice a layer (forward and recompute) and its
    backward kernel once, through ops._Scan."""
    from repro_torch.kernels import mamba2_scan, rwkv6_scan
    from repro_torch.launch import cost
    from repro_torch.launch import train as train_launcher
    from repro_torch.optim import adamw_init
    from repro_torch.train.train_step import (TrainState, check_backward,
                                              trainable)
    from repro_torch.train.trainer import Trainer
    counts = (mamba2_scan.launches, mamba2_scan.bwd_launches,
              rwkv6_scan.launches, rwkv6_scan.bwd_launches)
    tcfg = TrainConfig(global_batch=1, seq_len=16, total_steps=1)
    cfgs = (get_smoke_config(arch).replace(head_dim=80), get_config(arch))
    for cfg in cfgs:
        check_backward(cfg, device)
    if device == "cuda":
        for cfg in cfgs:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                Trainer(cfg, tcfg, device=device)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_launcher.main(["--arch", arch, "--smoke", "--steps", "1"])
        # the smoke config's own head dim, 16, is K5's to refuse in
        # zamba2's shared block; rwkv6 has no attention
        if arch.startswith("zamba2"):
            with pytest.raises(NotImplementedError, match="K5.*head dim 16"):
                Trainer(get_smoke_config(arch), tcfg, device=device)
        else:
            check_backward(get_smoke_config(arch), device)
    else:
        cfg = cfgs[0]
        model = build_model(cfg, device="meta")
        params = trainable(model.params)
        state = TrainState(params, adamw_init(params), {})
        batch = {"tokens": torch.empty((2, 40), dtype=torch.int32,
                                       device="meta")}
        step = make_train_step(model, TrainConfig(
            global_batch=2, seq_len=40, total_steps=1, remat="full"))
        with cost.StepCost() as c:
            step(state, batch)
        calls = {k: v["calls"] for k, v in c.summary()["kernels"].items()}
        scan = "K6" if arch.startswith("zamba2") else "K7"
        L = cfg.n_layers
        assert calls[scan] == 2 * L and calls[f"{scan}_bwd"] == L, calls
    assert (mamba2_scan.launches, mamba2_scan.bwd_launches,
            rwkv6_scan.launches, rwkv6_scan.bwd_launches) == counts


# ===========================================================================
# the engine
# ===========================================================================

PROMPT_LENS = (5, 3, 7)
NEW = 6


def _serve(eng, prompts):
    for p in prompts:
        eng.submit(p)
    done = eng.run_until_done()
    eng.check_invariants()
    return {r.uid: r.out_tokens for r in done}


def _greedy(tm, tp, prompt):
    """Greedy continuation by teacher-forced Model.forward."""
    seq = list(prompt)
    for _ in range(NEW):
        logits, _ = tm.forward(tp, {"tokens": torch.tensor([seq],
                                                           dtype=torch.int32)})
        seq.append(int(torch.argmax(logits[0, -1])))
    return seq[len(prompt):]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_batches_exactly(arch):
    jm, jp, tm, tp = _models(arch)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 256, n).tolist() for n in PROMPT_LENS]
    kw = dict(max_batch=2, max_seq=32, max_new_tokens=NEW)
    t_eng = ServeEngine(tm, tp, ServeConfig(**kw))
    got = _serve(t_eng, prompts)
    solo = {i + 1: _serve(JaxServeEngine(jm, jp, JaxServeConfig(**dict(
        kw, max_batch=1))), [p])[1] for i, p in enumerate(prompts)}
    greedy = {i + 1: _greedy(tm, tp, p) for i, p in enumerate(prompts)}
    assert got == solo == greedy
    # a slot was reused: three requests through two slots
    assert len(t_eng.sched.finished) == 3
    j_eng = JaxServeEngine(jm, jp, JaxServeConfig(**kw))
    _serve(j_eng, prompts)
    assert [dataclasses.astuple(r) for r in t_eng.launch_records()] \
        == [dataclasses.astuple(r) for r in j_eng.launch_records()]
    strip = lambda rows: [(r[0], r[1], r[3], r[4]) for r in rows]
    assert strip(t_eng.launch_log) == strip(j_eng.launch_log)
    for key in ("jit_calls", "host_syncs", "prefill_tokens", "gen_tokens",
                "decode_launches"):
        assert getattr(t_eng, key) == getattr(j_eng, key), key
    assert t_eng.sched.work_clock == j_eng.sched.work_clock
    assert t_eng.kv_cache_bytes() == j_eng.kv_cache_bytes()
    kinds = [r.kind for r in t_eng.launch_records()]
    assert kinds.count("stepwise") == 3
    assert t_eng.jit_calls == sum(PROMPT_LENS) + kinds.count("decode")


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_and_chunked_entry_points_raise(arch):
    _, _, tm, tp = _models(arch)
    with pytest.raises(ValueError, match="paged serving needs an attention "
                                         "family"):
        ServeEngine(tm, tp, ServeConfig(max_batch=2, max_seq=32,
                                        paged=True))
    with pytest.raises(ValueError, match="attention family"):
        tm.init_cache(2, 32, page_size=4)
    toks = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="attention family"):
        tm.prefill_paged(tp, {"tokens": toks}, {}, torch.zeros(2))
    with pytest.raises(ValueError, match="attention family"):
        tm.prefill_chunks(tp, {"tokens": toks}, {}, torch.zeros((1, 2)))


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_keeps_the_float32_leaves_and_refuses_others(arch):
    """bfloat16 trees: the leaves the JAX init keeps in float32 arrive in
    float32, every other in bfloat16; a float32 leaf where the port keeps
    bfloat16, or the reverse, raises."""
    jm = jax_build_model(jax_smoke_config(arch))
    host = jax.device_get(jm.init(jax.random.PRNGKey(1)))
    cfg = get_smoke_config(arch)
    tp = params_from_numpy(host, cfg, "cpu")
    fp32 = {p for p, t in leaves_with_paths(tp) if t.dtype == torch.float32}
    assert fp32 == ({"blocks/mamba/A_log", "blocks/mamba/dt_bias"}
                    if arch == "zamba2-2.7b"
                    else {"blocks/mix/w_base", "blocks/mix/u"})
    group = host["blocks"]["mamba" if arch == "zamba2-2.7b" else "mix"]
    leaf = "A_log" if arch == "zamba2-2.7b" else "u"
    group[leaf] = group[leaf].astype(jnp.bfloat16)
    with pytest.raises(TypeError, match=leaf):
        params_from_numpy(host, cfg, "cpu")
