"""The port's sharded training (ROADMAP M14a) against the JAX package on the
CPU: Trainer(mesh=make_debug_mesh(d, m), state_shardings=train_cell(...)
[2][0]) on the granite-3-2b and gemma3-4b smoke configs in float32 (4
query / 2 KV heads of 16; gemma3-4b brings its sliding window), from the
JAX Model.init state.

The port's ranks run in ONE gloo world of four processes per module, and
one of two (tests/torch_mesh_worker.py, each rank a subprocess with its
own PYTHONHASHSEED, meeting through a FileStore under the fixture's
directory; WORLD_S seconds, after which the fixture kills them and
fails).  Every train job starts from the same JAX state, written by the
JAX package's save_checkpoint into the job's checkpoint directory at
step 0, and trains on the same saved batches of steps 1-3 (each rank's
host_batch reads them; rank 0's reach the others by broadcast).
Meanwhile the fixture runs the JAX single-device train step over the
same batches from the same state, and the port's unsharded Trainer.

Bars:
- losses and grad norms of each of the three steps against the JAX
  single-device step: 1e-5 relative (the same float32 functions; the
  mesh sums the gradients and the loss shares over the data-parallel
  ranks, which rounds in another order).
- each leaf's gradient of the first step (the whole gradient after the
  data-parallel sum, before the clip) against JAX's: within 1e-5 of the
  leaf's largest |entry| (the bar of tests/test_torch_train.py).
- the parameters after three steps against the port's unsharded Trainer:
  within 3 x lr_max of absolute difference.  AdamW's first update of an
  entry is about lr x sign(g): where a gradient is at rounding level, the
  mesh's and the single device's roundings may give it opposite signs,
  and that entry moves by up to 2 lr apart (seen: 3.8e-4 at lr 3e-4, on
  a few entries); everywhere else they agree to float32 rounding.
- every rank's losses equal rank 0's exactly; the data 1 x model 2 mesh
  (the model axis alone: every attention on a head shard, no data-
  parallel sum) gives every leaf's gradient within 1e-6 of its largest
  |entry| of the unsharded port's - a head split whose backward dropped
  the other ranks' head slices would leave every parameter upstream of
  attention a partial gradient with the same loss.
- the elastic round trip (2x2 -> 1x4 -> no mesh) and the batches: bit
  for bit.
"""
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.models import build_model as jax_build_model
from repro.train import init_train_state as j_init_train_state
from repro.train import make_train_step as j_make_train_step
from repro.train.checkpoint import save_checkpoint as j_save
from repro_torch.configs import TrainConfig, get_smoke_config
from repro_torch.data import DataPipeline
from repro_torch.models import build_model
from repro_torch.train.checkpoint import restore_checkpoint
from repro_torch.train.trainer import Trainer
from repro_torch.tree import leaves_with_paths

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_S = 240
STEPS = 3
TC = dict(global_batch=4, seq_len=48, total_steps=20, warmup_steps=1,
          checkpoint_every=0, log_every=1)
# job -> (arch, mesh, int8 compression)
TRAIN_JOBS = {"granite_2x2": ("granite-3-2b", (2, 2), False),
              "granite_1x4": ("granite-3-2b", (1, 4), False),
              "granite_4x1": ("granite-3-2b", (4, 1), False),
              "gemma_2x2": ("gemma3-4b", (2, 2), False),
              "granite_2x2_int8": ("granite-3-2b", (2, 2), True)}
MODEL_ONLY = {"granite_1x2": ("granite-3-2b", (1, 2), False)}


def _tcfg(ckpt, int8):
    return dict(TC, checkpoint_dir=ckpt,
                grad_compression="int8" if int8 else "")


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def _spawn(world, d, seed0):
    env = dict(os.environ, PYTHONPATH=f"{ROOT}/src:{ROOT}/tests")
    return [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "torch_mesh_worker.py"),
         str(r), str(world), os.path.join(d, "store"),
         os.path.join(d, "jobs.json"), d],
        env=dict(env, PYTHONHASHSEED=str(seed0 + r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def _join(procs, d, t0):
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(
                timeout=max(t0 + WORLD_S - time.monotonic(), 1))[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"a gloo world of {len(procs)} did not finish in "
                        f"{WORLD_S} s")
    if any(p.returncode for p in procs):
        pytest.fail("a rank failed:\n" + "\n".join(logs)[-6000:])
    out = []
    for r in range(len(procs)):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            js = json.load(f)
        with np.load(os.path.join(d, f"rank{r}.npz")) as z:
            out.append((js, {k: z[k] for k in z.files}))
    return out


def _jax_run(arch, int8, batches):
    """JAX single-device: the initial state, the first step's gradients
    (before the clip) and STEPS steps' metrics."""
    jcfg = jax_smoke_config(arch).replace(dtype="float32")
    jm = jax_build_model(jcfg)
    jtc = JaxTrainConfig(**_tcfg("", int8))
    state = j_init_train_state(jm, jax.random.PRNGKey(0), jtc)
    init = jax.device_get(state)
    b1 = {"tokens": batches[1]}
    (_, _), grads = jax.value_and_grad(
        lambda p: jm.loss(p, b1), has_aux=True)(state.params)
    step = jax.jit(j_make_train_step(jm, jtc))
    metrics = []
    for s in range(1, STEPS + 1):
        state, m = step(state, {"tokens": batches[s]})
        metrics.append({k: float(v) for k, v in m.items()})
    return init, dict(leaves_with_paths(jax.device_get(grads))), metrics


def _port_unsharded(arch, int8, ckpt, batches):
    """The port's Trainer without a mesh from the same checkpoint: its
    parameters after STEPS steps and its first step's gradients."""
    cfg = get_smoke_config(arch).replace(dtype="float32")
    tr = Trainer(cfg, TrainConfig(**_tcfg(ckpt, int8)), device="cpu")
    tr.pipeline.host_batch = lambda s: {"tokens": batches[s]}
    params = tr.state.params
    loss, _ = tr.model.loss(params, tr.pipeline.device_batch(1))
    loss.backward()
    grads = {p: t.grad.detach().clone()
             for p, t in leaves_with_paths(params)}
    for _, t in leaves_with_paths(params):
        t.grad = None
    tr.run(STEPS)
    return grads, {p: t.detach().clone()
                   for p, t in leaves_with_paths(tr.state.params)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d4 = str(tmp_path_factory.mktemp("mesh4"))
    d2 = str(tmp_path_factory.mktemp("mesh2"))
    archs = sorted({a for a, _, _ in {**TRAIN_JOBS, **MODEL_ONLY}.values()})
    batches = {}
    for arch in archs:
        cfg = get_smoke_config(arch).replace(dtype="float32")
        pipe = DataPipeline(cfg, TrainConfig(**TC), device="cpu")
        batches[arch] = {s: pipe.host_batch(s)["tokens"]
                         for s in range(1, STEPS + 1)}
        np.savez(os.path.join(d4, f"{arch}.npz"),
                 **{str(s): b for s, b in batches[arch].items()})
    jax_ref, inits = {}, {}
    for name, (arch, mesh, int8) in {**TRAIN_JOBS, **MODEL_ONLY}.items():
        if (arch, int8) not in inits:
            inits[arch, int8] = _jax_run(arch, int8, batches[arch])
        jax_ref[name] = inits[arch, int8]

    def train_job(name, d, arch, mesh, int8, **extra):
        ckpt = os.path.join(d, name)
        j_save(ckpt, 0, inits[arch, int8][0])
        return dict(name=name, kind="train", arch=arch, dtype="float32",
                    mesh=list(mesh), tcfg=_tcfg(ckpt, int8),
                    batches=os.path.join(d4, f"{arch}.npz"), steps=STEPS,
                    **extra)
    jobs4 = [train_job(n, d4, *spec) for n, spec in TRAIN_JOBS.items()]
    restored = os.path.join(d4, "restored_1x4")
    jobs4 += [
        dict(name="restore_1x4", kind="restore", arch="granite-3-2b",
             dtype="float32", mesh=[1, 4],
             tcfg=_tcfg(os.path.join(d4, "granite_2x2_int8"), True),
             save_dir=restored),
        dict(name="batch", kind="batch", arch="granite-3-2b",
             dtype="float32", mesh=[2, 2], tcfg=TC, step=5),
        dict(name="refuse", kind="refuse", arch="granite-3-2b",
             other=[["zamba2-2.7b", "cuda"], ["rwkv6-1.6b", "meta"]],
             dtype="float32", mesh=[2, 2], tcfg=TC, bad_mesh=[2, 1])]
    jobs2 = [train_job(n, d2, *spec, all_grads=True)
             for n, spec in MODEL_ONLY.items()]
    for d, jobs in ((d4, jobs4), (d2, jobs2)):
        with open(os.path.join(d, "jobs.json"), "w") as f:
            json.dump({"jobs": jobs}, f)
    t0 = time.monotonic()
    p4, p2 = _spawn(4, d4, 11), _spawn(2, d2, 21)

    # meanwhile: the port's unsharded Trainer on every job's start
    port = {}
    for name, (arch, mesh, int8) in {**TRAIN_JOBS, **MODEL_ONLY}.items():
        ckpt = os.path.join(d4, "unsharded_" + name)
        j_save(ckpt, 0, inits[arch, int8][0])
        port[name] = _port_unsharded(arch, int8, ckpt, batches[arch])
    ranks4, ranks2 = _join(p4, d4, t0), _join(p2, d2, t0)
    return SimpleNamespace(ranks4=ranks4, ranks2=ranks2, jax=jax_ref,
                           port=port, d4=d4, d2=d2, restored=restored,
                           batches=batches)


def _ranks(run, name):
    return run.ranks2 if name in MODEL_ONLY else run.ranks4


def _losses(js, name):
    return [(m["loss"], m["grad_norm"], m["lr"]) for m in js[name]["metrics"]]


@pytest.mark.parametrize("name", [*TRAIN_JOBS, *MODEL_ONLY])
def test_every_rank_agrees(run, name):
    ranks = _ranks(run, name)
    want = _losses(ranks[0][0], name)
    assert len(want) == STEPS
    for js, _ in ranks[1:]:
        assert _losses(js, name) == want


@pytest.mark.parametrize("name", [*TRAIN_JOBS, *MODEL_ONLY])
def test_mesh_steps_match_the_jax_step(run, name):
    js = _ranks(run, name)[0][0]
    assert js[name]["start_step"] == 1
    _, _, jm = run.jax[name]
    got = js[name]["metrics"]
    assert [m["step"] for m in got] == [1, 2, 3]
    for g, w in zip(got, jm):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", [*TRAIN_JOBS, *MODEL_ONLY])
def test_mesh_gradients_match_jax_leaf_by_leaf(run, name):
    arrays = _ranks(run, name)[0][1]
    want = run.jax[name][1]
    got = {k[len(name) + 6:]: v for k, v in arrays.items()
           if k.startswith(f"{name}.grad.")}
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        w = np.asarray(want[path], np.float32)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=path)


@pytest.mark.parametrize("name", [*TRAIN_JOBS, *MODEL_ONLY])
def test_params_after_three_steps_match_the_unsharded_trainer(run, name):
    arch, _, int8 = {**TRAIN_JOBS, **MODEL_ONLY}[name]
    ck = os.path.join(run.d4 if name in TRAIN_JOBS else run.d2, name)
    cfg = get_smoke_config(arch).replace(dtype="float32")
    template = Trainer(cfg, TrainConfig(**_tcfg(
        os.path.join(run.d4, "no_checkpoint"), int8)), device="cpu").state
    state, _ = restore_checkpoint(ck, STEPS, template)
    lr_max = max(m["lr"] for m in _ranks(run, name)[0][0][name]["metrics"])
    want = run.port[name][1]
    for path, t in leaves_with_paths(state.params):
        np.testing.assert_allclose(t.detach().numpy(), want[path].numpy(),
                                   rtol=0, atol=3 * lr_max, err_msg=path)


def test_model_axis_alone_gives_every_leaf_the_whole_gradient(run):
    """data 1 x model 2: both ranks' gradients, leaf by leaf, against the
    port's unsharded Model.loss backward from the same state and batch."""
    want = run.port["granite_1x2"][0]
    for r, (_, arrays) in enumerate(run.ranks2):
        got = {k[len("granite_1x2.grad."):]: v for k, v in arrays.items()
               if k.startswith("granite_1x2.grad.")}
        assert sorted(got) == sorted(want) and len(got) > 5
        for path, g in got.items():
            w = want[path].numpy()
            np.testing.assert_allclose(
                g, w, rtol=0, atol=1e-6 * float(np.abs(w).max()),
                err_msg=f"rank {r} {path}")


def test_every_rank_trains_on_rank_0s_global_batch(run):
    """Each rank runs under its own PYTHONHASHSEED, so each would seed
    SyntheticCorpus's batch differently; rank 0 makes it and broadcasts
    it, and each rank takes its data coordinate's rows (the model axis
    shares them)."""
    hashes = {js["batch"]["hash"] for js, _ in run.ranks4}
    assert len(hashes) > 1, "the ranks did not run under different seeds"
    host = run.ranks4[0][1]["batch.host"]
    assert host.shape == (4, 48)
    for r, (_, arrays) in enumerate(run.ranks4):
        data = r // 2                       # rank r at (r // 2, r % 2)
        np.testing.assert_array_equal(arrays["batch.tokens"],
                                      host[2 * data:2 * data + 2])


def test_elastic_round_trip_is_bit_equal(run):
    """The checkpoint the 2x2 mesh wrote (int8 job: ef non-zero) restored
    onto 1x4 and written again, and restored with no mesh: the same bits
    leaf by leaf."""
    js = run.ranks4[0][0]
    assert js["restore_1x4"]["start_step"] == STEPS + 1
    src = os.path.join(run.d4, "granite_2x2_int8", f"step_{STEPS}",
                       "arrays.npz")
    dst = os.path.join(run.restored, f"step_{STEPS}", "arrays.npz")
    with np.load(src) as a, np.load(dst) as b:
        assert sorted(a.files) == sorted(b.files) and len(a.files) == 45
        for k in a.files:
            np.testing.assert_array_equal(_bits(a[k]), _bits(b[k]),
                                          err_msg=k)
        cfg = get_smoke_config("granite-3-2b").replace(dtype="float32")
        tr = Trainer(cfg, TrainConfig(**_tcfg(
            os.path.join(run.d4, "granite_2x2_int8"), True)), device="cpu")
        assert tr.start_step == STEPS + 1
        for path, t in leaves_with_paths(tr.state):
            np.testing.assert_array_equal(
                t.detach().numpy(), a[path.replace("/", "|")], err_msg=path)
        assert any(np.abs(a[k]).max() > 0 for k in a.files
                   if k.startswith(".ef"))


def test_the_mesh_path_refuses(run):
    """The mesh Trainer of the hybrid and ssm families on the card or the
    meta device: the scans' backward kernels exist, so check_backward no
    longer refuses the families - zamba2's smoke config is refused on
    the card only for its head dim 16, which K5 does not take, and
    rwkv6 (no attention) gets past it to the mesh's own check, a CPU
    mesh holding no meta tensors - before anything is built; and a mesh
    whose size is not the world's."""
    for js, _ in run.ranks4:
        out = js["refuse"]
        assert sorted(out["family"]) == ["rwkv6-1.6b.meta",
                                         "zamba2-2.7b.cuda"]
        zamba, rwkv = out["family"]["zamba2-2.7b.cuda"], \
            out["family"]["rwkv6-1.6b.meta"]
        assert zamba.startswith("NotImplementedError") and "K5" in zamba \
            and "head dim 16" in zamba and "K6" not in zamba, zamba
        assert rwkv.startswith("ValueError") and "K7" not in rwkv \
            and "the mesh holds cpu tensors" in rwkv, rwkv
        assert "a world of 2 ranks, the process group has 4" in out["mesh"]


def test_trainer_mesh_preconditions():
    cfg = get_smoke_config("granite-3-2b")
    tc = TrainConfig(**TC)
    with pytest.raises(ValueError, match="come together"):
        Trainer(cfg, tc, device="cpu", mesh=SimpleNamespace(
            device_type="cpu"))
    with pytest.raises(ValueError, match="holds cuda tensors"):
        Trainer(cfg, tc, device="cpu", mesh=SimpleNamespace(
            device_type="cuda"), state_shardings=object())
    if not torch.cuda.is_available():
        # the default device is the card: without one it raises, as the
        # single-device Trainer does (at a head dim K5 takes, so that the
        # device is what is refused)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(cfg.replace(head_dim=64), tc,
                    mesh=SimpleNamespace(device_type="cuda"),
                    state_shardings=object())
