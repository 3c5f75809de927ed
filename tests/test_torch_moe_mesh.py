"""The MoE family on a (data, model) mesh against the JAX package on the
CPU, in float32: the expert-parallel exchange with its gradients
(models/moe_a2a.py make_sharded_moe, the REPRO_MOE_A2A switch of
models/moe.py), the mesh Trainer on both of the FFN's paths, the prefill
and decode cells, and the dry run of a train cell.

The port's ranks run in one gloo world of four processes and one of two
(tests/torch_mesh_worker.py, each rank a subprocess meeting through a
FileStore under the fixture's directory; WORLD_S seconds, after which the
fixture kills them and fails).  Meanwhile the fixture computes the JAX
references: jax.grad through make_sharded_moe on host meshes in a
subprocess with four forced host devices (as tests/test_torch_moe_a2a.py
runs it), the JAX single-device train step, Model.prefill and
Model.decode_step, and hlo_cost.analyze of the JAX train cell.

- the exchange, at olmoe-1b-7b's smoke config (8 experts, top 2) on
  numpy-seeded x (offset by 0.5, which skews the routing) and w (2, 32,
  64) and the JAX moe_init weights, on the (1, 2) mesh of the world of
  two and the (1, 4) and (2, 2) meshes of the world of four, at capacity
  factors 8.0 (nothing drops) and 1.25 (every mesh drops pairs: its
  output there parts from its output at 8):
  each rank's y, aux and its gradients of sum(y w) + 3 aux / (data ranks)
  against make_sharded_moe's and jax.grad's of sum(Y W) + 3 aux on the
  same mesh shape - x's at the rank's rows and sequence block, the
  router's and the experts' summed over the ranks (each rank's part: its
  tokens' routing, its E / tp experts).  On (2, 2) the rows are gathered
  over the data axis before the exchange, as the JAX in_specs replicate
  the batch there: capacities and first-come slots are the global
  batch's, which the drops at 1.25 show.
- the mesh Trainer (Trainer(mesh=make_debug_mesh(2, 2), state_shardings=
  train_cell(...)[2][0])) on the olmoe-1b-7b and qwen3-moe-235b-a22b smoke
  configs from the JAX Model.init state, 3 steps of 4 x 48 saved tokens,
  on the per-row dispatch (factor 1.25) and on the exchange
  (REPRO_MOE_A2A=1, factor 8.0, where neither the exchange nor the JAX
  per-row dispatch drops a pair), against the JAX single-device step at
  the same factor: loss, aux and grad norm each step, and the first step's
  gradients leaf by leaf.  On the exchange, each model rank's MoE
  gradients before the model-axis sum (train_step.model_partials): the
  experts' zero outside the rank's E / tp slice; after it every leaf is
  whole (the leaf-by-leaf check).
- the prefill and decode cells (launch/specs.py prefill_cell and
  serve_cell) in each cache layout the smoke configs' KV heads reach:
  olmoe's 4 KV heads the default layout on 2x2 and the sequence over data
  at batch 1; qwen3-moe's 2 the default layout on 2x2 and the sequence
  over the model axis on 1x4; and the prefill through the exchange
  (REPRO_MOE_A2A=1, factor 8.0) on 2x2 and 1x4; against the JAX unsharded
  prefill and decode_step (with seq_parallel=True where the sequence is
  split, the JAX serve cell's naive decode).
- the dry run of olmoe's smoke train cell on a (1, 1) mesh beside JAX
  hlo_cost.analyze of the JAX train cell, as tests/test_torch_cost.py
  holds the dense one.

Bars (float32; the frameworks and the mesh sum in other orders): outputs,
aux, losses and logits 1e-5 (absolute; losses and grad norms relative);
every gradient within 1e-5 of its leaf's largest |entry| (the bar of
tests/test_torch_mesh_train.py); cache shards 1e-5.
"""
import json
import os
import subprocess
import sys
import textwrap
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.models import build_model as jax_build_model
from repro.train import init_train_state as j_init_train_state
from repro.train import make_train_step as j_make_train_step
from repro.train.checkpoint import save_checkpoint as j_save
from repro_torch.configs import TrainConfig, get_smoke_config
from repro_torch.data import DataPipeline
from repro_torch.tree import leaves_with_paths

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_S = 240
F32 = 1e-5
AUX_C = 3.0                             # tests/torch_mesh_worker.py's
FACTORS = (8.0, 1.25)
# exchange job -> mesh; the (1, 2) mesh runs in the world of two
A2A = {"a2a_1x2": (1, 2), "a2a_1x4": (1, 4), "a2a_2x2": (2, 2)}
STEPS = 3
TC = dict(global_batch=4, seq_len=48, total_steps=20, warmup_steps=1,
          checkpoint_every=0, log_every=1)
# train job -> (arch, capacity factor, REPRO_MOE_A2A)
TRAIN = {"olmoe_rows": ("olmoe-1b-7b", 1.25, False),
         "olmoe_a2a": ("olmoe-1b-7b", 8.0, True),
         "qwen_rows": ("qwen3-moe-235b-a22b", 1.25, False),
         "qwen_a2a": ("qwen3-moe-235b-a22b", 8.0, True)}
# cell -> (arch, kind, mesh, (B, S), decode steps' lens, REPRO_MOE_A2A)
CELLS = {
    "olmoe_prefill_2x2": ("olmoe-1b-7b", "prefill", (2, 2), (4, 32), None,
                          False),
    "olmoe_decode_2x2": ("olmoe-1b-7b", "decode", (2, 2), (4, 32),
                         [[7] * 4, [8] * 4], False),
    "olmoe_prefill_seq_data": ("olmoe-1b-7b", "prefill", (2, 2), (1, 32),
                               None, False),
    "olmoe_decode_seq_data": ("olmoe-1b-7b", "decode", (2, 2), (1, 32),
                              [[15], [16]], False),
    "olmoe_prefill_2x2_a2a": ("olmoe-1b-7b", "prefill", (2, 2), (4, 32),
                              None, True),
    "qwen_prefill_2x2": ("qwen3-moe-235b-a22b", "prefill", (2, 2), (4, 32),
                         None, False),
    "qwen_decode_2x2": ("qwen3-moe-235b-a22b", "decode", (2, 2), (4, 32),
                        [[7] * 4, [8] * 4], False),
    "qwen_prefill_seq_model": ("qwen3-moe-235b-a22b", "prefill", (1, 4),
                               (4, 32), None, False),
    "qwen_decode_seq_model": ("qwen3-moe-235b-a22b", "decode", (1, 4),
                              (4, 32), [[7, 8, 15, 23], [8, 9, 16, 24]],
                              False),
    "qwen_prefill_seq_model_a2a": ("qwen3-moe-235b-a22b", "prefill", (1, 4),
                                   (4, 32), None, True),
}
A2A_CELL_FACTOR = 8.0
DRY = (4, 32)                           # (B, S) of the (1, 1) train cell

JAX_A2A = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import get_smoke_config
from repro.models.moe import moe_init
from repro.models.moe_a2a import make_sharded_moe

base = get_smoke_config("olmoe-1b-7b").replace(dtype="float32")
params = moe_init(jax.random.PRNGKey(0), base)
rng = np.random.default_rng(0)
# an offset skews the routing, so that every mesh drops pairs at 1.25
x = rng.standard_normal((2, 32, 64)).astype(np.float32) + 0.5
w = rng.standard_normal((2, 32, 64)).astype(np.float32)
out = dict(x=x, w=w, **{{k: np.asarray(v) for k, v in params.items()}})
for shape in {meshes}:
    n = shape[0] * shape[1]
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape),
                ("data", "model"))
    for f in {factors}:
        fn = make_sharded_moe(base.replace(moe_capacity_factor=f), mesh)

        def loss(p, xx):
            y, aux = fn(p, xx)
            return jnp.sum(y * w) + {aux_c} * aux, (y, aux)
        (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, (0, 1), has_aux=True))(params, jnp.asarray(x))
        tag = f"{{shape[0]}}x{{shape[1]}}.{{f}}"
        out[tag + ".y"], out[tag + ".aux"] = np.asarray(y), np.asarray(aux)
        out[tag + ".dx"] = np.asarray(gx)
        for k, v in gp.items():
            out[tag + ".d" + k] = np.asarray(v)
# each row alone on a (1, 2) mesh at 1.25: what a (2, 2) rank that routed
# only its own row would compute
mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("data", "model"))
fn = make_sharded_moe(base.replace(moe_capacity_factor=1.25), mesh)
out["rows_alone"] = np.concatenate([np.asarray(fn(params, jnp.asarray(
    x[i:i + 1]))[0]) for i in range(2)])
np.savez(sys.argv[1], **out)
"""

_FAKE = r"""
import json, os, sys
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_debug_mesh
spec = json.loads(sys.argv[1])
cfg = get_smoke_config(spec["arch"]).replace(**spec["replace"])
B, S = spec["shape"]
out = {}
for name, mesh, a2a in (("train", (1, 1), ""), ("a2a_2x2", (2, 2), "1")):
    os.environ["REPRO_MOE_A2A"] = a2a
    dryrun.fake_world(mesh[0] * mesh[1])
    out[name] = dryrun.run_cell(spec["arch"], name, False, cfg=cfg,
                                shape=ShapeSpec(name, S, B, "train"),
                                mesh=make_debug_mesh(*mesh,
                                                     device_type="cpu"))
json.dump(out, open(spec["out"], "w"))
"""

_JAX_FLOPS = r"""
import json, sys
import jax
from repro.compat import make_mesh, use_mesh
from repro.configs import get_smoke_config
from repro.configs.base import ShapeSpec, TrainConfig
from repro.launch.hlo_cost import analyze
from repro.launch.specs import train_cell
spec = json.loads(sys.argv[1])
cfg = get_smoke_config(spec["arch"]).replace(**spec["replace"])
mesh = make_mesh((1, 1), ("data", "model"))
B, S = spec["shape"]
with use_mesh(mesh):
    tcfg = TrainConfig(global_batch=B, seq_len=S, remat="full")
    step, args, sh = train_cell(cfg, ShapeSpec("t", S, B, "train"), mesh,
                                tcfg)
    hlo = jax.jit(step, in_shardings=sh).lower(*args).compile().as_text()
json.dump(analyze(hlo), open(spec["out"], "w"))
"""
# float32, and the smoke head dim 16 raised to 64, a head dim the kernels'
# meta paths take (tests/test_torch_cost.py)
DRY_REPLACE = {"dtype": "float32", "head_dim": 64}


def _tcfg(ckpt):
    return dict(TC, checkpoint_dir=ckpt)


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{pre}{k}/") if isinstance(v, dict)
                   else {pre + k: np.asarray(v)})
    return out


def _spawn(world, d, seed0, env=None):
    env = dict(os.environ, PYTHONPATH=f"{ROOT}/src:{ROOT}/tests",
               **(env or {}))
    return [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "torch_mesh_worker.py"),
         str(r), str(world), os.path.join(d, "store"),
         os.path.join(d, "jobs.json"), d],
        env=dict(env, PYTHONHASHSEED=str(seed0 + r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def _join(procs, name, t0):
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(
                timeout=max(t0 + WORLD_S - time.monotonic(), 1))[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"{name} did not finish in {WORLD_S} s")
    if any(p.returncode for p in procs):
        pytest.fail(f"{name} failed:\n" + "\n".join(logs)[-6000:])


def _ranks(d, world):
    out = []
    for r in range(world):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            js = json.load(f)
        with np.load(os.path.join(d, f"rank{r}.npz")) as z:
            out.append((js, {k: z[k] for k in z.files}))
    return out


def _jax_cfg(arch, **over):
    return jax_smoke_config(arch).replace(dtype="float32", **over)


def _jax_train(arch, factor, batches):
    """JAX single-device at the capacity factor: the initial state, the
    first step's gradients (before the clip) and STEPS steps' metrics."""
    jm = jax_build_model(_jax_cfg(arch, moe_capacity_factor=factor))
    jtc = JaxTrainConfig(**_tcfg(""))
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


def _jax_cell(jm, jp, name, inp):
    _, kind, _, (B, S), steps, _ = CELLS[name]
    if kind == "prefill":
        logits, cache, _ = jax.jit(jm.prefill)(
            jp, {"tokens": jnp.asarray(inp["tokens"])}, jm.init_cache(B, S))
        return {"logits": [np.asarray(logits)],
                "cache": {n: np.asarray(cache[n]) for n in ("k", "v")}}
    seq_parallel = "seq" in name
    step = jax.jit(jm.decode_step, static_argnames=("seq_parallel",))
    cache = {n: jnp.asarray(inp[f"cache.{n}"]) for n in ("k", "v")}
    out = []
    for i in range(len(steps)):
        logits, cache = step(jp, jnp.asarray(inp[f"tokens.{i}"]),
                             jnp.asarray(inp[f"lens.{i}"]), cache,
                             seq_parallel=seq_parallel)
        out.append(np.asarray(logits))
    return {"logits": out,
            "cache": {n: np.asarray(cache[n]) for n in ("k", "v")}}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d4 = str(tmp_path_factory.mktemp("moe4"))
    d2 = str(tmp_path_factory.mktemp("moe2"))
    dj = str(tmp_path_factory.mktemp("moejax"))
    t0 = time.monotonic()
    # the JAX side of the exchange and of the dry run, in subprocesses
    jenv = dict(os.environ, PYTHONPATH=f"{ROOT}/src", JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=4")
    a2a_path = os.path.join(dj, "a2a.npz")
    side = {"a2a": subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_A2A.format(
            meshes=tuple(A2A.values()), factors=FACTORS, aux_c=AUX_C)),
         a2a_path], cwd=ROOT, env=jenv, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)}
    dry = {"arch": "olmoe-1b-7b", "replace": DRY_REPLACE,
           "shape": list(DRY)}
    side["jax_flops"] = subprocess.Popen(
        [sys.executable, "-c", _JAX_FLOPS, json.dumps(
            dict(dry, out=os.path.join(dj, "jax_flops.json")))],
        cwd=ROOT, env=dict(jenv, XLA_FLAGS=""), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    side["fake"] = subprocess.Popen(
        [sys.executable, "-c", _FAKE, json.dumps(
            dict(dry, out=os.path.join(dj, "fake.json")))],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=f"{ROOT}/src"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    # the train jobs' batches and JAX initial states
    archs = sorted({a for a, _, _ in TRAIN.values()})
    batches, inits = {}, {}
    for arch in archs:
        pipe = DataPipeline(get_smoke_config(arch).replace(dtype="float32"),
                            TrainConfig(**TC), device="cpu")
        batches[arch] = {s: pipe.host_batch(s)["tokens"]
                         for s in range(1, STEPS + 1)}
        np.savez(os.path.join(d4, f"{arch}.npz"),
                 **{str(s): b for s, b in batches[arch].items()})
        jm = jax_build_model(_jax_cfg(arch))
        inits[arch] = jax.device_get(j_init_train_state(
            jm, jax.random.PRNGKey(0), JaxTrainConfig(**_tcfg(""))))
    jobs4 = []
    for name, (arch, factor, a2a) in TRAIN.items():
        ckpt = os.path.join(d4, name)
        j_save(ckpt, 0, inits[arch])
        jobs4.append(dict(
            name=name, kind="train", arch=arch, dtype="float32",
            replace={"moe_capacity_factor": factor}, mesh=[2, 2],
            tcfg=_tcfg(ckpt), batches=os.path.join(d4, f"{arch}.npz"),
            steps=STEPS, partials=a2a, all_grads=a2a,
            env={"REPRO_MOE_A2A": "1"} if a2a else {}))

    # the cells' weights and inputs
    rng = np.random.default_rng(11)
    jmodels, cell_inputs = {}, {}
    for arch in sorted({c[0] for c in CELLS.values()}):
        for a2a in (False, True):
            over = {"moe_capacity_factor": A2A_CELL_FACTOR} if a2a else {}
            jm = jax_build_model(_jax_cfg(arch, **over))
            jmodels[arch, a2a] = (jm, jm.init(jax.random.PRNGKey(0)))
        np.savez(os.path.join(d4, f"{arch}.params.npz"),
                 **_flat(jax.device_get(jmodels[arch, False][1])))
    for name, (arch, kind, mesh, (B, S), steps, a2a) in CELLS.items():
        cfg = _jax_cfg(arch)
        L, Hkv, D = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        inp = {f"cache.{n}": np.zeros((L, B, S, Hkv, D), np.float32)
               for n in ("k", "v")}
        if kind == "prefill":
            inp["tokens"] = rng.integers(0, cfg.vocab_size, (B, S),
                                         dtype=np.int32)
        else:
            for n in ("k", "v"):
                inp[f"cache.{n}"] = rng.standard_normal(
                    (L, B, S, Hkv, D)).astype(np.float32)
            for i, lens in enumerate(steps):
                inp[f"tokens.{i}"] = rng.integers(0, cfg.vocab_size, (B, 1),
                                                  dtype=np.int32)
                inp[f"lens.{i}"] = np.asarray(lens, np.int32)
        path = os.path.join(d4, f"{name}.npz")
        np.savez(path, **inp)
        cell_inputs[name] = inp
        replace = {"dtype": "float32"}
        if a2a:
            replace["moe_capacity_factor"] = A2A_CELL_FACTOR
        jobs4.append({"name": name, "kind": "cell", "cell": kind,
                      "arch": arch, "replace": replace, "mesh": list(mesh),
                      "shape": [B, S],
                      "steps": 0 if steps is None else len(steps),
                      "params": os.path.join(d4, f"{arch}.params.npz"),
                      "inputs": path, "count": True,
                      "env": {"REPRO_MOE_A2A": "1"} if a2a else {}})
    jobs4.append({"name": "refuse", "kind": "refuse", "arch": "olmoe-1b-7b",
                  "other": [["zamba2-2.7b", "meta"],
                            ["rwkv6-1.6b", "cuda"]],
                  "dtype": "float32", "mesh": [2, 2], "tcfg": TC,
                  "bad_mesh": [2, 1]})

    # the exchange jobs wait for the JAX subprocess's inputs
    log = side.pop("a2a").communicate(timeout=max(
        t0 + WORLD_S - time.monotonic(), 1))[0]
    assert os.path.exists(a2a_path), log[-4000:]
    a2a_job = lambda name: {"name": name, "kind": "a2a",
                            "arch": "olmoe-1b-7b", "mesh": list(A2A[name]),
                            "factors": list(FACTORS), "inputs": a2a_path}
    jobs4 = [a2a_job("a2a_1x4"), a2a_job("a2a_2x2")] + jobs4
    jobs2 = [a2a_job("a2a_1x2")]
    for d, jobs in ((d4, jobs4), (d2, jobs2)):
        with open(os.path.join(d, "jobs.json"), "w") as f:
            json.dump({"jobs": jobs}, f)
    p4, p2 = _spawn(4, d4, 31), _spawn(2, d2, 41)

    # meanwhile: the JAX train steps and cells
    jax_train = {}
    for name, (arch, factor, _) in TRAIN.items():
        jax_train[name] = _jax_train(arch, factor, batches[arch])
    jax_cells = {name: _jax_cell(*jmodels[c[0], c[5]], name,
                                 cell_inputs[name])
                 for name, c in CELLS.items()}
    for name, p in side.items():
        try:
            log = p.communicate(timeout=max(
                t0 + WORLD_S - time.monotonic(), 1))[0]
        except subprocess.TimeoutExpired:
            p.kill()
            pytest.fail(f"{name} did not finish in {WORLD_S} s")
        assert p.returncode == 0, f"{name}:\n{log[-4000:]}"
    _join(p4, "the gloo world of four", t0)
    _join(p2, "the gloo world of two", t0)
    with np.load(a2a_path) as z:
        jax_a2a = {k: z[k] for k in z.files}
    with open(os.path.join(dj, "jax_flops.json")) as f:
        jax_flops = json.load(f)
    with open(os.path.join(dj, "fake.json")) as f:
        fake = json.load(f)
    return SimpleNamespace(ranks4=_ranks(d4, 4), ranks2=_ranks(d2, 2),
                           jax_a2a=jax_a2a, jax_train=jax_train,
                           jax_cells=jax_cells, cell_inputs=cell_inputs,
                           jax_flops=jax_flops, fake=fake)


# ---------------------------------------------------------------------------
# the exchange
# ---------------------------------------------------------------------------

def _a2a_ranks(run, name):
    return run.ranks2 if name == "a2a_1x2" else run.ranks4


def _close(got, want, what, rel=True):
    atol = F32 * max(float(np.abs(want).max()), 1.0) if rel else F32
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=what)


@pytest.mark.parametrize("factor", FACTORS)
@pytest.mark.parametrize("name", sorted(A2A))
def test_exchange_forward_matches_jax(run, name, factor):
    nd, nm = A2A[name]
    tag = f"{nd}x{nm}.{factor}"
    want_y, want_aux = run.jax_a2a[tag + ".y"], run.jax_a2a[tag + ".aux"]
    for js, arrays in _a2a_ranks(run, name):
        r0, r1 = js[name]["rows"]
        s0, s1 = js[name]["seq"]
        np.testing.assert_allclose(
            arrays[f"{name}.{factor}.y"], want_y[r0:r1, s0:s1], rtol=0,
            atol=F32, err_msg=f"{name} y at {js[name]['coord']}")
        assert abs(float(arrays[f"{name}.{factor}.aux"])
                   - float(want_aux)) <= F32


@pytest.mark.parametrize("factor", FACTORS)
@pytest.mark.parametrize("name", sorted(A2A))
def test_exchange_gradients_match_jax_grad(run, name, factor):
    """x's gradient at each rank's block; the router's and the experts'
    as the sum of the ranks' parts (each is partial: its tokens, its
    experts)."""
    nd, nm = A2A[name]
    tag = f"{nd}x{nm}.{factor}"
    ranks = _a2a_ranks(run, name)
    for js, arrays in ranks:
        r0, r1 = js[name]["rows"]
        s0, s1 = js[name]["seq"]
        _close(arrays[f"{name}.{factor}.dx"],
               run.jax_a2a[tag + ".dx"][r0:r1, s0:s1], f"{name} dx")
    for k in ("router", "experts_in", "experts_gate", "experts_out"):
        got = sum(a[f"{name}.{factor}.d{k}"] for _, a in ranks)
        _close(got, run.jax_a2a[f"{tag}.d{k}"], f"{name} d{k}")
        if k != "router":
            # rank (d, m)'s expert gradient lies in its E / tp slice
            for js, a in ranks:
                m, e = js[name]["coord"][1], got.shape[0] // nm
                g = a[f"{name}.{factor}.d{k}"].copy()
                g[m * e:(m + 1) * e] = 0
                assert not g.any(), f"{name} d{k} outside rank's experts"


@pytest.mark.parametrize("mesh", sorted({f"{a}x{b}" for a, b in
                                         A2A.values()}))
def test_the_exchange_drops_at_the_published_factor(run, mesh):
    """At 1.25 every mesh drops pairs: its output parts from its output at
    8.0, and the port's agrees with JAX's at both
    (test_exchange_forward_matches_jax).  On (2, 2) each row routed alone
    - what a rank that skipped the gather over the data axis would
    compute, with its own capacities and slot order - parts from the
    global batch's output too."""
    d = run.jax_a2a
    assert np.abs(d[f"{mesh}.1.25.y"] - d[f"{mesh}.8.0.y"]).max() > 0.1
    if mesh == "2x2":
        assert np.abs(d["rows_alone"] - d["2x2.1.25.y"]).max() > 0.1


# ---------------------------------------------------------------------------
# the mesh Trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(TRAIN))
def test_every_rank_agrees(run, name):
    want = [(m["loss"], m["aux"], m["grad_norm"])
            for m in run.ranks4[0][0][name]["metrics"]]
    assert len(want) == STEPS
    for js, _ in run.ranks4[1:]:
        assert [(m["loss"], m["aux"], m["grad_norm"])
                for m in js[name]["metrics"]] == want


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_mesh_steps_match_the_jax_step(run, name):
    js = run.ranks4[0][0]
    assert js[name]["start_step"] == 1
    got = js[name]["metrics"]
    assert [m["step"] for m in got] == [1, 2, 3]
    for g, w in zip(got, run.jax_train[name][2]):
        for k in ("loss", "ce", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(g[k], w[k], rtol=F32, err_msg=k)
        assert w["aux"] > 0.5                # the MoE layers' aux losses


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_mesh_gradients_match_jax_leaf_by_leaf(run, name):
    want = run.jax_train[name][1]
    ranks = run.ranks4 if TRAIN[name][2] else run.ranks4[:1]
    for r, (_, arrays) in enumerate(ranks):
        got = {k[len(name) + 6:]: v for k, v in arrays.items()
               if k.startswith(f"{name}.grad.")}
        assert sorted(got) == sorted(want)
        for path, g in got.items():
            _close(g, np.asarray(want[path], np.float32),
                   f"rank {r} {path}")


@pytest.mark.parametrize("name", ["olmoe_a2a", "qwen_a2a"])
def test_exchange_leaves_partial_gradients_before_the_model_sum(run, name):
    """On the exchange, model rank m's expert gradients (after the data-
    parallel sum) are zero outside its E / tp slice, and the model axis's
    ranks' parts sum to JAX's whole gradient."""
    want = run.jax_train[name][1]
    leaves = [p for p in want if "/moe/" in f"/{p}/"]
    assert len(leaves) >= 3
    for path in leaves:
        parts = {}
        for r, (_, arrays) in enumerate(run.ranks4):
            m = r % 2                       # rank r at (r // 2, r % 2)
            g = arrays[f"{name}.partial.{path}"]
            parts[m] = g
            if "experts" in path:
                e = g.shape[1] // 2                 # (L, E, ...)
                rest = g.copy()
                rest[:, m * e:(m + 1) * e] = 0
                assert not rest.any(), f"{path} rank {m}"
        _close(parts[0] + parts[1], np.asarray(want[path], np.float32),
               path)


# ---------------------------------------------------------------------------
# the serving cells
# ---------------------------------------------------------------------------

def _slice(a, bounds):
    idx = [slice(None)] * a.ndim
    for dim, start, size in bounds:
        idx[dim] = slice(start, start + size)
    return a[tuple(idx)]


@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_logits_match_the_jax_unsharded_step(run, name):
    want = run.jax_cells[name]["logits"]
    for js, arrays in run.ranks4:
        rows = [b for b in js[name]["rows"] if b[0] == 0]
        for i, w in enumerate(want):
            key = f"{name}.logits" if CELLS[name][1] == "prefill" \
                else f"{name}.logits.{i}"
            np.testing.assert_allclose(arrays[key], _slice(w, rows), rtol=0,
                                       atol=F32, err_msg=f"{name} step {i}")


@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_cache_shards_match_the_jax_cache(run, name):
    want = run.jax_cells[name]["cache"]
    for js, arrays in run.ranks4:
        for n in ("k", "v"):
            np.testing.assert_allclose(
                arrays[f"{name}.cache.{n}"],
                _slice(want[n], js[name]["bounds"][n]), rtol=0, atol=F32,
                err_msg=f"{name} {n}")


@pytest.mark.parametrize("name", sorted(CELLS))
def test_the_prefill_takes_the_exchange_exactly_under_the_switch(run,
                                                                  name):
    """The first call's collectives (launch/cost.py StepCost): all_to_all
    in the prefill cells run with REPRO_MOE_A2A=1, none elsewhere - decode
    (S = 1) never takes it."""
    a2a = CELLS[name][5]
    for js, _ in run.ranks4:
        calls = js[name]["collectives"].get("all_to_all", {}).get("calls", 0)
        if a2a:
            # an exchange out and back, and the expert ids, a layer
            assert calls == 3 * 2, js[name]["collectives"]
        else:
            assert calls == 0, js[name]["collectives"]


def test_cells_reach_every_layout(run):
    """olmoe's 4 KV heads split over the model axis of 2 (default), the
    batch-1 cells split the sequence over data, qwen3-moe's 2 KV heads on
    the model axis of 4 split the sequence there."""
    for name, (_, _, mesh, (B, S), _, _) in CELLS.items():
        full = run.cell_inputs[name]["cache.k"].shape
        split = set()
        for js, _ in run.ranks4:
            split |= {dim for dim, _, size in js[name]["bounds"]["k"]
                      if size < full[dim]}
        if "seq_model" in name:
            assert split == {2}, name
        elif "seq_data" in name:
            assert split == {2, 3}, name
        else:
            assert split == {1, 3}, name


# ---------------------------------------------------------------------------
# refusals and the dry run
# ---------------------------------------------------------------------------

def test_the_mesh_trainer_takes_moe_and_refuses_hybrid(run):
    """Beside the MoE mesh Trainer (the jobs above), the hybrid and ssm
    families' mesh Trainer on the meta device or the card is no longer
    refused for its scans (their backward kernels exist): on the job's
    CPU mesh each stops, before anything is built, only at the mesh's
    own check - a CPU mesh holds neither meta nor CUDA tensors."""
    for js, _ in run.ranks4:
        out = js["refuse"]["family"]
        assert sorted(out) == ["rwkv6-1.6b.cuda", "zamba2-2.7b.meta"]
        for key, device in (("zamba2-2.7b.meta", "meta"),
                            ("rwkv6-1.6b.cuda", "cuda")):
            assert out[key] is not None and out[key].startswith(
                "ValueError") and "the mesh holds cpu tensors, the " \
                f"Trainer's device is {device}" in out[key] \
                and "scan" not in out[key], out[key]


def test_dry_run_train_cell_flops_sit_beside_the_jax_analysis(run):
    """As tests/test_torch_cost.py's dense cell: the JAX count is the
    port's dots outside K4 / K5 plus the jnp reference attention's eight
    full-block dots a layer (keys in blocks of 512); the MoE dots - the
    router and the experts over every slot of every row, empty slots
    included, forward, remat recompute and backward - count alike in both
    packages."""
    rec = run.fake["train"]
    cfg = get_smoke_config("olmoe-1b-7b").replace(**DRY_REPLACE)
    B, S = DRY
    padded = -(-S // 512) * 512
    kernels = sum(k["flops"] for k in rec["kernels"].values())
    assert set(rec["kernels"]) == {"K4", "K5"}
    outside = rec["cost"]["flops"] - kernels
    attention = cfg.n_layers * 8 * 2 * B * cfg.n_heads * S * padded \
        * cfg.head_dim
    assert run.jax_flops["flops"] == outside + attention, \
        (run.jax_flops["flops"], outside, attention)
    assert 0 < kernels < attention


def test_dry_run_counts_the_exchange_under_the_switch(run):
    """The same train cell on a (2, 2) fake-backend mesh with
    REPRO_MOE_A2A=1: a layer exchanges the rows, their expert ids and the
    replies in the forward and again in the remat recompute, and the
    gradients of the replies and the rows in the backward - 8
    all_to_all a layer, each (tp, c_pair, ...) with c_pair = ceil(T K /
    tp x 1.25) pairs of the T = B x S / tp tokens of the gathered rows;
    none on the (1, 1) mesh."""
    cfg = get_smoke_config("olmoe-1b-7b").replace(**DRY_REPLACE)
    B, S = DRY
    tp = 2
    c_pair = -(-(B * S // tp) * cfg.moe_top_k * 5 // (tp * 4))
    rows, ids = tp * c_pair * cfg.d_model * 4, tp * c_pair * 8
    got = run.fake["a2a_2x2"]["collectives"]["all_to_all"]
    assert got == {"calls": 8 * cfg.n_layers,
                   "bytes": cfg.n_layers * (6 * rows + 2 * ids)}
    assert run.fake["a2a_2x2"]["collectives_state"]["all_to_all"] == got
    assert "all_to_all" not in run.fake["train"]["collectives"]
