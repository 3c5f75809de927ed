"""The hybrid and ssm families on a (data, model) mesh: the mesh Trainer
and launch/specs.py prefill_cell's and serve_cell's steps on the
zamba2-2.7b and rwkv6-1.6b smoke configs, in ONE gloo world of four
processes on the CPU (tests/torch_mesh_worker.py, each rank a subprocess
meeting through a FileStore under the fixture's directory; WORLD_S
seconds, after which the fixture kills them and fails), against the JAX
package on the same numpy-seeded inputs and the JAX Model.init weights
(repro_torch/models/convert.py on the rank's side), float32.

Training: Trainer(mesh=, state_shardings=train_cell(...)[2][0]), remat
full, STEPS steps of a global 4 x 48 batch (zamba2: 4 x 40, below) from
the JAX init state, on 2x2 and 1x4 for each family: the Mamba2 layers
and the RWKV6 time-mix
run every head on the rank's rows, replicated over the model axis (the
JAX "kv_rep" layout), differentiated through the plain chunked scans as
on one CPU device; zamba2's shared attention block runs on the rank's
head shard (2 of 4 heads on 2x2, 1 on 1x4).  zamba2's batches are 40
tokens long: at 48, the second batch's first row drives the JAX chunked
Mamba2 scan past its overflow (ROADMAP §3: exp of a positive exponent
times the causal mask's 0, NaN; the JAX naive scan and the port stay
finite there), and the JAX step's loss is NaN.

Serving: the prefill and decode cells of both families in the three
layouts of sharding/rules.py cache_spec, reached the way launch/specs.py
_kv_seq_sharded reaches them: default on 2x2 with B 4; the sequence over
data on 2x2 with B 1; the sequence over model on 1x4, where the KV heads
(4) are replaced by 2 so that they do not divide the axis (rwkv6 has no
strips, but its cells take the same layout's state specs).  Each state
leaf takes its block from its own sanitized spec: on the zamba2 smoke
config ssm's 2 heads split 1 a rank on 2x2 and stay whole on 1x4, where
conv's 128 channels split 32 a rank; rwkv6's wkv splits its 4 heads and
tm_prev / cm_prev stay whole; with B 1 the data axis drops from every
state leaf.  The decodes run on a filled cache (random states and
strips) from lanes at and across the strips' shard boundaries; the
sequence-sharded decodes are held against JAX's decode_step with
seq_parallel=True (its naive decode for zamba2's shared block).

Bars (tests/test_torch_recurrent.py's, float32):
- rwkv6: logits within 1e-5 absolute of the JAX unsharded prefill /
  decode_step, each rank's block of every cache leaf within 1e-5 of the
  leaf's largest |entry|; the train steps' loss and grad norm within
  1e-5 relative; each leaf's gradient of the first step within 1e-4 of
  its largest |entry| of jax.grad - wider than the dense families' 1e-5
  because the port on one device is already 4.6e-5 from jax.grad at
  this batch (tok/embed; the WKV scan's cumulative decays amplify the
  two frameworks' float32 orders), the mesh adding nothing visible
  (3.4e-5 at blocks/mix/cm_k on both meshes).
- zamba2, whose smoke model amplifies float32 rounding (in the JAX
  package alone its chunked and naive scans give gradients up to 1.4e-4
  apart, relative to each leaf's largest entry): logits within 5e-5
  absolute, cache leaves within 2e-4 of their largest |entry|, the
  grad norm within 2e-4 relative (the loss 1e-5), each leaf's gradient
  within 2e-4 of its largest |entry| (the port on one device: 5.4e-5,
  blocks/mamba/dt_bias).
- every rank's metrics equal rank 0's exactly; what no step wrote (the
  strips' positions past the lanes) equal to the input bit for bit.
"""
import json
import os
import subprocess
import sys
import time

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
from repro_torch.tree import leaves_with_paths

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_S = 300
ZAMBA, RWKV = "zamba2-2.7b", "rwkv6-1.6b"
ARCHS = {ZAMBA: "zamba2", RWKV: "rwkv6"}
# arch -> (logits absolute, cache leaf of its largest |entry|, grad norm
# relative, gradient of its leaf's largest |entry|)
BARS = {RWKV: (1e-5, 1e-5, 1e-5, 1e-4), ZAMBA: (5e-5, 2e-4, 2e-4, 2e-4)}
LOSS_REL = 1e-5
STEPS = 2
TC = dict(global_batch=4, seq_len=48, total_steps=20, warmup_steps=1,
          checkpoint_every=0, log_every=1, remat="full")
# arch -> its TrainConfig fields (zamba2's 40 tokens: the module docstring)
TCS = {RWKV: TC, ZAMBA: dict(TC, seq_len=40)}
# job -> (arch, mesh)
TRAIN = {f"{ARCHS[a]}_{m[0]}x{m[1]}": (a, m)
         for a in ARCHS for m in ((2, 2), (1, 4))}
S = 32
LANES = [[7, 8, 15, 23], [8, 9, 16, 24]]
# layout -> (mesh, B, decode lens of each step)
LAYOUTS = {"default": ((2, 2), 4, LANES),
           "seq_data": ((2, 2), 1, [[15], [16]]),
           "seq_model": ((1, 4), 4, LANES)}
# 2 KV heads do not divide the model axis of 4: the sequence-over-model
# layout (_kv_seq_sharded)
SEQ_MODEL = {"n_kv_heads": 2}
CELLS = {f"{ARCHS[a]}_{kind}_{lay}": (a, kind, lay)
         for a in ARCHS for kind in ("prefill", "decode") for lay in LAYOUTS}
STRIPS = ("shared_k", "shared_v")


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{pre}{k}/"))
        else:
            out[pre + k] = np.asarray(v)
    return out


def _replace(layout):
    return SEQ_MODEL if layout == "seq_model" else {}


def _jax_cfg(arch, **over):
    return jax_smoke_config(arch).replace(dtype="float32", **over)


def _batches(arch):
    """The numpy-seeded global token batches of steps 1..STEPS."""
    cfg = _jax_cfg(arch)
    rng = np.random.default_rng(31)
    return {s: {"tokens": rng.integers(
        0, cfg.vocab_size, (TCS[arch]["global_batch"],
                            TCS[arch]["seq_len"]),
        dtype=np.int32)} for s in range(1, STEPS + 1)}


def _jax_train(arch, batches):
    """The JAX single-device step: the initial state, the first step's
    gradients (before the clip) and STEPS steps' metrics."""
    jm = jax_build_model(_jax_cfg(arch))
    jtc = JaxTrainConfig(**TCS[arch])
    state = j_init_train_state(jm, jax.random.PRNGKey(0), jtc)
    init = jax.device_get(state)
    jb = {s: {k: jnp.asarray(v) for k, v in b.items()}
          for s, b in batches.items()}
    (_, _), grads = jax.value_and_grad(
        lambda p: jm.loss(p, jb[1]), has_aux=True)(state.params)
    step = jax.jit(j_make_train_step(jm, jtc))
    metrics = []
    for s in range(1, STEPS + 1):
        state, m = step(state, jb[s])
        metrics.append({k: float(v) for k, v in m.items()})
    return init, dict(leaves_with_paths(jax.device_get(grads))), metrics


def _cell_inputs(jm, kind, layout, rng):
    """A cell's inputs: the cache (zeros to prefill; random states and
    strips to decode from) and the prompt batch or each decode step's
    tokens and lens."""
    _, B, steps = LAYOUTS[layout]
    cache = jax.device_get(jm.init_cache(B, S))
    inp = {}
    for n, leaf in cache.items():
        leaf = np.asarray(leaf, np.float32)
        inp[f"cache.{n}"] = leaf if kind == "prefill" else \
            rng.standard_normal(leaf.shape).astype(np.float32)
    if kind == "prefill":
        inp["tokens"] = rng.integers(0, jm.cfg.vocab_size, (B, S),
                                     dtype=np.int32)
    else:
        for i, lens in enumerate(steps):
            inp[f"tokens.{i}"] = rng.integers(0, jm.cfg.vocab_size, (B, 1),
                                              dtype=np.int32)
            inp[f"lens.{i}"] = np.asarray(lens, np.int32)
    return inp


def _jax_cell(jm, jp, kind, layout, inp):
    names = [k[len("cache."):] for k in inp if k.startswith("cache.")]
    B = LAYOUTS[layout][1]
    if kind == "prefill":
        logits, cache, _ = jax.jit(jm.prefill)(
            jp, {"tokens": jnp.asarray(inp["tokens"])}, jm.init_cache(B, S))
        return {"logits": [np.asarray(logits)],
                "cache": {n: np.asarray(cache[n]) for n in names}}
    step = jax.jit(jm.decode_step, static_argnames=("seq_parallel",))
    cache = {n: jnp.asarray(inp[f"cache.{n}"]) for n in names}
    out = []
    for i in range(len(LAYOUTS[layout][2])):
        logits, cache = step(jp, jnp.asarray(inp[f"tokens.{i}"]),
                             jnp.asarray(inp[f"lens.{i}"]), cache,
                             seq_parallel=layout != "default")
        out.append(np.asarray(logits))
    return {"logits": out, "cache": {n: np.asarray(cache[n])
                                     for n in names}}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("recurrent_mesh"))
    jobs, jax_train, batches = [], {}, {}
    for arch in ARCHS:
        batches[arch] = _batches(arch)
        jax_train[arch] = _jax_train(arch, batches[arch])
        np.savez(os.path.join(d, f"{ARCHS[arch]}.batches.npz"),
                 **{str(s): b["tokens"] for s, b in batches[arch].items()})
    for name, (arch, mesh) in TRAIN.items():
        ckpt = os.path.join(d, name)
        j_save(ckpt, 0, jax_train[arch][0])
        jobs.append(dict(name=name, kind="train", arch=arch,
                         dtype="float32", mesh=list(mesh),
                         tcfg=dict(TCS[arch], checkpoint_dir=ckpt),
                         batches=os.path.join(
                             d, f"{ARCHS[arch]}.batches.npz"),
                         steps=STEPS))
    rng = np.random.default_rng(17)
    params, models, want, inputs = {}, {}, {}, {}
    for name, (arch, kind, layout) in CELLS.items():
        replace = _replace(layout)
        key = (arch, tuple(sorted(replace.items())))
        if key not in models:
            jm = jax_build_model(_jax_cfg(arch, **replace))
            jp = jm.init(jax.random.PRNGKey(0))
            models[key] = (jm, jp)
            params[key] = os.path.join(d, f"params{len(params)}.npz")
            np.savez(params[key], **_flat(jax.device_get(jp)))
        jm, jp = models[key]
        inp = inputs[name] = _cell_inputs(jm, kind, layout, rng)
        path = os.path.join(d, f"{name}.npz")
        np.savez(path, **inp)
        want[name] = _jax_cell(jm, jp, kind, layout, inp)
        mesh, B, steps = LAYOUTS[layout]
        jobs.append({"name": name, "kind": "cell", "cell": kind,
                     "arch": arch, "replace": dict(replace, dtype="float32"),
                     "mesh": list(mesh), "shape": [B, S],
                     "steps": 0 if kind == "prefill" else len(steps),
                     "params": params[key], "inputs": path})
    with open(os.path.join(d, "jobs.json"), "w") as f:
        json.dump({"jobs": jobs}, f)
    env = dict(os.environ, PYTHONPATH=f"{ROOT}/src:{ROOT}/tests")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "torch_mesh_worker.py"),
         str(r), "4", os.path.join(d, "store"), os.path.join(d, "jobs.json"),
         d], env=dict(env, PYTHONHASHSEED=str(60 + r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)]
    t0 = time.monotonic()
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(
                timeout=max(t0 + WORLD_S - time.monotonic(), 1))[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"the gloo world of 4 did not finish in {WORLD_S} s")
    if any(p.returncode for p in procs):
        pytest.fail("a rank failed:\n" + "\n".join(logs)[-6000:])
    ranks = []
    for r in range(4):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            js = json.load(f)
        with np.load(os.path.join(d, f"rank{r}.npz")) as z:
            ranks.append((js, {k: z[k] for k in z.files}))
    return {"ranks": ranks, "jax_train": jax_train, "want": want,
            "inputs": inputs}


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(TRAIN))
def test_mesh_steps_match_the_jax_step(run, name):
    arch = TRAIN[name][0]
    want = run["jax_train"][arch][2]
    got = run["ranks"][0][0][name]["metrics"]
    assert [m["step"] for m in got] == list(range(1, STEPS + 1))
    for s, (g, w) in enumerate(zip(got, want)):
        for k, bar in (("loss", LOSS_REL), ("grad_norm", BARS[arch][2])):
            np.testing.assert_allclose(g[k], w[k], rtol=bar,
                                       err_msg=f"{name} step {s} {k}")


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_mesh_gradients_match_jax_leaf_by_leaf(run, name):
    arch = TRAIN[name][0]
    want = run["jax_train"][arch][1]
    arrays = run["ranks"][0][1]
    prefix = f"{name}.grad."
    got = {k[len(prefix):]: v for k, v in arrays.items()
           if k.startswith(prefix)}
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        w = np.asarray(w, np.float32)
        tol = BARS[arch][3] * max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(got[path], w, rtol=0, atol=tol,
                                   err_msg=f"{name} {path}")


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_every_rank_agrees(run, name):
    want = run["ranks"][0][0][name]["metrics"]
    for js, _ in run["ranks"][1:]:
        got = js[name]["metrics"]
        for g, w in zip(got, want):
            assert {k: g[k] for k in ("loss", "grad_norm", "lr")} == \
                {k: w[k] for k in ("loss", "grad_norm", "lr")}


# ---------------------------------------------------------------------------
# serving cells
# ---------------------------------------------------------------------------

def _slice(a, bounds):
    idx = [slice(None)] * a.ndim
    for dim, start, size in bounds:
        idx[dim] = slice(start, start + size)
    return a[tuple(idx)]


@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_logits_match_the_jax_unsharded_step(run, name):
    arch, kind, _ = CELLS[name]
    for js, arrays in run["ranks"]:
        rows = [b for b in js[name]["rows"] if b[0] == 0]
        for i, w in enumerate(run["want"][name]["logits"]):
            key = f"{name}.logits" if kind == "prefill" \
                else f"{name}.logits.{i}"
            np.testing.assert_allclose(arrays[key], _slice(w, rows), rtol=0,
                                       atol=BARS[arch][0],
                                       err_msg=f"{name} step {i}")


@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_cache_blocks_match_the_jax_cache(run, name):
    """Each rank's block of every leaf - conv, ssm, shared_k, shared_v;
    wkv, tm_prev, cm_prev - against the JAX cache's slice under that
    leaf's own sanitized spec."""
    arch = CELLS[name][0]
    want = run["want"][name]["cache"]
    inp = run["inputs"][name]
    assert sorted(want) == (["cm_prev", "tm_prev", "wkv"] if arch == RWKV
                            else ["conv", "shared_k", "shared_v", "ssm"])
    for js, arrays in run["ranks"]:
        for n, w_full in want.items():
            bounds = js[name]["bounds"][n]
            got, w = arrays[f"{name}.cache.{n}"], _slice(w_full, bounds)
            tol = BARS[arch][1] * max(float(np.abs(w_full).max()), 1e-30)
            np.testing.assert_allclose(got, w, rtol=0, atol=tol,
                                       err_msg=f"{name} {n}")
            same = _slice(inp[f"cache.{n}"], bounds) == w
            np.testing.assert_array_equal(got[same], w[same])


def _split_dims(run, name, leaf):
    """{dim: {(start, size)}} of the dims of `leaf` the ranks hold in
    blocks."""
    full = run["inputs"][name][f"cache.{leaf}"].shape
    dims = {}
    for js, _ in run["ranks"]:
        for dim, start, size in js[name]["bounds"][leaf]:
            if size < full[dim]:
                dims.setdefault(dim, set()).add((start, size))
    return dims


@pytest.mark.parametrize("name", sorted(CELLS))
def test_each_leaf_takes_its_block_from_its_own_spec(run, name):
    """The blocks the layouts give: rows over data where B 4 splits (not
    B 1); ssm / wkv heads and conv channels over the model axis where it
    divides them (zamba2's 2 SSM heads on the 1x4 mesh stay whole, its
    128 conv channels split 32 a rank); rwkv6's shift carries whole on
    the model axis; zamba2's strips as the layout says (KV heads over
    model in the default and sequence-over-data layouts, the sequence
    over data or over model)."""
    arch, _, layout = CELLS[name]
    (n_data, n_model), B, _ = LAYOUTS[layout]
    rows = {1} if n_data > 1 and B > 1 else set()
    strips = rows | {3} if layout == "default" else \
        {2, 3} if layout == "seq_data" else {2}
    want = {"tm_prev": rows, "cm_prev": rows, "wkv": strips,
            "conv": rows | {3}, "ssm": rows | ({2} if n_model == 2
                                                else set()),
            "shared_k": strips, "shared_v": strips}
    for leaf in run["want"][name]["cache"]:
        dims = _split_dims(run, name, leaf)
        assert set(dims) == want[leaf], (leaf, dims)
        if leaf == "conv":
            assert {s for _, s in dims[3]} == {128 // n_model}
        if leaf in STRIPS and layout != "default":
            assert {s for _, s in dims[2]} == {S // (n_data if layout ==
                                                     "seq_data"
                                                     else n_model)}
