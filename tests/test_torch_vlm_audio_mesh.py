"""The vlm and audio families on a (data, model) mesh (ROADMAP §1 item 3):
the mesh Trainer and launch/specs.py prefill_cell's and serve_cell's
steps on the llava-next-34b and whisper-base smoke configs, in ONE gloo
world of four processes on the CPU (tests/torch_mesh_worker.py, each rank
a subprocess meeting through a FileStore under the fixture's directory;
WORLD_S seconds, after which the fixture kills them and fails), against
the JAX package on the same numpy-seeded inputs and the JAX Model.init
weights (repro_torch/models/convert.py on the rank's side), float32.

Training: Trainer(mesh=, state_shardings=train_cell(...)[2][0]), remat
full, STEPS steps of a global 4 x 48 batch from the JAX init state, on
- llava 2x2 (4 query / 2 KV heads, 8 image positions ahead of 40 text
  tokens) and whisper 2x2 (4 / 4 heads; its encoder, its decoder's self
  and cross-attention each on the rank's head shard);
- llava with 14 query / 2 KV heads on 1x4: each group's 7 query heads
  split 4 + 3 over its two ranks (kernels/ops.py _head_blocks' uneven
  split, the pad of the head gathers dropped forwards and backwards).
The batches hold the frontends' embeddings in float32 on both sides (the
worker's "float32_embeds": the pipeline hands them over in bfloat16, as
the JAX one does, which makes whisper's float32 encoder run on bfloat16
activations, where one rounding flipped by a summation order moves the
loss by ~1e-5 - tests/test_torch_whisper.py; in float32 the bar below
measures the mesh, not that).

Serving: the prefill and decode cells of both families in the three
layouts of sharding/rules.py cache_spec, reached the way launch/specs.py
_kv_seq_sharded reaches them: default on 2x2 with B 4; the sequence over
data on 2x2 with B 1; the sequence over model on 1x4 (llava's 2 KV heads
as they are, whisper's 4 replaced by 2).  Decode lanes sit at and across
the shard boundaries (8 positions on the model axis of 4, 16 on the data
axis of 2); whisper's cross strips are 32 positions, split with its self
strips, and the decode's default enc_lens must be the whole strip's.
The sequence-sharded decodes are held against JAX's decode_step with
seq_parallel=True (its naive decode, as tests/test_torch_serve_cells.py).

Bars (float32: the two frameworks sum the projections in other orders,
and the mesh sums the gradients and the loss shares over the data ranks
in another order again):
- each step's loss and grad norm within 1e-5 relative of the JAX single-
  device train step; every rank's metrics equal rank 0's exactly;
- each leaf's gradient of the first step (the mesh step's (a)-(c), before
  the clip) within 1e-5 of the leaf's largest |entry| of jax.grad (the
  bar of tests/test_torch_train.py);
- logits within 1e-5 absolute of the JAX unsharded prefill / decode_step;
  each rank's cache shard within 1e-5 of the JAX cache's slice, and what
  no step wrote equal to the input bit for bit; whisper's cross strips
  after every decode step equal to their input bit for bit;
- the uneven head split on its own (the worker's "heads" job on the
  plain K4 / K5): o and dq bit-equal to the unsharded call through
  autograd (per-head work, only moved), dk and dv within 1e-6 of their
  largest |entry| (two ranks share each KV head and add their parts in
  rank order, where the unsharded backward sums its 7 query heads in
  one reduction).
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
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.models import build_model as jax_build_model
from repro.train import init_train_state as j_init_train_state
from repro.train import make_train_step as j_make_train_step
from repro.train.checkpoint import save_checkpoint as j_save
from repro_torch.kernels import ops
from repro_torch.tree import leaves_with_paths

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_S = 300
F32 = 1e-5
HEAD_BAR = 1e-6
STEPS = 2
TC = dict(global_batch=4, seq_len=48, total_steps=20, warmup_steps=1,
          checkpoint_every=0, log_every=1, remat="full")
LLAVA, WHISPER = "llava-next-34b", "whisper-base"
UNEVEN = {"n_heads": 14, "n_kv_heads": 2}
# job -> (arch, mesh, config fields replaced)
TRAIN = {"llava_2x2": (LLAVA, (2, 2), {}),
         "whisper_2x2": (WHISPER, (2, 2), {}),
         "llava_uneven_1x4": (LLAVA, (1, 4), UNEVEN)}
S = 32
LANES = [[7, 8, 15, 23], [8, 9, 16, 24]]
# layout -> (mesh, B, decode lens of each step)
LAYOUTS = {"default": ((2, 2), 4, LANES),
           "seq_data": ((2, 2), 1, [[15], [16]]),
           "seq_model": ((1, 4), 4, LANES)}
ARCHS = {LLAVA: "llava", WHISPER: "whisper"}
# whisper's 4 KV heads divide the model axis of 4: 2 of them reach the
# sequence-over-model layout, as llava's 2 do
SEQ_MODEL = {WHISPER: {"n_kv_heads": 2}}
CELLS = {f"{ARCHS[a]}_{kind}_{lay}": (a, kind, lay)
         for a in ARCHS for kind in ("prefill", "decode") for lay in LAYOUTS}
HEAD_CASES = {"uneven_causal": ((1, 24, 14, 16), 24, True),
              "uneven_cross": ((2, 12, 14, 16), 20, False)}


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{pre}{k}/"))
        else:
            out[pre + k] = np.asarray(v)
    return out


def _replace(arch, layout):
    return SEQ_MODEL.get(arch, {}) if layout == "seq_model" else {}


def _jax_cfg(arch, **over):
    return jax_smoke_config(arch).replace(dtype="float32", **over)


def _embeds(cfg, rng, B, S_total):
    """The frontend's embeddings of a batch of B rows of S_total
    positions: llava's image (B, frontend_tokens, d), whisper's frames
    (B, S_total, d), float32; and the text length."""
    if cfg.family == "vlm":
        P = cfg.frontend_tokens
        return {"vision_embeds": (rng.standard_normal(
            (B, P, cfg.d_model)) * 0.02).astype(np.float32)}, S_total - P
    return {"audio_embeds": (rng.standard_normal(
        (B, S_total, cfg.d_model)) * 0.02).astype(np.float32)}, S_total


def _batches(arch, replace):
    """The numpy-seeded global batches of steps 1..STEPS: {step: batch}."""
    cfg = _jax_cfg(arch, **replace)
    rng = np.random.default_rng(21)
    out = {}
    for s in range(1, STEPS + 1):
        emb, s_text = _embeds(cfg, rng, TC["global_batch"], TC["seq_len"])
        out[s] = dict(emb, tokens=rng.integers(
            0, cfg.vocab_size, (TC["global_batch"], s_text),
            dtype=np.int32))
    return out


def _jax_train(arch, replace, batches):
    """The JAX single-device step: the initial state, the first step's
    gradients (before the clip) and STEPS steps' metrics."""
    jm = jax_build_model(_jax_cfg(arch, **replace))
    jtc = JaxTrainConfig(**TC)
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


def _cell_inputs(cfg, kind, layout, rng):
    """A cell's inputs: the cache (zeros to prefill, random K/V to decode
    against) and the prompt batch or each decode step's tokens and lens."""
    mesh, B, steps = LAYOUTS[layout]
    L, Hkv, D = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    names = ("self_k", "self_v", "cross_k", "cross_v") \
        if cfg.family == "audio" else ("k", "v")
    inp = {}
    for n in names:
        inp[f"cache.{n}"] = np.zeros((L, B, S, Hkv, D), np.float32) \
            if kind == "prefill" else rng.standard_normal(
                (L, B, S, Hkv, D)).astype(np.float32)
    if kind == "prefill":
        emb, s_text = _embeds(cfg, rng, B, S)
        inp.update(emb)
        inp["tokens"] = rng.integers(0, cfg.vocab_size, (B, s_text),
                                     dtype=np.int32)
    else:
        for i, lens in enumerate(steps):
            inp[f"tokens.{i}"] = rng.integers(0, cfg.vocab_size, (B, 1),
                                              dtype=np.int32)
            inp[f"lens.{i}"] = np.asarray(lens, np.int32)
    return inp


def _jax_cell(jm, jp, kind, layout, inp):
    cfg = jm.cfg
    names = [k[len("cache."):] for k in inp if k.startswith("cache.")]
    B = inp[f"cache.{names[0]}"].shape[1]
    if kind == "prefill":
        cache = jm.init_cache(B, S, enc_len=S) if cfg.family == "audio" \
            else jm.init_cache(B, S)
        batch = {k: jnp.asarray(inp[k]) for k in inp
                 if not k.startswith("cache.")}
        logits, cache, _ = jax.jit(jm.prefill)(jp, batch, cache)
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


def _head_inputs(d):
    rng = np.random.default_rng(9)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    arrays = {}
    for case, ((B, Sq, Hq, D), Skv, _) in HEAD_CASES.items():
        arrays.update({f"{case}.q": f(B, Sq, Hq, D),
                       f"{case}.k": f(B, Skv, 2, D),
                       f"{case}.v": f(B, Skv, 2, D),
                       f"{case}.do": f(B, Sq, Hq, D)})
    path = os.path.join(d, "heads.npz")
    np.savez(path, **arrays)
    return arrays, path


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("vlm_audio_mesh"))
    jobs, jax_train, batches = [], {}, {}
    for name, (arch, mesh, replace) in TRAIN.items():
        b = batches[name] = _batches(arch, replace)
        path = os.path.join(d, f"{name}.batches.npz")
        np.savez(path, **{(str(s) if k == "tokens" else f"{s}.{k}"): v
                          for s, bb in b.items() for k, v in bb.items()})
        jax_train[name] = _jax_train(arch, replace, b)
        ckpt = os.path.join(d, name)
        j_save(ckpt, 0, jax_train[name][0])
        jobs.append(dict(name=name, kind="train", arch=arch,
                         dtype="float32", replace=replace, mesh=list(mesh),
                         tcfg=dict(TC, checkpoint_dir=ckpt), batches=path,
                         steps=STEPS, float32_embeds=True))
    rng = np.random.default_rng(13)
    params, models, want, inputs = {}, {}, {}, {}
    for name, (arch, kind, layout) in CELLS.items():
        replace = _replace(arch, layout)
        key = (arch, tuple(sorted(replace.items())))
        if key not in models:
            jm = jax_build_model(_jax_cfg(arch, **replace))
            jp = jm.init(jax.random.PRNGKey(0))
            models[key] = (jm, jp)
            params[key] = os.path.join(d, f"params{len(params)}.npz")
            np.savez(params[key], **_flat(jax.device_get(jp)))
        jm, jp = models[key]
        inp = inputs[name] = _cell_inputs(jm.cfg, kind, layout, rng)
        path = os.path.join(d, f"{name}.npz")
        np.savez(path, **inp)
        want[name] = _jax_cell(jm, jp, kind, layout, inp)
        mesh, B, steps = LAYOUTS[layout]
        jobs.append({"name": name, "kind": "cell", "cell": kind,
                     "arch": arch, "replace": dict(replace, dtype="float32"),
                     "mesh": list(mesh), "shape": [B, S],
                     "steps": 0 if kind == "prefill" else len(steps),
                     "params": params[key], "inputs": path,
                     "after": ["cross_k", "cross_v"]
                     if arch == WHISPER and kind == "decode" else []})
    heads, hpath = _head_inputs(d)
    jobs.append({"name": "heads", "kind": "heads", "device": "cpu",
                 "cases": sorted(HEAD_CASES), "inputs": hpath,
                 "causal": {c: v[2] for c, v in HEAD_CASES.items()}})
    with open(os.path.join(d, "jobs.json"), "w") as f:
        json.dump({"jobs": jobs}, f)
    env = dict(os.environ, PYTHONPATH=f"{ROOT}/src:{ROOT}/tests")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "torch_mesh_worker.py"),
         str(r), "4", os.path.join(d, "store"), os.path.join(d, "jobs.json"),
         d], env=dict(env, PYTHONHASHSEED=str(40 + r)),
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
            "inputs": inputs, "heads": heads}


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(TRAIN))
def test_mesh_steps_match_the_jax_step(run, name):
    want = run["jax_train"][name][2]
    got = run["ranks"][0][0][name]["metrics"]
    assert [m["step"] for m in got] == list(range(1, STEPS + 1))
    for s, (g, w) in enumerate(zip(got, want)):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=F32,
                                       err_msg=f"{name} step {s} {k}")


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_mesh_gradients_match_jax_leaf_by_leaf(run, name):
    want = run["jax_train"][name][1]
    arrays = run["ranks"][0][1]
    prefix = f"{name}.grad."
    got = {k[len(prefix):]: v for k, v in arrays.items()
           if k.startswith(prefix)}
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        w = np.asarray(w, np.float32)
        tol = F32 * max(float(np.abs(w).max()), 1e-30)
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


@pytest.mark.parametrize("case", sorted(HEAD_CASES))
def test_the_uneven_head_split_matches_the_unsharded_call(run, case):
    a = {k: torch.from_numpy(run["heads"][f"{case}.{k}"])
         for k in ("q", "k", "v", "do")}
    q, k, v = (a[x].clone().requires_grad_(True) for x in ("q", "k", "v"))
    o = ops.flash_attention(q, k, v, causal=HEAD_CASES[case][2])
    o.backward(a["do"])
    want = {"o": o, "dq": q.grad, "dk": k.grad, "dv": v.grad}
    for r, (_, arrays) in enumerate(run["ranks"]):
        for name, w in want.items():
            g, w = arrays[f"{case}.{name}"], w.detach().numpy()
            if name in ("o", "dq"):
                assert np.array_equal(g, w), (r, name,
                                              float(np.abs(g - w).max()))
            else:
                np.testing.assert_allclose(
                    g, w, rtol=0, atol=HEAD_BAR * float(np.abs(w).max()),
                    err_msg=f"rank {r} {name}")


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
    kind = CELLS[name][1]
    for js, arrays in run["ranks"]:
        rows = [b for b in js[name]["rows"] if b[0] == 0]
        for i, w in enumerate(run["want"][name]["logits"]):
            key = f"{name}.logits" if kind == "prefill" \
                else f"{name}.logits.{i}"
            np.testing.assert_allclose(arrays[key], _slice(w, rows), rtol=0,
                                       atol=F32, err_msg=f"{name} step {i}")


@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_cache_shards_match_the_jax_cache(run, name):
    want = run["want"][name]["cache"]
    inp = run["inputs"][name]
    for js, arrays in run["ranks"]:
        for n, w_full in want.items():
            bounds = js[name]["bounds"][n]
            got, w = arrays[f"{name}.cache.{n}"], _slice(w_full, bounds)
            np.testing.assert_allclose(got, w, rtol=0, atol=F32,
                                       err_msg=f"{name} {n}")
            same = _slice(inp[f"cache.{n}"], bounds) == w
            np.testing.assert_array_equal(got[same], w[same])


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_decode_leaves_the_cross_strips_as_they_were(run, layout):
    name = f"whisper_decode_{layout}"
    inp = run["inputs"][name]
    for js, arrays in run["ranks"]:
        for i in range(len(LAYOUTS[layout][2])):
            for n in ("cross_k", "cross_v"):
                want = _slice(inp[f"cache.{n}"], js[name]["bounds"][n])
                np.testing.assert_array_equal(
                    arrays[f"{name}.after.{i}.{n}"], want,
                    err_msg=f"{name} step {i} {n}")


@pytest.mark.parametrize("name", sorted(CELLS))
def test_the_cell_shards_as_its_layout_says(run, name):
    """Each layout's block of every strip (whisper's self and cross strips
    alike): rows over data and KV heads over model (default); the
    sequence over data and the KV heads (sequence over data); the
    sequence over model (sequence over model)."""
    arch, kind, layout = CELLS[name]
    mesh, B, _ = LAYOUTS[layout]
    for n in [k[len("cache."):] for k in run["inputs"][name]
              if k.startswith("cache.")]:
        full = run["inputs"][name][f"cache.{n}"].shape
        dims = {}
        for js, _ in run["ranks"]:
            for dim, start, size in js[name]["bounds"][n]:
                if size < full[dim]:
                    dims.setdefault(dim, set()).add((start, size))
        if layout == "default":
            assert set(dims) == {1, 3}, (n, dims)
        elif layout == "seq_data":
            assert set(dims) == {2, 3}, (n, dims)
            assert {s for _, s in dims[2]} == {S // mesh[0]}
        else:
            assert set(dims) == {2}, (n, dims)
            assert {s for _, s in dims[2]} == {S // mesh[1]}
