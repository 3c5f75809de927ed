"""The serving cells on a (data, model) mesh (ROADMAP M14b): launch/
specs.py prefill_cell's and serve_cell's steps in a gloo world of four
processes on the CPU (tests/torch_mesh_worker.py "cell" jobs, each rank
a process of its own), against the JAX package's unsharded Model.prefill
and Model.decode_step of the same float32 weights (the JAX Model.init
tree through repro_torch/models/convert.py) on the same inputs.

The three cache layouts of sharding/rules.py cache_spec, each reached the
way launch/specs.py _kv_seq_sharded reaches it with the gemma3-4b smoke
config (4 query / 2 KV heads of 16, a 32-position window on two layers of
three):
- default, P(None, dp, None, tp, None): B 4 on 2x2 - the JAX
  tests/test_distributed.py case (S 32, lens 7), two decode steps;
  K3's plain version on each rank's KV head, the heads gathered;
- sequence over data, P(None, None, "data", tp, None): B 1 on 2x2, the
  new token at positions 15 then 16, the second in the other data
  rank's half;
- sequence over model, P(None, dp, "model", None, None): 2 KV heads on
  the 1x4 mesh's model axis of 4, lanes at 7, 8, 15, 23 then one
  further, each crossing or meeting a shard boundary of 8 positions.
The sequence-sharded decodes are held against JAX's decode_step with
seq_parallel=True (its naive decode: no window, ROADMAP §3).  Prefill:
prefill_cell's step on 2x2 (default), 1x4 (sequence over model) and B 1
on 2x2 (sequence over data).

Bars: logits within 1e-5 of the JAX step (float32; the JAX package's own
0.15 in tests/test_distributed.py is for bfloat16); each rank's cache
shard within 1e-5 of the JAX cache's slice at the rank's bounds (written
pools are not bit-equal in float32: ROADMAP §3), and a slice that a step
did not write equal to its input exactly.  Also the hybrid and ssm
families' cells on the same 2x2 mesh (the worker's "family_cells" job):
their prefill and decode steps run, their logits finite (held against
the JAX package in tests/test_torch_recurrent_mesh.py), and their train
cell's step, whose model lies on the meta device, no longer refuses by
name (the scans have backward kernels): called without a state, it
stops only where it reads the state.
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
from repro.models import build_model as jax_build_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "gemma3-4b"
F32 = 1e-5
WORLD_S = 120
# name: (kind, mesh, (B, S), lens of each decode step)
CELLS = {
    "decode_2x2": ("decode", (2, 2), (4, 32), [[7] * 4, [8] * 4]),
    "decode_seq_data": ("decode", (2, 2), (1, 32), [[15], [16]]),
    "decode_seq_model": ("decode", (1, 4), (4, 32),
                         [[7, 8, 15, 23], [8, 9, 16, 24]]),
    "prefill_2x2": ("prefill", (2, 2), (4, 32), None),
    "prefill_seq_model": ("prefill", (1, 4), (4, 32), None),
    "prefill_seq_data": ("prefill", (2, 2), (1, 32), None),
}
LAYOUTS = {"decode_2x2": "default", "prefill_2x2": "default",
           "decode_seq_data": "seq_data", "prefill_seq_data": "seq_data",
           "decode_seq_model": "seq_model",
           "prefill_seq_model": "seq_model"}
# the recurrent families and the scan kernel each one's training needs a
# backward of
FAMILIES = {"zamba2-2.7b": "K6 mamba2_scan", "rwkv6-1.6b": "K7 rwkv6_scan"}
REFUSED = tuple(FAMILIES)


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{pre}{k}/"))
        else:
            out[pre + k] = np.asarray(v)
    return out


def _jax_reference(jm, jp, name, inp):
    kind, _, (B, S), steps = CELLS[name]
    if kind == "prefill":
        cache = jm.init_cache(B, S)
        logits, cache, lens = jax.jit(jm.prefill)(
            jp, {"tokens": jnp.asarray(inp["tokens"])}, cache)
        return {"logits": [np.asarray(logits)],
                "cache": {n: np.asarray(cache[n]) for n in ("k", "v")}}
    seq_parallel = LAYOUTS[name] != "default"
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
    d = str(tmp_path_factory.mktemp("serve_cells"))
    cfg = jax_smoke_config(ARCH).replace(dtype="float32")
    jm = jax_build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    np.savez(os.path.join(d, "params.npz"), **_flat(jax.device_get(jp)))
    rng = np.random.default_rng(11)
    L, Hkv, D = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    jobs, inputs, want = [], {}, {}
    for name, (kind, mesh, (B, S), steps) in CELLS.items():
        inp = {"cache.k": np.zeros((L, B, S, Hkv, D), np.float32),
               "cache.v": np.zeros((L, B, S, Hkv, D), np.float32)}
        if kind == "prefill":
            inp["tokens"] = rng.integers(0, cfg.vocab_size, (B, S),
                                         dtype=np.int32)
        else:
            # a filled cache: the lanes' earlier positions hold K/V
            for n in ("k", "v"):
                inp[f"cache.{n}"] = rng.standard_normal(
                    (L, B, S, Hkv, D)).astype(np.float32)
            for i, lens in enumerate(steps):
                inp[f"tokens.{i}"] = rng.integers(0, cfg.vocab_size, (B, 1),
                                                  dtype=np.int32)
                inp[f"lens.{i}"] = np.asarray(lens, np.int32)
        path = os.path.join(d, f"{name}.npz")
        np.savez(path, **inp)
        inputs[name] = inp
        want[name] = _jax_reference(jm, jp, name, inp)
        jobs.append({"name": name, "kind": "cell", "cell": kind,
                     "arch": ARCH, "replace": {"dtype": "float32"},
                     "mesh": list(mesh),
                     "shape": [B, S],
                     "steps": 0 if steps is None else len(steps),
                     "params": os.path.join(d, "params.npz"),
                     "inputs": path})
    jobs.append({"name": "refuse", "kind": "family_cells", "mesh": [2, 2],
                 "archs": list(REFUSED)})
    with open(os.path.join(d, "jobs.json"), "w") as f:
        json.dump({"jobs": jobs}, f)
    env = dict(os.environ, PYTHONPATH=f"{ROOT}/src:{ROOT}/tests")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "torch_mesh_worker.py"),
         str(r), "4", os.path.join(d, "store"), os.path.join(d, "jobs.json"),
         d], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(4)]
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
    return {"ranks": ranks, "want": want, "inputs": inputs}


def _slice(a, bounds, lead=0):
    """a's block at slice_bounds `bounds` (dims counted from `lead`)."""
    idx = [slice(None)] * a.ndim
    for dim, start, size in bounds:
        idx[dim + lead] = slice(start, start + size)
    return a[tuple(idx)]


def _row_bounds(bounds):
    return [b for b in bounds if b[0] == 0]


@pytest.mark.parametrize("name", sorted(CELLS))
def test_logits_match_the_jax_unsharded_step(run, name):
    want = run["want"][name]["logits"]
    for js, arrays in run["ranks"]:
        rows = _row_bounds(js[name]["rows"])
        for i, w in enumerate(want):
            key = f"{name}.logits" if CELLS[name][0] == "prefill" \
                else f"{name}.logits.{i}"
            got = arrays[key]
            np.testing.assert_allclose(got, _slice(w, rows), rtol=0,
                                       atol=F32, err_msg=f"{name} step {i}")


@pytest.mark.parametrize("name", sorted(CELLS))
def test_each_rank_holds_its_slice_of_the_jax_cache(run, name):
    want = run["want"][name]["cache"]
    inp = run["inputs"][name]
    for js, arrays in run["ranks"]:
        for n in ("k", "v"):
            bounds = js[name]["bounds"][n]
            got = arrays[f"{name}.cache.{n}"]
            w = _slice(want[n], bounds)
            np.testing.assert_allclose(got, w, rtol=0, atol=F32,
                                       err_msg=f"{name} {n}")
            # what no step wrote is the input, bit for bit
            same = _slice(inp[f"cache.{n}"], bounds) == w
            np.testing.assert_array_equal(got[same], w[same])


@pytest.mark.parametrize("name", sorted(CELLS))
def test_the_cell_shards_as_its_layout_says(run, name):
    """Each layout's block: heads over the model axis (default, sequence
    over data), the sequence over data or over model."""
    layout = LAYOUTS[name]
    kind, mesh, (B, S), _ = CELLS[name]
    full = run["inputs"][name]["cache.k"].shape
    dims = {}
    for js, _ in run["ranks"]:
        for dim, start, size in js[name]["bounds"]["k"]:
            if size < full[dim]:                 # a dim split in blocks
                dims.setdefault(dim, set()).add((start, size))
    if layout == "default" and B > 1:
        assert set(dims) == {1, 3}           # rows over data, KV heads
    elif layout == "seq_data":
        assert set(dims) == {2, 3}
        assert {s for _, s in dims[2]} == {S // mesh[0]}
    else:
        assert set(dims) == {2}
        assert {s for _, s in dims[2]} == {S // mesh[1]}


@pytest.mark.parametrize("arch", REFUSED)
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_other_families_refuse_the_mesh_by_name(run, arch, kind):
    """The hybrid and ssm families on the mesh: the prefill and decode
    cells run on each rank's rows (2 of the 4; finite logits), and the
    train cell's step, whose model lies on the meta device, is no longer
    refused by name: called without a state or a batch, it gets past
    train/train_step.py check_backward and stops only where it first
    reads the missing state (launch/dryrun.py costs it with one)."""
    for js, _ in run["ranks"]:
        got = js["refuse"][f"{arch}.{kind}"]
        if kind == "train":
            assert got is not None and got.startswith("AttributeError") \
                and "'NoneType' object has no attribute 'params'" in got \
                and FAMILIES[arch] not in got, got
        else:
            assert got == {"shape": [2, 1, 256], "finite": True}, got
