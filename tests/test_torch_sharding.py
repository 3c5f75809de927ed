"""The port's sharding rules, meshes and cell specs (ROADMAP M14a) against
the JAX package's on the CPU.

- param_spec: the port's equals tuple(JAX's) for every leaf path of every
  registered architecture's smoke params (the JAX Model.init tree through
  eval_shape, no devices), under ("data", "model") and ("pod", "data",
  "model"); param_sharding_tree on the port's own parameter tree gives
  the same specs at the same paths.  cache_spec in its three cases.
- the cells: a subprocess with 8 forced host devices runs the JAX
  package's train_cell, prefill_cell and serve_cell at a (2, 2) and a
  (2, 2, 2) mesh; another runs the port's on DeviceMeshes of the "fake"
  process-group backend (a test utility of torch, never imported by the
  package; no process is started for the ranks).  Every leaf of every
  cell has the same path, shape, dtype and sanitized spec in both.  The
  same subprocess builds make_production_mesh at (16, 16) and (2, 16, 16)
  in fake worlds of 256 and 512 ranks and sees a world of another size
  refused.
- local shards: in a gloo world of four processes (tests/
  torch_mesh_worker.py), each rank's shard of a tensor under a spec
  (sharding/shards.py local_slice, and DTensor's own distribute_tensor)
  equals the slice JAX's NamedSharding(...).devices_indices_map gives the
  device at the same coordinate of a (2, 2) mesh, element for element.
All exact: the rules are the same integer arithmetic.
"""
import json
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro.sharding.rules import cache_spec as j_cache_spec
from repro.sharding.rules import param_spec as j_param_spec
from repro_torch.configs import ARCH_MODULES, get_smoke_config
from repro_torch.models import build_model
from repro_torch.sharding import (P, cache_spec, constrain, param_spec,
                                  placements, tree_paths)
from repro_torch.tree import leaves_with_paths

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = [("data", "model"), ("pod", "data", "model")]
SUB_S = 240
# (shape, spec) cases for the local shards on the (2, 2) mesh
SLICE_CASES = [((4, 6), ("data", "model")), ((6, 4), ("model", "data")),
               ((8, 3), (("data", "model"), None)),
               ((3, 8), (None, ("data", "model"))),
               ((2, 4, 6), (None, "data", "model")),
               ((2, 6, 4), (None, "model", "data")),
               ((4, 2, 2), ("data", None, "model")), ((5, 3), ())]

_JAX_CELLS = r"""
import json, sys
import jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.compat import make_mesh
from repro.configs import get_smoke_config
from repro.configs.base import ShapeSpec, TrainConfig
from repro.launch.specs import prefill_cell, serve_cell, train_cell

def flat(args, shardings):
    out = []
    fa = jax.tree_util.tree_flatten_with_path(args)[0]
    fs = jax.tree_util.tree_leaves(shardings,
                                   is_leaf=lambda x: isinstance(x, NamedSharding))
    assert len(fa) == len(fs)
    for (kp, a), s in zip(fa, fs):
        path = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in kp)
        out.append([path, list(a.shape), str(a.dtype),
                    [list(e) if isinstance(e, tuple) else e for e in s.spec]])
    return out

spec = json.loads(sys.argv[1])
res = {}
for shape, names in spec["meshes"]:
    mesh = make_mesh(tuple(shape), tuple(names))
    for arch in spec["archs"]:
        cfg = get_smoke_config(arch)
        for kind, (seq, batch) in spec["shapes"].items():
            sh = ShapeSpec(kind, seq, batch, kind)
            if kind.startswith("train"):
                _, args, shd = train_cell(cfg, sh, mesh, TrainConfig(
                    global_batch=batch, seq_len=seq,
                    grad_compression="int8"))
            elif kind.startswith("prefill"):
                _, args, shd = prefill_cell(cfg, sh, mesh)
            else:
                _, args, shd = serve_cell(cfg, sh, mesh)
            res[f"{len(shape)}|{arch}|{kind}"] = flat(args, shd)
mesh = make_mesh((2, 2), ("data", "model"))
slices = []
for shape, sp in spec["slices"]:
    sp = tuple(tuple(e) if isinstance(e, list) else e for e in sp)
    m = NamedSharding(mesh, P(*sp)).devices_indices_map(tuple(shape))
    per = {}
    for i in range(2):
        for j in range(2):
            idx = m[mesh.devices[i, j]]
            per[f"{i},{j}"] = [[s.start or 0,
                                shape[d] if s.stop is None else s.stop]
                               for d, s in enumerate(idx)]
    slices.append(per)
res["slices"] = slices
json.dump(res, open(spec["out"], "w"))
"""

_PORT_CELLS = r"""
import json, sys
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import TrainConfig, get_smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch.mesh import _mesh, make_production_mesh
from repro_torch.launch.specs import prefill_cell, serve_cell, train_cell
from repro_torch.sharding.rules import NamedSharding
from repro_torch.tree import leaves_with_paths

def flat(args, shardings):
    # a plain tuple's element i is "i/" on its leaves' paths, as in JAX
    def walk(a, s, pre):
        if isinstance(a, tuple) and not hasattr(a, "_fields"):
            return [x for i, (aa, ss) in enumerate(zip(a, s))
                    for x in walk(aa, ss, f"{pre}{i}/")]
        la, ls = leaves_with_paths(a), leaves_with_paths(s)
        assert [p for p, _ in la] == [p for p, _ in ls]
        return [[pre + p if p else pre.rstrip("/"), list(t.shape),
                 str(t.dtype).replace("torch.", ""),
                 [list(e) if isinstance(e, tuple) else e for e in sh.spec]]
                for (p, t), (_, sh) in zip(la, ls)]
    return walk(args, shardings, "")

def world(n):
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)

spec = json.loads(sys.argv[1])
res = {}
for shape, names in spec["meshes"]:
    n = 1
    for s in shape:
        n *= s
    world(n)
    mesh = _mesh(tuple(shape), tuple(names), "cpu")
    for arch in spec["archs"]:
        cfg = get_smoke_config(arch)
        for kind, (seq, batch) in spec["shapes"].items():
            sh = ShapeSpec(kind, seq, batch, kind)
            if kind.startswith("train"):
                step, args, shd = train_cell(cfg, sh, mesh, TrainConfig(
                    global_batch=batch, seq_len=seq,
                    grad_compression="int8"))
                assert callable(step)
            elif kind.startswith("prefill"):
                step, args, shd = prefill_cell(cfg, sh, mesh)
                assert callable(step)
            else:
                step, args, shd = serve_cell(cfg, sh, mesh)
                assert callable(step)
            res[f"{len(shape)}|{arch}|{kind}"] = flat(args, shd)
prod = {}
for multi, n in ((False, 256), (True, 512)):
    world(n)
    m = make_production_mesh(multi_pod=multi)
    prod[str(multi)] = [list(m.shape), list(m.mesh_dim_names), m.device_type]
world(8)
try:
    make_production_mesh()
    prod["refused"] = None
except ValueError as e:
    prod["refused"] = str(e)
res["production"] = prod
json.dump(res, open(spec["out"], "w"))
"""

SHAPES = {"train": (32, 8), "prefill": (32, 4), "decode": (32, 8),
          "decode_b1": (32, 1)}


def _jax_params_shape(arch):
    jm = jax_build_model(jax_smoke_config(arch))
    return jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))


@pytest.mark.parametrize("names", NAMES, ids=lambda n: "x".join(n))
@pytest.mark.parametrize("arch", sorted(ARCH_MODULES))
def test_param_spec_matches_jax(arch, names):
    jparams = _jax_params_shape(arch)
    want = {p: tuple(j_param_spec(p, len(leaf.shape), names))
            for p, leaf in leaves_with_paths(jax.device_get(jparams))}
    got = {p: param_spec(p, leaf.ndim, names)
           for p, leaf in tree_paths(jparams)}
    assert got == want
    # the port's own tree has the same paths and gets the same specs
    port = build_model(get_smoke_config(arch), "meta").params
    assert {p: param_spec(p, t.ndim, names)
            for p, t in leaves_with_paths(port)} == want


@pytest.mark.parametrize("names", NAMES + [("model",), ("data",), ()],
                         ids=lambda n: "x".join(n) or "none")
def test_cache_spec_matches_jax(names):
    for kw in (dict(seq_sharded=False), dict(seq_sharded=True),
               dict(seq_sharded=True, seq_axis="model")):
        assert cache_spec(names, **kw) == tuple(j_cache_spec(names, **kw))


def test_spec_entries_and_constrain():
    assert P(("data",), "model") == ("data", "model")
    assert P(("pod", "data"), None) == (("pod", "data"), None)
    x = object()
    assert constrain(x, "bshd") is x and constrain(x, "btd") is x


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """Both packages' cells (two subprocesses) and the gloo world's local
    shards, started together."""
    d = str(tmp_path_factory.mktemp("cells"))
    base = {"meshes": [[[2, 2], ["data", "model"]],
                       [[2, 2, 2], ["pod", "data", "model"]]],
            "archs": sorted(ARCH_MODULES), "shapes": SHAPES,
            "slices": [[list(s), list(sp)] for s, sp in SLICE_CASES]}
    env = dict(os.environ, PYTHONPATH=f"{ROOT}/src:{ROOT}/tests",
               JAX_PLATFORMS="cpu", PYTHONHASHSEED="0",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    procs = {side: subprocess.Popen(
        [sys.executable, "-c", script,
         json.dumps(dict(base, out=os.path.join(d, f"{side}.json")))],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for side, script in (("jax", _JAX_CELLS),
                                        ("port", _PORT_CELLS))}
    jobs = [{"name": "slices", "kind": "slices", "mesh": [2, 2],
             "names": ["data", "model"],
             "cases": [[list(s), [list(e) if isinstance(e, tuple) else e
                                  for e in sp]] for s, sp in SLICE_CASES]}]
    with open(os.path.join(d, "jobs.json"), "w") as f:
        json.dump({"jobs": jobs}, f)
    wenv = dict(os.environ, PYTHONPATH=f"{ROOT}/src:{ROOT}/tests")
    ranks = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "torch_mesh_worker.py"),
         str(r), "4", os.path.join(d, "store"),
         os.path.join(d, "jobs.json"), d], env=wenv,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)]
    t0 = time.monotonic()
    out = {}
    for name, p in list(procs.items()) + [(f"rank{r}", p)
                                          for r, p in enumerate(ranks)]:
        try:
            log = p.communicate(
                timeout=max(t0 + SUB_S - time.monotonic(), 1))[0]
        except subprocess.TimeoutExpired:
            for q in list(procs.values()) + ranks:
                q.kill()
            pytest.fail(f"{name} did not finish in {SUB_S} s")
        assert p.returncode == 0, f"{name}:\n{log[-4000:]}"
    for side in procs:
        with open(os.path.join(d, f"{side}.json")) as f:
            out[side] = json.load(f)
    out["ranks"] = []
    for r in range(4):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            js = json.load(f)
        with np.load(os.path.join(d, f"rank{r}.npz")) as z:
            out["ranks"].append((js, {k: z[k] for k in z.files}))
    return out


@pytest.mark.parametrize("kind", sorted(SHAPES))
@pytest.mark.parametrize("mesh", [2, 3], ids=["2x2", "2x2x2"])
def test_cells_match_jax_leaf_by_leaf(cells, mesh, kind):
    n = 0
    for arch in sorted(ARCH_MODULES):
        key = f"{mesh}|{arch}|{kind}"
        want, got = cells["jax"][key], cells["port"][key]
        assert [x[0] for x in got] == [x[0] for x in want], key
        for g, w in zip(got, want):
            assert g == w, (key, g, w)
        n += len(got)
    assert n > 100


def test_production_meshes_on_the_fake_backend(cells):
    prod = cells["port"]["production"]
    assert prod["False"] == [[16, 16], ["data", "model"], "cuda"]
    assert prod["True"] == [[2, 16, 16], ["pod", "data", "model"], "cuda"]
    assert "needs a world of 256 ranks, the process group has 8" \
        in prod["refused"] and "torchrun" in prod["refused"]


@pytest.mark.parametrize("case", range(len(SLICE_CASES)))
def test_local_shards_are_the_jax_device_slices(cells, case):
    shape, spec = SLICE_CASES[case]
    full = np.arange(int(np.prod(shape))).reshape(shape)
    jslices = cells["jax"]["slices"][case]
    for js, arrays in cells["ranks"]:
        i, j = js["slices"]["coord"]
        want = full[tuple(slice(a, b) for a, b in jslices[f"{i},{j}"])]
        np.testing.assert_array_equal(arrays[f"slices.{case}"], want)
        np.testing.assert_array_equal(arrays[f"slices.{case}.dtensor"], want)


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")
    assert placements((None, ("pod", "data"), "model"), Mesh()) == \
        (Shard(1), Shard(1), Shard(2))
    assert placements((), Mesh()) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh's order"):
        placements((("data", "pod"),), Mesh())
