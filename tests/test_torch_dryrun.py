"""launch/dryrun.py, the port's dry run of every cell on the meta device
(ROADMAP M14b), on the CPU; every run in a subprocess of its own, since
the dry run initialises a fake-backend process group.

- the CLI at --mesh both for granite-3-2b decode_32k (the (16, 16) and
  (2, 16, 16) production meshes in fake worlds of 256 and 512 ranks): a
  record a mesh with JAX's keys, the memory a device shrinking with the
  devices; and a cell of another family (zamba2-2.7b long_500k) written
  to its .error.json with the NotImplementedError naming ROADMAP §1
  item 3;
- memory.argument_size_bytes a device equals the JAX package's
  compiled.memory_analysis().argument_size_in_bytes for the train,
  prefill and decode cells of the granite-3-2b smoke config (head dim
  raised to 64, which the kernels' meta paths take) on a (2, 2) mesh of
  8 forced host devices, exactly: both count each argument's shard
  shape, and XLA pads none of these buffers;
- the M14 cell (granite-3-2b at full width, 8 of its 40 layers, 2x2, 4 x
  2048 tokens, remat full): a step's state collectives are all_gather 15
  calls 1660956672 bytes and all_reduce 14 calls 1174487052 bytes, the
  counts of chip_smoke.py phase_m14 on the card (PERF.md: 1.661 GB, 1.174
  GB), and K4 / K5 run 2 x 8 / 8 times on the rank's head shard.
"""
import json
import os
import subprocess
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUB_S = 240
SMOKE = {"train": (32, 8), "prefill": (32, 4), "decode": (32, 8)}
REPLACE = {"head_dim": 64}

_PORT = r"""
import json, sys
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_debug_mesh
spec = json.loads(sys.argv[1])
dryrun.fake_world(4)
mesh = make_debug_mesh(2, 2, device_type="cpu")
out = {}
cfg = get_smoke_config("granite-3-2b").replace(**spec["replace"])
for kind, (S, B) in spec["smoke"].items():
    out[kind] = dryrun.run_cell("granite-3-2b", kind, False, cfg=cfg,
                                shape=ShapeSpec(kind, S, B, kind), mesh=mesh)
cfg = get_config("granite-3-2b").replace(n_layers=8)
out["m14"] = dryrun.run_cell("granite-3-2b", "m14", False, cfg=cfg,
                             shape=ShapeSpec("m14", 2048, 4, "train"),
                             mesh=mesh)
json.dump(out, open(spec["out"], "w"))
"""

_JAX = r"""
import json, sys
import jax
from repro.compat import make_mesh, use_mesh
from repro.configs import get_smoke_config
from repro.configs.base import ShapeSpec, TrainConfig
from repro.launch.specs import prefill_cell, serve_cell, train_cell
spec = json.loads(sys.argv[1])
cfg = get_smoke_config("granite-3-2b").replace(**spec["replace"])
mesh = make_mesh((2, 2), ("data", "model"))
out = {}
with use_mesh(mesh):
    for kind, (S, B) in spec["smoke"].items():
        sh = ShapeSpec(kind, S, B, kind)
        if kind == "train":
            cell = train_cell(cfg, sh, mesh, TrainConfig(
                global_batch=B, seq_len=S, remat="full"))
        elif kind == "prefill":
            cell = prefill_cell(cfg, sh, mesh)
        else:
            cell = serve_cell(cfg, sh, mesh)
        step, args, shardings = cell
        mem = jax.jit(step, in_shardings=shardings).lower(
            *args).compile().memory_analysis()
        out[kind] = int(mem.argument_size_in_bytes)
json.dump(out, open(spec["out"], "w"))
"""


def _cli(d, *args):
    return [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
            "--out", d]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dryrun"))
    env = dict(os.environ, PYTHONPATH=f"{ROOT}/src")
    spec = {"smoke": SMOKE, "replace": REPLACE}
    procs = {
        "cli": subprocess.Popen(
            _cli(os.path.join(d, "cli"), "--arch", "granite-3-2b",
                 "--shape", "decode_32k", "--mesh", "both"),
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True),
        "refused": subprocess.Popen(
            _cli(os.path.join(d, "refused"), "--arch", "zamba2-2.7b",
                 "--shape", "long_500k", "--mesh", "single"),
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True),
        "port": subprocess.Popen(
            [sys.executable, "-c", _PORT, json.dumps(
                dict(spec, out=os.path.join(d, "port.json")))],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True),
        "jax": subprocess.Popen(
            [sys.executable, "-c", _JAX, json.dumps(
                dict(spec, out=os.path.join(d, "jax.json")))],
            env=dict(env, JAX_PLATFORMS="cpu",
                     XLA_FLAGS="--xla_force_host_platform_device_count=8"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)}
    t0 = time.monotonic()
    logs = {}
    for name, p in procs.items():
        try:
            logs[name] = p.communicate(
                timeout=max(t0 + SUB_S - time.monotonic(), 1))[0]
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
            pytest.fail(f"{name} did not finish in {SUB_S} s")
    for name in ("cli", "port", "jax"):
        assert procs[name].returncode == 0, f"{name}:\n{logs[name][-4000:]}"
    out = {"d": d, "logs": logs, "rc": {k: p.returncode
                                        for k, p in procs.items()}}
    for side in ("port", "jax"):
        with open(os.path.join(d, f"{side}.json")) as f:
            out[side] = json.load(f)
    return out


def test_the_cli_costs_a_dense_cell_at_both_meshes(runs):
    d = os.path.join(runs["d"], "cli")
    recs = {}
    for mesh, n, shape in (("single", 256, [16, 16]),
                           ("multi", 512, [2, 16, 16])):
        with open(os.path.join(
                d, f"granite-3-2b__decode_32k__{mesh}.json")) as f:
            rec = json.load(f)
        recs[mesh] = rec
        assert rec["mesh_shape"] == shape and rec["n_devices"] == n
        for key in ("argument_size_bytes", "output_size_bytes",
                    "temp_size_bytes", "total_per_device_bytes"):
            assert rec["memory"][key] > 0, key
        assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes_accessed"] > 0
        # 8 KV heads do not divide the model axis of 16: the sequence is
        # sharded over it, and the decode gathers its partials there
        assert rec["collectives"]["all_gather"]["calls"] > \
            rec["collectives_state"]["all_gather"]["calls"] > 0
    assert recs["multi"]["memory"]["argument_size_bytes"] < \
        recs["single"]["memory"]["argument_size_bytes"]
    assert "2 costed, 0 refused" in runs["logs"]["cli"]


def test_another_familys_cell_writes_its_error(runs):
    assert runs["rc"]["refused"] == 0, runs["logs"]["refused"]
    path = os.path.join(runs["d"], "refused",
                        "zamba2-2.7b__long_500k__single.error.json")
    with open(path) as f:
        err = json.load(f)
    assert err["error"].startswith("NotImplementedError")
    assert "ROADMAP §1 item 3" in err["error"]
    assert "0 costed, 1 refused" in runs["logs"]["refused"]


@pytest.mark.parametrize("kind", sorted(SMOKE))
def test_argument_bytes_equal_the_jax_compiled_arguments(runs, kind):
    got = runs["port"][kind]["memory"]["argument_size_bytes"]
    assert got == runs["jax"][kind], (got, runs["jax"][kind])


def test_the_m14_cell_counts_the_cards_collectives(runs):
    rec = runs["port"]["m14"]
    assert rec["collectives_state"] == {
        "all_gather": {"calls": 15, "bytes": 1660956672},
        "all_reduce": {"calls": 14, "bytes": 1174487052}}
    assert round(1660956672 / 1e9, 3) == 1.661
    assert round(1174487052 / 1e9, 3) == 1.174
    assert {k: v["calls"] for k, v in rec["kernels"].items()} == \
        {"K4": 16, "K5": 8}
    # the head-sharded attention's gathers come on top of the state's
    assert rec["collectives"]["all_gather"]["calls"] > 15
    assert rec["collectives"]["all_reduce"] == \
        {"calls": 14, "bytes": 1174487052}
