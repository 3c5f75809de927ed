"""launch/dryrun.py, the port's dry run of every cell on the meta device
(ROADMAP M14b), on the CPU; every run in a subprocess of its own, since
the dry run initialises a fake-backend process group.

- the CLI at --mesh both for granite-3-2b decode_32k (the (16, 16) and
  (2, 16, 16) production meshes in fake worlds of 256 and 512 ranks): a
  record a mesh with JAX's keys, the memory a device shrinking with the
  devices; and the CLI's --all at --mesh both over the cells of
  zamba2-2.7b (cut to 6 of its 54 layers: one application of its shared
  block) and of rwkv6-1.6b (1 of 24), one config a process (_CUT_CLI):
  their 16 cells all costed - train_4k, prefill_32k, decode_32k and
  long_500k, zamba2's K4 / K5 / K3 calls one an application of the
  shared block, the train cells' scans K6 / K7 twice a layer (the
  forward and remat's recompute) and their backward kernels K6_bwd /
  K7_bwd once, rwkv6's serving cells no kernel (the full depth's
  prefill cells trace for minutes on the meta device: the chunked
  scans' Python loop over 1024 or 256 chunks a layer);
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
  GB), and K4 / K5 run 2 x 8 / 8 times on the rank's head shard;
- the vlm and audio families' train, prefill and decode cells (the
  llava-next-34b and whisper-base smoke configs, head dim 64, float32, 4
  x 32): on a (1, 1) mesh their FLOPs beside the JAX hlo_cost.analyze of
  the same cell (test_vlm_audio_flops_sit_beside_the_jax_analysis), and
  their K3 / K4 / K5 calls exactly; on the (2, 2) mesh each kernel's
  calls again, its FLOPs a quarter of the (1, 1) cell's (half the rows,
  half the heads); llava with 14 query / 2 KV heads on (1, 4), where
  rank 0 attends with 4 of each group's 7 heads (kernels/ops.py
  _head_blocks' uneven split), its K4 / K5 FLOPs 4 / 14 of the (1, 1)
  cell's.  And _head_blocks itself: llava's 56 / 8 over 16 and the
  splits that still raise;
- the hybrid and ssm families' prefill and decode cells (the zamba2-2.7b
  smoke config at its published head dim 80, which K4 / K3's meta paths
  take, and rwkv6-1.6b's, float32, 4 x 32): on a (1, 1) mesh their FLOPs
  beside the JAX hlo_cost.analyze of the same cell
  (test_recurrent_flops_sit_beside_the_jax_analysis); zamba2's K4 / K3
  calls exactly on (1, 1) and (2, 2) - one a shared-block application,
  on the rank's head shard - and rwkv6's none.
"""
import json
import os
import subprocess
import sys
import time

import pytest

from repro_torch.kernels import ops

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUB_S = 240
SMOKE = {"train": (32, 8), "prefill": (32, 4), "decode": (32, 8)}
REPLACE = {"head_dim": 64}
# the recurrent families' CLI runs: arch -> the layers each config is cut
# to (zamba2's 6: one application of its shared block)
RECURRENT_LAYERS = {"zamba2-2.7b": 6, "rwkv6-1.6b": 1}
# the CLI's --all over one config's cells, cut in depth: at full depth
# the prefill_32k cells trace for minutes (the chunked scans' Python loop
# over 256 / 1024 chunks a layer)
_CUT_CLI = r"""
import json, sys
from repro_torch.launch import dryrun
spec = json.loads(sys.argv[1])
cells = [c for c in dryrun.all_cells() if c[0] == spec["arch"]]
config = dryrun.get_config
dryrun.all_cells = lambda: iter(cells)
dryrun.get_config = lambda a: config(a).replace(n_layers=spec["layers"])
sys.exit(dryrun.main(["--all", "--mesh", "both", "--out", spec["out"]]))
"""
RECURRENT_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")

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
        **{arch: subprocess.Popen(
            [sys.executable, "-c", _CUT_CLI, json.dumps(
                {"arch": arch, "layers": layers,
                 "out": os.path.join(d, arch)})],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
           for arch, layers in RECURRENT_LAYERS.items()},
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
    for name in ("cli", "port", "jax") + tuple(RECURRENT_LAYERS):
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
    """zamba2-2.7b's train_4k cell, once refused on the meta device (K6
    had no backward, nor K5 its head dim 80), writes a record now and no
    .error.json: its step runs K5 at head dim 80 and the Mamba2 scan's
    backward kernel K6_bwd; its long_500k cell is costed too."""
    d = os.path.join(runs["d"], "zamba2-2.7b")
    for mesh in ("single", "multi"):
        assert not os.path.exists(os.path.join(
            d, f"zamba2-2.7b__train_4k__{mesh}.error.json"))
        with open(os.path.join(
                d, f"zamba2-2.7b__train_4k__{mesh}.json")) as f:
            rec = json.load(f)
        assert rec["kernels"]["K5"]["flops"] > 0
        assert rec["kernels"]["K6_bwd"]["flops"] > 0
        with open(os.path.join(
                d, f"zamba2-2.7b__long_500k__{mesh}.json")) as f:
            rec = json.load(f)
        assert rec["cost"]["flops"] > 0


@pytest.mark.parametrize("arch", sorted(RECURRENT_LAYERS))
def test_the_cli_costs_the_recurrent_serving_cells(runs, arch):
    """Each recurrent config's 8 cells (4 shapes x 2 meshes) are costed,
    none refused: 16 costed in all.  zamba2's shared block runs K4 once a
    prefill (its one application) and K3 once a decode step where the
    strips keep the whole sequence (decode_32k's 128 lanes), none with
    the sequence split (long_500k's one lane: the sequence-parallel
    decode); rwkv6's serving cells run no kernel.  A train_4k cell (remat
    full) runs each scan twice a layer - the forward and the recompute -
    and its backward kernel once (zamba2's 6 layers: K6 12, K6_bwd 6; K4
    2, K5 1 at its one application; rwkv6's 1: K7 2, K7_bwd 1), and its
    record carries the backward kernels' work: launch/cost.py k6_bwd_work
    / k7_bwd_work at the rank's rows."""
    from repro_torch.configs import get_config
    from repro_torch.launch import cost
    d = os.path.join(runs["d"], arch)
    assert "8 costed, 0 refused" in runs["logs"][arch], runs["logs"][arch]
    L = RECURRENT_LAYERS[arch]
    cfg = get_config(arch)
    for mesh, rows in (("single", 256 // 16), ("multi", 256 // 32)):
        assert not os.path.exists(
            os.path.join(d, f"{arch}__train_4k__{mesh}.error.json"))
        for shape in RECURRENT_SHAPES:
            with open(os.path.join(d, f"{arch}__{shape}__{mesh}.json")) \
                    as f:
                rec = json.load(f)
            assert rec["memory"]["argument_size_bytes"] > 0
            assert rec["cost"]["flops"] > 0
            want = {}
            if arch.startswith("zamba2"):
                want = {"train_4k": {"K4": 2, "K5": 1, "K6": 2 * L,
                                     "K6_bwd": L},
                        "prefill_32k": {"K4": 1}, "decode_32k": {"K3": 1},
                        "long_500k": {}}[shape]
            elif shape == "train_4k":
                want = {"K7": 2 * L, "K7_bwd": L}
            assert _calls(rec) == want, (shape, mesh, _calls(rec))
        with open(os.path.join(d, f"{arch}__train_4k__{mesh}.json")) as f:
            kernels = json.load(f)["kernels"]
        H = cfg.n_heads if arch.startswith("rwkv6") else None
        if arch.startswith("zamba2"):
            d_in = cfg.ssm_expand * cfg.d_model
            H = cfg.ssm_heads or d_in // 64
            work = cost.k6_bwd_work((rows, 4096, H, d_in // H),
                                    cfg.ssm_state, 2)
            key = "K6_bwd"
        else:
            K = cfg.d_model // H
            work = cost.k7_bwd_work((rows, 4096, H, K), K, 2)
            key = "K7_bwd"
        assert kernels[key] == {"calls": L, "bytes": L * work[0],
                                "flops": L * work[1]}, (mesh, kernels[key])


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


# ---------------------------------------------------------------------------
# the vlm and audio families' cells
# ---------------------------------------------------------------------------

VA_ARCHS = ("llava-next-34b", "whisper-base")
VA_KINDS = ("train", "prefill", "decode")
VA_REPLACE = {"dtype": "float32", "head_dim": 64}
VA_SHAPE = (4, 32)                           # (B, S)
UNEVEN = {"n_heads": 14, "n_kv_heads": 2}

_VA_PORT = r"""
import json, sys
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_debug_mesh
spec = json.loads(sys.argv[1])
B, S = spec["shape"]
out = {}
for mesh in ((1, 1), (2, 2), (1, 4)):
    dryrun.fake_world(mesh[0] * mesh[1])
    m = make_debug_mesh(*mesh, device_type="cpu")
    for arch in spec["archs"]:
        cfg = get_smoke_config(arch).replace(**spec["replace"])
        kinds = spec["kinds"]
        if mesh == (1, 4):
            if arch != spec["archs"][0]:
                continue
            cfg, kinds = cfg.replace(**spec["uneven"]), ["train"]
        for kind in kinds:
            name = f"{arch}.{kind}.{mesh[0]}x{mesh[1]}"
            out[name] = dryrun.run_cell(arch, kind, False, cfg=cfg,
                                        shape=ShapeSpec(kind, S, B, kind),
                                        mesh=m)
    if mesh == (1, 1):
        cfg = get_smoke_config(spec["archs"][0]).replace(
            **spec["replace"], **spec["uneven"])
        out["uneven.train.1x1"] = dryrun.run_cell(
            "uneven", "train", False, cfg=cfg,
            shape=ShapeSpec("train", S, B, "train"), mesh=m)
json.dump(out, open(spec["out"], "w"))
"""

_VA_JAX = r"""
import json, sys
import jax
from repro.compat import make_mesh, use_mesh
from repro.configs import get_smoke_config
from repro.configs.base import ShapeSpec, TrainConfig
from repro.launch.hlo_cost import analyze
from repro.launch.specs import prefill_cell, serve_cell, train_cell
spec = json.loads(sys.argv[1])
B, S = spec["shape"]
mesh = make_mesh((1, 1), ("data", "model"))
out = {}
with use_mesh(mesh):
    for arch in spec["archs"]:
        cfg = get_smoke_config(arch).replace(**spec["replace"])
        for kind in spec["kinds"]:
            sh = ShapeSpec(kind, S, B, kind)
            if kind == "train":
                cell = train_cell(cfg, sh, mesh, TrainConfig(
                    global_batch=B, seq_len=S, remat="full"))
            elif kind == "prefill":
                cell = prefill_cell(cfg, sh, mesh)
            else:
                cell = serve_cell(cfg, sh, mesh)
            step, args, shardings = cell
            hlo = jax.jit(step, in_shardings=shardings).lower(
                *args).compile().as_text()
            out[f"{arch}.{kind}"] = analyze(hlo)["flops"]
json.dump(out, open(spec["out"], "w"))
"""


@pytest.fixture(scope="module")
def va(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dryrun_va"))
    env = dict(os.environ, PYTHONPATH=f"{ROOT}/src")
    spec = {"archs": list(VA_ARCHS), "kinds": list(VA_KINDS),
            "replace": VA_REPLACE, "shape": list(VA_SHAPE),
            "uneven": UNEVEN}
    procs = {
        "port": subprocess.Popen(
            [sys.executable, "-c", _VA_PORT, json.dumps(
                dict(spec, out=os.path.join(d, "port.json")))],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True),
        "jax": subprocess.Popen(
            [sys.executable, "-c", _VA_JAX, json.dumps(
                dict(spec, out=os.path.join(d, "jax.json")))],
            env=dict(env, JAX_PLATFORMS="cpu"), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)}
    t0 = time.monotonic()
    for name, p in procs.items():
        try:
            log = p.communicate(timeout=max(t0 + SUB_S - time.monotonic(),
                                            1))[0]
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
            pytest.fail(f"{name} did not finish in {SUB_S} s")
        assert p.returncode == 0, f"{name}:\n{log[-4000:]}"
    out = {}
    for side in ("port", "jax"):
        with open(os.path.join(d, f"{side}.json")) as f:
            out[side] = json.load(f)
    return out


def _va_cfg(arch):
    from repro_torch.configs import get_smoke_config
    return get_smoke_config(arch).replace(**VA_REPLACE)


def _va_calls(cfg, kind):
    """Each kernel's calls in one step of a cell: a layer's attention K4
    forward (twice under remat full) and K5 backward, whisper's encoder
    once (not remat, as in the JAX package) and its decoder's self and
    cross attention; the prefill's K4 a layer's attention; the decode's
    K3 a decoder attention (self and cross)."""
    E = cfg.encoder_layers
    dec = 2 * cfg.n_layers if cfg.family == "audio" else cfg.n_layers
    return {"train": {"K4": E + 2 * dec, "K5": E + dec},
            "prefill": {"K4": E + dec}, "decode": {"K3": dec}}[kind]


def _jax_attention_dots(cfg, kind):
    """The FLOPs of the JAX reference attention's dots on the CPU
    (repro/kernels/ops.py and ref.py: keys in blocks of 512, a decode's
    cache in blocks of 1024, S = 32 padded to a whole block), from the
    compiled HLO: a prefill's 2 a layer's attention (the scores and the
    weighted values), a decode's 2 over its padded cache, a train step's
    8 a remat layer's attention (as the dense cells: the forward's two,
    again in the recompute, the backward's dp, dq, dk and dv) and 7 an
    attention outside remat (whisper's encoder: the backward's
    recomputed scores stay, where the remat layer's share the
    recompute's), each dot 2 B Hq Sq Skv_padded D."""
    B, S = VA_SHAPE
    E = cfg.encoder_layers
    dec = 2 * cfg.n_layers if cfg.family == "audio" else cfg.n_layers
    if kind == "decode":
        return dec * 2 * 2 * B * cfg.n_heads * 1024 * cfg.head_dim
    dots = {"train": 7 * E + 8 * dec, "prefill": 2 * (E + dec)}[kind]
    return dots * 2 * B * cfg.n_heads * S * 512 * cfg.head_dim


def _calls(rec):
    return {k: v["calls"] for k, v in rec["kernels"].items()}


@pytest.mark.parametrize("arch", VA_ARCHS)
@pytest.mark.parametrize("kind", VA_KINDS)
def test_vlm_audio_flops_sit_beside_the_jax_analysis(va, arch, kind):
    """As the dense and MoE train cells (tests/test_torch_cost.py): the
    JAX count is the port's dots outside its kernels plus the JAX
    reference attention's (_jax_attention_dots), exactly; the port
    counts its kernels by their formulas over the pairs and positions
    attended, less than the reference's padded blocks."""
    cfg = _va_cfg(arch)
    rec = va["port"][f"{arch}.{kind}.1x1"]
    kernels = sum(k["flops"] for k in rec["kernels"].values())
    outside = rec["cost"]["flops"] - kernels
    attention = _jax_attention_dots(cfg, kind)
    assert va["jax"][f"{arch}.{kind}"] == outside + attention, \
        (va["jax"][f"{arch}.{kind}"], outside, attention)
    assert 0 < kernels < attention


@pytest.mark.parametrize("arch", VA_ARCHS)
@pytest.mark.parametrize("kind", VA_KINDS)
def test_vlm_audio_kernels_run_on_the_head_shard(va, arch, kind):
    """Each kernel's calls, exactly, on (1, 1) and on the (2, 2) mesh;
    on (2, 2) a rank's share of each kernel's FLOPs is a quarter of the
    whole cell's: half the rows (data) and half the heads (model)."""
    want = _va_calls(_va_cfg(arch), kind)
    one = va["port"][f"{arch}.{kind}.1x1"]
    four = va["port"][f"{arch}.{kind}.2x2"]
    assert _calls(one) == _calls(four) == want
    for k in want:
        assert 4 * four["kernels"][k]["flops"] == one["kernels"][k]["flops"]


def test_the_uneven_split_costs_rank_0s_heads(va):
    """llava with 14 query / 2 KV heads on (1, 4): rank 0 attends with 4
    of each group's 7 query heads (the larger block), so its K4 / K5
    FLOPs are 4 / 14 of the (1, 1) cell's, with as many calls."""
    one, four = va["port"]["uneven.train.1x1"], \
        va["port"]["llava-next-34b.train.1x4"]
    assert _calls(one) == _calls(four) == {"K4": 4, "K5": 2}
    for k in ("K4", "K5"):
        assert 14 * four["kernels"][k]["flops"] == \
            4 * one["kernels"][k]["flops"]


@pytest.mark.parametrize("hq,hkv,n,sizes", [(56, 8, 16, [4, 3]),
                                             (14, 2, 4, [4, 3]),
                                             (56, 8, 32, [2, 2, 2, 1])])
def test_head_blocks_split_each_group_unevenly(hq, hkv, n, sizes):
    """Query heads the ranks do not divide, over a multiple of the KV
    heads (llava-next-34b's 56 / 8 over a model axis of 16): each KV
    head's G query heads go to its n / Hkv ranks as evenly as they go,
    the larger blocks first, contiguous, so every rank keeps one KV head
    and every query head has one rank."""
    blocks = ops._head_blocks(hq, hkv, n)
    per = n // hkv
    assert [hi - lo for (lo, hi), _ in blocks] == sizes * hkv
    assert [kv for _, kv in blocks] == [(r // per, r // per + 1)
                                        for r in range(n)]
    assert [h for (lo, hi), _ in blocks for h in range(lo, hi)] == \
        list(range(hq))


@pytest.mark.parametrize("hq,hkv,n", [(12, 4, 16), (6, 4, 8), (56, 8, 6),
                                      (14, 4, 8)])
def test_head_blocks_refuse_what_does_not_split(hq, hkv, n):
    """Splits that still raise: more ranks a group than its query heads
    ((12, 4) over 16: 4 ranks for 3 heads), KV heads that neither divide
    nor are divided by the ranks, query heads not a multiple of the KV
    heads."""
    with pytest.raises(ValueError, match="do not split"):
        ops._head_blocks(hq, hkv, n)


# ---------------------------------------------------------------------------
# the hybrid and ssm families' serving cells
# ---------------------------------------------------------------------------

REC_ARCHS = {"zamba2-2.7b": {"dtype": "float32", "head_dim": 80},
             "rwkv6-1.6b": {"dtype": "float32"}}
REC_KINDS = ("prefill", "decode")
REC_SHAPE = (4, 32)                          # (B, S)

_REC_PORT = r"""
import json, sys
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_debug_mesh
spec = json.loads(sys.argv[1])
B, S = spec["shape"]
out = {}
for mesh in ((1, 1), (2, 2)):
    dryrun.fake_world(mesh[0] * mesh[1])
    m = make_debug_mesh(*mesh, device_type="cpu")
    for arch, rep in spec["archs"].items():
        cfg = get_smoke_config(arch).replace(**rep)
        for kind in spec["kinds"]:
            out[f"{arch}.{kind}.{mesh[0]}x{mesh[1]}"] = dryrun.run_cell(
                arch, kind, False, cfg=cfg,
                shape=ShapeSpec(kind, S, B, kind), mesh=m)
json.dump(out, open(spec["out"], "w"))
"""

_REC_JAX = r"""
import json, sys
import jax
from repro.compat import make_mesh, use_mesh
from repro.configs import get_smoke_config
from repro.configs.base import ShapeSpec
from repro.launch.hlo_cost import analyze
from repro.launch.specs import prefill_cell, serve_cell
spec = json.loads(sys.argv[1])
B, S = spec["shape"]
mesh = make_mesh((1, 1), ("data", "model"))
out = {}
with use_mesh(mesh):
    for arch, rep in spec["archs"].items():
        cfg = get_smoke_config(arch).replace(**rep)
        for kind in spec["kinds"]:
            sh = ShapeSpec(kind, S, B, kind)
            cell = prefill_cell(cfg, sh, mesh) if kind == "prefill" \
                else serve_cell(cfg, sh, mesh)
            step, args, shardings = cell
            hlo = jax.jit(step, in_shardings=shardings).lower(
                *args).compile().as_text()
            out[f"{arch}.{kind}"] = analyze(hlo)["flops"]
json.dump(out, open(spec["out"], "w"))
"""


@pytest.fixture(scope="module")
def rec(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dryrun_rec"))
    env = dict(os.environ, PYTHONPATH=f"{ROOT}/src")
    spec = {"archs": REC_ARCHS, "kinds": list(REC_KINDS),
            "shape": list(REC_SHAPE)}
    procs = {side: subprocess.Popen(
        [sys.executable, "-c", script, json.dumps(
            dict(spec, out=os.path.join(d, f"{side}.json")))],
        env=dict(env, JAX_PLATFORMS="cpu") if side == "jax" else env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for side, script in (("port", _REC_PORT), ("jax", _REC_JAX))}
    t0 = time.monotonic()
    for name, p in procs.items():
        try:
            log = p.communicate(timeout=max(t0 + SUB_S - time.monotonic(),
                                            1))[0]
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
            pytest.fail(f"{name} did not finish in {SUB_S} s")
        assert p.returncode == 0, f"{name}:\n{log[-4000:]}"
    out = {}
    for side in procs:
        with open(os.path.join(d, f"{side}.json")) as f:
            out[side] = json.load(f)
    return out


def _rec_cfg(arch):
    from repro_torch.configs import get_smoke_config
    return get_smoke_config(arch).replace(**REC_ARCHS[arch])


def _shared_block_dots(cfg, kind):
    """zamba2's shared block in one application, as the JAX reference
    counts it on the CPU: (its dots outside the attention - the q, k, v
    and o projections and the MLP's matrices, over the cell's rows -,
    the reference attention's two dots, the scores and the weighted
    values, each 2 B Hq Sq Skv_padded D: keys in blocks of 512, a
    decode's strips in blocks of 1024)."""
    B, S = REC_SHAPE
    rows = B * S if kind == "prefill" else B
    d, D = cfg.d_model, cfg.head_dim
    mats = 3 if cfg.act == "silu" else 2
    rest = rows * (2 * d * D * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
                   + mats * 2 * d * cfg.d_ff)
    sq, skv = (S, 512) if kind == "prefill" else (1, 1024)
    return rest, 2 * 2 * B * cfg.n_heads * sq * skv * D


@pytest.mark.parametrize("arch", sorted(REC_ARCHS))
@pytest.mark.parametrize("kind", REC_KINDS)
def test_recurrent_flops_sit_beside_the_jax_analysis(rec, arch, kind):
    """rwkv6: the port's FLOPs equal the JAX count exactly (the same
    chunked WKV scan's einsums, no kernel).  zamba2: the JAX count is the
    port's dots outside its kernels with its shared block's dots moved -
    the JAX stack applies the block under lax.cond in each of its
    n_layers scanned layers, and hlo_cost.analyze charges a conditional
    the mean of its two branches, so it counts n_layers / 2 applications
    (3 at the smoke config) where the port runs n_layers /
    shared_attn_every (2) - plus the JAX reference attention's dots in
    those n_layers / 2 applications (_shared_block_dots); the port's K4 /
    K3 count the pairs and positions attended, less than the
    reference's padded blocks."""
    cfg = _rec_cfg(arch)
    r = rec["port"][f"{arch}.{kind}.1x1"]
    kernels = sum(k["flops"] for k in r["kernels"].values())
    outside = r["cost"]["flops"] - kernels
    want = rec["jax"][f"{arch}.{kind}"]
    if cfg.family == "ssm":
        assert kernels == 0 and r["cost"]["flops"] == want, \
            (r["cost"]["flops"], want)
        return
    rest, attention = _shared_block_dots(cfg, kind)
    counted = cfg.n_layers / 2
    apps = cfg.n_layers // cfg.shared_attn_every
    assert want == outside + (counted - apps) * rest + counted * attention, \
        (want, outside, rest, attention)
    assert 0 < kernels < apps * attention


@pytest.mark.parametrize("arch", sorted(REC_ARCHS))
@pytest.mark.parametrize("kind", REC_KINDS)
def test_recurrent_kernels_run_on_the_head_shard(rec, arch, kind):
    """zamba2: K4 once a shared-block application in a prefill, K3 once a
    decode step, exactly, on (1, 1) and on (2, 2), where a rank's share
    of each call's FLOPs is a quarter of the whole cell's (half the rows
    over data, half the heads over model); rwkv6: no kernel."""
    cfg = _rec_cfg(arch)
    one = rec["port"][f"{arch}.{kind}.1x1"]
    four = rec["port"][f"{arch}.{kind}.2x2"]
    want = {}
    if cfg.family == "hybrid":
        want = {"K4" if kind == "prefill" else "K3":
                cfg.n_layers // cfg.shared_attn_every}
    assert _calls(one) == _calls(four) == want
    for k in want:
        assert 4 * four["kernels"][k]["flops"] == one["kernels"][k]["flops"]
