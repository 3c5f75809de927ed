"""Dry run: every (arch x input shape x mesh) cell's step traced once over
meta tensors, compiled nowhere and allocating nothing - the JAX package's
launch/dryrun.py, which lowers and compiles each cell for the production
meshes.

One process stands for rank 0 of the production mesh, (16, 16) ("data",
"model") or (2, 16, 16) ("pod", "data", "model"), in a world of 256 or
512 ranks on torch's "fake" process-group backend (a test utility of
torch: its collectives move nothing; it is imported inside main and
run_cell only).  A cell (launch/specs.py train_cell, prefill_cell,
serve_cell) gives its step, its arguments' global shapes and their
shardings; the rank's arguments are meta tensors of its local shard
shapes (the parameters and the train state as DTensors over them, as the
mesh steps take them), and the step runs once under launch/cost.py's
StepCost.  The kernels' wrappers take the meta path (launch/cost.py).

One JSON record per cell, with the JAX record's keys where they mean the
same thing:
  mesh_shape, n_devices;
  memory.argument_size_bytes: the rank's argument shards, exact;
  memory.output_size_bytes: the step's results that are not its
    arguments (a train step's state is its arguments, updated in place);
  memory.temp_size_bytes: the peak of live op results StepCost tracked
    (a lower bound: launch/cost.py); memory.total_per_device_bytes their
    sum;
  cost.flops (dot FLOPs and the kernels' formulas), cost.bytes_accessed
    (the materialised-result proxy and the kernels' bytes),
    cost.transcendentals;
  collectives: every collective of the step by kind, {"calls", "bytes"},
    and total_bytes; collectives_state: those of the gathered parameters
    and the reduced gradients (sharding/shards.py COMM, which
    chip_smoke.py reads on the card; an MoE layer's aux share's
    all_reduce over the data axes, and with REPRO_MOE_A2A its exchange's
    all_to_all, gathers and all_reduce, are counted there too), the rest
    being the head-sharded attention's and the sequence-parallel
    decode's gathers;
  kernels: K1-K7, and K6_bwd / K7_bwd (the scans' backward kernels), by
    name, {"calls", "flops", "bytes"};
  trace_s: the wall time of the traced call.
The mesh steps take every family.  A cell whose step raises is written
to <tag>.error.json, as the JAX dry run writes its failures.  The hybrid
and ssm families' cells are costed like the rest: the Mamba2 / RWKV6
layers on every head of the rank's rows (a train cell's scans K6 / K7
and their backward kernels K6_bwd / K7_bwd), zamba2's shared block's K4
/ K5 / K3 on the head shard.  The MoE cells run the per-row dispatch, as the JAX dry run runs
without REPRO_MOE_A2A; with it set, their steps take the exchange and
count its all_to_all.

Usage:
  python -m repro_torch.launch.dryrun --arch granite-3-2b --shape decode_32k \
      --mesh both
  python -m repro_torch.launch.dryrun --all --mesh both --out build/dryrun
(--all takes ~10 minutes on the CPU: zamba2's and rwkv6's prefill_32k
cells trace their chunked scans' loop over 256 / 1024 chunks a layer.)
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

import torch

from ..configs import ASSIGNED_ARCHS, get_config
from ..configs.base import SHAPES, ModelConfig, ShapeSpec, TrainConfig
from ..tree import _is_namedtuple, leaves, map_tree
from . import cost


def subquadratic(cfg: ModelConfig) -> bool:
    """Decode state that does not grow with the sequence (the ssm and
    hybrid families): the long_500k shape applies (the JAX
    ModelConfig.subquadratic)."""
    return cfg.family in ("ssm", "hybrid")


def all_cells():
    """Applicable (arch, shape) cells, the JAX dry run's: ASSIGNED_ARCHS x
    SHAPES, long_500k only for the subquadratic archs."""
    for arch in ASSIGNED_ARCHS:
        cfg = get_config(arch)
        for shape_name in SHAPES:
            if shape_name == "long_500k" and not subquadratic(cfg):
                continue
            yield arch, shape_name


def fake_world(n: int) -> None:
    """This process as rank 0 of a world of n on the fake backend."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def local_args(args, shardings, mesh):
    """The rank's arguments: for each leaf a meta tensor of its local shard
    shape; the first argument (the parameters, or the train state) as
    DTensors over them.  Returns (args, their bytes)."""
    from ..sharding.shards import as_dtensor, local_shape
    total = [0]

    def local(t, sh):
        out = torch.empty(local_shape(t.shape, sh.placements, sh.mesh),
                          dtype=t.dtype, device="meta")
        total[0] += out.numel() * out.element_size()
        return out

    def walk(a, s, as_d):
        if isinstance(a, tuple) and not _is_namedtuple(a):
            return tuple(walk(x, y, as_d) for x, y in zip(a, s))
        return map_tree(lambda t, sh: as_dtensor(local(t, sh), sh) if as_d
                        else local(t, sh), a, s)
    out = (walk(args[0], shardings[0], True),) + tuple(
        walk(a, s, False) for a, s in zip(args[1:], shardings[1:]))
    return out, total[0]


def _cell(cfg, shape, mesh):
    from .specs import prefill_cell, serve_cell, train_cell
    if shape.kind == "train":
        tcfg = TrainConfig(global_batch=shape.global_batch,
                           seq_len=shape.seq_len, remat="full")
        return train_cell(cfg, shape, mesh, tcfg)
    if shape.kind == "prefill":
        return prefill_cell(cfg, shape, mesh)
    return serve_cell(cfg, shape, mesh)


def _plain(t):
    return t.to_local() if hasattr(t, "to_local") else t


def run_cell(arch: str, shape_name: str, multi_pod: bool, *,
             cfg: ModelConfig = None, shape: ShapeSpec = None,
             mesh=None) -> dict:
    """One cell's record (the module docstring).  cfg, shape and mesh
    override the registry's config, the named shape and the production
    mesh (a cut model, a debug mesh over a fake world of its size)."""
    from ..sharding import shards
    from .mesh import make_production_mesh
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    if mesh is None:
        fake_world(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "multi" if multi_pod else "single",
           "mesh_shape": list(mesh.shape), "n_devices": mesh.size(),
           "rank": 0}
    step, args, shardings = _cell(cfg, shape, mesh)
    largs, arg_bytes = local_args(args, shardings, mesh)
    shards.reset_comm()
    t0 = time.perf_counter()
    with cost.StepCost() as sc:
        out = step(*largs)
    rec["trace_s"] = round(time.perf_counter() - t0, 3)
    arg_ids = {id(t) for t in _result_leaves(largs)}
    out_bytes = sum(_plain(t).numel() * _plain(t).element_size()
                    for t in _result_leaves(out) if id(t) not in arg_ids)
    s = sc.summary()
    rec["memory"] = {"argument_size_bytes": arg_bytes,
                     "output_size_bytes": out_bytes,
                     "temp_size_bytes": s["peak_live_bytes"]}
    rec["memory"]["total_per_device_bytes"] = sum(rec["memory"].values())
    rec["cost"] = {k: s[k] for k in ("flops", "bytes_accessed",
                                     "transcendentals")}
    rec["collectives"] = dict(s["collectives"], total_bytes=sum(
        v["bytes"] for v in s["collectives"].values()))
    rec["collectives_state"] = {k: dict(v) for k, v in
                                sorted(shards.COMM.items())}
    rec["kernels"] = s["kernels"]
    return rec


def _result_leaves(out):
    if torch.is_tensor(out):
        return [out]
    if isinstance(out, dict) or _is_namedtuple(out):
        return leaves(out)
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _result_leaves(o)]
    return []


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    cells = list(all_cells()) if args.all else [(args.arch, args.shape)]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    ran, refused, failures = 0, 0, 0
    for arch, shape_name in cells:
        for mp in meshes:
            tag = f"{arch}__{shape_name}__{'multi' if mp else 'single'}"
            out_path = outdir / f"{tag}.json"
            if out_path.exists():
                print(f"[skip] {tag} (exists)", flush=True)
                continue
            print(f"[run ] {tag}", flush=True)
            try:
                rec = run_cell(arch, shape_name, mp)
                out_path.write_text(json.dumps(rec, indent=1))
                ran += 1
                m = rec["memory"]
                print(f"[ ok ] {tag}: traced {rec['trace_s']}s, args/dev "
                      f"{m['argument_size_bytes'] / 2**30:.2f} GiB, temp "
                      f"{m['temp_size_bytes'] / 2**30:.2f} GiB, flops "
                      f"{rec['cost']['flops']:.3e}, coll "
                      f"{rec['collectives']['total_bytes'] / 2**20:.1f} MiB",
                      flush=True)
            except Exception as e:
                no = isinstance(e, NotImplementedError)
                refused += no
                failures += not no
                err = {"arch": arch, "shape": shape_name,
                       "mesh": "multi" if mp else "single",
                       "error": repr(e),
                       "traceback": traceback.format_exc()}
                (outdir / f"{tag}.error.json").write_text(
                    json.dumps(err, indent=1))
                print(f"[{'refused' if no else 'FAIL'}] {tag}: {e!r}",
                      flush=True)
    print(f"done; {ran} costed, {refused} refused (NotImplementedError), "
          f"{failures} failures", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
