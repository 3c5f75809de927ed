"""One rank of a gloo world for tests/test_torch_mesh_train.py,
tests/test_torch_sharding.py, tests/test_torch_serve_cells.py,
tests/test_torch_moe_mesh.py, tests/test_torch_vlm_audio_mesh.py and
tests/test_torch_recurrent_mesh.py: the port's sharded training and
serving cells (ROADMAP M14) and the MoE, vlm, audio, hybrid and ssm
families on the mesh, one process per rank.

    python tests/torch_mesh_worker.py RANK WORLD STORE JOBS OUT_DIR

The rank joins the world through a FileStore, runs the jobs the test
wrote to the JSON file JOBS, and writes what each gave to
OUT_DIR/rank<r>.json (arrays to rank<r>.npz).  The tests start each rank
as a process of its own (subprocess, so that every rank can have its own
PYTHONHASHSEED), with torch and the port only: no jax.  A job's "env"
holds environment variables set while it runs (REPRO_MOE_A2A), and a
train job's "replace" config fields beside its dtype.

Jobs:
  slices   each case's local shard of arange(numel).reshape(shape) on the
           mesh, by sharding/shards.py local_slice and by DTensor's own
           distribute_tensor
  batch    DataPipeline(mesh=).device_batch(step) on the mesh, with this
           rank's hash of ("batch", step)
  train    Trainer(mesh=, state_shardings=train_cell(...)[2][0]) from the
           checkpoint the test put in its directory, on the test's saved
           batches ("<step>" the tokens, "<step>.<key>" the frontend's
           embeddings, with "float32_embeds" given to the step in float32
           where the pipeline casts them to bfloat16; each rank's
           host_batch reads them; rank 0's reach
           the others by broadcast): the whole gradient of the first step (the
           mesh step's (a)-(c), before the clip), then the Trainer's
           steps; the Trainer's last checkpoint holds the parameters.
           With "partials", the MoE leaves' gradients are also kept
           before train_step.model_partials sums them over the model axis
  restore  a Trainer on this job's mesh restores the checkpoint of
           another directory and saves it again in its own
  refuse   what the mesh path refuses: the Trainer of each "other" [arch,
           device] on the job's (CPU) mesh - the hybrid and ssm families
           on "cuda" or "meta", past check_backward now, stopped before
           anything is built by the mesh's device (or K5's head dims), the
           error by type - and a mesh whose size is not the world's
  heads    ops.head_sharded_attention on the rank's head shard of the
           saved q, k and v, K4 forward and K5 backward on the card (or
           their plain versions with "device": "cpu"): o and the whole
           gradients of q, k, v
  cell     the step of launch/specs.py prefill_cell or serve_cell on the
           job's mesh (tests/test_torch_serve_cells.py): the parameters
           saved by the test as this rank's DTensor shards, the batch /
           cache / tokens / lens as this rank's slices; prefill once, or
           decode the saved steps one after another; the logits and the
           cache's local shard of each call (of the leaves "after" names,
           after every decode step), and the slice bounds (with "count",
           the first call's collectives by launch/cost.py); the batch
           takes every key of the cell's batch specs (whisper's frames,
           llava's image) and the cache every "cache.<leaf>" saved
  family_cells  each "archs" cell on the job's mesh at a 4 x 32 shape,
           seeded weights: the train cell's step called without a state
           or a batch (its model lies on the meta device, where nothing
           refuses the hybrid and ssm families' training any more: the
           error of the missing arguments, by type), the prefill cell's step
           on a prompt into Model.init_cache(shardings=), the decode
           cell's on a cache of its own, lanes at 5: each one's logits'
           shape and whether they are finite
  cell (the recurrent families, tests/test_torch_recurrent_mesh.py)
           takes their state leaves as any "cache.<leaf>", each in its
           own sanitized spec
  a2a      models/moe_a2a.py make_sharded_moe on the job's mesh over the
           rank's rows and sequence block of the saved x, with the router
           and its E / tp experts: at each capacity factor, y, aux and the
           gradients of sum(y w) + AUX_C aux / (data ranks) - the rank's
           share of sum(Y W) + AUX_C aux - with respect to x, the router
           and the rank's expert slices
"""
import datetime
import json
import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist


def _mesh(job, device_type="cpu"):
    from repro_torch.launch.mesh import make_debug_mesh
    d, m = job["mesh"]
    return make_debug_mesh(d, m, device_type=device_type)


def _slices_job(job, arrays):
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.sharding.rules import NamedSharding
    from repro_torch.sharding.shards import local_slice
    from repro_torch.launch.mesh import _mesh as build_mesh
    mesh = build_mesh(tuple(job["mesh"]), tuple(job["names"]), "cpu")
    for i, (shape, spec) in enumerate(job["cases"]):
        spec = tuple(tuple(e) if isinstance(e, list) else e for e in spec)
        full = torch.arange(int(np.prod(shape))).reshape(shape)
        sh = NamedSharding(mesh, spec)
        arrays[f"{job['name']}.{i}"] = local_slice(
            full, sh.placements, mesh).numpy()
        arrays[f"{job['name']}.{i}.dtensor"] = distribute_tensor(
            full, mesh, sh.placements).to_local().numpy()
    return {"coord": mesh.get_coordinate()}


AUX_C = 3.0


def _cfgs(job):
    from repro_torch.configs import TrainConfig, get_smoke_config
    cfg = get_smoke_config(job["arch"]).replace(dtype=job["dtype"],
                                                **job.get("replace", {}))
    return cfg, TrainConfig(**job["tcfg"])


def _batch_job(job, arrays):
    from repro_torch.data import DataPipeline
    cfg, tcfg = _cfgs(job)
    pipe = DataPipeline(cfg, tcfg, device="cpu", mesh=_mesh(job))
    got = pipe.device_batch(job["step"])
    arrays[f"{job['name']}.tokens"] = got["tokens"].numpy()
    if dist.get_rank() == 0:
        arrays[f"{job['name']}.host"] = pipe.host_batch(job["step"])["tokens"]
    return {"hash": hash(("batch", job["step"]))}


def _trainer(job, mesh, device="cpu"):
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.specs import train_cell
    from repro_torch.train.trainer import Trainer
    cfg, tcfg = _cfgs(job)
    shape = ShapeSpec("train", tcfg.seq_len, tcfg.global_batch, "train")
    shardings = train_cell(cfg, shape, mesh, tcfg)[2][0]
    return Trainer(cfg, tcfg, device=device, mesh=mesh,
                   state_shardings=shardings)


def _train_job(job, arrays):
    from repro_torch.train.train_step import make_mesh_grads, model_partials
    from repro_torch.tree import leaves_with_paths
    mesh = _mesh(job)
    tr = _trainer(job, mesh)
    saved = {}
    with np.load(job["batches"]) as z:
        for k in z.files:               # "<step>" tokens, "<step>.<key>"
            step, _, key = k.partition(".")
            saved.setdefault(int(step), {})[key or "tokens"] = z[k]
    tr.pipeline.host_batch = lambda step: dict(saved[step])
    if job.get("float32_embeds"):       # the rank's rows, kept in float32
        from repro_torch.launch.specs import batch_shardings
        from repro_torch.sharding.shards import local_slice
        bsh, inner = batch_shardings(tr.cfg, mesh), tr.pipeline.device_batch

        def device_batch(step):
            b = inner(step)
            for k in b:
                if k != "tokens":
                    b[k] = local_slice(torch.from_numpy(saved[step][k]),
                                       bsh[k].placements, mesh).contiguous()
            return b
        tr.pipeline.device_batch = device_batch
    partials = bool(job.get("partials"))
    full, m = make_mesh_grads(tr.model, tr.tcfg, mesh)(
        tr.state, tr.pipeline.device_batch(tr.start_step),
        model_sum=not partials)
    if partials:
        for path, p in leaves_with_paths(full):
            if "/moe/" in f"/{path}/":
                arrays[f"{job['name']}.partial.{path}"] = \
                    p.grad.float().numpy().copy()
        model_partials(full, mesh)
    if dist.get_rank() == 0 or job.get("all_grads"):
        for path, p in leaves_with_paths(full):
            arrays[f"{job['name']}.grad.{path}"] = p.grad.float().numpy()
    out = tr.run(job["steps"])
    return {"start_step": tr.start_step, "first_loss": float(m["loss"]),
            "metrics": out["metrics"], "final_step": out["final_step"]}


def _restore_job(job, arrays):
    mesh = _mesh(job)
    src = job["tcfg"]["checkpoint_dir"]
    dst = job["save_dir"]
    tr = _trainer(job, mesh)            # restores the newest of src
    from repro_torch.train.checkpoint import save_checkpoint
    save_checkpoint(dst, tr.start_step - 1, tr.state)
    return {"start_step": tr.start_step, "src": src}


def _refuse_job(job, arrays):
    from repro_torch.launch.mesh import make_debug_mesh
    out = {"family": {}}
    for arch, device in job["other"]:
        try:
            _trainer(dict(job, arch=arch), _mesh(job), device)
            out["family"][f"{arch}.{device}"] = None
        except (NotImplementedError, ValueError) as e:
            out["family"][f"{arch}.{device}"] = f"{type(e).__name__}: {e}"
    try:
        make_debug_mesh(*job["bad_mesh"], device_type="cpu")
        out["mesh"] = None
    except ValueError as e:
        out["mesh"] = str(e)
    return out


def _heads_job(job, arrays):
    """The head-split autograd pair around K4 / K5 on cuda:0 (the card),
    or around their plain versions with "device": "cpu"."""
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import ServeMesh
    r, n = dist.get_rank(), dist.get_world_size()
    tp = ServeMesh(dist.group.WORLD, r, n)
    dev = job.get("device", "cuda")
    with np.load(job["inputs"]) as z:
        for case in job["cases"]:
            a = {k: torch.from_numpy(z[f"{case}.{k}"]).to(dev)
                 for k in ("q", "k", "v", "do")}
            dtype = torch.bfloat16 if "bf16" in case else torch.float32
            q, k, v = (a[x].to(dtype).requires_grad_(True)
                       for x in ("q", "k", "v"))
            o = ops.head_sharded_attention(
                q, k, v, tp, causal=job.get("causal", {}).get(case, True))
            o.backward(a["do"].to(dtype))
            for name, t in (("o", o), ("dq", q.grad), ("dk", k.grad),
                            ("dv", v.grad)):
                arrays[f"{case}.{name}"] = t.detach().float().cpu().numpy()
    return {"cases": job["cases"]}


def _cell_job(job, arrays):
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.specs import prefill_cell, serve_cell
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.sharding.shards import local_slice, shard, slice_bounds
    from repro_torch.tree import map_tree
    cfg = get_smoke_config(job["arch"]).replace(**job["replace"])
    mesh = _mesh(job)
    B, S = job["shape"]
    kind = job["cell"]
    cell = prefill_cell if kind == "prefill" else serve_cell
    step, args, shardings = cell(cfg, ShapeSpec(kind, S, B, kind), mesh)
    with np.load(job["params"]) as z:
        flat = {k: z[k] for k in z.files}
    tree = {}
    for path, a in flat.items():
        node = tree
        *head, last = path.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = a
    params = map_tree(shard, params_from_numpy(tree, cfg, "cpu"),
                      shardings[0])
    with np.load(job["inputs"]) as z:
        inp = {k: z[k] for k in z.files}
    cache_sh = shardings[2] if kind == "prefill" else shardings[1]
    local = lambda a, sh: local_slice(torch.from_numpy(a), sh.placements,
                                      mesh).clone()
    names = sorted(k[len("cache."):] for k in inp if k.startswith("cache."))
    cache = {n: local(inp[f"cache.{n}"], cache_sh[n]) for n in names}
    out = {"bounds": {n: slice_bounds(inp[f"cache.{n}"].shape,
                                      cache_sh[n].placements, mesh)
                      for n in names}}
    name = job["name"]
    if job.get("count"):                # the first call under StepCost
        from repro_torch.launch.cost import StepCost
        inner = step

        def step(*a):
            if "collectives" in out:
                return inner(*a)
            with StepCost() as sc:
                res = inner(*a)
            out["collectives"] = sc.summary()["collectives"]
            return res
    with torch.no_grad():
        if kind == "prefill":
            batch = {k: local(inp[k], shardings[1][k])
                     for k in shardings[1]}
            logits, cache, lens = step(params, batch, cache)
            arrays[f"{name}.logits"] = logits.numpy()
            arrays[f"{name}.lens"] = lens.numpy()
            out["rows"] = slice_bounds(inp["tokens"].shape,
                                       shardings[1]["tokens"].placements,
                                       mesh)
        else:
            out["rows"] = slice_bounds(inp["tokens.0"].shape,
                                       shardings[2].placements, mesh)
            for i in range(job["steps"]):
                tok = local(inp[f"tokens.{i}"], shardings[2])
                lens = local(inp[f"lens.{i}"], shardings[3])
                logits, cache = step(params, cache, tok, lens)
                arrays[f"{name}.logits.{i}"] = logits.numpy()
                for n in job.get("after", ()):  # these leaves, each step
                    arrays[f"{name}.after.{i}.{n}"] = cache[n].numpy()
    for n in names:
        arrays[f"{name}.cache.{n}"] = cache[n].numpy()
    return out


def _family_cells_job(job, arrays):
    from repro_torch.configs import TrainConfig, get_smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.specs import prefill_cell, serve_cell, train_cell
    from repro_torch.models import build_model
    from repro_torch.sharding.shards import local_slice
    mesh = _mesh(job)
    B, S = 4, 32
    rng = np.random.default_rng(5)
    local = lambda a, sh: local_slice(torch.from_numpy(a), sh.placements,
                                      mesh).contiguous()
    finite = lambda t: {"shape": list(t.shape),
                        "finite": bool(torch.isfinite(t).all())}
    out = {}
    for arch in job["archs"]:
        cfg = get_smoke_config(arch).replace(dtype="float32")
        step = train_cell(cfg, ShapeSpec("t", S, B, "train"), mesh,
                          TrainConfig(global_batch=B, seq_len=S))[0]
        try:
            step(None, None)
            out[f"{arch}.train"] = None
        except (NotImplementedError, AttributeError, TypeError) as e:
            out[f"{arch}.train"] = f"{type(e).__name__}: {e}"
        model = build_model(cfg, "cpu")
        params = model.init(0)
        step, _, sh = prefill_cell(cfg, ShapeSpec("p", S, B, "prefill"),
                                   mesh)
        tokens = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
        with torch.no_grad():
            batch = {"tokens": local(tokens, sh[1]["tokens"])}
            logits = step(params, batch,
                          model.init_cache(B, S, shardings=sh[2]))[0]
            out[f"{arch}.prefill"] = finite(logits)
            step, _, sh = serve_cell(cfg, ShapeSpec("d", S, B, "decode"),
                                     mesh)
            tokens = rng.integers(0, cfg.vocab_size, (B, 1), dtype=np.int32)
            logits = step(params, model.init_cache(B, S, shardings=sh[1]),
                          local(tokens, sh[2]),
                          local(np.full((B,), 5, np.int32), sh[3]))[0]
            out[f"{arch}.decode"] = finite(logits)
    return out


def _a2a_job(job, arrays):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.moe_a2a import local_experts, make_sharded_moe
    mesh = _mesh(job)
    (d, m), (nd, nm) = mesh.get_coordinate(), job["mesh"]
    with np.load(job["inputs"]) as z:
        a = {k: z[k] for k in z.files}
    B, S = a["x"].shape[:2]
    rows = slice(d * B // nd, (d + 1) * B // nd)
    seq = slice(m * S // nm, (m + 1) * S // nm)
    name = job["name"]
    for f in job["factors"]:
        cfg = get_smoke_config(job["arch"]).replace(
            dtype="float32", moe_capacity_factor=f)
        params = {k: torch.from_numpy(a[k]).requires_grad_(True)
                  for k in ("router", "experts_in", "experts_gate",
                            "experts_out")}
        x = torch.from_numpy(np.ascontiguousarray(
            a["x"][rows, seq])).requires_grad_(True)
        w = torch.from_numpy(np.ascontiguousarray(a["w"][rows, seq]))
        y, aux = make_sharded_moe(cfg, mesh)(local_experts(params, m, nm),
                                             x)
        (torch.sum(y * w) + AUX_C * aux / nd).backward()
        arrays[f"{name}.{f}.y"] = y.detach().numpy()
        arrays[f"{name}.{f}.aux"] = aux.detach().numpy()
        arrays[f"{name}.{f}.dx"] = x.grad.numpy()
        for k, p in params.items():
            arrays[f"{name}.{f}.d{k}"] = p.grad.numpy()
    return {"coord": [d, m], "rows": [rows.start, rows.stop],
            "seq": [seq.start, seq.stop]}


JOBS = {"a2a": _a2a_job, "cell": _cell_job,
        "family_cells": _family_cells_job, "slices": _slices_job,
        "batch": _batch_job, "train": _train_job, "restore": _restore_job,
        "refuse": _refuse_job, "heads": _heads_job}


def run(rank: int, world: int, store: str, job_file: str, out_dir: str):
    torch.set_num_threads(1)
    with open(job_file) as f:
        spec = json.load(f)
    if spec.get("cuda"):
        torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        results, arrays = {}, {}
        for job in spec["jobs"]:
            env = job.get("env", {})
            os.environ.update(env)
            try:
                results[job["name"]] = JOBS[job["kind"]](job, arrays)
            except Exception:           # the test reports the rank's trace
                results[job["name"]] = {"error": traceback.format_exc()}
                raise
            finally:
                for k in env:
                    del os.environ[k]
                with open(os.path.join(out_dir, f"rank{rank}.json"),
                          "w") as f:
                    json.dump(results, f)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    run(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
