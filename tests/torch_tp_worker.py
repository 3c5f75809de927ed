"""One rank of a gloo world for tests/test_torch_tp.py and
tests/test_torch_tp_models.py: tensor-parallel serving (ROADMAP M10) of the
port, one process per rank.  It joins the world through a FileStore, then
runs the jobs the test wrote to a JSON file - engines and fleets replaying
traces, the head-sharded kernel wrappers on saved inputs, the serve mesh's
refusals - and writes what each job gave to rank<r>.json (and the wrapper
outputs to rank<r>.npz) for the test to compare.

Kept apart from the test modules so that a spawned rank imports torch and
the port only, not jax; the test modules import the summaries below and
apply them to their in-process engines (the JAX package's too: they read
the surface the two engines share)."""
import dataclasses
import datetime
import json
import os
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ServeConfig, get_smoke_config
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_serve_mesh
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import FleetConfig, FleetRouter, ServeEngine

# stats() keys that are wall-clock times, and the JAX engine's count of
# compiled step variants (the eager port compiles none)
WALL_KEYS = {"ttft_wall_p50", "ttft_wall_p95", "tbt_wall_p50",
             "tbt_wall_p95", "tick_host_wall_p50", "tick_host_wall_p95"}
JAX_ONLY_KEYS = {"compile_count"}
# tp_stats() keys of the port alone
PORT_TP_KEYS = {"rank", "rank_kv_cache_bytes"}


def _plain(x):
    """x as JSON's types (tuples to lists, numpy scalars to numbers)."""
    return json.loads(json.dumps(x, default=lambda o: o.item()))


# ---------------------------------------------------------------------------
# weights and traffic, as the test hands them over
# ---------------------------------------------------------------------------

def save_params(path: str, tree) -> None:
    """A nested dict of numpy arrays to one .npz, keys joined by '/'."""
    flat = {}

    def walk(t, pre):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{pre}{k}/")
            else:
                flat[pre + k] = np.asarray(v)
    walk(tree, "")
    np.savez(path, **flat)


def load_params(path: str, cfg):
    """The port's parameter tree on the CPU from save_params' file."""
    tree = {}
    with np.load(path) as d:
        for key in d.files:
            *dirs, leaf = key.split("/")
            node = tree
            for k in dirs:
                node = node.setdefault(k, {})
            node[leaf] = d[key]
    return params_from_numpy(tree, cfg, "cpu")


def item_dict(it) -> dict:
    """A tests/traffic.py TrafficItem as a plain dict."""
    return {"tick": it.tick, "prompt": list(it.prompt),
            "max_new": it.max_new, "stop_tokens": it.stop_tokens,
            "priority": it.priority, "deadline": it.deadline,
            "max_retries": it.max_retries}


def _submit(target, it: dict) -> int:
    return target.submit(it["prompt"], max_new_tokens=it["max_new"],
                         stop_tokens=it["stop_tokens"],
                         priority=it["priority"], deadline=it["deadline"],
                         max_retries=it["max_retries"])


def replay(eng, items, max_ticks: int = 50_000):
    """tests/traffic.py replay: each item submitted at its tick, the engine
    ticked until the trace drains, check_invariants after every tick."""
    pending = sorted(items, key=lambda it: it["tick"])
    tick = 0
    while pending or eng.queue or any(s is not None for s in eng.slots):
        while pending and pending[0]["tick"] <= tick:
            _submit(eng, pending.pop(0))
        eng.tick()
        eng.check_invariants()
        tick += 1
        if tick >= max_ticks:
            raise RuntimeError(f"replay: {max_ticks} ticks exhausted")
    return eng


def replay_fleet(router, items, kills=(), max_ticks: int = 50_000):
    """tests/chaos.py replay_fleet_chaos with the kill fault only: replica
    r fails just before fleet tick t for each (t, r) in `kills`; the
    router's invariants after every tick."""
    pending = sorted(items, key=lambda it: it["tick"])
    last = max((t for t, _ in kills), default=0)
    tick = 0
    while pending or not router.idle or tick <= last:
        for t, r in kills:
            if t == tick:
                router.fail(r)
        while pending and pending[0]["tick"] <= tick:
            _submit(router, pending.pop(0))
        router.tick()
        router.check_invariants()
        tick += 1
        if tick >= max_ticks:
            raise RuntimeError(f"replay_fleet: {max_ticks} ticks exhausted")
    return router


# ---------------------------------------------------------------------------
# what a run gave, for either package's engine
# ---------------------------------------------------------------------------

def engine_summary(eng) -> dict:
    """Every device-independent result of an engine's run: outputs, launch
    records, the launch_log without wall time, work clock, tick log,
    counts, stats() without wall times, tp_stats(), the cache bytes, the
    serve_tp_degree gauge and movement_stats()."""
    fin = sorted(eng.sched.finished, key=lambda r: r.uid)
    stats = eng.stats()
    return _plain({
        "outputs": {str(r.uid): list(r.out_tokens) for r in fin},
        "requests": [(r.uid, r.token_work, r.token_tick, r.n_preemptions,
                      r.n_resumes, r.finish_reason) for r in fin],
        "records": [dataclasses.astuple(r) for r in eng.launch_records()],
        "log": [(r[0], r[1], r[3], r[4]) for r in eng.launch_log],
        "work_clock": eng.sched.work_clock,
        "tick_log": eng.sched.tick_log,
        "gen_tokens": eng.gen_tokens,
        "host_syncs": eng.host_syncs,
        "kv_pages_read": eng.kv_pages_read,
        "stats": {k: v for k, v in stats.items()
                  if k not in WALL_KEYS | JAX_ONLY_KEYS},
        "tp_stats": eng.tp_stats(),
        "kv_cache_bytes": eng.kv_cache_bytes(),
        "tp_gauge": eng.metrics_snapshot()["serve_tp_degree"]["value"],
        "movement": eng.movement_stats(),
        "table": eng.allocator.table.tolist() if eng.paged else None,
    })


def fleet_summary(router) -> dict:
    """A fleet's results: outputs by fleet uid, placements, dispatch
    counts, statuses, replica states, fleet_stats() without per-replica
    or wall entries, and each replica's engine_summary."""
    fs = router.fleet_stats()
    return _plain({
        "outputs": {str(f): list(o) for f, o in router.outputs().items()},
        "placement": {str(f): i for f, i in router.placement.items()},
        "dispatch": router.dispatch_counts(),
        "statuses": {str(f): s for f, s in router.statuses().items()},
        "states": [s.value for s in router.states],
        "fleet_stats": {k: v for k, v in fs.items()
                        if k != "per_replica" and k not in WALL_KEYS},
        "engines": [engine_summary(e) for e in router.engines],
    })


# ---------------------------------------------------------------------------
# the jobs
# ---------------------------------------------------------------------------

def _model(spec, models, arch):
    if arch not in models:
        cfg = get_smoke_config(arch).replace(dtype="float32")
        m = build_model(cfg, device="cpu")
        models[arch] = (m, load_params(spec["params"][arch], cfg))
    return models[arch]


def _engine_job(job, spec, models):
    m, p = _model(spec, models, job["arch"])
    eng = replay(ServeEngine(m, p, ServeConfig(**job["scfg"])),
                 job["items"])
    return engine_summary(eng)


def _fleet_job(job, spec, models):
    m, p = _model(spec, models, job["arch"])
    router = FleetRouter(m, p, ServeConfig(**job["scfg"]),
                         FleetConfig(n_replicas=job["n_replicas"]))
    return fleet_summary(replay_fleet(router, job["items"],
                                      [tuple(k) for k in job["kills"]]))


def _stats_job(job, spec, models):
    """tests/test_tp_serve.py test_tp_stats_surface: one request through
    run_until_done()."""
    m, p = _model(spec, models, job["arch"])
    eng = ServeEngine(m, p, ServeConfig(**job["scfg"]))
    eng.submit(job["prompt"])
    eng.run_until_done()
    return engine_summary(eng)


def _mesh_job(job, spec, models):
    """make_serve_mesh at each degree in job["degrees"]: the mesh's (rank,
    size), or the ValueError's text."""
    out = {}
    for n in job["degrees"]:
        try:
            mesh = make_serve_mesh(n)
            out[str(n)] = [mesh.rank, mesh.size]
        except ValueError as e:
            out[str(n)] = str(e)
    return out


def _kernel_job(job, spec, models, arrays):
    """The head-sharded wrappers on saved inputs: this rank takes its KV
    heads' slice of the pools and calls the wrapper with the mesh; the
    gathered output goes to arrays[case]."""
    mesh = make_serve_mesh(job["tp"])
    with np.load(job["inputs"]) as d:
        for case in job["cases"]:
            a = {k[len(case) + 1:]: torch.from_numpy(d[k])
                 for k in d.files if k.startswith(case + ".")}
            kp = ops.shard_heads(a["kp"], mesh).contiguous()
            vp = ops.shard_heads(a["vp"], mesh).contiguous()
            if "offs" in a:
                o = ops.batched_paged_prefill_attention(
                    a["q"], kp, vp, a["tables"], a["offs"], a["lens"],
                    a.get("q_lens"), impl="ref", tp_mesh=mesh)
            else:
                o = ops.paged_flash_decode(a["q"], kp, vp, a["tables"],
                                           a["lens"], impl="ref",
                                           tp_mesh=mesh)
            arrays[case] = o.numpy()
    return {"cases": job["cases"]}


JOBS = {"engine": _engine_job, "fleet": _fleet_job, "stats": _stats_job,
        "mesh": _mesh_job}


def run(rank: int, world: int, store: str, job_file: str, out_dir: str):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        with open(job_file) as f:
            spec = json.load(f)
        models, results, arrays = {}, {}, {}
        for job in spec["jobs"]:
            try:
                if job["kind"] == "kernels":
                    results[job["name"]] = _kernel_job(job, spec, models,
                                                       arrays)
                else:
                    results[job["name"]] = JOBS[job["kind"]](job, spec,
                                                             models)
            except Exception:           # the test reports the rank's trace
                results[job["name"]] = {"error": traceback.format_exc()}
                raise
            finally:
                with open(os.path.join(out_dir, f"rank{rank}.json"),
                          "w") as f:
                    json.dump(results, f)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    finally:
        dist.destroy_process_group()
