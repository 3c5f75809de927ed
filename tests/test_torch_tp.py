"""Tensor-parallel paged serving (ROADMAP M10) of the port against the JAX
package on the CPU: the counterparts of tests/test_tp_serve.py and of
tests/test_chaos.py's tensor-parallel kill, on the granite-3-2b smoke
config (4 query / 2 KV heads of 16) in float32 with the JAX Model.init
weights.

The port's tp 2 runs in ONE gloo world of two processes per module
(tests/torch_tp_worker.py, spawned from the module fixture; the ranks
meet through a FileStore under the fixture's directory and have JOIN_S
seconds, after which the fixture fails and kills them).  Each rank builds
the model from the same saved numpy weights and replays every job: the
four conformance traces (tests/conformance.py TRACES), speculation, the
traces under the pressure that makes them preempt and hit (ROADMAP §3), a
2-replica fleet of tp 2 replicas with and without a replica killed
mid-trace, the stats surface, the serve mesh's refusal of a small world
and the head-sharded wrappers on seeded random inputs.  While the world
runs, the fixture replays the same jobs in-process through the port's tp
1 engine and the JAX package's tp 1 engine, and a subprocess with two
host devices replays every trace through the JAX package's tp 2 engine
(its own shard_map path).

Held: every rank's results equal rank 0's; the port's tp 2 equals its tp
1 bit for bit (outputs, launch records, work clock, tick log, counts and
every stats() value but tp_degree); against the JAX tp 1 engine the
device-independent counts are equal and the outputs equal or pass the
teacher-forced near-tie check (tests/traffic.py); against the JAX tp 2
engine every summary key equals, tp_stats() included (less the port's two
own keys); shard bytes x tp == pages read x page bytes; the wrappers'
gathered outputs equal the unsharded plain version's bit for bit.
"""
import copy
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_tp_worker as W
from conformance import BASE_SCFG, TRACES
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import ServeConfig as JaxServeConfig
from repro.models import build_model as jax_build_model
from repro.serve import FleetConfig as JaxFleetConfig
from repro.serve import FleetRouter as JaxFleetRouter
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.configs import ServeConfig, get_smoke_config
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_serve_mesh
from repro_torch.models import build_model
from repro_torch.serve import FleetConfig, FleetRouter, ServeEngine
from torch_replay import one_torch_thread
from traffic import assert_greedy_equivalent

ARCH = "granite-3-2b"
JOIN_S = 120
# the JAX tp 2 subprocess (jit compiles of the shard_map steps; ~20 s
# alone on a few cores, slower beside a loaded test run)
ORACLE_S = 300
# tests/test_tp_serve.py's engine shape
TP_SCFG = dict(max_batch=4, max_seq=512, page_size=16, prefill_chunk=32,
               tick_token_budget=64, max_new_tokens=12, paged=True,
               chunked=True, batched=True)
# (trace, speculative, extra ServeConfig fields) of each engine job; the
# pressure jobs are the port's own (tests/test_torch_preempt.py,
# tests/test_torch_prefix.py): without it priority_burst never preempts
# and shared_prefix never hits (ROADMAP §3)
ENGINE_JOBS = {
    **{f"trace/{t}": (t, False, {}) for t in sorted(TRACES)},
    "spec/mixed": ("mixed", True, {}),
    "pressure/priority_burst": ("priority_burst", False,
                                dict(usable_pages=18)),
    "pressure/shared_prefix": ("shared_prefix", True, dict(max_batch=2)),
}
# the fleets: tests/test_tp_serve.py's differential (8 new tokens) and
# tests/test_chaos.py's tensor-parallel kill (12; replica 1 at tick 2)
FLEET_NEW = 8
CHAOS_NEW = 12
KILLS = [(2, 1)]
# the wrapper cases of tests/test_tp_serve.py (hkv_mult, gqa, n_rows,
# seed; the chunk cases also ragged), then seeded draws of the property
# sweep (its hypothesis ranges)
DECODE_CASES = [(1, 1, 1, 0), (1, 2, 2, 1), (2, 2, 3, 2)] + [
    (1 + s % 2, 1 + s // 2 % 2, 1 + s % 3, 100 + s) for s in range(6)]
CHUNK_CASES = [(1, 1, 1, False, 3), (1, 2, 2, True, 4),
               (2, 1, 3, True, 5)] + [
    (1 + s % 2, 1 + s // 2 % 2, 1 + s % 3, bool(s % 2), 200 + s)
    for s in range(6)]

# the JAX package's tp 2 engine over every trace, in a process with two
# host devices: its engine_summary per trace, as JSON
JAX_TP2 = """
import json, sys
import jax
from conformance import TRACES, make_scfg
from repro.configs import get_smoke_config
from repro.models import build_model
from repro.serve import ServeEngine
from traffic import replay
import torch_tp_worker as W
assert jax.device_count() >= 2
cfg = get_smoke_config("granite-3-2b").replace(dtype="float32")
m = build_model(cfg)
params = m.init(jax.random.PRNGKey(0))
out = {}
for name in sorted(TRACES):
    eng = ServeEngine(m, params, make_scfg(TRACES[name], False, tp_degree=2))
    replay(eng, TRACES[name].build(cfg.vocab_size), check=True)
    out[name] = W.engine_summary(eng)
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
"""


_threads = pytest.fixture(scope="module", autouse=True)(one_torch_thread)


def _kw(trace, speculative, **extra):
    return {**BASE_SCFG, **TRACES[trace].scfg_kw,
            "speculative": speculative, **extra}


def random_paged(rng, tp, hkv_mult, gqa, n_rows, d=8, page_size=4,
                 n_pages=24, n_max=6):
    """tests/test_tp_serve.py _random_paged in numpy: Hkv a multiple of
    tp, Hq = Hkv gqa, block tables of distinct pages (page 0 the null
    page), lengths in [1, n_max page_size]."""
    hkv = tp * hkv_mult
    kp = rng.standard_normal((n_pages, page_size, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((n_pages, page_size, hkv, d)).astype(np.float32)
    tables = np.zeros((n_rows, n_max), np.int32)
    lens = np.zeros((n_rows,), np.int32)
    for r in range(n_rows):
        n = int(rng.integers(1, n_max * page_size + 1))
        lens[r] = n
        need = -(-n // page_size)
        tables[r, :need] = rng.choice(np.arange(1, n_pages), size=need,
                                      replace=False)
    return hkv * gqa, dict(kp=kp, vp=vp, tables=tables, lens=lens)


def decode_inputs(tp, hkv_mult, gqa, n_rows, seed):
    rng = np.random.default_rng(seed)
    hq, a = random_paged(rng, tp, hkv_mult, gqa, n_rows)
    a["q"] = rng.standard_normal((n_rows, 1, hq, 8)).astype(np.float32)
    return a


def chunk_inputs(tp, hkv_mult, gqa, n_rows, ragged, seed, s=8):
    """Chunk rows at the tail of each row's span (offsets may overhang
    short rows, as a padded final chunk does); `ragged` adds q_lens, the
    verify lane."""
    rng = np.random.default_rng(seed)
    hq, a = random_paged(rng, tp, hkv_mult, gqa, n_rows)
    a["offs"] = np.maximum(a["lens"] - s, 0).astype(np.int32)
    a["q"] = rng.standard_normal((n_rows, s, hq, 8)).astype(np.float32)
    if ragged:
        a["q_lens"] = rng.integers(1, s + 1, size=n_rows).astype(np.int32)
    return a


def kernel_cases(tp):
    """{case name: inputs} of every wrapper case at tp."""
    cases = {f"decode{i}": decode_inputs(tp, *c)
             for i, c in enumerate(DECODE_CASES)}
    cases.update({f"chunk{i}": chunk_inputs(tp, *c)
                  for i, c in enumerate(CHUNK_CASES)})
    return cases


def unsharded(a):
    """The plain version on every head (no mesh)."""
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    if "offs" in t:
        return ops.batched_paged_prefill_attention(
            t["q"], t["kp"], t["vp"], t["tables"], t["offs"], t["lens"],
            t.get("q_lens"), impl="ref").numpy()
    return ops.paged_flash_decode(t["q"], t["kp"], t["vp"], t["tables"],
                                  t["lens"], impl="ref").numpy()


def spawn_world(world: int, d: str):
    """Start a gloo world of `world` ranks on the jobs in d/jobs.json."""
    return mp.start_processes(
        W.run, args=(world, os.path.join(d, "store"),
                     os.path.join(d, "jobs.json"), d),
        nprocs=world, join=False, start_method="spawn")


def join_world(ctx, world: int, d: str, t0: float):
    """Wait for the world (JOIN_S from t0, then kill it and fail); each
    rank's results (json, npz)."""
    deadline = t0 + JOIN_S
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                pytest.fail(f"gloo world of {world} did not finish in "
                            f"{JOIN_S} s")
    except mp.ProcessRaisedException as e:
        pytest.fail(f"a rank of the gloo world of {world} failed:\n{e}")
    out = []
    for r in range(world):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            js = json.load(f)
        with np.load(os.path.join(d, f"rank{r}.npz")) as z:
            out.append((js, {k: z[k] for k in z.files}))
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Everything the module compares: the gloo world's results per rank,
    the port's and the JAX package's tp 1 runs of the same jobs (in this
    process), the JAX package's tp 2 run of every trace (a subprocess),
    and the wrapper cases' inputs."""
    d = str(tmp_path_factory.mktemp("tp"))
    jcfg = jax_smoke_config(ARCH).replace(dtype="float32")
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    params = os.path.join(d, "granite.npz")
    W.save_params(params, jax.device_get(jp))
    vocab = jcfg.vocab_size
    items = lambda t: [W.item_dict(i) for i in TRACES[t].build(vocab)]
    jobs = [{"name": name, "kind": "engine", "arch": ARCH,
             "scfg": _kw(t, spec, tp_degree=2, **extra), "items": items(t)}
            for name, (t, spec, extra) in ENGINE_JOBS.items()]
    fleet = dict(arch=ARCH, kind="fleet", n_replicas=2, items=items("mixed"))
    jobs += [
        dict(fleet, name="fleet", kills=[],
             scfg=_kw("mixed", False, max_new_tokens=FLEET_NEW,
                      tp_degree=2)),
        dict(fleet, name="chaos_free", kills=[],
             scfg=_kw("mixed", False, max_new_tokens=CHAOS_NEW,
                      tp_degree=2)),
        dict(fleet, name="chaos", kills=KILLS,
             scfg=_kw("mixed", False, max_new_tokens=CHAOS_NEW,
                      tp_degree=2)),
        {"name": "stats", "kind": "stats", "arch": ARCH,
         "scfg": dict(TP_SCFG, tp_degree=2), "prompt": list(range(1, 40))},
        {"name": "mesh", "kind": "mesh", "degrees": [2, 3]}]
    cases = kernel_cases(2)
    kin = os.path.join(d, "kernels.npz")
    np.savez(kin, **{f"{c}.{k}": v for c, a in cases.items()
                     for k, v in a.items()})
    jobs.append({"name": "kernels", "kind": "kernels", "tp": 2,
                 "inputs": kin, "cases": sorted(cases)})
    with open(os.path.join(d, "jobs.json"), "w") as f:
        json.dump({"params": {ARCH: params}, "jobs": jobs}, f)

    t0 = time.monotonic()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    jax_out = os.path.join(d, "jax_tp2.json")
    env = dict(os.environ, PYTHONPATH=f"{root}/src:{root}/tests",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               JAX_PLATFORMS="cpu")
    oracle = subprocess.Popen([sys.executable, "-c", JAX_TP2, jax_out],
                              cwd=root, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
    ctx = spawn_world(2, d)

    # meanwhile: tp 1 of every job in this process, in both packages
    tcfg = get_smoke_config(ARCH).replace(dtype="float32")
    tm = build_model(tcfg, device="cpu")
    tp = W.load_params(params, tcfg)
    port1, jax1 = {}, {}
    for job in jobs:
        if job["kind"] == "engine":
            kw = dict(job["scfg"], tp_degree=1)
            port1[job["name"]] = W.engine_summary(W.replay(
                ServeEngine(tm, tp, ServeConfig(**kw)), job["items"]))
            jax1[job["name"]] = W.engine_summary(W.replay(
                JaxServeEngine(jm, jp, JaxServeConfig(**kw)),
                job["items"]))
    for name, n, new, kills in (("fleet", 1, FLEET_NEW, []),
                                ("chaos", 2, CHAOS_NEW, KILLS)):
        kw = _kw("mixed", False, max_new_tokens=new)
        port1[name] = W.fleet_summary(W.replay_fleet(
            FleetRouter(tm, tp, ServeConfig(**kw), FleetConfig(n_replicas=n)),
            items("mixed"), kills))
        jax1[name] = W.fleet_summary(W.replay_fleet(
            JaxFleetRouter(jm, jp, JaxServeConfig(**kw),
                           JaxFleetConfig(n_replicas=n)),
            items("mixed"), kills))

    ranks = join_world(ctx, 2, d, t0)
    try:
        log, _ = oracle.communicate(timeout=max(t0 + ORACLE_S
                                                - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        oracle.kill()
        oracle.communicate()
        pytest.fail(f"the JAX tp 2 run did not finish in {ORACLE_S} s")
    assert oracle.returncode == 0, log[-4000:]
    with open(jax_out) as f:
        jax2 = json.load(f)
    return SimpleNamespace(ranks=ranks, port1=port1, jax1=jax1, jax2=jax2,
                           cases=cases, items=items, jm=jm, jp=jp)


def _prompts(items):
    """uid -> prompt of a replay of `items` (uids in submit order)."""
    order = sorted(items, key=lambda it: it["tick"])
    return {str(u): it["prompt"] for u, it in enumerate(order, start=1)}


def assert_same_greedy(run, got, want, prompts):
    """outputs `got` equal `want`, or every token of a request that
    differs passes the teacher-forced near-tie check on the JAX model."""
    assert got.keys() == want.keys()
    if got != want:
        done = [SimpleNamespace(uid=u, prompt=prompts[u], out_tokens=o)
                for u, o in got.items()]
        assert_greedy_equivalent(run.jm, run.jp, done, want)


def assert_shard_accounting(t):
    """tests/conformance.py assert_tp_shard_accounting on a tp_stats()."""
    tp = t["tp_degree"]
    assert t["shard_page_bytes"] * tp == t["page_bytes"], t
    assert t["shard_kv_bytes_read"] * tp \
        == t["kv_pages_read"] * t["page_bytes"], t
    if tp > 1 and t["kv_pages_read"] > 0:
        assert t["table_bytes_replicated"] > 0, t


def same_but_degree(got, tp1, tp=2):
    """A tp `tp` engine summary against a tp 1 one: everything equal but
    the degree and what follows from it (the per-shard and replicated
    bytes, the per-device movement section, the rank's cache bytes: its
    1 / tp of the pools and the whole block table)."""
    for key in got:
        if key in ("tp_stats", "tp_gauge", "movement"):
            continue
        if key == "stats":
            assert {k: v for k, v in got[key].items() if k != "tp_degree"} \
                == {k: v for k, v in tp1[key].items() if k != "tp_degree"}
            continue
        assert got[key] == tp1[key], key
    a, b = got["tp_stats"], tp1["tp_stats"]
    assert a["tp_degree"] == tp and got["stats"]["tp_degree"] == tp
    assert a["kv_pages_read"] == b["kv_pages_read"]
    assert a["page_bytes"] == b["page_bytes"]
    assert a["shard_kv_bytes_read"] * tp == b["shard_kv_bytes_read"]
    assert a["table_bytes_replicated"] == tp * b["table_bytes_replicated"]
    table = b["rank_kv_cache_bytes"] - a["rank_kv_cache_bytes"] * tp
    table //= 1 - tp
    assert (a["rank_kv_cache_bytes"] - table) * tp + table \
        == b["rank_kv_cache_bytes"] == got["kv_cache_bytes"]
    assert {k: v for k, v in got["movement"].items() if k != "per_device"} \
        == tp1["movement"]
    assert got["movement"]["per_device"]["tp_degree"] == tp
    assert got["tp_gauge"] == tp and tp1["tp_gauge"] == 1


def _engine(run, name):
    """Rank 0's summary of an engine job (test_every_rank_agrees holds
    the other rank to it)."""
    return run.ranks[0][0][name]


# ===========================================================================
# validation: the JAX package's refusals, with its words
# ===========================================================================

def _raises_alike(build_port, build_jax):
    with pytest.raises(ValueError) as port:
        build_port()
    with pytest.raises(ValueError) as jx:
        build_jax()
    assert str(port.value) == str(jx.value)
    return str(port.value)


def test_tp_degree_below_one_rejected():
    kw = dict(TP_SCFG, tp_degree=0)
    msg = _raises_alike(lambda: ServeConfig(**kw).validate(),
                        lambda: JaxServeConfig(**kw).validate())
    assert "tp_degree" in msg


@pytest.mark.parametrize("off", [("paged", "chunked"), ("chunked",),
                                 ("batched",)])
def test_tp_requires_paged_chunked_batched(off):
    kw = {**TP_SCFG, "tp_degree": 2, **{k: False for k in off}}
    msg = _raises_alike(lambda: ServeConfig(**kw).validate(),
                        lambda: JaxServeConfig(**kw).validate())
    assert "tp_degree" in msg


def test_tp_indivisible_heads_rejected():
    """n_kv_heads 2 over tp 3: the engine says so by name, before any mesh
    or process group is asked for."""
    jcfg = jax_smoke_config(ARCH).replace(dtype="float32")
    jm = jax_build_model(jcfg)
    tm = build_model(get_smoke_config(ARCH).replace(dtype="float32"),
                     device="cpu")
    kw = dict(TP_SCFG, tp_degree=3)
    msg = _raises_alike(
        lambda: ServeEngine(tm, tm.init(seed=0), ServeConfig(**kw)),
        lambda: JaxServeEngine(jm, jm.init(jax.random.PRNGKey(0)),
                               JaxServeConfig(**kw)))
    assert "n_kv_heads" in msg


def test_serve_mesh_without_a_process_group():
    """No process group: tp 2 raises, naming the world size and the way
    out; tp 1 needs none; tp 0 is refused.  The engine and a fleet of tp
    2 replicas raise the same, and never serve at tp 1."""
    with pytest.raises(ValueError, match="world size.*nproc-per-node=2"):
        make_serve_mesh(2)
    with pytest.raises(ValueError, match="tp_degree"):
        make_serve_mesh(0)
    mesh = make_serve_mesh(1)
    assert (mesh.rank, mesh.size, mesh.group) == (0, 1, None)
    tm = build_model(get_smoke_config(ARCH).replace(dtype="float32"),
                     device="cpu")
    kw = dict(TP_SCFG, tp_degree=2)
    with pytest.raises(ValueError, match="world size"):
        ServeEngine(tm, tm.init(seed=0), ServeConfig(**kw))
    with pytest.raises(ValueError, match="world size"):
        FleetRouter(tm, tm.init(seed=0), ServeConfig(**kw))


def test_serve_mesh_rejects_a_small_world(run):
    """In a world of 2: a tp 2 mesh on each rank, tp 3 refused."""
    for rank, (res, _) in enumerate(run.ranks):
        got = res["mesh"]
        assert got["2"] == [rank, 2]
        assert "world size of at least 3" in got["3"] \
            and "has 2" in got["3"], got["3"]


# ===========================================================================
# the engine: tp 2 against tp 1 and against the JAX package
# ===========================================================================

def test_every_rank_agrees(run):
    """Every job's results on rank 1 equal rank 0's (the rank itself
    aside): the ranks stay in lockstep and emit the same tokens."""
    (r0, a0), (r1, a1) = copy.deepcopy(run.ranks)
    assert r0.keys() == r1.keys()
    for name in set(r0) - {"mesh"}:
        a, b = r0[name], r1[name]
        for s in [a] + a.get("engines", []):
            if "tp_stats" in s:
                s["tp_stats"] = dict(s["tp_stats"], rank=None)
        for s in [b] + b.get("engines", []):
            if "tp_stats" in s:
                assert s["tp_stats"]["rank"] == 1
                s["tp_stats"] = dict(s["tp_stats"], rank=None)
        assert a == b, name
    for case in a0:
        assert np.array_equal(a0[case], a1[case]), case


@pytest.mark.parametrize("trace", sorted(TRACES))
def test_trace_tp2_bit_equal_to_tp1(run, trace):
    """The tentpole guarantee: head-sharding changes where the KV bytes
    live, never what is generated - outputs, launch records, work clock,
    pages read and every count equal the port's tp 1 run exactly."""
    name = f"trace/{trace}"
    got = _engine(run, name)
    same_but_degree(got, run.port1[name])
    assert_shard_accounting(got["tp_stats"])


@pytest.mark.parametrize("trace", sorted(TRACES))
def test_trace_tp2_matches_jax(run, trace):
    """Against the JAX tp 1 engine in this process: the device-independent
    counts equal and the outputs greedy-equal; against the JAX tp 2
    engine (two host devices): every summary key, tp_stats() and
    movement_stats()' per_device section included."""
    name = f"trace/{trace}"
    got, j1, j2 = _engine(run, name), run.jax1[name], run.jax2[trace]
    prompts = _prompts(run.items(trace))
    for key in ("records", "log", "work_clock", "tick_log", "gen_tokens",
                "kv_pages_read", "host_syncs", "requests", "table"):
        assert got[key] == j1[key] == j2[key], key
    assert_same_greedy(run, got["outputs"], j1["outputs"], prompts)
    assert_same_greedy(run, got["outputs"], j2["outputs"], prompts)
    port_tp = {k: v for k, v in got["tp_stats"].items()
               if k not in W.PORT_TP_KEYS}
    assert port_tp == j2["tp_stats"]
    for key in ("stats", "kv_cache_bytes", "tp_gauge", "movement"):
        assert got[key] == j2[key], key


def test_tp_composes_with_speculation(run):
    """Speculation on: the verify lane of K1 runs head-sharded too, and
    spec-on tp 2 equals spec-on tp 1."""
    name = "spec/mixed"
    got = _engine(run, name)
    same_but_degree(got, run.port1[name])
    assert got["stats"]["spec_drafted"] > 0, "speculation never engaged"
    for key in ("records", "work_clock", "kv_pages_read"):
        assert got[key] == run.jax1[name][key], key
    assert_same_greedy(run, got["outputs"], run.jax1[name]["outputs"],
                       _prompts(run.items("mixed")))
    assert_shard_accounting(got["tp_stats"])


@pytest.mark.parametrize("trace", ["priority_burst", "shared_prefix"])
def test_tp_under_pressure(run, trace):
    """priority_burst with 18 usable pages preempts (prefilling and
    decoding victims parked and resumed on the rank's own pools);
    shared_prefix at 2 slots, speculation on, hits the prefix cache and
    copies pages on write in the local pools.  Equal to tp 1."""
    name = f"pressure/{trace}"
    got = _engine(run, name)
    same_but_degree(got, run.port1[name])
    if trace == "priority_burst":
        assert got["stats"]["preemptions"] > 0
    else:
        assert got["stats"]["prefix_hit_tokens"] > 0
    for key in ("records", "work_clock", "kv_pages_read", "requests"):
        assert got[key] == run.jax1[name][key], key
    assert_same_greedy(run, got["outputs"], run.jax1[name]["outputs"],
                       _prompts(run.items(trace)))
    assert_shard_accounting(got["tp_stats"])


def test_tp_stats_surface(run):
    """tests/test_tp_serve.py test_tp_stats_surface: tp_stats(), stats()'s
    degree, the serve_tp_degree gauge and movement_stats()'s per_device
    section tell one story; kv_cache_bytes() is the whole logical cache,
    the rank's own pools half of it."""
    got = _engine(run, "stats")
    t = got["tp_stats"]
    assert t["tp_degree"] == 2 and got["stats"]["tp_degree"] == 2
    assert t["shard_page_bytes"] * 2 == t["page_bytes"]
    assert t["shard_kv_bytes_read"] > 0
    assert t["table_bytes_replicated"] > 0
    assert got["tp_gauge"] == 2
    per = got["movement"]["per_device"]
    assert per["tp_degree"] == 2.0
    assert per["kv_read_bytes"] * 2 == got["movement"]["total"][
        "kv_read_bytes"]
    table = TP_SCFG["max_batch"] * (TP_SCFG["max_seq"]
                                    // TP_SCFG["page_size"]) * 4
    assert (t["rank_kv_cache_bytes"] - table) * 2 \
        == got["kv_cache_bytes"] - table


# ===========================================================================
# fleets of tensor-parallel replicas
# ===========================================================================

def test_tp_fleet_differential(run):
    """A 1-replica tp 1 fleet and a 2-replica tp 2 fleet give equal
    outputs per fleet uid, with the shard accounting on every replica;
    the JAX 1-replica fleet greedy-equal."""
    got, want = run.ranks[0][0]["fleet"], run.port1["fleet"]
    assert got["outputs"] == want["outputs"]
    assert_same_greedy(run, got["outputs"], run.jax1["fleet"]["outputs"],
                       _prompts(run.items("mixed")))
    for eng in got["engines"]:
        assert eng["tp_stats"]["tp_degree"] == 2
        assert_shard_accounting(eng["tp_stats"])
    assert got["fleet_stats"]["tp_degree"] == 2
    assert sum(map(len, got["outputs"].values())) \
        == sum(map(len, want["outputs"].values()))


def test_kill_tp_replica_mid_trace_is_invisible_in_outputs(run):
    """tests/test_chaos.py's tensor-parallel kill: replica 1 of a tp 2
    fleet dies at tick 2, and every request ends done with the tokens of
    the fault-free tp 2 fleet; the survivor's shard accounting holds.
    Routing, redispatch and statuses equal the JAX fleet's under the same
    kill, and the tokens its greedy ones."""
    got, free = run.ranks[0][0]["chaos"], run.ranks[0][0]["chaos_free"]
    assert set(got["statuses"].values()) == {"done"}
    assert got["outputs"] == free["outputs"]
    survivor = got["engines"][0]
    assert survivor["tp_stats"]["tp_degree"] == 2
    assert_shard_accounting(survivor["tp_stats"])
    assert got["fleet_stats"]["failures"] == 1
    assert got["fleet_stats"]["replica_states"] == ["healthy", "dead"]
    j = run.jax1["chaos"]
    for key in ("placement", "dispatch", "statuses", "states"):
        assert got[key] == j[key], key
    assert got["outputs"] == run.port1["chaos"]["outputs"]
    assert_same_greedy(run, got["outputs"], j["outputs"],
                       _prompts(run.items("mixed")))


# ===========================================================================
# the head-sharded wrappers, bitwise against the unsharded plain version
# ===========================================================================

@pytest.mark.parametrize("case", [f"decode{i}" for i in
                                  range(len(DECODE_CASES))]
                         + [f"chunk{i}" for i in range(len(CHUNK_CASES))])
def test_wrapper_bitwise_at_tp2(run, case):
    """paged_flash_decode / batched_paged_prefill_attention (both lanes)
    with tp_mesh over 2 ranks, each holding its half of the pools' KV
    heads: the gathered output equals the unsharded call's bits."""
    want = unsharded(run.cases[case])
    got = run.ranks[0][1][case]
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want), float(np.abs(got - want).max())
