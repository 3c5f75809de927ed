"""Tensor-parallel paged serving (ROADMAP M10) of the port beyond granite:
the gemma3-4b smoke config (sliding window 32 on two of every three
layers, 4 query / 2 KV heads) at tp 2 and the olmoe-1b-7b smoke config
(MoE, 4 query / 4 KV heads: G 1) at tp 2 and 4, each serving the mixed
conformance trace against its own tp 1 run and the JAX package's tp 1
engine; the head-sharded wrappers at tp 4; the serve mesh in a world of 4,
where ranks 2 and 3 lie outside a tp 2 group.

Two gloo worlds (tests/torch_tp_worker.py): 2 ranks for the tp 2 jobs and
4 for the tp 4 ones, spawned one after the other from the module fixture
while it replays the tp 1 runs in this process; each has
tests/test_torch_tp.py's JOIN_S seconds.  The weights are the JAX
Model.init trees in float32, saved once and converted in every rank.  The
bars are test_torch_tp.py's: tp N equals tp 1 bit for bit, every rank
equals rank 0, the device-independent counts equal the JAX engine's and
its outputs are greedy-equal, the wrappers' gathered outputs equal the
unsharded plain version's bits.
"""
import copy
import json
import os
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest

import torch_tp_worker as W
from conformance import TRACES
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import ServeConfig as JaxServeConfig
from repro.models import build_model as jax_build_model
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.configs import ServeConfig, get_smoke_config
from repro_torch.models import build_model
from repro_torch.serve import ServeEngine
from test_torch_tp import (CHUNK_CASES, DECODE_CASES, _kw, _prompts,
                           assert_shard_accounting, join_world,
                           kernel_cases, same_but_degree, spawn_world,
                           unsharded)
from torch_replay import one_torch_thread
from traffic import assert_greedy_equivalent

ARCHS = ("gemma3-4b", "olmoe-1b-7b")
# (arch, tp) of each engine job, all on the mixed trace
RUNS = [("gemma3-4b", 2), ("olmoe-1b-7b", 2), ("olmoe-1b-7b", 4)]


_threads = pytest.fixture(scope="module", autouse=True)(one_torch_thread)


def _job(arch, tp, items):
    return {"name": f"{arch}/tp{tp}", "kind": "engine", "arch": arch,
            "scfg": _kw("mixed", False, tp_degree=tp), "items": items}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_models")
    params, jax_models, items = {}, {}, {}
    for arch in ARCHS:
        jcfg = jax_smoke_config(arch).replace(dtype="float32")
        jm = jax_build_model(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        jax_models[arch] = (jm, jp)
        params[arch] = str(root / f"{arch}.npz")
        W.save_params(params[arch], jax.device_get(jp))
        items[arch] = [W.item_dict(i)
                       for i in TRACES["mixed"].build(jcfg.vocab_size)]
    cases = kernel_cases(4)
    dirs = {w: str(root / f"world{w}") for w in (2, 4)}
    for w, d in dirs.items():
        os.makedirs(d)
        jobs = [_job(a, tp, items[a]) for a, tp in RUNS if tp == w]
        if w == 4:
            kin = os.path.join(d, "kernels.npz")
            np.savez(kin, **{f"{c}.{k}": v for c, a in cases.items()
                             for k, v in a.items()})
            jobs = [{"name": "mesh", "kind": "mesh", "degrees": [2, 4, 5]}] \
                + jobs + [{"name": "kernels", "kind": "kernels", "tp": 4,
                           "inputs": kin, "cases": sorted(cases)}]
        with open(os.path.join(d, "jobs.json"), "w") as f:
            json.dump({"params": params, "jobs": jobs}, f)

    t0 = time.monotonic()
    ctx = spawn_world(2, dirs[2])
    port1, jax1 = {}, {}
    for arch in ARCHS:
        tcfg = get_smoke_config(arch).replace(dtype="float32")
        tm = build_model(tcfg, device="cpu")
        tp = W.load_params(params[arch], tcfg)
        jm, jp = jax_models[arch]
        kw = _kw("mixed", False)
        port1[arch] = W.engine_summary(W.replay(
            ServeEngine(tm, tp, ServeConfig(**kw)), items[arch]))
        jax1[arch] = W.engine_summary(W.replay(
            JaxServeEngine(jm, jp, JaxServeConfig(**kw)), items[arch]))
    ranks = {2: join_world(ctx, 2, dirs[2], t0)}
    t0 = time.monotonic()
    ranks[4] = join_world(spawn_world(4, dirs[4]), 4, dirs[4], t0)
    return SimpleNamespace(ranks=ranks, port1=port1, jax1=jax1, cases=cases,
                           items=items, jax_models=jax_models)


@pytest.mark.parametrize("arch,tp", RUNS)
def test_model_tp_bit_equal_to_tp1(run, arch, tp):
    """The mixed trace at tp N: outputs, launch records, work clock and
    every count equal the port's tp 1 run exactly, on every rank; the
    shard accounting holds; each rank holds 1 / N of the pools."""
    name = f"{arch}/tp{tp}"
    res = [copy.deepcopy(r[0][name]) for r in run.ranks[tp]]
    for rank, other in enumerate(res):
        assert other["tp_stats"].pop("rank") == rank
        assert other == res[0], rank
    got = run.ranks[tp][0][0][name]
    same_but_degree(got, run.port1[arch], tp)
    assert_shard_accounting(got["tp_stats"])


@pytest.mark.parametrize("arch", ARCHS)
def test_model_tp_matches_jax(run, arch):
    """Against the JAX tp 1 engine: launch records, work clock, pages read
    and the tick log equal, the outputs greedy-equal (the teacher-forced
    near-tie check on the JAX model)."""
    got, want = run.ranks[2][0][0][f"{arch}/tp2"], run.jax1[arch]
    for key in ("records", "log", "work_clock", "tick_log", "gen_tokens",
                "kv_pages_read", "requests"):
        assert got[key] == want[key], key
    if got["outputs"] != want["outputs"]:
        jm, jp = run.jax_models[arch]
        prompts = _prompts(run.items[arch])
        done = [SimpleNamespace(uid=u, prompt=prompts[u], out_tokens=o)
                for u, o in got["outputs"].items()]
        assert_greedy_equivalent(jm, jp, done, want["outputs"])


def test_serve_mesh_in_a_world_of_four(run):
    """A tp 2 group in a world of 4: ranks 0 and 1 get their mesh, ranks 2
    and 3 a ValueError naming their rank; tp 4 spans the world; tp 5 is
    refused by the world's size."""
    for rank, (res, _) in enumerate(run.ranks[4]):
        got = res["mesh"]
        if rank < 2:
            assert got["2"] == [rank, 2]
        else:
            assert f"rank {rank} is outside the tp_degree=2" in got["2"]
        assert got["4"] == [rank, 4]
        assert "world size of at least 5" in got["5"]


@pytest.mark.parametrize("case", [f"decode{i}" for i in
                                  range(len(DECODE_CASES))]
                         + [f"chunk{i}" for i in range(len(CHUNK_CASES))])
def test_wrapper_bitwise_at_tp4(run, case):
    """The wrapper cases at tp 4 (each rank a quarter of the KV heads):
    the gathered output equals the unsharded plain version's bits on
    every rank."""
    want = unsharded(run.cases[case])
    for rank, (_, arrays) in enumerate(run.ranks[4]):
        got = arrays[case]
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want), \
            (rank, float(np.abs(got - want).max()))
