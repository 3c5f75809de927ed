"""launch/cost.py, the port's counterpart of the JAX package's
launch/hlo_cost.py (mirroring tests/test_hlo_cost.py), on the CPU.

- StepCost counts one matmul's FLOPs exactly, a loop of L layers L times
  (eager PyTorch runs every iteration: no trip count to recover) and a
  backward as the forward dot plus its two transposed dots.
- each kernel wrapper's meta path (K1-K7) reports its formula, and the
  formulas reproduce PERF.md §6's bound ms column (H100 SXM data sheet:
  989e12 FLOP/s dense bf16, 3.35e12 B/s), within its 3 or 4 digits.
- the collectives of one call of a mesh step run in a gloo world of four
  (tests/torch_mesh_worker.py "cell" jobs with "count") equal, kind by
  kind, calls and bytes, the same cell's step traced on the meta device
  in a fake-backend world of four.
- a dense smoke train_cell on a (1, 1) mesh: its dot FLOPs outside the
  kernels equal a closed form of its config exactly, and its FLOPs sit
  beside the JAX hlo_cost.analyze corrected FLOPs of the JAX train_cell
  within the attention's share (see the test).
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch.kernels import (flash_attention, flash_backward,
                                 flash_decode, mamba2_scan, paged_prefill,
                                 rwkv6_scan)
from repro_torch.launch import cost

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEAK_FLOP_S, PEAK_BYTES_S = 989e12, 3.35e12
SUB_S = 240


def _counted(fn):
    with cost.StepCost() as sc:
        fn()
    return sc.summary()


def test_single_matmul_flops_exact():
    a, b = torch.ones(64, 128), torch.ones(128, 256)
    assert _counted(lambda: a @ b)["flops"] == 2 * 64 * 128 * 256


@pytest.mark.parametrize("L", [1, 3, 8])
def test_a_loop_of_layers_counts_each_layer(L):
    x, w = torch.ones(64, 64), torch.ones(L, 64, 64)

    def layers():
        y = x
        for i in range(L):
            y = y @ w[i]
    assert _counted(layers)["flops"] == L * 2 * 64 ** 3


def test_backward_counts_the_forward_and_the_backward_dots():
    a = torch.ones(32, 64, requires_grad=True)
    b = torch.ones(64, 16, requires_grad=True)

    def step():
        torch.sum((a @ b) ** 2).backward()
    # the forward dot and its two transposes, as the JAX analyzer counts
    assert _counted(step)["flops"] == 3 * 2 * 32 * 64 * 16


def test_results_bytes_and_transcendentals():
    x = torch.ones(10, 20)
    s = _counted(lambda: torch.exp(x).sum())
    assert s["transcendentals"] == 200
    assert s["bytes_accessed"] == 200 * 4 + 4        # exp's result, the sum
    assert s["peak_live_bytes"] >= 200 * 4


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _i32(*shape):
    return _meta(*shape, dtype=torch.int32)


# (kernel, call on meta tensors, formula of the same call)
KERNEL_CASES = {
    "K1": (lambda: paged_prefill.batched_paged_prefill_attention(
        _meta(4, 256, 16, 64), _meta(300, 16, 4, 64), _meta(300, 16, 4, 64),
        _i32(4, 64), _i32(4), _i32(4), _i32(4)),
           lambda: cost.k1_work((4, 256, 16, 64), 4, 2,
                                *cost.chunk_rows_work([(768, 1024)] * 4, 0))),
    "K2": (lambda: flash_decode.paged_flash_decode(
        _meta(8, 1, 16, 64), _meta(300, 16, 4, 64), _meta(300, 16, 4, 64),
        _i32(8, 64), _i32(8), window=100),
           lambda: cost.decode_work((8, 1, 16, 64), 4, 2, 8 * 100)),
    "K3": (lambda: flash_decode.flash_decode(
        _meta(8, 1, 16, 64), _meta(8, 512, 4, 64), _meta(8, 512, 4, 64),
        _i32(8)),
           lambda: cost.decode_work((8, 1, 16, 64), 4, 2, 8 * 512)),
    "K4": (lambda: flash_attention.flash_attention_fwd(
        _meta(2, 300, 8, 128), _meta(2, 300, 2, 128), _meta(2, 300, 2, 128),
        causal=True, window=64),
           lambda: cost.k4_work((2, 300, 8, 128), (2, 300, 2, 128), 2, True,
                                64)),
    "K5": (lambda: flash_backward.flash_attention_bwd(
        _meta(2, 300, 8, 128), _meta(2, 300, 2, 128), _meta(2, 300, 2, 128),
        _meta(2, 300, 8, 128), _meta(2, 300, 8, dtype=torch.float32),
        _meta(2, 300, 8, 128)),
           lambda: cost.k5_work((2, 300, 8, 128), (2, 300, 2, 128), 2, True,
                                0)),
    "K6": (lambda: mamba2_scan.mamba2_scan(
        _meta(2, 300, 4, 64), _meta(2, 300, 4, dtype=torch.float32),
        _meta(4, dtype=torch.float32), _meta(2, 300, 64), _meta(2, 300, 64)),
           lambda: cost.k6_work((2, 300, 4, 64), 64, 2)),
    "K7": (lambda: rwkv6_scan.rwkv6_scan(
        _meta(2, 300, 4, 64), _meta(2, 300, 4, 64), _meta(2, 300, 4, 64),
        _meta(2, 300, 4, 64, dtype=torch.float32),
        _meta(4, 64, dtype=torch.float32)),
           lambda: cost.k7_work((2, 300, 4, 64), 64, 2)),
}


@pytest.mark.parametrize("name", sorted(KERNEL_CASES))
def test_each_kernels_meta_path_reports_its_formula(name):
    call, formula = KERNEL_CASES[name]
    launched = {m: getattr(m, a) for m, a in (
        (paged_prefill, "launches"), (flash_decode, "launches"),
        (flash_decode, "dense_launches"), (flash_attention, "launches"),
        (flash_backward, "launches"), (mamba2_scan, "launches"),
        (rwkv6_scan, "launches"))}
    with cost.StepCost() as sc:
        out = call()
    nbytes, flops = formula()
    got = sc.summary()["kernels"]
    assert got == {name: {"calls": 1, "flops": flops, "bytes": nbytes}}
    assert sc.flops == flops and flops > 0
    for t in (out if isinstance(out, tuple) else (out,)):
        assert t.device.type == "meta"
    # a meta call launches nothing
    for (m, a), n in zip(((paged_prefill, "launches"),
                          (flash_decode, "launches"),
                          (flash_decode, "dense_launches"),
                          (flash_attention, "launches"),
                          (flash_backward, "launches"),
                          (mamba2_scan, "launches"),
                          (rwkv6_scan, "launches")), launched.values()):
        assert getattr(m, a) == n


def test_a_kernel_refuses_on_the_meta_path_what_it_refuses_on_cuda():
    with pytest.raises(ValueError, match="head dim 48 not supported"):
        flash_attention.flash_attention_fwd(
            _meta(1, 8, 2, 48), _meta(1, 8, 2, 48), _meta(1, 8, 2, 48))


# PERF.md §6 rows: (formula, bound ms as printed, bound by)
BOUNDS = [
    # K4 at the training shape: 6.87e10 FLOPs, 0.0695 ms at 989 TFLOP/s
    (lambda: cost.k4_work((4, 2048, 16, 128), (4, 2048, 16, 128), 2, True,
                          0), 0.0695, "operations"),
    (lambda: cost.k4_work((1, 2048, 32, 128), (1, 2048, 8, 128), 2, True,
                          0), 0.0348, "operations"),
    (lambda: cost.k4_work((1, 1904, 8, 256), (1, 1904, 4, 256), 2, True,
                          1024), 0.0118, "operations"),
    (lambda: cost.k4_work((16, 4, 8, 64), (16, 1500, 8, 64), 2, False, 0),
     0.0147, "bytes"),
    (lambda: cost.k4_work((2, 2048, 16, 64), (2, 2048, 4, 64), 2, True, 0),
     0.0174, "operations"),
    (lambda: cost.k5_work((4, 2048, 16, 128), (4, 2048, 16, 128), 2, True,
                          0), 0.1738, "operations"),
    (lambda: cost.k5_work((2, 2048, 56, 128), (2, 2048, 8, 128), 2, True,
                          0), 0.3041, "operations"),
    (lambda: cost.k5_work((2, 2048, 16, 64), (2, 2048, 4, 64), 2, True, 0),
     0.0434, "operations"),
    # K5 at zamba2's shared block (head dim 80), the scans' backward
    # kernels at zamba2's and rwkv6's training calls
    (lambda: cost.k5_work((4, 2048, 32, 80), (4, 2048, 32, 80), 2, True,
                          0), 0.2172, "operations"),
    (lambda: cost.k6_bwd_work((4, 2048, 80, 64), 64, 2), 0.0779, "bytes"),
    (lambda: cost.k7_bwd_work((4, 2048, 32, 64), 64, 2), 0.1102, "bytes"),
]


@pytest.mark.parametrize("case", range(len(BOUNDS)))
def test_formulas_reproduce_the_bound_column(case):
    formula, ms, by = BOUNDS[case]
    nbytes, flops = formula()
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FLOP_S
    got = max(t_bytes, t_ops) * 1e3
    assert ("bytes" if t_bytes >= t_ops else "operations") == by
    assert abs(got - ms) <= 0.5 * 10 ** (np.floor(np.log10(ms)) - 2), got
    if case == 0:                     # 6.875e10, printed as 6.87e10
        assert int(flops // 1e8) == 687


_FAKE = r"""
import json, sys, torch
from repro_torch.configs import TrainConfig, get_smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_debug_mesh
spec = json.loads(sys.argv[1])
out = {}
for name, (mesh, kind, B, S) in spec["cells"].items():
    dryrun.fake_world(mesh[0] * mesh[1])
    m = make_debug_mesh(*mesh, device_type="cpu")
    cfg = get_smoke_config(spec["arch"]).replace(**spec["replace"])
    out[name] = dryrun.run_cell(spec["arch"], name, False, cfg=cfg,
                                shape=ShapeSpec(name, S, B, kind), mesh=m)
json.dump(out, open(spec["out"], "w"))
"""

_JAX_FLOPS = r"""
import json, sys
import jax
from repro.compat import make_mesh, use_mesh
from repro.configs import get_smoke_config
from repro.configs.base import ShapeSpec, TrainConfig
from repro.launch.hlo_cost import analyze
from repro.launch.specs import train_cell
spec = json.loads(sys.argv[1])
cfg = get_smoke_config(spec["arch"]).replace(**spec["replace"])
mesh = make_mesh((1, 1), ("data", "model"))
B, S = spec["shape"]
with use_mesh(mesh):
    tcfg = TrainConfig(global_batch=B, seq_len=S, remat="full")
    step, args, sh = train_cell(cfg, ShapeSpec("t", S, B, "train"), mesh,
                                tcfg)
    hlo = jax.jit(step, in_shardings=sh).lower(*args).compile().as_text()
json.dump(analyze(hlo), open(spec["out"], "w"))
"""

ARCH = "granite-3-2b"
# float32, and the smoke head dim 16 raised to 64, a head dim the kernels'
# meta paths take (as the training CLI's --smoke does on the card)
REPLACE = {"dtype": "float32", "head_dim": 64}
TRAIN = (4, 32)                        # (B, S) of the (1, 1) train cell
COUNTED = {"decode": ((2, 2), "decode", 4, 32),
           "prefill": ((1, 4), "prefill", 4, 32)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The gloo world of four counting the two cells' first calls, the
    fake-backend subprocess tracing the same cells (and the (1, 1) train
    cell), and the JAX subprocess: started together."""
    import jax
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models import build_model as jax_build_model
    d = str(tmp_path_factory.mktemp("cost"))
    cfg = jax_smoke_config(ARCH).replace(**REPLACE)
    jm = jax_build_model(cfg)
    jp = jax.device_get(jm.init(jax.random.PRNGKey(0)))

    def flat(tree, pre=""):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{pre}{k}/") if isinstance(v, dict)
                       else {pre + k: np.asarray(v)})
        return out
    np.savez(os.path.join(d, "params.npz"), **flat(jp))
    rng = np.random.default_rng(5)
    L, Hkv, D = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    jobs = []
    for name, (mesh, kind, B, S) in COUNTED.items():
        inp = {f"cache.{n}": rng.standard_normal(
            (L, B, S, Hkv, D)).astype(np.float32) for n in ("k", "v")}
        if kind == "prefill":
            inp["tokens"] = rng.integers(0, 256, (B, S), dtype=np.int32)
        else:
            inp["tokens.0"] = rng.integers(0, 256, (B, 1), dtype=np.int32)
            inp["lens.0"] = np.full((B,), 9, np.int32)
        np.savez(os.path.join(d, f"{name}.npz"), **inp)
        jobs.append({"name": name, "kind": "cell", "cell": kind,
                     "arch": ARCH, "replace": REPLACE, "mesh": list(mesh),
                     "shape": [B, S], "steps": 1, "count": True,
                     "params": os.path.join(d, "params.npz"),
                     "inputs": os.path.join(d, f"{name}.npz")})
    with open(os.path.join(d, "jobs.json"), "w") as f:
        json.dump({"jobs": jobs}, f)
    env = dict(os.environ, PYTHONPATH=f"{ROOT}/src:{ROOT}/tests")
    procs = {f"rank{r}": subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "torch_mesh_worker.py"),
         str(r), "4", os.path.join(d, "store"), os.path.join(d, "jobs.json"),
         d], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(4)}
    cells = dict({k: list(v) for k, v in COUNTED.items()},
                 train=[(1, 1), "train", *TRAIN])
    procs["fake"] = subprocess.Popen(
        [sys.executable, "-c", _FAKE, json.dumps(
            {"arch": ARCH, "cells": cells, "replace": REPLACE,
             "out": os.path.join(d, "fake.json")})],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    procs["jax"] = subprocess.Popen(
        [sys.executable, "-c", _JAX_FLOPS, json.dumps(
            {"arch": ARCH, "shape": list(TRAIN), "replace": REPLACE,
             "out": os.path.join(d, "jax.json")})],
        env=dict(env, JAX_PLATFORMS="cpu"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
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
    out = {"ranks": []}
    for r in range(4):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            out["ranks"].append(json.load(f))
    for side in ("fake", "jax"):
        with open(os.path.join(d, f"{side}.json")) as f:
            out[side] = json.load(f)
    out["cfg"] = cfg
    return out


@pytest.mark.parametrize("name", sorted(COUNTED))
def test_gloo_collectives_equal_the_fake_backends_count(runs, name):
    want = runs["fake"][name]["collectives"]
    want = {k: v for k, v in want.items() if k != "total_bytes"}
    assert want, "the cell makes collectives"
    for js in runs["ranks"]:
        assert js[name]["collectives"] == want


def _closed_form_train_flops(cfg, B, S):
    """Dot FLOPs of one remat="full" train step of a dense decoder,
    outside the attention kernels: the q / k / v / o projections and the
    gated MLP, 2 x tokens x (d Hq D + 2 d Hkv D + Hq D d + 3 d d_ff) a
    layer, run four times (forward, the recompute in the backward, and
    the two transposed dots of the backward) less the recompute of the
    MLP's down projection, 2 x tokens x d_ff x d: torch's checkpoint
    stops recomputing once it has every tensor the backward saved, and
    the block's last dot saves only its inputs; the tied unembed, 2 x
    tokens x d x V, three times (outside the checkpointed layers)."""
    d, Hq, Hkv, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    T = B * S
    layer = 2 * T * (d * Hq * D + 2 * d * Hkv * D + Hq * D * d
                     + 3 * d * cfg.d_ff)
    down = 2 * T * cfg.d_ff * d
    return cfg.n_layers * (4 * layer - down) \
        + 3 * 2 * T * d * cfg.vocab_size


def test_train_cell_dot_flops_equal_the_closed_form(runs):
    rec = runs["fake"]["train"]
    kernels = sum(k["flops"] for k in rec["kernels"].values())
    assert set(rec["kernels"]) == {"K4", "K5"}
    assert rec["cost"]["flops"] - kernels == \
        _closed_form_train_flops(runs["cfg"], *TRAIN)


def test_train_cell_flops_sit_beside_the_jax_analysis(runs):
    """The JAX train step on the CPU attends through its jnp reference
    (repro/kernels/ops.py, keys in blocks of 512, so S = 32 is padded to
    512): eight full-block dots a layer, each 2 B Hq S 512 D FLOPs - the
    forward's scores and weighted values, both again in the remat
    recompute, and the backward's dp, dq, dk and dv (its compiled HLO).
    Every other dot is the port's, one for one: the JAX count equals the
    port's dots outside K4 / K5 plus those eight, exactly.  The port
    counts K4 and K5 by their formulas over the causal pairs instead, so
    its total is the smaller."""
    rec = runs["fake"]["train"]
    cfg = runs["cfg"]
    B, S = TRAIN
    padded = -(-S // 512) * 512
    jax_flops = runs["jax"]["flops"]
    kernels = sum(k["flops"] for k in rec["kernels"].values())
    outside = rec["cost"]["flops"] - kernels
    attention = cfg.n_layers * 8 * 2 * B * cfg.n_heads * S * padded \
        * cfg.head_dim
    assert jax_flops == outside + attention, (jax_flops, outside, attention)
    assert 0 < kernels < attention
