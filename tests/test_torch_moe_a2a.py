"""The port's expert-parallel MoE (models/moe_a2a.py) against the JAX
package on the CPU, at olmoe-1b-7b's smoke config (8 experts, top 2,
d_model 64) in float32 on the JAX moe_init weights and numpy-seeded
tokens (2 x 32).

moe_ffn_a2a_local runs in gloo worlds of 1, 2 and 4 processes (one spawn
each, tests/torch_moe_a2a_worker.py), each rank holding its 32 / world
tokens and 8 / world experts; the ranks meet through a FileStore under
the test's tmp_path, and each world has 120 s to join and finish, so that
a hang fails its test.  Its output and aux loss are held against the JAX
package's make_sharded_moe on a (1, world) mesh of host devices, run in a
subprocess with four forced host devices (as tests/test_moe_a2a.py runs
it), at the config's capacity factor 1.25, where the world of 4 drops
pairs (its output there parts from its output at 8, asserted), and at 8,
where nothing drops; and at 8 against the port's own moe_ffn (per-row
capacity dispatch), which then drops nothing either.  Every rank's aux
must be the same.

Bars, float32 (the frameworks sum the products in other orders): 1e-5
absolute for the outputs and the aux losses.
"""
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_moe_a2a_worker
from repro_torch.configs import get_smoke_config
from repro_torch.models import moe

F32 = 1e-5
JOIN_S = 120
FACTORS = (1.25, 8.0)
WORLDS = (1, 2, 4)
ROOT = Path(__file__).resolve().parents[1]

JAX_SIDE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import get_smoke_config
from repro.models.moe import moe_init
from repro.models.moe_a2a import make_sharded_moe

base = get_smoke_config("olmoe-1b-7b").replace(dtype="float32")
params = moe_init(jax.random.PRNGKey(0), base)
x = np.random.default_rng(0).standard_normal((2, 32, 64)).astype(np.float32)
out = dict(x=x, factors=np.array({factors}), **{{
    k: np.asarray(v) for k, v in params.items()}})
for world in {worlds}:
    mesh = Mesh(np.array(jax.devices()[:world]).reshape(1, world),
                ("data", "model"))
    for f in {factors}:
        cfg = base.replace(moe_capacity_factor=f)
        y, aux = jax.jit(make_sharded_moe(cfg, mesh))(params, jnp.asarray(x))
        out[f"y{{f}}_{{world}}"] = np.asarray(y)
        out[f"aux{{f}}_{{world}}"] = np.asarray(aux)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The inputs, and make_sharded_moe's outputs for every world and
    capacity factor, from one JAX subprocess."""
    path = tmp_path_factory.mktemp("a2a") / "jax.npz"
    code = textwrap.dedent(JAX_SIDE.format(factors=FACTORS, worlds=WORLDS))
    out = subprocess.run(
        [sys.executable, "-c", code, str(path)], capture_output=True,
        text=True, cwd=ROOT, timeout=300,
        env={"PYTHONPATH": "src",
             "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
             "JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    return path


def _run_world(world: int, tmp_path, inputs: str):
    ctx = mp.start_processes(
        torch_moe_a2a_worker.run,
        args=(world, str(tmp_path / "store"), inputs, str(tmp_path)),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_S
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"gloo world of {world} did not finish in {JOIN_S} s")
    return [dict(np.load(tmp_path / f"r{r}.npz")) for r in range(world)]


def _moe_ffn(d, factor):
    """The port's per-row capacity moe_ffn on the whole input."""
    cfg = get_smoke_config("olmoe-1b-7b").replace(
        dtype="float32", moe_capacity_factor=factor)
    params = {k: torch.from_numpy(d[k]) for k in
              ("router", "experts_in", "experts_gate", "experts_out")}
    y, aux = moe.moe_ffn(params, torch.from_numpy(d["x"]), cfg)
    return y.numpy(), float(aux)


@pytest.mark.parametrize("world", WORLDS)
def test_a2a_in_a_gloo_world_matches_jax_and_moe_ffn(world, jax_side,
                                                     tmp_path):
    d = dict(np.load(jax_side))
    outs = _run_world(world, tmp_path, str(jax_side))
    for f in FACTORS:
        y = np.concatenate([o[f"y{f}"] for o in outs], 1)
        auxes = [float(o[f"aux{f}"]) for o in outs]
        assert y.shape == (2, 32, 64) and len(set(auxes)) == 1, auxes
        np.testing.assert_allclose(y, d[f"y{f}_{world}"], rtol=0, atol=F32,
                                   err_msg=f"factor {f}")
        assert abs(auxes[0] - float(d[f"aux{f}_{world}"])) <= F32
        if f == 8.0:
            want, aux = _moe_ffn(d, f)
            np.testing.assert_allclose(y, want, rtol=0, atol=F32)
            assert abs(auxes[0] - aux) <= F32
    if world == 4:
        assert np.abs(d["y1.25_4"] - d["y8.0_4"]).max() > 100 * F32
