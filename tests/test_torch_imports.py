"""Import hygiene of the PyTorch port: repro_torch imports torch, numpy and
the standard library only - never jax and nothing of the JAX package - and
its entry points refuse to run on the CPU unless asked to."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

_CHECK = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "repro."))
             or m == "repro")
print(len(names), bad)
"""


def _run(code: str, **extra_env):
    env = dict(os.environ, PYTHONPATH=f"{REPO / 'src'}:{REPO / 'tests'}",
               **extra_env)
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    res = _run(_CHECK)
    assert res.returncode == 0, res.stderr
    n, bad = res.stdout.strip().split(" ", 1)
    assert int(n) >= 20, res.stdout
    assert bad == "[]", f"repro_torch pulled in {bad}"


@pytest.mark.parametrize("module", ["repro_torch.core.energy",
                                    "repro_torch.serve.telemetry",
                                    "repro_torch.serve.router",
                                    "repro_torch.configs.whisper_base",
                                    "repro_torch.kernels.ops",
                                    "repro_torch.models.transformer",
                                    "repro_torch.launch.mesh",
                                    "torch_tp_worker",
                                    "repro_torch.sharding.rules",
                                    "repro_torch.sharding.shards",
                                    "repro_torch.launch.specs",
                                    "repro_torch.launch.serve",
                                    "repro_torch.launch.train",
                                    "torch_mesh_worker",
                                    "repro_torch.launch.cost",
                                    "repro_torch.launch.dryrun",
                                    "repro_torch.core.schedule",
                                    "repro_torch.core.hopper_mapping",
                                    "repro_torch.serve.serve_step",
                                    "repro_torch.core.arch",
                                    "repro_torch.core.workloads",
                                    "repro_torch.core.dataflows",
                                    "repro_torch.core.simulator",
                                    "repro_torch.core.thermal",
                                    "repro_torch.kernels.mamba2_scan",
                                    "repro_torch.kernels.rwkv6_scan",
                                    "repro_torch.train.train_step"])
def test_module_alone_imports_no_jax(module):
    """The modules that keep copies of the JAX package's framework-free
    code (the energy model, the tracer, the fleet router, whisper's
    config), those that hold the sequence-parallel decode, the encoder-
    decoder stacks and the serve mesh, the tensor-parallel tests' worker
    (tests/torch_tp_worker.py, the module each spawned rank runs), the
    sharding rules, the launchers and cell specs, the mesh tests'
    worker (tests/torch_mesh_worker.py), the cost counter and the dry run,
    the copy of the paper's schedule and the Hopper block chooser, the
    mesh serving steps, the copies of the paper's 3D-Flow simulator
    (arch, workloads, dataflows, simulator, thermal), and the scans'
    wrappers with their backward kernels' and the train step that runs
    them on the card import, each on its own, no jax and nothing of the
    JAX package."""
    res = _run(f"import sys, {module}\n"
               "print(sorted(m for m in sys.modules if m == 'jax' or "
               "m.startswith(('jax.', 'jaxlib', 'repro.')) "
               "or m == 'repro'))\n")
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_the_dry_run_imports_the_fake_backend_only_when_it_runs():
    """torch's fake process-group backend is a test utility: importing
    any module of the port (launch/dryrun.py among them) leaves it out."""
    res = _run(_CHECK.replace("print(len(names), bad)",
                              "print('fake_pg' in str(sorted(sys.modules)))"))
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "False"


@pytest.mark.parametrize("example", ["torch_quickstart", "torch_serve_lm",
                                     "torch_train_lm"])
def test_example_imports_no_jax(example):
    """The port's examples (examples/torch_*.py), loaded as modules
    without running main(), import no jax and nothing of the JAX
    package."""
    code = ("import importlib.util, sys\n"
            f"spec = importlib.util.spec_from_file_location('ex', "
            f"'examples/{example}.py')\n"
            "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "print(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'repro.')) or m == 'repro'))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=""),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_chip_smoke_imports_no_jax():
    code = ("import sys\n"
            "import chip_smoke\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.')) or m == 'repro']\n"
            "print(bad)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_build_model_without_a_device_raises_on_a_cpu_only_machine():
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(get_smoke_config("granite-3-2b"))
    assert build_model(get_smoke_config("granite-3-2b"),
                       device="cpu").device.type == "cpu"


def test_whisper_builds_on_the_card_unless_the_cpu_is_asked_for():
    """whisper-base at full width defaults to the card: on a machine
    without one build_model raises before allocating anything."""
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import build_model
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(get_config("whisper-base"))
    model = build_model(get_smoke_config("whisper-base"), device="cpu")
    assert model.device.type == "cpu"
    assert sorted(model.params["blocks"]) == ["decoder", "enc_norm",
                                              "encoder"]


def _smoke_tree():
    """A whole granite-3-2b smoke parameter tree (float32) as numpy arrays,
    shaped by the port's own Model - no JAX."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Model
    from repro_torch.tree import map_tree
    cfg = get_smoke_config("granite-3-2b").replace(dtype="float32")
    tree = map_tree(lambda t: t.detach().numpy().copy(),
                    Model(cfg, "cpu").params)
    return cfg, tree


def test_params_from_numpy_without_a_device_raises_on_a_cpu_only_machine():
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    from repro_torch.models.convert import params_from_numpy
    cfg, tree = _smoke_tree()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy(tree, cfg)
    got = params_from_numpy(tree, cfg, device="cpu")
    assert got["tok"]["embed"].device.type == "cpu"


@pytest.mark.parametrize("fault", ["missing leaf", "missing subtree",
                                   "leaf for a subtree", "wrong shape"])
def test_params_from_numpy_refuses_an_incomplete_or_misshapen_tree(fault):
    """A tree with a leaf or a subtree left out, a leaf in place of a
    subtree, or a leaf of another shape raises naming its path, as an
    extra key or a wrong dtype does."""
    import numpy as np
    from repro_torch.models.convert import params_from_numpy
    cfg, tree = _smoke_tree()
    if fault == "missing leaf":
        del tree["blocks"]["attn"]["wq"]
        err, where = KeyError, "/blocks/attn"
    elif fault == "missing subtree":
        del tree["final_norm"]
        err, where = KeyError, "final_norm"
    elif fault == "leaf for a subtree":
        tree["final_norm"] = np.zeros(3, np.float32)
        err, where = KeyError, "/final_norm"
    else:
        wq = tree["blocks"]["attn"]["wq"]
        tree["blocks"]["attn"]["wq"] = np.zeros(wq.shape[:-1] + (3,),
                                                np.float32)
        err, where = ValueError, "/blocks/attn/wq"
    with pytest.raises(err, match=where):
        params_from_numpy(tree, cfg, device="cpu")
