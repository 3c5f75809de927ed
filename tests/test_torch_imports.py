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
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), **extra_env)
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    res = _run(_CHECK)
    assert res.returncode == 0, res.stderr
    n, bad = res.stdout.strip().split(" ", 1)
    assert int(n) >= 20, res.stdout
    assert bad == "[]", f"repro_torch pulled in {bad}"


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


def test_params_from_numpy_without_a_device_raises_on_a_cpu_only_machine():
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    import numpy as np
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.convert import params_from_numpy
    cfg = get_smoke_config("granite-3-2b").replace(dtype="float32")
    tree = {"tok": {"embed": np.zeros((4, 4), np.float32)}}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy(tree, cfg)
    got = params_from_numpy(tree, cfg, device="cpu")
    assert got["tok"]["embed"].device.type == "cpu"
