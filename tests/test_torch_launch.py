"""The port's serve CLI and its three examples on the CPU, each in a
subprocess of its own (--device cpu, smoke configs, a few steps).

- python -m repro_torch.launch.serve prints the very line the JAX
  package's repro.launch.serve prints for the same flags (dense and
  paged): the same request and token counts and KV cache bytes.
- examples/torch_quickstart.py, torch_train_lm.py and torch_serve_lm.py
  print the lines of examples/quickstart.py, train_lm.py and serve_lm.py,
  in their form (the numbers are the run's), and the training examples
  resume from their checkpoints when run again.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from repro.launch import serve as jax_serve

REPO = Path(__file__).resolve().parents[1]


def _run(args, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=timeout)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    return res.stdout.strip().splitlines()


@pytest.mark.parametrize("flags", [["--arch", "granite-3-2b"],
                                   ["--arch", "gemma3-4b", "--paged",
                                    "--page-size", "16", "--num-pages",
                                    "64", "--requests", "6"]],
                         ids=["dense", "paged"])
def test_serve_cli_prints_the_jax_line(flags, capsys):
    got = _run(["-m", "repro_torch.launch.serve", *flags, "--device",
                "cpu"])[-1]
    jax_serve.main(flags)
    want = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.fullmatch(r"served \d+ requests, \d+ tokens \[.* KV cache, "
                        r"[\d.]+ MB\]", got), got
    assert got == want


def test_quickstart_trains_then_serves(tmp_path):
    args = ["examples/torch_quickstart.py", "--steps", "6", "--device",
            "cpu", "--ckpt-dir", str(tmp_path)]
    out = _run(args)
    assert re.fullmatch(r"== granite-3-2b-smoke: [\d.]+M params \(dense\) "
                        r"==", out[0]), out[0]
    steps = [re.fullmatch(r"  step +(\d+)  loss ([\d.]+)  lr [\d.e+-]+  "
                          r"\d+ ms", line) for line in out[1:3]]
    assert all(steps), out[1:3]
    assert [int(m.group(1)) for m in steps] == [0, 5]
    assert float(steps[1].group(2)) < float(steps[0].group(2))
    for uid, line in zip((1, 2), out[3:5]):
        assert re.fullmatch(rf"  request {uid}: generated \[[\d, ]+\]",
                            line), line
    assert _run(args)[0] == out[0]          # resumes from its checkpoint


def test_train_lm_runs_and_resumes(tmp_path):
    args = ["examples/torch_train_lm.py", "--steps", "6", "--batch", "4",
            "--seq", "32", "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    out = _run(args)
    assert re.fullmatch(r"olmo-1b-smoke: [\d.]+M params", out[0]), out[0]
    for line in out[1:-1]:
        assert re.fullmatch(r"step +\d+  loss [\d.]+  grad_norm [\d.]+  "
                            r"\d+ ms", line), line
    assert out[-1] == "done at step 5; straggler events: 0"
    again = _run([*args[:2], "8", *args[3:]])
    assert "resumed from checkpoint at step 6" in again
    assert again[-1] == "done at step 7; straggler events: 0"


@pytest.mark.parametrize("mode", ["dense", "chunked"])
def test_serve_lm_serves(mode):
    out = _run(["examples/torch_serve_lm.py", "--requests", "5",
                "--max-new", "6", "--device", "cpu", f"--{mode}"])
    kv = r"dense KV: [\d.]+ MB" if mode == "dense" else \
        r"paged KV: [\d.]+ MB, peak \d+ pages"
    sched = "monolithic" if mode == "dense" else "chunked"
    assert re.fullmatch(
        rf"served 5 requests, 30 tokens in [\d.]+s \([\d.]+ tok/s, "
        rf"continuous batching over 4 slots, {sched} prefill, {kv}\)",
        out[0]), out[0]
    reqs = [line for line in out if line.startswith("  req ")]
    assert len(reqs) == 4 and all(
        re.fullmatch(r"  req \d+: \[[\d, ]+\]", r) for r in reqs)
