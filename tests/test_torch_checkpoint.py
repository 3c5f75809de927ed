"""The port's checkpoints and Trainer against the JAX package's.

A checkpoint written by either package restores in the other with the
same bits (bfloat16 params, float32 m / v / ef, the int32 step), and both
packages write the same keys, dtype tags and digest for the same state.
Retention, skipping a corrupt checkpoint, and the crash-and-resume of
tests/test_checkpoint.py run on the port's Trainer.  Then a JAX Trainer
runs three steps, the port's Trainer resumes from its checkpoint
directory, and its losses match the JAX Trainer's own continuation
(float32: 1e-5 relative; the batches are seeded per process, and both
trainers run in this one).
"""
import json
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.models import build_model as jax_build_model
from repro.train import init_train_state as j_init_train_state
from repro.train.checkpoint import restore_checkpoint as j_restore
from repro.train.checkpoint import save_checkpoint as j_save
from repro.train.trainer import Trainer as JaxTrainer
from repro_torch.configs import TrainConfig, get_smoke_config
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.models.convert import train_state_from_numpy
from repro_torch.train import init_train_state
from repro_torch.train.checkpoint import (all_checkpoints, latest_checkpoint,
                                          restore_checkpoint, restore_latest,
                                          save_checkpoint)
from repro_torch.train.trainer import Trainer
from repro_torch.tree import leaves_with_paths

TCFG = dict(global_batch=2, seq_len=32, grad_compression="int8")


def _jax_state(seed):
    jcfg = jax_smoke_config("granite-3-2b")
    jm = jax_build_model(jcfg)
    return jm, j_init_train_state(jm, jax.random.PRNGKey(seed),
                                  JaxTrainConfig(**TCFG))


def _port_state(seed):
    cfg = get_smoke_config("granite-3-2b")
    return init_train_state(build_model(cfg, device="cpu"), seed,
                            TrainConfig(**TCFG))


def _bits(x):
    """A leaf's raw bits as numpy (bfloat16 as uint16), for exact checks."""
    if torch.is_tensor(x):
        x = x.detach()
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 \
            else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def _assert_same_bits(port_state, jax_state):
    want = dict(leaves_with_paths(jax.device_get(jax_state)))
    got = dict(leaves_with_paths(port_state))
    assert sorted(got) == sorted(want) and len(got) == 45
    for path, t in got.items():
        np.testing.assert_array_equal(_bits(t), _bits(want[path]),
                                      err_msg=path)


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    _, jstate = _jax_state(0)
    j_save(str(tmp_path), 4, jstate)
    state = _port_state(1)                   # other values, same structure
    restored, step = restore_checkpoint(str(tmp_path), 4, state)
    assert step == 4 and restored is state
    _assert_same_bits(restored, jstate)
    assert restored.params["tok"]["embed"].requires_grad


def test_port_checkpoint_restores_in_jax(tmp_path):
    jm, jstate = _jax_state(0)
    host = jax.device_get(jstate)
    cfg = get_smoke_config("granite-3-2b")
    state = train_state_from_numpy(host.params, host.opt, host.ef, cfg,
                                   "cpu")
    save_checkpoint(str(tmp_path / "port"), 4, state)
    template = jax.eval_shape(lambda: j_init_train_state(
        jm, jax.random.PRNGKey(1), JaxTrainConfig(**TCFG)))
    restored, step = j_restore(str(tmp_path / "port"), 4, template)
    assert step == 4
    _assert_same_bits(state, restored)
    # the same state written by both packages: same keys, tags and digest
    j_save(str(tmp_path / "jax"), 4, jstate)
    mp, mj = (json.loads((tmp_path / d / "step_4" / "manifest.json")
                         .read_text()) for d in ("port", "jax"))
    for key in ("step", "digest", "dtypes", "n_arrays"):
        assert mp[key] == mj[key], key
    with np.load(tmp_path / "port" / "step_4" / "arrays.npz") as zp, \
            np.load(tmp_path / "jax" / "step_4" / "arrays.npz") as zj:
        assert sorted(zp.files) == sorted(zj.files)
        for k in zp.files:
            assert zp[k].dtype == zj[k].dtype, k


def test_retention_and_latest(tmp_path):
    state = {"a": torch.zeros(4)}
    for s in range(6):
        save_checkpoint(str(tmp_path), s, state, keep=3)
    assert all_checkpoints(str(tmp_path)) == [3, 4, 5]
    assert latest_checkpoint(str(tmp_path)) == 5
    assert latest_checkpoint(str(tmp_path / "none")) is None


def test_corrupt_checkpoint_skipped(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"a": torch.arange(4.0)})
    save_checkpoint(str(tmp_path), 2, {"a": torch.arange(4.0) + 10})
    (tmp_path / "step_2" / "arrays.npz").write_bytes(b"garbage")
    template = {"a": torch.zeros(4)}
    restored = restore_latest(str(tmp_path), template)
    assert restored is not None and restored[1] == 1
    assert torch.equal(template["a"], torch.arange(4.0))
    with pytest.raises(IOError, match="the state wants"):
        restore_checkpoint(str(tmp_path), 1, {"a": torch.zeros(5)})


def test_crash_resume_end_to_end(tmp_path):
    cfg = get_smoke_config("granite-3-2b")
    tcfg = TrainConfig(global_batch=2, seq_len=32, total_steps=8,
                       warmup_steps=1, checkpoint_every=3,
                       checkpoint_dir=str(tmp_path), log_every=2)
    tr = Trainer(cfg, tcfg, device="cpu", fail_at_step=5)
    with pytest.raises(RuntimeError):
        tr.run()
    tr2 = Trainer(cfg, tcfg, device="cpu")
    assert tr2.start_step == 3                 # resumed from step_2
    out = tr2.run()
    assert out["final_step"] == 7
    assert [m["step"] for m in out["metrics"]] == [4, 6, 7]
    assert all(np.isfinite(m["loss"]) and m["step_time_s"] >= 0
               for m in out["metrics"])


def test_port_trainer_resumes_a_jax_run(tmp_path):
    jcfg = jax_smoke_config("granite-3-2b").replace(dtype="float32")
    cfg = get_smoke_config("granite-3-2b").replace(dtype="float32")
    kw = dict(global_batch=2, seq_len=32, total_steps=6, warmup_steps=1,
              checkpoint_every=3, log_every=1)
    JaxTrainer(jcfg, JaxTrainConfig(checkpoint_dir=str(tmp_path / "jax"),
                                    **kw)).run(n_steps=3)
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    jtr = JaxTrainer(jcfg, JaxTrainConfig(checkpoint_dir=str(tmp_path / "jax"),
                                          **kw))
    tr = Trainer(cfg, TrainConfig(checkpoint_dir=str(tmp_path / "port"),
                                  **kw), device="cpu")
    assert tr.start_step == jtr.start_step == 3
    want, got = jtr.run()["metrics"], tr.run()["metrics"]
    assert [m["step"] for m in got] == [m["step"] for m in want] == [3, 4, 5]
    for g, w in zip(got, want):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)


def test_launch_trains_the_smoke_config(tmp_path, capsys):
    launch_train.main(["--arch", "granite-3-2b", "--smoke", "--steps", "2",
                       "--seq", "16", "--global-batch", "2", "--device",
                       "cpu", "--ckpt-dir", str(tmp_path)])
    assert "finished at step 1" in capsys.readouterr().out
    assert all_checkpoints(str(tmp_path)) == [1]
    # --multi-pod builds the (2, 16, 16) production mesh, which needs a
    # world of 512 ranks: without one it raises, saying how to launch
    with pytest.raises(ValueError, match="torchrun"):
        launch_train.main(["--arch", "granite-3-2b", "--multi-pod",
                           "--device", "cpu"])
