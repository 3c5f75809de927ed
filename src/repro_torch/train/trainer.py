"""Fault-tolerant trainer: checkpoint/restart, straggler watchdog, metrics -
the JAX package's train/trainer.py on one device.

Restart semantics: on construction the trainer restores the newest valid
checkpoint (if any) and the data pipeline resumes from the same step index
deterministically.  A preemption/failure can therefore kill the process at
any point and `Trainer(...).run()` continues where it left off.  (The
batches are seeded with hash(("batch", step)) as in the JAX package, which
Python salts per process: the same data after a restart holds within one
process only - ROADMAP §3.)

Straggler mitigation (single-host analogue): a step-time watchdog tracks a
robust moving estimate; steps slower than `straggler_factor` x median are
counted.

On a mesh (mesh=, a launch/mesh.py DeviceMesh, with state_shardings=,
launch/specs.py train_cell's state shardings), every rank of the world
runs the same Trainer: the state lives as DTensors with those
placements (init_sharded_train_state), each step is the sharded step of
train/train_step.py over this rank's rows of rank 0's global batch
(DataPipeline(mesh=)), and checkpoints hold the full tensors, written by
rank 0 and restored onto whatever mesh the restoring Trainer has.  The
mesh path takes every family (an MoE layer by the per-row dispatch on
the rank's rows, or with REPRO_MOE_A2A the expert-parallel exchange, its
aux loss a share of the global batch's: train/train_step.py; the vlm
family's image rows and whisper's encoder and cross-attention on the
rank's head shard; zamba2's shared block on the head shard, its Mamba2
layers and rwkv6's time-mix replicated over the model axis).  On the
card the Trainer first refuses a head dim K5 does not take, before
anything is built (check_backward).
"""
from __future__ import annotations

import statistics
import time
from typing import Dict, Optional

import torch

from ..configs.base import ModelConfig, TrainConfig
from ..data.pipeline import DataPipeline
from ..launch.mesh import check_mesh_family
from ..models import build_model
from .checkpoint import restore_latest, save_checkpoint
from .train_step import (check_backward, init_sharded_train_state,
                         init_train_state, make_train_step)


def check_mesh(cfg: ModelConfig, device, mesh, state_shardings) -> None:
    """The mesh path's preconditions, before anything is built: a mesh
    and its state shardings together, on the device type the mesh holds,
    and a family the mesh steps take (launch/mesh.py
    check_mesh_family)."""
    if (mesh is None) != (state_shardings is None):
        raise ValueError("a mesh and its state_shardings (launch/specs.py "
                         "train_cell) come together")
    if mesh is None:
        return
    check_mesh_family(cfg, "training")
    if torch.device(device).type != mesh.device_type:
        raise ValueError(f"the mesh holds {mesh.device_type} tensors, the "
                         f"Trainer's device is {device}")


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, device="cuda",
                 fail_at_step: Optional[int] = None, mesh=None,
                 state_shardings=None):
        check_backward(cfg, device)
        check_mesh(cfg, device, mesh, state_shardings)
        self.cfg = cfg
        self.tcfg = tcfg
        self.model = build_model(cfg, device)
        self.pipeline = DataPipeline(cfg, tcfg, device=self.model.device,
                                     mesh=mesh)
        self.fail_at_step = fail_at_step          # test hook: simulated crash
        self.metrics_log = []
        self._step_times = []
        self.straggler_factor = 3.0
        self.straggler_events = 0
        self.train_step = make_train_step(self.model, tcfg, mesh=mesh)

        # ---- restore-or-init: the fresh state is the restore template -----
        if mesh is None:
            self.state = init_train_state(self.model, tcfg.seed, tcfg)
        else:
            self.state = init_sharded_train_state(self.model, tcfg.seed,
                                                  tcfg, state_shardings)
        restored = restore_latest(tcfg.checkpoint_dir, self.state)
        if restored is not None:
            self.state, self.start_step = restored
            self.start_step += 1
        else:
            self.start_step = 0

    # --------------------------------------------------------------------
    def run(self, n_steps: Optional[int] = None) -> Dict:
        tcfg = self.tcfg
        end = min(self.start_step + (n_steps or tcfg.total_steps),
                  tcfg.total_steps)
        step = self.start_step
        while step < end:
            if self.fail_at_step is not None and step == self.fail_at_step:
                raise RuntimeError(f"simulated failure at step {step}")
            t0 = time.time()
            batch = self.pipeline.device_batch(step)
            self.state, metrics = self.train_step(self.state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.time() - t0
            self._watchdog(step, dt)
            if step % tcfg.log_every == 0 or step == end - 1:
                metrics.update(step=step, step_time_s=round(dt, 4))
                self.metrics_log.append(metrics)
            if tcfg.checkpoint_every and (step + 1) % tcfg.checkpoint_every == 0:
                save_checkpoint(tcfg.checkpoint_dir, step, self.state,
                                keep=tcfg.keep_checkpoints)
            step += 1
        save_checkpoint(tcfg.checkpoint_dir, step - 1, self.state,
                        keep=tcfg.keep_checkpoints)
        return {"final_step": step - 1,
                "metrics": self.metrics_log,
                "straggler_events": self.straggler_events}

    # --------------------------------------------------------------------
    def _watchdog(self, step: int, dt: float):
        self._step_times.append(dt)
        if len(self._step_times) >= 8:
            med = statistics.median(self._step_times[-32:])
            if dt > self.straggler_factor * med:
                self.straggler_events += 1
        if len(self._step_times) > 256:
            self._step_times = self._step_times[-64:]
