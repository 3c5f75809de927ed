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
counted.  A mesh and state shardings (data / tensor parallel training)
come with ROADMAP M10 and M14.
"""
from __future__ import annotations

import statistics
import time
from typing import Dict, Optional

from ..configs.base import ModelConfig, TrainConfig
from ..data.pipeline import DataPipeline
from ..models import build_model
from .checkpoint import restore_latest, save_checkpoint
from .train_step import init_train_state, make_train_step


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, device="cuda",
                 fail_at_step: Optional[int] = None, mesh=None,
                 state_shardings=None):
        if mesh is not None or state_shardings is not None:
            raise NotImplementedError(
                "sharded training over a mesh is not ported yet (ROADMAP "
                "M10 / M14): the port trains on one device")
        self.cfg = cfg
        self.tcfg = tcfg
        self.model = build_model(cfg, device)
        self.pipeline = DataPipeline(cfg, tcfg, device=self.model.device)
        self.fail_at_step = fail_at_step          # test hook: simulated crash
        self.metrics_log = []
        self._step_times = []
        self.straggler_factor = 3.0
        self.straggler_events = 0
        self.train_step = make_train_step(self.model, tcfg)

        # ---- restore-or-init: the fresh state is the restore template -----
        self.state = init_train_state(self.model, tcfg.seed, tcfg)
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
