"""Synthetic LM data pipeline: deterministic, restartable, with prefetch -
the JAX package's data/pipeline.py with torch tensors on the trainer's
device in place of mesh-placed arrays.

Batches are made on the host with numpy from (seed, step), exactly as the
JAX package makes them (SyntheticCorpus is a copy, down to its per-step
seed hash(("batch", step)), so a port batch equals the JAX batch of the
same step in the same process), then moved to the device; tokens stay
int32.  The frontend families' extra inputs (vlm, audio) come with those
families (ROADMAP M13).
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig, TrainConfig
from ..models.model import resolve_device


class SyntheticCorpus:
    """Zipf-distributed token stream with local n-gram structure, so the
    model has something learnable (repeated bigram templates)."""

    def __init__(self, vocab_size: int, seed: int = 0, n_templates: int = 64,
                 template_len: int = 16):
        self.vocab = vocab_size
        rng = np.random.default_rng(seed)
        probs = 1.0 / np.arange(1, vocab_size + 1) ** 1.1
        self.probs = probs / probs.sum()
        self.templates = rng.integers(
            0, vocab_size, (n_templates, template_len)).astype(np.int32)

    def batch(self, step: int, batch_size: int, seq_len: int) -> np.ndarray:
        rng = np.random.default_rng((hash(("batch", step)) & 0x7FFFFFFF))
        toks = rng.choice(self.vocab, size=(batch_size, seq_len),
                          p=self.probs).astype(np.int32)
        # splice learnable templates
        n_splice = max(1, seq_len // (2 * self.templates.shape[1]))
        for b in range(batch_size):
            for _ in range(n_splice):
                t = rng.integers(0, len(self.templates))
                pos = rng.integers(0, max(1, seq_len - self.templates.shape[1]))
                toks[b, pos:pos + self.templates.shape[1]] = self.templates[t]
        return toks


class DataPipeline:
    """step -> device batch dict, with prefetch.  Runs on `device` (the GPU
    unless device="cpu" is asked for)."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, device="cuda",
                 prefetch: int = 2):
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve_device(device, "DataPipeline")
        self.corpus = SyntheticCorpus(cfg.vocab_size, seed=tcfg.seed)
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ---- raw host batches --------------------------------------------------
    def host_batch(self, step: int) -> Dict[str, np.ndarray]:
        if self.cfg.family in ("vlm", "audio"):
            raise NotImplementedError(
                f"the {self.cfg.family} frontend inputs are not ported yet "
                f"(ROADMAP M13)")
        B, S = self.tcfg.global_batch, self.tcfg.seq_len
        return {"tokens": self.corpus.batch(step, B, S)}

    # ---- device placement ---------------------------------------------------
    def device_batch(self, step: int) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self.host_batch(step).items()}

    # ---- prefetch -------------------------------------------------------------
    def start(self, first_step: int):
        def worker():
            step = first_step
            while not self._stop.is_set():
                try:
                    self._q.put((step, self.device_batch(step)), timeout=0.5)
                    step += 1
                except queue.Full:
                    continue
        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def next(self):
        return self._q.get()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
