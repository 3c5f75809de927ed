"""Synthetic LM data pipeline: deterministic, restartable, with prefetch -
the JAX package's data/pipeline.py with torch tensors on the trainer's
device in place of mesh-placed arrays.

Batches are made on the host with numpy from (seed, step), exactly as the
JAX package makes them (SyntheticCorpus is a copy, down to its per-step
seed hash(("batch", step)), so a port batch equals the JAX batch of the
same step in the same process), then moved to the device; tokens stay
int32, and the frontend stubs' inputs go over in bfloat16, whatever the
model's dtype, as the JAX package's device_batch casts them: the audio
family's frame embeddings (audio_embeds: numpy-seeded N(0, 0.02^2) from
default_rng(step + 11), one frame per token) and the vlm family's patch
embeddings (vision_embeds: frontend_tokens of them, N(0, 0.02^2) from
default_rng(step + 7), ahead of seq_len - frontend_tokens text tokens, so
a row is seq_len positions).

On a mesh (mesh=, a launch/mesh.py DeviceMesh), device_batch gives each
rank its rows of the global batch, split over the data-parallel axes
("pod", "data", pod outermost) in mesh order and whole on the model
axis, as the JAX package's device_batch places it.  The global batch is
rank 0's, broadcast over the world from the device:
SyntheticCorpus seeds each step with hash(("batch", step)), which Python
salts per process, so each rank draws a different "global" batch; rank
0's overwrites the others' before any is used, and every rank slices
the same one.  The
single-process batch is made as before, so that it equals the JAX
package's in one process.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig, TrainConfig
from ..models.model import resolve_device
from ..sharding.rules import axis_names, dp_axes


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
    unless device="cpu" is asked for); mesh: this rank's rows of each
    global batch."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, device="cuda",
                 prefetch: int = 2, mesh=None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.mesh = mesh
        self.device = resolve_device(device, "DataPipeline")
        self.corpus = SyntheticCorpus(cfg.vocab_size, seed=tcfg.seed)
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ---- raw host batches --------------------------------------------------
    def host_batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        B, S = self.tcfg.global_batch, self.tcfg.seq_len
        if cfg.family == "vlm":
            rng = np.random.default_rng(step + 7)
            return {"tokens": self.corpus.batch(step, B,
                                                S - cfg.frontend_tokens),
                    "vision_embeds": rng.standard_normal(
                        (B, cfg.frontend_tokens, cfg.d_model)).astype(
                            np.float32) * 0.02}
        batch = {"tokens": self.corpus.batch(step, B, S)}
        if cfg.family == "audio":
            rng = np.random.default_rng(step + 11)
            batch["audio_embeds"] = rng.standard_normal(
                (B, S, cfg.d_model)).astype(np.float32) * 0.02
        return batch

    # ---- device placement ---------------------------------------------------
    def device_batch(self, step: int) -> Dict[str, torch.Tensor]:
        if self.mesh is not None:
            return self._mesh_batch(step)
        return {k: torch.from_numpy(v).to(self.device, None if k == "tokens"
                                          else torch.bfloat16)
                for k, v in self.host_batch(step).items()}

    def _mesh_batch(self, step: int) -> Dict[str, torch.Tensor]:
        """Rank 0's global batch, broadcast over the world (every rank
        draws one, and rank 0's overwrites the others'); this rank's rows
        of it."""
        from ..sharding.shards import broadcast_world
        mesh = self.mesh
        full = {k: torch.from_numpy(v).to(
            self.device, None if k == "tokens" else torch.bfloat16)
            for k, v in self.host_batch(step).items()}
        dp = dp_axes(axis_names(mesh)) or ()
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        n, c = 1, 0
        for a in dp:
            c, n = c * sizes[a] + coord[a], n * sizes[a]
        B = self.tcfg.global_batch
        if B % n:
            raise ValueError(f"global batch {B} does not split over the "
                             f"{n} data-parallel ranks of the mesh")
        out = {}
        for k in sorted(full):
            broadcast_world(full[k])
            out[k] = full[k][c * (B // n):(c + 1) * (B // n)].contiguous()
        return out

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
