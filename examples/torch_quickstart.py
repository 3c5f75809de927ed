"""Quickstart through the PyTorch/CUDA port: build a model, train a few
steps, generate tokens - examples/quickstart.py on repro_torch.

    python examples/torch_quickstart.py [--arch granite-3-2b] [--device cpu]

Trains a smoke-scale model for a few steps (loss should fall), then serves
two requests through the paged-KV ServeEngine.  Runs on the GPU unless
--device cpu; on CUDA the smoke config's head dim (16) is raised to 64,
the smallest the port's kernels take (K1-K5: 64, 128 and 256).
Checkpoints go to --ckpt-dir (under the temporary directory by default):
a second run resumes from them.

Expected output shape:

    == granite-3-2b-smoke: 0.07M params (dense) ==
      step    4  loss 5.54  lr ...  ... ms
      ...
      request 1: generated [..., ..., ...]
      request 2: generated [..., ..., ...]
"""
import argparse
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch

from repro_torch.configs import ServeConfig, TrainConfig, get_smoke_config
from repro_torch.kernels._checks import BACKWARD_HEAD_DIMS
from repro_torch.models import build_model
from repro_torch.serve import ServeEngine
from repro_torch.train.trainer import Trainer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_quickstart"))
    args = ap.parse_args()

    cfg = get_smoke_config(args.arch)
    if torch.device(args.device).type == "cuda":
        cfg = cfg.replace(head_dim=BACKWARD_HEAD_DIMS[0])
    print(f"== {cfg.name}: {cfg.param_count()/1e6:.2f}M params "
          f"({cfg.family}) ==")

    tcfg = TrainConfig(global_batch=8, seq_len=64, total_steps=args.steps,
                       warmup_steps=2, learning_rate=1e-2,
                       checkpoint_every=10, checkpoint_dir=args.ckpt_dir,
                       log_every=5)
    out = Trainer(cfg, tcfg, device=args.device).run()
    for m in out["metrics"]:
        print(f"  step {m['step']:4d}  loss {m['loss']:.3f}  "
              f"lr {m['lr']:.2e}  {m['step_time_s']*1e3:.0f} ms")

    model = build_model(cfg, args.device)
    params = model.init(seed=0)
    eng = ServeEngine(model, params,
                      ServeConfig(max_batch=2, max_seq=96, max_new_tokens=8,
                                  paged=True, page_size=16))
    eng.submit([1, 2, 3, 4])
    eng.submit([5, 6, 7])
    for r in eng.run_until_done():
        print(f"  request {r.uid}: generated {r.out_tokens}")


if __name__ == "__main__":
    main()
