"""Training example through the PyTorch/CUDA port: fault-tolerant LM
training on synthetic data - examples/train_lm.py on repro_torch.

Smoke scale by default; --full-ish is a ~100M-parameter variant (slow on
the CPU; sized for the card).  Checkpoint/restart: run it, stop it, run
it again - it resumes.  Runs on the GPU unless --device cpu; on CUDA the
smoke config's head dim (16) is raised to 64, the smallest the attention
backward K5 takes.

    python examples/torch_train_lm.py --arch olmo-1b --steps 50
    python examples/torch_train_lm.py --steps 6 --device cpu
"""
import argparse
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch

from repro_torch.configs import TrainConfig, get_smoke_config
from repro_torch.kernels._checks import BACKWARD_HEAD_DIMS
from repro_torch.train.trainer import Trainer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full-ish", action="store_true",
                    help="~100M-param config (d_model=768, 12 layers)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_smoke_config(args.arch)
    if args.full_ish:
        cfg = cfg.replace(n_layers=12, d_model=768, n_heads=12,
                          n_kv_heads=12, head_dim=64, d_ff=3072,
                          vocab_size=32768)
    elif torch.device(args.device).type == "cuda":
        cfg = cfg.replace(head_dim=BACKWARD_HEAD_DIMS[0])
    print(f"{cfg.name}: {cfg.param_count()/1e6:.1f}M params")

    tcfg = TrainConfig(global_batch=args.batch, seq_len=args.seq,
                       total_steps=args.steps, warmup_steps=5,
                       learning_rate=6e-3, checkpoint_every=20,
                       checkpoint_dir=args.ckpt_dir, log_every=10,
                       grad_compression="int8" if args.compress_grads else "")
    tr = Trainer(cfg, tcfg, device=args.device)
    if tr.start_step:
        print(f"resumed from checkpoint at step {tr.start_step}")
    out = tr.run()
    for m in out["metrics"]:
        print(f"step {m['step']:4d}  loss {m['loss']:.4f}  "
              f"grad_norm {m['grad_norm']:.2f}  {m['step_time_s']*1e3:.0f} ms")
    print(f"done at step {out['final_step']}; "
          f"straggler events: {out['straggler_events']}")


if __name__ == "__main__":
    main()
