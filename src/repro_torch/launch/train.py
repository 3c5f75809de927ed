"""Training launcher: the CLI of the JAX package's repro.launch.train.

Smoke scale, on the GPU:
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
        --smoke

The smoke configs' head dim (16) is below what the CUDA attention kernels
take (64 and 128), so on a CUDA device --smoke raises it to 64; on the CPU
(--device cpu) the smoke config runs as it is, as in the JAX package.

Without --smoke the full config trains on one device with no mesh.  The
JAX defaults for the full config (a global batch of 256 x 4096 tokens)
are sized for a sharded TPU fleet and do not fit one H100: pass
--global-batch and --seq (e.g. 4 x 2048 for granite-3-2b).  --multi-pod
needs a mesh (ROADMAP M14).
"""
import argparse

import torch

from ..configs import get_config, get_smoke_config
from ..configs.base import TrainConfig
from ..kernels._checks import HEAD_DIMS_64_128


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=0)
    ap.add_argument("--seq", type=int, default=0)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--ckpt-dir", default="/tmp/repro_train")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..train.trainer import Trainer

    if args.smoke:
        cfg = get_smoke_config(args.arch)
        if torch.device(args.device).type == "cuda" \
                and cfg.head_dim not in HEAD_DIMS_64_128:
            cfg = cfg.replace(head_dim=HEAD_DIMS_64_128[0])
        tcfg = TrainConfig(global_batch=args.global_batch or 8,
                           seq_len=args.seq or 64, total_steps=args.steps,
                           warmup_steps=5, checkpoint_dir=args.ckpt_dir,
                           grad_compression="int8" if args.compress_grads
                           else "")
    else:
        if args.multi_pod:
            raise NotImplementedError(
                "--multi-pod needs a device mesh, not ported yet (ROADMAP "
                "M14)")
        cfg = get_config(args.arch)
        tcfg = TrainConfig(global_batch=args.global_batch or 256,
                           seq_len=args.seq or 4096, total_steps=args.steps,
                           remat="full", checkpoint_dir=args.ckpt_dir,
                           grad_compression="int8" if args.compress_grads
                           else "")
    out = Trainer(cfg, tcfg, device=args.device).run()
    print(f"finished at step {out['final_step']}; "
          f"last loss {out['metrics'][-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
