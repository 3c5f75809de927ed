"""Training launcher: the CLI of the JAX package's repro.launch.train.

Smoke scale, on the GPU:
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
        --smoke

The smoke configs' head dim (16) is below what the CUDA attention backward
K5 takes (64, 128 and 256), so on a CUDA device --smoke raises it to 64; on
the CPU (--device cpu) the smoke config runs as it is, as in the JAX
package.  A full config whose head dim K5 does not take (zamba2's 80) is
refused on CUDA by the Trainer, naming K5, before anything is built.

gemma3-4b at full width on one H100 (2.99 B parameters, ~12 bytes each of
training state):
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-4b \
        --single-device --global-batch 4 --seq 2048 --steps 10

Without --smoke, as in the JAX package, the full config trains on the
production mesh built from the world (launch/mesh.py: (16, 16) "data" x
"model", or (2, 16, 16) with --multi-pod) with train_cell's state
shardings: one process per rank, e.g. torchrun --nproc-per-node=... on
each host; a world of another size raises.  --debug-mesh D,M trains on
a (D, M) mesh instead (make_debug_mesh), with --smoke or without; on the
CPU, a gloo world of four:
    torchrun --nproc-per-node=4 -m repro_torch.launch.train \
        --arch granite-3-2b --smoke --debug-mesh 2,2 --device cpu
The process group is initialised here from torchrun's environment when
it is not yet (gloo on the CPU; nccl on CUDA, each rank on
cuda:LOCAL_RANK).  --single-device trains the full config on one
device with no mesh: the JAX defaults (a global batch of 256 x 4096
tokens) are sized for a sharded TPU fleet and do not fit one H100, so
pass --global-batch and --seq (e.g. 4 x 2048 for granite-3-2b).
"""
import argparse
import os

import torch

from ..configs import get_config, get_smoke_config
from ..configs.base import ShapeSpec, TrainConfig
from ..kernels._checks import BACKWARD_HEAD_DIMS


def init_world(device: str) -> None:
    """The default process group from torchrun's environment (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT), unless one exists."""
    import torch.distributed as dist
    if dist.is_initialized():
        return
    if "WORLD_SIZE" not in os.environ:
        raise ValueError("a mesh needs one process per rank: launch with "
                         "torchrun --nproc-per-node=N (or initialise "
                         "torch.distributed first)")
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if cuda else "gloo")


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
    ap.add_argument("--debug-mesh", default="",
                    help="N_DATA,N_MODEL: train on that mesh")
    ap.add_argument("--single-device", action="store_true",
                    help="the full config on one device, no mesh")
    args = ap.parse_args(argv)

    from ..train.trainer import Trainer, check_backward

    if args.smoke:
        cfg = get_smoke_config(args.arch)
        if torch.device(args.device).type == "cuda" \
                and cfg.head_dim not in BACKWARD_HEAD_DIMS:
            cfg = cfg.replace(head_dim=BACKWARD_HEAD_DIMS[0])
        tcfg = TrainConfig(global_batch=args.global_batch or 8,
                           seq_len=args.seq or 64, total_steps=args.steps,
                           warmup_steps=5, checkpoint_dir=args.ckpt_dir,
                           grad_compression="int8" if args.compress_grads
                           else "")
    else:
        cfg = get_config(args.arch)
        tcfg = TrainConfig(global_batch=args.global_batch or 256,
                           seq_len=args.seq or 4096, total_steps=args.steps,
                           remat="full", checkpoint_dir=args.ckpt_dir,
                           grad_compression="int8" if args.compress_grads
                           else "")
    # a head dim K5 does not take has no backward on the card: refused
    # before a world or a mesh is built
    check_backward(cfg, args.device)
    mesh = None
    if args.debug_mesh or not (args.smoke or args.single_device):
        from .mesh import make_debug_mesh, make_production_mesh
        from .specs import train_cell
        init_world(args.device)
        dev = torch.device(args.device).type
        if args.debug_mesh:
            d, m = (int(x) for x in args.debug_mesh.split(","))
            mesh = make_debug_mesh(d, m, device_type=dev)
        else:
            mesh = make_production_mesh(multi_pod=args.multi_pod,
                                        device_type=dev)
        shape = ShapeSpec("train", tcfg.seq_len, tcfg.global_batch, "train")
        _, _, shardings = train_cell(cfg, shape, mesh, tcfg)
        tr = Trainer(cfg, tcfg, device=args.device, mesh=mesh,
                     state_shardings=shardings[0])
    else:
        tr = Trainer(cfg, tcfg, device=args.device)
    out = tr.run()
    import torch.distributed as dist
    if mesh is None or dist.get_rank() == 0:
        print(f"finished at step {out['final_step']}; "
              f"last loss {out['metrics'][-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
