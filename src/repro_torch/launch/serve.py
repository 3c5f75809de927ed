"""Serving launcher (continuous batching, dense or paged KV cache): the CLI
of the JAX package's repro.launch.serve.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-4b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-4b \
        --paged --page-size 16 --num-pages 64 --device cpu

--paged serves through the paged KV cache (serve/paged_cache.py): a global
page pool + block table instead of one dense (max_batch, max_seq) strip per
slot.  --num-pages 0 sizes the pool to dense-equivalent capacity; smaller
pools trade admission backpressure for KV memory.  Runs on the GPU unless
--device cpu; there the smoke configs' head dim (16) is raised to 64, the
smallest the serving kernels K1-K3 take (64, 128 and 256), as
launch/train.py raises it for K5.  The weights are Model.init(seed=0).
"""
import argparse

import numpy as np
import torch

from ..configs import get_config, get_smoke_config
from ..configs.base import ServeConfig
from ..kernels._checks import PAGED_HEAD_DIMS
from ..models import build_model
from ..serve.engine import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--paged", action="store_true",
                    help="serve through the paged KV cache")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=0,
                    help="page pool size (0 = dense-equivalent)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.smoke and torch.device(args.device).type == "cuda" \
            and cfg.head_dim not in PAGED_HEAD_DIMS:
        cfg = cfg.replace(head_dim=PAGED_HEAD_DIMS[0])
    model = build_model(cfg, args.device)
    params = model.init(seed=0)
    scfg = ServeConfig(max_batch=args.max_batch, max_seq=args.max_seq,
                       max_new_tokens=16, paged=args.paged,
                       page_size=args.page_size, num_pages=args.num_pages)
    eng = ServeEngine(model, params, scfg)
    rng = np.random.default_rng(0)
    for _ in range(args.requests):
        eng.submit(rng.integers(1, cfg.vocab_size, size=6).tolist())
    done = eng.run_until_done()
    mode = f"paged (page={scfg.page_size}, pool={scfg.pool_pages()})" \
        if args.paged else "dense"
    print(f"served {len(done)} requests, "
          f"{sum(len(r.out_tokens) for r in done)} tokens "
          f"[{mode} KV cache, {eng.kv_cache_bytes() / 1e6:.2f} MB]")


if __name__ == "__main__":
    main()
