"""End-to-end serving example through the PyTorch/CUDA port - examples/
serve_lm.py on repro_torch (the paper is an inference accelerator, so the
end-to-end example serves a small LM with continuously-batched requests).
Runs on the GPU unless --device cpu; on CUDA the smoke config's head dim
(16) is raised to 64, the smallest the serving kernels K1-K3 take.

This is the paged-serving entry point: by default requests are served
through the paged KV cache (a global page pool walked via a block table -
see docs/serving.md); --dense switches back to the one-strip-per-slot
layout for comparison.  Both modes print tokens/s and allocated KV bytes.

    python examples/torch_serve_lm.py --arch gemma3-4b --requests 12
    python examples/torch_serve_lm.py --dense
    python examples/torch_serve_lm.py --chunked  # token-budget
        # scheduler: prefill chunks interleave with decode ticks
        # (docs/scheduling.md); greedy outputs match the monolithic
        # schedule exactly in float32 (bf16 can flip an argmax tie - the
        # chunk kernel and the monolithic prefill reduce in different
        # orders)

Expected output (CPU, smoke-scale model; numbers vary by machine):

    served 12 requests, 192 tokens in 8.3s (23.1 tok/s,
    continuous batching over 4 slots, paged KV: 0.03 MB, peak 18 pages)
      req 1: [132, 38, ...]
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np
import torch

from repro_torch.configs import ServeConfig, get_smoke_config
from repro_torch.kernels._checks import PAGED_HEAD_DIMS
from repro_torch.models import build_model
from repro_torch.serve import ServeEngine


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-4b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--dense", action="store_true",
                    help="dense KV cache instead of the paged pool")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=0,
                    help="page pool size (0 = dense-equivalent capacity)")
    ap.add_argument("--chunked", action="store_true",
                    help="token-budget scheduler: chunked prefill mixed "
                         "into decode ticks (paged only)")
    ap.add_argument("--prefill-chunk", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tick-budget", type=int, default=0,
                    help="tokens of work per tick "
                         "(0 = max_batch + prefill_chunk)")
    args = ap.parse_args()
    if args.chunked and args.dense:
        ap.error("--chunked needs the paged cache (drop --dense)")

    cfg = get_smoke_config(args.arch)
    if torch.device(args.device).type == "cuda":
        cfg = cfg.replace(head_dim=PAGED_HEAD_DIMS[0])
    model = build_model(cfg, args.device)
    params = model.init(seed=0)
    eng = ServeEngine(model, params,
                      ServeConfig(max_batch=args.max_batch, max_seq=128,
                                  max_new_tokens=args.max_new,
                                  paged=not args.dense,
                                  page_size=args.page_size,
                                  num_pages=args.num_pages,
                                  chunked=args.chunked,
                                  prefill_chunk=args.prefill_chunk,
                                  tick_token_budget=args.tick_budget or
                                  args.max_batch + args.prefill_chunk))

    rng = np.random.default_rng(0)
    t0 = time.time()
    for i in range(args.requests):
        prompt = rng.integers(1, cfg.vocab_size,
                              size=rng.integers(3, 12)).tolist()
        eng.submit(prompt)
    done = eng.run_until_done()
    dt = time.time() - t0
    tokens = sum(len(r.out_tokens) for r in done)
    kv = f"paged KV: {eng.kv_cache_bytes() / 1e6:.2f} MB, " \
         f"peak {eng.peak_pages} pages" if not args.dense \
        else f"dense KV: {eng.kv_cache_bytes() / 1e6:.2f} MB"
    sched = "chunked prefill" if args.chunked else "monolithic prefill"
    print(f"served {len(done)} requests, {tokens} tokens "
          f"in {dt:.1f}s ({tokens/dt:.1f} tok/s, "
          f"continuous batching over {args.max_batch} slots, {sched}, "
          f"{kv})")
    if args.chunked:
        st = eng.stats()
        print(f"  budget {st['tick_token_budget']} tok/tick, max tick "
              f"{st['max_tick_tokens']}, {st['chunks_run']} chunks, p95 "
              f"TTFT {st['ttft_work_p95']:.0f} work-tok / "
              f"{st['ttft_wall_p95'] * 1e3:.0f} ms")
    for r in done[:4]:
        print(f"  req {r.uid}: {r.out_tokens}")


if __name__ == "__main__":
    main()
