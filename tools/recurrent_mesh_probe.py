"""How far the hybrid and ssm families' mesh decode strays from one device
over teacher-forced steps, four ranks on one card, and how much of that
the batch rows explain.

    python3 tools/recurrent_mesh_probe.py [P STEPS ZAMBA_L RWKV_L DTYPES]
    # default: 2048 16 12 6 bfloat16,float32; from the repository root

Four spawned processes on cuda:0 join a gloo world through a FileStore
under build/ and build make_debug_mesh(2, 2).  Each rank seeds
zamba2-2.7b and rwkv6-1.6b at full width, cut to the given depths
(Model.init(5), in each dtype), prefills P tokens through
launch/specs.py prefill_cell's step and decodes STEPS teacher-forced
tokens through serve_cell's, in the default layout (4 lanes) and with
the sequence over the data axis (1 lane).  Beside them, in the same
process, one device runs the same prompt and tokens twice: over the
whole batch, and over the rank's rows alone (the same GEMM shapes as
the rank's).  Rank 0 prints, per config, dtype, layout and reference,
the largest logits |difference| over the steps, the argmax flips, and
each cache leaf's largest |difference| over its largest |entry| after
the last step.  (A numpy-seeded prompt, the same in every process.)
"""
import datetime
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
STORE = os.path.join(ROOT, "build", "recurrent_mesh_probe_store")


def _rank(rank, world, P, steps, arch, layers, dtype):
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.specs import prefill_cell, serve_cell
    from repro_torch.models import build_model
    from repro_torch.sharding.shards import local_slice, slice_bounds
    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", store=dist.FileStore(STORE, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=300))
    mesh = make_debug_mesh(2, 2)
    cfg = get_config(arch).replace(n_layers=layers, dtype=dtype)
    model = build_model(cfg)
    params = model.init(5)
    S = P + steps
    loc = lambda t, sh: local_slice(t, sh.placements, mesh).contiguous()
    out = {}
    for layout, B in (("default", 4), ("seq_data", 1)):
        rng = np.random.default_rng(3)
        prompt = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (B, P), dtype=np.int32)).cuda()
        toks = [torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (B, 1), dtype=np.int32)).cuda()
            for _ in range(steps)]
        pstep, _, psh = prefill_cell(cfg, ShapeSpec("p", S, B, "prefill"),
                                     mesh)
        dstep, dargs, dsh = serve_cell(cfg, ShapeSpec("d", S, B, "decode"),
                                       mesh)
        rb = [b for b in slice_bounds((B, 1), dsh[2].placements, mesh)
              if b[0] == 0]
        rows = slice(rb[0][1], rb[0][1] + rb[0][2]) if rb else slice(0, B)
        with torch.no_grad():
            cache = model.init_cache(B, S, shardings=psh[2])
            _, cache, _ = pstep(params, {"tokens": loc(prompt,
                                                       psh[1]["tokens"])},
                                cache)
            refs = {}
            for name, sl in (("whole", slice(0, B)), ("rows", rows)):
                rc = model.init_cache(sl.stop - sl.start, S)
                _, rc, lens = model.prefill(params, {"tokens": prompt[sl]},
                                            rc)
                refs[name] = [rc, lens, sl]
            mlens = torch.full((rows.stop - rows.start,), P,
                               dtype=torch.int32, device="cuda")
            res = {name: {"logits": 0.0, "flips": 0} for name in refs}
            for t in toks:
                ml, cache = dstep(params, cache, loc(t, dsh[2]), mlens)
                mlens = mlens + 1
                for name, r in refs.items():
                    rl, r[0] = model.decode_step(
                        params, t[r[2]], r[1], r[0],
                        seq_parallel=layout != "default")
                    r[1] = r[1] + 1
                    w = rl if name == "rows" else rl[rows]
                    res[name]["logits"] = max(res[name]["logits"],
                                              float((ml - w).abs().max()))
                    res[name]["flips"] += int(
                        (ml.argmax(-1) != w.argmax(-1)).sum())
            for name, r in refs.items():
                for n in cache:
                    want = r[0][n]
                    for dim, st, sz in slice_bounds(
                            dargs[1][n].shape, dsh[1][n].placements, mesh):
                        if not (dim == 1 and name == "rows"):
                            want = want.narrow(dim, st, sz)
                    res[name][n] = float(
                        (cache[n].float() - want.float()).abs().max()) \
                        / max(float(r[0][n].float().abs().max()), 1e-30)
            out[layout] = res
    if rank == 0:
        for layout, res in out.items():
            for name, r in res.items():
                print(f"# {arch} ({layers} L) {dtype} {layout} against one "
                      f"device ({name}): " + json.dumps(r), flush=True)
    dist.destroy_process_group()


def main(argv) -> int:
    P, steps, zl, rl = (int(a) for a in (argv + ["2048", "16", "12",
                                                  "6"][len(argv):])[:4])
    dtypes = argv[4].split(",") if len(argv) > 4 \
        else ["bfloat16", "float32"]
    from repro_torch.kernels import build
    build.build_all()                   # once, before the ranks start
    os.makedirs(os.path.dirname(STORE), exist_ok=True)
    for arch, layers in (("zamba2-2.7b", zl), ("rwkv6-1.6b", rl)):
        for dtype in dtypes:
            if os.path.exists(STORE):
                os.remove(STORE)
            mp.start_processes(_rank, args=(4, P, steps, arch, layers,
                                            dtype),
                               nprocs=4, join=True, start_method="spawn")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
