"""gloo's all-gather of CUDA tensors between two ranks on one card: the
transport of the port's tensor-parallel serving (kernels/ops.py
_tp_head_sharded) when the two ranks share one GPU, where NCCL refuses
two ranks on one device.

    python3 tools/tp_gather_probe.py        # from the repository root

Two spawned processes on cuda:0 join a gloo world through a FileStore
under build/.  Each checks that all_gather_into_tensor (and the list
all_gather) takes CUDA tensors and puts the ranks' rows in rank order,
then, for K2's and K1's gathered output at granite-3-2b's tp 2 shapes -
(8, 1, 16, 64) and (4, 256, 16, 64) in bf16 - counts the synchronising
calls torch.cuda's sync debug mode reports on the calling thread in one
gather (gloo's own threads print theirs to stderr) and times 100 gathers
(host wall over a synchronise, per gather).
"""
import datetime
import os
import sys
import time
import warnings

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def rank(r, store):
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=r,
                            world_size=2,
                            timeout=datetime.timedelta(seconds=60))
    x = torch.full((3, 4), float(r + 1), device="cuda")
    out = torch.empty((6, 4), device="cuda")
    try:
        dist.all_gather_into_tensor(out, x)
        torch.cuda.synchronize()
        print(r, "into_tensor ok", out[:, 0].tolist(), flush=True)
    except Exception as e:
        print(r, "into_tensor FAILED", repr(e)[:400], flush=True)
    lst = [torch.empty_like(x) for _ in range(2)]
    dist.all_gather(lst, x)
    print(r, "list ok", [t[0, 0].item() for t in lst], flush=True)
    for shape in ((8, 1, 16, 64), (4, 256, 16, 64)):
        x = torch.randn(shape, device="cuda").to(torch.bfloat16)
        out = x.new_empty((2 * shape[0],) + shape[1:])
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            dist.all_gather_into_tensor(out, x)
            torch.cuda.set_sync_debug_mode(0)
        n = sum("synchroniz" in str(w.message) for w in caught)
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(100):
            dist.all_gather_into_tensor(out, x)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / 100 * 1e3
        print(r, shape, f"{dt:.3f} ms a gather, sync warnings in one: {n}",
              [str(w.message)[:120] for w in caught][:3], flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    os.makedirs(os.path.join(root, "build"), exist_ok=True)
    store = os.path.join(root, "build", "probe_store")
    if os.path.exists(store):
        os.remove(store)
    mp.start_processes(rank, args=(store,), nprocs=2, start_method="spawn")
