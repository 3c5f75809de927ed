"""gloo's collectives on CUDA tensors over the groups of a 2x2 DeviceMesh,
four ranks on one card: the transport of the port's sharded training step
(sharding/shards.py, train/train_step.py) when the ranks share one GPU,
where NCCL refuses two ranks on one device.

    python3 tools/mesh_collectives_probe.py       # from the repository root

Four spawned processes on cuda:0 join a gloo world through a FileStore
under build/ and build DeviceMesh("cuda", [[0, 1], [2, 3]], ("data",
"model")).  Each checks, on CUDA tensors: all_gather_into_tensor over the
"data" and the "model" group (rows in group-rank order), all_reduce (sum)
over each group, broadcast from rank 0 over the world, and a DTensor made
with from_local whose to_local() is the same storage.  Then it times the
collectives at the sizes of one granite-3-2b layer's w_in in bf16 (2048 x
8192, a quarter of it a rank): 20 gathers over "data" and 20 all-reduces
over "data" (host wall over a synchronise, per call), and counts the
synchronising calls torch.cuda's sync debug mode reports on the calling
thread in one of each.
"""
import datetime
import os
import sys
import time
import warnings

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4


def _syncs(fn) -> int:
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        fn()
        torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


def _timed(fn, n=20) -> float:
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def rank(r, store):
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD),
                            rank=r, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=120))
    mesh = DeviceMesh("cuda", torch.arange(WORLD).reshape(2, 2),
                      mesh_dim_names=("data", "model"))
    coord = mesh.get_coordinate()
    ok = True
    for dim in ("data", "model"):
        g = mesh.get_group(dim)
        x = torch.full((2, 3), float(r), device="cuda")
        out = torch.empty((4, 3), device="cuda")
        dist.all_gather_into_tensor(out, x, group=g)
        got = out[::2, 0].tolist()
        want = [float(q) for q in
                (mesh.mesh[:, coord[1]] if dim == "data"
                 else mesh.mesh[coord[0], :]).tolist()]
        s = torch.full((5,), float(r + 1), device="cuda")
        dist.all_reduce(s, group=g)
        print(r, dim, "gather", got, "want", want, "all_reduce",
              s[0].item(), "want", sum(w + 1 for w in want), flush=True)
        ok &= got == want and s[0].item() == sum(w + 1 for w in want)
    b = torch.full((3,), float(r), device="cuda", dtype=torch.int32)
    dist.broadcast(b, src=0)
    ok &= b.tolist() == [0, 0, 0]
    loc = torch.randn(4, 8, device="cuda")
    d = DTensor.from_local(loc, mesh, [Shard(0), Replicate()],
                           run_check=False)
    ok &= d.to_local().data_ptr() == loc.data_ptr() \
        and tuple(d.shape) == (8, 8)
    print(r, "broadcast", b.tolist(), "dtensor", tuple(d.shape),
          d.placements, "all ok" if ok else "FAILED", flush=True)
    g = mesh.get_group("data")
    x = torch.randn((1024, 8192), device="cuda").to(torch.bfloat16)
    out = x.new_empty((2048, 8192))
    full = torch.randn((2048, 8192), device="cuda").to(torch.bfloat16)
    n_g = _syncs(lambda: dist.all_gather_into_tensor(out, x, group=g))
    n_r = _syncs(lambda: dist.all_reduce(full, group=g))
    t_g = _timed(lambda: dist.all_gather_into_tensor(out, x, group=g))
    t_r = _timed(lambda: dist.all_reduce(full, group=g))
    mb = full.numel() * 2 / 1e6
    print(r, f"data group, bf16 (2048, 8192) = {mb:.1f} MB: all_gather "
          f"{t_g:.2f} ms ({n_g} sync warnings), all_reduce {t_r:.2f} ms "
          f"({n_r} sync warnings)", flush=True)
    dist.destroy_process_group()
    if not ok:
        raise SystemExit(1)


if __name__ == "__main__":
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    os.makedirs(os.path.join(root, "build"), exist_ok=True)
    store = os.path.join(root, "build", "mesh_probe_store")
    if os.path.exists(store):
        os.remove(store)
    mp.start_processes(rank, args=(store,), nprocs=WORLD,
                       start_method="spawn")
