"""One rank of a gloo world for tests/test_torch_seq_parallel.py: it joins
the world through a FileStore, takes its slice of the cache and runs the
port's seq_parallel_decode.  Kept apart from the test module so that a
spawned rank imports torch and the port only, not jax."""
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.kernels import ops


def run(rank: int, world: int, store: str, inputs: str, out_dir: str):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        d = np.load(inputs)
        S_local = d["k"].shape[1] // world
        part = slice(rank * S_local, (rank + 1) * S_local)
        o = ops.seq_parallel_decode(
            torch.from_numpy(d["q"]),
            torch.from_numpy(np.ascontiguousarray(d["k"][:, part])),
            torch.from_numpy(np.ascontiguousarray(d["v"][:, part])),
            torch.from_numpy(d["lens"]))
        np.save(os.path.join(out_dir, f"o{rank}.npy"), o.numpy())
    finally:
        dist.destroy_process_group()
