"""One rank of a gloo world for tests/test_torch_moe_a2a.py: it joins the
world through a FileStore, takes its slice of the tokens and of the
experts and runs the port's moe_ffn_a2a_local at each capacity factor of
the inputs.  Kept apart from the test module so that a spawned rank
imports torch and the port only, not jax."""
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke_config
from repro_torch.models.moe_a2a import moe_ffn_a2a_local


def run(rank: int, world: int, store: str, inputs: str, out_dir: str):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        d = np.load(inputs)
        S_l = d["x"].shape[1] // world
        e_loc = d["router"].shape[1] // world
        x = torch.from_numpy(np.ascontiguousarray(
            d["x"][:, rank * S_l:(rank + 1) * S_l]))
        params = {"router": torch.from_numpy(d["router"])}
        for k in ("experts_in", "experts_gate", "experts_out"):
            params[k] = torch.from_numpy(np.ascontiguousarray(
                d[k][rank * e_loc:(rank + 1) * e_loc]))
        out = {}
        for factor in d["factors"]:
            cfg = get_smoke_config("olmoe-1b-7b").replace(
                dtype="float32", moe_capacity_factor=float(factor))
            y, aux = moe_ffn_a2a_local(params, x, cfg)
            out[f"y{factor}"], out[f"aux{factor}"] = y.numpy(), aux.numpy()
        np.savez(os.path.join(out_dir, f"r{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()
