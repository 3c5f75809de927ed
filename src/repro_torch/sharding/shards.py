"""Tensors split over a DeviceMesh: a rank's shard of a full tensor, the
state leaves as DTensors, and the explicit collectives of the sharded
train step.

Every collective here is a torch.distributed call on plain tensors over
one mesh dim's process group (mesh.get_group(dim)):
all_gather_into_tensor, all_reduce and broadcast.  The same code runs on
gloo (the CPU, or CUDA tensors when several ranks share one card, where
NCCL refuses two ranks on one device) and on NCCL; a reduction is an
all_reduce then a slice, never a reduce_scatter, which gloo lacks for
CUDA tensors.  A failed collective raises: nothing retries it elsewhere.

A rank's shard of tensor dim d, split over mesh dims i1 < i2 < ... (the
spec entry's axes), is chunk number c = (((coord[i1]) * n[i2] + coord[i2])
* ...) of dim d in n[i1] * n[i2] * ... equal chunks: the outer mesh dim
first, as JAX tiles P(("pod", "data")) and as DTensor splits a dim over
several mesh dims.  The specs come sanitized (launch/specs.py), so every
split is even.

COMM counts the collectives a process makes (calls and payload bytes by
kind: for a gather the gathered output, for an all_reduce, a broadcast
and an all_to_all the tensor) - these helpers' and the MoE exchange's
(models/moe_a2a.py) - for chip_smoke.py's per-step report; reset with
reset_comm().
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.distributed as dist

COMM: Dict[str, Dict[str, int]] = {}


def reset_comm() -> None:
    COMM.clear()


def _count(kind: str, t: torch.Tensor) -> None:
    c = COMM.setdefault(kind, {"calls": 0, "bytes": 0})
    c["calls"] += 1
    c["bytes"] += t.numel() * t.element_size()


def _split_dims(placements) -> Dict[int, List[int]]:
    """{tensor dim: [mesh dims that split it, in mesh order]}."""
    out: Dict[int, List[int]] = {}
    for i, pl in enumerate(placements):
        if pl.is_shard():
            out.setdefault(pl.dim, []).append(i)
    return out


def slice_bounds(shape, placements, mesh) -> List[Tuple[int, int, int]]:
    """[(dim, start, size)] of this rank's shard of a tensor of `shape`,
    one for each split dim."""
    coord = mesh.get_coordinate()
    sizes = mesh.shape
    out = []
    for d, dims in _split_dims(placements).items():
        n, c = 1, 0
        for i in dims:
            c = c * sizes[i] + coord[i]
            n *= sizes[i]
        if shape[d] % n:
            raise ValueError(f"dim {d} of size {shape[d]} does not split "
                             f"evenly {n} ways")
        out.append((d, c * (shape[d] // n), shape[d] // n))
    return out


def local_slice(full: torch.Tensor, placements, mesh) -> torch.Tensor:
    """This rank's shard of `full` (a view of it)."""
    out = full
    for d, start, size in slice_bounds(full.shape, placements, mesh):
        out = out.narrow(d, start, size)
    return out


def local_shape(shape, placements, mesh) -> Tuple[int, ...]:
    """The shape of a rank's shard of a tensor of `shape`."""
    shape = list(shape)
    for d, dims in _split_dims(placements).items():
        for i in dims:
            shape[d] //= mesh.shape[i]
    return tuple(shape)


def as_dtensor(local: torch.Tensor, sharding):
    """A DTensor over `local`'s storage with the sharding's placements."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, sharding.mesh, sharding.placements,
                              run_check=False)


def shard(full: torch.Tensor, sharding):
    """This rank's shard of `full`, copied, as a DTensor."""
    return as_dtensor(local_slice(full, sharding.placements,
                                  sharding.mesh).clone(), sharding)


def _gather_dim(x: torch.Tensor, d: int, group, n: int) -> torch.Tensor:
    """all_gather_into_tensor of x over `group` (n ranks), the rank shards
    concatenated along dim d in group-rank order."""
    src = x.movedim(d, 0).contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    _count("all_gather", out)
    return out.movedim(0, d)


def gather_full(dt, out: torch.Tensor = None) -> torch.Tensor:
    """The full tensor of DTensor `dt` from every rank's shard, gathered
    over one mesh dim at a time, the innermost first; into `out` when
    given.  Every rank of the mesh calls this for the same leaf."""
    mesh, placements = dt.device_mesh, dt.placements
    x, gathered = dt.to_local(), False
    for i in reversed(range(mesh.ndim)):
        pl = placements[i]
        if pl.is_shard():
            x = _gather_dim(x, pl.dim, mesh.get_group(i), mesh.shape[i])
            gathered = True
    if out is None:
        return x.contiguous() if gathered else x.clone()
    out.copy_(x)
    return out


def all_reduce_sum(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """t summed, in place, over the mesh axes `axes` (a name or a tuple
    of names; None or () is no reduction)."""
    if axes is None:
        return t
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        if mesh.shape[mesh.mesh_dim_names.index(a)] > 1:
            dist.all_reduce(t, group=mesh.get_group(a))
            _count("all_reduce", t)
    return t


def broadcast_world(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """t from rank `src` of the default group to every rank, in place."""
    dist.broadcast(t, src=src)
    _count("broadcast", t)
    return t
