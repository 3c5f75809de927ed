"""The meshes of the port on torch.distributed: the JAX package's
launch/mesh.py.

make_production_mesh and make_debug_mesh (training) return a
torch.distributed.device_mesh.DeviceMesh over the initialised world with
the JAX axis names and shapes: (16, 16) ("data", "model") for one pod,
(2, 16, 16) ("pod", "data", "model") across two, (n_data, n_model)
("data", "model") for the debug mesh.  Rank r sits at the row-major
coordinate of r, so each mesh dim's group lists its ranks in coordinate
order.  One process per rank (PyTorch's idiom, torchrun): the world's
size must be the mesh's, or they raise ValueError saying how to launch
it - they never build a smaller mesh.  The device type is the caller's,
"cuda" by default; DTensors on the mesh hold tensors of that type.

make_serve_mesh (tensor-parallel serving, M10): every rank of a tp_degree group
runs the same ServeEngine, and the mesh is the process group its head-
sharded attention gathers over.  The group spans ranks [0, tp_degree) of
the default group - the JAX "first tp_degree devices" - and is built once
per degree, so the replicas of one degree in a fleet share it, as the JAX
replicas share the first N devices.

axis_mesh views one axis of a DeviceMesh as a ServeMesh (its group, this
rank's coordinate on it, its size): what the head-sharded attention and
the sequence-parallel decode of the mesh steps gather over.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class ServeMesh:
    """A serving mesh: the process group of the tp ranks (None at size 1),
    this process's rank in it and the group's size (the tp degree)."""
    group: Any
    rank: int
    size: int


def axis_mesh(mesh, name: str):
    """Axis `name` of a DeviceMesh as a ServeMesh (its process group, this
    rank's coordinate on it, its size); None when the mesh has no such
    axis or it has size 1."""
    if name not in tuple(mesh.mesh_dim_names):
        return None
    i = mesh.mesh_dim_names.index(name)
    if mesh.shape[i] == 1:
        return None
    return ServeMesh(mesh.get_group(name), mesh.get_local_rank(name),
                     mesh.shape[i])


# the families the mesh steps take: every family the port registers
MESH_FAMILIES = ("dense", "moe", "vlm", "audio", "hybrid", "ssm")


def check_mesh_family(cfg, what: str) -> None:
    """The mesh steps (training, prefill, decode) take every family: the
    dense and vlm decoders (the vlm family's image ahead of its text
    rows), the MoE FFN by the per-row dispatch on the rank's rows or the
    REPRO_MOE_A2A exchange (models/moe.py), whisper's encoder and cross-
    attention on the rank's head shard (its cross strips in the cache's
    layout), zamba2's Mamba2 layers and rwkv6's time-mix replicated over
    the model axis with only their state leaves split (zamba2's shared
    block on the head shard; their scans' backward kernels on every
    rank).  A family outside MESH_FAMILIES raises NotImplementedError."""
    if cfg.family not in MESH_FAMILIES:
        raise NotImplementedError(
            f"{what} {cfg.name} (family {cfg.family!r}) on a mesh: the "
            f"mesh steps take the {', '.join(MESH_FAMILIES[:-1])} and "
            f"{MESH_FAMILIES[-1]} families")


# the default group the groups below belong to, and one group per degree
_WORLD: Dict[str, Any] = {"pg": None}
_GROUPS: Dict[int, Any] = {}


def make_serve_mesh(tp_degree: int) -> ServeMesh:
    """The serve mesh of `tp_degree` ranks.  tp_degree 1 needs no process
    group.  Otherwise torch.distributed must be initialised with a world of
    at least tp_degree ranks: every rank of the world calls this (building
    a group is collective), in the same order, and a rank outside [0,
    tp_degree) gets a ValueError after the group exists."""
    if tp_degree < 1:
        raise ValueError(f"tp_degree must be >= 1, got {tp_degree}")
    if tp_degree == 1:
        return ServeMesh(None, 0, 1)
    how = (f"run one process per rank, e.g. torchrun "
           f"--nproc-per-node={tp_degree}, or call "
           f"torch.distributed.init_process_group with world_size="
           f"{tp_degree} first")
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(
            f"tp_degree={tp_degree} needs a torch.distributed process group "
            f"with a world size of at least {tp_degree}, and none is "
            f"initialised ({how})")
    world = dist.get_world_size()
    if world < tp_degree:
        raise ValueError(
            f"tp_degree={tp_degree} needs a world size of at least "
            f"{tp_degree}, the process group has {world} ({how})")
    pg = dist.distributed_c10d._get_default_group()
    if _WORLD["pg"] is not pg:          # a new world: forget the old groups
        _WORLD["pg"] = pg
        _GROUPS.clear()
    if tp_degree not in _GROUPS:
        _GROUPS[tp_degree] = dist.new_group(ranks=list(range(tp_degree)))
    rank = dist.get_rank()
    if rank >= tp_degree:
        raise ValueError(
            f"rank {rank} is outside the tp_degree={tp_degree} serve group "
            f"(ranks 0-{tp_degree - 1} of a world of {world})")
    return ServeMesh(_GROUPS[tp_degree], rank, tp_degree)


def _mesh(shape: Tuple[int, ...], names: Tuple[str, ...], device_type: str):
    from torch.distributed.device_mesh import DeviceMesh
    n = 1
    for s in shape:
        n *= s
    how = (f"run one process per rank, e.g. torchrun --nproc-per-node={n}, "
           f"or call torch.distributed.init_process_group with world_size="
           f"{n} first")
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(f"a {shape} {names} mesh needs a torch.distributed "
                         f"process group of {n} ranks, and none is "
                         f"initialised ({how})")
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"a {shape} {names} mesh needs a world of {n} "
                         f"ranks, the process group has {world} ({how})")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16x16 = 256 chips per pod (data, model); 2x16x16 = 512 chips across
    two pods (pod, data, model)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_debug_mesh(n_data: int = 1, n_model: int = 1, *,
                    device_type: str = "cuda"):
    """An (n_data, n_model) (data, model) mesh over a world of n_data x
    n_model ranks."""
    return _mesh((n_data, n_model), ("data", "model"), device_type)
