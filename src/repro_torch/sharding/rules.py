"""Logical-axis sharding rules: the JAX package's sharding/rules.py for
torch.distributed's DeviceMesh and DTensor placements.

Mesh axes, as in the JAX package:
  pod    - pure data parallelism across pods (params replicated per pod)
  data   - data parallelism + FSDP weight sharding
  model  - tensor parallelism (heads / d_ff / vocab) + expert parallelism

A spec is the PartitionSpec counterpart: a tuple with one entry a tensor
dim, each None (replicated), an axis name, or a tuple of names (the dim
split over those axes, the first the outermost).  P(...) builds one and,
as jax.sharding.PartitionSpec does, writes a one-name tuple as the name,
so the port's specs compare equal to tuple(jax_spec).  The rules take the
mesh's axis names, never an implicit mesh: the port has no mesh in scope.
placements(spec, mesh) turns a spec into DTensor placements, one a mesh
dim: Shard(d) on every mesh dim the entry of tensor dim d names, the rest
Replicate().  An entry ("pod", "data") becomes Shard(d) on both, and
DTensor splits a dim sharded on several mesh dims in mesh-dim order, pod
outermost, as JAX tiles P(("pod", "data")).
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Tuple

from ..tree import leaves_with_paths, map_with_paths


def P(*entries) -> tuple:
    """A spec: the entries as given, a one-name tuple written as the
    name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def axis_names(mesh) -> Tuple[str, ...]:
    """A DeviceMesh's axis names (mesh_dim_names); () for no mesh."""
    return tuple(mesh.mesh_dim_names) if mesh is not None else ()


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a DeviceMesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def entry_axes(entry) -> Tuple[str, ...]:
    """The axis names of one spec entry."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def dp_axes(names: Tuple[str, ...] = ()):
    ax = tuple(a for a in ("pod", "data") if a in names)
    return ax if ax else None


def tp_axis(names: Tuple[str, ...] = ()):
    return "model" if "model" in names else None


def constrain(x, logical: str):
    """The identity, with a mesh or without.  The JAX package's constrain
    hands XLA a layout for an activation and lets the partitioner move
    data; the port moves data only where its code says so - the sharded
    train step's gathers and reductions (train/train_step.py) and the
    attention's head split (kernels/ops.py head_sharded_attention) - so
    there is nothing to constrain.  Kept for code written against the JAX
    package's name."""
    return x


# --------------------------------------------------------------------------
# Parameter sharding rules (path regex -> spec rule), the JAX package's
# --------------------------------------------------------------------------
# Param layouts (all may carry a leading stacked-layer axis, detected by
# ndim mismatch and padded with None):
#   embed        (V, D)        vocab over model, D over data (FSDP)
#   lm_head      (V, D)
#   wq/wk/wv     (D, N)        D over data, N (heads*hd) over model
#   wo           (N, D)
#   mlp in/gate  (D, F)
#   mlp out      (F, D)
#   router       (D, E)        replicated E
#   experts_in   (E, D, F)     experts over model (EP), D over data
#   experts_out  (E, F, D)
#   ssm in/out   (D, X) / (X, D)
#   norms, biases, small vectors: replicated

_PARAM_RULES = [
    (r"(embed|lm_head|cls_head)$", lambda dp, tp: P(tp, dp)),
    (r"(wq|wk|wv|w_in|w_gate|in_proj|router_dense|r_proj|k_proj|v_proj|g_proj|w_proj)$",
     lambda dp, tp: P(dp, tp)),
    (r"(wo|w_out|out_proj)$", lambda dp, tp: P(tp, dp)),
    (r"(experts_in|experts_gate)$", lambda dp, tp: P(tp, dp, None)),
    (r"(experts_out)$", lambda dp, tp: P(tp, None, dp)),
    (r"(router)$", lambda dp, tp: P(dp, None)),
    (r"(conv_w)$", lambda dp, tp: P(None, tp)),
    (r"(pos_embed)$", lambda dp, tp: P(None, dp)),
]


def param_spec(path: str, ndim: int, names: Tuple[str, ...]) -> tuple:
    """Resolve the spec for a parameter by its tree path."""
    dp = dp_axes(names)
    tp = tp_axis(names)
    leaf = path.split("/")[-1]
    for pat, rule in _PARAM_RULES:
        if re.search(pat, leaf):
            spec = rule(dp, tp)
            base = len(spec)
            if ndim > base:
                # leading stacked-layer axes -> replicated
                spec = P(*([None] * (ndim - base) + list(spec)))
            elif ndim < base:
                return P()        # degenerate (e.g. smoke configs)
            return spec
    return P()                    # norms / scalars / biases: replicated


def tree_paths(tree):
    """(path, leaf) pairs with '/'-joined key paths, in the JAX package's
    flatten order (repro_torch/tree.py)."""
    return leaves_with_paths(tree)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the jax.sharding.NamedSharding counterpart."""
    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def placements(spec: tuple, mesh) -> tuple:
    """The DTensor placements of `spec` on `mesh`: for each mesh dim,
    Shard(d) if tensor dim d's entry names its axis, else Replicate().
    An entry naming its axes out of mesh order has no DTensor placement
    (DTensor splits in mesh-dim order) and raises."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        idx = [names.index(a) for a in entry_axes(entry)]
        if idx != sorted(idx) or len(set(idx)) != len(idx):
            raise ValueError(f"spec entry {entry!r} of dim {d} does not name "
                             f"its axes in the mesh's order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {names[i]!r} shards two dims "
                                 f"of spec {spec}")
            out[i] = Shard(d)
    return tuple(out)


def param_sharding_tree(params, mesh):
    """NamedSharding tree matching `params` for the given mesh."""
    names = axis_names(mesh)
    return map_with_paths(
        lambda path, leaf: NamedSharding(
            mesh, param_spec(path, getattr(leaf, "ndim", 0), names)),
        params)


def cache_spec(names: Tuple[str, ...], *, seq_sharded: bool,
               seq_axis: str = "data") -> tuple:
    """KV cache (L, B, S, H_kv, D).

    - default: batch over DP, KV heads over TP
    - seq_sharded + seq_axis="data": batch=1 long-context decode - shard the
      SEQUENCE over the data axis (sequence-parallel KV)
    - seq_sharded + seq_axis="model": KV head count does not divide the
      model axis - shard the sequence there instead of replicating the
      cache across it."""
    dp = dp_axes(names)
    tp = tp_axis(names)
    if seq_sharded and seq_axis == "data":
        return P(None, None, "data" if "data" in names else None, tp, None)
    if seq_sharded:
        return P(None, dp, tp, None, None)
    return P(None, dp, None, tp, None)


def spec_axis_size(mesh, entry) -> int:
    """How many ways an entry splits its dim on `mesh`."""
    sizes = axis_sizes(mesh)
    n = 1
    for a in entry_axes(entry):
        n *= sizes[a]
    return n

