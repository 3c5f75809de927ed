"""Expert-parallel MoE dispatch with an explicit all-to-all - the JAX
package's models/moe_a2a.py on torch.distributed process groups.

Each of the model axis's `tp` ranks holds a slice of the tokens, the
router (replicated) and E / tp experts (its slice of every experts_* leaf
along the expert axis), and calls moe_ffn_a2a_local with its own slices:

  1. route the local tokens; the destination rank of a (token, k) pair is
     its expert // (E / tp)
  2. compact the pairs per destination (running count, pair capacity
     c_pair; a pair past it is dropped)
  3. all_to_all_single the (tp, c_pair, d) rows and their local expert ids
  4. the receiver dispatches them into its (E / tp, c_loc, d) expert
     slots (a row past c_loc is dropped), runs its experts, and puts each
     reply back in the row's receive slot
  5. all_to_all_single back; the sender gathers each pair's reply from
     the (destination, slot) it recorded, scales it by the gate and sums
     the K replies of a token in float32

The aux loss takes the mean router statistics over the group (the JAX
pmean: an all_reduce divided by the group size), so every rank returns
the same aux.  The expert products upcast both operands to float32, as
the JAX function does on every backend.  With the default capacity
factors both capacities are at least the per-row capacity of models/
moe.py, so at moderate imbalance the two agree.

Gradients flow through the exchange as jax.grad's through lax.all_to_all
and lax.pmean: the all_to_all's backward is the reverse all_to_all over
the same group (_AllToAll), and the statistics' all_reduce passes its
gradient through unchanged (_SumStats) - every rank holds the one global
aux, and each rank's backward of it gives the gradient through its own
tokens' probabilities, so the ranks' router gradients sum to the aux's
gradient once.  The expert and router gradients are thus partial on each
rank (its E / tp experts, its tokens' routing): the mesh train step sums
them over the model axis (train/train_step.py).

make_sharded_moe is the counterpart of the JAX shard_map placement on a
DeviceMesh: tokens split along the sequence over the model axis, experts
over the model axis, the router replicated.  The JAX in_specs replicate
the batch over the data axes, so a rank whose rows are split over them
gathers every row first (_RowGather), routes and exchanges the global
batch - its capacities, slot order and statistics those of the global
batch - and keeps its own rows of the output.  sharded_moe_ffn runs it on
the whole sequence every model rank holds, as models/moe.py moe_ffn's
REPRO_MOE_A2A switch does inside the mesh steps.  Every shape is fixed by
the inputs and the config; the groups' collectives are the only
synchronisation, and each is counted in sharding/shards.py COMM.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.distributed as dist

from ..configs.base import ModelConfig
from ..sharding.shards import _count, _gather_dim, all_reduce_sum
from .moe import _one_hot, experts, route


def _positions_within(groups: torch.Tensor, n_groups: int) -> torch.Tensor:
    """Slot index of each element of groups (N,) within its group, in
    first-come order."""
    counts = torch.cumsum(_one_hot(groups, n_groups, torch.int32), 0)
    return torch.gather(counts, 1, groups[:, None])[:, 0] - 1


def _exchange(t: torch.Tensor, group) -> torch.Tensor:
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t.contiguous(), group=group)
    _count("all_to_all", out)
    return out


class _AllToAll(torch.autograd.Function):
    """Block i of t (tp, ...) to rank i; block i of the result from rank
    i (jax.lax.all_to_all over axis 0, tiled=False).  Its transpose is
    the same exchange of the gradient's blocks, over the same group."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _exchange(t, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


class _SumStats(torch.autograd.Function):
    """The sum of t over the group; the gradient passes through as it
    comes (see the module docstring)."""

    @staticmethod
    def forward(ctx, t, group):
        out = t.clone()
        dist.all_reduce(out, group=group)
        _count("all_reduce", out)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _RowGather(torch.autograd.Function):
    """Forward: every rank's rows (axis 0) of mesh axis `axis`, gathered
    in coordinate order.  Backward: the gradient summed over the axis's
    ranks (each rank's loss reaches every row through the statistics),
    and this rank's rows of it."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis, ctx.rows = mesh, axis, t.shape[0]
        ctx.coord = mesh.get_local_rank(axis)
        n = mesh.shape[mesh.mesh_dim_names.index(axis)]
        return _gather_dim(t, 0, mesh.get_group(axis), n)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_sum(g.contiguous().clone(), ctx.mesh, ctx.axis)
        return g.narrow(0, ctx.coord * ctx.rows, ctx.rows), None, None


class _SeqSplit(torch.autograd.Function):
    """Forward: this rank's block of the sequence (axis 1) of a tensor
    every rank of the model axis holds whole and equal.  Backward: every
    rank's block of the gradient gathered, so each holds the whole one
    (ops._HeadSplit along the sequence)."""

    @staticmethod
    def forward(ctx, t, tp_mesh):
        ctx.tp_mesh = tp_mesh
        n = t.shape[1] // tp_mesh.size
        return t[:, tp_mesh.rank * n:(tp_mesh.rank + 1) * n].contiguous()

    @staticmethod
    def backward(ctx, g):
        tp = ctx.tp_mesh
        return _gather_dim(g, 1, tp.group, tp.size), None


class _SeqGather(torch.autograd.Function):
    """Forward: every rank's sequence block gathered in rank order.
    Backward: this rank's block of the gradient, which every rank of the
    axis holds whole and equal (ops._HeadGather along the sequence)."""

    @staticmethod
    def forward(ctx, t, tp_mesh):
        ctx.lo, ctx.n = tp_mesh.rank * t.shape[1], t.shape[1]
        return _gather_dim(t, 1, tp_mesh.group, tp_mesh.size)

    @staticmethod
    def backward(ctx, g):
        return g[:, ctx.lo:ctx.lo + ctx.n].contiguous(), None


def moe_ffn_a2a_local(params, x_local: torch.Tensor, cfg: ModelConfig,
                      group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's part of the expert-parallel MoE FFN (see the module
    docstring).  x_local (B, S_local, d): the rank's token slice; params:
    the router, and the rank's E / tp experts of each experts_* leaf;
    group: the process group (the default group when None).  Returns
    (y_local (B, S_local, d) in x_local's dtype, the float32 aux loss)."""
    B, S_l, D = x_local.shape
    E, K = cfg.moe_experts, cfg.moe_top_k
    tp = dist.get_world_size(group)
    e_loc = E // tp
    dev = x_local.device

    # ---- 1. routing --------------------------------------------------
    xt = x_local.reshape(B * S_l, D)
    probs, gate_vals, top_idx = route(params, xt, cfg)          # (T, K)
    stats = torch.stack([torch.mean(probs, 0), torch.mean(torch.sum(
        _one_hot(top_idx, E, torch.float32), 1), 0)])
    stats = _SumStats.apply(stats, group) / tp
    aux = E * torch.sum(stats[0] * stats[1]) / K

    T = B * S_l
    rows = torch.arange(T, device=dev)[:, None].expand(T, K).reshape(-1)
    flat_e = top_idx.reshape(-1)
    flat_g = gate_vals.reshape(-1)
    dst = flat_e // e_loc                                       # rank
    loc_e = flat_e % e_loc                                      # expert there

    # ---- 2. compact per destination (pair capacity) ------------------
    c_pair = int(math.ceil(T * K / tp * cfg.moe_capacity_factor))
    slot = _positions_within(dst, tp)
    keep = slot < c_pair
    slot = torch.where(keep, slot, c_pair)                      # c_pair: drop
    at = dst * (c_pair + 1) + slot
    send_x = x_local.new_zeros((tp * (c_pair + 1), D)).index_copy(
        0, at, xt[rows]).view(tp, c_pair + 1, D)
    send_le = torch.full((tp * (c_pair + 1),), e_loc, dtype=torch.int64,
                         device=dev).index_copy(0, at, loc_e).view(
                             tp, c_pair + 1)             # e_loc: inert

    # ---- 3. all-to-all -------------------------------------------------
    recv_x = _AllToAll.apply(send_x[:, :c_pair], group).reshape(
        tp * c_pair, D)
    recv_le = _exchange(send_le[:, :c_pair], group).reshape(tp * c_pair)

    # ---- 4. local expert dispatch and compute ---------------------------
    c_loc = int(math.ceil(tp * c_pair / e_loc * cfg.moe_capacity_factor))
    eslot = _positions_within(recv_le, e_loc + 1)       # +1: the inert group
    real = recv_le < e_loc
    ekeep = (eslot < c_loc) & real
    eslot = torch.where(ekeep, eslot, c_loc)
    le_safe = torch.where(real, recv_le, 0)
    buf = x_local.new_zeros((e_loc * (c_loc + 1), D)).index_add(
        0, torch.where(ekeep, le_safe, 0) * (c_loc + 1) + eslot,
        torch.where(ekeep[:, None], recv_x, 0))
    ein = buf.view(e_loc, c_loc + 1, D)[:, :c_loc]
    # float32 throughout, the hidden layer unrounded (moe.experts on
    # float32 operands)
    out = experts({k: v.float() for k, v in params.items()
                   if k.startswith("experts")}, ein.float(),
                  cfg).to(x_local.dtype)
    out_pad = torch.cat([out, out.new_zeros((e_loc, 1, D))], 1)
    reply = torch.where(ekeep[:, None],
                        out_pad.reshape(-1, D)[le_safe * (c_loc + 1) + eslot],
                        0).reshape(tp, c_pair, D)

    # ---- 5. all-to-all back and the sender's combine -----------------
    back = _AllToAll.apply(reply, group)
    back_pad = torch.cat([back, back.new_zeros((tp, 1, D))], 1)
    contrib = back_pad.reshape(-1, D)[at] * torch.where(
        keep, flat_g, 0.0)[:, None].to(x_local.dtype)
    y = torch.zeros((T, D), dtype=torch.float32, device=dev).index_add(
        0, rows, contrib.float())
    return y.reshape(B, S_l, D).to(x_local.dtype), aux


def local_experts(params, rank: int, tp: int):
    """The router, and model rank `rank`'s E / tp slice of each experts_*
    leaf (a view: its gradient lands in that slice of the leaf's)."""
    out = {}
    for k, v in params.items():
        if k.startswith("experts"):
            n = v.shape[0] // tp
            v = v[rank * n:(rank + 1) * n]
        out[k] = v
    return out


def make_sharded_moe(cfg: ModelConfig, mesh, *, axis: str = "model",
                     row_axes=None):
    """The expert-parallel MoE FFN on a DeviceMesh (the JAX shard_map
    placement): fn(params, x_local) -> (y_local, aux).  params: the router
    and this rank's E / tp slice of each experts_* leaf (local_experts);
    x_local (B, S_local, d): this rank's rows and its S / tp positions of
    the sequence.  row_axes: the mesh axes the rows are split over, outer
    first (default the data-parallel axes): the rows are gathered over
    them before the exchange, and y_local is this rank's rows again.  aux
    is the aux loss of the global batch, the same on every rank."""
    from ..sharding.rules import axis_names, dp_axes
    if row_axes is None:
        row_axes = dp_axes(axis_names(mesh)) or ()
    row_axes = tuple(row_axes)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    group = mesh.get_group(axis)

    def fn(params, x_local):
        B = x_local.shape[0]
        x, c = x_local, 0
        for a in reversed(row_axes):           # innermost first
            x = _RowGather.apply(x, mesh, a)
        for a in row_axes:
            c = c * sizes[a] + mesh.get_local_rank(a)
        y, aux = moe_ffn_a2a_local(params, x, cfg, group=group)
        return y[c * B:(c + 1) * B], aux

    return fn


def sharded_moe_ffn(params, x: torch.Tensor, cfg: ModelConfig, mesh,
                    row_axes=()) -> Tuple[torch.Tensor, torch.Tensor]:
    """The expert-parallel FFN over x (B, S, d), the whole sequence every
    rank of the mesh's model axis holds, and the whole params: this rank's
    S / tp positions and E / tp experts through make_sharded_moe, the
    output gathered back over the sequence.  Returns (y (B, S, d), the
    global aux)."""
    from ..launch.mesh import axis_mesh
    tp = axis_mesh(mesh, "model")
    fn = make_sharded_moe(cfg, mesh, row_axes=row_axes)
    y, aux = fn(local_experts(params, tp.rank, tp.size),
                _SeqSplit.apply(x, tp))
    return _SeqGather.apply(y, tp), aux
