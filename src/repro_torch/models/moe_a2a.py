"""Expert-parallel MoE dispatch with an explicit all-to-all - the JAX
package's models/moe_a2a.py on a torch.distributed process group.

Each of the group's `tp` ranks holds a slice of the tokens, the router
(replicated) and E / tp experts (its slice of every experts_* leaf along
the expert axis), and calls moe_ffn_a2a_local with its own slices:

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

The JAX package's make_sharded_moe places the shards with shard_map over
a mesh axis, and its moe_ffn takes this path behind an environment switch
when a mesh with a model axis is active; the port's only mesh so far is
the serve mesh of tensor-parallel serving (launch/mesh.py), so a caller
slices the tokens and experts and passes its group (ROADMAP §1 item 3).  Every shape is fixed by the inputs and the config; the group's
collectives are the only synchronisation.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.distributed as dist

from ..configs.base import ModelConfig
from .moe import _one_hot, experts, route


def _positions_within(groups: torch.Tensor, n_groups: int) -> torch.Tensor:
    """Slot index of each element of groups (N,) within its group, in
    first-come order."""
    counts = torch.cumsum(_one_hot(groups, n_groups, torch.int32), 0)
    return torch.gather(counts, 1, groups[:, None])[:, 0] - 1


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Block i of t (tp, ...) to rank i; block i of the result from rank
    i (jax.lax.all_to_all over axis 0, tiled=False)."""
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t.contiguous(), group=group)
    return out


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
    dist.all_reduce(stats, group=group)
    stats = stats / tp
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
    recv_x = _all_to_all(send_x[:, :c_pair], group).reshape(tp * c_pair, D)
    recv_le = _all_to_all(send_le[:, :c_pair], group).reshape(tp * c_pair)

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
    back = _all_to_all(reply, group)
    back_pad = torch.cat([back, back.new_zeros((tp, 1, D))], 1)
    contrib = back_pad.reshape(-1, D)[at] * torch.where(
        keep, flat_g, 0.0)[:, None].to(x_local.dtype)
    y = torch.zeros((T, D), dtype=torch.float32, device=dev).index_add(
        0, rows, contrib.float())
    return y.reshape(B, S_l, D).to(x_local.dtype), aux
