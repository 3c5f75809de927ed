"""Mixture-of-Experts FFN: top-k routing and capacity-based dispatch - the
JAX package's models/moe.py as plain functions on tensors.

Parameters (one layer, JAX layout): router (d, E) in float32, as the JAX
init keeps it; experts_in and experts_gate (E, d, d_ff) and experts_out
(E, d_ff, d) in the config's dtype.

Dispatch is per batch row, as in the JAX package: the capacity C =
ceil(S K / E x capacity_factor) follows the call's own sequence length S,
each (token, k) pair takes its slot in its expert from a cumulative count
along the row in (token, k) order, and a pair past C is dropped.  So a
served token's output depends on how the engine cut its prompt into
chunks, in both packages (ROADMAP §3).  The experts run as batched
products over every expert's C slots of every row, empty slots included,
so a call reads every expert's weights.  The buffer holds the E x B x C
slots expert-major, (E, B C, d), plus one row that takes every dropped
pair: each expert's slots are one contiguous (B C, d) operand, and the
gather back reads the dropped pairs from that row after it was zeroed,
as the JAX package reads its padded drop slot.

Every shape is fixed by (B, S) and the config: no nonzero, no boolean
indexing, no one_hot (whose range check reads the device on CUDA), no
.item(), so a served MoE layer adds no host synchronisation.  The expert
products accumulate in float32 on the operands' own values: on the CPU
both operands are upcast, as the JAX package's mixed_einsum does there;
on CUDA a bfloat16 product runs as torch.bmm(..., out_dtype=float32) on
the bfloat16 operands (the JAX dot with preferred_element_type=float32),
without float32 copies of the expert weights, and so does its backward
(_MixedBmm).

On a mesh (moe_ffn's mesh=, an MoEMesh from the mesh steps), the FFN
takes one of two paths, as the JAX package's moe_ffn does.  With the
environment switch REPRO_MOE_A2A set, a model axis of tp > 1 ranks, E %
tp == 0 and S % tp == 0 (a2a_active), the expert-parallel exchange of
models/moe_a2a.py (sharded_moe_ffn); otherwise the per-row dispatch on
the rank's rows, which equals one device's.  Decode (S = 1) never takes
the switch.  A training mesh step's loss is each data-parallel rank's
share of the global loss (models/model.py Model.loss, dp_sum): the aux
loss, a product of batch means, becomes a share too - E / K x sum(me_share
x ce_global), me_share the rank's probability sum over the global token
count and ce_global the assignments summed over the data ranks with no
gradient - so the shares sum to the global aux and their gradients to its
gradient.  On the exchange the statistics are already the global batch's,
and the share is the global aux over the number of data ranks.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig

# leaves the JAX init keeps in float32
FP32_LEAVES = ("router",)


def moe_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """Leaf shapes of one layer (moe_init's tree)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe_experts
    shapes = {"router": (d, e), "experts_in": (e, d, f),
              "experts_out": (e, f, d)}
    if cfg.act == "silu":
        shapes["experts_gate"] = (e, d, f)
    return shapes


def moe_stds(cfg: ModelConfig) -> Dict[str, float]:
    """moe_init's standard deviation of each leaf: 1 / sqrt(d) for the
    router and the input projections, 1 / sqrt(d_ff) for the output."""
    d_in, f_in = 1.0 / math.sqrt(cfg.d_model), 1.0 / math.sqrt(cfg.d_ff)
    return {"router": d_in, "experts_in": d_in, "experts_gate": d_in,
            "experts_out": f_in}


def capacity(S: int, cfg: ModelConfig) -> int:
    """Slots per expert per batch row for a call of sequence length S."""
    return int(math.ceil(S * cfg.moe_top_k / cfg.moe_experts
                         * cfg.moe_capacity_factor))


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """idx (...) -> (..., n): a comparison against arange, with no range
    check (F.one_hot's reads the device)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def route(params, x: torch.Tensor, cfg: ModelConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The float32 router over x (..., d): (probs (..., E), gate_vals
    (..., K) renormalised over the top K, top_idx (..., K) int64).  The
    top K come from a stable descending sort, so among equal
    probabilities the lower expert comes first, as jax.lax.top_k orders
    them (torch.topk leaves that order unspecified on CUDA)."""
    K = cfg.moe_top_k
    probs = torch.softmax(torch.matmul(x.float(), params["router"]), -1)
    vals, idx = torch.sort(probs, stable=True, dim=-1, descending=True)
    gate_vals, top_idx = vals[..., :K], idx[..., :K]
    gate_vals = gate_vals / torch.clamp_min(
        torch.sum(gate_vals, -1, keepdim=True), 1e-9)
    return probs, gate_vals, top_idx


@dataclass(frozen=True)
class MoEMesh:
    """Where a mesh step runs the MoE FFN: the DeviceMesh (None: no
    exchange), the mesh axes the batch rows are split over, outer first
    (the exchange gathers them), and the training loss's dp_sum (None:
    the aux loss of the rows alone)."""
    mesh: Any = None
    row_axes: Tuple[str, ...] = ()
    dp_sum: Optional[Callable] = None


def a2a_active(cfg: ModelConfig, mesh, S: int) -> bool:
    """Whether moe_ffn over a sequence of S takes the expert-parallel
    exchange on `mesh` (a DeviceMesh or None): the JAX package's three
    conditions behind REPRO_MOE_A2A."""
    if not os.environ.get("REPRO_MOE_A2A") or not cfg.moe_experts \
            or mesh is None or "model" not in tuple(mesh.mesh_dim_names):
        return False
    tp = mesh.shape[mesh.mesh_dim_names.index("model")]
    return tp > 1 and cfg.moe_experts % tp == 0 and S % tp == 0


def aux_loss(probs: torch.Tensor, top_idx: torch.Tensor,
             cfg: ModelConfig, dp_sum=None) -> torch.Tensor:
    """The Switch load-balancing loss over probs (B, S, E) and top_idx
    (B, S, K): E x sum(mean prob x mean assignments) / K, float32.  With
    dp_sum (the rows are this rank's of a batch split over data-parallel
    ranks), this rank's share of the global loss (the module
    docstring)."""
    E, K = cfg.moe_experts, cfg.moe_top_k
    counts = torch.sum(_one_hot(top_idx, E, torch.float32), 2)
    if dp_sum is None:
        return E * torch.sum(torch.mean(probs, (0, 1))
                             * torch.mean(counts, (0, 1))) / K
    tot = dp_sum(torch.cat([torch.sum(counts, (0, 1)), counts.new_full(
        (1,), float(counts.shape[0] * counts.shape[1]))]))
    return E * torch.sum(torch.sum(probs, (0, 1)) / tot[E]
                         * (tot[:E] / tot[E])) / K


class _MixedBmm(torch.autograd.Function):
    """torch.bmm(a, w, out_dtype=float32) on bfloat16 operands, which
    autograd has no formula for.  Backward: the float32 gradient rounded
    to the operands' dtype - the JAX package's grad_cast puts the expert
    products' cotangents in the primal dtype - then the two transposed
    products, each accumulated in float32 and rounded to its operand's
    dtype, as JAX transposes a dot with preferred_element_type."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        return torch.bmm(a, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        g = g.to(a.dtype)
        da = torch.bmm(g, w.transpose(1, 2), out_dtype=torch.float32)
        dw = torch.bmm(a.transpose(1, 2), g, out_dtype=torch.float32)
        return da.to(a.dtype), dw.to(w.dtype)


def _edot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(E, N, d_in) x (E, d_in, d_out) -> (E, N, d_out) float32 (see the
    module docstring)."""
    if a.device.type == "cpu":
        return torch.bmm(a.float(), w.float())
    if a.dtype == torch.float32 and w.dtype == torch.float32:
        return torch.bmm(a, w)
    return _MixedBmm.apply(a, w)


def experts(params, ein: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The gated MLP of every expert over its slots ein (E, N, d), in
    ein's dtype: the hidden layer in float32, rounded to ein's dtype
    before the output product."""
    h = _edot(ein, params["experts_in"])
    if cfg.act == "silu":
        h = F.silu(_edot(ein, params["experts_gate"])) * h
    else:
        # JAX's gelu default is the tanh approximation
        h = F.gelu(h, approximate="tanh")
    return _edot(h.to(ein.dtype), params["experts_out"]).to(ein.dtype)


def dispatch(params, x: torch.Tensor, gate_vals: torch.Tensor,
             top_idx: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The experts over x (B, S, d) routed by (gate_vals, top_idx) (B, S,
    K): per-row capacity slots, the experts, the gates folded into the
    expert outputs, each token's K outputs gathered and summed in x's
    dtype.  Returns (B, S, d)."""
    B, S, D = x.shape
    E, K = cfg.moe_experts, cfg.moe_top_k
    C = capacity(S, cfg)
    dev = x.device
    flat_e = top_idx.reshape(B, S * K)
    # slot of each (token, k) pair in its expert: the in-row running count
    pos = torch.gather(torch.cumsum(_one_hot(flat_e, E, torch.int32), 1),
                       2, flat_e[..., None])[..., 0] - 1
    keep = pos < C
    rows = torch.arange(B, device=dev)[:, None]
    dump = E * B * C                      # the row of every dropped pair
    slot = torch.where(keep, (flat_e * B + rows) * C + pos, dump).reshape(-1)
    xk = x[:, :, None].expand(B, S, K, D).reshape(B * S * K, D)
    buf = x.new_zeros((dump + 1, D)).index_add(0, slot, xk)
    out = experts(params, buf[:dump].view(E, B * C, D), cfg)
    gates = torch.where(keep, gate_vals.reshape(B, S * K), 0.0).reshape(-1)
    gate_buf = gates.new_zeros(dump + 1).index_add(0, slot, gates)
    out = out * gate_buf[:dump].view(E, B * C, 1).to(out.dtype)
    out = torch.cat([out.reshape(dump, D), out.new_zeros((1, D))])
    return torch.sum(torch.index_select(out, 0, slot).view(B, S, K, D), 2)


def moe_ffn(params, x: torch.Tensor, cfg: ModelConfig,
            mesh: Optional[MoEMesh] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> ((B, S, d) in x's dtype, the float32 aux loss).
    mesh: the mesh step's MoEMesh (the module docstring) - the exchange
    where a2a_active, the aux loss as this rank's share under its
    dp_sum."""
    mesh = mesh or MoEMesh()
    if a2a_active(cfg, mesh.mesh, x.shape[1]):
        from .moe_a2a import sharded_moe_ffn
        y, aux = sharded_moe_ffn(params, x, cfg, mesh.mesh, mesh.row_axes)
        if mesh.dp_sum is not None:
            sizes = dict(zip(mesh.mesh.mesh_dim_names, mesh.mesh.shape))
            aux = aux / math.prod(sizes[a] for a in mesh.row_axes)
        return y, aux
    probs, gate_vals, top_idx = route(params, x, cfg)
    return dispatch(params, x, gate_vals, top_idx, cfg), \
        aux_loss(probs, top_idx, cfg, mesh.dp_sum)
