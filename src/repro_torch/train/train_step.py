"""Training step: loss -> backward -> clip -> (compress) -> AdamW update -
the JAX package's train/train_step.py in eager PyTorch.

One step runs the same operations in the same order as the JAX step, with
two differences that save memory and change no value: the gradient comes
from loss.backward() into each parameter's .grad, and the clip, the
compression and the AdamW update overwrite the gradients, the parameters,
m, v and the error-feedback buffers in place (optim/).  The state is
returned for symmetry with the JAX step, holding the same tensors.

On a mesh (make_train_step(model, tcfg, mesh=)), the state - params,
AdamW m and v, ef - lives as DTensors with the placements of
launch/specs.py train_cell (init_sharded_train_state), and one step
does, with explicit collectives over the mesh's groups
(sharding/shards.py):
  (a) gathers the full parameters from the shards into the model's own
      full-size tensors (all_gather_into_tensor over each sharded mesh
      dim: ZeRO-3 with one gather of the whole tree a step);
  (b) runs Model.loss and its backward on the rank's rows of the batch
      (every family: launch/mesh.py check_mesh_family), each attention -
      whisper's encoder and cross-attention and zamba2's shared block
      too - on the rank's head shard of the model axis
      (ops.head_sharded_attention: K4 / K5; the Mamba2 and RWKV6 scans
      and their backward kernels replicated over it, as in the JAX
      package), the loss the rank's
      share of the global mean (dp_sum: the position count summed over the
      data-parallel ranks before dividing; an MoE layer's aux loss the
      rank's share too, models/moe.py).  An MoE layer runs the per-row
      dispatch on the rank's rows, or with REPRO_MOE_A2A the expert-
      parallel exchange (models/moe_a2a.py: the rank's sequence block of
      every data rank's rows, its E / tp experts);
  (c) sums the gradients over the data-parallel axes (all_reduce): the
      gradient of the global mean, whole and equal on every rank - but on
      the exchange, where the router's and the experts' gradients are
      partial on each model rank (its experts, its block's routing), and
      those leaves are summed over the model axis too (model_partials);
  (d) clips by the global norm of those whole gradients;
  (e) runs int8 compression on the whole gradients with the whole error-
      feedback buffer gathered (one max-abs scale a leaf, as on one
      device), then keeps this rank's shard of ef;
  (f) runs AdamW on the local shards of the gradients, params, m and v.
The metrics are the global loss (the shares summed), its ce and aux, the
grad norm and the lr, equal on every rank.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from ..configs.base import ModelConfig, TrainConfig
from ..kernels._checks import BACKWARD_HEAD_DIMS
from ..models import moe
from ..models.model import Model
from ..optim import (AdamWState, adamw_init, adamw_update,
                     clip_by_global_norm, compress_grads, cosine_schedule,
                     ef_init)
from ..sharding.rules import axis_names, dp_axes
from ..sharding.shards import (all_reduce_sum, as_dtensor, gather_full,
                               local_shape, local_slice, shard)
from ..tree import leaves, leaves_with_paths, map_tree


def check_backward(cfg: ModelConfig, device) -> None:
    """The backward kernels training needs on the card, refused before a
    model is built or a kernel launched where they do not exist.  On
    CUDA the attention gradient is K5 (kernels/flash_backward.py,
    csrc/flash_backward.cu), with no fallback, and K5 takes the head
    dims BACKWARD_HEAD_DIMS (64, zamba2's 80, 128 and gemma3-4b's 256):
    another head dim raises.  The scans' gradients are their backward
    kernels (csrc/mamba2_scan_bwd.cu, csrc/rwkv6_scan_bwd.cu, through
    kernels/ops.py _Scan), so the hybrid and ssm
    families train on CUDA and cost on the meta device like the rest;
    the ssm family has no attention, so no head dim to check."""
    if torch.device(device).type != "cuda" or cfg.family == "ssm":
        return
    if cfg.head_dim not in BACKWARD_HEAD_DIMS:
        raise NotImplementedError(
            f"training {cfg.name} on cuda needs K5 flash_attention_bwd "
            f"(csrc/flash_backward.cu) at head dim {cfg.head_dim}; K5 "
            f"takes {BACKWARD_HEAD_DIMS}")


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    ef: Any              # error-feedback buffers ({} when compression off)


def trainable(params):
    """Switch requires_grad on for every parameter leaf (the model creates
    them without it, for serving).  Returns params."""
    for p in leaves(params):
        p.requires_grad_(True)
    return params


def init_train_state(model: Model, seed: int, tcfg: TrainConfig
                     ) -> TrainState:
    """The model's own parameters, seeded with Model.init(seed), made
    trainable, with a fresh optimizer state."""
    params = trainable(model.init(seed))
    return TrainState(params=params, opt=adamw_init(params),
                      ef=ef_init(params) if tcfg.grad_compression else {})


def init_sharded_train_state(model: Model, seed: int, tcfg: TrainConfig,
                             shardings: TrainState) -> TrainState:
    """init_train_state on a mesh: the model's own parameters seeded with
    Model.init(seed) on every rank (the same values: the same seed) and
    made trainable - they stay whole, the gather target of each step -
    and a state of DTensors with `shardings` (train_cell's state
    shardings): this rank's shard of each parameter, copied, and m, v and
    ef zeros made at their shard's size."""
    params = trainable(model.init(seed))

    def zeros(t, sh):
        return as_dtensor(torch.zeros(
            local_shape(t.shape, sh.placements, sh.mesh),
            dtype=torch.float32, device=t.device), sh)
    with torch.no_grad():
        return TrainState(
            params=map_tree(lambda t, sh: shard(t.detach(), sh), params,
                            shardings.params),
            opt=AdamWState(
                step=as_dtensor(torch.zeros((), dtype=torch.int32,
                                            device=model.device),
                                shardings.opt.step),
                m=map_tree(zeros, params, shardings.opt.m),
                v=map_tree(zeros, params, shardings.opt.v)),
            ef=map_tree(zeros, params, shardings.ef)
            if tcfg.grad_compression else {})


def _local(tree):
    return map_tree(lambda t: t.to_local(), tree)


def model_partials(full, mesh) -> None:
    """Step (c)'s sum over the model axis of the leaves the MoE exchange
    leaves partial on each model rank: every MoE leaf (the router and the
    experts_*), their .grad summed in place."""
    for path, f in leaves_with_paths(full):
        if "/moe/" in f"/{path}/":
            all_reduce_sum(f.grad, mesh, "model")


def make_mesh_grads(model: Model, tcfg: TrainConfig, mesh):
    """Steps (a)-(c) of the sharded step: grads(state, batch) gathers the
    full parameters into the model's own tensors, runs the loss and its
    backward on this rank's rows and head shard, and sums the gradients
    over the data-parallel axes, and where the MoE exchange ran, the MoE
    leaves over the model axis (model_partials; model_sum=False leaves
    them partial).  Returns (the model's parameter tree, its .grad
    filled: the whole gradient of the global loss, the same on every
    rank; {"loss", "ce", "aux"}: the global values)."""
    remat = tcfg.remat != "none"
    dp = dp_axes(axis_names(mesh))
    from ..launch.mesh import axis_mesh
    tp_mesh = axis_mesh(mesh, "model")
    full = model.params
    dp_sum = lambda t: all_reduce_sum(t, mesh, dp)
    moe_mesh = moe.MoEMesh(mesh, dp or ()) if model.cfg.moe_experts \
        else None

    def grads(state: TrainState, batch: Dict, model_sum: bool = True):
        with torch.no_grad():
            for f, p in zip(leaves(full), leaves(state.params)):
                gather_full(p, out=f)
        for f in leaves(full):
            f.grad = None
        loss, metrics = model.loss(full, batch, remat=remat,
                                   tp_mesh=tp_mesh, dp_sum=dp_sum,
                                   moe_mesh=moe_mesh)
        loss.backward()
        for f in leaves(full):
            if f.grad is None:
                f.grad = torch.zeros_like(f)
            dp_sum(f.grad)
        if model_sum and moe.a2a_active(model.cfg, mesh,
                                        batch["tokens"].shape[1]):
            model_partials(full, mesh)
        out = {"loss": loss.detach(), "ce": metrics["ce"].detach(),
               "aux": metrics["aux"].detach()}
        # the aux of a family without MoE is a zero on every rank
        for k in ("loss", "ce") + (("aux",) if moe_mesh else ()):
            dp_sum(out[k])
        return full, out

    return grads


def _make_mesh_step(model: Model, tcfg: TrainConfig, mesh):
    from torch.distributed.tensor import DTensor

    from ..launch.mesh import check_mesh_family
    grads_of = make_mesh_grads(model, tcfg, mesh)

    def train_step(state: TrainState, batch: Dict
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        check_mesh_family(model.cfg, "training")
        check_backward(model.cfg, model.device)
        full, out = grads_of(state, batch)
        grads = map_tree(lambda f: f.grad, full)
        grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
        if tcfg.grad_compression == "int8":
            with torch.no_grad():
                ef_full = map_tree(gather_full, state.ef)
                grads, ef_full = compress_grads(grads, ef_full)
                for e, ew in zip(leaves(state.ef), leaves(ef_full)):
                    e.to_local().copy_(local_slice(ew, e.placements,
                                                   e.device_mesh))
                del ef_full
        g_local = map_tree(lambda g, p: local_slice(g, p.placements,
                                                    p.device_mesh),
                           grads, state.params)
        step = state.opt.step
        lr = cosine_schedule(step.to_local(), base_lr=tcfg.learning_rate,
                             warmup=tcfg.warmup_steps, total=tcfg.total_steps)
        _, opt = adamw_update(
            g_local, AdamWState(step.to_local(), _local(state.opt.m),
                                _local(state.opt.v)),
            _local(state.params), lr=lr, b1=tcfg.b1, b2=tcfg.b2,
            weight_decay=tcfg.weight_decay)
        new_step = DTensor.from_local(opt.step, step.device_mesh,
                                      step.placements, run_check=False)
        for f in leaves(full):
            f.grad = None
        out.update(grad_norm=gnorm, lr=lr)
        return TrainState(state.params, AdamWState(new_step, state.opt.m,
                                                   state.opt.v),
                          state.ef), out

    return train_step


def make_train_step(model: Model, tcfg: TrainConfig, mesh=None):
    """The train step; on `mesh` the sharded step over DTensor state (the
    module docstring).  Either step, called, first refuses what
    check_backward refuses on the model's device."""
    if mesh is not None:
        return _make_mesh_step(model, tcfg, mesh)
    remat = tcfg.remat != "none"

    def train_step(state: TrainState, batch: Dict
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        check_backward(model.cfg, model.device)
        params = state.params
        for p in leaves(params):
            p.grad = None
        loss, metrics = model.loss(params, batch, remat=remat)
        loss.backward()
        grads = map_tree(lambda p: p.grad if p.grad is not None
                         else torch.zeros_like(p), params)
        grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
        ef = state.ef
        if tcfg.grad_compression == "int8":
            grads, ef = compress_grads(grads, ef)
        lr = cosine_schedule(state.opt.step, base_lr=tcfg.learning_rate,
                             warmup=tcfg.warmup_steps, total=tcfg.total_steps)
        params, opt = adamw_update(grads, state.opt, params, lr=lr,
                                   b1=tcfg.b1, b2=tcfg.b2,
                                   weight_decay=tcfg.weight_decay)
        for p in leaves(params):
            p.grad = None
        out = {"loss": loss.detach(), "ce": metrics["ce"].detach(),
               "aux": metrics["aux"].detach(), "grad_norm": gnorm, "lr": lr}
        return TrainState(params, opt, ef), out

    return train_step
