"""Training step: loss -> backward -> clip -> (compress) -> AdamW update -
the JAX package's train/train_step.py in eager PyTorch.

One step runs the same operations in the same order as the JAX step, with
two differences that save memory and change no value: the gradient comes
from loss.backward() into each parameter's .grad, and the clip, the
compression and the AdamW update overwrite the gradients, the parameters,
m, v and the error-feedback buffers in place (optim/).  The state is
returned for symmetry with the JAX step, holding the same tensors.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from ..configs.base import TrainConfig
from ..models.model import Model
from ..optim import (AdamWState, adamw_init, adamw_update,
                     clip_by_global_norm, compress_grads, cosine_schedule,
                     ef_init)
from ..tree import leaves, map_tree


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


def make_train_step(model: Model, tcfg: TrainConfig):
    remat = tcfg.remat != "none"

    def train_step(state: TrainState, batch: Dict
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
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
