"""AdamW with global-norm clipping and a cosine schedule: the JAX package's
optim/adamw.py on trees of torch tensors.

The arithmetic is the JAX package's, operation for operation: m and v are
fp32, the clip scales a gradient in fp32 and rounds it back to its dtype,
and the parameter update is computed in fp32 and rounded once.  step is a
0-d int32 tensor on the parameters' device, so the bias corrections and
the learning rate stay device tensors and no update waits on the host.

Unlike JAX, the updates are in place: clip_by_global_norm overwrites the
gradients, adamw_update the parameters, m and v, and each returns the
trees it was given.  They go over a stacked (L, ...) leaf one layer at a
time, so the fp32 temporaries of an update are one layer's size (a
full-width granite-3-2b w_in leaf is 2.7 GB in fp32, one layer of it 67
MB).  Leaves of fewer than three dimensions go whole.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Tuple

import torch

from ..tree import leaves, map_tree


class AdamWState(NamedTuple):
    step: torch.Tensor      # 0-d int32, on the parameters' device
    m: Any
    v: Any


def adamw_init(params) -> AdamWState:
    zeros = map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    step = torch.zeros((), dtype=torch.int32,
                       device=leaves(params)[0].device)
    return AdamWState(step=step, m=zeros, v=map_tree(torch.clone, zeros))


def _layers(t: torch.Tensor):
    """A leaf in pieces of one layer: the slices of a stacked leaf."""
    return [t[i] for i in range(t.shape[0])] if t.dim() >= 3 else [t]


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(
        sum(torch.sum(torch.square(x.float())) for x in _layers(g))
        for g in leaves(tree)))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scale every gradient by min(1, max_norm / norm), in place.  Returns
    (grads, norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    for g in leaves(grads):
        for x in _layers(g):
            x.copy_(x.float() * scale)
    return grads, norm


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, *, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1) -> Tuple[Any, AdamWState]:
    """One AdamW step, in place.  lr: a float or a 0-d device tensor.
    Returns (params, AdamWState(step + 1, m, v))."""
    step = state.step + 1
    fstep = step.float()
    bc1 = 1.0 - torch.pow(b1, fstep)
    bc2 = 1.0 - torch.pow(b2, fstep)
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.m),
                          leaves(state.v)):
        for ps, gs, ms, vs in zip(_layers(p), _layers(g), _layers(m),
                                  _layers(v)):
            gf = gs.float()
            ms.mul_(b1).add_(gf * (1.0 - b1))
            vs.mul_(b2).add_(gf * (1.0 - b2) * gf)
            delta = (ms / bc1) / (torch.sqrt(vs / bc2) + eps) \
                + ps.float() * weight_decay
            ps.copy_(ps.float() - lr * delta)
    return params, AdamWState(step=step, m=state.m, v=state.v)


def cosine_schedule(step: torch.Tensor, *, base_lr: float, warmup: int,
                    total: int, min_frac: float = 0.1) -> torch.Tensor:
    """Linear warm-up to base_lr, then a cosine decay to min_frac of it;
    a 0-d float32 tensor on step's device."""
    fstep = step.float()
    warm = fstep / max(warmup, 1)
    prog = torch.clamp((fstep - warmup) / max(total - warmup, 1), 0, 1)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return base_lr * torch.where(fstep < warmup, warm, cos)
