"""Carry a parameter tree, or a whole train state, over from the JAX
package.

The JAX package keeps its parameters as a pytree of nested dicts; pulled to
the host (`jax.device_get`) every leaf is a numpy array.  params_from_numpy
turns that tree into the port's tree of torch tensors with the same keys
and the same stacked (L, ...) layout - a dense weight stays (d_in, d_out)
and the port computes x @ w - so the two packages run the very same
weights.  bfloat16 leaves arrive as numpy arrays of the ml_dtypes bfloat16
type, which torch.from_numpy refuses; their bits travel as int16 and are
viewed back as torch.bfloat16.  Like every entry point of the port, both
functions put their tensors on the GPU unless device="cpu" is asked for,
and raise on a machine without one.  train_state_from_numpy carries a JAX
TrainState (params, AdamW step / m / v, error-feedback buffers) across the
same way.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..optim import AdamWState
from ..train.train_step import TrainState, trainable
from .layers import pdtype
from .model import resolve_device


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    """One numpy leaf -> torch tensor on `device` (bfloat16 bit-exact)."""
    device = resolve_device(device, "tensor_from_numpy")
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16).view(np.int16)
        t = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device)


def _tree_from_numpy(tree, want: torch.dtype, device, path: str, owner: str):
    """Nested dict of numpy arrays -> nested dict of tensors on `device`,
    every leaf already `want`; a mismatch raises instead of casting."""
    if isinstance(tree, dict):
        return {k: _tree_from_numpy(v, want, device, f"{path}/{k}", owner)
                for k, v in tree.items()}
    t = tensor_from_numpy(tree, device)
    if t.dtype != want:
        raise TypeError(f"{path}: {t.dtype}, {owner} wants {want}")
    return t


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                      device="cuda") -> Dict[str, Any]:
    """Nested dict of numpy arrays (the JAX Model.init tree) -> nested dict
    of torch tensors on `device`.  Every leaf must already be in the
    config's dtype; a mismatch raises instead of silently casting."""
    device = resolve_device(device, "params_from_numpy")
    return _tree_from_numpy(tree, pdtype(cfg), device, "",
                            f"config {cfg.name}")


def train_state_from_numpy(params: Dict[str, Any], opt, ef: Dict[str, Any],
                           cfg: ModelConfig, device="cuda"):
    """A JAX TrainState pulled to numpy (jax.device_get(state)): its
    params tree, its AdamWState opt (step, m, v) and its ef tree ({} when
    compression is off) -> the port's TrainState on `device`, parameters
    trainable.  The params must be in the config's dtype, step int32, m,
    v and ef float32; a mismatch raises instead of casting."""
    device = resolve_device(device, "train_state_from_numpy")
    step = tensor_from_numpy(opt.step, device)
    if step.dtype != torch.int32 or step.dim() != 0:
        raise TypeError(f"opt.step: {step.dtype} of shape "
                        f"{tuple(step.shape)}, want a 0-d int32")
    f32 = lambda tree, path: _tree_from_numpy(tree, torch.float32, device,
                                              path, "the optimizer state")
    return TrainState(
        params=trainable(params_from_numpy(params, cfg, device)),
        opt=AdamWState(step=step, m=f32(opt.m, "opt.m"),
                       v=f32(opt.v, "opt.v")),
        ef=f32(ef, "ef"))
