"""Carry a parameter tree, or a whole train state, over from the JAX
package.

The JAX package keeps its parameters as a pytree of nested dicts; pulled to
the host (`jax.device_get`) every leaf is a numpy array.  params_from_numpy
turns that tree into the port's tree of torch tensors with the same keys
and the same stacked (L, ...) layout - a dense weight stays (d_in, d_out)
and the port computes x @ w - so the two packages run the very same
weights.  Each leaf must already have the dtype of the port's own
parameter at its path (the config's dtype, but float32 for the leaves
the JAX init keeps in float32: Mamba2's A_log and dt_bias, RWKV6's w_base
and u); a mismatch raises instead of casting.  bfloat16 leaves arrive as
numpy arrays of the ml_dtypes bfloat16 type, which torch.from_numpy
refuses; their bits travel as int16 and are viewed back as
torch.bfloat16.  Like every entry point of the port, both
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
from .model import Model, resolve_device


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


def _tree_from_numpy(tree, want, device, path: str, owner: str):
    """Nested dict of numpy arrays -> nested dict of tensors on `device`.
    `want` is a torch.dtype every leaf must have, or the matching nest of
    tensors whose dtype and shape each leaf must have, every one of them
    present; a key `want` lacks, a missing key, or a leaf of another dtype
    or shape raises instead of casting, naming its path (extra keys first,
    then the leaves in order, then the missing keys)."""
    nest = isinstance(want, dict)
    if isinstance(tree, dict):
        extra = set(tree) - set(want) if nest else ()
        if extra:
            raise KeyError(f"{path or '/'}: {sorted(extra)} not in {owner}")
        out = {k: _tree_from_numpy(v, want[k] if nest else want, device,
                                   f"{path}/{k}", owner)
               for k, v in tree.items()}
        missing = set(want) - set(tree) if nest else ()
        if missing:
            raise KeyError(f"{path or '/'}: {sorted(missing)} of {owner} "
                           f"missing")
        return out
    if nest:
        raise KeyError(f"{path}: a leaf where {owner} has "
                       f"{sorted(want)}")
    t = tensor_from_numpy(tree, device)
    dtype = want if isinstance(want, torch.dtype) else want.dtype
    if t.dtype != dtype:
        raise TypeError(f"{path}: {t.dtype}, {owner} wants {dtype}")
    if not isinstance(want, torch.dtype) and t.shape != want.shape:
        raise ValueError(f"{path}: shape {tuple(t.shape)}, {owner} wants "
                         f"{tuple(want.shape)}")
    return t


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                      device="cuda") -> Dict[str, Any]:
    """Nested dict of numpy arrays (the JAX Model.init tree) -> nested dict
    of torch tensors on `device`, each leaf's dtype and shape checked
    against the port's own parameter at its path (Model(cfg) on the meta
    device, no memory); an extra, missing or mismatched leaf raises instead
    of being cast or left out."""
    device = resolve_device(device, "params_from_numpy")
    return _tree_from_numpy(tree, Model(cfg, "meta").params, device, "",
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
