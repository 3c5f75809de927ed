"""Carry a parameter tree over from the JAX package.

The JAX package keeps its parameters as a pytree of nested dicts; pulled to
the host (`jax.device_get`) every leaf is a numpy array.  params_from_numpy
turns that tree into the port's tree of torch tensors with the same keys
and the same stacked (L, ...) layout - a dense weight stays (d_in, d_out)
and the port computes x @ w - so the two packages run the very same
weights.  bfloat16 leaves arrive as numpy arrays of the ml_dtypes bfloat16
type, which torch.from_numpy refuses; their bits travel as int16 and are
viewed back as torch.bfloat16.  Like every entry point of the port, both
functions put their tensors on the GPU unless device="cpu" is asked for,
and raise on a machine without one.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..configs.base import ModelConfig
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


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                      device="cuda") -> Dict[str, Any]:
    """Nested dict of numpy arrays (the JAX Model.init tree) -> nested dict
    of torch tensors on `device`.  Every leaf must already be in the
    config's dtype; a mismatch raises instead of silently casting."""
    device = resolve_device(device, "params_from_numpy")
    want = pdtype(cfg)

    def conv(node, path):
        if isinstance(node, dict):
            return {k: conv(v, f"{path}/{k}") for k, v in node.items()}
        t = tensor_from_numpy(node, device)
        if t.dtype != want:
            raise TypeError(f"{path}: {t.dtype}, config {cfg.name} wants "
                            f"{want}")
        return t

    return conv(tree, "")
