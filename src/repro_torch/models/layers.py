"""Building blocks of the dense decoder, as plain functions on tensors.

Parameters come as dicts of tensors in the JAX package's layout (a dense
weight is (d_in, d_out) and computes x @ w), and the numerics follow its
models/layers.py: projections return the input dtype, norms compute in
fp32 and cast back, the SwiGLU gate multiplies in fp32, and the unembed
accumulates in fp32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig


def pdtype(cfg: ModelConfig) -> torch.dtype:
    """The parameter / activation dtype a config names."""
    try:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32,
                "float16": torch.float16}[cfg.dtype]
    except KeyError:
        raise ValueError(f"unsupported dtype {cfg.dtype!r}")


def dense(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x: (..., d_in) @ w: (d_in, d_out), result in x's dtype."""
    return torch.matmul(x, w).to(x.dtype)


def apply_norm(params, x: torch.Tensor, cfg: ModelConfig,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "rmsnorm":
        y = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
        return (y * params["scale"].float()).to(x.dtype)
    mean = torch.mean(xf, -1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), -1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if cfg.norm == "layernorm":
        y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def rms_head_norm(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """Per-head RMS norm (QK-norm).  x: (..., head_dim)."""
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         scaling: float = 1.0) -> torch.Tensor:
    """Rotary embedding over the two HALVES of the head dimension (not
    interleaved pairs).  x: (B, S, H, D); positions: (S,) or (B, S)."""
    D = x.shape[-1]
    half = D // 2
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device)
                      * (math.log(theta) / half))
    pos = positions.float() / scaling
    if pos.dim() == 1:
        ang = (pos[:, None] * freqs[None, :])[None, :, None, :]
    else:
        ang = (pos[:, :, None] * freqs[None, None, :])[:, :, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     -1).to(x.dtype)


def mlp(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = dense(params["w_in"], x)
    if cfg.act == "silu":
        h = F.silu(dense(params["w_gate"], x).float()) * h.float()
        h = h.to(x.dtype)
    else:
        # JAX's gelu default is the tanh approximation
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return dense(params["w_out"], h)


def embed(params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = params["embed"][tokens]
    if cfg.family == "dense" and cfg.qk_norm:     # gemma-style input scaling
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def unembed(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Tied (or separate) output projection, accumulated in fp32."""
    table = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return torch.matmul(x.float(), table.float().t())
