"""Mamba2 (SSD) block: gated selective state space with a depthwise causal
conv - the JAX package's models/mamba2.py as plain functions on tensors.

Parameters (one layer, JAX layout): in_proj (d, 2 d_in + 2 N + H) emitting
[z | x | B | C | dt], out_proj (d_in, d), conv_w (ssm_conv, d_in), gate_norm
(d_in,) in the config's dtype, and A_log, dt_bias (H,) kept in float32 as
the JAX init keeps them.  The decode state is (conv: the last ssm_conv - 1
pre-conv inputs, ssm: the (H, P, N) float32 state).  The full-sequence
scan goes through ops.mamba2_scan (K6 on the card); prefill uses the plain
chunked scan, which also returns the final state, as the JAX package does.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import ops, ref
from .layers import dense


def _dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    d_in = cfg.ssm_expand * cfg.d_model
    H = cfg.ssm_heads or max(1, d_in // 64)      # head channel P = 64
    P = d_in // H
    N = cfg.ssm_state
    return d_in, H, P, N


def mamba2_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """Leaf shapes of one layer (mamba2_init's tree)."""
    d = cfg.d_model
    d_in, H, P, N = _dims(cfg)
    return {"in_proj": (d, 2 * d_in + 2 * N + H), "out_proj": (d_in, d),
            "conv_w": (cfg.ssm_conv, d_in), "A_log": (H,), "dt_bias": (H,),
            "gate_norm": (d_in,)}


# leaves the JAX init keeps in float32 whatever the config's dtype
FP32_LEAVES = ("A_log", "dt_bias")


def _split(proj: torch.Tensor, cfg: ModelConfig):
    d_in, H, P, N = _dims(cfg)
    z = proj[..., :d_in]
    x = proj[..., d_in:2 * d_in]
    Bm = proj[..., 2 * d_in:2 * d_in + N]
    Cm = proj[..., 2 * d_in + N:2 * d_in + 2 * N]
    dt = proj[..., 2 * d_in + 2 * N:]
    return z, x, Bm, Cm, dt


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv.  x: (B, S, C); w: (k, C)."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        out = out + xp[:, i:i + x.shape[1]].float() * w[i].float()
    return out.to(x.dtype)


def _gated_out(params, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    yf = y.float() * F.silu(z.float())
    yf = yf * torch.rsqrt(torch.mean(yf * yf, -1, keepdim=True) + 1e-6)
    yf = yf * params["gate_norm"].float()
    return dense(params["out_proj"], yf.to(y.dtype))


def _scan_inputs(params, x: torch.Tensor, cfg: ModelConfig):
    """in_proj, the conv and the step sizes of a whole sequence: (z, x
    (B, S, H, P) contiguous, Bm, Cm (B, S, N) contiguous, dt (B, S, H)
    float32, A (H,) float32, the pre-conv x)."""
    B, S, _ = x.shape
    d_in, H, P, N = _dims(cfg)
    proj = dense(params["in_proj"], x)
    z, xs_raw, Bm, Cm, dt = _split(proj, cfg)
    xs = F.silu(_causal_conv(xs_raw, params["conv_w"]).float()).to(x.dtype)
    dt = F.softplus(dt.float() + params["dt_bias"])
    A = torch.exp(params["A_log"])
    return (z, xs.reshape(B, S, H, P), Bm.contiguous(), Cm.contiguous(),
            dt, A, xs_raw)


def mamba2_forward(params, x: torch.Tensor, cfg: ModelConfig,
                   impl=None) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D)."""
    B, S, _ = x.shape
    z, xh, Bm, Cm, dt, A, _ = _scan_inputs(params, x, cfg)
    y = ops.mamba2_scan(xh, dt, A, Bm, Cm, impl=impl)       # (B, S, H, P)
    return _gated_out(params, y.reshape(B, S, -1), z)


def mamba2_prefill(params, x: torch.Tensor, cfg: ModelConfig):
    """Full-sequence prefill: (y, state) with the final SSM state and the
    conv window (the last ssm_conv - 1 pre-conv inputs), so decode
    continues exactly where the prompt ended."""
    B, S, _ = x.shape
    z, xh, Bm, Cm, dt, A, xs_raw = _scan_inputs(params, x, cfg)
    y, h_fin = ref.mamba2_scan_chunked_state(xh, dt, A, Bm, Cm)
    out = _gated_out(params, y.reshape(B, S, -1), z)
    conv_win = xs_raw[:, S - (cfg.ssm_conv - 1):, :]
    return out, {"conv": conv_win, "ssm": h_fin}


def mamba2_init_state(cfg: ModelConfig, batch: int, dtype, device):
    d_in, H, P, N = _dims(cfg)
    return {"conv": torch.zeros((batch, cfg.ssm_conv - 1, d_in),
                                dtype=dtype, device=device),
            "ssm": torch.zeros((batch, H, P, N), dtype=torch.float32,
                               device=device)}


def mamba2_decode(params, x: torch.Tensor, cfg: ModelConfig, state):
    """x: (B, 1, D); state {"conv", "ssm"}.  Returns (y (B, 1, D), new
    state)."""
    B = x.shape[0]
    d_in, H, P, N = _dims(cfg)
    proj = dense(params["in_proj"], x)[:, 0]
    z, xs, Bm, Cm, dt = _split(proj, cfg)
    win = torch.cat([state["conv"], xs[:, None, :]], 1)     # (B, k, d_in)
    xc = torch.sum(win.float() * params["conv_w"].float()[None], 1)
    xc = F.silu(xc).to(x.dtype)
    dt = F.softplus(dt.float() + params["dt_bias"])
    A = torch.exp(params["A_log"])
    h, y = ops.mamba2_step(state["ssm"], xc.reshape(B, H, P), dt, A, Bm, Cm)
    y = _gated_out(params, y.reshape(B, 1, d_in), z.reshape(B, 1, d_in))
    return y, {"conv": win[:, 1:], "ssm": h}
