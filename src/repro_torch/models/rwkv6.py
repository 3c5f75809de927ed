"""RWKV6 (Finch) block: time-mix with data-dependent decay, and
channel-mix - the JAX package's models/rwkv6.py as plain functions on
tensors.

Parameters (one layer, JAX layout): r/k/v/g/out_proj (d, d), the decay
LoRA w_a (d, lora) and w_b (lora, d), token-shift weights mix (5, d) and
cm_mix (1, d), the per-head group-norm scale ln_x (d,), the channel-mix
cm_k (d, d_ff) and cm_v (d_ff, d) in the config's dtype; w_base (d,) and
the bonus u (H, K) kept in float32 as the JAX init keeps them.  The decay
w is float32 from end to end (the scan sums its logarithm).  The decode
state is (wkv: the (H, K, K) float32 state, tm_prev / cm_prev: the last
token's time-mix and channel-mix inputs).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import ops, ref
from .layers import dense


def rwkv6_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """Leaf shapes of one layer (rwkv6_init's tree)."""
    d, H = cfg.d_model, cfg.n_heads
    lora = max(32, d // 32)
    return {"r_proj": (d, d), "k_proj": (d, d), "v_proj": (d, d),
            "g_proj": (d, d), "out_proj": (d, d), "w_base": (d,),
            "w_a": (d, lora), "w_b": (lora, d), "u": (H, d // H),
            "mix": (5, d), "ln_x": (d,), "cm_k": (d, cfg.d_ff),
            "cm_v": (cfg.d_ff, d), "cm_mix": (1, d)}


# leaves the JAX init keeps in float32 whatever the config's dtype
FP32_LEAVES = ("w_base", "u")


def _token_shift(x: torch.Tensor,
                 x_prev_last: Optional[torch.Tensor] = None) -> torch.Tensor:
    """shifted[t] = x[t-1]; position 0 takes x_prev_last (the decode
    carry), or zeros."""
    first = torch.zeros_like(x[:, :1]) if x_prev_last is None \
        else x_prev_last[:, None, :]
    return torch.cat([first, x[:, :-1]], 1)


def _mix(x: torch.Tensor, shifted: torch.Tensor,
         mu: torch.Tensor) -> torch.Tensor:
    return x * mu.to(x.dtype) + shifted * (1.0 - mu).to(x.dtype)


def _decay(params, xw: torch.Tensor) -> torch.Tensor:
    """w = exp(-exp(w_base + tanh(xw @ w_a) @ w_b)), float32, with the
    exponent clipped to [-8, 0.75] so that w >= exp(-exp(0.75)) ~ 0.12:
    the chunked scans' e^{-cw} stays inside float32 over a 32-step
    chunk."""
    wf = params["w_base"] + torch.tanh(dense(params["w_a"], xw).float()) \
        @ params["w_b"].float()
    wf = torch.clamp(wf, -8.0, 0.75)
    return torch.exp(-torch.exp(wf))


def _group_norm(y: torch.Tensor, scale: torch.Tensor, H: int) -> torch.Tensor:
    """Per-head normalization of the WKV output.  y: (B, S, D)."""
    B, S, D = y.shape
    yh = y.reshape(B, S, H, D // H).float()
    mean = torch.mean(yh, -1, keepdim=True)
    var = torch.mean(torch.square(yh - mean), -1, keepdim=True)
    yh = (yh - mean) * torch.rsqrt(var + 1e-5)
    return (yh.reshape(B, S, D) * scale.float()).to(y.dtype)


def rwkv6_time_mix(params, x: torch.Tensor, cfg: ModelConfig,
                   x_prev: Optional[torch.Tensor] = None,
                   wkv_state: Optional[torch.Tensor] = None, impl=None,
                   return_state: bool = False):
    """x: (B, S, D).  The full sequence when wkv_state is None (the scan:
    ops.rwkv6_scan, or with return_state the plain chunked scan that also
    returns the final state); otherwise one decode step (S == 1).  Returns
    (y, (x[:, -1], new state or None))."""
    B, S, D = x.shape
    H = cfg.n_heads
    K = D // H
    shifted = _token_shift(x, x_prev)
    mu = params["mix"]
    xr, xk, xv, xw, xg = (_mix(x, shifted, mu[i]) for i in range(5))
    r = dense(params["r_proj"], xr).reshape(B, S, H, K)
    k = dense(params["k_proj"], xk).reshape(B, S, H, K)
    v = dense(params["v_proj"], xv).reshape(B, S, H, K)
    g = F.silu(dense(params["g_proj"], xg).float())
    w = _decay(params, xw).reshape(B, S, H, K)
    if wkv_state is None:
        if return_state:
            y, new_state = ref.rwkv6_scan_chunked_state(r, k, v, w,
                                                        params["u"])
        else:
            y = ops.rwkv6_scan(r, k, v, w, params["u"], impl=impl)
            new_state = None
    else:
        new_state, y1 = ops.rwkv6_step(wkv_state, r[:, 0], k[:, 0], v[:, 0],
                                       w[:, 0], params["u"])
        y = y1[:, None]
    y = _group_norm(y.reshape(B, S, D), params["ln_x"], H)
    y = (y.float() * g).to(x.dtype)
    return dense(params["out_proj"], y), (x[:, -1], new_state)


def rwkv6_channel_mix(params, x: torch.Tensor, cfg: ModelConfig,
                      x_prev: Optional[torch.Tensor] = None):
    """Returns (y (B, S, D), x[:, -1])."""
    shifted = _token_shift(x, x_prev)
    xk = _mix(x, shifted, params["cm_mix"][0])
    h = torch.square(F.relu(dense(params["cm_k"], xk).float()))
    return dense(params["cm_v"], h.to(x.dtype)), x[:, -1]


def rwkv6_init_state(cfg: ModelConfig, batch: int, dtype, device):
    H = cfg.n_heads
    K = cfg.d_model // H
    return {"wkv": torch.zeros((batch, H, K, K), dtype=torch.float32,
                               device=device),
            "tm_prev": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                   device=device),
            "cm_prev": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                   device=device)}
