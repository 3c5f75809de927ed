"""Device-side sampling: top-k / top-p / temperature as plain tensor
functions, in the JAX package's filter order

    logits -> / temperature -> top-k mask -> top-p mask -> categorical

Greedy (temperature <= 0) is an argmax and takes no random numbers.  The
categorical draw is a Gumbel-max over the filtered logits with noise from
an explicit torch.Generator, so it stays on the device and never
synchronises with the host; its random stream differs from jax.random's,
so sampled outputs agree with the JAX package in distribution, not token
for token.  Speculative chains (sample_chain, speculative_accept) come
with speculative decoding (ROADMAP M6).
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Mask all but the k highest logits of the last axis to NEG_INF.
    k <= 0 (or k >= vocab) disables the filter; ties at the k-th value
    keep every tied token."""
    v = logits.shape[-1]
    if k <= 0 or k >= v:
        return logits
    kth = torch.sort(logits, dim=-1).values[..., v - k][..., None]
    return torch.where(logits >= kth, logits, NEG_INF)


def apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filter: keep the smallest set of highest-probability tokens
    whose cumulative probability reaches p (the argmax always survives);
    p >= 1 disables the filter."""
    if p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < p
    n_keep = keep.sum(-1, keepdim=True)
    thresh = torch.gather(sorted_logits, -1, n_keep - 1)
    return torch.where(logits >= thresh, logits, NEG_INF)


def sample(logits: torch.Tensor,
           generator: Optional[torch.Generator] = None, *,
           temperature: float = 0.0, top_k: int = 0,
           top_p: float = 1.0) -> torch.Tensor:
    """logits (..., V) -> tokens (...) int32.  temperature <= 0 is greedy
    argmax (first index among equal maxima; generator unused); otherwise
    `generator` (on the logits' device) is required."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if generator is None:
        raise ValueError("sampling at temperature > 0 needs a generator")
    scaled = apply_top_p(apply_top_k(logits / temperature, top_k), top_p)
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device,
                   dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp(1e-20, 1.0 - 1e-7)))
    return torch.argmax(scaled + gumbel, dim=-1).to(torch.int32)
