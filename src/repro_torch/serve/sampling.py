"""Device-side sampling: top-k / top-p / temperature as plain tensor
functions, in the JAX package's filter order

    logits -> / temperature -> top-k mask -> top-p mask -> categorical

Greedy (temperature <= 0) is an argmax and takes no random numbers.  The
categorical draw is a Gumbel-max over the filtered logits with noise from
an explicit torch.Generator, so it stays on the device and never
synchronises with the host; its random stream differs from jax.random's,
so sampled outputs agree with the JAX package in distribution, not token
for token.

Speculative verification samples the target's token at every chain
position (sample_chain) and accepts the longest draft prefix that matches
those samples (speculative_accept): for a deterministic draft this is the
speculative rejection rule, so the emitted stream is distributed exactly
as non-speculative decoding, and greedy chains are bit-identical.
"""
from __future__ import annotations

from typing import Optional, Tuple

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


def sample_chain(logits: torch.Tensor,
                 generator: Optional[torch.Generator] = None, *,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0) -> torch.Tensor:
    """Per-position sampling for speculative verification: logits (K, S,
    V) -> tokens (K, S) int32.  Greedy is the argmax; otherwise every
    (row, position) takes its own Gumbel noise from `generator`, so each
    position, given its prefix, is drawn as one decode step would draw
    it."""
    if logits.dim() != 3:
        raise ValueError(f"sample_chain takes (K, S, V) logits, got "
                         f"{tuple(logits.shape)}")
    return sample(logits, generator, temperature=temperature, top_k=top_k,
                  top_p=top_p)


def speculative_accept(target_tokens: torch.Tensor,
                       draft_tokens: torch.Tensor,
                       draft_lens: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample-and-compare acceptance of deterministic draft chains.

    target_tokens (K, S): the target's token at every chain position;
    draft_tokens (K, S): row = [pending, d_1 .. d_m, pad...]; draft_lens
    (K,): m per row.  Returns (n_acc (K,), bonus (K,)) int32: n_acc the
    longest draft prefix equal to the target's tokens (at most m), bonus
    target_tokens[:, n_acc] - the correction on the first mismatch, or the
    extra token after a fully accepted chain."""
    S = draft_tokens.shape[1]
    pos = torch.arange(S - 1, device=draft_tokens.device)[None, :]
    m = draft_lens.to(torch.int64)[:, None]
    match = (target_tokens[:, :-1] == draft_tokens[:, 1:]) & (pos < m)
    n_acc = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
    bonus = torch.gather(target_tokens, 1, n_acc[:, None].long())[:, 0]
    return n_acc.to(torch.int32), bonus.to(torch.int32)
