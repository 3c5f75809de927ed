"""3D-FlashAttention scheduling: latency-balanced tier mapping - a copy of
the JAX package's core/schedule.py (framework-free; the port imports
nothing of the JAX package), for the Hopper block chooser
(core/hopper_mapping.py).

This module reproduces the paper's Section IV: the assignment of the
FlashAttention-2 inner-loop operators (Algorithm 1) onto the four stacked PE
tiers, the cycle-level pipeline this forms, and the generalized
latency-balancer ("the co-designed hybrid-bonded NPU architecture can also be
generalized to other fused operators beyond attention").

Timeline reproduced from the paper (Fig. 4), for a d x d tile:

  Tier 0 (QK^T, output-stationary):  first S element at cycle d, all at 3d;
                                     next iteration may start at 2d.
  Tier 1 (rowmax + subtract):        starts at d (first S via TSV), `a` done
                                     at 3d, matrix N done at 4d.
  Tier 2 (exp2 / rowsum / l-update): starts at 2d, done before 5d.
  Tier 3 (PV, weight-stationary, + O rescale): V injected at 2d, first
                                     local_O at 3d, all done at 5d.

Steady state: initiation interval = 2d cycles per inner-loop iteration;
pipeline depth = 5d cycles (first iteration's completion).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Sequence, Tuple


@dataclass(frozen=True)
class TierStage:
    """One pipeline stage (= one PE tier) of the 3D-FlashAttention schedule."""

    name: str
    tier: int
    # per d x d tile op counts, as functions of d
    macs: Callable[[int], float]
    exp_ops: Callable[[int], float]
    alu_ops: Callable[[int], float]
    # bytes forwarded upward through the hybrid-bonded TSV links per tile
    tsv_out_bytes: Callable[[int], float]
    # cycles this stage occupies per tile (its stage latency)
    latency: Callable[[int], float]
    # initiation interval: min cycles between successive tiles on this tier
    ii: Callable[[int], float]


def threed_flash_schedule(dtype_bytes: int = 2) -> List[TierStage]:
    """The paper's 4-tier operator mapping (Fig. 2/3/4, Alg. 1 colors)."""
    B = dtype_bytes
    return [
        TierStage(
            name="QK^T", tier=0,
            macs=lambda d: float(d) ** 3,
            exp_ops=lambda d: 0.0,
            alu_ops=lambda d: 0.0,
            # S tile forwarded element-by-element upward
            tsv_out_bytes=lambda d: float(d * d) * B,
            latency=lambda d: 3.0 * d,   # all S elements ready at 3d
            ii=lambda d: 2.0 * d,        # top-left PE frees at 2d
        ),
        TierStage(
            name="rowmax+sub", tier=1,
            macs=lambda d: 0.0,
            exp_ops=lambda d: 0.0,
            # rightward max propagation (d^2 cmp) + leftward compare with
            # old_m (d) + subtraction producing N (d^2) and a (d)
            alu_ops=lambda d: 2.0 * d * d + 2.0 * d,
            tsv_out_bytes=lambda d: (float(d * d) + d) * B,   # N and a
            latency=lambda d: 3.0 * d,   # active d..4d
            ii=lambda d: 2.0 * d,
        ),
        TierStage(
            name="exp+rowsum", tier=2,
            # new_l = old_l * b + local_l -> d MACs; const mult folded below
            macs=lambda d: float(d),
            # P (d^2) plus b (d) exponentials, exp2-based
            exp_ops=lambda d: float(d * d) + d,
            # const multiply (d^2) + rowsum accumulation (d^2)
            alu_ops=lambda d: 2.0 * d * d,
            tsv_out_bytes=lambda d: (float(d * d) + 2.0 * d) * B,  # P, b, l
            latency=lambda d: 3.0 * d,   # active 2d..5d
            ii=lambda d: 2.0 * d,
        ),
        TierStage(
            name="PV+rescale", tier=3,
            # PV: d^3 MACs; new_O = diag(b) old_O + local_O: d^2 MACs
            macs=lambda d: float(d) ** 3 + float(d * d),
            exp_ops=lambda d: 0.0,
            alu_ops=lambda d: 0.0,
            tsv_out_bytes=lambda d: 0.0,  # O leaves through the top to SRAM
            latency=lambda d: 3.0 * d,   # active 2d..5d
            ii=lambda d: 2.0 * d,
        ),
    ]


def pipeline_period(stages: Sequence[TierStage], d: int) -> float:
    """Steady-state initiation interval = max over stages (bubble-free when
    all tiers share the same II - the paper's latency-balanced property)."""
    return max(s.ii(d) for s in stages)


def pipeline_depth(stages: Sequence[TierStage], d: int) -> float:
    """Cycles until the first tile fully drains (paper: 5d)."""
    # Tier start offsets (paper Fig. 4): 0, d, 2d, 2d; depth = last finish.
    offsets = [0.0, 1.0 * d, 2.0 * d, 2.0 * d]
    return max(off + s.latency(d) for off, s in zip(offsets, stages))


def pipeline_cycles(n_tiles: int, stages: Sequence[TierStage], d: int) -> float:
    """Total cycles to stream `n_tiles` inner-loop tiles through the stack."""
    if n_tiles <= 0:
        return 0.0
    period = pipeline_period(stages, d)
    depth = pipeline_depth(stages, d)
    return depth + (n_tiles - 1) * period


def is_bubble_free(stages: Sequence[TierStage], d: int, tol: float = 1e-9) -> bool:
    """Bubble-free <=> every tier's initiation interval equals the pipeline
    period, i.e. no tier is left waiting on a slower neighbor."""
    period = pipeline_period(stages, d)
    return all(abs(s.ii(d) - period) <= tol * max(period, 1.0) for s in stages)


# ---------------------------------------------------------------------------
# Generalized latency balancer (beyond attention)
# ---------------------------------------------------------------------------

def balance_chain(costs: Sequence[float], n_tiers: int) -> Tuple[List[List[int]], float]:
    """Partition a chain of fused micro-operators (given per-op latencies)
    into `n_tiers` contiguous groups minimizing the maximum group latency.

    This is the paper's "latency-balanced mapping" generalized: the returned
    max group latency is the pipeline initiation interval when each group is
    assigned to one tier.  Exact O(n^2 * k) dynamic program.
    """
    n = len(costs)
    if n == 0:
        return [[] for _ in range(n_tiers)], 0.0
    k = min(n_tiers, n)
    prefix = [0.0]
    for c in costs:
        prefix.append(prefix[-1] + float(c))

    INF = float("inf")
    # dp[j][i] = minimal max-group-cost partitioning costs[:i] into j groups
    dp = [[INF] * (n + 1) for _ in range(k + 1)]
    cut = [[0] * (n + 1) for _ in range(k + 1)]
    dp[0][0] = 0.0
    for j in range(1, k + 1):
        for i in range(1, n + 1):
            for m in range(j - 1, i):
                cand = max(dp[j - 1][m], prefix[i] - prefix[m])
                if cand < dp[j][i]:
                    dp[j][i] = cand
                    cut[j][i] = m
    # reconstruct
    groups: List[List[int]] = []
    i = n
    for j in range(k, 0, -1):
        m = cut[j][i]
        groups.append(list(range(m, i)))
        i = m
    groups.reverse()
    while len(groups) < n_tiers:
        groups.append([])
    return groups, dp[k][n]


def balanced_ii(costs: Sequence[float], n_tiers: int) -> float:
    """Pipeline initiation interval after latency balancing."""
    _, mx = balance_chain(costs, n_tiers)
    return mx
