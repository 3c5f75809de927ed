"""The paper's latency-balanced tier scheduling on an H100 SM: the Hopper
counterpart of the JAX package's core/tpu_mapping.py, which picks the
Pallas block shapes of the TPU kernel K4 (kernels/flash_attention.py
there: choose_block_config when block_q or block_kv is 0).  Here it picks
the tile of K4's bfloat16 kernel (csrc/flash_attention.cu) among the
tiles that kernel instantiates.

The paper maps FlashAttention-2's inner loop onto four stacked tiers and
balances their latencies so the pipeline runs without bubbles.  On an SM
the four tiers are its units:
  qk      S = Q K^T on the tensor cores (mma.sync bf16);
  rowmax  scale and row max on the FP32 lanes;
  expsum  exp2 on the special-function units (ex2) and the row sum and
          the subtraction on the FP32 lanes;
  pv      O += P V on the tensor cores, and O's rescale on the FP32 lanes.
A tile is (block_q, block_kv): block_q flattened query rows (row r = s G +
g, the G query heads of one KV head side by side, as the kernel tiles
them - a Pallas block counts positions of one head), block_kv KV
positions.  Each stage's latency is its work on one tile over its unit's
rate on one SM.  The pipeline check is the paper's bubble-free property
on Hopper: the cp.async load of the next K/V tile from HBM (its share of
HBM bandwidth an SM) must hide under the current tile's compute.

A tile must fit: its shared memory (the q tile and two buffers of K and
V, rows padded by 16 bytes) within 227 KB a block, and its registers -
o's accumulators (D / 2 fp32 a thread: each warp owns 16 rows of D
columns), the scores (block_kv / 2 a thread) and the rest of the kernel
(81, what ptxas gave K4's (64, 64) tile at head dim 256 beyond those two:
241 registers, PERF.md) - within 255 a thread and 64 K an SM for the
block's 32 block_q / 16 threads.  At head dim 256 a block_kv of 128 needs
128 + 64 + 81 = 273 registers, and with block_q 64 also 304 KB of shared
memory: it does not fit.

choose_block_config ranks the fitting candidates by the balance criterion
(max over mean of the stage latencies, 1.0 = balanced), bubble-free ones
first, ties to the larger tile, as the JAX chooser does.  The constants
are the H100 SXM's published figures, each with its source; none comes
from the TPU, and none was tuned toward the tile that measures fastest.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

from .schedule import balance_chain

# NVIDIA H100 SXM5 data sheet and Hopper architecture white paper: 132 SMs
SMS = 132
# data sheet: 989 TFLOP/s dense bf16 on the tensor cores, an SM's share
TENSOR_FLOPS_SM = 989e12 / SMS
# data sheet: 67 TFLOP/s float32 outside the tensor cores, an FMA two
# FLOPs: 128 FP32 lanes an SM (CUDA C++ Programming Guide, arithmetic
# instruction throughput, compute capability 9.0) at the clock below
FP32_OPS_SM = 67e12 / 2 / SMS
CLOCK_HZ = FP32_OPS_SM / 128
# CUDA C++ Programming Guide, same table: 16 results a clock an SM for
# exp2 (and the other special functions) on compute capability 9.0
SFU_OPS_SM = 16 * CLOCK_HZ
# data sheet: 3.35 TB/s of HBM3, an SM's share
HBM_BYTES_SM = 3.35e12 / SMS
# Hopper tuning guide: 227 KB of shared memory a block (232,448 bytes)
SMEM_BLOCK = 232448
# CUDA C++ Programming Guide, compute capability 9.0: 255 registers a
# thread, 64 K 32-bit registers an SM
REGS_THREAD = 255
REGS_SM = 65536
# K4's bf16 tile beyond o's accumulators and the scores: ptxas's 241
# registers for the (64, 64) tile at head dim 256 (PERF.md) less 128 + 32
REGS_OTHER = 81
PAD = 8                       # bf16 elements of padding a shared-memory row

# The tiles csrc/flash_attention.cu instantiates for bfloat16, by head dim
# (block_q flattened rows = 16 x warps, block_kv positions), three a head
# dim: (64, 64), the tile before this chooser; the tile the criterion
# picks of every pair of block_q 64 or 128 and block_kv 32, 64 or 128
# that fits (at a long sequence); and (128, 64), or where that is the
# pick, the other fitting block_kv.  The float32 kernel has one tile a
# head dim.
K4_TILES: Dict[int, Tuple[Tuple[int, int], ...]] = {
    64: ((64, 64), (128, 32), (128, 64)),
    80: ((64, 64), (128, 32), (128, 64)),
    128: ((64, 64), (128, 128), (128, 64)),
    256: ((64, 64), (128, 64), (64, 32)),
}


def f32_tile(head_dim: int) -> Tuple[int, int]:
    """The float32 CUDA-core kernel's one tile (f32_rows in the source)."""
    return (32 if head_dim > 128 else 64, 64)


@dataclass(frozen=True)
class BlockConfig:
    """A tile of K4 with its stage latencies (seconds on one SM)."""
    block_q: int
    block_kv: int
    stages: Tuple[Tuple[str, float], ...]
    smem_bytes: int
    registers: int
    tensor_s: float
    lanes_s: float
    load_s: float

    @property
    def balanced(self) -> float:
        """Stage imbalance: max over mean of the stage latencies (1.0 =
        perfectly balanced, the paper's criterion)."""
        lat = [c for _, c in self.stages]
        return max(lat) / (sum(lat) / len(lat))

    @property
    def bubble_free(self) -> bool:
        """The next K/V tile's load from HBM hides under this tile's
        compute."""
        return self.load_s <= self.tensor_s + self.lanes_s

    @property
    def fits(self) -> bool:
        threads = 32 * (self.block_q // 16)
        return (self.smem_bytes <= SMEM_BLOCK
                and self.registers <= REGS_THREAD
                and self.registers * threads <= REGS_SM)


def stage_latencies(block_q: int, block_kv: int, head_dim: int
                    ) -> List[Tuple[str, float]]:
    """Seconds each tier takes for one tile on one SM, the paper's four
    tiers in its order (the module docstring)."""
    elems = block_q * block_kv
    mma = 2.0 * elems * head_dim / TENSOR_FLOPS_SM
    qk = mma
    rowmax = 2.0 * elems / FP32_OPS_SM              # scale, max
    expsum = elems / SFU_OPS_SM + 2.0 * elems / FP32_OPS_SM
    pv = mma + block_q * head_dim / FP32_OPS_SM     # o *= alpha
    return [("qk", qk), ("rowmax", rowmax), ("expsum", expsum), ("pv", pv)]


def smem_working_set(block_q: int, block_kv: int, head_dim: int) -> int:
    """Bytes of shared memory a block of K4's bf16 kernel takes: the q
    tile and two buffers of the K and V tiles, rows padded."""
    return 2 * (head_dim + PAD) * (block_q + 4 * block_kv)


def registers(block_kv: int, head_dim: int) -> int:
    """Registers a thread of K4's bf16 kernel needs (the module
    docstring)."""
    return head_dim // 2 + block_kv // 2 + REGS_OTHER


def block_config(block_q: int, block_kv: int, head_dim: int) -> BlockConfig:
    """A tile's stages, footprint and the time of its next K/V load."""
    stages = stage_latencies(block_q, block_kv, head_dim)
    tensor = 4.0 * block_q * block_kv * head_dim / TENSOR_FLOPS_SM
    return BlockConfig(
        block_q=block_q, block_kv=block_kv, stages=tuple(stages),
        smem_bytes=smem_working_set(block_q, block_kv, head_dim),
        registers=registers(block_kv, head_dim), tensor_s=tensor,
        lanes_s=sum(c for _, c in stages) - tensor,
        load_s=2.0 * block_kv * head_dim * 2 / HBM_BYTES_SM)


def candidates(head_dim: int, seq_len: int) -> List[BlockConfig]:
    """K4's instantiated bf16 tiles at this head dim that fit, none longer
    than the sequence needs (a tile past max(seq_len, 64) rows or
    positions only adds padding)."""
    if head_dim not in K4_TILES:
        raise ValueError(f"K4 has no bf16 tile at head dim {head_dim}; it "
                         f"takes {sorted(K4_TILES)}")
    out = []
    for bq, bkv in K4_TILES[head_dim]:
        if bq > max(seq_len, 64) or bkv > max(seq_len, 64):
            continue
        cfg = block_config(bq, bkv, head_dim)
        if cfg.fits:
            out.append(cfg)
    return out


def choose_block_config(head_dim: int, seq_len: int,
                        dtype: str = "bfloat16") -> BlockConfig:
    """The tile K4 launches (block_q = block_kv = 0 at its wrapper).
    bfloat16: of the instantiated tiles that fit, the bubble-free ones
    when any is, the one with the best balance (rounded to 3 digits),
    ties to the larger tile - the JAX chooser's rule.  float32: the
    CUDA-core kernel's one tile (f32_tile; it holds fp32 q, K and V in
    shared memory and a thread's scores and outputs in registers, and no
    other shape was built)."""
    if dtype == "float32":
        return block_config(*f32_tile(head_dim), head_dim)
    if dtype != "bfloat16":
        raise ValueError(f"K4 takes float32 or bfloat16, got {dtype}")
    cands = candidates(head_dim, seq_len)
    if not cands:
        raise ValueError(f"no K4 tile fits at head dim {head_dim}")
    pool = [c for c in cands if c.bubble_free] or cands
    return min(pool, key=lambda c: (round(c.balanced, 3),
                                    -c.block_q * c.block_kv))


def tier_assignment_for_chain(costs: List[float], n_units: int = 4):
    """The generalized latency balancer for any fused chain (the paper:
    "generalizable to other fused operators beyond attention")."""
    return balance_chain(costs, n_units)
