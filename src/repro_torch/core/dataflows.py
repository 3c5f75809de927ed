"""Analytical dataflow models for the five evaluated accelerator designs: a
copy of the JAX package's core/dataflows.py (framework-free; the port
imports nothing of the JAX package) over the port's own copies of the
energy model (core/energy.py) and the schedule (core/schedule.py).  The
cycles and bytes it counts are the paper's 16 nm, 1 GHz 3D NPU's, not
the card's.

Each model walks the attention computation at tile granularity (the same
granularity as the paper's in-house simulator) and accumulates an Activity
trace: cycles, MAC/exp/alu ops, and byte traffic at every level of the
hierarchy (register / SRAM / DRAM / TSV / NoC).

Conventions
-----------
* `d` = attention head dimension = PE array dimension (128 in the paper).
* One "tile" = one FlashAttention-2 inner-loop iteration over a d x d block
  (Algorithm 1, lines 6-19).
* The paper evaluates non-causal prefill attention; op counts use full N^2.
* GQA: K/V off-chip traffic is paid once per KV head and amortized across the
  `group_size` query heads that share it (K/V stay resident in SRAM).
* Head instances are scheduled onto `n_clusters` parallel units; 3D designs
  have a single (stacked) cluster and process heads sequentially, exactly as
  in the paper ("multiple heads can be processed in parallel by integrating
  multiple 3D-stacked PE arrays" - Table I gives ours 1 cluster).

Utilization is *array-level* (paper Fig. 8: "Average utilization of PE
arrays"): the fraction of array-cycles in which an array/tier is actively
streaming computation rather than stalled on memory, a slower producer, or a
phase boundary.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from .arch import AcceleratorSpec
from .energy import Activity
from .schedule import (pipeline_cycles, pipeline_depth, pipeline_period,
                       threed_flash_schedule)
from .workloads import AttentionWorkload

# ---------------------------------------------------------------------------
# Calibrated micro-constants (the JAX package's).  Register traffic per op
# counts only *architectural* register-file accesses that Accelergy would
# meter (psum read-modify-write, operand staging); the operand-forwarding
# flip-flops inside a systolic PE are part of the MAC energy.
# ---------------------------------------------------------------------------
# Each systolic MAC performs 4 architectural register accesses (two operand
# registers read-forward, psum read + write) of 2 bytes each - the classic
# Eyeriss/Accelergy RF accounting.  This is why the paper's Table II shows
# register energy 2-3x MAC energy.
REG_BYTES_PER_MAC = 8.0
REG_BYTES_PER_VECOP = 4.0        # vector/scalar op operand staging
# 3D-Flow keeps the running state (old_m, old_l, old_O) plus forwarded
# operands in PE-local registers - the paper's "increased register access".
REG_BYTES_PER_TSV_BYTE = 2.0     # write on producer tier + read on consumer
FUSEMAX_CTX_REGS = 10            # FuseMax stores 10 intermediates per PE


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class TileGeom:
    """Tile geometry for one head."""
    N: int
    d: int

    @property
    def Tr(self) -> int:
        return _ceil_div(self.N, self.d)

    @property
    def Tc(self) -> int:
        return _ceil_div(self.N, self.d)

    @property
    def tiles(self) -> int:
        return self.Tr * self.Tc


def _qkv_dram_bytes(wl: AttentionWorkload, B: int) -> float:
    """Compulsory off-chip traffic for the whole workload (all heads/layers):
    Q and O per query head; K and V once per KV head (GQA reuse in SRAM)."""
    per_q_head = 2.0 * wl.seq * wl.head_dim * B          # Q read + O write
    per_kv_head = 2.0 * wl.seq * wl.head_dim * B         # K read + V read
    return (wl.n_heads * per_q_head + wl.n_kv_heads * per_kv_head) \
        * wl.n_layers * wl.batch


def _heads_wall_factor(wl: AttentionWorkload, parallel_units: int) -> float:
    """Wall-clock multiplier: head instances executed per parallel unit."""
    return _ceil_div(int(wl.total_head_instances), parallel_units)


# ===========================================================================
# 3D-Flow (ours)
# ===========================================================================

def flow3d_attention(spec: AcceleratorSpec, wl: AttentionWorkload) -> Activity:
    """The paper's co-designed dataflow: 4-tier register-to-register pipeline,
    one inner-loop tile per 2d cycles in steady state, no SRAM round-trips for
    intermediates."""
    d = spec.array_dim
    B = spec.dtype_bytes
    g = TileGeom(wl.seq, d)
    stages = threed_flash_schedule(B)
    act = Activity()

    H = wl.total_head_instances

    # ---- per-head cycles: bubble-free vertical pipeline -------------------
    per_head_cycles = pipeline_cycles(g.tiles, stages, d)
    # outer-loop boundary: final O scaling by diag(l)^-1 (Alg.1 line 21),
    # overlapped except for a d-cycle drain per outer row
    per_head_cycles += g.Tr * d
    wall = per_head_cycles * _heads_wall_factor(wl, spec.n_clusters)

    # ---- op counts --------------------------------------------------------
    per_tile_macs = sum(s.macs(d) for s in stages)
    per_tile_exp = sum(s.exp_ops(d) for s in stages)
    per_tile_alu = sum(s.alu_ops(d) for s in stages)
    per_tile_tsv = sum(s.tsv_out_bytes(d) for s in stages)

    act.macs = H * g.tiles * per_tile_macs
    act.exp_ops = H * g.tiles * per_tile_exp
    act.alu_ops = H * g.tiles * per_tile_alu + H * g.Tr * d * d  # line 21
    act.tsv_bytes = H * g.tiles * per_tile_tsv

    # ---- register traffic -------------------------------------------------
    # psum + running-state (old_m, old_l: 2d elems; old_O: d^2 elems) kept in
    # registers and updated once per tile
    state_reg = (2.0 * d + d * d) * B * 2.0   # read+write per tile
    act.reg_bytes = (act.macs * REG_BYTES_PER_MAC
                     + (act.exp_ops + act.alu_ops) * REG_BYTES_PER_VECOP
                     + act.tsv_bytes * REG_BYTES_PER_TSV_BYTE
                     + H * g.tiles * state_reg)

    # ---- SRAM traffic: tile injection only (Q_i, K_j, V_j per tile) plus
    # final O write-back.  NO intermediate round-trips - the paper's point.
    act.sram_bytes = H * (g.tiles * 3.0 * d * d * B      # Q,K,V injection
                          + g.Tr * d * d * B)            # O write
    # staging DRAM->SRAM (double-buffered): counted once as SRAM writes
    act.sram_bytes += _qkv_dram_bytes(wl, B)

    act.dram_bytes = _qkv_dram_bytes(wl, B)

    # ---- cycles & utilization --------------------------------------------
    act.cycles = wall
    n_arrays = spec.n_tiers * spec.n_clusters
    act.total_pe_cycles = wall * n_arrays
    # each tier streams continuously while the pipeline is full; fill/drain
    # and the per-outer-row scaling drain are the only idle windows
    steady = g.tiles * pipeline_period(stages, d)
    per_head_busy = 4.0 * steady * 0.89   # intra-window occupancy of wavefront
    act.busy_pe_cycles = per_head_busy * _heads_wall_factor(wl, spec.n_clusters)
    return act


# ===========================================================================
# 3D-Base: same stack, operators per tier, but intermediates exchanged via
# SRAM (ISQED'21 / SiPS'18-style mapping).  Broadcast input reuse via TSV.
# ===========================================================================

def base3d_attention(spec: AcceleratorSpec, wl: AttentionWorkload) -> Activity:
    d = spec.array_dim
    B = spec.dtype_bytes
    g = TileGeom(wl.seq, d)
    stages = threed_flash_schedule(B)
    act = Activity()
    H = wl.total_head_instances

    # Every inter-tier transfer becomes an SRAM write + read, serialized over
    # the tier's SRAM port.  Three tier boundaries; traffic per tile ~= the
    # TSV bytes of 3D-Flow.
    per_tile_boundary_bytes = sum(s.tsv_out_bytes(d) for s in stages)
    roundtrip_bytes = 2.0 * per_tile_boundary_bytes
    stall = roundtrip_bytes / spec.sram_port_bytes_per_cycle

    period = pipeline_period(stages, d) + stall
    per_head_cycles = (pipeline_depth(stages, d)
                       + (g.tiles - 1) * period + g.Tr * d)
    wall = per_head_cycles * _heads_wall_factor(wl, spec.n_clusters)

    per_tile_macs = sum(s.macs(d) for s in stages)
    per_tile_exp = sum(s.exp_ops(d) for s in stages)
    per_tile_alu = sum(s.alu_ops(d) for s in stages)
    act.macs = H * g.tiles * per_tile_macs
    act.exp_ops = H * g.tiles * per_tile_exp
    act.alu_ops = H * g.tiles * per_tile_alu + H * g.Tr * d * d

    # input reuse via TSV broadcast (Q tile broadcast to tiers): counted as
    # TSV traffic, saving one of the three SRAM injections
    act.tsv_bytes = H * g.tiles * d * d * B
    act.sram_bytes = (H * (g.tiles * 2.0 * d * d * B     # K,V injection
                           + g.Tr * d * d * B)           # O write
                      + H * g.tiles * roundtrip_bytes    # intermediates!
                      + _qkv_dram_bytes(wl, B))
    act.dram_bytes = _qkv_dram_bytes(wl, B)

    state_reg = (2.0 * d + d * d) * B * 2.0
    act.reg_bytes = (act.macs * REG_BYTES_PER_MAC
                     + (act.exp_ops + act.alu_ops) * REG_BYTES_PER_VECOP
                     + act.tsv_bytes * REG_BYTES_PER_TSV_BYTE
                     + H * g.tiles * state_reg)

    act.cycles = wall
    n_arrays = spec.n_tiers * spec.n_clusters
    act.total_pe_cycles = wall * n_arrays
    steady = g.tiles * pipeline_period(stages, d)   # useful fraction
    act.busy_pe_cycles = (4.0 * steady * 0.92
                          * _heads_wall_factor(wl, spec.n_clusters))
    return act


# ===========================================================================
# 2D-Unfused: true kernel-per-operator execution - the semantics
# FlashAttention was invented to eliminate.
# ===========================================================================

def unfused2d_attention(spec: AcceleratorSpec, wl: AttentionWorkload) -> Activity:
    """Every operator materializes its output off-chip: S and P round-trip
    DRAM between kernels, and the softmax chain runs as five separate vector
    kernels (rowmax, subtract, exp, rowsum, scale), each streaming operands
    from/to DRAM.  On-chip SRAM only stages GEMM operand tiles (DMA-in +
    array injection) - unfused scheduling has no cross-kernel residency, and
    GQA K/V sharing is not exploited."""
    d = spec.array_dim
    B = spec.dtype_bytes
    g = TileGeom(wl.seq, d)
    act = Activity()
    H = wl.total_head_instances
    par = spec.n_clusters

    s_bytes = float(wl.seq) * wl.seq * B          # one S (or P) matrix
    dram_bpc = spec.offchip_bytes_per_cycle / spec.n_clusters

    # ---- off-chip intermediate transfers (per head) ------------------------
    # GEMM boundaries: S write (QK^T out), P read (PV in)         -> 2
    # softmax chain:   S r | S r + N w | N r + P w | P r | P r+w  -> 8
    dram_interm = 10.0 * s_bytes

    # ---- phase cycles (per head, one cluster); phases are barriers ---------
    qk_cycles = g.tiles * 2.0 * d + d + s_bytes / dram_bpc        # S to DRAM
    n_elems = float(wl.seq) * wl.seq
    sm_compute = (n_elems * 3.0 / spec.vec_elem_per_cycle         # max+sub+scale
                  + n_elems / spec.vec_exp_per_cycle)             # exp
    sm_cycles = max(sm_compute, 8.0 * s_bytes / dram_bpc)
    pv_cycles = g.tiles * 2.0 * d + d + s_bytes / dram_bpc        # P from DRAM

    per_head_cycles = qk_cycles + sm_cycles + pv_cycles
    wall = per_head_cycles * _heads_wall_factor(wl, par)

    # ---- ops ---------------------------------------------------------------
    act.macs = wl.qk_macs + wl.pv_macs
    act.exp_ops = wl.softmax_elems
    act.alu_ops = wl.softmax_elems * 3.0

    # ---- traffic ------------------------------------------------------------
    inject = g.tiles * 2.0 * d * d * B * 2.0      # (Q,K) + (P,V) injections
    staging = g.tiles * 2.0 * d * d * B * 2.0     # DMA-in staging of the same
    per_head_io = 2.0 * wl.seq * wl.head_dim * B  # Q read + O write
    per_head_kv = 2.0 * wl.seq * wl.head_dim * B  # K + V, per q head (no GQA)
    compulsory = H * (per_head_io + per_head_kv)
    act.sram_bytes = H * (inject + staging + g.Tr * d * d * B)
    act.dram_bytes = compulsory + H * dram_interm
    act.reg_bytes = (act.macs * REG_BYTES_PER_MAC
                     + (act.exp_ops + act.alu_ops) * REG_BYTES_PER_VECOP)

    act.cycles = wall
    act.total_pe_cycles = wall * spec.n_tiers * spec.n_clusters
    # arrays idle during the whole softmax phase and all DRAM stalls
    busy = (g.tiles * 2.0 * d) * 2.0 * 0.92       # QK^T + PV streaming
    act.busy_pe_cycles = busy * _heads_wall_factor(wl, par)
    return act


# ===========================================================================
# 2D-Fused: FuseMax / FLAT / TileFlow-class deep fusion on a single planar
# array per cluster.  No S/P DRAM materialization, but every operator hand-
# off round-trips SRAM, and softmax reductions time-multiplex the array.
# ===========================================================================

def fused2d_attention(spec: AcceleratorSpec, wl: AttentionWorkload) -> Activity:
    d = spec.array_dim
    B = spec.dtype_bytes
    g = TileGeom(wl.seq, d)
    act = Activity()
    H = wl.total_head_instances
    par = spec.n_clusters

    # per-tile array occupancy: QK^T (2d) + PV (2d) + spatial rowmax/rowsum
    # ripple passes (2d) time-multiplexed on ONE array
    compute_ii = 6.0 * d
    # operator hand-offs through SRAM: S out/in, P out/in, O partial r/w
    handoff_bytes = 6.0 * d * d * B
    stall = handoff_bytes / spec.sram_port_bytes_per_cycle
    # FuseMax-style iteration context switching: 10 live registers per PE
    # spilled/restored through the array edge (d elems/cycle)
    ctx = FUSEMAX_CTX_REGS * d * B / 4.0
    period = compute_ii + stall + ctx

    per_head_cycles = period * g.tiles + 5.0 * d
    wall = per_head_cycles * _heads_wall_factor(wl, par)

    act.macs = wl.qk_macs + wl.pv_macs + H * g.tiles * (d * d + d)
    act.exp_ops = wl.softmax_elems + H * g.tiles * d
    act.alu_ops = wl.softmax_elems * 3.0

    inject = g.tiles * 3.0 * d * d * B            # Q,K,V per tile
    interm = g.tiles * (4.0 * d * d * B           # S round-trip, P round-trip
                        + 2.0 * d * d * B         # exp stage reload
                        + 4.0 * d * d * B         # O partial read+write
                        + 8.0 * d * B)            # m,l stats round-trips
    ctx_bytes = g.tiles * FUSEMAX_CTX_REGS * d * B
    act.sram_bytes = H * (inject + interm + ctx_bytes + g.Tr * d * d * B) \
        + _qkv_dram_bytes(wl, B)
    act.dram_bytes = _qkv_dram_bytes(wl, B)
    act.reg_bytes = (act.macs * REG_BYTES_PER_MAC
                     + (act.exp_ops + act.alu_ops) * REG_BYTES_PER_VECOP
                     + H * g.tiles * FUSEMAX_CTX_REGS * d * d * B * 0.25)

    act.cycles = wall
    act.total_pe_cycles = wall * spec.n_tiers * spec.n_clusters
    act.busy_pe_cycles = (compute_ii * g.tiles * 0.92
                          * _heads_wall_factor(wl, par))
    return act


# ===========================================================================
# Dual-SA (COSA-class): QK^T on array A, PV on array B, dedicated softmax SFU
# between them; inter-array transfers over the 2D NoC ("drain-and-inject").
# ===========================================================================

def dualsa_attention(spec: AcceleratorSpec, wl: AttentionWorkload) -> Activity:
    d = spec.array_dim
    B = spec.dtype_bytes
    g = TileGeom(wl.seq, d)
    act = Activity()
    H = wl.total_head_instances
    par = spec.n_clusters          # each cluster = 2 arrays + SFU

    # stage latencies per tile
    qk = 2.0 * d
    # SFU throughput on d^2 exponentials + stats
    sfu = (d * d) / spec.sfu_exp_per_cycle
    pv = 2.0 * d
    # drain S from array A through the NoC into the SFU, then inject P into
    # array B: two transfers of d^2 elements over the 2D NoC
    drain_inject = 2.0 * (d * d * B / spec.noc_bytes_per_cycle
                          + spec.noc_hop_latency)
    # SFU exchanges its operands through SRAM (paper: "its dedicated Softmax
    # unit still relies on SRAM for data exchange")
    sfu_sram_stall = 4.0 * d * d * B / spec.sram_port_bytes_per_cycle
    period = max(qk, pv, sfu + drain_inject + sfu_sram_stall)

    per_head_cycles = period * g.tiles + (qk + sfu + pv + drain_inject)
    wall = per_head_cycles * _heads_wall_factor(wl, par)

    act.macs = wl.qk_macs + wl.pv_macs + H * g.tiles * (d * d + d)
    act.exp_ops = wl.softmax_elems + H * g.tiles * d
    act.alu_ops = wl.softmax_elems * 3.0

    act.noc_bytes = H * g.tiles * 2.0 * d * d * B
    inject = g.tiles * 3.0 * d * d * B
    interm = g.tiles * 8.0 * d * d * B            # SFU in/out via SRAM, both
    #                                               S and P staged + stats
    act.sram_bytes = H * (inject + interm + g.Tr * d * d * B) \
        + _qkv_dram_bytes(wl, B)
    act.dram_bytes = _qkv_dram_bytes(wl, B)
    act.reg_bytes = (act.macs * REG_BYTES_PER_MAC
                     + (act.exp_ops + act.alu_ops) * REG_BYTES_PER_VECOP)

    act.cycles = wall
    act.total_pe_cycles = wall * spec.n_tiers * spec.n_clusters
    act.busy_pe_cycles = ((qk + pv) * g.tiles * 0.92
                          * _heads_wall_factor(wl, par))
    return act


ATTENTION_MODELS = {
    "3D-Flow": flow3d_attention,
    "3D-Base": base3d_attention,
    "2D-Unfused": unfused2d_attention,
    "2D-Fused": fused2d_attention,
    "Dual-SA": dualsa_attention,
}


# ===========================================================================
# Conventional GEMM on the fabric (projections / FFN) - identical across
# designs (the paper's contribution targets the attention core; Table II /
# end-to-end numbers include these).
# ===========================================================================

def gemm_activity(spec: AcceleratorSpec, M: float, K: float, N: float,
                  weight_resident: bool = False) -> Activity:
    """Weight-stationary GEMM (M,K)x(K,N) on all arrays of the device."""
    d = spec.array_dim
    B = spec.dtype_bytes
    act = Activity()
    tiles = (math.ceil(M / d) * math.ceil(K / d) * math.ceil(N / d))
    n_arrays = spec.n_tiers * spec.n_clusters
    act.macs = M * K * N
    act.cycles = tiles * d / n_arrays + 2 * d
    act.sram_bytes = tiles * 2.0 * d * d * B + M * N * B
    w_bytes = K * N * B
    act.dram_bytes = (0.0 if weight_resident else w_bytes) + (M * K + M * N) * B * 0.0
    act.reg_bytes = act.macs * REG_BYTES_PER_MAC
    act.total_pe_cycles = act.cycles * n_arrays
    act.busy_pe_cycles = tiles * d * 0.92
    return act
