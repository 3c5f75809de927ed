"""Hardware architecture specifications for 3D-Flow and its baselines: a
copy of the JAX package's core/arch.py (framework-free; the port imports
nothing of the JAX package).  Every figure below is the paper's 16 nm,
1 GHz model of its hybrid-bonded 3D NPU - not the GPU the port runs on.

Reproduces Table I of the paper:

    |                   | Ours / 3D-Base | 2D-Unfused / 2D-Fused | Dual-SA     |
    | Array Size        | 128x128x4      | 128x128               | 128x128x2   |
    | Clusters          | 1              | 4                     | 2           |
    | On-Chip Mem. Size | 60MB           | 60MB                  | 60MB        |
    | On-Chip BW        | 8 TB/s         | 8 TB/s                | 8 TB/s      |
    | Off-Chip BW       | 400 GB/s       | 400 GB/s              | 400 GB/s    |

All designs have identical total compute (128*128*4 PEs) and identical memory
resources; they differ only in how the PEs are organized (stacked tiers vs
planar clusters) and how intermediates move between operators.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

KB = 1024
MB = 1024 * KB
GB = 1024 * MB


@dataclass(frozen=True)
class AcceleratorSpec:
    """Static description of one accelerator design point."""

    name: str
    # -- compute fabric -------------------------------------------------
    array_dim: int = 128          # PE rows == cols of one tier / cluster array
    n_tiers: int = 1              # vertically stacked tiers (3D designs)
    n_clusters: int = 4           # independent planar arrays (2D designs)
    freq_hz: float = 1e9          # 1 GHz clock, paper-typical for 16 nm NPUs
    dtype_bytes: int = 2          # bf16 datapath

    # -- memory hierarchy (Table I) --------------------------------------
    sram_bytes: int = 60 * MB
    onchip_bw_Bps: float = 8e12   # 8 TB/s aggregate SRAM bandwidth
    offchip_bw_Bps: float = 400e9  # 400 GB/s DRAM bandwidth

    # -- microarchitectural knobs (calibrated, the JAX package's values) -
    # Vector/scalar unit throughput for softmax on 2D designs.  The paper's
    # motivation: "softmax runs on slower scalar or vector units, causing
    # stalls".  elem ops (add/cmp/mul) per cycle per cluster:
    vec_elem_per_cycle: float = 26.4
    # exponential throughput (exp is multi-cycle on scalar/vector units):
    vec_exp_per_cycle: float = 3.3
    # Dedicated softmax SFU throughput for Dual-SA (exp/cycle):
    sfu_exp_per_cycle: float = 64.0
    # SRAM port width seen by one array/tier when exchanging intermediates
    # (bytes/cycle).  This is the serialization the paper identifies: "data
    # transfer between large caches and systolic arrays is serialized over
    # multiple cycles".
    sram_port_bytes_per_cycle: float = 1792.0
    # 2D inter-array NoC: router-to-router transfer (Dual-SA drain/inject).
    noc_bytes_per_cycle: float = 80.0
    noc_hop_latency: float = 24.0  # cycles per tile handoff through the NoC
    # fraction of per-cluster SRAM usable for score-matrix residency before
    # the unfused design must spill S/P to DRAM
    sram_resident_frac: float = 0.8
    # 3D hybrid-bonded TSV link: one element per PE per cycle, single-cycle
    # latency (sub-10um pitch hybrid bonding).
    tsv_latency_cycles: float = 1.0

    @property
    def pes_per_array(self) -> int:
        return self.array_dim * self.array_dim

    @property
    def total_pes(self) -> int:
        return self.pes_per_array * self.n_tiers * self.n_clusters

    @property
    def onchip_bytes_per_cycle(self) -> float:
        return self.onchip_bw_Bps / self.freq_hz

    @property
    def offchip_bytes_per_cycle(self) -> float:
        return self.offchip_bw_Bps / self.freq_hz

    def replace(self, **kw) -> "AcceleratorSpec":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Table I design points.  Total PEs identical (= 128*128*4) across designs.
# ---------------------------------------------------------------------------

def ours_3dflow() -> AcceleratorSpec:
    """3D-Flow: one 128x128x4 hybrid-bonded stack, register-to-register TSVs."""
    return AcceleratorSpec(name="3D-Flow", n_tiers=4, n_clusters=1)


def base_3d() -> AcceleratorSpec:
    """3D-Base: architecturally identical stack; operators per tier but
    intermediates exchanged via on-chip SRAM (mapping of ISQED'21 / SiPS'18)."""
    return AcceleratorSpec(name="3D-Base", n_tiers=4, n_clusters=1)


def unfused_2d() -> AcceleratorSpec:
    """2D-Unfused: 4 planar clusters; attention phases run sequentially with
    full S / P materialization through SRAM (and DRAM once SRAM overflows)."""
    return AcceleratorSpec(name="2D-Unfused", n_tiers=1, n_clusters=4)


def fused_2d() -> AcceleratorSpec:
    """2D-Fused: FuseMax / FLAT / TileFlow-class deep fusion on planar arrays."""
    return AcceleratorSpec(name="2D-Fused", n_tiers=1, n_clusters=4)


def dual_sa() -> AcceleratorSpec:
    """Dual-SA: COSA-class dual systolic arrays + dedicated softmax SFU."""
    return AcceleratorSpec(name="Dual-SA", n_tiers=2, n_clusters=2)


DESIGNS = {
    "3D-Flow": ours_3dflow,
    "3D-Base": base_3d,
    "2D-Unfused": unfused_2d,
    "2D-Fused": fused_2d,
    "Dual-SA": dual_sa,
}


def get_spec(name: str) -> AcceleratorSpec:
    try:
        return DESIGNS[name]()
    except KeyError:
        raise KeyError(f"unknown design {name!r}; one of {sorted(DESIGNS)}")
