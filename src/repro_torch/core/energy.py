"""Accelergy-style activity -> energy model: a copy of the JAX package's
core/energy.py, dataclasses only, for the port's serving telemetry
(serve/telemetry.py movement_breakdown).

Every constant below is the paper's 16 nm model of its hybrid-bonded 3D
NPU - not a reading or a data sheet of the GPU the port runs on.  An
energy that this model gives for a served trace is the energy the paper's
design would spend moving those bytes, never the card's.

Per-action energies start from public technology numbers (Horowitz, ISSCC'14,
scaled 45nm -> 16nm by ~0.35x voltage/cap scaling) and are calibrated within
physically plausible ranges so that the paper's published *ratios* hold
simultaneously (SRAM access = 10-20x FMA per element; Table II shares; Fig 5/6
relative energies).  The TSV z-hop energy is fixed at the paper's own number
(1.35 pJ/byte, from stacked-DRAM analysis, stated as a conservative upper
bound for register-to-register hybrid-bonded transfers).

All energies are Joules; activity counts are raw op / byte counts.
"""
from __future__ import annotations

from dataclasses import dataclass, field, fields


@dataclass
class Activity:
    """Raw activity counts accumulated by a dataflow model."""

    macs: float = 0.0          # bf16 multiply-accumulates
    exp_ops: float = 0.0       # exponential evaluations (exp2-based)
    alu_ops: float = 0.0       # cmp / add / mul vector-lane ops
    reg_bytes: float = 0.0     # register-file bytes read+written
    sram_bytes: float = 0.0    # on-chip SRAM bytes read+written
    dram_bytes: float = 0.0    # off-chip DRAM bytes read+written
    tsv_bytes: float = 0.0     # 3D hybrid-bonded vertical link bytes
    noc_bytes: float = 0.0     # 2D inter-array NoC bytes (Dual-SA)

    cycles: float = 0.0        # wall-clock cycles for the modeled workload
    busy_pe_cycles: float = 0.0
    total_pe_cycles: float = 0.0

    def __add__(self, other: "Activity") -> "Activity":
        out = Activity()
        for f in fields(Activity):
            setattr(out, f.name, getattr(self, f.name) + getattr(other, f.name))
        return out

    def scaled(self, k: float) -> "Activity":
        out = Activity()
        for f in fields(Activity):
            setattr(out, f.name, getattr(self, f.name) * k)
        return out

    @property
    def utilization(self) -> float:
        if self.total_pe_cycles <= 0:
            return 0.0
        return self.busy_pe_cycles / self.total_pe_cycles


@dataclass(frozen=True)
class EnergyTable:
    """pJ-per-action table (stored in Joules)."""

    e_mac: float = 0.05e-12       # bf16 FMA datapath only @16nm (RF metered
    #                                 separately via REG_BYTES_PER_MAC)
    e_exp: float = 1.2e-12        # piecewise exp2 unit (ISCAS'22-style)
    e_alu: float = 0.1e-12        # cmp/add/mul lane op
    e_reg_byte: float = 0.02e-12  # register-file access energy per byte
    # Large (60 MB, heavily banked) on-chip SRAM: ~10 pJ per 2-byte element
    # dynamic access (banking + long wires of a 60 MB macro); the paper's
    # quoted 10-20x-FMA band refers to the cache sizes of [12] - a 60 MB
    # macro sits above it.  Static retention is charged separately below.
    e_sram_byte: float = 12.0e-12
    e_dram_byte: float = 46.0e-12  # LPDDR-class off-chip access (~0.37 nJ/bit)
    e_tsv_byte: float = 1.35e-12   # paper's conservative z-axis number
    e_noc_byte: float = 2.0e-12    # 2D router+link per-byte
    # Static 3D-IC overhead (power delivery / thermal / clock distribution of
    # the stack) as a fraction of dynamic energy of 3D designs:
    static_3d_frac: float = 0.02
    # Static power charged per wall-clock second: 60 MB SRAM retention +
    # periphery (16 nm HD SRAM) and DRAM background/refresh.  Slow designs
    # pay for every stalled cycle - a first-order reason unfused execution
    # loses even at short sequence lengths.  Attributed 70/30 SRAM/DRAM.
    static_w: float = 0.3
    static_sram_frac: float = 0.3

    @staticmethod
    def default16nm() -> "EnergyTable":
        return EnergyTable()


@dataclass
class EnergyBreakdown:
    mac: float = 0.0
    reg: float = 0.0
    sram: float = 0.0
    dram: float = 0.0
    overhead_3d: float = 0.0   # TSV transfers + stack static overhead
    noc: float = 0.0
    vector: float = 0.0        # exp + alu on vector/SFU units

    @property
    def total(self) -> float:
        return (self.mac + self.reg + self.sram + self.dram
                + self.overhead_3d + self.noc + self.vector)

    def as_dict(self) -> dict:
        return {
            "MAC": self.mac,
            "Vector": self.vector,
            "Reg": self.reg,
            "SRAM": self.sram,
            "DRAM": self.dram,
            "NoC": self.noc,
            "3D-IC": self.overhead_3d,
            "Total": self.total,
        }

    def shares(self) -> dict:
        t = self.total or 1.0
        return {k: v / t for k, v in self.as_dict().items() if k != "Total"}


def energy_of(act: Activity, tbl: EnergyTable, *, is_3d: bool = False,
              time_s: float = 0.0) -> EnergyBreakdown:
    """Fold an activity trace into an energy breakdown.

    `time_s` is the wall-clock duration of the workload; SRAM retention /
    idle-logic leakage is charged against it and attributed to SRAM.
    """
    eb = EnergyBreakdown()
    eb.mac = act.macs * tbl.e_mac
    eb.vector = act.exp_ops * tbl.e_exp + act.alu_ops * tbl.e_alu
    eb.reg = act.reg_bytes * tbl.e_reg_byte
    eb.sram = (act.sram_bytes * tbl.e_sram_byte
               + tbl.static_w * tbl.static_sram_frac * time_s)
    eb.dram = (act.dram_bytes * tbl.e_dram_byte
               + tbl.static_w * (1.0 - tbl.static_sram_frac) * time_s)
    eb.noc = act.noc_bytes * tbl.e_noc_byte
    tsv = act.tsv_bytes * tbl.e_tsv_byte
    if is_3d:
        dynamic = eb.mac + eb.vector + eb.reg + eb.sram + eb.dram + eb.noc + tsv
        eb.overhead_3d = tsv + tbl.static_3d_frac * dynamic
    else:
        eb.overhead_3d = tsv
    return eb
