"""Top-level simulator: design x workload -> cycles / energy / traffic - a
copy of the JAX package's core/simulator.py (framework-free; the port
imports nothing of the JAX package).  Its times and energies are the
paper's 16 nm, 1 GHz model of a 3D NPU: arithmetic on Python floats that
touches no device, and no reading of the GPU the port runs on.

Drives the analytical dataflow models (dataflows.py) and the Accelergy-style
energy model (energy.py); produces the records behind every paper figure.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Optional

from .arch import AcceleratorSpec, get_spec
from .dataflows import ATTENTION_MODELS, gemm_activity
from .energy import Activity, EnergyBreakdown, EnergyTable, energy_of
from .workloads import AttentionWorkload, ModelWorkload


@dataclass
class SimResult:
    design: str
    workload: str
    seq: int
    cycles: float
    time_s: float
    activity: Activity
    energy: EnergyBreakdown
    utilization: float

    @property
    def total_energy(self) -> float:
        return self.energy.total

    def row(self) -> Dict:
        return {
            "design": self.design, "workload": self.workload, "seq": self.seq,
            "cycles": self.cycles, "time_s": self.time_s,
            "energy_J": self.energy.total,
            "util": self.utilization,
            "dram_B": self.activity.dram_bytes,
            "sram_B": self.activity.sram_bytes,
            "tsv_B": self.activity.tsv_bytes,
            "noc_B": self.activity.noc_bytes,
            "reg_B": self.activity.reg_bytes,
        }


def _is_3d(name: str) -> bool:
    return name.startswith("3D")


def simulate_attention(design: str, wl: AttentionWorkload,
                       spec: Optional[AcceleratorSpec] = None,
                       table: Optional[EnergyTable] = None) -> SimResult:
    """Attention-core simulation (paper Figs 5-8)."""
    spec = spec or get_spec(design)
    table = table or EnergyTable.default16nm()
    act = ATTENTION_MODELS[design](spec, wl)
    eb = energy_of(act, table, is_3d=_is_3d(design),
                   time_s=act.cycles / spec.freq_hz)
    return SimResult(design=design, workload=wl.name, seq=wl.seq,
                     cycles=act.cycles, time_s=act.cycles / spec.freq_hz,
                     activity=act, energy=eb, utilization=act.utilization)


def simulate_model(design: str, mwl: ModelWorkload,
                   spec: Optional[AcceleratorSpec] = None,
                   table: Optional[EnergyTable] = None) -> SimResult:
    """End-to-end forward (attention core + projection/FFN GEMMs).

    The GEMM part is identical across designs (the technique targets the
    attention core); weights stream from DRAM once per forward.
    """
    spec = spec or get_spec(design)
    table = table or EnergyTable.default16nm()
    wl = mwl.attn
    act = ATTENTION_MODELS[design](spec, wl)

    # projections: per layer, (seq x d_model) x (d_model x out)
    d_q = wl.n_heads * wl.head_dim
    d_kv = wl.n_kv_heads * wl.head_dim
    tok = wl.seq * wl.batch
    for out in (d_q, d_kv, d_kv, mwl.d_model):
        g = gemm_activity(spec, tok, mwl.d_model, out)
        act = act + g.scaled(wl.n_layers)
    # FFN (gated 3-matmul); MoE runs top_k experts' worth of compute
    mult = mwl.moe_top_k if mwl.moe_top_k else 1
    for (m, k, n) in ((tok, mwl.d_model, mwl.d_ff), (tok, mwl.d_model, mwl.d_ff),
                      (tok, mwl.d_ff, mwl.d_model)):
        g = gemm_activity(spec, m * mult, k, n)
        act = act + g.scaled(wl.n_layers)
    # weight DRAM traffic: whole parameter set streamed once per forward
    act.dram_bytes += mwl.weight_bytes

    eb = energy_of(act, table, is_3d=_is_3d(design),
                   time_s=act.cycles / spec.freq_hz)
    return SimResult(design=design, workload=mwl.name, seq=wl.seq,
                     cycles=act.cycles, time_s=act.cycles / spec.freq_hz,
                     activity=act, energy=eb, utilization=act.utilization)


def sweep(designs: Iterable[str], workloads: Iterable[AttentionWorkload],
          table: Optional[EnergyTable] = None) -> list:
    return [simulate_attention(dsn, wl, table=table)
            for dsn in designs for wl in workloads]


# ---------------------------------------------------------------------------
# Figure-level aggregates
# ---------------------------------------------------------------------------

def normalized_energy(results: list, baseline: str = "2D-Unfused") -> Dict:
    """Fig 5: energy normalized to the 2D-Unfused baseline per (wl, seq)."""
    base = {(r.workload, r.seq): r.total_energy
            for r in results if r.design == baseline}
    out: Dict = {}
    for r in results:
        out.setdefault(r.design, {})[(r.workload, r.seq)] = \
            r.total_energy / base[(r.workload, r.seq)]
    return out


def speedups(results: list, ours: str = "3D-Flow") -> Dict:
    """Fig 7: mean speedup of `ours` over every other design."""
    ours_t = {(r.workload, r.seq): r.time_s for r in results if r.design == ours}
    agg: Dict = {}
    for r in results:
        if r.design == ours:
            continue
        agg.setdefault(r.design, []).append(
            r.time_s / ours_t[(r.workload, r.seq)])
    return {k: sum(v) / len(v) for k, v in agg.items()}


def mean_utilization(results: list) -> Dict:
    agg: Dict = {}
    for r in results:
        agg.setdefault(r.design, []).append(r.utilization)
    return {k: sum(v) / len(v) for k, v in agg.items()}


def data_movement(results: list) -> Dict:
    """Fig 6: mean DRAM / SRAM / vertical traffic per design."""
    agg: Dict = {}
    for r in results:
        e = agg.setdefault(r.design, {"dram": [], "sram": [], "tsv": []})
        e["dram"].append(r.activity.dram_bytes)
        e["sram"].append(r.activity.sram_bytes)
        e["tsv"].append(r.activity.tsv_bytes)
    return {k: {m: sum(v) / len(v) for m, v in d.items()}
            for k, d in agg.items()}
