"""3D-Flow / 3D-FlashAttention core of the port: the paper's contribution,
framework-free, each module a copy of the JAX package's (the port imports
nothing of that package), and the Hopper tile chooser.

- arch:           Table I accelerator design points
- energy:         Accelergy-style activity -> energy model
- schedule:       latency-balanced tier scheduling (the 2d-cycle pipeline)
- dataflows:      analytical models of 3D-Flow and the four baselines
- simulator:      design x workload sweeps behind every paper figure
- thermal:        the Section III-C thermal check of the 4-tier stack
- workloads:      OPT (MHA) / Qwen (GQA) and assigned-arch attention workloads
- hopper_mapping: the paper's balance principle re-targeted at K4's tiles on
                  an H100 SM, the counterpart of the JAX core/tpu_mapping.py

The simulator's cycles, times and energies are the paper's 16 nm, 1 GHz
model of a hybrid-bonded 3D NPU: no reading of the GPU the port runs on.
No module here imports kernels/ (kernels/flash_attention.py imports
hopper_mapping).
"""
from .arch import DESIGNS, AcceleratorSpec, get_spec
from .energy import Activity, EnergyBreakdown, EnergyTable, energy_of
from .hopper_mapping import BlockConfig, choose_block_config
from .schedule import (balance_chain, balanced_ii, is_bubble_free,
                       pipeline_cycles, threed_flash_schedule)
from .simulator import (SimResult, data_movement, mean_utilization,
                        normalized_energy, simulate_attention, simulate_model,
                        speedups, sweep)
from .thermal import ThermalSpec, junction_temp_c
from .thermal import report as thermal_report
from .workloads import (PAPER_MODELS, PAPER_SEQS, AttentionWorkload,
                        ModelWorkload, from_model_config, opt_6_7b, paper_grid,
                        qwen_7b)

__all__ = [
    "DESIGNS", "AcceleratorSpec", "get_spec",
    "Activity", "EnergyBreakdown", "EnergyTable", "energy_of",
    "balance_chain", "balanced_ii", "is_bubble_free", "pipeline_cycles",
    "threed_flash_schedule",
    "SimResult", "data_movement", "mean_utilization", "normalized_energy",
    "simulate_attention", "simulate_model", "speedups", "sweep",
    "BlockConfig", "choose_block_config",
    "ThermalSpec", "junction_temp_c", "thermal_report",
    "PAPER_MODELS", "PAPER_SEQS", "AttentionWorkload", "ModelWorkload",
    "from_model_config", "opt_6_7b", "paper_grid", "qwen_7b",
]
