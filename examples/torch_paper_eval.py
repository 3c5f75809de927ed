"""The paper's evaluation from the port's 3D-Flow co-design simulator
(repro_torch.core): examples/paper_eval.py's numbers without the JAX
package and without its benchmarks/ folder.

    PYTHONPATH=src python examples/torch_paper_eval.py

Every number printed is the paper's 16 nm, 1 GHz analytical model of a
hybrid-bonded 3D NPU (Table I's five design points) - not a reading of the
H100 the port's kernels run on, and not a TPU.  The simulator is
arithmetic on Python floats: this script runs on the CPU and touches no
device.  It prints

  * one CSV row per (design, workload, seq) of the attention core over
    paper_grid() (OPT-6.7B and Qwen-7B at 1K-64K positions), from
    SimResult.row(), each row tagged with the model it comes from;
  * the figure-level reductions over those rows: energy normalized to
    2D-Unfused (Fig. 5), the speedups of 3D-Flow (Fig. 7), the mean PE
    utilization (Fig. 8) and the mean data movement (Fig. 6);
  * simulate_model's end-to-end energy (attention and the projection /
    FFN GEMMs) per design and workload;
  * the Section III-C thermal report of the 4-tier stack.
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.core import (DESIGNS, data_movement, mean_utilization,
                              normalized_energy, paper_grid, simulate_model,
                              speedups, sweep, thermal_report)

MODEL = "paper-3d-npu-16nm-1GHz"
ROW_KEYS = ("design", "workload", "seq", "cycles", "time_s", "energy_J",
            "util", "dram_B", "sram_B", "tsv_B", "noc_B", "reg_B")


def main():
    grid = list(paper_grid())
    results = sweep(list(DESIGNS), [m.attn for m in grid])
    print(f"# attention core, {MODEL} (the paper's 16 nm, 1 GHz 3D NPU "
          f"model; not the H100, not a TPU)")
    print(",".join(ROW_KEYS + ("model",)))
    for r in results:
        row = r.row()
        print(",".join(repr(row[k]) if isinstance(row[k], float)
                       else str(row[k]) for k in ROW_KEYS) + f",{MODEL}")

    print(f"# Fig. 5 energy / 2D-Unfused energy, {MODEL}")
    for d, cells in normalized_energy(results).items():
        for (wl, seq), v in cells.items():
            print(f"normalized_energy,{d},{wl},{seq},{v!r},{MODEL}")
    print(f"# Fig. 7 mean time of the design / time of 3D-Flow, {MODEL}")
    for d, v in speedups(results).items():
        print(f"speedup,{d},{v!r},{MODEL}")
    print(f"# Fig. 8 mean PE-array utilization, {MODEL}")
    for d, v in mean_utilization(results).items():
        print(f"utilization,{d},{v!r},{MODEL}")
    print(f"# Fig. 6 mean bytes moved per workload, {MODEL}")
    for d, levels in data_movement(results).items():
        for level, v in levels.items():
            print(f"data_movement,{d},{level},{v!r},{MODEL}")

    print(f"# end-to-end forward energy (J), attention and GEMMs, {MODEL}")
    for d in DESIGNS:
        for m in grid:
            r = simulate_model(d, m)
            print(f"model_energy_J,{d},{m.name},{m.attn.seq},"
                  f"{r.total_energy!r},{MODEL}")

    print(f"# Section III-C thermal report of the 4-tier stack, {MODEL}")
    for k, v in thermal_report().items():
        print(f"thermal,{k},{v!r},{MODEL}")


if __name__ == "__main__":
    main()
