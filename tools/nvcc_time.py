"""Wall time of nvcc on kernel sources, one at a time, with the port's
build flags (repro_torch/kernels/build.py FLAGS): what a source adds to
build_all, which waits for the slowest.

    python3 tools/nvcc_time.py SOURCE.cu [SOURCE.cu ...] [--repeat N]

Each source compiles alone, N times in turns (default 2), into a scratch
library under build/nvcc_time/ (gitignored), with its own directory on
the include path for its headers.  Prints one line a source: the times
and the number of kernel instantiations ptxas reported, then the card's
name and power limit.
"""
import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("sources", nargs="+")
    ap.add_argument("--repeat", type=int, default=2)
    args = ap.parse_args(argv)
    out_dir = ROOT / "build" / "nvcc_time"
    out_dir.mkdir(parents=True, exist_ok=True)
    times = {s: [] for s in args.sources}
    reports = {}
    for _ in range(args.repeat):
        for i, src in enumerate(args.sources):
            src_path = Path(src).resolve()
            cmd = [build.nvcc(), *build.FLAGS, "-I", str(src_path.parent),
                   "-o", str(out_dir / f"lib{i}.so"), str(src_path)]
            t0 = time.perf_counter()
            res = subprocess.run(cmd, capture_output=True, text=True)
            times[src].append(time.perf_counter() - t0)
            if res.returncode != 0:
                print(res.stdout[-3000:], res.stderr[-3000:])
                return 1
            reports[src] = build.ptxas_report(res.stdout + res.stderr)
    for src, ts in times.items():
        rep = reports[src]
        spills = sum(r["spill_bytes"] for r in rep.values())
        print(f"nvcc {src}: {', '.join(f'{t:.1f}' for t in ts)} s; "
              f"{len(rep)} instantiations, {spills} bytes of spills",
              flush=True)
        for fn, r in sorted(rep.items()):
            print(f"    {fn[:100]}: {r['registers']} registers, "
                  f"{r['spill_bytes']} spill bytes, {r['smem']} smem")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
