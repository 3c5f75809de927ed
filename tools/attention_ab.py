#!/usr/bin/env python3
"""Time two versions of the attention kernels K4 (flash_attention.cu) and
K5 (flash_backward.cu) against each other on one NVIDIA GPU.

    python3 tools/attention_ab.py --old DIR

DIR holds the other version's kernel sources (flash_attention.cu and
flash_backward.cu, with any header they include), for example
src/repro_torch/csrc of an earlier commit unpacked with `git archive` into
build/, which .gitignore lists.  Both versions are built with the flags of
repro_torch/kernels/build.py into build/attention_ab/{old,new}, all four
nvcc processes started together, and called through their C entry points
on the same inputs at the shapes of the port's main paths, in bf16:

  K5  the training backward: q (4, 2048, 32, 64), k / v 8 heads, causal,
      o and lse from the new K4, a random do
  K4  the dense prefill (1, 1904) and (2, 256), 32 / 8 heads of 64; the
      training forward (4, 2048), 32 / 8 heads of 64; zamba2's shared
      block (2, 2048), 32 heads of 80, G 1; all causal

For each shape it prints the old and the new kernel's times, taken in turns
(old, new, new, old: CUDA events, L2 flushed before each run, median of 25
a turn), one scaled_dot_product_attention call (its backward alone for K5)
on the same inputs as the library's yardstick, the bound the data sheet
allows, the achieved rates, and the largest difference between the old
and the new result (printed, not judged: the kernels' own checks are
chip_smoke.py's and tests/test_torch_kernels_cuda.py's).  The last line
is {"ab": [...], "device": ...}.  Needs a GPU and nvcc; exits non-zero
without them.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.kernels import build  # noqa: E402

PEAK_BYTES_S = 3.35e12          # H100 SXM data sheet: HBM bandwidth
PEAK_FLOP_S = 989e12            # and dense bf16 tensor-core rate
NAMES = ("flash_attention", "flash_backward")
# (label, B, S, Hq, Hkv, D) of the K4 shapes
K4_SHAPES = [("dense prefill (1, 1904)", 1, 1904, 32, 8, 64),
             ("dense prefill (2, 256)", 2, 256, 32, 8, 64),
             ("training forward (4, 2048)", 4, 2048, 32, 8, 64),
             ("zamba2 head dim 80 (2, 2048)", 2, 2048, 32, 32, 80)]
K5_SHAPE = ("training backward (4, 2048)", 4, 2048, 32, 8, 64)


def build_both(old_dir: Path):
    """Both versions of both kernels, all nvcc started together; returns
    {version: {name: ctypes function}}."""
    procs = {}
    for version, src in (("old", old_dir), ("new", build.CSRC)):
        out_dir = ROOT / "build" / "attention_ab" / version
        out_dir.mkdir(parents=True, exist_ok=True)
        for name in NAMES:
            lib = out_dir / f"lib{name}.so"
            cmd = [build.nvcc(), *build.FLAGS, "-o", str(lib),
                   str(src / f"{name}.cu")]
            procs[version, name] = (lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    fns = {"old": {}, "new": {}}
    for (version, name), (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {version} {name}:\n{log}")
        print(f"# built {version} {name}: {ptxas_summary(log)}", flush=True)
        symbol, argtypes = build.SIGNATURES[name]
        fn = getattr(ctypes.CDLL(str(lib)), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        fns[version][name] = fn
    return fns


def ptxas_summary(log: str) -> str:
    """Each kernel instantiation's registers and spill stores, from the
    -Xptxas -v lines of an nvcc log."""
    out = []
    for block in log.split("Compiling entry function")[1:]:
        m = re.search(r"((?:flash_attention|flash_attention_bf16|flash_bwd_dq"
                      r"|flash_bwd_dkv|dq_bf16|dkv_bf16)_kernel)I(f)?Li(\d+)E",
                      block)
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores", block)
        if m and regs:
            label = f"{m[1]}<{'float, ' if m[2] else ''}{m[3]}>"
            out.append(f"{label} {regs[1]} regs, "
                       f"{spill[1] if spill else '?'} B spilled")
    return "; ".join(out)


def time_ms(fn, flush: torch.Tensor, n: int = 25, warm: int = 3) -> float:
    """Median CUDA-event time of fn() in ms, L2 flushed before each run."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(n):
        flush.zero_()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def pairs(s: int) -> int:
    """(query, attended key) pairs of one causal head over s positions."""
    return s * (s + 1) // 2


def rnd(g, *shape):
    return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)


def k4_case(fns, B, S, Hq, Hkv, D, g):
    q, k, v = rnd(g, B, S, Hq, D), rnd(g, B, S, Hkv, D), rnd(g, B, S, Hkv, D)
    outs = {ver: (torch.empty_like(q), torch.empty((B, S, Hq), device="cuda"))
            for ver in fns}
    stream = torch.cuda.current_stream().cuda_stream

    def call(ver):
        o, lse = outs[ver]
        err = fns[ver]["flash_attention"](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, S, S, Hkv, Hq // Hkv, D, 1, 0,
            1.0 / math.sqrt(D), 0.0, 1, stream)
        build.check("flash_attention", err)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    qq, kk, vv = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    library = lambda: sdpa(qq, kk, vv, is_causal=True, enable_gqa=True)
    nbytes = 2 * (q.numel() + 2 * k.numel()) + 4 * B * S * Hq
    flops = 4 * D * Hq * B * pairs(S)
    return call, library, nbytes, flops, lambda ver: [outs[ver][0]]


def k5_case(fns, B, S, Hq, Hkv, D, g):
    q, k, v = rnd(g, B, S, Hq, D), rnd(g, B, S, Hkv, D), rnd(g, B, S, Hkv, D)
    do = rnd(g, B, S, Hq, D)
    stream = torch.cuda.current_stream().cuda_stream
    o, lse = torch.empty_like(q), torch.empty((B, S, Hq), device="cuda")
    build.check("flash_attention", fns["new"]["flash_attention"](
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), B, S, S, Hkv, Hq // Hkv, D, 1, 0, 1.0 / math.sqrt(D),
        0.0, 1, stream))
    outs = {ver: (torch.empty_like(q), torch.empty_like(k),
                  torch.empty_like(v), torch.empty((B, S, Hq), device="cuda"))
            for ver in fns}

    def call(ver):
        dq, dk, dv, delta = outs[ver]
        err = fns[ver]["flash_backward"](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(), B, S, S, Hkv, Hq // Hkv, D, 1,
            0, 1.0 / math.sqrt(D), 0.0, 1, stream)
        build.check("flash_backward", err)

    qq, kk, vv = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    dd = do.transpose(1, 2).contiguous()
    out = torch.nn.functional.scaled_dot_product_attention(
        qq, kk, vv, is_causal=True, enable_gqa=True)
    library = lambda: torch.autograd.grad(out, (qq, kk, vv), dd,
                                          retain_graph=True)
    nbytes = 2 * (4 * q.numel() + 4 * k.numel()) + 4 * B * S * Hq
    flops = 10 * D * Hq * B * pairs(S)
    return call, library, nbytes, flops, lambda ver: list(outs[ver][:3])


def measure(label, kernel, case, fns, flush, g):
    call, library, nbytes, flops, results = case(fns, *label[1:], g)
    for ver in ("old", "new"):
        call(ver)
    torch.cuda.synchronize()
    diff = max(float((a.float() - b.float()).abs().max())
               for a, b in zip(results("old"), results("new")))
    turns = {"old": [], "new": []}
    for ver in ("old", "new", "new", "old"):
        turns[ver].append(time_ms(lambda: call(ver), flush))
    lib_ms = time_ms(library, flush)
    old_ms, new_ms = float(np.mean(turns["old"])), float(np.mean(turns["new"]))
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FLOP_S
    row = {"kernel": kernel, "shape": label[0], "B_S_Hq_Hkv_D": label[1:],
           "old_ms_turns": turns["old"], "new_ms_turns": turns["new"],
           "old_ms": old_ms, "new_ms": new_ms, "speedup": old_ms / new_ms,
           "library_ms": lib_ms, "new_over_library": new_ms / lib_ms,
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "flops": flops, "old_tflops": flops / old_ms / 1e9,
           "new_tflops": flops / new_ms / 1e9,
           "max_abs_diff_old_new": diff}
    print(json.dumps(row), flush=True)
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", type=Path, required=True,
                    help="directory with the other version's sources")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attention_ab: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    fns = build_both(args.old.resolve())
    g = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 * 1024 * 1024 // 4, device="cuda")
    rows = [measure(K5_SHAPE, "K5", k5_case, fns, flush, g)]
    rows += [measure(s, "K4", k4_case, fns, flush, g) for s in K4_SHAPES]
    print(card, flush=True)
    print(json.dumps({"ab": rows, "device": torch.cuda.get_device_name(0)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
