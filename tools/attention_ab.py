#!/usr/bin/env python3
"""Time two versions of the attention kernels K1 (paged_prefill.cu), K2
(paged_decode.cu), K4 (flash_attention.cu) and K5 (flash_backward.cu)
against each other on one NVIDIA GPU.

    python3 tools/attention_ab.py --old DIR [--kernels K1,K2,K4,K5]

DIR holds the other version's kernel sources (the .cu files, with any
header they include), for example src/repro_torch/csrc of an earlier commit
unpacked with `git archive` into build/, which .gitignore lists.  Both
versions of each kernel asked for are built with the flags of
repro_torch/kernels/build.py into build/attention_ab/{old,new}, all nvcc
processes started together, and called through their C entry points on
the same inputs at the shapes of the port's main paths, in bf16:

  K1  the chunked run's chunk batch (chip_smoke.py serving_shape_args): 4
      chunk rows of 256 over prefixes up to 1792, one dead, 32 / 8 heads
      of 64, pages of 16
  K2  the chunked run's decode: 8 sequences of 0..1932 positions, 6348 in
      all, through 128-page table rows, 32 / 8 heads of 64
  K5  the training backward: q (4, 2048, 32, 64), k / v 8 heads, causal,
      o and lse from the new K4, a random do
  K4  the dense prefill (1, 1904) and (2, 256), 32 / 8 heads of 64; the
      training forward (4, 2048), 32 / 8 heads of 64; zamba2's shared
      block (2, 2048), 32 heads of 80, G 1; all causal

K2's C entry point took no scratch and no split before its split-KV form;
the signature each version takes is read from its source.  For each shape
it prints the old and the new kernel's times, taken in turns (old, new,
new, old: CUDA events, L2 flushed before each run, median of 25 a turn),
one scaled_dot_product_attention call (its backward alone for K5; for K1
and K2 on K/V gathered into contiguous strips beforehand, chip_smoke.py's
k1_library / k2_library) on the same inputs as the library's yardstick,
the bound the data sheet allows, the achieved rates, and the largest
difference between the old and the new result (printed, not judged: the
kernels' own checks are chip_smoke.py's and
tests/test_torch_kernels_cuda.py's).  Each build prints its kernels'
registers, static shared memory and spill stores (ptxas -v) and the
number of bf16 tensor-core instructions (HMMA.16816.F32.BF16) in its SASS.
With --serve it then serves chip_smoke.py's chunked and paged-monolithic
traffic on full-width granite-3-2b with the wrappers' K1 and K2 routed to
the old and the new build in turns (serve_ab).  The last line is {"ab":
[...], "serve": [...], "device": ...}.  Needs a GPU and nvcc; exits
non-zero without them.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.kernels import build, flash_decode  # noqa: E402

PEAK_BYTES_S = 3.35e12          # H100 SXM data sheet: HBM bandwidth
PEAK_FLOP_S = 989e12            # and dense bf16 tensor-core rate
# kernel -> the source it is built from
SOURCES = {"K1": "paged_prefill", "K2": "paged_decode",
           "K4": "flash_attention", "K5": "flash_backward"}
# K2's C signature before its split-KV form: q, k_pages, v_pages,
# block_table, cache_len, out, B, Hkv, G, D, page_size, n_max, window,
# scale, softcap, is_bf16, stream
K2_UNSPLIT = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 7 + (
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p)
# (label, B, S, Hq, Hkv, D) of the K4 shapes
K4_SHAPES = [("dense prefill (1, 1904)", 1, 1904, 32, 8, 64),
             ("dense prefill (2, 256)", 2, 256, 32, 8, 64),
             ("training forward (4, 2048)", 4, 2048, 32, 8, 64),
             ("zamba2 head dim 80 (2, 2048)", 2, 2048, 32, 32, 80)]
K5_SHAPE = ("training backward (4, 2048)", 4, 2048, 32, 8, 64)
# (label, rows x chunk or sequences, Hq, Hkv, D) of the K1 and K2 calls
K1_SHAPE = ("chunk batch (4 x 256 over prefixes up to 1792)", 4, 256, 32, 8,
            64)
K2_SHAPE = ("decode (8 sequences, 6348 positions)", 8, 1, 32, 8, 64)


def build_both(old_dir: Path, names):
    """Both versions of the kernels `names` (source stems), all nvcc started
    together; returns {version: {name: ctypes function}}."""
    procs = {}
    for version, src in (("old", old_dir), ("new", build.CSRC)):
        out_dir = ROOT / "build" / "attention_ab" / version
        out_dir.mkdir(parents=True, exist_ok=True)
        for name in names:
            lib = out_dir / f"lib{name}.so"
            cmd = [build.nvcc(), *build.FLAGS, "-o", str(lib),
                   str(src / f"{name}.cu")]
            procs[version, name] = (src, lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    fns = {"old": {}, "new": {}}
    for (version, name), (src, lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {version} {name}:\n{log}")
        print(f"# built {version} {name}: {ptxas_summary(log)}; "
              f"{hmma_count(lib)} HMMA.16816.F32.BF16 in its SASS",
              flush=True)
        symbol, argtypes = build.SIGNATURES[name]
        unsplit = name == "paged_decode" and "scratch" not in (
            src / f"{name}.cu").read_text()
        fn = getattr(ctypes.CDLL(str(lib)), symbol)
        fn.argtypes = list(K2_UNSPLIT if unsplit else argtypes)
        fn.restype = ctypes.c_int
        # an unsplit K2 takes the split-KV call without scratch and split
        fns[version][name] = (lambda *a, fn=fn: fn(*a[:6], *a[7:13], *a[14:])
                              ) if unsplit else fn
    return fns


def ptxas_summary(log: str) -> str:
    """Each kernel instantiation's registers, static shared memory and
    spill stores, from the -Xptxas -v lines of an nvcc log."""
    out = []
    for block in log.split("Compiling entry function")[1:]:
        m = re.search(r"(\w+?_kernel)I(f|13__nv_bfloat16)?Li(\d+)E", block)
        regs = re.search(r"Used (\d+) registers", block)
        smem = re.search(r"(\d+) bytes smem", block)
        spill = re.search(r"(\d+) bytes spill stores", block)
        if m and regs:
            dtype = {"f": "float, ", "13__nv_bfloat16": "bf16, "}.get(m[2],
                                                                      "")
            out.append(f"{m[1]}<{dtype}{m[3]}> {regs[1]} regs, "
                       f"{smem[1] if smem else '?'} B static smem, "
                       f"{spill[1] if spill else '?'} B spilled")
    return "; ".join(out)


def hmma_count(lib: Path):
    """bf16 mma.sync instructions in a library's SASS (cuobjdump -sass), or
    None without cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    return sass.count("HMMA.16816.F32.BF16")


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


def _i32_ptrs(a, *names):
    return [a[n].data_ptr() for n in names]


def k1_case(fns, g):
    a = chip_smoke.serving_shape_args(torch.bfloat16)[0]
    q = a["q"]
    K, S, Hq, D = q.shape
    ps, Hkv = a["k_pages"].shape[1], a["k_pages"].shape[2]
    n_max = a["page_tables"].shape[1]
    a["q_lens"] = torch.clamp(a["true_lens"] - a["q_offsets"], 0,
                              S).to(torch.int32)
    outs = {ver: torch.empty_like(q) for ver in fns}
    stream = torch.cuda.current_stream().cuda_stream

    def call(ver):
        err = fns[ver]["paged_prefill"](
            q.data_ptr(), a["k_pages"].data_ptr(), a["v_pages"].data_ptr(),
            *_i32_ptrs(a, "page_tables", "q_offsets", "true_lens", "q_lens"),
            outs[ver].data_ptr(), K, S, Hkv, Hq // Hkv, D, ps, n_max, 0,
            1.0 / math.sqrt(D), 0.0, 1, stream)
        build.check("paged_prefill", err)

    nbytes, flops = chip_smoke.k1_work(a)
    return (call, chip_smoke.k1_library(a), nbytes, flops,
            lambda ver: [outs[ver]])


def k2_case(fns, g, split=flash_decode.SPLIT):
    a = chip_smoke.serving_shape_args(torch.bfloat16)[1]
    q = a["q"]
    B, _, Hq, D = q.shape
    ps, Hkv = a["k_pages"].shape[1], a["k_pages"].shape[2]
    n_max = a["block_table"].shape[1]
    G = Hq // Hkv
    outs = {ver: torch.empty_like(q) for ver in fns}
    n_split = -(-n_max * ps // min(split, flash_decode.SPLIT))
    scratch = torch.empty(B * Hkv * n_split * G * (D + 2), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def call(ver):
        err = fns[ver]["paged_decode"](
            q.data_ptr(), a["k_pages"].data_ptr(), a["v_pages"].data_ptr(),
            *_i32_ptrs(a, "block_table", "cache_len"), outs[ver].data_ptr(),
            scratch.data_ptr(), B, Hkv, G, D, ps, n_max,
            flash_decode.SPLIT if ver == "old" else split, 0,
            1.0 / math.sqrt(D), 0.0, 1, stream)
        build.check("paged_decode", err)

    nbytes, flops = chip_smoke.k2_work(a)
    return (call, chip_smoke.k2_library(a), nbytes, flops,
            lambda ver: [outs[ver]])


def measure(label, kernel, case, fns, flush, g):
    call, library, nbytes, flops, results = case(fns, g)
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
    row = {"kernel": kernel, "shape": label[0], "dims": label[1:],
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


SERVE_RUNS = ("chunked", "paged_monolithic")


def serve_ab(fns):
    """chip_smoke.py's serving traffic (8 requests, 32 new tokens each) on
    full-width granite-3-2b through the chunked and the paged-monolithic
    engine, the wrappers' K1 and K2 routed to the old and the new build in
    turns (old, new, new, old): per turn the wall of one run, generated
    tokens/s, median / p95 tick, and the device's busy share and K1 / K2
    device time of a second, profiled run.  Everything but K1 and K2 is
    the same code in every turn."""
    cfg = chip_smoke.get_config("granite-3-2b")
    model = chip_smoke.build_model(cfg)
    params = model.init(seed=0)
    rows = []

    def route(ver):
        for name in ("paged_prefill", "paged_decode"):
            build._loaded[name] = fns[ver][name]

    for run in SERVE_RUNS:
        scfg = chip_smoke.RUNS[run]
        tokens = {}
        for ver in ("old", "new"):       # warm-up; each version's tokens
            route(ver)
            eng = chip_smoke.run_traffic(model, params, scfg, False)[0]
            tokens[ver] = [r.out_tokens for r in eng.sched.finished]
        print(f"# {run}: old and new kernels served the same tokens: "
              f"{tokens['old'] == tokens['new']}", flush=True)
        for ver in ("old", "new", "new", "old"):
            route(ver)
            eng, tick_s, _, wall = chip_smoke.run_traffic(model, params,
                                                          scfg, False)
            trace = chip_smoke.device_trace(
                lambda: chip_smoke.run_traffic(model, params, scfg, False))
            stats = eng.stats()
            row = {"serve": run, "version": ver, "wall_s": wall,
                   "gen_tok_s": stats["gen_tokens"] / wall,
                   "prefill_tok_s": stats["prefill_tokens"] / wall,
                   "tick_ms_median": float(np.median(tick_s)) * 1e3,
                   "tick_ms_p95": float(np.percentile(tick_s, 95)) * 1e3,
                   "ticks": len(tick_s),
                   "profiled_wall_s": trace["profiled_wall_s"],
                   "device_busy_s": trace["device_busy_s"],
                   "busy_share": trace["busy_share"],
                   "port_kernels": trace["port_kernels"]}
            print(json.dumps(row), flush=True)
            rows.append(row)
    build._loaded.clear()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", type=Path, required=True,
                    help="directory with the other version's sources")
    ap.add_argument("--kernels", default="K1,K2,K4,K5",
                    help="comma-separated kernels to time (K1, K2, K4, K5)")
    ap.add_argument("--serve", action="store_true",
                    help="also serve chip_smoke.py's chunked and "
                         "paged-monolithic traffic with the old and the new "
                         "K1 / K2 in turns (needs K1 and K2)")
    ap.add_argument("--k2-splits", default="",
                    help="comma-separated other splits (multiples of 64) at "
                         "which to time the new K2 against the old one, "
                         "beside the wrapper's SPLIT; a split-KV old "
                         "version runs at SPLIT")
    args = ap.parse_args()
    kernels = args.kernels.split(",")
    if not set(kernels) <= set(SOURCES):
        ap.error(f"--kernels takes {sorted(SOURCES)}")
    if args.serve and not {"K1", "K2"} <= set(kernels):
        ap.error("--serve needs K1 and K2 among --kernels")
    if not torch.cuda.is_available():
        print("attention_ab: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    # K5's o and lse come from the new K4
    names = {SOURCES[k] for k in kernels} | (
        {"flash_attention"} if "K5" in kernels else set())
    fns = build_both(args.old.resolve(), sorted(names))
    g = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 * 1024 * 1024 // 4, device="cuda")
    rows = []
    if "K1" in kernels:
        rows.append(measure(K1_SHAPE, "K1", k1_case, fns, flush, g))
    if "K2" in kernels:
        rows.append(measure(K2_SHAPE, "K2", k2_case, fns, flush, g))
        for split in filter(None, args.k2_splits.split(",")):
            label = (f"{K2_SHAPE[0]}, split {split}",) + K2_SHAPE[1:]
            rows.append(measure(label, "K2", lambda f, gg, n=int(split):
                                k2_case(f, gg, n), fns, flush, g))
    if "K5" in kernels:
        rows.append(measure(K5_SHAPE, "K5", lambda f, gg: k5_case(
            f, *K5_SHAPE[1:], gg), fns, flush, g))
    if "K4" in kernels:
        rows += [measure(sh, "K4", lambda f, gg, sh=sh: k4_case(
            f, *sh[1:], gg), fns, flush, g) for sh in K4_SHAPES]
    serve = serve_ab(fns) if args.serve else []
    print(card, flush=True)
    print(json.dumps({"ab": rows, "serve": serve,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
