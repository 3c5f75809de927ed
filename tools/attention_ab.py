#!/usr/bin/env python3
"""Time two versions of the kernels K1 (paged_prefill.cu), K2
(paged_decode.cu), K3 (dense_decode.cu), K4 (flash_attention.cu), K5
(flash_backward.cu), K6 (mamba2_scan.cu), K7 (rwkv6_scan.cu), K6_bwd
(mamba2_scan_bwd.cu) and K7_bwd (rwkv6_scan_bwd.cu) against each other on
one NVIDIA GPU.

    python3 tools/attention_ab.py --old DIR
        [--kernels K1,...,K7,K6_bwd,K7_bwd] [--serve] [--train]

DIR holds the other version's kernel sources (the .cu files, with any
header they include), for example src/repro_torch/csrc of an earlier commit
unpacked with `git archive` into build/, which .gitignore lists.  Both
versions of each kernel asked for are built with the flags of
repro_torch/kernels/build.py into build/attention_ab/{old,new}, all nvcc
processes started together, and called through their C entry points on
the same inputs at the shapes of the port's main paths, in bf16 (K7 also
in float32):

  K1  the chunked run's chunk batch (chip_smoke.py serving_shape_args): 4
      chunk rows of 256 over prefixes up to 1792, one dead, 32 / 8 heads
      of 64, pages of 16; and the same rows at head dim 128 with qwen-7b's
      28 / 4 heads (G 7) and opt-6.7b's 32 / 32 (G 1)
  K2  the chunked run's decode: 8 sequences of 0..1932 positions, 6348 in
      all, through 128-page table rows, 32 / 8 heads of 64; and the same
      sequences at G 1 (32 KV heads of 64) and at head dim 128 with
      qwen-7b's 28 / 4 heads (G 7) and opt-6.7b's 32 / 32 (G 1)
  K3  the dense run's decode (chip_smoke.py serving_shape_args): 8 strips
      of 2048, lengths 0..2048, 7469 positions, 32 / 8 heads of 64, and
      the same strips with 32 / 8 heads of 128; and zamba2's decode: 4
      strips of 512, lengths 0..511, 32 heads of 80, G 1
  K5  the training backward: q (4, 2048, 32, 64), k / v 8 heads, causal,
      o and lse from the new K4, a random do
  K4  the dense prefill (1, 1904) and (2, 256), 32 / 8 heads of 64; the
      training forward (4, 2048), 32 / 8 heads of 64; zamba2's shared
      block (2, 2048), 32 heads of 80, G 1; granite-8b's forward (1,
      2048), 32 / 8 heads of 128; all causal
  K6  zamba2's forward: x (2, 2048, 80, 64), B / C state 64, seeded dt
      and A as chip_smoke.py's scans get them
  K7  rwkv6's forward: r, k, v (2, 2048, 32, 64), seeded w =
      exp(-exp(N(0, 1) clipped to [-8, 0.75])) and u, in bf16 and float32
  K6_bwd  zamba2's training backward: x, dy (4, 2048, 80, 64), B / C
      state 64, dt and A as K6's, in bf16
  K7_bwd  rwkv6's training backward: r, k, v, dy (4, 2048, 32, 64), w
      and u as K7's, in bf16

K2's and K3's C entry points took no scratch and no split before their
split-KV form, K6's and K7's no scratch before their chunk-parallel
forms; the signature each version takes is read from its source.  K6_bwd's
and K7_bwd's entry points kept their arguments when their bf16 paths
became the chunked form, but not the scratch they point to: each version
gets the layout its source takes (mamba2_scan / rwkv6_scan.bwd_scratch of
bf16 for a source that includes mamba2_chunk.cuh / rwkv6_chunk.cuh, of
float32 - the recurrence's - for one that does not).  For each shape
it prints the old and the new kernel's times, taken in turns (old, new,
new, old: CUDA events, L2 flushed before each run, median of 25 a turn),
one scaled_dot_product_attention call (its backward alone for K5; for K1
and K2 on K/V gathered into contiguous strips beforehand, chip_smoke.py's
k1_library / k2_library; none for K6 and K7, which no single PyTorch
call computes) on the same inputs as the library's yardstick,
the bound the data sheet allows, the achieved rates, the new version's
device time by device kernel (torch.profiler: each pass of a kernel that
launches several), and the largest difference between the old and the
new result, with whether their bits are equal (printed, not judged: the
kernels' own checks are chip_smoke.py's and
tests/test_torch_kernels_cuda.py's).  Each build prints its kernels'
registers, static shared memory and spill stores (ptxas -v) and the
number of bf16 tensor-core instructions (HMMA.16816.F32.BF16) in its SASS.
With --serve it then runs, with the wrappers routed to the old and the
new build of the kernels asked for in turns (serve_ab): chip_smoke.py's
chunked and paged-monolithic traffic on full-width granite-3-2b (K1,
K2), its dense traffic (K3), and the bf16 forward over chip_smoke.py's
2 x 2048 batch of full-width zamba2-2.7b (K6) and rwkv6-1.6b (K7).  With
--train it runs zamba2-2.7b's (K6_bwd) and rwkv6-1.6b's (K7_bwd) training
step as chip_smoke.py's recurrent training does (18 of 54 / 8 of 24
layers, bf16, 4 x 2048, remat full) with the scan's backward routed to
the old and the new build in turns (train_ab).  The last line is {"ab": [...], "serve": [...], "train":
[...], "device": ...}.  Needs a GPU and nvcc; exits non-zero without
them.
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
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.kernels import build, flash_attention, flash_decode  # noqa
from repro_torch.kernels import mamba2_scan, rwkv6_scan  # noqa: E402

PEAK_BYTES_S = 3.35e12          # H100 SXM data sheet: HBM bandwidth
PEAK_FLOP_S = 989e12            # and dense bf16 tensor-core rate
# kernel -> the source it is built from
SOURCES = {"K1": "paged_prefill", "K2": "paged_decode", "K3": "dense_decode",
           "K4": "flash_attention", "K5": "flash_backward",
           "K6": "mamba2_scan", "K7": "rwkv6_scan",
           "K6_bwd": "mamba2_scan_bwd", "K7_bwd": "rwkv6_scan_bwd"}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures before the scratch pointer (K4: before its tile
# arguments): (argtypes, the indices of the current call's arguments the
# old entry point takes)
OLD_SIGNATURES = {
    # q, k, v, o, lse, B, Sq, Skv, Hkv, G, D, causal, window, scale,
    # softcap, is_bf16, stream
    "flash_attention": ((_P,) * 5 + (_I,) * 8 + (_F, _F, _I, _P),
                        [*range(13), *range(15, 19)]),
    # q, k_pages, v_pages, block_table, cache_len, out, B, Hkv, G, D,
    # page_size, n_max, window, scale, softcap, is_bf16, stream
    "paged_decode": ((_P,) * 6 + (_I,) * 7 + (_F, _F, _I, _P),
                     [*range(6), *range(7, 13), *range(14, 19)]),
    # q, k_cache, v_cache, cache_len, out, B, S, Hkv, G, D, window, scale,
    # softcap, is_bf16, stream
    "dense_decode": ((_P,) * 5 + (_I,) * 6 + (_F, _F, _I, _P),
                     [*range(5), *range(6, 11), *range(12, 17)]),
    # x, dt, A, Bm, Cm, y, B, S, H, P, N, is_bf16, stream
    "mamba2_scan": ((_P,) * 6 + (_I,) * 6 + (_P,),
                    [*range(6), *range(7, 14)]),
    # r, k, v, w, u, y, B, S, H, K, V, is_bf16, stream
    "rwkv6_scan": ((_P,) * 6 + (_I,) * 6 + (_P,),
                   [*range(6), *range(7, 14)]),
}
# the text only a current source has (the argument an old one lacks)
NEW_MARKER = {"flash_attention": "block_q"}
# (label, B, S, Hq, Hkv, D) of the K4 shapes
K4_SHAPES = [("dense prefill (1, 1904)", 1, 1904, 32, 8, 64),
             ("dense prefill (2, 256)", 2, 256, 32, 8, 64),
             ("training forward (4, 2048)", 4, 2048, 32, 8, 64),
             ("zamba2 head dim 80 (2, 2048)", 2, 2048, 32, 32, 80),
             ("granite-8b forward, head dim 128 (1, 2048)", 1, 2048, 32, 8,
              128)]
K5_SHAPE = ("training backward (4, 2048)", 4, 2048, 32, 8, 64)
# (label, rows x chunk or sequences, Hq, Hkv, D) of the K1 and K2 calls
K1_SHAPE = ("chunk batch (4 x 256 over prefixes up to 1792)", 4, 256, 32, 8,
            64)
# the same chunk rows at head dim 128: qwen-7b's 28 / 4 heads (G 7) and
# opt-6.7b's 32 / 32 (G 1)
K1_HEAD_SHAPES = [("chunk batch G 7, head dim 128", 4, 256, 28, 4, 128),
                  ("chunk batch G 1, head dim 128", 4, 256, 32, 32, 128)]
K2_SHAPE = ("decode (8 sequences, 6348 positions)", 8, 1, 32, 8, 64)
# the same sequences at G 1 (32 KV heads of 64), and at head dim 128 with
# qwen-7b's and opt-6.7b's heads
K2_HEAD_SHAPES = [("decode G 1 (8 sequences, 6348 positions)",
                   8, 1, 32, 32, 64),
                  ("decode G 7, head dim 128 (8 sequences, 6348 positions)",
                   8, 1, 28, 4, 128),
                  ("decode G 1, head dim 128 (8 sequences, 6348 positions)",
                   8, 1, 32, 32, 128)]
# (label, sequences, Hq, Hkv, D) of the K3 calls; (label, B, S, H, P, N)
# of the K6 call
K3_SHAPE = ("dense decode (8 strips of 2048, 7469 positions)", 8, 32, 8, 64)
K3_D80_SHAPE = ("zamba2 decode (4 strips of 512, 911 positions, head dim "
                "80)", 4, 32, 32, 80)
K3_D128_SHAPE = ("dense decode at head dim 128 (8 strips of 2048, 7469 "
                 "positions)", 8, 32, 8, 128)
K6_SHAPE = ("zamba2 forward scan (2, 2048, 80 heads of 64, state 64)", 2,
            2048, 80, 64, 64)
K6_BWD_SHAPE = ("zamba2 training backward scan (4, 2048, 80 heads of 64, "
                "state 64)", 4, 2048, 80, 64, 64)
# (label, B, S, H, K, V) of the K7 calls
K7_SHAPE = ("rwkv6 forward scan (2, 2048, 32 heads, K = V = 64)", 2, 2048,
            32, 64, 64)
K7_BWD_SHAPE = ("rwkv6 training backward scan (4, 2048, 32 heads, K = V = "
                "64)", 4, 2048, 32, 64, 64)


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
        old = name in OLD_SIGNATURES and NEW_MARKER.get(
            name, "scratch") not in (src / f"{name}.cu").read_text()
        fn = getattr(ctypes.CDLL(str(lib)), symbol)
        fn.argtypes = list(OLD_SIGNATURES[name][0] if old else argtypes)
        fn.restype = ctypes.c_int
        # an old entry point takes the current call without its scratch
        # (and split)
        fns[version][name] = (lambda *a, fn=fn, keep=OLD_SIGNATURES[name][1]:
                              fn(*(a[i] for i in keep))) if old else fn
    return fns


def _kernel_name(mangled: str) -> str:
    """`name<type, int>` of the *_kernel component of a mangled name
    (_ZN, then each component as its length and its text)."""
    i = 3 if mangled.startswith("_ZN") else 2
    while True:
        m = re.match(r"\d+", mangled[i:])
        if not m:
            return mangled
        i += m.end()
        name = mangled[i:i + int(m[0])]
        i += len(name)
        if name.endswith("_kernel"):
            args = re.match(r"I(f|13__nv_bfloat16)?Li(\d+)E", mangled[i:])
            if not args:
                return name
            dtype = {"f": "float, ", "13__nv_bfloat16": "bf16, "}.get(
                args[1], "")
            return f"{name}<{dtype}{args[2]}>"


def ptxas_summary(log: str) -> str:
    """Each kernel instantiation's registers, static shared memory and
    spill stores, from the -Xptxas -v lines of an nvcc log."""
    out = []
    for block in log.split("Compiling entry function")[1:]:
        fn = re.search(r"'(\w+)'", block)
        regs = re.search(r"Used (\d+) registers", block)
        smem = re.search(r"(\d+) bytes smem", block)
        spill = re.search(r"(\d+) bytes spill stores", block)
        if fn and regs:
            out.append(f"{_kernel_name(fn[1])} {regs[1]} regs, "
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

    bq, bkv = flash_attention.tile(D, S, torch.bfloat16)

    def call(ver):
        o, lse = outs[ver]
        err = fns[ver]["flash_attention"](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, S, S, Hkv, Hq // Hkv, D, 1, 0, bq, bkv,
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
        lse.data_ptr(), B, S, S, Hkv, Hq // Hkv, D, 1, 0,
        *flash_attention.tile(D, S, torch.bfloat16), 1.0 / math.sqrt(D),
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


def k1_case(fns, g, heads=None):
    a = chip_smoke.serving_shape_args(torch.bfloat16)[0]
    if heads:                    # the same chunk rows at (Hq, Hkv, D)
        hq, hkv, d = heads
        a["q"] = rnd(g, 4, 256, hq, d)
        a["k_pages"], a["v_pages"] = (rnd(g, 1025, 16, hkv, d)
                                      for _ in range(2))
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


def k2_case(fns, g, split=flash_decode.SPLIT, heads=None):
    a = chip_smoke.serving_shape_args(torch.bfloat16)[1]
    if heads:                    # the same sequences at (Hq, Hkv, D)
        hq, hkv, d = heads
        a["q"] = rnd(g, 8, 1, hq, d)
        a["k_pages"], a["v_pages"] = (rnd(g, 1025, 16, hkv, d)
                                      for _ in range(2))
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


def k3_case(fns, g, zamba2=False, heads=None):
    if zamba2:
        lens = torch.tensor([0, 100, 300, 511], dtype=torch.int32,
                            device="cuda")
        a = dict(q=rnd(g, 4, 1, 32, 80), k_cache=rnd(g, 4, 512, 32, 80),
                 v_cache=rnd(g, 4, 512, 32, 80), cache_len=lens)
    else:
        a = chip_smoke.serving_shape_args(torch.bfloat16)[2]
    if heads:                    # the same strips at (Hq, Hkv, D)
        hq, hkv, d = heads
        a["q"] = rnd(g, 8, 1, hq, d)
        a["k_cache"], a["v_cache"] = (rnd(g, 8, 2048, hkv, d)
                                      for _ in range(2))
    q, kc = a["q"], a["k_cache"]
    B, _, Hq, D = q.shape
    S, Hkv = kc.shape[1], kc.shape[2]
    G = Hq // Hkv
    outs = {ver: torch.empty_like(q) for ver in fns}
    scratch = torch.empty(B * Hkv * -(-S // flash_decode.SPLIT) * G * (D + 2),
                          device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def call(ver):
        err = fns[ver]["dense_decode"](
            q.data_ptr(), kc.data_ptr(), a["v_cache"].data_ptr(),
            a["cache_len"].data_ptr(), outs[ver].data_ptr(),
            scratch.data_ptr(), B, S, Hkv, G, D, flash_decode.SPLIT, 0,
            1.0 / math.sqrt(D), 0.0, 1, stream)
        build.check("dense_decode", err)

    nbytes, flops = chip_smoke.k3_work(a)
    return (call, chip_smoke.k3_library(a), nbytes, flops,
            lambda ver: [outs[ver]])


def k6_args(g, B=2, S=2048, H=80, P=64, N=64):
    """Seeded inputs of zamba2's scan: bf16 x, B, C; float32 dt =
    softplus(N(0, 1)) and A = |N(0, 1)| + 0.1."""
    f32 = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    return dict(x=rnd(g, B, S, H, P),
                dt=torch.nn.functional.softplus(f32(B, S, H)),
                A=f32(H).abs() + 0.1, Bm=rnd(g, B, S, N), Cm=rnd(g, B, S, N))


def k6_case(fns, g):
    a = k6_args(g)
    x = a["x"]
    B, S, H, P = x.shape
    N = a["Bm"].shape[-1]
    outs = {ver: torch.empty_like(x) for ver in fns}
    # the new kernel's carry-in states as two bf16 parts (mamba2_scan.py)
    scratch = torch.empty(B * H * -(-S // mamba2_scan.CHUNK) * 2 * P * N,
                          dtype=torch.bfloat16, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def call(ver):
        err = fns[ver]["mamba2_scan"](
            x.data_ptr(), a["dt"].data_ptr(), a["A"].data_ptr(),
            a["Bm"].data_ptr(), a["Cm"].data_ptr(), outs[ver].data_ptr(),
            scratch.data_ptr(), B, S, H, P, N, 1, stream)
        build.check("mamba2_scan", err)

    nbytes, flops = chip_smoke.k6_work(a)
    return call, None, nbytes, flops, lambda ver: [outs[ver]]


# each scan backward: (its module, its source, the chunked form's header)
SCAN_BWD = {"K6_bwd": (mamba2_scan, "mamba2_scan_bwd", "mamba2_chunk.cuh"),
            "K7_bwd": (rwkv6_scan, "rwkv6_scan_bwd", "rwkv6_chunk.cuh")}
_BWD_SCRATCH = {k: mod.bwd_scratch for k, (mod, *_) in SCAN_BWD.items()}


def chunked_bwd(src: Path, kernel: str = "K6_bwd") -> bool:
    """Whether a scan backward's source has its bf16 path in the chunked
    form (it includes the chunked state scan's header)."""
    _, name, header = SCAN_BWD[kernel]
    return header in (src / f"{name}.cu").read_text()


def bwd_scratch_for(chunked: bool, kernel: str = "K6_bwd"):
    """The module's bwd_scratch as a source of that form takes it in bf16:
    the recurrence (the earlier bf16 path) took the float32 layout."""
    base = _BWD_SCRATCH[kernel]

    def scratch(*shape_dtype_device):
        *shape, dtype, device = shape_dtype_device
        return base(*shape, dtype if chunked else torch.float32, device)
    return scratch


def k6_bwd_case(fns, g, srcs):
    *_, B, S, H, P, N = K6_BWD_SHAPE
    a = k6_args(g, B, S, H, P, N)
    a["dy"] = rnd(g, B, S, H, P)
    x = a["x"]
    outs = {ver: [torch.empty_like(x), torch.empty_like(a["dt"]),
                  torch.empty_like(a["A"]), torch.empty_like(a["Bm"]),
                  torch.empty_like(a["Cm"])] for ver in fns}
    scratch = {ver: bwd_scratch_for(chunked_bwd(srcs[ver]))(
        B, S, H, P, N, x.dtype, x.device) for ver in fns}
    stream = torch.cuda.current_stream().cuda_stream
    for ver in fns:
        print(f"# K6_bwd {ver}: scratch "
              f"{sum(t.numel() * t.element_size() for t in scratch[ver])}"
              f" bytes", flush=True)

    def call(ver):
        err = fns[ver]["mamba2_scan_bwd"](
            x.data_ptr(), a["dt"].data_ptr(), a["A"].data_ptr(),
            a["Bm"].data_ptr(), a["Cm"].data_ptr(), a["dy"].data_ptr(),
            *(t.data_ptr() for t in outs[ver]),
            *(t.data_ptr() for t in scratch[ver]), B, S, H, P, N, 1, stream)
        build.check("mamba2_scan_bwd", err)

    nbytes, flops = chip_smoke.k6_bwd_work(a)
    return call, None, nbytes, flops, lambda ver: outs[ver]


def k7_args(g, dtype, B, S, H, K, V):
    """Seeded inputs of rwkv6's scan: r, k, v in dtype; float32 w =
    exp(-exp(N(0, 1) clipped to [-8, 0.75])) (the model's clamp) and u =
    0.1 N(0, 1)."""
    f32 = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    return dict(r=f32(B, S, H, K).to(dtype), k=f32(B, S, H, K).to(dtype),
                v=f32(B, S, H, V).to(dtype),
                w=torch.exp(-torch.exp(f32(B, S, H, K).clamp(-8.0, 0.75))),
                u=f32(H, K) * 0.1)


def k7_case(fns, g, dtype=torch.bfloat16):
    a = k7_args(g, dtype, *K7_SHAPE[1:])
    r, v = a["r"], a["v"]
    B, S, H, K = r.shape
    V = v.shape[-1]
    outs = {ver: torch.empty_like(v) for ver in fns}
    # the new kernel's carry-in states as two bf16 parts (rwkv6_scan.py)
    scratch = torch.empty(B * H * -(-S // rwkv6_scan.CHUNK) * 2 * K * V,
                          dtype=torch.bfloat16, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def call(ver):
        err = fns[ver]["rwkv6_scan"](
            r.data_ptr(), a["k"].data_ptr(), v.data_ptr(), a["w"].data_ptr(),
            a["u"].data_ptr(), outs[ver].data_ptr(), scratch.data_ptr(), B,
            S, H, K, V, int(dtype == torch.bfloat16), stream)
        build.check("rwkv6_scan", err)

    nbytes, flops = chip_smoke.k7_work(a)
    return call, None, nbytes, flops, lambda ver: [outs[ver]]


def k7_bwd_case(fns, g, srcs):
    *_, B, S, H, K, V = K7_BWD_SHAPE
    a = k7_args(g, torch.bfloat16, B, S, H, K, V)
    a["dy"] = rnd(g, B, S, H, V)
    r = a["r"]
    outs = {ver: [torch.empty_like(a[n]) for n in ("r", "k", "v", "w", "u")]
            for ver in fns}
    scratch = {ver: bwd_scratch_for(chunked_bwd(srcs[ver], "K7_bwd"),
                                    "K7_bwd")(B, S, H, K, V, r.dtype,
                                              r.device) for ver in fns}
    stream = torch.cuda.current_stream().cuda_stream
    for ver in fns:
        print(f"# K7_bwd {ver}: scratch "
              f"{sum(t.numel() * t.element_size() for t in scratch[ver])}"
              f" bytes", flush=True)

    def call(ver):
        err = fns[ver]["rwkv6_scan_bwd"](
            *(a[n].data_ptr() for n in ("r", "k", "v", "w", "u", "dy")),
            *(t.data_ptr() for t in outs[ver]),
            *(t.data_ptr() for t in scratch[ver]), B, S, H, K, V, 1, stream)
        build.check("rwkv6_scan_bwd", err)

    nbytes, flops = chip_smoke.k7_bwd_work(a)
    return call, None, nbytes, flops, lambda ver: outs[ver]


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
    lib_ms = time_ms(library, flush) if library else None
    old_ms, new_ms = float(np.mean(turns["old"])), float(np.mean(turns["new"]))
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FLOP_S
    row = {"kernel": kernel, "shape": label[0], "dims": label[1:],
           "old_ms_turns": turns["old"], "new_ms_turns": turns["new"],
           "old_ms": old_ms, "new_ms": new_ms, "speedup": old_ms / new_ms,
           "library_ms": lib_ms,
           "new_over_library": new_ms / lib_ms if lib_ms else None,
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "flops": flops, "old_tflops": flops / old_ms / 1e9,
           "new_tflops": flops / new_ms / 1e9,
           "max_abs_diff_old_new": diff,
           "same_bits_old_new": all(torch.equal(a, b) for a, b in zip(
               results("old"), results("new"))),
           "new_device_us_by_kernel": device_us_by_kernel(
               lambda: call("new"))}
    print(json.dumps(row), flush=True)
    return row


def device_us_by_kernel(fn, n: int = 10) -> dict:
    """Mean device time (us) of each device kernel one fn() launches, over
    n calls under torch.profiler (device activity only, L2 not flushed):
    the time of each pass of a multi-kernel call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", None) \
                or getattr(e, "self_cuda_time_total", 0)
            out[e.key[:90]] = us / n
    return out


# the serving runs of chip_smoke.py that each kernel's old / new turns
# drive (K6 and K7 drive the zamba2 and rwkv6 forwards, forward_ab)
SERVE_RUNS = {"K1": ("chunked", "paged_monolithic"),
              "K2": ("chunked", "paged_monolithic"), "K3": ("dense",)}


def _route(fns, names, ver):
    for name in names:
        build._loaded[name] = fns[ver][name]


def serve_ab(fns, kernels):
    """chip_smoke.py's serving traffic (8 requests, 32 new tokens each) on
    full-width granite-3-2b through the engines of SERVE_RUNS for the
    kernels asked for, the wrappers of those kernels routed to the old and
    the new build in turns (old, new, new, old): per turn the wall of one
    run, generated tokens/s, median / p95 tick, and the device's busy share
    and port kernels' device time of a second, profiled run.  Everything
    but the routed kernels is the same code in every turn."""
    runs = [r for r in ("chunked", "paged_monolithic", "dense")
            if any(r in SERVE_RUNS.get(k, ()) for k in kernels)]
    if not runs:
        return []
    names = [SOURCES[k] for k in kernels if k in SERVE_RUNS]
    cfg = chip_smoke.get_config("granite-3-2b")
    model = chip_smoke.build_model(cfg)
    params = model.init(seed=0)
    rows = []
    for run in runs:
        scfg = chip_smoke.RUNS[run]
        tokens = {}
        for ver in ("old", "new"):       # warm-up; each version's tokens
            _route(fns, names, ver)
            eng = chip_smoke.run_traffic(model, params, scfg, False)[0]
            tokens[ver] = [r.out_tokens for r in eng.sched.finished]
        print(f"# {run}: old and new kernels served the same tokens: "
              f"{tokens['old'] == tokens['new']}", flush=True)
        for ver in ("old", "new", "new", "old"):
            _route(fns, names, ver)
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
    del model, params
    torch.cuda.empty_cache()
    return rows


# the architecture whose bf16 forward each scan kernel's old / new turns
# drive, and the kernel's source
FORWARDS = {"K6": ("zamba2-2.7b", "mamba2_scan"),
            "K7": ("rwkv6-1.6b", "rwkv6_scan")}


def forward_ab(fns, kernel):
    """The bf16 forward of a full-width recurrent model (zamba2-2.7b for
    K6: 54 Mamba2 layers; rwkv6-1.6b for K7: 24 RWKV6 layers; seeded
    weights) over chip_smoke.py's 2 x 2048 batch, the wrapper of the
    model's scan routed to the old and the new build in turns (old, new,
    new, old): per turn the wall of 3 forwards (each ending in a
    synchronise; median), and the device's busy time, busy share and port
    kernels' device time of a fourth, profiled forward.  The logits of the
    two versions are compared (printed, not judged: the kernels' checks are
    chip_smoke.py's)."""
    arch, name = FORWARDS[kernel]
    cfg = chip_smoke.get_config(arch)
    model = chip_smoke.build_model(cfg)
    params = model.init(seed=0)
    batch = chip_smoke._rec_batch(model)
    logits = {}
    with torch.no_grad():
        for ver in ("old", "new"):       # warm-up; each version's logits
            _route(fns, [name], ver)
            logits[ver] = model.forward(params, batch)[0].float()
        print(f"# {arch} forward: max |logits old - new| "
              f"{float((logits['old'] - logits['new']).abs().max()):.3e}",
              flush=True)
        del logits
        rows = []
        for ver in ("old", "new", "new", "old"):
            _route(fns, [name], ver)
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model.forward(params, batch)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            trace = chip_smoke.device_trace(
                lambda: model.forward(params, batch))
            row = {"forward": arch, "batch": list(chip_smoke.REC_BATCH),
                   "version": ver, "wall_ms": [t * 1e3 for t in times],
                   "wall_ms_median": float(np.median(times)) * 1e3,
                   "profiled_wall_s": trace["profiled_wall_s"],
                   "device_busy_s": trace["device_busy_s"],
                   "busy_share": trace["busy_share"],
                   "port_kernels": trace["port_kernels"]}
            print(json.dumps(row), flush=True)
            rows.append(row)
    build._loaded.clear()
    del model, params
    torch.cuda.empty_cache()
    return rows


# the architecture whose bf16 training step each scan backward's old /
# new turns drive
TRAINS = {"K6_bwd": "zamba2-2.7b", "K7_bwd": "rwkv6-1.6b"}


def train_ab(fns, srcs, kernel):
    """The bf16 training step of the kernel's architecture (zamba2-2.7b for
    K6_bwd, rwkv6-1.6b for K7_bwd) as chip_smoke.py's recurrent_training
    runs it (REC_LAYERS of its layers, seeded weights, one numpy-seeded 4
    x 2048 batch, remat full, make_train_step), with the scan's backward
    wrapper routed to the old and the new build in turns (old, new, new,
    old; each with the scratch layout its source takes): per turn the wall
    of 3 steps (each ending in a synchronise; median), the peak device
    memory over them, and the device's busy time and the port kernels'
    device time of a fourth, profiled step.  One warm-up step per version
    first: the first step's learning rate is 0, so both warm-up steps take
    their gradients at the seeded weights and their printed losses and
    gradient norms compare the two versions from one state.  The turns'
    steps move the weights, so their losses are printed, not compared."""
    from repro_torch.optim import adamw_init
    from repro_torch.train.train_step import TrainState, trainable
    arch = TRAINS[kernel]
    mod, name, _ = SCAN_BWD[kernel]
    cfg = chip_smoke.get_config(arch).replace(
        n_layers=chip_smoke.REC_LAYERS[arch])
    model = chip_smoke.build_model(cfg)
    params = model.init(seed=0)
    tcfg = chip_smoke.TrainConfig(**chip_smoke.REC_TRAIN)
    B, S = tcfg.global_batch, tcfg.seq_len
    state = TrainState(trainable(params), adamw_init(params), {})
    batch = chip_smoke.numpy_batch(cfg, B, S, model.device)
    step = chip_smoke.make_train_step(model, tcfg)

    def route(ver):
        _route(fns, [name], ver)
        mod.bwd_scratch = bwd_scratch_for(chunked_bwd(srcs[ver], kernel),
                                          kernel)

    rows = []
    try:
        for ver in ("old", "new"):
            route(ver)
            state, m = step(state, batch)
            torch.cuda.synchronize()
            print(f"# {arch} training warm-up ({ver}): loss "
                  f"{float(m['loss']):.6f}, grad norm "
                  f"{float(m['grad_norm']):.6f}", flush=True)
        for ver in ("old", "new", "new", "old"):
            route(ver)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times, losses = [], []
            for _ in range(3):
                t0 = time.perf_counter()
                state, m = step(state, batch)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                losses.append(float(m["loss"]))
            peak = torch.cuda.max_memory_allocated()
            trace = chip_smoke.device_trace(lambda: step(state, batch))
            row = {"train": arch, "layers": cfg.n_layers, "batch": [B, S],
                   "version": ver, "step_ms": [t * 1e3 for t in times],
                   "step_ms_median": float(np.median(times)) * 1e3,
                   "peak_mem_gb": peak / 1e9, "losses": losses,
                   "profiled_wall_s": trace["profiled_wall_s"],
                   "device_busy_s": trace["device_busy_s"],
                   "busy_share": trace["busy_share"],
                   "port_kernels": trace["port_kernels"]}
            print(json.dumps(row), flush=True)
            rows.append(row)
    finally:
        mod.bwd_scratch = _BWD_SCRATCH[kernel]
        build._loaded.clear()
    del model, params, state, step
    torch.cuda.empty_cache()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", type=Path, required=True,
                    help="directory with the other version's sources")
    ap.add_argument("--kernels", default="K1,K2,K4,K5",
                    help="comma-separated kernels to time (K1, K2, K3, K4, "
                         "K5, K6, K7, K6_bwd, K7_bwd)")
    ap.add_argument("--serve", action="store_true",
                    help="also run, with the old and the new kernels in "
                         "turns, chip_smoke.py's chunked and "
                         "paged-monolithic traffic (K1, K2), its dense "
                         "traffic (K3) and the zamba2 (K6) and rwkv6 (K7) "
                         "bf16 forwards")
    ap.add_argument("--train", action="store_true",
                    help="also run zamba2's (K6_bwd) and rwkv6's (K7_bwd) "
                         "training step with the old and the new scan "
                         "backward in turns (needs K6_bwd or K7_bwd)")
    ap.add_argument("--k2-splits", default="",
                    help="comma-separated other splits (multiples of 64) at "
                         "which to time the new K2 against the old one, "
                         "beside the wrapper's SPLIT; a split-KV old "
                         "version runs at SPLIT")
    args = ap.parse_args()
    kernels = args.kernels.split(",")
    if not set(kernels) <= set(SOURCES):
        ap.error(f"--kernels takes {sorted(SOURCES)}")
    if args.serve and not {"K1", "K2", "K3", "K6", "K7"} & set(kernels):
        ap.error("--serve needs K1, K2, K3, K6 or K7 among --kernels")
    if args.train and not set(TRAINS) & set(kernels):
        ap.error("--train needs K6_bwd or K7_bwd among --kernels")
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
        rows += [measure(sh, "K1", lambda f, gg, sh=sh: k1_case(
            f, gg, heads=sh[3:]), fns, flush, g) for sh in K1_HEAD_SHAPES]
    if "K2" in kernels:
        rows.append(measure(K2_SHAPE, "K2", k2_case, fns, flush, g))
        for split in filter(None, args.k2_splits.split(",")):
            label = (f"{K2_SHAPE[0]}, split {split}",) + K2_SHAPE[1:]
            rows.append(measure(label, "K2", lambda f, gg, n=int(split):
                                k2_case(f, gg, n), fns, flush, g))
        rows += [measure(sh, "K2", lambda f, gg, sh=sh: k2_case(
            f, gg, heads=sh[3:]), fns, flush, g) for sh in K2_HEAD_SHAPES]
    if "K3" in kernels:
        rows.append(measure(K3_SHAPE, "K3", k3_case, fns, flush, g))
        rows.append(measure(K3_D80_SHAPE, "K3", lambda f, gg: k3_case(
            f, gg, zamba2=True), fns, flush, g))
        rows.append(measure(K3_D128_SHAPE, "K3", lambda f, gg: k3_case(
            f, gg, heads=K3_D128_SHAPE[2:]), fns, flush, g))
    if "K6" in kernels:
        rows.append(measure(K6_SHAPE, "K6", k6_case, fns, flush, g))
    if "K7" in kernels:
        rows.append(measure(K7_SHAPE, "K7", k7_case, fns, flush, g))
        label = (f"{K7_SHAPE[0]}, float32",) + K7_SHAPE[1:]
        rows.append(measure(label, "K7", lambda f, gg: k7_case(
            f, gg, torch.float32), fns, flush, g))
    srcs = {"old": args.old.resolve(), "new": build.CSRC}
    if "K6_bwd" in kernels:
        rows.append(measure(K6_BWD_SHAPE, "K6_bwd", lambda f, gg: k6_bwd_case(
            f, gg, srcs), fns, flush, g))
    if "K7_bwd" in kernels:
        rows.append(measure(K7_BWD_SHAPE, "K7_bwd", lambda f, gg: k7_bwd_case(
            f, gg, srcs), fns, flush, g))
    if "K5" in kernels:
        rows.append(measure(K5_SHAPE, "K5", lambda f, gg: k5_case(
            f, *K5_SHAPE[1:], gg), fns, flush, g))
    if "K4" in kernels:
        rows += [measure(sh, "K4", lambda f, gg, sh=sh: k4_case(
            f, *sh[1:], gg), fns, flush, g) for sh in K4_SHAPES]
    serve = serve_ab(fns, kernels) if args.serve else []
    for kernel in FORWARDS:
        if args.serve and kernel in kernels:
            serve += forward_ab(fns, kernel)
    train = [row for kernel in TRAINS if args.train and kernel in kernels
             for row in train_ab(fns, srcs, kernel)]
    print(card, flush=True)
    print(json.dumps({"ab": rows, "serve": serve, "train": train,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
