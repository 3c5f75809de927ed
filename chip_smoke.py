#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one GPU

Phases (each raises on failure, so the run exits non-zero):

  1. device and build   the card's name and power limit (nvidia-smi), then
                        every CUDA kernel of repro_torch built from
                        src/repro_torch/csrc with nvcc for sm_90a.
  2. kernel parity      the hand-written kernels against their plain
                        PyTorch versions on the card: the edge cases of
                        tests/test_torch_kernels_cuda.py (run with pytest),
                        and the serving shapes (head dim 64, 4 query heads
                        per KV head, page size 16) in float32 and bfloat16.
  3. the slice          granite-3-2b at full width (40 layers, bf16, seeded
                        weights) served by the paged, chunked, batched
                        ServeEngine: 8 requests, 32 new tokens each, with
                        check_invariants() after every tick.  A warm-up run
                        first, then the counted run: every kernel's launch
                        count is set to 0 just before it and read just after,
                        and each must equal 40 x the engine's launches of
                        its kind.  Implicit host syncs inside the counted
                        ticks are counted with torch.cuda's sync debug mode
                        (the one token fetch per tick excepted).  Then one
                        chunk batch plus one decode step at full width
                        through the kernels and through impl="ref".
  4. times              per kernel, at the arguments the slice gave it:
                        kernel, plain version and library times (CUDA
                        events, L2 flushed, median of 25) beside the bound
                        the card's data sheet allows; then the end-to-end
                        numbers of the counted run.
  5. trace              the traffic once more under torch.profiler (device
                        activity only): device time by kernel name, and the
                        device's busy share of that same run's wall time.

Output: the nvidia-smi line, one {"kernels": [...]} line, one {"trace":
...} line, one {"e2e": ...} line, and as the last line {"ok": true,
"device": {...}}.  Without a GPU it
exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import ServeConfig, get_config  # noqa: E402
from repro_torch.kernels import build, flash_decode, ops  # noqa: E402
from repro_torch.kernels import paged_prefill  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

# H100 SXM data sheet: HBM bandwidth and dense bf16 tensor-core rate
PEAK_BYTES_S = 3.35e12
PEAK_FLOP_S = 989e12
F32_TOL = 1e-5
BF16_RTOL = 2.0 ** -7            # one bfloat16 rounding step of the output
# full-width bf16 logits, kernels vs ref: the H100 run measured 0.068
# (chunk batch) and 0.071 (decode step) at a logit scale of ~4; the bar
# leaves a margin of ~1.7x over those
LOGIT_BAR = 0.12
PROMPT_LENS = (37, 128, 300, 511, 700, 1024, 1500, 1900)
NEW_TOKENS = 32
SCFG = dict(max_batch=8, max_seq=2048, page_size=16, prefill_chunk=256,
            tick_token_budget=1024, max_new_tokens=NEW_TOKENS, paged=True,
            chunked=True, batched=True)


def log(msg: str):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def phase_device_and_build():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    secs, logs = build.build_all()
    log(f"# built {sorted(logs)} in {secs:.1f} s (nvcc, sm_90a, in parallel)")
    for name, text in logs.items():
        for line in text.splitlines():
            if re.search(r"registers|spill", line):
                log(f"#   {name}: {line.strip()}")


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

def compare(got: torch.Tensor, want: torch.Tensor, dtype) -> float:
    """Max |kernel - plain|; raises past the bar of the dtype."""
    g, w = got.float(), want.float()
    err = float((g - w).abs().max())
    bar = (BF16_RTOL * w.abs() + 1e-6) if dtype == torch.bfloat16 \
        else torch.full_like(w, F32_TOL)
    if not bool(((g - w).abs() <= bar).all()):
        raise AssertionError(f"kernel disagrees with its plain version: max "
                             f"abs err {err:.3e} ({dtype})")
    return err


def serving_shape_args(dtype, seed=0):
    """K1 and K2 inputs at the slice's shapes: 8 KV heads of dim 64, 32
    query heads, pages of 16 in a 1025-page pool, 128-page table rows."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    pool = lambda: torch.randn((1025, 16, 8, 64), generator=g, device=dev,
                               dtype=torch.float32).to(dtype)
    k, v = pool(), pool()
    perm = torch.randperm(1024, generator=g, device=dev).to(torch.int32) + 1
    tables = perm[:8 * 128].reshape(8, 128).contiguous()
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)
    # chunk rows: a first chunk, a ragged final chunk, mid-prompt chunks,
    # and a dead padding row (all-null table)
    k1_tables = tables[:4].clone()
    k1_tables[3] = 0
    k1 = dict(q=torch.randn((4, 256, 32, 64), generator=g, device=dev,
                            dtype=torch.float32).to(dtype),
              k_pages=k, v_pages=v, page_tables=k1_tables,
              q_offsets=i32([0, 256, 1536, 0]),
              true_lens=i32([256, 300, 1792, 0]))
    k2 = dict(q=torch.randn((8, 1, 32, 64), generator=g, device=dev,
                            dtype=torch.float32).to(dtype),
              k_pages=k, v_pages=v, block_table=tables,
              cache_len=i32([38, 129, 301, 512, 701, 0, 1501, 1932]))
    return k1, k2


def k1_call(a, impl=None):
    return ops.batched_paged_prefill_attention(
        a["q"], a["k_pages"], a["v_pages"], a["page_tables"],
        a["q_offsets"], a["true_lens"], a.get("q_lens"), impl=impl)


def k2_call(a, impl=None):
    return ops.paged_flash_decode(a["q"], a["k_pages"], a["v_pages"],
                                  a["block_table"], a["cache_len"],
                                  impl=impl)


def phase_kernel_parity():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "--noconftest", "-m", "cuda",
         str(ROOT / "tests" / "test_torch_kernels_cuda.py")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    summary = res.stdout.strip().splitlines()[-1] if res.stdout else ""
    if res.returncode != 0 or "skipped" in summary or "passed" not in summary:
        raise AssertionError(f"edge-case parity failed:\n{res.stdout[-4000:]}"
                             f"\n{res.stderr[-2000:]}")
    log(f"# edge cases (tests/test_torch_kernels_cuda.py): {summary}")
    for dtype in (torch.float32, torch.bfloat16):
        a1, a2 = serving_shape_args(dtype)
        o1 = k1_call(a1)
        if o1[3].any() or o1[1, 44:].any():
            raise AssertionError("K1: dead row or pad lanes not exactly 0")
        e1 = compare(o1, k1_call(a1, "ref"), dtype)
        o2 = k2_call(a2)
        if o2[5].any():
            raise AssertionError("K2: idle lane not exactly 0")
        e2 = compare(o2, k2_call(a2, "ref"), dtype)
        bar = "1e-5 abs" if dtype == torch.float32 else "2^-7 rel"
        log(f"# serving shapes {str(dtype)[6:]}: K1 max abs err {e1:.3e}, "
            f"K2 max abs err {e2:.3e} (bar {bar})")
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

class Capture:
    """Wraps a kernel module's wrapper and keeps the arguments of its
    largest call (by attended positions), cloned, for the timing phase.
    Used in the warm-up run only; the wrapped call is the original."""

    def __init__(self, module, attr, weight):
        self.module, self.attr, self.weight = module, attr, weight
        self.orig = getattr(module, attr)
        self.best, self.best_w = None, -1

    def __enter__(self):
        def wrapped(*args, **kw):
            w = self.weight(*args)
            if w > self.best_w:
                self.best_w = w
                self.best = ([a.clone() if torch.is_tensor(a) else a
                              for a in args], dict(kw))
            return self.orig(*args, **kw)
        setattr(self.module, self.attr, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.orig)


def _k1_weight(q, kp, vp, tables, offs, tls, qls=None):
    return int((tls - offs).clamp(min=0).sum()) * 1_000_000 + int(tls.sum())


def _k2_weight(q, kp, vp, bt, lens):
    return int(lens.sum())


def run_traffic(model, params, count_syncs: bool):
    """Serve the 8 requests to completion.  Returns (engine, per-tick wall
    seconds, implicit sync warnings, wall seconds)."""
    eng = ServeEngine(model, params, ServeConfig(**SCFG))
    rng = np.random.default_rng(0)
    for n in PROMPT_LENS:
        eng.submit(rng.integers(1, model.cfg.vocab_size, n).tolist())
    fetch = eng._fetch_tokens
    if count_syncs:
        def quiet_fetch():          # the one expected sync, not counted
            torch.cuda.set_sync_debug_mode(0)
            try:
                return fetch()
            finally:
                torch.cuda.set_sync_debug_mode("warn")
        eng._fetch_tokens = quiet_fetch
    tick_s, syncs = [], 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while eng.queue or any(s is not None for s in eng.slots):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if count_syncs:
                torch.cuda.set_sync_debug_mode("warn")
            ts = time.perf_counter()
            try:
                eng.tick()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            tick_s.append(time.perf_counter() - ts)
        syncs += sum("synchroniz" in str(w.message) for w in caught)
        eng.check_invariants()
        if len(tick_s) > 1000:
            raise AssertionError("traffic did not drain in 1000 ticks")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eng._fetch_tokens = fetch
    return eng, tick_s, syncs, wall


def phase_slice():
    cfg = get_config("granite-3-2b")
    t0 = time.perf_counter()
    model = build_model(cfg)                         # on the GPU
    params = model.init(seed=0)
    torch.cuda.synchronize()
    log(f"# granite-3-2b: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.2f} B params "
        f"({cfg.dtype}), built and seeded in {time.perf_counter() - t0:.1f} s")

    with Capture(paged_prefill, "batched_paged_prefill_attention",
                 _k1_weight) as c1, \
            Capture(flash_decode, "paged_flash_decode", _k2_weight) as c2:
        run_traffic(model, params, count_syncs=False)      # warm-up

    torch.cuda.reset_peak_memory_stats()
    paged_prefill.launches = 0
    flash_decode.launches = 0
    eng, tick_s, syncs, wall = run_traffic(model, params, count_syncs=True)
    launches = {"K1": paged_prefill.launches, "K2": flash_decode.launches}
    peak = torch.cuda.max_memory_allocated()

    done = eng.sched.finished
    if len(done) != len(PROMPT_LENS) or any(
            len(r.out_tokens) != NEW_TOKENS for r in done):
        raise AssertionError(f"not every request finished with {NEW_TOKENS}"
                             f" tokens: {[len(r.out_tokens) for r in done]}")
    for calls, host, _, n_chunks, n_dec in eng.launch_log:
        if calls > 2 or host != (1 if calls else 0):
            raise AssertionError(f"tick made {calls} launches and {host} "
                                 f"fetches")
    kinds = [r.kind for r in eng.launch_records()]
    n_chunk, n_decode = kinds.count("chunk_batch"), kinds.count("decode")
    if any(sum(1 for r in eng.launch_records() if r.tick == t
               and r.kind == kind) > 1
           for t in range(len(eng.launch_log))
           for kind in ("chunk_batch", "decode")):
        raise AssertionError("a tick made two launches of one kind")
    L = cfg.n_layers
    if launches["K1"] != L * n_chunk or launches["K2"] != L * n_decode:
        raise AssertionError(
            f"kernel launches {launches} != {L} x (chunk batches {n_chunk},"
            f" decodes {n_decode})")
    toks = np.array([t for r in done for t in r.out_tokens])
    if toks.min() < 0 or toks.max() >= cfg.vocab_size:
        raise AssertionError("generated token ids out of the vocabulary")
    log(f"# served {len(done)} requests x {NEW_TOKENS} tokens in "
        f"{len(eng.launch_log)} ticks: {n_chunk} chunk-batch + {n_decode} "
        f"decode launches, K1 {launches['K1']} / K2 {launches['K2']} "
        f"kernel launches, implicit host syncs in the ticks: {syncs}")
    model_check(model, params)
    stats = eng.stats()
    e2e = {"gen_tokens": stats["gen_tokens"],
           "prefill_tokens": stats["prefill_tokens"],
           "ticks": len(eng.launch_log),
           "busy_ticks": sum(1 for r in eng.launch_log if r[0]),
           "wall_s": wall,
           "gen_tok_s": stats["gen_tokens"] / wall,
           "prefill_tok_s": stats["prefill_tokens"] / wall,
           "tick_ms_median": float(np.median(tick_s)) * 1e3,
           "tick_ms_p95": float(np.percentile(tick_s, 95)) * 1e3,
           "peak_mem_gb": peak / 1e9,
           "kv_pool_gb": eng.kv_cache_bytes() / 1e9,
           "implicit_syncs": syncs,
           "host_syncs": stats["host_syncs"]}
    ticks = len(eng.launch_log)
    per_tick = {"K1": launches["K1"] / ticks, "K2": launches["K2"] / ticks}
    return launches, per_tick, e2e, c1.best, c2.best, (model, params)


def model_check(model, params):
    """One chunk batch and one decode step at full width through the
    kernels and through impl="ref" (separate caches, same inputs)."""
    dev = model.device
    rng = np.random.default_rng(1)
    i32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.int32,
                                 device=dev)
    toks = rng.integers(1, model.cfg.vocab_size, (2, 256))
    toks[1, 200:] = 0
    table = np.zeros((2, 32), np.int32)
    table[0, :17], table[1, :17] = np.arange(1, 18), np.arange(18, 35)
    batch = {"tokens": i32(toks), "offset": i32([0, 0]),
             "true_lens": i32([256, 200])}
    out = {}
    for impl in (None, "ref"):
        cache = model.init_cache(2, 512, page_size=16, num_pages=65)
        lp, cache, lens = model.prefill_chunks(params, batch, cache,
                                               i32(table), impl=impl)
        cache["block_table"] = i32(table)
        nxt = torch.argmax(lp[:, 0], -1, keepdim=True).to(torch.int32)
        ld, _ = model.decode_step(params, nxt, lens, cache, impl=impl)
        out[impl] = (lp, ld)
    for name, i in (("chunk batch", 0), ("decode step", 1)):
        a, b = out[None][i], out["ref"][i]
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{name}: non-finite logits")
        err = float((a - b).abs().max())
        log(f"# full-width {name}: logits max |kernels - ref| {err:.3e} "
            f"(bf16 bar {LOGIT_BAR}, logit scale "
            f"{float(b.abs().max()):.2f})")
        if err > LOGIT_BAR:
            raise AssertionError(f"{name}: kernels and ref disagree")


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------

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


def k1_work(a):
    """Bytes this call must move and FLOPs its data needs: q and the output
    once, each row's K/V positions below its cursor once; 4*D*Hq FLOPs per
    (live query, attended key) pair."""
    q = a["q"]
    K, S, Hq, D = q.shape
    Hkv = a["k_pages"].shape[2]
    el = q.element_size()
    offs, tls = a["q_offsets"].cpu().numpy(), a["true_lens"].cpu().numpy()
    pairs, kv_pos = 0, 0
    for off, tl in zip(offs, tls):
        n = max(int(tl) - int(off), 0)
        pairs += sum(min(int(off) + s + 1, int(tl)) for s in range(n))
        kv_pos += int(tl)
    nbytes = 2 * q.numel() * el + 2 * kv_pos * Hkv * D * el
    return nbytes, 4 * D * Hq * pairs


def k2_work(a):
    q = a["q"]
    B, _, Hq, D = q.shape
    Hkv = a["k_pages"].shape[2]
    el = q.element_size()
    pos = int(a["cache_len"].sum())
    return 2 * q.numel() * el + 2 * pos * Hkv * D * el, 4 * D * Hq * pos


def k1_library(a):
    """The same function as one scaled_dot_product_attention call on K/V
    already gathered per row into contiguous strips (gather excluded)."""
    q, tbl = a["q"], a["page_tables"].long()
    K, S, Hq, D = q.shape
    Hkv = a["k_pages"].shape[2]
    skv = int(a["true_lens"].max())
    kk = a["k_pages"][tbl].reshape(K, -1, Hkv, D)[:, :skv]
    vv = a["v_pages"][tbl].reshape(K, -1, Hkv, D)[:, :skv]
    G = Hq // Hkv
    kk = kk.transpose(1, 2).repeat_interleave(G, 1).contiguous()
    vv = vv.transpose(1, 2).repeat_interleave(G, 1).contiguous()
    qq = q.transpose(1, 2).contiguous()
    row = a["q_offsets"][:, None].long() + torch.arange(S, device=q.device)
    col = torch.arange(skv, device=q.device)
    mask = (col[None, None, :] <= row[:, :, None]) \
        & (col[None, None, :] < a["true_lens"][:, None, None].long())
    mask = mask[:, None].contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(qq, kk, vv, attn_mask=mask)


def k2_library(a):
    q, tbl = a["q"], a["block_table"].long()
    B, _, Hq, D = q.shape
    Hkv = a["k_pages"].shape[2]
    skv = int(a["cache_len"].max())
    G = Hq // Hkv
    kk = a["k_pages"][tbl].reshape(B, -1, Hkv, D)[:, :skv]
    vv = a["v_pages"][tbl].reshape(B, -1, Hkv, D)[:, :skv]
    kk = kk.transpose(1, 2).repeat_interleave(G, 1).contiguous()
    vv = vv.transpose(1, 2).repeat_interleave(G, 1).contiguous()
    qq = q.transpose(1, 2).contiguous()
    mask = (torch.arange(skv, device=q.device)[None, :]
            < a["cache_len"][:, None].long())[:, None, None, :].contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(qq, kk, vv, attn_mask=mask)


def phase_times(launches, per_tick, k1_args, k2_args):
    flush = torch.empty(64 * 1024 * 1024 // 4, dtype=torch.float32,
                        device="cuda")
    names1 = ("q", "k_pages", "v_pages", "page_tables", "q_offsets",
              "true_lens", "q_lens")
    a1 = dict(zip(names1, k1_args[0]))
    a2 = dict(zip(("q", "k_pages", "v_pages", "block_table", "cache_len"),
                  k2_args[0]))
    rows = []
    for name, a, call, work, lib, src, tpu in (
            ("K1 paged_prefill", a1, k1_call, k1_work, k1_library,
             "src/repro_torch/csrc/paged_prefill.cu",
             "src/repro/kernels/paged_prefill.py:141"),
            ("K2 paged_decode", a2, k2_call, k2_work, k2_library,
             "src/repro_torch/csrc/paged_decode.cu",
             "src/repro/kernels/flash_decode.py:203")):
        err = compare(call(a), call(a, "ref"), a["q"].dtype)
        f32 = {k: (v.float() if torch.is_tensor(v) and v.is_floating_point()
                   else v) for k, v in a.items()}
        err32 = compare(call(f32), call(f32, "ref"), torch.float32)
        nbytes, flops = work(a)
        t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FLOP_S
        key = name[:2]
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": launches[key], "launches_per_tick": per_tick[key],
            "max_abs_err": err, "max_abs_err_f32": err32,
            "ms": time_ms(lambda: call(a), flush),
            "plain_ms": time_ms(lambda: call(a, "ref"), flush),
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": time_ms(lib(a), flush),
            "library": "scaled_dot_product_attention on K/V pre-gathered "
                       "into contiguous strips (gather not timed)",
            "shape": {k: list(v.shape) for k, v in a.items()
                      if torch.is_tensor(v)},
            "bytes": nbytes, "flops": flops})
    return rows


# ---------------------------------------------------------------------------
# phase 5
# ---------------------------------------------------------------------------

def phase_trace(model, params, counted_wall_s: float):
    """The same traffic once more under torch.profiler, tracing device
    activity only (no host op recording, so the run's wall time stays near
    the unprofiled one): device time by kernel name, and the device's busy
    share as busy time over this same run's wall time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, _, _, wall = run_traffic(model, params, count_syncs=False)

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) \
            or getattr(e, "self_cuda_time_total", 0)

    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy = sum(dev_us(e) for e in kernels) / 1e6
    top = sorted(kernels, key=dev_us, reverse=True)[:10]
    out = {"profiled_wall_s": wall, "counted_wall_s": counted_wall_s,
           "device_busy_s": busy, "busy_share": busy / wall,
           "top_kernels_ms": [[e.key[:80], dev_us(e) / 1e3, e.count]
                              for e in top]}
    log(f"# trace: device busy {busy:.3f} s of {wall:.3f} s profiled wall "
        f"(unprofiled counted run: {counted_wall_s:.3f} s wall)"
        + ("" if busy else " (the profiler recorded no device time: not "
                           "measured)"))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one NVIDIA GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    phase_device_and_build()
    phase_kernel_parity()
    launches, per_tick, e2e, k1_args, k2_args, mp = phase_slice()
    rows = phase_times(launches, per_tick, k1_args, k2_args)
    trace = phase_trace(*mp, e2e["wall_s"])
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"trace": trace}), flush=True)
    print(json.dumps({"e2e": e2e}), flush=True)
    log(f"# total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
