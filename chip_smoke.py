#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one GPU

Phases (each raises on failure, so the run exits non-zero):

  1. device and build   the card's name and power limit (nvidia-smi), then
                        every CUDA kernel of repro_torch (K1-K4) built from
                        src/repro_torch/csrc with nvcc for sm_90a, one nvcc
                        per source, all started together.
  2. kernel parity      the hand-written kernels against their plain
                        PyTorch versions on the card: the edge cases of
                        tests/test_torch_kernels_cuda.py (run with pytest),
                        and the serving shapes (head dim 64, 4 query heads
                        per KV head; K1/K2 over pages of 16, K4 prompts of
                        (1, 1904) and (2, 256), K3 8 strips of 2048 with
                        lengths spread over [0, 2048]) in float32 and
                        bfloat16.
  3. the slice          granite-3-2b at full width (40 layers, bf16, seeded
                        weights) serves 8 requests, 32 new tokens each,
                        with check_invariants() after every tick, through
                        three engines: paged + chunked + batched (warm-up,
                        then counted), monolithic prefill on the dense cache
                        (warm-up, then counted), and monolithic prefill on
                        the paged cache (counted once).  Before each counted
                        run every kernel's launch count is set to 0; just
                        after it, each must equal 40 x the engine's launches
                        of its kind (K1 chunk batches and K2 decodes; K4
                        prefills and K3 decodes; K4 paged prefills and K2
                        decodes), and the kernels the run does not use must
                        show 0.  Implicit host syncs inside the counted
                        ticks are counted with torch.cuda's sync debug mode
                        (the tick's token fetch and a monolithic admission's
                        first-token fetch excepted) and must be 0.  Then
                        the model's entry points at full width through the
                        kernels and through impl="ref": one chunk batch and
                        a paged decode step, forward over 2 x 256 tokens, a
                        dense prefill and decode step, and a paged prefill
                        and decode step.
  4. times              per kernel, at the largest call its run gave it
                        (K1/K2 the chunked run, K3/K4 the dense run):
                        kernel, plain version and library times (CUDA
                        events, L2 flushed, median of 25) beside the bound
                        the card's data sheet allows; then the end-to-end
                        numbers of the counted runs.
  5. trace              the chunked and the dense traffic once more under
                        torch.profiler (device activity only): device time
                        by kernel name, and the device's busy share of that
                        same run's wall time.

Output: the nvidia-smi line, one {"kernels": [...]} line (K1-K4), one
{"trace": ...} and one {"trace_dense": ...} line, one {"e2e": ...} line
(the chunked run), one {"e2e_dense": ...} and one {"e2e_paged_monolithic":
...} line, and as the last line {"ok": true, "device": {...}}.  Without a
GPU it exits non-zero and prints no result.
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
from repro_torch.kernels import build, flash_attention  # noqa: E402
from repro_torch.kernels import flash_decode, ops, paged_prefill  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

# H100 SXM data sheet: HBM bandwidth and dense bf16 tensor-core rate
PEAK_BYTES_S = 3.35e12
PEAK_FLOP_S = 989e12
F32_TOL = 1e-5
BF16_RTOL = 2.0 ** -7            # one bfloat16 rounding step of the output
# full-width bf16 logits, kernels vs ref: max |difference| at a logit
# scale of ~4, measured on an H100 80GB HBM3 (700 W) - chunk batch 0.068,
# paged decode step 0.071, forward 0.104, dense prefill 0.071, dense
# decode step 0.069, paged prefill 0.071, paged decode after it 0.077,
# deterministic for the seeded weights; each bar leaves a margin of
# ~1.6-1.7x over its measurement
MODEL_BARS = {"chunk batch": 0.12, "paged decode step": 0.12,
              "forward": 0.18, "dense prefill": 0.12,
              "dense decode step": 0.12, "paged prefill": 0.12,
              "paged decode after paged prefill": 0.13}
PROMPT_LENS = (37, 128, 300, 511, 700, 1024, 1500, 1900)
NEW_TOKENS = 32
# the engines: paged + chunked + batched; monolithic prefill on the dense
# cache at the same batch and length; monolithic prefill on the paged
# cache with the chunked run's pool settings
SCFG = dict(max_batch=8, max_seq=2048, page_size=16, prefill_chunk=256,
            tick_token_budget=1024, max_new_tokens=NEW_TOKENS, paged=True,
            chunked=True, batched=True)
RUNS = {"chunked": SCFG,
        "dense": dict(max_batch=8, max_seq=2048, max_new_tokens=NEW_TOKENS,
                      paged=False, chunked=False),
        "paged_monolithic": dict(SCFG, chunked=False)}
# per run: kernel -> the launch kind whose count x n_layers it must equal
# (None: the run must not launch it)
EXPECTED = {
    "chunked": {"K1": "chunk_batch", "K2": "decode", "K3": None, "K4": None},
    "dense": {"K1": None, "K2": None, "K3": "decode", "K4": "prefill"},
    "paged_monolithic": {"K1": None, "K2": "decode", "K3": None,
                         "K4": "prefill_paged"}}
# kernel -> (module, launch counter)
COUNTERS = {"K1": (paged_prefill, "launches"),
            "K2": (flash_decode, "launches"),
            "K3": (flash_decode, "dense_launches"),
            "K4": (flash_attention, "launches")}


def log(msg: str):
    print(msg, flush=True)


def reset_counts():
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)


def read_counts():
    return {k: getattr(mod, attr) for k, (mod, attr) in COUNTERS.items()}


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

def compare(got: torch.Tensor, want: torch.Tensor, dtype,
            terms: torch.Tensor = None) -> float:
    """Max |kernel - plain|; raises past the bar of the dtype.  `terms`
    (bf16 K4 only): the plain attention of |v|, the magnitude of the
    summed terms - K4 rounds its softmax weights to bf16 before PV, as its
    plain version does, and a one-ulp score difference can flip one
    weight's rounding, so its bar is one bf16 step of the terms."""
    g, w = got.float(), want.float()
    err = float((g - w).abs().max())
    if dtype == torch.bfloat16:
        scale = w.abs() if terms is None else w.abs() + terms.float()
        bar = BF16_RTOL * scale + 1e-6
    else:
        bar = torch.full_like(w, F32_TOL)
    if not bool(((g - w).abs() <= bar).all()):
        raise AssertionError(f"kernel disagrees with its plain version: max "
                             f"abs err {err:.3e} ({dtype})")
    return err


def serving_shape_args(dtype, seed=0):
    """K1-K4 inputs at the slice's shapes: 8 KV heads of dim 64, 32 query
    heads; pages of 16 in a 1025-page pool with 128-page table rows (K1,
    K2), prompts of (1, 1904) and (2, 256) tokens (K4), 8 dense strips of
    2048 with lengths spread over [0, 2048] (K3)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=g, device=dev,
                                     dtype=torch.float32).to(dtype)
    k, v = rnd(1025, 16, 8, 64), rnd(1025, 16, 8, 64)
    perm = torch.randperm(1024, generator=g, device=dev).to(torch.int32) + 1
    tables = perm[:8 * 128].reshape(8, 128).contiguous()
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)
    # chunk rows: a first chunk, a ragged final chunk, mid-prompt chunks,
    # and a dead padding row (all-null table)
    k1_tables = tables[:4].clone()
    k1_tables[3] = 0
    k1 = dict(q=rnd(4, 256, 32, 64), k_pages=k, v_pages=v,
              page_tables=k1_tables, q_offsets=i32([0, 256, 1536, 0]),
              true_lens=i32([256, 300, 1792, 0]))
    k2 = dict(q=rnd(8, 1, 32, 64), k_pages=k, v_pages=v, block_table=tables,
              cache_len=i32([38, 129, 301, 512, 701, 0, 1501, 1932]))
    k4 = [dict(q=rnd(b, s, 32, 64), k=rnd(b, s, 8, 64), v=rnd(b, s, 8, 64),
               causal=True) for b, s in ((1, 1904), (2, 256))]
    k3 = dict(q=rnd(8, 1, 32, 64), k_cache=rnd(8, 2048, 8, 64),
              v_cache=rnd(8, 2048, 8, 64),
              cache_len=i32([0, 1, 257, 640, 1024, 1500, 1999, 2048]))
    return k1, k2, k3, k4


def k1_call(a, impl=None):
    return ops.batched_paged_prefill_attention(
        a["q"], a["k_pages"], a["v_pages"], a["page_tables"],
        a["q_offsets"], a["true_lens"], a.get("q_lens"), impl=impl)


def k2_call(a, impl=None):
    return ops.paged_flash_decode(a["q"], a["k_pages"], a["v_pages"],
                                  a["block_table"], a["cache_len"],
                                  impl=impl)


def k3_call(a, impl=None):
    return ops.flash_decode(a["q"], a["k_cache"], a["v_cache"],
                            a["cache_len"], window=a.get("window", 0),
                            logit_softcap=a.get("logit_softcap", 0.0),
                            impl=impl)


def _k4_kw(a):
    return dict(causal=a.get("causal", True), window=a.get("window", 0),
                logit_softcap=a.get("logit_softcap", 0.0))


def k4_call(a, impl=None):
    """(o, lse): the kernel, or its plain version with impl="ref"."""
    fn = flash_attention.reference if impl == "ref" \
        else flash_attention.flash_attention_fwd
    return fn(a["q"], a["k"], a["v"], **_k4_kw(a))


def k4_compare(a, dtype) -> float:
    """K4's o (bf16: against the terms' bar) and lse (fp32, 1e-5) against
    its plain version; returns the max abs error of o."""
    (o, lse), (o_r, lse_r) = k4_call(a), k4_call(a, "ref")
    terms = flash_attention.reference(a["q"], a["k"], a["v"].abs(),
                                      **_k4_kw(a))[0] \
        if dtype == torch.bfloat16 else None
    err = compare(o, o_r, dtype, terms)
    compare(lse, lse_r, torch.float32)
    return err


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
        a1, a2, a3, a4s = serving_shape_args(dtype)
        o1 = k1_call(a1)
        if o1[3].any() or o1[1, 44:].any():
            raise AssertionError("K1: dead row or pad lanes not exactly 0")
        e1 = compare(o1, k1_call(a1, "ref"), dtype)
        o2 = k2_call(a2)
        if o2[5].any():
            raise AssertionError("K2: idle lane not exactly 0")
        e2 = compare(o2, k2_call(a2, "ref"), dtype)
        o3 = k3_call(a3)
        if o3[0].any():
            raise AssertionError("K3: lane of length 0 not exactly 0")
        e3 = compare(o3, k3_call(a3, "ref"), dtype)
        e4 = [k4_compare(a, dtype) for a in a4s]
        bar = "1e-5 abs" if dtype == torch.float32 else "2^-7 rel"
        log(f"# serving shapes {str(dtype)[6:]}: K1 max abs err {e1:.3e}, "
            f"K2 {e2:.3e}, K3 {e3:.3e}, K4 (1, 1904) {e4[0]:.3e} and "
            f"(2, 256) {e4[1]:.3e} (bar {bar}; K4 bf16 of the terms)")
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

class Capture:
    """Wraps a kernel module's wrapper and keeps the arguments of its
    largest call (by `weight`), cloned, for the timing phase.  Used in the
    warm-up runs only; the wrapped call is the original."""

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


def _lens_weight(q, kc, vc, *rest):
    lens = rest[-1]
    return int(lens.sum()) if torch.is_tensor(lens) else lens * q.shape[0]


def _k4_weight(q, k, v):
    return q.shape[0] * q.shape[1] * k.shape[1]


def _quiet(fetch):
    """An expected device->host fetch, kept out of the sync count."""
    def quiet(*args):
        torch.cuda.set_sync_debug_mode(0)
        try:
            return fetch(*args)
        finally:
            torch.cuda.set_sync_debug_mode("warn")
    return quiet


def run_traffic(model, params, scfg, count_syncs: bool):
    """Serve the 8 requests to completion.  Returns (engine, per-tick wall
    seconds, implicit sync warnings, wall seconds)."""
    eng = ServeEngine(model, params, ServeConfig(**scfg))
    rng = np.random.default_rng(0)
    for n in PROMPT_LENS:
        eng.submit(rng.integers(1, model.cfg.vocab_size, n).tolist())
    fetches = ("_fetch_tokens", "_fetch_first_token")
    if count_syncs:
        for name in fetches:
            setattr(eng, name, _quiet(getattr(eng, name)))
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
    for name in fetches:
        eng.__dict__.pop(name, None)
    return eng, tick_s, syncs, wall


def counted_run(model, params, run: str):
    """Every launch count set to 0, the run's traffic with sync counting,
    the counts read; raises unless each kernel launched 40 x its kind's
    engine launches (and the others not at all), every request got its
    tokens, every launch had its fetch, and no implicit sync happened."""
    cfg, scfg = model.cfg, RUNS[run]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    eng, tick_s, syncs, wall = run_traffic(model, params, scfg,
                                           count_syncs=True)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    done = eng.sched.finished
    if len(done) != len(PROMPT_LENS) or any(
            len(r.out_tokens) != NEW_TOKENS for r in done):
        raise AssertionError(f"{run}: not every request finished with "
                             f"{NEW_TOKENS} tokens: "
                             f"{[len(r.out_tokens) for r in done]}")
    for calls, host, _, n_chunks, n_dec in eng.launch_log:
        # chunked: at most a chunk batch and a decode, one fetch; monolithic:
        # one fetch per launch (the first token of an admission, the tokens
        # of a decode)
        ok = (calls <= 2 and host == (1 if calls else 0)) \
            if scfg["chunked"] else host == calls
        if not ok:
            raise AssertionError(f"{run}: tick made {calls} launches and "
                                 f"{host} fetches")
    kinds = [r.kind for r in eng.launch_records()]
    if any(sum(1 for r in eng.launch_records() if r.tick == t
               and r.kind == "decode") > 1
           for t in range(len(eng.launch_log))):
        raise AssertionError(f"{run}: a tick made two decode launches")
    L = cfg.n_layers
    want = {k: L * kinds.count(kind) if kind else 0
            for k, kind in EXPECTED[run].items()}
    if launches != want:
        raise AssertionError(f"{run}: kernel launches {launches} != "
                             f"{want} ({L} x the engine's launches)")
    if syncs:
        raise AssertionError(f"{run}: {syncs} implicit host syncs in the "
                             f"ticks")
    toks = np.array([t for r in done for t in r.out_tokens])
    if toks.min() < 0 or toks.max() >= cfg.vocab_size:
        raise AssertionError("generated token ids out of the vocabulary")
    counts = {k: kinds.count(k) for k in sorted(set(kinds))}
    log(f"# {run}: served {len(done)} requests x {NEW_TOKENS} tokens in "
        f"{len(eng.launch_log)} ticks: engine launches {counts}, kernel "
        f"launches {launches}, implicit host syncs in the ticks: {syncs}")
    stats = eng.stats()
    ticks = len(eng.launch_log)
    e2e = {"gen_tokens": stats["gen_tokens"],
           "prefill_tokens": stats["prefill_tokens"],
           "ticks": ticks,
           "busy_ticks": sum(1 for r in eng.launch_log if r[0]),
           "engine_launches": counts,
           "kernel_launches": launches,
           "wall_s": wall,
           "gen_tok_s": stats["gen_tokens"] / wall,
           "prefill_tok_s": stats["prefill_tokens"] / wall,
           "tick_ms_median": float(np.median(tick_s)) * 1e3,
           "tick_ms_p95": float(np.percentile(tick_s, 95)) * 1e3,
           "peak_mem_gb": peak / 1e9,
           "kv_cache_gb": eng.kv_cache_bytes() / 1e9,
           "implicit_syncs": syncs,
           "host_syncs": stats["host_syncs"]}
    return {"launches": launches,
            "per_tick": {k: n / ticks for k, n in launches.items()},
            "e2e": e2e}


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
    runs = {}
    with Capture(paged_prefill, "batched_paged_prefill_attention",
                 _k1_weight) as c1, \
            Capture(flash_decode, "paged_flash_decode", _lens_weight) as c2:
        run_traffic(model, params, RUNS["chunked"], count_syncs=False)
    runs["chunked"] = counted_run(model, params, "chunked")
    with Capture(flash_attention, "flash_attention_fwd", _k4_weight) as c4, \
            Capture(flash_decode, "flash_decode", _lens_weight) as c3:
        run_traffic(model, params, RUNS["dense"], count_syncs=False)
    runs["dense"] = counted_run(model, params, "dense")
    runs["paged_monolithic"] = counted_run(model, params, "paged_monolithic")
    model_check(model, params)
    args = {"K1": c1.best, "K2": c2.best, "K3": c3.best, "K4": c4.best}
    return runs, args, (model, params)


def model_check(model, params):
    """The model's entry points at full width through the kernels and
    through impl="ref" (separate caches, same inputs): a chunk batch and a
    paged decode step (K1, K2), forward over 2 x 256 tokens (K4), a dense
    prefill of two prompts (256 and 200 real tokens) and a decode step
    (K4, K3), a paged prefill of the 200-token prompt and a decode step
    (K4, K2)."""
    dev = model.device
    rng = np.random.default_rng(1)
    i32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.int32,
                                 device=dev)
    toks = rng.integers(1, model.cfg.vocab_size, (2, 256))
    toks[1, 200:] = 0
    table = np.zeros((2, 32), np.int32)
    table[0, :17], table[1, :17] = np.arange(1, 18), np.arange(18, 35)
    argmax = lambda lg: torch.argmax(lg[:, -1], -1,
                                     keepdim=True).to(torch.int32)
    out = {}
    for impl in (None, "ref"):
        got = {}
        batch = {"tokens": i32(toks), "offset": i32([0, 0]),
                 "true_lens": i32([256, 200])}
        cache = model.init_cache(2, 512, page_size=16, num_pages=65)
        lp, cache, lens = model.prefill_chunks(params, batch, cache,
                                               i32(table), impl=impl)
        cache["block_table"] = i32(table)
        got["chunk batch"] = lp
        got["paged decode step"] = model.decode_step(
            params, argmax(lp), lens, cache, impl=impl)[0]
        got["forward"] = model.forward(params, {"tokens": i32(toks)},
                                       impl=impl)[0]
        cache = model.init_cache(2, 512)
        lp, cache, lens = model.prefill(
            params, {"tokens": i32(toks), "true_lens": i32([256, 200])},
            cache, impl=impl)
        got["dense prefill"] = lp
        got["dense decode step"] = model.decode_step(
            params, argmax(lp), lens, cache, impl=impl)[0]
        cache = model.init_cache(1, 512, page_size=16, num_pages=33)
        lp, cache, lens = model.prefill_paged(
            params, {"tokens": i32(toks[1:]), "true_lens": i32([200])},
            cache, i32(np.arange(1, 17)), impl=impl)
        cache["block_table"] = i32(np.arange(1, 33)[None])
        got["paged prefill"] = lp
        got["paged decode after paged prefill"] = model.decode_step(
            params, argmax(lp), lens, cache, impl=impl)[0]
        out[impl] = got
    for name, bar in MODEL_BARS.items():
        a, b = out[None][name], out["ref"][name]
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{name}: non-finite logits")
        err = float((a - b).abs().max())
        log(f"# full-width {name}: logits max |kernels - ref| {err:.3e} "
            f"(bf16 bar {bar}, logit scale {float(b.abs().max()):.2f})")
        if err > bar:
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


def k3_work(a):
    """q and the output once, each lane's visible K/V positions once."""
    q = a["q"]
    B, _, Hq, D = q.shape
    S, Hkv = a["k_cache"].shape[1], a["k_cache"].shape[2]
    el = q.element_size()
    lens = a["cache_len"]
    lens = lens.cpu().numpy() if torch.is_tensor(lens) else [lens] * B
    window = a.get("window", 0)
    pos = sum(min(int(n), S) - (max(0, int(n) - window) if window > 0
                                else 0) for n in lens)
    return 2 * q.numel() * el + 2 * pos * Hkv * D * el, 4 * D * Hq * pos


def k4_work(a):
    """q, K and V read once, o and the fp32 lse written once; 4*D*Hq FLOPs
    per (query, attended key) pair under the call's mask."""
    q, k = a["q"], a["k"]
    B, Sq, Hq, D = q.shape
    Skv = k.shape[1]
    kw = _k4_kw(a)
    window = kw["window"]
    pairs = 0
    for s in range(Sq):
        hi = min(s + 1, Skv) if kw["causal"] or window > 0 else Skv
        lo = max(0, s - window + 1) if window > 0 else 0
        pairs += max(hi - lo, 0)
    el = q.element_size()
    nbytes = (2 * q.numel() + 2 * k.numel()) * el + 4 * B * Sq * Hq
    return nbytes, 4 * D * Hq * B * pairs


def _sdpa(q, k, v, **kw):
    """One scaled_dot_product_attention call on (B, S, H, D) inputs laid
    out as (B, H, S, D) beforehand (the transposes are not timed), the KV
    heads shared by enable_gqa where this PyTorch has it."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qq, kk, vv = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    try:
        sdpa(qq, kk, vv, enable_gqa=True, **kw)
        return lambda: sdpa(qq, kk, vv, enable_gqa=True, **kw)
    except TypeError:
        G = qq.shape[1] // kk.shape[1]
        kk, vv = (t.repeat_interleave(G, 1).contiguous() for t in (kk, vv))
        return lambda: sdpa(qq, kk, vv, **kw)


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


def k3_library(a):
    """One scaled_dot_product_attention call over the whole strips with a
    per-lane length mask."""
    q, kc = a["q"], a["k_cache"]
    S = kc.shape[1]
    lens = a["cache_len"]
    lens = lens if torch.is_tensor(lens) else torch.full(
        (q.shape[0],), lens, device=q.device)
    mask = (torch.arange(S, device=q.device)[None, :]
            < lens[:, None].long())[:, None, None, :].contiguous()
    return _sdpa(q, kc, a["v_cache"], attn_mask=mask)


def k4_library(a):
    """One causal scaled_dot_product_attention call (its is_causal mask is
    top-left aligned, as K4's, and the calls timed here have Sq == Skv)."""
    return _sdpa(a["q"], a["k"], a["v"], is_causal=_k4_kw(a)["causal"])


# key -> (name, call, work, library, source, TPU kernel, run that feeds
# its row, argument names of the wrapper)
KERNELS = {
    "K1": ("K1 paged_prefill", k1_call, k1_work, k1_library,
           "src/repro_torch/csrc/paged_prefill.cu",
           "src/repro/kernels/paged_prefill.py:141", "chunked",
           ("q", "k_pages", "v_pages", "page_tables", "q_offsets",
            "true_lens", "q_lens")),
    "K2": ("K2 paged_decode", k2_call, k2_work, k2_library,
           "src/repro_torch/csrc/paged_decode.cu",
           "src/repro/kernels/flash_decode.py:203", "chunked",
           ("q", "k_pages", "v_pages", "block_table", "cache_len")),
    "K3": ("K3 dense_decode", k3_call, k3_work, k3_library,
           "src/repro_torch/csrc/dense_decode.cu",
           "src/repro/kernels/flash_decode.py:115", "dense",
           ("q", "k_cache", "v_cache", "cache_len")),
    "K4": ("K4 flash_attention", k4_call, k4_work, k4_library,
           "src/repro_torch/csrc/flash_attention.cu",
           "src/repro/kernels/flash_attention.py:113", "dense",
           ("q", "k", "v")),
}


def phase_times(runs, captured):
    flush = torch.empty(64 * 1024 * 1024 // 4, dtype=torch.float32,
                        device="cuda")
    rows = []
    for key, (name, call, work, lib, src, tpu, run, names) in \
            KERNELS.items():
        args, kw = captured[key]
        a = dict(zip(names, args))
        a.update(kw)
        f32 = {k: (v.float() if torch.is_tensor(v) and v.is_floating_point()
                   else v) for k, v in a.items()}
        if key == "K4":
            err = k4_compare(a, a["q"].dtype)
            err32 = k4_compare(f32, torch.float32)
        else:
            err = compare(call(a), call(a, "ref"), a["q"].dtype)
            err32 = compare(call(f32), call(f32, "ref"), torch.float32)
        nbytes, flops = work(a)
        t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FLOP_S
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": runs[run]["launches"][key],
            "launches_per_tick": runs[run]["per_tick"][key],
            "launches_by_run": {r: v["launches"][key]
                                for r, v in runs.items()},
            "timed_from_run": run,
            "max_abs_err": err, "max_abs_err_f32": err32,
            "ms": time_ms(lambda: call(a), flush),
            "plain_ms": time_ms(lambda: call(a, "ref"), flush),
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": time_ms(lib(a), flush),
            "library": "scaled_dot_product_attention"
                       + (" on K/V pre-gathered into contiguous strips "
                          "(gather not timed)" if key in ("K1", "K2")
                          else " (inputs transposed beforehand, not timed)"),
            "shape": {k: list(v.shape) for k, v in a.items()
                      if torch.is_tensor(v)},
            "bytes": nbytes, "flops": flops})
    return rows


# ---------------------------------------------------------------------------
# phase 5
# ---------------------------------------------------------------------------

def phase_trace(model, params, run: str, counted_wall_s: float):
    """The run's traffic once more under torch.profiler, tracing device
    activity only (no host op recording, so the run's wall time stays near
    the unprofiled one): device time by kernel name, and the device's busy
    share as busy time over this same run's wall time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, _, _, wall = run_traffic(model, params, RUNS[run],
                                    count_syncs=False)

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) \
            or getattr(e, "self_cuda_time_total", 0)

    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy = sum(dev_us(e) for e in kernels) / 1e6
    top = sorted(kernels, key=dev_us, reverse=True)[:10]
    out = {"run": run, "profiled_wall_s": wall,
           "counted_wall_s": counted_wall_s, "device_busy_s": busy,
           "busy_share": busy / wall,
           "top_kernels_ms": [[e.key[:80], dev_us(e) / 1e3, e.count]
                              for e in top]}
    log(f"# trace ({run}): device busy {busy:.3f} s of {wall:.3f} s profiled "
        f"wall (unprofiled counted run: {counted_wall_s:.3f} s wall)"
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
    runs, captured, mp = phase_slice()
    rows = phase_times(runs, captured)
    trace = phase_trace(*mp, "chunked", runs["chunked"]["e2e"]["wall_s"])
    trace_dense = phase_trace(*mp, "dense", runs["dense"]["e2e"]["wall_s"])
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"trace": trace}), flush=True)
    print(json.dumps({"trace_dense": trace_dense}), flush=True)
    print(json.dumps({"e2e": runs["chunked"]["e2e"]}), flush=True)
    print(json.dumps({"e2e_dense": runs["dense"]["e2e"]}), flush=True)
    print(json.dumps({"e2e_paged_monolithic":
                      runs["paged_monolithic"]["e2e"]}), flush=True)
    log(f"# total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
