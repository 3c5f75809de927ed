#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one GPU

Phases (each raises on failure, so the run exits non-zero):

  1. device and build   the card's name and power limit (nvidia-smi), then
                        every CUDA kernel of repro_torch (K1-K7) built from
                        src/repro_torch/csrc with nvcc for sm_90a, one nvcc
                        per source, all started together.
  2. kernel parity      the hand-written kernels against their plain
                        PyTorch versions on the card: the edge cases of
                        tests/test_torch_kernels_cuda.py (run with pytest),
                        the serving shapes (head dim 64, 4 query heads per
                        KV head; K1/K2 over pages of 16, K4 prompts of
                        (1, 1904) and (2, 256), K3 8 strips of 2048 with
                        lengths spread over [0, 2048]) and K5 at the
                        training shape (4 x 2048 tokens, 32 / 8 heads,
                        causal, o and lse from K4), in float32 and
                        bfloat16; the test file also holds K3 and K4 at
                        head dim 80 and the edge cases of the scans K6 and
                        K7 (their full-width shapes among them).
  3. the slices         serving: granite-3-2b at full width (40 layers,
                        bf16, seeded weights) serves 8 requests, 32 new
                        tokens each, with check_invariants() after every
                        tick, through three engines: paged + chunked +
                        batched (warm-up, then counted), monolithic prefill
                        on the dense cache (warm-up, then counted), and
                        monolithic prefill on the paged cache (counted
                        once).  Before each counted run every kernel's
                        launch count is set to 0; just after it, each must
                        equal 40 x the engine's launches of its kind (K1
                        chunk batches and K2 decodes; K4 prefills and K3
                        decodes; K4 paged prefills and K2 decodes), and the
                        kernels the run does not use (K5 always) must show
                        0.  Implicit host syncs inside the counted ticks
                        are counted with torch.cuda's sync debug mode (the
                        tick's token fetch and a monolithic admission's
                        first-token fetch excepted) and must be 0.  Then
                        the model's entry points at full width through the
                        kernels and through impl="ref".
                        training: granite-3-2b at full width trains 4 x
                        2048 tokens a step with remat "full" through
                        init_train_state, make_train_step and
                        DataPipeline.device_batch: one step's loss and
                        gradient norm through the kernels against
                        impl="ref" from the same state (on a batch seeded
                        by numpy, the same in every process), a warm-up
                        step,
                        then 6 counted steps, which must launch K4 2 x 40
                        times a step (forward and recompute), K5 40 times
                        (one count per backward call, its dq and dk/dv
                        kernels together) and K1-K3 never, with finite
                        losses from near ln(vocab).  Then the Trainer at
                        the smoke config (head dim 64) crashes at step 5,
                        resumes from its checkpoint, and must end with the
                        state digest and losses of a run that did not stop.
                        recurrent: zamba2-2.7b (54 Mamba2 layers, a shared
                        attention block of head dim 80 after every 6th)
                        and rwkv6-1.6b (24 RWKV6 layers) at full width,
                        seeded weights.  bf16: each model's forward over a
                        numpy-seeded 2 x 2048 batch through the kernels
                        (counts set to 0 before, read after: K6 54 and K4
                        9 a zamba2 forward, K7 24 an rwkv6 forward, the
                        rest 0), its logits against impl="ref" within
                        REC_NOISE_MARGIN x the model's own bf16 noise, and
                        each layer against impl="ref" on the same input
                        within REC_LAYER_RTOL; then 6 requests (prompts
                        of 24 to 200 tokens, 16 new tokens each, 4 slots:
                        two requests reuse a freed slot) served on the
                        dense recurrent-state cache with stepwise
                        admission: counts set to 0 before, read after
                        (zamba2: K3 9 x the engine's decode steps, every
                        other kernel 0; rwkv6: all 0), no implicit host
                        sync in the ticks.  float32 on the same weights:
                        the forward's logits against impl="ref" within
                        REC_F32_BARS, each layer as in bf16 with the
                        float32 bar, and the same traffic, every generated
                        token the argmax of a teacher-forced kernel
                        forward at its position or within REC_F32_BARS of
                        it (near ties printed); a corrupted recurrent
                        state moves the logits by O(1).
  4. times              per kernel, at the largest call its run gave it
                        (K1/K2 the chunked run, K3/K4 the dense run, K5 the
                        training run, K6/K7 the recurrent forwards; K3/K4
                        also at zamba2's head dim 80, K4 also at the
                        training step's shape): kernel, plain version and
                        library times (CUDA events, L2 flushed, median of
                        25) beside the bound the card's data sheet allows
                        and the achieved rate (tflops: the FLOPs the call's
                        data needs over the kernel's time); then the
                        end-to-end numbers of the counted runs.
  5. trace              the chunked, the dense and the paged-monolithic
                        traffic once more, 2 training steps, and one zamba2
                        forward, under torch.profiler (device activity
                        only): device time by kernel name and by port
                        kernel (K1-K7, each one's share of the busy time),
                        and the device's busy share of that same run's
                        wall time.

Output: the nvidia-smi line, one {"kernels": [...]} line (K1-K7), one
{"trace": ...}, one {"trace_dense": ...}, one {"trace_paged_monolithic":
...}, one {"trace_train": ...} and one {"trace_recurrent": ...} line, one
{"e2e": ...} line (the chunked run),
one {"e2e_dense": ...}, one {"e2e_paged_monolithic": ...}, one
{"e2e_train": ...} and one {"e2e_recurrent": ...} line, and as the last
line {"ok": true, "device": {...}}.  Without a GPU it exits non-zero and
prints no result.
"""
from __future__ import annotations

import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import (ServeConfig, TrainConfig,  # noqa: E402
                                 get_config, get_smoke_config)
from repro_torch.data import DataPipeline  # noqa: E402
from repro_torch.kernels import build, flash_attention  # noqa: E402
from repro_torch.kernels import flash_backward, flash_decode  # noqa: E402
from repro_torch.kernels import mamba2_scan, rwkv6_scan  # noqa: E402
from repro_torch.kernels import ops, paged_prefill  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.layers import embed  # noqa: E402
from repro_torch.models.transformer import n_shared_applications  # noqa
from repro_torch.optim import global_norm  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.train import init_train_state, make_train_step  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402
from repro_torch.tree import leaves, leaves_with_paths, map_tree  # noqa

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
    "chunked": {"K1": "chunk_batch", "K2": "decode", "K3": None, "K4": None,
                "K5": None, "K6": None, "K7": None},
    "dense": {"K1": None, "K2": None, "K3": "decode", "K4": "prefill",
              "K5": None, "K6": None, "K7": None},
    "paged_monolithic": {"K1": None, "K2": "decode", "K3": None,
                         "K4": "prefill_paged", "K5": None, "K6": None,
                         "K7": None}}
# kernel -> (module, launch counter)
COUNTERS = {"K1": (paged_prefill, "launches"),
            "K2": (flash_decode, "launches"),
            "K3": (flash_decode, "dense_launches"),
            "K4": (flash_attention, "launches"),
            "K5": (flash_backward, "launches"),
            "K6": (mamba2_scan, "launches"),
            "K7": (rwkv6_scan, "launches")}
# the training phase: granite-3-2b at full width, 4 x 2048 tokens a step,
# every layer recomputed in the backward (remat "full"); lr warms up over 2
# steps so the counted steps update the weights
TRAIN = dict(global_batch=4, seq_len=2048, remat="full", warmup_steps=2,
             total_steps=100)
TRAIN_STEPS = 6                  # counted steps, after one warm-up step
# full-width bf16 training, kernels vs impl="ref" from the same state on a
# numpy-seeded batch: |loss difference| and |grad norm difference| / grad
# norm.  On two pipeline batches an H100 80GB HBM3 (700 W) gave 4.6e-4 and
# 4.3e-5, 1.1e-4 and 6.6e-5; each bar is ~10x the larger of the two
TRAIN_BARS = {"loss": 5e-3, "grad_norm": 2e-3}
# the recurrent run: zamba2-2.7b and rwkv6-1.6b at full width, bf16; each
# model's forward over a 2 x 2048 batch, then 6 requests served on the
# dense recurrent-state cache with stepwise admission (4 slots: the last
# two requests reuse freed slots)
REC_ARCHS = ("zamba2-2.7b", "rwkv6-1.6b")
REC_BATCH = (2, 2048)
REC_PROMPTS = (24, 57, 96, 130, 171, 200)
REC_NEW = 16
REC_SCFG = dict(max_batch=4, max_seq=512, max_new_tokens=REC_NEW,
                paged=False, chunked=False)
# With seeded random weights at full depth, both models amplify rounding
# differences layer by layer: in bf16 two correct versions of the forward
# (the kernels and impl="ref") part by O(1) logits, as far as the bf16
# forward is from the float32 forward on the same weights (the model's own
# bf16 noise).  So the bf16 forward's logits are held within
# REC_NOISE_MARGIN x that noise, each layer is held on the same input
# within one rounding step (layer_parity), and the tight checks run in
# float32: logits of the forward, kernels vs ref, within REC_F32_BARS, and
# the served tokens against a teacher-forced forward within the same bar.
REC_NOISE_MARGIN = 1.5
# float32 forward logits, kernels vs impl="ref": 0.179 (zamba2) and 0.0043
# (rwkv6) on an H100 80GB HBM3 (700 W), deterministic for the seeded
# weights; each bar ~2.2x its measurement
REC_F32_BARS = {"zamba2-2.7b": 0.4, "rwkv6-1.6b": 0.01}
# each layer on the same input (layer_parity), relative to its largest
# |input| or |output|: bf16 four rounding steps - a layer rounds its
# updates and residual sums to bf16 (a layer with the shared block three
# times in series, through values larger than its input and output), and
# a kernel's last-bit difference flips some of those roundings; float32
# 1e-4 (a layer's own float32 rounding is ~1e-6 of it)
REC_LAYER_RTOL = {"bfloat16": 2.0 ** -5, "float32": 1e-4}


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

def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def phase_device_and_build():
    print(card(), flush=True)
    secs, logs = build.build_all()
    log(f"# built {sorted(logs)} in {secs:.1f} s (nvcc, sm_90a, in parallel)")
    for name, text in logs.items():
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        smem = [int(b) for b in re.findall(r"(\d+) bytes smem", text)]
        spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill", text))
        log(f"#   {name}: {len(regs)} instantiations, "
            f"{min(regs, default=0)}-{max(regs, default=0)} registers, up "
            f"to {max(smem, default=0)} bytes static smem, {spills} bytes "
            f"of spills")


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

def compare(got: torch.Tensor, want: torch.Tensor, dtype,
            terms: torch.Tensor = None, f32_rel: bool = False) -> float:
    """Max |kernel - plain|; raises past the bar of the dtype.  `terms`
    (bf16 K4 and K5): the magnitude of the summed terms - K4 rounds its
    softmax weights, K5 its p and ds, to bf16 before their products, as
    their plain versions do, and a one-ulp score difference can flip one
    such rounding, so their bar is one bf16 step of the terms.  f32_rel
    (K5): the float32 bar is 1e-5 of the largest |gradient|."""
    g, w = got.float(), want.float()
    err = float((g - w).abs().max())
    if dtype == torch.bfloat16:
        scale = w.abs() if terms is None else w.abs() + terms.float()
        bar = BF16_RTOL * scale + 1e-6
    else:
        bar = torch.full_like(w, F32_TOL * (float(w.abs().max())
                                            if f32_rel else 1.0))
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


def _k5_kw(a):
    return dict(causal=a.get("causal", True), window=a.get("window", 0),
                logit_softcap=a.get("logit_softcap", 0.0))


def k5_call(a, impl=None, terms=False):
    """(dq, dk, dv): the kernel, or its plain version with impl="ref"
    (terms=True: the plain version's magnitude of the summed terms)."""
    args = (a["q"], a["k"], a["v"], a["o"], a["lse"], a["do"])
    if impl == "ref":
        return flash_backward.reference(*args, terms=terms, **_k5_kw(a))
    return flash_backward.flash_attention_bwd(*args, **_k5_kw(a))


def k5_compare(a, dtype) -> float:
    """dq, dk, dv against the plain version: bf16 one step of the terms'
    magnitude, fp32 1e-5 of the largest |gradient|.  Returns the max abs
    error over the three."""
    got, want = k5_call(a), k5_call(a, "ref")
    terms = k5_call(a, "ref", terms=True) if dtype == torch.bfloat16 \
        else (None,) * 3
    return max(compare(g, w, dtype, t, f32_rel=True)
               for g, w, t in zip(got, want, terms))


def k5_training_args(dtype, seed=0):
    """K5 at the training shape: q (4, 2048, 32, 64), k / v (4, 2048, 8,
    64), causal, o and lse from K4, a random do."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=g, device=dev,
                                     dtype=torch.float32).to(dtype)
    a = dict(q=rnd(4, 2048, 32, 64), k=rnd(4, 2048, 8, 64),
             v=rnd(4, 2048, 8, 64), do=rnd(4, 2048, 32, 64), causal=True)
    a["o"], a["lse"] = flash_attention.flash_attention_fwd(a["q"], a["k"],
                                                           a["v"])
    return a


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
        e5 = k5_compare(k5_training_args(dtype), dtype)
        bar = "1e-5 of max |grad|" if dtype == torch.float32 \
            else "2^-7 of the terms"
        log(f"# training shape {str(dtype)[6:]}: K5 (4, 2048, 32/8, 64) "
            f"causal max abs err {e5:.3e} (bar {bar})")
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


def run_traffic(model, params, scfg, count_syncs: bool,
                prompt_lens=PROMPT_LENS):
    """Serve one request per prompt length (seeded prompts) to completion.
    Returns (engine, per-tick wall seconds, implicit sync warnings, wall
    seconds)."""
    eng = ServeEngine(model, params, ServeConfig(**scfg))
    rng = np.random.default_rng(0)
    for n in prompt_lens:
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
# phase 3, training
# ---------------------------------------------------------------------------

def _k5_weight(q, k, v, o, lse, do):
    return q.shape[0] * q.shape[1] * k.shape[1]


def train_check(model, params, batch):
    """One step's loss and gradient norm (the step's loss and backward,
    before the optimizer) through the kernels and through impl="ref",
    from the same state.  Returns {impl: (loss, grad norm)}."""
    out = {}
    for impl in (None, "ref"):
        for p in leaves(params):
            p.grad = None
        loss, _ = model.loss(params, batch, impl=impl, remat=True)
        loss.backward()
        grads = map_tree(lambda p: p.grad, params)
        out[impl] = (float(loss.detach()), float(global_norm(grads)))
    for p in leaves(params):
        p.grad = None
    for key, (a, b) in (("loss", (out[None][0], out["ref"][0])),
                        ("grad_norm", (out[None][1], out["ref"][1]))):
        err = abs(a - b) if key == "loss" else abs(a - b) / b
        log(f"# full-width training step, kernels vs ref: {key} {a:.6f} vs "
            f"{b:.6f}, {'abs' if key == 'loss' else 'rel'} diff {err:.3e} "
            f"(bar {TRAIN_BARS[key]})")
        if not (np.isfinite(a) and err <= TRAIN_BARS[key]):
            raise AssertionError(f"training {key}: kernels and ref disagree")
    return out


def trainer_check():
    """The Trainer on the card at the granite-3-2b smoke config with head
    dim 64 (the kernels take 64 and 128; the smoke config has 16): a run
    that crashes at step 5 and resumes from its step-2 checkpoint ends
    with the same state digest and the same losses as a run that does not
    stop.  Checkpoints go under build/ and are removed after."""
    cfg = get_smoke_config("granite-3-2b").replace(head_dim=64)
    base = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(base, ignore_errors=True)
    kw = dict(global_batch=2, seq_len=64, total_steps=8, warmup_steps=1,
              checkpoint_every=3, log_every=1)
    tc = lambda d: TrainConfig(checkpoint_dir=str(base / d), **kw)
    try:
        Trainer(cfg, tc("resumed"), fail_at_step=5).run()
    except RuntimeError as e:
        if "simulated failure at step 5" not in str(e):
            raise
    else:
        raise AssertionError("the Trainer did not crash at step 5")
    resumed = Trainer(cfg, tc("resumed"))
    if resumed.start_step != 3:
        raise AssertionError(f"resumed at step {resumed.start_step}, not 3")
    got = resumed.run()
    want = Trainer(cfg, tc("whole")).run()
    digest = {d: json.loads((base / d / "step_7" / "manifest.json")
                            .read_text())["digest"]
              for d in ("resumed", "whole")}
    loss = lambda out: {m["step"]: m["loss"] for m in out["metrics"]}
    same_losses = all(loss(want)[s] == v for s, v in loss(got).items())
    log(f"# Trainer crash at step 5 and resume from step 2 (smoke config, "
        f"head dim 64): final digest {digest['resumed']} vs uninterrupted "
        f"{digest['whole']}; losses of steps 3-7 equal: {same_losses}")
    if digest["resumed"] != digest["whole"] or not same_losses:
        raise AssertionError("resumed Trainer run differs from the "
                             "uninterrupted one")
    shutil.rmtree(base)
    return {"final_step": got["final_step"], "digest": digest["resumed"],
            "losses_equal": same_losses}


def phase_train():
    """granite-3-2b at full width trains through init_train_state,
    make_train_step and DataPipeline.device_batch - the calls Trainer.run
    makes each step (the full-width Trainer itself would also save a ~25
    GB .npz state; it runs at the smoke config in trainer_check)."""
    cfg = get_config("granite-3-2b")
    tcfg = TrainConfig(**TRAIN)
    t0 = time.perf_counter()
    model = build_model(cfg)
    state = init_train_state(model, 0, tcfg)
    pipe = DataPipeline(cfg, tcfg)
    n_params = sum(p.numel() for p in leaves(state.params))
    torch.cuda.synchronize()
    log(f"# training granite-3-2b: {n_params / 1e9:.3f} B params, batch "
        f"{tcfg.global_batch} x {tcfg.seq_len}, remat {tcfg.remat}; built "
        f"in {time.perf_counter() - t0:.1f} s")
    # the kernels-vs-ref check on a batch seeded by numpy, the same in every
    # process (the pipeline's batches are hash-seeded: ROADMAP section 3)
    rng = np.random.default_rng(0)
    check = train_check(model, state.params, {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (tcfg.global_batch, tcfg.seq_len),
                     dtype=np.int32)).to(model.device)})
    batch0 = pipe.device_batch(0)
    step = make_train_step(model, tcfg)
    torch.cuda.reset_peak_memory_stats()
    with Capture(flash_backward, "flash_attention_bwd", _k5_weight) as c5, \
            Capture(flash_attention, "flash_attention_fwd", _k4_weight) as c4:
        state, m0 = step(state, batch0)            # warm-up: data step 0
    batches = [pipe.device_batch(s) for s in range(1, 1 + TRAIN_STEPS)]
    torch.cuda.synchronize()
    reset_counts()
    times, outs = [], []
    for b in batches:
        t = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        outs.append(m)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    L, N = cfg.n_layers, TRAIN_STEPS
    want = {"K1": 0, "K2": 0, "K3": 0, "K4": 2 * L * N, "K5": L * N,
            "K6": 0, "K7": 0}
    log(f"# training: {N} counted steps, kernel launches {launches} (want "
        f"{want}: K4 forward + remat recompute, K5 once per layer)")
    if launches != want:
        raise AssertionError(f"training launches {launches} != {want}")
    losses = [float(m0["loss"])] + [float(m["loss"]) for m in outs]
    gnorms = [float(m0["grad_norm"])] + [float(m["grad_norm"]) for m in outs]
    ln_v = math.log(cfg.vocab_size)
    log(f"# training losses (step 0 = warm-up): "
        f"{[round(x, 4) for x in losses]}, ln(vocab) {ln_v:.4f}")
    if not all(np.isfinite(losses + gnorms)):
        raise AssertionError("non-finite training loss or gradient norm")
    if abs(losses[0] - ln_v) > 1.0:
        raise AssertionError(f"step-0 loss {losses[0]:.3f} is not near "
                             f"ln(vocab) {ln_v:.3f}")
    trace = device_trace(lambda: [step(state, b) for b in batches[:2]])
    trace.update(run="train", steps=2)
    log(f"# trace (training, 2 steps): device busy "
        f"{trace['device_busy_s']:.3f} s of {trace['profiled_wall_s']:.3f} s")
    B, S, Hq, D = tcfg.global_batch, tcfg.seq_len, cfg.n_heads, cfg.head_dim
    tokens = B * S
    med = float(np.median(times))
    model_flops = 6 * n_params * tokens \
        + 12 * L * B * Hq * D * S * (S + 1) // 2
    e2e = {"config": cfg.name, "layers": L, "params": n_params,
           "global_batch": B, "seq_len": S, "remat": tcfg.remat,
           "tokens_per_step": tokens, "counted_steps": N,
           "step_ms": [t * 1e3 for t in times], "step_ms_median": med * 1e3,
           "tokens_per_s": tokens / med, "peak_mem_gb": peak / 1e9,
           "losses": losses, "grad_norms": gnorms,
           "lr": [float(m0["lr"])] + [float(m["lr"]) for m in outs],
           "kernel_launches": launches,
           "launches_per_step": {k: v / N for k, v in launches.items()},
           "model_flops_per_step": model_flops,
           "mfu": model_flops / (med * PEAK_FLOP_S),
           "mfu_formula": "(6 * params * tokens + 12 * layers * batch * "
                          "heads * head_dim * seq * (seq + 1) / 2) / "
                          "(median step s * 989e12)",
           "kernels_vs_ref": {"loss": [check[None][0], check["ref"][0]],
                              "grad_norm": [check[None][1],
                                            check["ref"][1]]}}
    del state, model, step, batches, batch0   # free the full-width state
    e2e["trainer_resume"] = trainer_check()
    run = {"launches": launches, "per_step": {k: v / N for k, v in
                                              launches.items()}}
    return run, {"K5": c5.best, "K4_train": c4.best}, e2e, trace


# ---------------------------------------------------------------------------
# phase 3, the recurrent families
# ---------------------------------------------------------------------------

def _forward_want(cfg):
    """Kernel launches of one full-sequence forward: the Mamba2 scan K6 per
    layer and K4 per application of the shared block (hybrid), the RWKV6
    scan K7 per layer (ssm); nothing else."""
    want = {k: 0 for k in COUNTERS}
    if cfg.family == "hybrid":
        want.update(K6=cfg.n_layers, K4=n_shared_applications(cfg))
    else:
        want.update(K7=cfg.n_layers)
    return want


def _rec_batch(model):
    B, S = REC_BATCH
    rng = np.random.default_rng(2)
    return {"tokens": torch.from_numpy(rng.integers(
        0, model.cfg.vocab_size, (B, S), dtype=np.int32)).to(model.device)}


def recurrent_forward(model, params, arch):
    """The bf16 forward over a numpy-seeded 2 x 2048 batch through the
    kernels (launches counted) and through impl="ref"; 3 timed kernel
    forwards (throughput, peak memory).  Returns (the launch counts, the
    ref logits, max |logits kernels - ref|, the e2e numbers)."""
    cfg = model.cfg
    batch = _rec_batch(model)
    torch.cuda.synchronize()
    reset_counts()
    got = model.forward(params, batch)[0]
    torch.cuda.synchronize()
    launches = read_counts()
    want = _forward_want(cfg)
    if launches != want:
        raise AssertionError(f"{arch} forward: kernel launches {launches} "
                             f"!= {want}")
    if not bool(torch.isfinite(got).all()) or got.shape != (
            *REC_BATCH, cfg.vocab_size):
        raise AssertionError(f"{arch} forward: non-finite logits or shape "
                             f"{tuple(got.shape)}")
    ref = model.forward(params, batch, impl="ref")[0]
    err = float((got - ref).abs().max())
    del got
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.forward(params, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    e2e = {"forward_batch": list(REC_BATCH),
           "forward_ms": [t * 1e3 for t in times],
           "forward_ms_median": med * 1e3,
           "forward_tok_s": REC_BATCH[0] * REC_BATCH[1] / med,
           "forward_peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "forward_kernel_launches": launches}
    log(f"# {arch} forward {REC_BATCH}: kernel launches {launches}, "
        f"{med * 1e3:.1f} ms")
    return launches, ref, err, e2e


def layer_parity(model, params, arch) -> float:
    """Each layer of the forward through the kernels against the same layer
    through impl="ref", both on the ref path's input to that layer (so no
    difference carries from one layer into the next): max |y - y_ref|
    within REC_LAYER_RTOL of the layer's largest |input| or |output|.
    Returns the largest |difference| over the layers."""
    cfg = model.cfg
    rtol = REC_LAYER_RTOL[cfg.dtype]
    layers = T.hybrid_layers(params["blocks"], cfg) \
        if cfg.family == "hybrid" else T.rwkv_layers(params["blocks"], cfg)
    worst = 0.0
    with torch.no_grad():
        x = embed(params["tok"], _rec_batch(model)["tokens"], cfg)
        for i, layer in enumerate(layers):
            y_ref, y = layer(x, "ref"), layer(x, None)
            d = float((y.float() - y_ref.float()).abs().max())
            bar = rtol * max(float(x.float().abs().max()),
                             float(y_ref.float().abs().max()))
            if d > bar:
                raise AssertionError(
                    f"{arch} {cfg.dtype} layer {i}: kernels and ref part by "
                    f"{d:.3e} on the same input (bar {bar:.3e})")
            worst = max(worst, d)
            x = y_ref
    log(f"# {arch} {cfg.dtype} layer by layer on the ref path's inputs: "
        f"max |kernels - ref| {worst:.3e}, every layer within {rtol:.3g} "
        f"of its largest |input| or |output|")
    return worst


def fp32_copy(model, params):
    """The model in float32 with the bf16 model's weights (exact)."""
    m32 = build_model(model.cfg.replace(dtype="float32"))
    p32 = m32.params
    with torch.no_grad():
        for (path, a), (path32, b) in zip(leaves_with_paths(params),
                                          leaves_with_paths(p32)):
            if path != path32:
                raise AssertionError(f"parameter trees differ: {path} vs "
                                     f"{path32}")
            b.copy_(a.float())
    return m32, p32


def recurrent_fp32(m32, p32, arch, ref16):
    """The float32 forward through the kernels against impl="ref" (logits
    within REC_F32_BARS), and the bf16 checks' yardstick: the bf16 ref
    logits against the float32 ref logits on the same weights - the
    model's own bf16 rounding noise, which 54 (24) layers of random
    weights amplify to O(1) logits.  Returns (fp32 error, bf16 noise)."""
    batch = _rec_batch(m32)
    ref = m32.forward(p32, batch, impl="ref")[0]
    got = m32.forward(p32, batch)[0]
    err = float((got - ref).abs().max())
    noise = float((ref16 - ref).abs().max())
    log(f"# {arch} float32 forward {REC_BATCH}: logits max |kernels - ref| "
        f"{err:.3e} (bar {REC_F32_BARS[arch]}, logit scale "
        f"{float(ref.abs().max()):.2f}); bf16 ref vs float32 ref on the "
        f"same weights {noise:.3e}")
    if err > REC_F32_BARS[arch]:
        raise AssertionError(f"{arch} float32 forward: kernels and ref "
                             f"disagree")
    return err, noise


def teacher_forced_check(model, params, eng, bar):
    """Every generated token must be the argmax of a teacher-forced kernel
    forward over the request's prompt and generated tokens at its
    position, or within `bar` of that argmax (a near tie).  Returns the
    near ties."""
    ties = []
    for r in sorted(eng.sched.finished, key=lambda r: r.uid):
        seq = list(r.prompt) + list(r.out_tokens)
        toks = torch.tensor([seq[:-1]], dtype=torch.int32,
                            device=model.device)
        logits = model.forward(params, {"tokens": toks})[0][0]
        for i, tok in enumerate(r.out_tokens):
            row = logits[len(r.prompt) - 1 + i]
            top = int(torch.argmax(row))
            if top == tok:
                continue
            gap = float(row[top] - row[tok])
            if gap > bar:
                raise AssertionError(
                    f"request {r.uid} token {i}: generated {tok}, the "
                    f"teacher-forced forward's argmax is {top}, {gap:.3f} "
                    f"above it (bar {bar})")
            ties.append({"uid": r.uid, "index": i, "token": tok,
                         "argmax": top, "gap": gap})
    return ties


def recurrent_serving(model, params, arch, check_tokens: bool):
    """The 6 requests on the dense recurrent-state cache, counted: every
    request finished, launch counts, no implicit sync, one fetch per
    admission and decode tick; with check_tokens the teacher-forced
    check.  Returns (the launch counts, the e2e numbers)."""
    cfg = model.cfg
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    eng, tick_s, syncs, wall = run_traffic(model, params, REC_SCFG, True,
                                           REC_PROMPTS)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    done = eng.sched.finished
    if len(done) != len(REC_PROMPTS) or any(
            len(r.out_tokens) != REC_NEW for r in done):
        raise AssertionError(f"{arch} serving: not every request finished "
                             f"with {REC_NEW} tokens")
    toks = np.array([t for r in done for t in r.out_tokens])
    if toks.min() < 0 or toks.max() >= cfg.vocab_size:
        raise AssertionError("generated token ids out of the vocabulary")
    kinds = [r.kind for r in eng.launch_records()]
    steps = eng.jit_calls           # decode steps: stepwise tokens + ticks
    if steps != sum(REC_PROMPTS) + kinds.count("decode") \
            or kinds.count("stepwise") != len(REC_PROMPTS):
        raise AssertionError(f"{arch} serving: {steps} decode steps for "
                             f"{kinds.count('stepwise')} admissions and "
                             f"{kinds.count('decode')} decode ticks")
    want = {k: 0 for k in COUNTERS}
    if cfg.family == "hybrid":
        want["K3"] = n_shared_applications(cfg) * steps
    if launches != want:
        raise AssertionError(f"{arch} serving: kernel launches {launches} "
                             f"!= {want}")
    if syncs:
        raise AssertionError(f"{arch} serving: {syncs} implicit host syncs "
                             f"in the ticks")
    if eng.host_syncs != len(REC_PROMPTS) + kinds.count("decode"):
        raise AssertionError(f"{arch} serving: {eng.host_syncs} fetches")
    ties = teacher_forced_check(model, params, eng, REC_F32_BARS[arch]) \
        if check_tokens else None
    stats = eng.stats()
    dtype = str(cfg.dtype)
    log(f"# {arch} serving ({dtype}): {len(done)} requests x {REC_NEW} "
        f"tokens, {sum(REC_PROMPTS)} prompt tokens admitted stepwise, "
        f"{kinds.count('decode')} decode ticks, {steps} decode steps; "
        f"kernel launches {launches}, implicit host syncs in the ticks: "
        f"{syncs}" + ("" if ties is None else
                      f"; teacher-forced check: every token the argmax or "
                      f"within {REC_F32_BARS[arch]} of it, near ties "
                      f"{ties}"))
    e2e = {"dtype": dtype, "requests": len(done),
           "prompt_tokens": sum(REC_PROMPTS),
           "gen_tokens": stats["gen_tokens"], "decode_steps": steps,
           "decode_ticks": kinds.count("decode"), "ticks": len(tick_s),
           "wall_s": wall, "gen_tok_s": stats["gen_tokens"] / wall,
           "tokens_per_s": (stats["gen_tokens"] + sum(REC_PROMPTS)) / wall,
           "tick_ms_median": float(np.median(tick_s)) * 1e3,
           "peak_mem_gb": peak / 1e9,
           "cache_gb": eng.kv_cache_bytes() / 1e9,
           "kernel_launches": launches, "implicit_syncs": syncs,
           "host_syncs": eng.host_syncs}
    if ties is not None:
        e2e["near_ties"] = ties
    return launches, e2e


def _scan_weight(t, *rest):
    return t.numel()


def phase_recurrent():
    """zamba2-2.7b and rwkv6-1.6b at full width.  bf16, the deployment
    dtype: the forward (counted; logits against impl="ref" within
    REC_NOISE_MARGIN x the model's own bf16 noise), each layer against
    impl="ref" on the same input, and the 6 requests served (counted).
    float32, on the same weights: the forward's logits against
    impl="ref", each layer on the same input, and the same traffic with
    the teacher-forced token check.  K6 / K7 (and zamba2's
    K4 / K3 at head dim 80) are captured at their largest call for the
    timing phase; one zamba2 forward is traced."""
    run = {"launches": {k: 0 for k in COUNTERS},
           "per_forward": {k: 0 for k in COUNTERS}}
    e2e, captured, trace = {}, {}, None
    for arch in REC_ARCHS:
        cfg = get_config(arch)
        t0 = time.perf_counter()
        model = build_model(cfg)
        params = model.init(seed=0)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in model.parameters())
        log(f"# {arch}: {cfg.family}, {cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, {n_params / 1e9:.2f} B params ({cfg.dtype}), "
            f"built and seeded in {time.perf_counter() - t0:.1f} s")
        with Capture(mamba2_scan, "mamba2_scan", _scan_weight) as c6, \
                Capture(rwkv6_scan, "rwkv6_scan", _scan_weight) as c7, \
                Capture(flash_attention, "flash_attention_fwd",
                        _k4_weight) as c4:
            fwd, ref16, err16, e2e_fwd = recurrent_forward(model, params,
                                                           arch)
        layer_err = layer_parity(model, params, arch)
        serve, e2e_serve = recurrent_serving(model, params, arch, False)
        if cfg.family == "hybrid":
            captured.update(K6=c6.best, K4_d80=c4.best)
            with Capture(flash_decode, "flash_decode", _lens_weight) as c3:
                model.decode_step(params, *_zamba2_decode_args(model))
            captured["K3_d80"] = c3.best
            batch = _rec_batch(model)
            trace = device_trace(lambda: model.forward(params, batch))
            trace.update(run="recurrent", model=arch,
                         forward_batch=list(REC_BATCH))
            log(f"# trace (zamba2 forward {REC_BATCH}): device busy "
                f"{trace['device_busy_s']:.3f} s of "
                f"{trace['profiled_wall_s']:.3f} s")
        else:
            captured["K7"] = c7.best
        m32, p32 = fp32_copy(model, params)
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
        err32, noise = recurrent_fp32(m32, p32, arch, ref16)
        layer_err32 = layer_parity(m32, p32, arch)
        log(f"# {arch} bf16 forward: logits max |kernels - ref| {err16:.3e}"
            f" against the model's own bf16 noise {noise:.3e} (bar "
            f"{REC_NOISE_MARGIN} x it)")
        if err16 > REC_NOISE_MARGIN * noise:
            raise AssertionError(f"{arch} bf16 forward: kernels and ref "
                                 f"part by more than the bf16 noise")
        del ref16
        serve32, e2e_serve32 = recurrent_serving(m32, p32, arch, True)
        for k in COUNTERS:
            run["launches"][k] += fwd[k] + serve[k]
            run["per_forward"][k] += fwd[k]
        e2e[arch] = dict(
            e2e_fwd, params=n_params, serving=e2e_serve,
            serving_fp32=e2e_serve32,
            checks={"forward_bf16_logits_max_abs_err": err16,
                    "bf16_noise_logits_max_abs": noise,
                    "layer_bf16_max_abs_err": layer_err,
                    "layer_fp32_max_abs_err": layer_err32,
                    "forward_fp32_logits_max_abs_err": err32})
        del m32, p32
        gc.collect()
        torch.cuda.empty_cache()
    return run, captured, e2e, trace


def _zamba2_decode_args(model):
    """One decode step of zamba2 at the serving shape: 4 lanes of the
    512-token strips, filled with seeded values, lengths spread over [0,
    512) (an extra step outside the counted runs: capturing K3's arguments
    inside them would synchronise)."""
    cache = model.init_cache(REC_SCFG["max_batch"], REC_SCFG["max_seq"])
    dev = model.device
    g = torch.Generator(device=dev).manual_seed(3)
    for name in ("shared_k", "shared_v"):
        cache[name].copy_(torch.randn(cache[name].shape, generator=g,
                                      device=dev))
    tokens = torch.ones((REC_SCFG["max_batch"], 1), dtype=torch.int32,
                        device=dev)
    lens = torch.tensor([0, 100, 300, 511], dtype=torch.int32, device=dev)
    return tokens, lens, cache


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
    kw = _k4_kw(a)
    pairs = _pairs(Sq, k.shape[1], kw["causal"], kw["window"])
    el = q.element_size()
    nbytes = (2 * q.numel() + 2 * k.numel()) * el + 4 * B * Sq * Hq
    return nbytes, 4 * D * Hq * B * pairs


def _pairs(sq, skv, causal, window):
    """(query, attended key) pairs of one head under the mask."""
    pairs = 0
    for s in range(sq):
        hi = min(s + 1, skv) if causal or window > 0 else skv
        lo = max(0, s - window + 1) if window > 0 else 0
        pairs += max(hi - lo, 0)
    return pairs


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


def k5_work(a):
    """q, k, v, o, do and the fp32 lse read once, dq, dk, dv written once;
    five products of 2*D FLOPs (s = q k, dp = do v, dv += p do, dq += ds
    k, dk += ds q) per (query head, attended key) pair under the mask."""
    q, k = a["q"], a["k"]
    B, Sq, Hq, D = q.shape
    kw = _k5_kw(a)
    pairs = _pairs(Sq, k.shape[1], kw["causal"], kw["window"])
    el = q.element_size()
    nbytes = (4 * q.numel() + 4 * k.numel()) * el + 4 * B * Sq * Hq
    return nbytes, 10 * D * Hq * B * pairs


def k5_library(a):
    """The backward alone of one causal scaled_dot_product_attention call
    with enable_gqa: torch.autograd.grad of its output with respect to
    q, k and v, on inputs laid out as (B, H, S, D) beforehand."""
    qq, kk, vv = (a[n].transpose(1, 2).contiguous().requires_grad_(True)
                  for n in ("q", "k", "v"))
    dd = a["do"].transpose(1, 2).contiguous()
    out = torch.nn.functional.scaled_dot_product_attention(
        qq, kk, vv, is_causal=_k5_kw(a)["causal"], enable_gqa=True)
    return lambda: torch.autograd.grad(out, (qq, kk, vv), dd,
                                       retain_graph=True)


def k6_call(a, impl=None):
    return ops.mamba2_scan(a["x"], a["dt"], a["A"], a["Bm"], a["Cm"],
                           impl=impl)


def k7_call(a, impl=None):
    return ops.rwkv6_scan(a["r"], a["k"], a["v"], a["w"], a["u"], impl=impl)


def scan_compare(call, a, dtype) -> float:
    """K6 / K7 against the plain chunked scan: float32 within 1e-5 of the
    largest term (the plain scan of the inputs' absolute values - the
    decays are positive - is the magnitude of the summed terms), bfloat16
    within one rounding step of the output, 2^-7 |y|, plus that."""
    got, want = call(a), call(a, "ref")
    absd = {k: (v.abs() if k in ("x", "Bm", "Cm", "r", "k", "v", "u")
                else v) for k, v in a.items()}
    bar = F32_TOL * float(call(absd, "ref").float().abs().max())
    g, w = got.float(), want.float()
    err = float((g - w).abs().max())
    limit = bar + (BF16_RTOL * w.abs() if dtype == torch.bfloat16 else 0.0)
    if not bool(torch.isfinite(g).all()) or not bool(
            ((g - w).abs() <= limit).all()):
        raise AssertionError(f"scan kernel disagrees with its plain "
                             f"version: max abs err {err:.3e} ({dtype})")
    return err


def k6_work(a):
    """x, dt, A, B, C read once, y written once; the chunked form's
    products over 128-step chunks, the causal half of each chunk's pairs
    (C B^T masked, times dt x), the carry-in C h and the state update
    (dt x)^T B: 2 (T (T + 1) / 2 (N + P) + 2 T N P) FLOPs per chunk, head
    and sequence."""
    x, Bm = a["x"], a["Bm"]
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    el = x.element_size()
    nbytes = 2 * x.numel() * el + 2 * Bm.numel() * el \
        + (a["dt"].numel() + a["A"].numel()) * 4
    T = 128
    flops = 0
    for c0 in range(0, S, T):
        t = min(T, S - c0)
        flops += 2 * (t * (t + 1) // 2 * (N + P) + 2 * t * N * P)
    return nbytes, flops * B * H


def k7_work(a):
    """r, k, v, w, u read once, y written once; the chunked form's products
    over 32-step chunks: the strictly lower pairs (r e^cw)(k e^-cw)^T times
    v, the diagonal (r u k) v, the carry-in r S and the state update k^T v:
    T (T - 1) (K + V) + 3 T K + 4 T K V FLOPs per chunk, head and
    sequence."""
    r, v = a["r"], a["v"]
    B, S, H, K = r.shape
    V = v.shape[-1]
    el = r.element_size()
    nbytes = (2 * r.numel() + 2 * v.numel()) * el \
        + (a["w"].numel() + a["u"].numel()) * 4
    T = 32
    flops = 0
    for c0 in range(0, S, T):
        t = min(T, S - c0)
        flops += t * (t - 1) * (K + V) + 3 * t * K + 4 * t * K * V
    return nbytes, flops * B * H


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
    "K5": ("K5 flash_backward", k5_call, k5_work, k5_library,
           "src/repro_torch/csrc/flash_backward.cu",
           "src/repro/kernels/flash_backward.py:168", "train",
           ("q", "k", "v", "o", "lse", "do")),
    "K6": ("K6 mamba2_scan", k6_call, k6_work, None,
           "src/repro_torch/csrc/mamba2_scan.cu",
           "src/repro/kernels/mamba2_scan.py:72", "recurrent",
           ("x", "dt", "A", "Bm", "Cm")),
    "K7": ("K7 rwkv6_scan", k7_call, k7_work, None,
           "src/repro_torch/csrc/rwkv6_scan.cu",
           "src/repro/kernels/rwkv6_scan.py:83", "recurrent",
           ("r", "k", "v", "w", "u")),
}
PER = {"train": "per_step", "recurrent": "per_forward"}


def _timed(key, args_kw, flush):
    """One kernel at one captured call: parity (its dtype and float32),
    kernel, plain and library times, the bound."""
    name, call, work, lib, src, tpu, run, names = KERNELS[key]
    args, kw = args_kw
    a = dict(zip(names, args))
    a.update(kw)
    f32 = {k: (v.float() if torch.is_tensor(v) and v.is_floating_point()
               else v) for k, v in a.items()}
    dtype = next(v for v in a.values() if torch.is_tensor(v)).dtype
    if key in ("K4", "K5"):
        cmp = {"K4": k4_compare, "K5": k5_compare}[key]
        err, err32 = cmp(a, dtype), cmp(f32, torch.float32)
    elif key in ("K6", "K7"):
        err = scan_compare(call, a, dtype)
        err32 = scan_compare(call, f32, torch.float32)
    else:
        err = compare(call(a), call(a, "ref"), dtype)
        err32 = compare(call(f32), call(f32, "ref"), torch.float32)
    nbytes, flops = work(a)
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FLOP_S
    ms = time_ms(lambda: call(a), flush)
    return {"max_abs_err": err, "max_abs_err_f32": err32, "ms": ms,
            "tflops": flops / ms / 1e9,
            "plain_ms": time_ms(lambda: call(a, "ref"), flush),
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": time_ms(lib(a), flush) if lib else None,
            "shape": {k: list(v.shape) for k, v in a.items()
                      if torch.is_tensor(v)},
            "bytes": nbytes, "flops": flops}


def phase_times(runs, captured):
    flush = torch.empty(64 * 1024 * 1024 // 4, dtype=torch.float32,
                        device="cuda")
    rows = []
    for key, (name, _, _, lib, src, tpu, run, _) in KERNELS.items():
        per = PER.get(run, "per_tick")
        row = {"name": name, "route": "cuda", "source": src, "replaces": tpu,
               "launches": runs[run]["launches"][key],
               f"launches_{per}": runs[run][per][key],
               "launches_by_run": {r: v["launches"][key]
                                   for r, v in runs.items()},
               "timed_from_run": run}
        row.update(_timed(key, captured[key], flush))
        row["library"] = (
            "none: no single PyTorch call computes this scan" if lib is None
            else "scaled_dot_product_attention"
            + (" on K/V pre-gathered into contiguous strips (gather not "
               "timed)" if key in ("K1", "K2")
               else " backward (torch.autograd.grad of its output; inputs "
               "transposed beforehand, not timed)" if key == "K5"
               else " (inputs transposed beforehand, not timed)"))
        # zamba2's shared attention block (head dim 80, 32 heads, G 1); the
        # training step's forward (4 x 2048 tokens, 32 / 8 heads of 64)
        for tag, label in (("d80", "at_zamba2_d80"), ("train", "at_train")):
            if f"{key}_{tag}" in captured:
                row[label] = _timed(key, captured[f"{key}_{tag}"], flush)
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# phase 5
# ---------------------------------------------------------------------------

# the device functions of each port kernel (csrc/*.cu), as the profiler
# names them: K2's and K3's split and combine kernels (the split-KV kernel
# of csrc/split_decode.cuh, named after paged_decode::Pages and
# dense_decode::Strip) count together, and so do K6's and K7's two bf16
# launches (their state scan and output kernels; rwkv6_scan_state_kernel
# and rwkv6_scan_chunk_out_kernel for K7)
PORT_KERNEL_NAMES = {"K1": ("paged_prefill",), "K2": ("paged_decode",),
                     "K3": ("dense_decode",), "K4": ("flash_attention",),
                     "K5": ("flash_bwd", "dq_bf16", "dkv_bf16"),
                     "K6": ("mamba2_scan",), "K7": ("rwkv6_scan",)}


def device_trace(fn) -> dict:
    """fn() under torch.profiler, tracing device activity only (no host op
    recording, so the wall time stays near the unprofiled one): device
    time by kernel name, and the device's busy share of that wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) \
            or getattr(e, "self_cuda_time_total", 0)

    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy = sum(dev_us(e) for e in kernels) / 1e6
    top = sorted(kernels, key=dev_us, reverse=True)[:10]
    if not busy:
        log("# the profiler recorded no device time: not measured")
    port = {}
    for key, names in PORT_KERNEL_NAMES.items():
        mine = [e for e in kernels if any(n in e.key for n in names)]
        if mine:
            us = sum(dev_us(e) for e in mine)
            port[key] = {"ms": us / 1e3, "launches": sum(e.count
                                                         for e in mine),
                         "share_of_busy": us / 1e6 / busy if busy else None}
    return {"profiled_wall_s": wall, "device_busy_s": busy,
            "busy_share": busy / wall,
            "top_kernels_ms": [[e.key[:80], dev_us(e) / 1e3, e.count]
                               for e in top],
            "port_kernels": port}


def phase_trace(model, params, run: str, counted_wall_s: float):
    """The run's traffic once more under the device-only profiler."""
    out = device_trace(lambda: run_traffic(model, params, RUNS[run],
                                           count_syncs=False))
    out.update(run=run, counted_wall_s=counted_wall_s)
    shares = ", ".join(f"{k} {v['ms']:.1f} ms ({v['share_of_busy']:.2f})"
                       for k, v in out["port_kernels"].items()
                       if v["share_of_busy"] is not None)
    log(f"# trace ({run}): device busy {out['device_busy_s']:.3f} s of "
        f"{out['profiled_wall_s']:.3f} s profiled wall (unprofiled counted "
        f"run: {counted_wall_s:.3f} s wall); port kernels (share of busy): "
        f"{shares}")
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
    trace = phase_trace(*mp, "chunked", runs["chunked"]["e2e"]["wall_s"])
    trace_dense = phase_trace(*mp, "dense", runs["dense"]["e2e"]["wall_s"])
    trace_pm = phase_trace(*mp, "paged_monolithic",
                           runs["paged_monolithic"]["e2e"]["wall_s"])
    del mp                       # the serving model, before the training one
    gc.collect()
    torch.cuda.empty_cache()
    runs["train"], train_captured, e2e_train, trace_train = phase_train()
    captured.update(train_captured)
    gc.collect()
    torch.cuda.empty_cache()
    runs["recurrent"], rec_captured, e2e_rec, trace_rec = phase_recurrent()
    captured.update(rec_captured)
    rows = phase_times(runs, captured)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"trace": trace}), flush=True)
    print(json.dumps({"trace_dense": trace_dense}), flush=True)
    print(json.dumps({"trace_paged_monolithic": trace_pm}), flush=True)
    print(json.dumps({"trace_train": trace_train}), flush=True)
    print(json.dumps({"trace_recurrent": trace_rec}), flush=True)
    print(json.dumps({"e2e": runs["chunked"]["e2e"]}), flush=True)
    print(json.dumps({"e2e_dense": runs["dense"]["e2e"]}), flush=True)
    print(json.dumps({"e2e_paged_monolithic":
                      runs["paged_monolithic"]["e2e"]}), flush=True)
    print(json.dumps({"e2e_train": e2e_train}), flush=True)
    print(json.dumps({"e2e_recurrent": e2e_rec}), flush=True)
    log(f"# total {time.perf_counter() - t0:.1f} s")
    print(card(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
