#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one GPU

Phases (each raises on failure, so the run exits non-zero):

  1. device and build   the card's name and power limit (nvidia-smi), then
                        every CUDA kernel of repro_torch (K1-K7) built from
                        src/repro_torch/csrc with nvcc for sm_90a, one nvcc
                        per source, all started together (when each
                        finished printed; no K4 bf16 tile may spill).
  2. kernel parity      the hand-written kernels against their plain
                        PyTorch versions on the card: the edge cases of
                        tests/test_torch_kernels_cuda.py (run with pytest,
                        every collected test, in EDGE_PROCS processes at
                        once),
                        the serving shapes (head dim 64, 4 query heads per
                        KV head; K1/K2 over pages of 16, K4 prompts of
                        (1, 1904) and (2, 256), K3 8 strips of 2048 with
                        lengths spread over [0, 2048]) and K5 at the
                        training shape (4 x 2048 tokens, 32 / 8 heads,
                        causal, o and lse from K4), at gemma3-4b's (8 /
                        4 heads of 256, causal, and with its window of
                        1024), at llava-next-34b's (2 x 2048, 56 / 8
                        heads of 128, causal) and K4 / K5 at the M14
                        shard's (2 x 2048, 16 / 4 heads of 64), in
                        float32 and bfloat16; the test file also holds K3 and K4 at
                        head dim 80, K4 at every tile its source
                        instantiates, and the edge cases of the scans K6
                        and K7 (their full-width shapes among them).  Then
                        K4 in bf16 at every instantiated tile at each of
                        K4_SHAPES (PERF.md §6's K4 shapes) against its
                        plain version (the bf16 bar of the terms and 2^-6
                        of the largest |o|, lse 1e-5) and timed: one line
                        a shape with the tile core/hopper_mapping.py's
                        chooser picks and every tile.  Then K4 at the
                        paper's attention workloads (phase_paper): the
                        port's 3D-Flow simulator's OPT-6.7B (32 heads of
                        128) and Qwen-7B (28 / 4 heads of 128) built from
                        the registered configs, one layer at batch 1, bf16,
                        non-causal, at 1024, 4096, 16384 and 65536
                        positions, at the chooser's tile, against the plain
                        version (every row up to 4096, 512 seeded random
                        rows past it), timed beside its bound and one
                        scaled_dot_product_attention call, with every
                        instantiated tile timed at 16384; the simulator's
                        op count and launch/cost.py's FLOPs must agree.
  3. the slices        serving: granite-3-2b at full width (40 layers,
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
                        speculation, prefix cache, preemption: the same
                        model serves, counted as above, each beside a
                        reference run of the same traffic without the
                        feature: speculative (spec_k 4, spec_ngram 3; 8
                        prompts of 200-1900 tokens repeating their own
                        n-grams; K1 = 40 x chunk batches + verify launches)
                        against speculation off; prefix (a 1024-token
                        shared prefix, 8 suffixes of 16-256 tokens in two
                        waves, and the bare prefix, wholly cached, in the
                        second) and prefix_monolithic (chunked=False: each
                        admission one chunk through K1 at K = 1) against
                        the cache off; preempt (prefix cache on, 260 usable
                        pages: a priority-5 burst sheds prefilling and
                        decoding requests, which resume and finish) against
                        the whole pool.  Each run's outputs equal its
                        reference's, or every token of a request that
                        differs passes the teacher-forced check at
                        SERVED_TOKEN_BAR; at least one verify launch, a
                        prefix hit, and preemptions that all resumed.
                        the span tracer, deadlines, the fleet: the same
                        model serves, counted as above: telemetry (the
                        chunked traffic with ServeConfig(telemetry=True):
                        its tokens, launch records and launch_log rows
                        without wall time equal the chunked run's, a
                        second run traces the same deterministic records,
                        the Perfetto export in both clocks written under
                        chiprun_out/m6d_traces and parsed back, the
                        movement model's totals - first-order bytes and
                        the paper's 16 nm energy table, not a reading of
                        the card); deadline (the chunked prompts on 4
                        slots with DEADLINES: requests expire while
                        queued, prefilling and decoding, every uid ends
                        done or timeout, every page back in the pool,
                        the done requests against the same traffic
                        without deadlines); fleet (the prefix traffic
                        through 2 replicas of 1 slot, affinity dispatch,
                        replica 1 failed while it holds a queued and an
                        in-flight request, every request done, K1 / K2 40
                        x the replicas' chunk batches / decodes, no
                        implicit sync in the router's ticks, outputs
                        against a 1-replica fleet).
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
                        recurrent: zamba2-2.7b (18 of its 54 Mamba2
                        layers, a shared attention block of head dim 80
                        after every 6th) and rwkv6-1.6b (8 of its 24 RWKV6
                        layers) at full width, seeded weights.  bf16: each
                        model's forward over a numpy-seeded 2 x 2048 batch
                        through the kernels (counts set to 0 before, read
                        after: K6 18 and K4 3 a zamba2 forward, K7 8 an
                        rwkv6 forward, the
                        rest 0), its logits against impl="ref" within
                        REC_NOISE_MARGIN x the model's own bf16 noise, and
                        each layer against impl="ref" on the same input
                        within REC_LAYER_RTOL; then 6 requests (prompts
                        of 24 to 200 tokens, 16 new tokens each, 4 slots:
                        two requests reuse a freed slot) served on the
                        dense recurrent-state cache with stepwise
                        admission: counts set to 0 before, read after
                        (zamba2: K3 3 x the engine's decode steps, every
                        other kernel 0; rwkv6: all 0), no implicit host
                        sync in the ticks.  float32 on the same weights:
                        the forward's logits against impl="ref" within
                        REC_F32_BARS, each layer as in bf16 with the
                        float32 bar, and the same traffic, every generated
                        token the argmax of a teacher-forced kernel
                        forward at its position or within REC_F32_BARS of
                        it (near ties printed); a corrupted recurrent
                        state moves the logits by O(1).
                        the dense family: opt-6.7b, qwen-7b and gemma3-4b
                        at full width with 8, 7 and 12 of their layers
                        (DF_SERVE_LAYERS) serve the chunked traffic
                        (gemma3-4b also the dense), counted and checked as
                        above;
                        olmo-1b (head dim 128) and gemma3-4b (34 layers,
                        8 / 4 heads of 256, windows of 1024 on 29 layers,
                        vocab 262144) train DF_TRAIN_STEPS steps of
                        2048-token rows: one step against impl="ref"
                        within TRAIN_BARS, K4 2 x n_layers and K5 n_layers
                        launches a step and nothing else, finite losses
                        from near initial_loss (ln(vocab) + the seeded
                        logits' variance / 2), step time, MFU and peak
                        memory; granite-8b runs one forward against
                        impl="ref".
                        tensor-parallel serving (M10, run right after the
                        serving phase, phase_m10): two ranks on cuda:0,
                        each a spawned process, in a gloo world (NCCL
                        refuses two ranks on one device).  K1's chunk and
                        verify lanes and K2 at granite-3-2b's shapes, each
                        rank on its half of the heads (16 / 4, G 4) through
                        the sharded wrappers, gathered: bit-equal to the
                        unsharded kernels in the parent.  Then each rank
                        seeds granite-3-2b at full width (checked against
                        the parent's weights) and serves the chunked
                        traffic at tp 2 under the device profiler, then
                        the chunked and speculative traffic counted: every
                        rank's tokens equal to the tp 1 runs', its K1 / K2
                        launches the tp 1 runs', 0 implicit syncs of the
                        engine (gloo's own synchronising calls counted
                        apart), shard bytes x 2 = pages read x page bytes,
                        and half of tp 1's pool bytes on each rank.
                        sharded training (M14a, phase_m14, right after
                        the training phase): four ranks on cuda:0, each a
                        spawned process, in a gloo world on
                        make_debug_mesh(2, 2); granite-3-2b at full width
                        with 8 of its 40 layers trains 2 steps of 4 x 2048
                        numpy-seeded tokens (2 x 2048 a rank) through
                        Trainer(mesh=, state_shardings=train_cell(...)):
                        every rank's losses equal rank 0's and the single-
                        device Trainer's steps from the same seeded
                        weights within M14_BARS (the JAX package's bars),
                        K4 2 x 8 and K5 8 launches a step on each rank's
                        16 / 4 head shard and nothing else; the step wall,
                        collective calls and bytes a step and peak memory
                        a rank printed; the checkpoint the mesh wrote
                        restored without a mesh, every rank's shard of
                        every leaf bit-equal (digests); the serve CLI and
                        the three examples (examples/torch_*.py) once each
                        on the card.  In the same ranks, on the trained
                        weights: launch/specs.py prefill_cell's step (4 x
                        2048, K4 on the rank's heads) and two serve_cell
                        decode runs of 16 teacher-forced steps, each filled
                        by its prefill cell - 4 lanes to 4096 positions in
                        the default layout (K3 on the rank's heads) and 1
                        lane to 32768 with the sequence over the data axis
                        (ops.seq_parallel_decode) - against the single-
                        device prefill and decode of the restored
                        checkpoint: logits within MODEL_BARS, argmax equal
                        or a near tie, cache shards within M14_CACHE_BAR
                        of the slices, K3 / K4 launches a rank.  Then
                        launch/dryrun.py's record of the train cell (rank
                        0, meta device, fake world): its state collectives
                        equal each rank's a step, its argument bytes
                        printed beside torch.cuda.memory_allocated().
                        Then the MoE family in the same ranks:
                        olmoe-1b-7b at full width with 2 of its 16 layers
                        trains 2 steps of 2 x 2048 numpy-seeded tokens
                        twice through the mesh Trainer - the per-row
                        dispatch at the published capacity factor 1.25,
                        and the REPRO_MOE_A2A exchange at the smallest of
                        2.0, 3.0, 4.0 at which neither path drops a pair
                        of these batches (the drops of both paths printed
                        by factor) - each within M14_BARS of the single-
                        device Trainer at its factor, every rank's losses
                        rank 0's, K4 8 and K5 4 a rank a run and nothing
                        else, the exchange's all_to_all calls counted
                        (sharding/shards.py COMM) and none on the per-row
                        path; then a prefill cell of 2 x 2048 and 16
                        decode steps of the serve cell (default layout:
                        K4 2, K3 32 a rank) on the per-row run's weights
                        against one device, as granite's.  Then the vlm
                        and audio families in the same ranks (M14_VA),
                        each first serving its seeded weights through
                        the cells, then training 2 steps: llava-next-34b
                        at full width with 1 of its 60 layers (2 x (576
                        + 1472) positions; K4 4 / K5 2 a rank, serving K4
                        1 / K3 16) and whisper-base whole (4 x 1500; K4
                        60 / K5 36, serving K4 18 a prefill, K3 192 on 4
                        lanes in the default layout, none on 1 lane with
                        the sequence over data), against one device on
                        the same weights, run before the ranks start.
                        sequence-parallel decode (M11): the serving
                        granite-3-2b, batch 1, prefills a 32768-token
                        prompt into a dense cache (2.7 GB of K/V); on
                        layer 0's strips _decode_partials over 4 slices,
                        merged, and seq_parallel_decode in a one-rank
                        NCCL group (its all-gather on the card) are held
                        against K3 (bf16 one output rounding step, float32
                        copies 1e-5); then 16 greedy decode steps with
                        seq_parallel=True (ops.decode_attention_naive, no
                        kernel) and through K3, each from the prefilled
                        cache, counted: the tokens equal, or every
                        seq-parallel token within NEAR_TIE of the top of
                        K3's logits fed the same tokens, those logits
                        within MODEL_BARS["seq-parallel decode step"], K3
                        40 x 16 launches and the naive run none, 0
                        implicit syncs; both step times.
                        whisper-base (M13, M9) at full width (6 + 6
                        layers, d_model 512, 8 heads of 64, vocab 51865,
                        bf16, seeded weights): 16 clips of 1500 numpy-
                        seeded frame embeddings (the frontend is a stub)
                        and a 4-token prompt through init_cache(16, 448,
                        enc_len=1500), prefill (counted: K4 18 = encoder 6
                        + decoder self 6 + cross 6) and 124 greedy decode
                        steps (counted: K3 12 a step, self and cross; 0
                        implicit syncs): the prefill's logits against
                        Model.forward's and each step's against a
                        teacher-forced forward within MODEL_BARS; the
                        largest K4 (encoder, cross) and K3 (self, cross)
                        calls kept for phase 4, which holds them against
                        their plain versions; the engine (4 requests,
                        dense, stepwise, 2 slots, counted: K3 12 x its
                        decode steps, 0 implicit syncs), each request's
                        output equal to the same request served alone;
                        training 3 steps of 8 x 1500 (frames and tokens)
                        with remat "full": K4 30 and K5 18 a step, finite
                        losses from near ln(vocab), step time, MFU, peak
                        memory, the largest K5 call kept for phase 4.
                        the MoE family (M13): olmoe-1b-7b at full width
                        and depth (16 layers, 64 experts, top 8, 16 heads
                        of 128) and qwen3-moe-235b-a22b at its published
                        widths with MOE_LAYERS of its 94 layers (128
                        experts, top 8, 64 / 4 heads of 128: K1-K4 at G
                        16), bf16, seeded weights, one at a time.  Each
                        serves the chunked traffic: a warm-up run that
                        records every MoE call's routing and every
                        sampling call's logits (Routing), the counted run
                        (K1 / K2 n_layers x the engine's chunk batches /
                        decodes, every other kernel 0, 0 implicit syncs,
                        its tokens the warm-up's), then the same engine
                        and traffic through impl="ref" (no kernel launch)
                        with the warm-up's routing, held to the warm-up
                        event by event over the live rows until the runs
                        part (moe_events_check: MOE_PROB_BARS,
                        MOE_LOGIT_BARS; routing flips and the parting
                        token reported with their gaps) - the teacher-
                        forced forward is no oracle here, as the capacity
                        follows each call's length; model_check with the
                        ref pass on the kernel pass's routing; the traffic
                        under the profiler.  olmoe also: the MoE layer
                        alone at the largest chunk-batch call and an
                        8-lane decode call (ms, bound, error against
                        float32 operands), moe_ffn_a2a_local in a one-rank
                        NCCL group against moe_ffn, and its float32 copy
                        serving through the kernels and through impl="ref",
                        each on its own routing, held the same way.  Then
                        olmoe-1b-7b at full width with 8 of its 16 layers
                        (3.56 B parameters, ~43 GB of training state)
                        trains 3 steps of 4 x 2048 numpy-seeded tokens,
                        remat full, capacity factor 1.25: the first step
                        against impl="ref" within M14_BARS, K4 48 and K5
                        24 launches and nothing else, step time, tokens/s,
                        peak memory and an MFU over the parameters a
                        token reaches (moe_train_flops).
                        the vision-language family (M13): llava-next-34b
                        at full width and depth (60 layers, 56 / 8 heads
                        of 128, 34.39 B parameters, 68.8 GB of bf16
                        weights, seeded), text only through the engine as
                        in the JAX package: the chunked traffic (warm-up,
                        counted: K1 / K2 60 x the engine's, 0 implicit
                        syncs; teacher-forced check; traced), model_check
                        (its bars raised to REC_NOISE_MARGIN x the model's
                        own bf16 noise against a float32 forward streamed
                        layer by layer, where that is larger); the image
                        path (vlm_image_path: 4 rows of 576 seeded patch
                        embeddings and 256 text tokens, make_prefill_step
                        counted K4 60, 32 greedy make_serve_step steps
                        counted K3 60 a step, 0 implicit syncs; every
                        token teacher-forced with its image; the rows with
                        two padded against each row alone; the image moves
                        the logits); a float32 copy of 8 layers through
                        the image path (the near-tie rule) and model_check
                        (VLM_F32_MODEL_BAR); 4 of the 60 layers training
                        2 x 2048 (576 image + 1472 text positions), as
                        the dense family trains.
  4. times              per kernel, at the largest call its run gave it
                        (K1/K2 the chunked run, K3/K4 the dense run, K5 the
                        training run, K6/K7 the recurrent forwards; K3/K4
                        also at zamba2's head dim 80, K4 also at the
                        training step's shape, K1 also at the speculative
                        run's largest verify launch, K3 / K4 / K5 also at
                        whisper-base's, K1-K4 at olmoe-1b-7b's and
                        qwen3-moe's, K1-K5 at llava-next-34b's): kernel,
                        plain version and
                        library times (CUDA events, L2 flushed, median of
                        25) beside the bound the card's data sheet allows
                        and the achieved rate (tflops: the FLOPs the call's
                        data needs over the kernel's time); then the
                        end-to-end numbers of the counted runs.
  5. trace              the chunked, the dense, the paged-monolithic, the
                        speculative, the prefix, the prefix_monolithic and
                        the preempt traffic once more, 2 training steps,
                        and one zamba2
                        forward, under torch.profiler (device activity
                        only): device time by kernel name and by port
                        kernel (K1-K7, each one's share of the busy time),
                        and the device's busy share of that same run's
                        wall time.

Output: the nvidia-smi line, one {"kernels": [...]} line (K1-K7), one
{"trace": ...}, one {"trace_dense": ...}, one {"trace_paged_monolithic":
...}, one {"trace_train": ...}, one {"trace_recurrent": ...} and one
{"trace_<run>": ...} line for each of speculative, prefix,
prefix_monolithic and preempt, one {"e2e": ...} line (the chunked run),
one {"e2e_dense": ...}, one {"e2e_paged_monolithic": ...}, one
{"e2e_train": ...}, one {"e2e_recurrent": ...} and one {"e2e_<run>": ...}
line for each of those four runs (its reference run inside), one
{"e2e_m14": ...} line, one
{"e2e_dense_family": ...}, one {"e2e_telemetry": ...} and one
{"e2e_deadline": ...} line (each with its reference run inside) and one
{"e2e_fleet": ...} line, one {"e2e_m11": ...}, one {"e2e_whisper":
...}, one {"trace_moe": ...}, one {"e2e_moe": ...}, one {"trace_vlm":
...} and one {"e2e_vlm": ...} line, the card line again, and as the last
line {"ok": true,
"device": {...}}.  Without a GPU it exits
non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import functools
import gc
import json
import math
import os
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
from repro_torch.kernels import ops, paged_prefill, ref  # noqa: E402
from repro_torch.launch import cost  # noqa: E402
from repro_torch.models import build_model, moe  # noqa: E402
from repro_torch.models.moe_a2a import moe_ffn_a2a_local  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.layers import (apply_norm, embed,  # noqa: E402
                                       pdtype, unembed)
from repro_torch.models.transformer import n_shared_applications  # noqa
from repro_torch.optim import global_norm  # noqa: E402
from repro_torch.serve import (FleetConfig, FleetRouter,  # noqa: E402
                               ServeEngine, engine, serve_step)
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
# ~1.6-1.7x over its measurement.  The same way, on the same card: the
# seq-parallel decode step (decode_attention_naive) against K3's on the
# same tokens 0.0773 (phase_m11); whisper-base's decode steps (K3)
# against a teacher-forced forward (K4) 0.0188 at a logit scale of ~2,
# and its prefill against its forward 0 - the same kernel calls on the
# same shapes, only the float32 unembedding of the last row is a GEMM
# of another shape, so that bar is the float32 one
MODEL_BARS = {"chunk batch": 0.12, "paged decode step": 0.12,
              "forward": 0.18, "dense prefill": 0.12,
              "dense decode step": 0.12, "paged prefill": 0.12,
              "paged decode after paged prefill": 0.13,
              "seq-parallel decode step": 0.125,
              "whisper prefill": 1e-5, "whisper decode step": 0.03}
PROMPT_LENS = (37, 128, 300, 511, 700, 1024, 1500, 1900)
NEW_TOKENS = 32
# the engines: paged + chunked + batched; monolithic prefill on the dense
# cache at the same batch and length; monolithic prefill on the paged
# cache with the chunked run's pool settings
SCFG = dict(max_batch=8, max_seq=2048, page_size=16, prefill_chunk=256,
            tick_token_budget=1024, max_new_tokens=NEW_TOKENS, paged=True,
            chunked=True, batched=True)
# speculative decoding (the JAX defaults spec_k 4, spec_ngram 3): prompts
# of repeated n-grams, so the drafter finds the history's own patterns
SPEC_LENS = (200, 420, 640, 860, 1100, 1350, 1600, 1900)
SPEC = dict(SCFG, speculative=True, spec_k=4, spec_ngram=3)
# the prefix cache: a 1024-token shared prefix with 8 distinct suffixes in
# two waves (the second wave starts when the first has drained and
# published its pages) and, in the second, the bare prefix, which is
# wholly cached and so copies its last page on write
PREFIX_LEN = 1024
PREFIX_SUFFIXES = ((16, 80, 144, 208), (48, 112, 176, 256, 0))
# preemption: low-priority requests at tick 0, a priority-5 burst at tick
# 2 that does not fit in PREEMPT_USABLE of the pool's 1024 usable pages;
# it sheds the two long prompts mid-prefill and a short one mid-decode
# (the same scheduling for any weights: no stop token, no speculation)
PREEMPT_BACKGROUND = (200, 300, 1500, 1900)
PREEMPT_BURST = (1800, 1800)
PREEMPT_USABLE = 260
# request deadlines: the chunked traffic's prompts on 4 slots, so that
# requests queue, each with its work-clock deadline (None: none).  The
# scheduler alone decides where each expires, the same for any weights:
# requests 1 and 5 while decoding, 7 queued, 8 prefilling
DEADLINE_SCFG = dict(SCFG, max_batch=4)
DEADLINES = (990, None, None, None, 1050, None, 2500, 3000)
# the fleet: replicas of 1 slot with the prefix cache, affinity dispatch,
# over the prefix traffic (so each replica queues a request of the first
# wave behind another); replica 1 fails at the first tick at which it
# holds a queued request and one in flight
FLEET_SCFG = dict(SCFG, prefix_cache=True, max_batch=1)
FLEET_REPLICAS = 2
RUNS = {"chunked": SCFG,
        "dense": dict(max_batch=8, max_seq=2048, max_new_tokens=NEW_TOKENS,
                      paged=False, chunked=False),
        "paged_monolithic": dict(SCFG, chunked=False),
        "speculative": SPEC, "speculative_off": SCFG,
        "prefix": dict(SCFG, prefix_cache=True), "prefix_off": SCFG,
        "prefix_monolithic": dict(SCFG, chunked=False, prefix_cache=True),
        "preempt": dict(SCFG, preemption=True, prefix_cache=True,
                        usable_pages=PREEMPT_USABLE),
        "preempt_free": dict(SCFG, preemption=True, prefix_cache=True),
        "telemetry": dict(SCFG, telemetry=True),
        "deadline": DEADLINE_SCFG, "deadline_free": DEADLINE_SCFG}
# the traffic of each run (see traffic())
TRAFFIC = {"speculative": "ngrams", "speculative_off": "ngrams",
           "prefix": "prefix", "prefix_off": "prefix",
           "prefix_monolithic": "prefix", "preempt": "burst",
           "preempt_free": "burst", "deadline": "deadline"}
# the runs of the speculative, prefix and preemption slice, each beside
# the run it is checked against (the same traffic without the feature)
M6_RUNS = {"speculative": "speculative_off", "prefix": "prefix_off",
           "prefix_monolithic": "prefix_off", "preempt": "preempt_free"}
# per run: kernel -> the launch kinds whose count x n_layers it must equal
# (empty: the run must not launch it)
_CHUNKED = {"K1": ("chunk_batch",), "K2": ("decode",)}
EXPECTED = {
    "chunked": _CHUNKED,
    "dense": {"K3": ("decode",), "K4": ("prefill",)},
    "paged_monolithic": {"K2": ("decode",), "K4": ("prefill_paged",)},
    "speculative": {"K1": ("chunk_batch", "spec_verify"),
                    "K2": ("decode",)},
    "speculative_off": _CHUNKED, "prefix": _CHUNKED, "prefix_off": _CHUNKED,
    "prefix_monolithic": {"K1": ("chunk",), "K2": ("decode",)},
    "preempt": _CHUNKED, "preempt_free": _CHUNKED, "telemetry": _CHUNKED,
    "deadline": _CHUNKED, "deadline_free": _CHUNKED}
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
# two requests reuse freed slots); the prompts are half the 678 tokens of
# PRs 14-27, to keep the script near 900 s beside M14's serving cells
# (the stepwise admission is one decode step a prompt token, four runs);
# since PR 29, beside the MoE family's runs, a third of each model's
# layers (REC_LAYERS: zamba2's 18 of 54 keep 3 applications of its shared
# block, one every 6 layers; rwkv6's 8 of 24)
REC_ARCHS = ("zamba2-2.7b", "rwkv6-1.6b")
REC_LAYERS = {"zamba2-2.7b": 18, "rwkv6-1.6b": 8}
REC_BATCH = (2, 2048)
REC_PROMPTS = (12, 28, 48, 65, 85, 100)
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
    log(f"# built {sorted(logs)} in {secs:.1f} s (nvcc, sm_90a, in parallel; "
        f"each done at " + ", ".join(
            f"{k} {v:.1f} s" for k, v in sorted(build.nvcc_seconds.items(),
                                                key=lambda kv: kv[1])) + ")")
    for name, text in logs.items():
        report = build.ptxas_report(text)
        regs = [r["registers"] for r in report.values()]
        log(f"#   {name}: {len(regs)} instantiations, "
            f"{min(regs, default=0)}-{max(regs, default=0)} registers, up "
            f"to {max((r['smem'] for r in report.values()), default=0)} "
            f"bytes static smem, "
            f"{sum(r['spill_bytes'] for r in report.values())} bytes of "
            f"spills")
        # the head-dim-256 instantiations (gemma3-4b) and every tile of
        # K4's bf16 kernel (core/hopper_mapping.py K4_TILES) one by one:
        # none may spill
        for fn, r in report.items():
            if "flash_attention_bf16_kernel" in fn:
                log(f"#     K4 bf16 tile {fn[fn.index('kernelI') + 7:][:30]}: "
                    f"{r['registers']} registers, {r['spill_bytes']} bytes "
                    f"of spills")
                if r["spill_bytes"]:
                    raise AssertionError(f"{fn} spills")
            if "Li256E" in fn:
                log(f"#     head dim 256: {fn[:90]}: {r['registers']} "
                    f"registers, {r['spill_bytes']} bytes of spills, "
                    f"{r['smem']} bytes static smem")
                if r["spill_bytes"]:
                    raise AssertionError(f"{fn} spills")


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

def compare(got: torch.Tensor, want: torch.Tensor, dtype,
            terms: torch.Tensor = None, f32_rel: bool = False,
            cancel: torch.Tensor = None) -> float:
    """Max |kernel - plain|; raises past the bar of the dtype.  `terms`
    (bf16 K4 and K5): the magnitude of the summed terms - K4 rounds its
    softmax weights, K5 its p and ds, to bf16 before their products, as
    their plain versions do, and a one-ulp score difference can flip one
    such rounding, so their bar is one bf16 step of the terms.  `cancel`
    (bf16 K1): sum_j p_j |v_j|, the magnitude of the terms its fp32 sum
    adds - where they cancel to an output near 0, the two fp32 sums part
    by more than the 1e-6 floor, so the float32 bar of that magnitude is
    added.  f32_rel (K5): the float32 bar is 1e-5 of the largest
    |gradient|."""
    g, w = got.float(), want.float()
    err = float((g - w).abs().max())
    if dtype == torch.bfloat16:
        scale = w.abs() if terms is None else w.abs() + terms.float()
        bar = BF16_RTOL * scale + 1e-6
        if cancel is not None:
            bar = bar + F32_TOL * cancel.float()
    else:
        bar = torch.full_like(w, F32_TOL * (float(w.abs().max())
                                            if f32_rel else 1.0))
    past = int(((g - w).abs() > bar).sum())
    if past:
        raise AssertionError(f"kernel disagrees with its plain version: max "
                             f"abs err {err:.3e} ({dtype}), {past} of "
                             f"{w.numel()} elements past the bar")
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


def k1_call(a, impl=None, tp_mesh=None):
    return ops.batched_paged_prefill_attention(
        a["q"], a["k_pages"], a["v_pages"], a["page_tables"],
        a["q_offsets"], a["true_lens"], a.get("q_lens"),
        window=a.get("window", 0),
        logit_softcap=a.get("logit_softcap", 0.0), impl=impl,
        tp_mesh=tp_mesh)


def k2_call(a, impl=None, tp_mesh=None):
    return ops.paged_flash_decode(a["q"], a["k_pages"], a["v_pages"],
                                  a["block_table"], a["cache_len"],
                                  window=a.get("window", 0),
                                  logit_softcap=a.get("logit_softcap", 0.0),
                                  impl=impl, tp_mesh=tp_mesh)


def k3_call(a, impl=None):
    return ops.flash_decode(a["q"], a["k_cache"], a["v_cache"],
                            a["cache_len"], window=a.get("window", 0),
                            logit_softcap=a.get("logit_softcap", 0.0),
                            impl=impl)


def k1_compare(o, a, dtype) -> float:
    """K1's output against its plain version; bf16 also with the bar of
    the terms its fp32 sum cancels (the plain version on |v|)."""
    cancel = k1_call(dict(a, v_pages=a["v_pages"].abs()), "ref") \
        if dtype == torch.bfloat16 else None
    return compare(o, k1_call(a, "ref"), dtype, cancel=cancel)


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


def k5_cancel(a, block: int = 512):
    """The magnitude of the float32 sums behind each ds = p (dp - delta)
    of K5's plain version, carried into dq and dk as ds is: scale x sum
    over the masked pairs of p (|do| . |v| + |do| . |o|) x |k| (dq) or
    |q| (dk); dv takes no ds (None).  Where dp and delta cancel - a query
    that attends one key has o = v, so ds = 0 exactly - the plain
    version's ds is fp32 rounding of that magnitude, which the kernel,
    taking delta from the same products as dp, does not have."""
    q, k, v, o, do, lse = (a[n] for n in ("q", "k", "v", "o", "do", "lse"))
    kw = _k5_kw(a)
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G, sc = Hq // Hkv, 1.0 / math.sqrt(D)
    qb = q.reshape(B, Sq, Hkv, G, D).float()
    dob = do.reshape(B, Sq, Hkv, G, D).float().abs()
    dmag = (dob * o.reshape(B, Sq, Hkv, G, D).float().abs()).sum(-1)
    lsef = lse.reshape(B, Sq, Hkv, G)
    q_pos = torch.arange(Sq, device=q.device)
    dq, dk = torch.zeros_like(qb), []
    for j0 in range(0, Skv, block):
        kb, vb = k[:, j0:j0 + block].float(), v[:, j0:j0 + block].float()
        k_pos = j0 + torch.arange(kb.shape[1], device=q.device)
        s = torch.einsum("bqhgd,bkhd->bqhgk", qb, kb) * sc
        if kw["logit_softcap"] > 0.0:
            s = kw["logit_softcap"] * torch.tanh(s / kw["logit_softcap"])
        keep = torch.ones((Sq, kb.shape[1]), dtype=torch.bool,
                          device=q.device)
        if kw["causal"] or kw["window"] > 0:
            keep &= k_pos[None, :] <= q_pos[:, None]
        if kw["window"] > 0:
            keep &= k_pos[None, :] > q_pos[:, None] - kw["window"]
        p = torch.where(keep[None, :, None, None, :],
                        torch.exp2((s - lsef[..., None]) * ref.LOG2E), 0.0)
        c = p * (torch.einsum("bqhgd,bkhd->bqhgk", dob, vb.abs())
                 + dmag[..., None])
        dq += torch.einsum("bqhgk,bkhd->bqhgd", c, kb.abs()) * sc
        dk.append(torch.einsum("bqhgk,bqhgd->bkhd", c, qb.abs()) * sc)
    return dq.reshape(B, Sq, Hq, D), torch.cat(dk, 1), None


def k5_compare(a, dtype) -> float:
    """dq, dk, dv against the plain version: bf16 one step of the terms'
    magnitude plus, for dq and dk, the float32 bar of the sums behind
    their ds (k5_cancel, as K1's bar adds that of its PV sum); fp32 1e-5
    of the largest |gradient|.  Returns the max abs error over the
    three."""
    got, want = k5_call(a), k5_call(a, "ref")
    terms, cancel = (k5_call(a, "ref", terms=True), k5_cancel(a)) \
        if dtype == torch.bfloat16 else ((None,) * 3, (None,) * 3)
    return max(compare(g, w, dtype, t, f32_rel=True, cancel=c)
               for g, w, t, c in zip(got, want, terms, cancel))


def k5_training_args(dtype, seed=0, shape=(4, 2048, 32, 8, 64), window=0):
    """K5 at a training shape (B, S, Hq, Hkv, D), by default granite-3-2b's:
    q (4, 2048, 32, 64), k / v (4, 2048, 8, 64); causal, under `window`
    if > 0; o and lse from K4, a random do."""
    B, S, Hq, Hkv, D = shape
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=g, device=dev,
                                     dtype=torch.float32).to(dtype)
    a = dict(q=rnd(B, S, Hq, D), k=rnd(B, S, Hkv, D), v=rnd(B, S, Hkv, D),
             do=rnd(B, S, Hq, D), causal=True, window=window)
    a["o"], a["lse"] = flash_attention.flash_attention_fwd(
        a["q"], a["k"], a["v"], window=window)
    return a


def k5_gemma_shape():
    """gemma3-4b's training backward at the training phase's batch, (B, S,
    8, 4, 256), and its sliding window."""
    cfg = get_config("gemma3-4b")
    return (TRAIN["global_batch"], TRAIN["seq_len"], cfg.n_heads,
            cfg.n_kv_heads, cfg.head_dim), cfg.sliding_window


def k5_llava_shape():
    """llava-next-34b's training backward at its training run's batch,
    (2, 2048, 56, 8, 128): 7 query heads a KV head."""
    cfg = get_config("llava-next-34b")
    return (VLM_TRAIN["global_batch"], VLM_TRAIN["seq_len"], cfg.n_heads,
            cfg.n_kv_heads, cfg.head_dim)


# the edge-case tests run in this many pytest processes on the card at
# once, each a round-robin share of the collected tests and one torch
# thread: one process took 185 s of a 981.5 s script, four 91.2 s (my
# chip calls 3-4, PR 29), most of it on the host, which has 8 cores
EDGE_PROCS = 8


def edge_cases() -> str:
    """tests/test_torch_kernels_cuda.py's CUDA tests, every one collected,
    in EDGE_PROCS pytest processes at once (the kernels are built
    already, so each only loads them); raises unless each process passes
    its share with nothing skipped.  Returns the summary."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
           "--noconftest", "-m", "cuda"]
    path = str(ROOT / "tests" / "test_torch_kernels_cuda.py")
    col = subprocess.run(cmd + ["--collect-only", path], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    ids = [line for line in col.stdout.splitlines() if "::" in line]
    if col.returncode != 0 or not ids:
        raise AssertionError(f"edge-case collection failed:\n"
                             f"{col.stdout[-4000:]}\n{col.stderr[-2000:]}")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd + ids[i::EDGE_PROCS], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for i in range(EDGE_PROCS)]
    passed, lines = 0, []
    try:
        for i, p in enumerate(procs):
            out, err = p.communicate(timeout=900)
            last = out.strip().splitlines()[-1] if out.strip() else ""
            lines.append(last)
            n = len(ids[i::EDGE_PROCS])
            if p.returncode != 0 or f"{n} passed" not in last \
                    or "skipped" in last:
                raise AssertionError(f"edge-case parity failed:\n"
                                     f"{out[-4000:]}\n{err[-2000:]}")
            passed += n
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return (f"{passed} of {len(ids)} passed in {EDGE_PROCS} processes at "
            f"once, {time.perf_counter() - t0:.1f} s ({'; '.join(lines)})")


def phase_kernel_parity():
    log(f"# edge cases (tests/test_torch_kernels_cuda.py): {edge_cases()}")
    for dtype in (torch.float32, torch.bfloat16):
        a1, a2, a3, a4s = serving_shape_args(dtype)
        o1 = k1_call(a1)
        if o1[3].any() or o1[1, 44:].any():
            raise AssertionError("K1: dead row or pad lanes not exactly 0")
        e1 = k1_compare(o1, a1, dtype)
        o2 = k2_call(a2)
        if o2[5].any():
            raise AssertionError("K2: idle lane not exactly 0")
        e2 = compare(o2, k2_call(a2, "ref"), dtype)
        o3 = k3_call(a3)
        if o3[0].any():
            raise AssertionError("K3: lane of length 0 not exactly 0")
        e3 = compare(o3, k3_call(a3, "ref"), dtype)
        e4 = [k4_compare(a, dtype) for a in a4s]
        bar = "1e-5 abs" if dtype == torch.float32 else \
            "2^-7 rel + 1e-6, K1 + 1e-5 of sum p|v|"
        log(f"# serving shapes {str(dtype)[6:]}: K1 max abs err {e1:.3e}, "
            f"K2 {e2:.3e}, K3 {e3:.3e}, K4 (1, 1904) {e4[0]:.3e} and "
            f"(2, 256) {e4[1]:.3e} (bar {bar}; K4 bf16 of the terms)")
        e5 = k5_compare(k5_training_args(dtype), dtype)
        bar = "1e-5 of max |grad|" if dtype == torch.float32 \
            else "2^-7 of the terms, dq / dk + 1e-5 of k5_cancel"
        log(f"# training shape {str(dtype)[6:]}: K5 (4, 2048, 32/8, 64) "
            f"causal max abs err {e5:.3e} (bar {bar})")
        shape, window = k5_gemma_shape()
        for w in (0, window):
            e5 = k5_compare(k5_training_args(dtype, shape=shape, window=w),
                            dtype)
            log(f"# gemma3-4b training shape {str(dtype)[6:]}: K5 {shape} "
                f"causal, window {w}: max abs err {e5:.3e} (bar {bar})")
        shape = k5_llava_shape()
        e5 = k5_compare(k5_training_args(dtype, shape=shape), dtype)
        log(f"# llava-next-34b training shape {str(dtype)[6:]}: K5 {shape} "
            f"causal: max abs err {e5:.3e} (bar {bar})")
        a5 = k5_training_args(dtype, seed=3, shape=M14_SHARD)
        e4 = k4_compare({k: a5[k] for k in ("q", "k", "v", "causal",
                                             "window")}, dtype)
        e5 = k5_compare(a5, dtype)
        log(f"# M14 shard shape {str(dtype)[6:]}: K4 {M14_SHARD} causal max "
            f"abs err {e4:.3e}, K5 {e5:.3e} (bars as above)")
    torch.cuda.synchronize()


@dataclasses.dataclass(frozen=True)
class K4Shape:
    """One K4 call of phase_k4_tiles: (B, S, Hq, Hkv, D) under its mask.
    sweep: every tile of K4_TILES[D] is held and timed, else the chooser's
    only; library: one scaled_dot_product_attention call is timed beside
    it; runs: time_ms's (n, warm)."""
    B: int
    S: int
    Hq: int
    Hkv: int
    D: int
    causal: bool = True
    window: int = 0
    sweep: bool = True
    library: bool = False
    runs: tuple = (25, 3)


# K4's shapes in PERF.md §6's tables: the training steps of granite-3-2b
# (32 / 8 heads of 64) and olmo-1b (16 of 128), granite-8b's forward,
# gemma3-4b's prompt and training step (head dim 256, a 1024 window), the
# whisper encoder (full mask), llava's image prefill (56 / 8 heads of 128)
# and the M14 rank's head shard
K4_SHAPES = {"granite-3-2b training": K4Shape(4, 2048, 32, 8, 64),
             "olmo-1b training": K4Shape(4, 2048, 16, 16, 128),
             "granite-8b": K4Shape(1, 2048, 32, 8, 128),
             "gemma3-4b": K4Shape(1, 1904, 8, 4, 256, window=1024),
             "gemma3-4b training": K4Shape(4, 2048, 8, 4, 256, window=1024),
             "whisper encoder": K4Shape(16, 1500, 8, 8, 64, causal=False),
             "llava image prefill": K4Shape(4, 832, 56, 8, 128),
             "M14 shard": K4Shape(2, 2048, 16, 4, 64)}
K4_FULL_ROWS = 4096             # every query row compared up to here
K4_ROWS = 512                   # past it, this many seeded random rows


def phase_k4_tiles(shapes: dict, seed: int = 7) -> dict:
    """K4 in bf16 at each of `shapes` ({name: K4Shape}) at every tile its
    source instantiates (core/hopper_mapping.py K4_TILES) or at the
    chooser's only: held against the plain version and timed (time_ms)
    beside its bound (launch/cost.py k4_work over the card's peaks) and,
    where asked, one scaled_dot_product_attention call (_sdpa, on a fused
    backend).  Inputs from a generator seeded `seed` at each shape.  One
    line a shape; returns {name: row}.

    o is held to two bars.  compare's bf16 bar of the terms, 2^-7 (|o| +
    sum_j p_j |v_j|), stays near 6e-3 however long the row, while o
    averages away without a mask (rms ~ sqrt(e / S) for unit normal
    inputs): at 65536 positions that bar is as large as o itself.  So o
    is also held to 2^-6 of the reference's largest |o|, two bf16 steps
    of it: the kernel and its plain version part by one rounding step of
    the output, and a P.V fault that moves o by a tenth of its rms passes
    neither.  lse is held to 1e-5."""
    from repro_torch.core.hopper_mapping import K4_TILES
    from torch.nn.attention import SDPBackend, sdpa_kernel
    flush = torch.empty(64 * 1024 * 1024 // 4, dtype=torch.float32,
                        device="cuda")
    out = {}
    for name, s in shapes.items():
        B, S, Hq, Hkv, D = s.B, s.S, s.Hq, s.Hkv, s.D
        g = torch.Generator(device="cuda").manual_seed(seed)
        rnd = lambda *shape: torch.randn(shape, generator=g, device="cuda"
                                         ).to(torch.bfloat16)
        q, k, v = rnd(B, S, Hq, D), rnd(B, S, Hkv, D), rnd(B, S, Hkv, D)
        kw = dict(causal=s.causal, window=s.window)
        pick = flash_attention.tile(D, S, torch.bfloat16)
        tiles = K4_TILES[D] if s.sweep else (pick,)
        for bq, _ in tiles:
            # K4's grid z: one block a block_q flattened rows (S x G)
            if -(-S * (Hq // Hkv) // bq) > 65535:
                raise AssertionError(f"K4 at {name}: the grid at block_q "
                                     f"{bq} passes 65535")
        if S > K4_FULL_ROWS:
            # the plain version cannot hold every row's scores here; rows
            # without a mask are independent, so it runs on K4_ROWS seeded
            # random query rows over every key - the same function on those
            # rows - and is held to the kernel's output on the same rows
            # (random, so they fall in every warp of K4's row tiles)
            if s.causal or s.window:
                raise AssertionError(f"K4 at {name}: rows under a mask "
                                     f"cannot be compared apart")
            idx = torch.randperm(S, generator=torch.Generator().manual_seed(
                seed))[:K4_ROWS].sort().values.cuda()
        else:
            idx = slice(None)
        qs = q[:, idx]
        o_r, lse_r = flash_attention.reference(qs, k, v, **kw)
        terms = flash_attention.reference(qs, k, v.abs(), **kw)[0]
        n_rows = qs.shape[1]
        del qs
        o_bar = 2.0 ** -6 * float(o_r.float().abs().max())
        rms_o = float(o_r.float().square().mean().sqrt())
        nbytes, flops = cost.k4_work(q.shape, k.shape, 2, s.causal,
                                     s.window)
        n, warm = s.runs
        t = {}
        for bq, bkv in tiles:
            call = lambda bq=bq, bkv=bkv: flash_attention.flash_attention_fwd(
                q, k, v, block_q=bq, block_kv=bkv, **kw)
            o, lse = call()
            err = compare(o[:, idx], o_r, torch.bfloat16, terms)
            if err > o_bar:
                raise AssertionError(f"K4 at {name}, tile {bq}x{bkv}: max "
                                     f"abs err {err:.3e} past 2^-6 max|o| "
                                     f"{o_bar:.3e}")
            lse_err = compare(lse[:, idx], lse_r, torch.float32)
            del o, lse
            t[f"{bq}x{bkv}"] = {"ms": time_ms(call, flush, n=n, warm=warm),
                                "max_abs_err": err, "lse_max_abs_err": lse_err}
        del o_r, lse_r, terms
        lib_ms = None
        if s.library:
            # a fused backend only: at 65536 positions the math backend's
            # scores would not fit the card
            with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                              SDPBackend.CUDNN_ATTENTION,
                              SDPBackend.EFFICIENT_ATTENTION]):
                lib_ms = time_ms(_sdpa(q, k, v, is_causal=s.causal), flush,
                                 n=n, warm=warm)
        del q, k, v
        torch.cuda.empty_cache()
        chosen = f"{pick[0]}x{pick[1]}"
        fast = min(t, key=lambda x: t[x]["ms"])
        ms = t[chosen]["ms"]
        row = {"shape": [B, S, Hq, Hkv, D], "causal": s.causal,
               "window": s.window, "chooser": list(pick), "ms": ms,
               "tflop_s": flops / ms * 1e-9,
               "bound_ms": max(nbytes / PEAK_BYTES_S, flops / PEAK_FLOP_S)
               * 1e3,
               "bound_by": "bytes" if nbytes / PEAK_BYTES_S
               > flops / PEAK_FLOP_S else "operations",
               "library_ms": lib_ms, "max_abs_err": t[chosen]["max_abs_err"],
               "o_bar": o_bar, "rms_o": rms_o,
               "lse_max_abs_err": t[chosen]["lse_max_abs_err"],
               "rows_compared": n_rows, "runs": n, "bytes": nbytes,
               "flops": flops, "tiles": t, "fastest": fast,
               "chooser_over_fastest": ms / t[fast]["ms"]}
        log(f"# K4 at {name} {tuple(row['shape'])}"
            + ("" if s.causal else " full")
            + (f" window {s.window}" if s.window else "")
            + f": chooser {chosen} {ms:.4f} ms ({row['tflop_s']:.1f} "
            f"TFLOP/s, median of {n}), bound {row['bound_ms']:.4f} ms by "
            f"{row['bound_by']}"
            + ("" if lib_ms is None else f", sdpa {lib_ms:.4f} ms")
            + f"; max abs err {row['max_abs_err']:.1e} (2^-6 max|o| "
            f"{o_bar:.1e}, rms|o| {rms_o:.1e}; lse "
            f"{row['lse_max_abs_err']:.1e}) over {n_rows} rows"
            + ("" if len(t) == 1 else
               "; tiles " + ", ".join(f"{x} {y['ms']:.4f} ms err "
                                      f"{y['max_abs_err']:.1e}"
                                      for x, y in t.items())
               + f" - fastest {fast}, chooser / fastest "
               f"{row['chooser_over_fastest']:.3f}"))
        out[name] = row
    del flush
    torch.cuda.synchronize()
    return out


# the paper's attention workloads (repro_torch/core/workloads.py
# PAPER_MODELS / PAPER_SEQS) from the registered configs: one K4 call of
# one layer at batch 1, bf16, non-causal as the paper evaluates them
PAPER_ARCHS = ("opt-6.7b", "qwen-7b")
PAPER_TILE_SEQ = 16384          # every instantiated tile timed here
# timed runs (after warm-ups): one K4 call at 65536 positions is ~7e13
# FLOPs, so the long shapes take fewer
PAPER_RUNS = {1024: (25, 3), 4096: (25, 3), 16384: (5, 1), 65536: (3, 1)}
PAPER_SEED = 11


def phase_paper():
    """K4 at the paper's attention workloads: for each of PAPER_ARCHS and
    PAPER_SEQS, the port's simulator's workload from the registered
    config (from_model_config(get_config(arch), S), which must equal the
    paper's own, opt_6_7b(S).attn / qwen_7b(S).attn), whose K4 call's
    FLOPs (launch/cost.py k4_work) must equal the simulator's 2 (qk_macs
    + pv_macs) / n_layers; then phase_k4_tiles at those shapes, non-causal,
    at the chooser's tile (every tile at PAPER_TILE_SEQ) beside one
    scaled_dot_product_attention call, and the simulator's 3D-Flow time on
    lines of its own.  Returns one row a shape."""
    from repro_torch.core import (PAPER_MODELS, PAPER_SEQS,
                                  from_model_config, simulate_attention)
    shapes, wls = {}, {}
    for arch in PAPER_ARCHS:
        cfg = get_config(arch)
        for S in PAPER_SEQS:
            wl = from_model_config(cfg, S)
            if wl != PAPER_MODELS[arch](S).attn:
                raise AssertionError(f"{arch}'s config gives {wl}, not the "
                                     f"paper's {PAPER_MODELS[arch](S).attn}")
            B, Hq, Hkv, D = wl.batch, wl.n_heads, wl.n_kv_heads, wl.head_dim
            flops = cost.k4_work((B, S, Hq, D), (B, S, Hkv, D), 2, False,
                                 0)[1]
            if flops != 2 * (wl.qk_macs + wl.pv_macs) / wl.n_layers:
                raise AssertionError(f"{arch} at {S}: k4_work counts {flops} "
                                     f"FLOPs, the simulator "
                                     f"{2 * (wl.qk_macs + wl.pv_macs)} over "
                                     f"{wl.n_layers} layers")
            name = f"paper {arch} {S}"
            shapes[name] = K4Shape(B, S, Hq, Hkv, D, causal=False,
                                   sweep=S == PAPER_TILE_SEQ, library=True,
                                   runs=PAPER_RUNS[S])
            wls[name] = (arch, wl)
    rows = phase_k4_tiles(shapes, seed=PAPER_SEED)
    out = []
    for name, (arch, wl) in wls.items():
        sim = simulate_attention("3D-Flow", wl)
        log(f"# paper 3D-Flow model, 16 nm, 1 GHz (not this card): "
            f"{arch} at {wl.seq}, all {wl.n_layers} layers, {sim.time_s!r} s")
        out.append(dict(rows[name], arch=arch, seq=wl.seq))
    return out


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

class Capture:
    """Wraps a kernel module's wrapper and keeps the arguments of its
    largest call (by `weight` of the call's arguments, keywords included;
    the first of equal calls), cloned, for the timing phase.  Used in the
    warm-up runs only; the wrapped call is the original."""

    def __init__(self, module, attr, weight):
        self.module, self.attr, self.weight = module, attr, weight
        self.orig = getattr(module, attr)
        self.best, self.best_w = None, -1

    def __enter__(self):
        def wrapped(*args, **kw):
            w = self.weight(*args, **kw)
            if w > self.best_w:
                self.best_w = w
                self.best = ([a.clone() if torch.is_tensor(a) else a
                              for a in args], dict(kw))
            return self.orig(*args, **kw)
        setattr(self.module, self.attr, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.orig)


def _k1_weight(q, kp, vp, tables, offs, tls, qls=None, **_):
    return int((tls - offs).clamp(min=0).sum()) * 1_000_000 + int(tls.sum())


def _lens_weight(q, kc, vc, *rest, **_):
    lens = rest[-1]
    return int(lens.sum()) if torch.is_tensor(lens) else lens * q.shape[0]


def _k4_weight(q, k, v, **_):
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


def traffic(kind: str, vocab: int, lens=PROMPT_LENS):
    """A run's requests as waves of (tick, prompt, priority[, deadline]); a
    wave is submitted tick by tick from the moment the wave before it has
    drained.  "random": one seeded prompt per `lens`, all at tick 0;
    "deadline": the same prompts with DEADLINES; "ngrams": per SPEC_LENS
    a prompt repeating its own seeded n-gram of 3 to 10 tokens; "prefix":
    PREFIX_LEN shared tokens plus a seeded suffix of each PREFIX_SUFFIXES
    length, in two waves; "burst": PREEMPT_BACKGROUND at priority 0, tick
    0, then PREEMPT_BURST at priority 5, tick 2."""
    rng = np.random.default_rng(0)
    rand = lambda n: rng.integers(1, vocab, n).tolist()
    if kind == "random":
        return [[(0, rand(n), 0) for n in lens]]
    if kind == "deadline":
        return [[(0, rand(n), 0, d) for n, d in zip(lens, DEADLINES)]]
    if kind == "ngrams":
        return [[(0, (rand(3 + i) * n)[:n], 0)
                 for i, n in enumerate(SPEC_LENS)]]
    if kind == "prefix":
        shared = rand(PREFIX_LEN)
        return [[(0, shared + rand(n), 0) for n in wave]
                for wave in PREFIX_SUFFIXES]
    return [[(0, rand(n), 0) for n in PREEMPT_BACKGROUND]
            + [(2, rand(n), 5) for n in PREEMPT_BURST]]


def run_traffic(model, params, run: str, count_syncs: bool,
                scfg=None, waves=None):
    """Serve the run's traffic (traffic(TRAFFIC[run]), or `waves`) under
    ServeConfig(**RUNS[run]) (or `scfg`) to completion.  Returns (engine,
    per-tick wall seconds, implicit sync warnings, wall seconds, the
    preempted and the expired requests as (tick, uid, state, prefill
    cursor, tokens out) at their preemption or expiry, each tagged with
    its kind in the last field)."""
    eng = ServeEngine(model, params, ServeConfig(**(scfg or RUNS[run])))
    pending = waves or traffic(TRAFFIC.get(run, "random"),
                               model.cfg.vocab_size)
    pending = [list(w) for w in pending]
    fetches = ("_fetch_tokens", "_fetch_first_token")
    if count_syncs:
        for name in fetches:
            setattr(eng, name, _quiet(getattr(eng, name)))
    victims = []
    for name in ("_preempt", "_expire"):
        eng.__dict__[name] = _noted(eng, getattr(eng, name), victims,
                                    name[1:])
    tick_s, syncs, wave_t0 = [], 0, 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while pending or eng.queue or any(s is not None for s in eng.slots):
        idle = not eng.queue and all(s is None for s in eng.slots)
        if pending and idle and not pending[0]:
            pending.pop(0)
            wave_t0 = len(tick_s)
            continue
        while pending and pending[0] and pending[0][0][0] \
                <= len(tick_s) - wave_t0:
            _, prompt, prio, *deadline = pending[0].pop(0)
            eng.submit(prompt, priority=prio,
                       deadline=deadline[0] if deadline else None)
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
    for name in fetches + ("_preempt", "_expire"):
        eng.__dict__.pop(name, None)
    return eng, tick_s, syncs, wall, victims


def _noted(eng, fn, log_, kind):
    """fn (a request's preemption or expiry), which first logs (tick, uid,
    state, prefill cursor, tokens out, kind) to log_."""
    def noted(req):
        log_.append((eng.sched.ticks, req.uid, req.state.value,
                     req.prefill_pos, len(req.out_tokens), kind))
        fn(req)
    return noted


def counted_run(model, params, run: str, keep=None):
    """Every launch count set to 0, the run's traffic with sync counting,
    the counts read; raises unless each kernel launched 40 x its kinds'
    engine launches (and the others not at all), every request finished
    (the deadline run's may time out) and those done got their tokens,
    every tick kept its launch and fetch shape, and no implicit sync
    happened.  `keep(engine)` adds host values of the engine to the
    result (the engine itself, and its cache, are let go)."""
    cfg, scfg = model.cfg, RUNS[run]
    n_requests = sum(map(len, traffic(TRAFFIC.get(run, "random"), 1 << 15)))
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    eng, tick_s, syncs, wall, victims = run_traffic(model, params, run,
                                                    count_syncs=True)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    done = eng.sched.finished
    ends = {"done", "timeout"} if run == "deadline" else {"done"}
    if len(done) != n_requests or any(
            len(r.out_tokens) != NEW_TOKENS for r in done
            if r.state.value == "done") \
            or not {r.state.value for r in done} <= ends:
        got = [(r.state.value, len(r.out_tokens)) for r in done]
        raise AssertionError(f"{run}: not every request finished with "
                             f"{NEW_TOKENS} tokens: {got}")
    for calls, host, _, n_chunks, n_dec in eng.launch_log:
        # chunked: at most a chunk batch, a verify and a decode launch and
        # at most one fetch, one in every tick with a decoding slot;
        # monolithic: one fetch per launch (the first token of an
        # admission, the tokens of a decode)
        ok = (calls <= 2 + scfg.get("speculative", False) and host <= 1
              and (host == 1 or not n_dec)) \
            if scfg["chunked"] else host == calls
        if not ok:
            raise AssertionError(f"{run}: tick made {calls} launches and "
                                 f"{host} fetches")
    kinds = [r.kind for r in eng.launch_records()]
    by_tick = {}
    for r in eng.launch_records():
        by_tick[(r.tick, r.kind)] = by_tick.get((r.tick, r.kind), 0) + 1
    if any(n > 1 for (_, kind), n in by_tick.items() if kind in
           ("chunk_batch", "spec_verify", "decode")):
        raise AssertionError(f"{run}: a tick made two launches of a kind")
    L = cfg.n_layers
    want = {k: L * sum(kinds.count(kind)
                       for kind in EXPECTED[run].get(k, ()))
            for k in COUNTERS}
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
    n_done = sum(r.state.value == "done" for r in done)
    log(f"# {run}: served {n_done} of {len(done)} requests x {NEW_TOKENS} "
        f"tokens in {len(eng.launch_log)} ticks: engine launches {counts}, "
        f"kernel "
        f"launches {launches}, implicit host syncs in the ticks: {syncs}")
    stats = eng.stats()
    ticks = len(eng.launch_log)
    slice_stats = {k: stats[k] for k in (
        "decode_launches", "kv_pages_read", "work_tokens", "spec_drafted",
        "spec_accepted", "prefix_hit_tokens", "cow_copies", "cached_pages",
        "preemptions", "resumes", "pages_reclaimed", "pages_parked")}
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
    if run in M6_RUNS or run in M6_RUNS.values():
        e2e.update(slice_stats, victims=victims)
    out = {"launches": launches,
           "per_tick": {k: n / ticks for k, n in launches.items()},
           "e2e": e2e, "stats": slice_stats, "victims": victims,
           "finished": [(r.uid, list(r.prompt), list(r.out_tokens))
                        for r in sorted(done, key=lambda r: r.uid)],
           "records": [dataclasses.astuple(r)
                       for r in eng.launch_records()],
           "log": [(c, h, n, d) for c, h, _, n, d in eng.launch_log]}
    if keep is not None:
        out.update(keep(eng))
    return out


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
        run_traffic(model, params, "chunked", count_syncs=False)
    runs["chunked"] = counted_run(model, params, "chunked")
    with Capture(flash_attention, "flash_attention_fwd", _k4_weight) as c4, \
            Capture(flash_decode, "flash_decode", _lens_weight) as c3:
        run_traffic(model, params, "dense", count_syncs=False)
    runs["dense"] = counted_run(model, params, "dense")
    runs["paged_monolithic"] = counted_run(model, params, "paged_monolithic")
    model_check(model, params)
    args = {"K1": c1.best, "K2": c2.best, "K3": c3.best, "K4": c4.best}
    return runs, args, (model, params)


def check_tokens(vocab: int) -> np.ndarray:
    """model_check's two prompts (2, 256): 256 and 200 real tokens."""
    toks = np.random.default_rng(1).integers(1, vocab, (2, 256))
    toks[1, 200:] = 0
    return toks


def model_check(model, params, on_pass=None, bars=MODEL_BARS):
    """The model's entry points at full width through the kernels and
    through impl="ref" (separate caches, same inputs): a chunk batch and a
    paged decode step (K1, K2), forward over 2 x 256 tokens (K4), a dense
    prefill of two prompts (256 and 200 real tokens) and a decode step
    (K4, K3), a paged prefill of the 200-token prompt and a decode step
    (K4, K2), each within its entry of `bars`.  on_pass(impl) is called
    before each pass.  Returns {entry point: max |kernels - ref|}."""
    dev = model.device
    i32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.int32,
                                 device=dev)
    toks = check_tokens(model.cfg.vocab_size)
    table = np.zeros((2, 32), np.int32)
    table[0, :17], table[1, :17] = np.arange(1, 18), np.arange(18, 35)
    argmax = lambda lg: torch.argmax(lg[:, -1], -1,
                                     keepdim=True).to(torch.int32)
    out = {}
    for impl in (None, "ref"):
        if on_pass is not None:
            on_pass(impl)
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
    errs = {}
    for name in out[None]:
        bar = bars[name]
        a, b = out[None][name], out["ref"][name]
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{name}: non-finite logits")
        err = errs[name] = float((a - b).abs().max())
        log(f"# full-width {name}: logits max |kernels - ref| {err:.3e} "
            f"({model.cfg.dtype} bar {bar:.3g}, logit scale "
            f"{float(b.abs().max()):.2f})")
        if err > bar:
            raise AssertionError(f"{name}: kernels and ref disagree")
    return errs


# ---------------------------------------------------------------------------
# phase 3, speculative decoding, the prefix cache, preemption
# ---------------------------------------------------------------------------

# a served bf16 token against the teacher-forced kernel forward at its
# position: the served logits (K1 chunk or verify rows, K2 decode) and the
# forward's (K4) are each within their MODEL_BARS of impl="ref", so the two
# differ by at most 0.12 + 0.18 per logit, and a served argmax sits at most
# twice that below the forward's
SERVED_TOKEN_BAR = 2 * (MODEL_BARS["chunk batch"] + MODEL_BARS["forward"])


def _verify_weight(q, kp, vp, tables, offs, tls, qls=None, **_):
    """K1's verify launches only (S = spec_k + 1), by their work."""
    return _k1_weight(q, kp, vp, tables, offs, tls) \
        if q.shape[1] == SPEC["spec_k"] + 1 else -1


def outputs_agree(model, params, run, ref, got, want):
    """The run's outputs equal those of the reference run `ref` (the same
    traffic without the feature), or every token of each request that
    differs passes teacher_forced_check at SERVED_TOKEN_BAR.  Speculation
    moves no work-clock stamp, so there equal outputs must come with equal
    work clocks (the prefix cache and preemption change the prefill work
    by design).  Returns the e2e fields."""
    w_out = {uid: out for uid, _, out in want["finished"]}
    differ = [f for f in got["finished"] if f[2] != w_out[f[0]]]
    ties = teacher_forced_check(model, params, differ, SERVED_TOKEN_BAR)
    if run == "speculative" and not differ \
            and got["stats"]["work_tokens"] != want["stats"]["work_tokens"]:
        raise AssertionError(f"{run}: outputs equal {ref}'s, work clocks "
                             f"differ")
    log(f"# {run} against {ref}: {len(got['finished']) - len(differ)} of "
        f"{len(got['finished'])} requests equal; the others teacher-forced "
        f"(bar {SERVED_TOKEN_BAR:.2f}), near ties {ties}")
    return {"against": ref, "requests_equal":
            len(got["finished"]) - len(differ), "near_ties": ties}


def phase_m6(model, params):
    """The speculative, prefix-cache and preemption runs of granite-3-2b
    at full width, each counted beside its reference run (the same traffic
    without the feature, also counted): a warm-up speculative run first
    keeps K1's largest verify call for the timing phase."""
    with Capture(paged_prefill, "batched_paged_prefill_attention",
                 _verify_weight) as cv:
        run_traffic(model, params, "speculative", count_syncs=False)
    runs = {}
    for run in ("speculative_off", "speculative", "prefix_off", "prefix",
                "prefix_monolithic", "preempt_free", "preempt"):
        runs[run] = counted_run(model, params, run)
    for run, ref in M6_RUNS.items():
        runs[run]["e2e"]["outputs"] = outputs_agree(
            model, params, run, ref, runs[run], runs[ref])
    on, off = runs["speculative"], runs["speculative_off"]
    n_verify = on["e2e"]["engine_launches"].get("spec_verify", 0)
    log(f"# speculative: {n_verify} verify launches, "
        f"{on['stats']['spec_drafted']} tokens drafted, "
        f"{on['stats']['spec_accepted']} accepted; decode launches (verify "
        f"included) {on['stats']['decode_launches']} on, "
        f"{off['stats']['decode_launches']} off; KV pages read "
        f"{on['stats']['kv_pages_read']} on, "
        f"{off['stats']['kv_pages_read']} off")
    if not n_verify:
        raise AssertionError("speculative: no verify launch ran")
    on["e2e"]["decode_launches_off"] = off["stats"]["decode_launches"]
    on["e2e"]["kv_pages_read_off"] = off["stats"]["kv_pages_read"]
    for run in ("prefix", "prefix_monolithic"):
        st = runs[run]["stats"]
        log(f"# {run}: {st['prefix_hit_tokens']} prompt tokens from the "
            f"cache, {st['cow_copies']} copy-on-write copies, "
            f"{st['cached_pages']} pages cached at the end")
        if not st["prefix_hit_tokens"] > 0:
            raise AssertionError(f"{run}: no prefix hit")
    st, victims = runs["preempt"]["stats"], runs["preempt"]["victims"]
    finished = {uid for uid, _, _ in runs["preempt"]["finished"]}
    log(f"# preempt: {st['preemptions']} preemptions (tick, uid, state, "
        f"prefill cursor, tokens out: {victims}), {st['resumes']} resumes, "
        f"{st['pages_reclaimed']} pages reclaimed, {st['pages_parked']} "
        f"parked in the prefix tree")
    if st["preemptions"] < 1 or st["resumes"] != st["preemptions"] \
            or not {v[1] for v in victims} <= finished \
            or {v[2] for v in victims} != {"prefilling", "decoding"}:
        raise AssertionError("preempt: the burst did not shed prefilling "
                             "and decoding victims that all resumed and "
                             "finished")
    return runs, {"K1_verify": cv.best}


# ---------------------------------------------------------------------------
# phase 3, request deadlines, the span tracer, the fleet router
# ---------------------------------------------------------------------------

TRACE_DIR = ROOT / "chiprun_out" / "m6d_traces"


def _traced(eng):
    """The telemetry run's host-side record: its tracer's deterministic
    view, span count, the movement model's totals, and the Perfetto
    export in both clocks, each written to TRACE_DIR and parsed back."""
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    exports = {}
    for clock in ("wall", "work"):
        path = TRACE_DIR / f"telemetry_{clock}.json"
        trace = eng.export_trace(str(path), clock=clock)
        if json.loads(path.read_text()) != json.loads(json.dumps(trace)):
            raise AssertionError(f"telemetry: the {clock}-clock export "
                                 f"does not parse back to what it wrote")
        exports[clock] = {"events": len(trace["traceEvents"]),
                          "bytes": path.stat().st_size}
    tr = eng.tm.tracer
    return {"trace": tr.deterministic_trace(), "spans": len(tr.spans()),
            "events": len(tr.events()), "dropped": tr.dropped,
            "movement": eng.movement_stats()["total"], "exports": exports}


def _deadline_kept(eng):
    return {"statuses": eng.request_statuses(),
            "pages_in_use": eng.allocator.used_pages,
            "table_clear": not eng.allocator.table.any()}


def run_fleet(model, params, n: int, fail: bool):
    """The prefix traffic through a FleetRouter of n replicas (FLEET_SCFG,
    affinity), check_invariants() after every tick, implicit host syncs
    counted inside the router's ticks (each replica's token fetches
    excepted).  With `fail`, replica 1 fails at the first tick at which it
    holds a queued request and one in flight.  Returns (router, per-tick
    wall seconds, implicit syncs, wall seconds, (tick, the states replica
    1 held, the fleet uids it owed) of the failure or None)."""
    router = FleetRouter(model, params, ServeConfig(**FLEET_SCFG),
                         FleetConfig(n_replicas=n))
    fetches = ("_fetch_tokens", "_fetch_first_token")
    for eng in router.engines:
        for name in fetches:
            setattr(eng, name, _quiet(getattr(eng, name)))
    pending = [list(w) for w in traffic("prefix", model.cfg.vocab_size)]
    tick_s, syncs, wave_t0, failed = [], 0, 0, None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while pending or not router.idle:
        if pending and router.idle and not pending[0]:
            pending.pop(0)
            wave_t0 = len(tick_s)
            continue
        while pending and pending[0] and pending[0][0][0] \
                <= len(tick_s) - wave_t0:
            _, prompt, prio = pending[0].pop(0)
            router.submit(prompt, priority=prio)
        if fail and failed is None:
            e1 = router.engines[1]
            held = {r.state.value for r in e1.queue} \
                | {r.state.value for r in e1.slots if r is not None}
            if "queued" in held and held & {"prefilling", "decoding"}:
                failed = (len(tick_s), sorted(held), router.fail(1))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            ts = time.perf_counter()
            try:
                router.tick()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            tick_s.append(time.perf_counter() - ts)
        syncs += sum("synchroniz" in str(w.message) for w in caught)
        router.check_invariants()
        if len(tick_s) > 1000:
            raise AssertionError("fleet traffic did not drain in 1000 ticks")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for eng in router.engines:
        for name in fetches:
            eng.__dict__.pop(name, None)
    return router, tick_s, syncs, wall, failed


def _fleet_finished(router):
    return [(f, list(r.prompt), list(r.out_tokens))
            for f, r in sorted(router.requests.items())]


def phase_m6d_m7(model, params, chunked):
    """The span tracer, request deadlines and the fleet router on
    granite-3-2b at full width.  telemetry: the chunked traffic with the
    tracer on, counted, against the chunked run (`chunked`: the same
    tokens, launch records and launch_log rows), twice (the same
    deterministic trace).  deadline: the chunked prompts on 4 slots with
    DEADLINES, counted, expiring requests while queued, prefilling and
    decoding, every page back after the drain, the done requests against
    the same traffic without deadlines.  fleet: the prefix traffic
    through FLEET_REPLICAS replicas, replica 1 failed mid-trace, every
    request done, counted, against a 1-replica fleet."""
    runs = {}
    on = runs["telemetry"] = counted_run(model, params, "telemetry",
                                         keep=_traced)
    again = run_traffic(model, params, "telemetry", count_syncs=False)[0]
    if again.tm.tracer.deterministic_trace() != on["trace"]:
        raise AssertionError("telemetry: two runs of the same traffic "
                             "traced different records")
    del again
    for key in ("finished", "records", "log"):
        if on[key] != chunked[key]:
            raise AssertionError(f"telemetry: {key} differ from the "
                                 f"chunked run without the tracer")
    mv = on["movement"]
    log(f"# telemetry: tokens, {len(on['records'])} launch records and "
        f"{len(on['log'])} launch_log rows equal to the chunked run's; "
        f"{on['spans']} spans, {on['events']} events, {on['dropped']} "
        f"dropped, the same deterministic trace twice; exports "
        f"{on['exports']}; tick wall p50 {on['e2e']['tick_ms_median']:.2f} "
        f"ms on, {chunked['e2e']['tick_ms_median']:.2f} ms off (the chunked "
        f"run); the movement model (first-order bytes, the paper's 16 nm "
        f"energy table - not a measurement of this card): "
        f"{mv['hbm_bytes']:.4e} HBM bytes, {mv['sram_bytes']:.4e} SRAM "
        f"bytes, {mv['energy_j']:.4e} J, padding {mv['padding_overhead']:.4f}")
    on["e2e"].update(
        spans=on["spans"], events=on["events"], dropped=on["dropped"],
        exports=on["exports"], same_as_chunked=True,
        tick_ms_median_off=chunked["e2e"]["tick_ms_median"],
        movement_model_paper_16nm={k: mv[k] for k in (
            "launches", "kv_read_bytes", "kv_write_bytes", "weight_bytes",
            "act_bytes", "hbm_bytes", "sram_bytes", "energy_j",
            "padding_overhead")})
    del on["trace"]

    free = runs["deadline_free"] = counted_run(model, params, "deadline_free")
    dl = runs["deadline"] = counted_run(model, params, "deadline",
                                        keep=_deadline_kept)
    expired = [v for v in dl["victims"] if v[-1] == "expire"]
    states = {v[2] for v in expired}
    timeouts = sorted(u for u, s in dl["statuses"].items() if s == "timeout")
    if not set(dl["statuses"].values()) <= {"done", "timeout"} \
            or len(dl["statuses"]) != len(DEADLINES) \
            or states != {"queued", "prefilling", "decoding"} \
            or sorted(v[1] for v in expired) != timeouts \
            or dl["pages_in_use"] or not dl["table_clear"]:
        raise AssertionError(f"deadline: statuses {dl['statuses']}, "
                             f"expired {expired}, {dl['pages_in_use']} "
                             f"pages in use after the drain")
    done = {u for u, s in dl["statuses"].items() if s == "done"}
    dl["e2e"]["outputs"] = outputs_agree(
        model, params, "deadline", "deadline_free",
        dict(dl, finished=[f for f in dl["finished"] if f[0] in done]),
        free)
    dl["e2e"].update(statuses=dl["statuses"], expired=expired,
                     timeouts=len(timeouts))
    log(f"# deadline: {len(timeouts)} of {len(DEADLINES)} requests timed "
        f"out (tick, uid, state, prefill cursor, tokens out: {expired}); "
        f"every uid terminal, every page back in the pool")

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    router, tick_s, syncs, wall, failed = run_fleet(model, params,
                                                    FLEET_REPLICAS, True)
    launches = read_counts()
    kinds = [r.kind for e in router.engines for r in e.launch_records()]
    want = {k: model.cfg.n_layers * sum(kinds.count(kind)
                                        for kind in _CHUNKED.get(k, ()))
            for k in COUNTERS}
    statuses = router.statuses()
    if failed is None or set(statuses.values()) != {"done"} \
            or launches != want or syncs:
        raise AssertionError(f"fleet: failure {failed}, statuses "
                             f"{statuses}, kernel launches {launches} "
                             f"(want {want}), {syncs} implicit syncs")
    for i, eng in enumerate(router.engines):
        if router.states[i].value != "dead" and eng.allocator.used_pages \
                != eng.prefix.cached_pages:
            raise AssertionError(f"fleet: replica {i} leaked pages")
    one = run_fleet(model, params, 1, False)[0]
    got = {"finished": _fleet_finished(router)}
    st = router.fleet_stats()
    e2e = {"replicas": FLEET_REPLICAS, "failed": failed,
           "dispatch": st["dispatch"], "redispatches": st["redispatches"],
           "affinity_hits": st["affinity_hits"],
           "affinity_hit_tokens": st["affinity_hit_tokens"],
           "replica_states": st["replica_states"],
           "gen_tokens": st["gen_tokens"],
           "prefill_tokens": st["prefill_tokens"],
           "prefix_hit_tokens": st["prefix_hit_tokens"],
           "ticks": len(tick_s), "wall_s": wall,
           "gen_tok_s": st["gen_tokens"] / wall,
           "tick_ms_median": float(np.median(tick_s)) * 1e3,
           "tick_ms_p95": float(np.percentile(tick_s, 95)) * 1e3,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "kernel_launches": launches, "implicit_syncs": syncs,
           "host_syncs": st["host_syncs"],
           "one_replica": {"dispatch": one.fleet_stats()["dispatch"],
                           "gen_tokens": one.fleet_stats()["gen_tokens"]}}
    e2e["outputs"] = outputs_agree(model, params, "fleet", "fleet of 1",
                                   got, {"finished": _fleet_finished(one)})
    log(f"# fleet: {FLEET_REPLICAS} replicas, replica 1 failed at tick "
        f"{failed[0]} holding {failed[1]} requests, {len(failed[2])} "
        f"redispatched; dispatch counts {st['dispatch']}, redispatches "
        f"{st['redispatches']}, affinity hits {st['affinity_hits']} "
        f"({st['affinity_hit_tokens']} tokens); every request done; kernel "
        f"launches {launches}; implicit host syncs in the ticks: {syncs}")
    runs["fleet"] = {"launches": launches, "e2e": e2e,
                     "per_tick": {k: v / len(tick_s)
                                  for k, v in launches.items()}}
    del router, one
    return runs


# ---------------------------------------------------------------------------
# phase 3, tensor-parallel serving (M10)
# ---------------------------------------------------------------------------

# two ranks of one gloo world on the one card (NCCL refuses two ranks on
# one device): each a process of its own on cuda:0 (spawned: the parent
# holds the card already), joined through a FileStore under build/
M10_TP = 2
M10_DIR = ROOT / "build" / "m10"
M10_JOIN_S = 600
# the runs served at tp 2, each against phase 3's tp 1 run of its traffic
M10_RUNS = ("chunked", "speculative")


def m10_lanes(dtype):
    """The kernel calls of phase_m10 at granite-3-2b's shapes (32 / 8 heads
    of 64, pages of 16): K1 on a chunk batch of (4, 256) queries
    (serving_shape_args' rows), K1's verify lane on (8, 5) draft rows with
    ragged q_lens over K2's tables, K2 on (8, 1).  The same seeded values
    in every process on the card.  Returns {lane: (call, args)}."""
    k1, k2, _, _ = serving_shape_args(dtype, seed=7)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(8)
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)
    q_lens = i32([5, 1, 3, 5, 2, 1, 4, 5])
    verify = dict(k1, q=torch.randn((8, 5, 32, 64), generator=g, device=dev,
                                    dtype=torch.float32).to(dtype),
                  page_tables=k2["block_table"], q_offsets=k2["cache_len"],
                  true_lens=k2["cache_len"] + q_lens, q_lens=q_lens)
    return {"K1 chunk": (k1_call, k1), "K1 verify": (k1_call, verify),
            "K2 decode": (k2_call, k2)}


def param_checksum(params) -> list:
    """Per parameter leaf, its float64 sum and sum of squares (on the card,
    in the leaves' order): equal weights give equal lists."""
    return [[float(t.double().sum()), float(t.double().square().sum())]
            for t in leaves(params)]


class GatherMeter:
    """Wraps torch.distributed.all_gather_into_tensor (the transport of
    ops._tp_head_sharded): counts the calls, sums their host wall time
    (gloo finishes the gather before the call returns) and keeps the
    synchronising calls torch.cuda's sync debug mode reports on this
    thread inside them out of the tick's count."""

    def __init__(self):
        import torch.distributed as dist
        self.dist, self.orig = dist, dist.all_gather_into_tensor
        self.calls, self.wall_s, self.syncs = 0, 0.0, 0

    def __enter__(self):
        def gather(*args, **kw):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                t0 = time.perf_counter()
                out = self.orig(*args, **kw)
                self.wall_s += time.perf_counter() - t0
            self.calls += 1
            self.syncs += sum("synchroniz" in str(w.message)
                              for w in caught)
            return out
        self.dist.all_gather_into_tensor = gather
        return self

    def __exit__(self, *exc):
        self.dist.all_gather_into_tensor = self.orig


@contextlib.contextmanager
def stderr_lines(path: Path):
    """The process's file descriptor 2 sent to `path` while the block runs
    (the C++ warnings of other threads - gloo's - go there); yields a
    list that holds the captured lines afterwards."""
    sys.stderr.flush()
    saved = os.dup(2)
    lines = []
    with open(path, "w") as f:
        os.dup2(f.fileno(), 2)
        try:
            yield lines
        finally:
            sys.stderr.flush()
            os.dup2(saved, 2)
            os.close(saved)
    lines.extend(path.read_text().splitlines())


def m10_serve(model, params, run: str, rank: int) -> dict:
    """The run's traffic at tp M10_TP on this rank, counted: launches, the
    engine's implicit syncs (0 expected) apart from gloo's (inside the
    gathers on this thread, and on gloo's threads, read from stderr),
    tick times, peak memory, tokens and the TP accounting."""
    scfg = dict(RUNS[run], tp_degree=M10_TP)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with GatherMeter() as gm, \
            stderr_lines(M10_DIR / f"stderr{rank}_{run}.txt") as err:
        eng, tick_s, syncs, wall, _ = run_traffic(model, params, run,
                                                  count_syncs=True,
                                                  scfg=scfg)
    launches = read_counts()
    st, tp = eng.stats(), eng.tp_stats()
    eng.check_invariants()
    return {
        "finished": [(r.uid, list(r.out_tokens))
                     for r in sorted(eng.sched.finished,
                                     key=lambda r: r.uid)],
        "launches": launches, "engine_syncs": syncs,
        "gloo_syncs_this_thread": gm.syncs,
        "gloo_syncs_other_threads": sum("synchronizing CUDA operation" in x
                                        for x in err),
        "gathers": gm.calls, "gather_wall_s": gm.wall_s,
        "tp_stats": tp, "kv_cache_bytes": eng.kv_cache_bytes(),
        "gen_tokens": st["gen_tokens"], "wall_s": wall,
        "gen_tok_s": st["gen_tokens"] / wall,
        "tick_ms_median": float(np.median(tick_s)) * 1e3,
        "tick_ms_p95": float(np.percentile(tick_s, 95)) * 1e3,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "ticks": len(tick_s), "host_syncs": st["host_syncs"]}


def m10_rank(rank: int, world: int, checksum: list):
    """One rank of phase_m10 (a spawned process of its own on cuda:0):
    K1 / K2 on its head shard of m10_lanes' inputs through the sharded
    wrappers, gathered over the gloo group (outputs saved for the parent
    to compare); then granite-3-2b at full width, seeded as the parent's
    (checked against the parent's checksum before serving), serves the
    chunked traffic at tp M10_TP under the device profiler (the warm-up),
    then each of M10_RUNS, counted.  Results to M10_DIR/rank<r>.json."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_serve_mesh
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(M10_DIR / "store"), world),
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_serve_mesh(world)
        outs = {}
        for dtype in (torch.float32, torch.bfloat16):
            for lane, (call, a) in m10_lanes(dtype).items():
                n = a["k_pages"].shape[2] // world
                shard = {k: a[k].narrow(2, rank * n, n).contiguous()
                         for k in ("k_pages", "v_pages")}
                outs[f"{lane} {str(dtype)[6:]}"] = call(
                    dict(a, **shard), tp_mesh=mesh).cpu()
        torch.save(outs, M10_DIR / f"kernels{rank}.pt")
        del outs
        model = build_model(get_config("granite-3-2b"))
        params = model.init(seed=0)
        if param_checksum(params) != checksum:
            raise AssertionError(f"rank {rank}: its seeded weights differ "
                                 f"from the parent's")
        # the traced run first: it is also the counted runs' warm-up
        with GatherMeter() as gm:
            tr = device_trace(lambda: run_traffic(
                model, params, "chunked", count_syncs=False,
                scfg=dict(RUNS["chunked"], tp_degree=M10_TP)))
        tr["gathers"], tr["gather_wall_s"] = gm.calls, gm.wall_s
        res = {"rank": rank, "trace": tr}
        for run in M10_RUNS:
            res[run] = m10_serve(model, params, run, rank)
        (M10_DIR / f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def phase_m10(model, params, runs):
    """Tensor-parallel serving on the card: two ranks on cuda:0 in a gloo
    world.  The kernel shards - K1's chunk and verify lanes and K2 at
    granite-3-2b's shapes, each rank on its half of the heads (16 / 4, G
    4), gathered - must equal the unsharded kernels' outputs here bit for
    bit.  Then each rank serves M10_RUNS at tp 2 on granite-3-2b at full
    width: every rank's tokens must equal phase 3's tp 1 run of the same
    traffic, its K1 / K2 launches that run's, its engine's implicit syncs
    0, its pools half of tp 1's, and shard bytes x 2 = pages read x page
    bytes.  Two ranks on one card share its SMs and HBM, and gloo moves
    the gathers through host memory: the times are not a TP speed."""
    import torch.multiprocessing as mp
    shutil.rmtree(M10_DIR, ignore_errors=True)
    M10_DIR.mkdir(parents=True)
    full = {}
    for dtype in (torch.float32, torch.bfloat16):
        for lane, (call, a) in m10_lanes(dtype).items():
            full[f"{lane} {str(dtype)[6:]}"] = call(a).cpu()
    checksum = param_checksum(params)
    t0 = time.perf_counter()
    ctx = mp.start_processes(m10_rank, args=(M10_TP, checksum),
                             nprocs=M10_TP, join=False,
                             start_method="spawn")
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() - t0 > M10_JOIN_S:
                raise AssertionError(f"M10: the ranks did not finish in "
                                     f"{M10_JOIN_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    wall = time.perf_counter() - t0
    errs = {}
    for r in range(M10_TP):
        got = torch.load(M10_DIR / f"kernels{r}.pt")
        for key, want in full.items():
            errs[key] = max(errs.get(key, 0.0), float(
                (got[key].float() - want.float()).abs().max()))
            if not torch.equal(got[key], want):
                raise AssertionError(f"M10: rank {r}'s gathered {key} "
                                     f"differs from the unsharded kernel")
    log(f"# M10 kernel shards ({M10_TP} ranks, 16 / 4 heads of 64 each, G "
        f"4), gathered against the unsharded kernels, max |difference|: "
        + ", ".join(f"{k} {e:.1e}" for k, e in errs.items()))
    res = [json.loads((M10_DIR / f"rank{r}.json").read_text())
           for r in range(M10_TP)]
    out = {"ranks_wall_s": wall, "kernel_max_abs_diff": errs}
    table_bytes = RUNS["chunked"]["max_batch"] * (
        RUNS["chunked"]["max_seq"] // RUNS["chunked"]["page_size"]) * 4
    for run in M10_RUNS:
        ref_run = runs[run]
        want_toks = [(uid, toks) for uid, _, toks in ref_run["finished"]]
        want_launches = dict(ref_run["launches"])
        tp1_kv = round(ref_run["e2e"]["kv_cache_gb"] * 1e9)
        for r, rr in enumerate(res):
            got = rr[run]
            toks = [tuple(x) for x in got["finished"]]
            n_eq = sum(a == b for a, b in zip(toks, want_toks))
            t = got["tp_stats"]
            pool = t["rank_kv_cache_bytes"] - table_bytes
            log(f"# M10 {run} rank {r}: {n_eq} of {len(want_toks)} requests "
                f"equal to tp 1's; kernel launches {got['launches']}; "
                f"implicit syncs of the engine {got['engine_syncs']}, of "
                f"gloo {got['gloo_syncs_this_thread']} on this thread and "
                f"{got['gloo_syncs_other_threads']} on its own in "
                f"{got['gathers']} gathers ({got['gather_wall_s']:.3f} s of "
                f"host wall); ticks {got['tick_ms_median']:.1f} / "
                f"{got['tick_ms_p95']:.1f} ms (median / p95), "
                f"{got['gen_tok_s']:.1f} generated tokens/s, peak "
                f"{got['peak_mem_gb']:.2f} GB, pools {pool / 1e9:.3f} GB "
                f"(tp 1 {(tp1_kv - table_bytes) / 1e9:.3f})")
            if n_eq != len(want_toks) or len(toks) != len(want_toks):
                raise AssertionError(f"M10 {run}: rank {r}'s tokens differ "
                                     f"from tp 1's")
            if got["launches"] != want_launches:
                raise AssertionError(f"M10 {run}: rank {r} launched "
                                     f"{got['launches']}, tp 1 "
                                     f"{want_launches}")
            if got["engine_syncs"]:
                raise AssertionError(f"M10 {run}: {got['engine_syncs']} "
                                     f"implicit syncs in the ticks")
            if t["shard_kv_bytes_read"] * M10_TP \
                    != t["kv_pages_read"] * t["page_bytes"] \
                    or t["tp_degree"] != M10_TP:
                raise AssertionError(f"M10 {run}: shard accounting {t}")
            if pool * M10_TP != tp1_kv - table_bytes \
                    or got["kv_cache_bytes"] != tp1_kv:
                raise AssertionError(f"M10 {run}: rank {r} holds {pool} "
                                     f"bytes of pools, tp 1 "
                                     f"{tp1_kv - table_bytes}")
        if res[1][run]["finished"] != res[0][run]["finished"]:
            raise AssertionError(f"M10 {run}: the ranks' tokens differ")
        out[run] = [rr[run] for rr in res]
    for r, rr in enumerate(res):
        tr = rr["trace"]
        log(f"# M10 trace (chunked) rank {r}: device busy "
            f"{tr['device_busy_s']:.3f} s of {tr['profiled_wall_s']:.3f} s, "
            f"{tr['gathers']} gathers {tr['gather_wall_s']:.3f} s of host "
            f"wall, memcpy {tr['memcpy_ms']:.1f} ms of device time; port "
            f"kernels "
            + ", ".join(f"{k} {v['ms']:.1f} ms" for k, v in
                        tr["port_kernels"].items()))
    out["trace"] = [rr["trace"] for rr in res]
    log(f"# M10: {M10_TP} ranks served in {wall:.1f} s (spawn, build, "
        f"seeding and every run)")
    # rank 0's calls, bf16, for the timing phase: K1 and K2 at the shard's
    # 16 / 4 heads
    lanes = m10_lanes(torch.bfloat16)
    captured = {}
    for key, lane in (("K1", "K1 chunk"), ("K2", "K2 decode")):
        a = dict(lanes[lane][1])
        for k, h in (("q", 32 // M10_TP), ("k_pages", 8 // M10_TP),
                     ("v_pages", 8 // M10_TP)):
            a[k] = a[k][:, :, :h].contiguous()
        captured[f"{key}@tp{M10_TP}_shard"] = ([], a)
    m10_launches = {f"m10_{run}_rank{r}": {"launches": rr[run]["launches"]}
                    for run in M10_RUNS for r, rr in enumerate(res)}
    return out, captured, m10_launches


# ---------------------------------------------------------------------------
# phase 3, training
# ---------------------------------------------------------------------------

def _k5_weight(q, k, v, o, lse, do, causal=True, window=0, **_):
    """The call's attended (query, key) pairs: under gemma3-4b's windows
    a global layer's backward is the largest."""
    return q.shape[0] * cost.attention_pairs(q.shape[1], k.shape[1], causal,
                                             window)


def train_check(model, params, batch, bars=TRAIN_BARS):
    """One step's loss and gradient norm (the step's loss and backward,
    before the optimizer) through the kernels and through impl="ref",
    from the same state, within `bars`.  Returns {impl: (loss, grad
    norm)}."""
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
            f"(bar {bars[key]})")
        if not (np.isfinite(a) and err <= bars[key]):
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
# phase 3, sharded training (M14a)
# ---------------------------------------------------------------------------

# four ranks of one gloo world on the one card (NCCL refuses two ranks on
# one device), each a spawned process on cuda:0, on make_debug_mesh(2, 2);
# granite-3-2b at full width, 8 of its 40 layers (each rank gathers the
# whole tree every step: ~1.2 GB of bf16 weights at 8 layers, ~105 GB for
# four ranks at 40), 4 x 2048 tokens a step (2 x 2048 a rank), remat full
M14_MESH = (2, 2)
M14_WORLD = M14_MESH[0] * M14_MESH[1]
M14_LAYERS = 8
M14_DIR = ROOT / "build" / "m14"
M14_JOIN_S = 750
M14_TRAIN = dict(TRAIN, checkpoint_every=0, log_every=1)
# each rank's K4 / K5 call: its 2 x 2048 rows, 16 of the 32 query heads
# and 4 of the 8 KV heads, of 64
M14_SHARD = (2, 2048, 16, 4, 64)
M14_STEPS = 2
# the sharded step against the single-device step in bf16: the JAX
# package's bars for the same comparison (tests/test_distributed.py:95-97),
# |loss difference| and |grad norm difference| / grad norm
M14_BARS = {"loss": 2e-2, "grad_norm": 0.05}
# the serving cells (launch/specs.py prefill_cell, serve_cell) on the same
# mesh and the trained weights: name -> (cache positions S, batch B,
# prompt length P); the prefill cell at 4 x 2048 (the default layout: K4
# on the rank's 16 / 4 heads), then two decode cells, each filled by its
# prefill cell and decoding M14_DECODE_STEPS teacher-forced steps to S:
# B 4 in the default layout (K3 on the rank's heads) and B 1 with the
# sequence over the data axis (ops.seq_parallel_decode, no kernel)
M14_SERVE = {"prefill": (2048, 4, 2048), "decode": (4096, 4, 4080),
             "decode_seq_data": (32768, 1, 32752)}
M14_DECODE_STEPS = 16
# each rank's cache shard against the single-device cache's slice: bf16
# K / V of scale ~5 from GEMMs of other shapes (a rank's 2 rows against
# 4), the bar of the dense prefill's logits
M14_CACHE_BAR = MODEL_BARS["dense prefill"]


# the MoE family on the same mesh (ROADMAP §1 item 3), after granite's
# work in the same four ranks: olmoe-1b-7b at full width with 2 of its 16
# layers (1.05 B parameters), two runs of M14_STEPS steps of 2 x 2048
# numpy-seeded tokens through the mesh Trainer - the per-row dispatch at
# the published capacity factor, against the single-device Trainer at the
# same factor (per-row capacity is per row: the mesh's rows drop what one
# device's drop), and the REPRO_MOE_A2A exchange at the smallest of
# M14_MOE_FACTORS at which it drops no pair in these batches
# (m14_moe_factor), against the single-device Trainer at M14_MOE_NO_DROP
# = E / K, where the per-row capacity C = S K / E x factor is the whole
# row and nothing can drop: both then compute the MoE with no drop.  The
# exchange's expert capacity carries the factor twice (c_loc = ceil(tp
# c_pair / e_loc x factor)), so at 8.0 its bf16 expert buffer alone would
# be 4.3 GB a rank a layer; at 2.0 each of its paths - per destination
# rank, per expert - has at least twice its mean load.  The per-row
# dispatch at the seeded weights drops at every factor of
# M14_MOE_FACTORS (the drops of both paths are printed by factor), and a
# shorter batch does not help: the seeded model routes most tokens of a
# row alike, so the overflow is a share of each row.  Then one prefill
# cell of 2 x 2048 and M14_DECODE_STEPS decode steps of the serve cell
# (default layout) on the per-row run's weights, against one device
M14_MOE_LAYERS = 2
M14_MOE_TRAIN = dict(M14_TRAIN, global_batch=2)
M14_MOE_FACTORS = (2.0, 3.0, 4.0)
M14_MOE_SERVE = {"moe_decode": (2048 + M14_DECODE_STEPS, 2, 2048)}
# the vlm and audio families on the same mesh (ROADMAP §1 item 3), after
# the MoE runs in the same ranks, each first serving on its seeded weights
# (the prefill cell, then M14_DECODE_STEPS steps of the serve cell), then
# training M14_STEPS steps through the mesh Trainer, against one device
# on the same seeded weights and batches (run before the ranks start).
# llava-next-34b at full width, cut to 1 of its 60 layers: 1.47 B
# parameters, 0.92 B of them the untied 64000 x 7168 embed and lm_head;
# a rank holds ~13 GB by reckoning (the gathered bf16 tree 2.9, its bf16
# grads 2.9, its shard of params, m and v 3.7, the fp32 unembed's table
# copy 1.8, a row's fp32 logits and softmax ~1.5; 14.7 GB peak on an H100
# 80GB HBM3), four ~60 GB; 2 layers would need ~20 GB a rank, ~80 GB in
# all.  A global 2 x (576 image + 1472 text)
# positions a step, its 56 / 8 heads 28 / 4 a rank.  whisper-base at
# full width and depth (6 + 6 layers, 74 M parameters): a global 4 x
# 1500 frames and tokens a step (launch/specs.py batch_specs' shapes),
# served on 4 lanes in the default layout (K3 on the rank's 4 KV heads
# for the self and cross strips) and on 1 lane with the sequence over
# the data axis (serve_cell's own layout at B 1 < 2: self and cross
# strips split in two, ops.seq_parallel_decode over the whole 1500 cross
# positions).  name -> (arch, layers or None for all, train fields,
# serving runs (S, B, P text tokens))
M14_VA = {
    "llava": ("llava-next-34b", 1,
              dict(M14_TRAIN, global_batch=2, seq_len=576 + 1472),
              {"llava_decode": (576 + 1472 + M14_DECODE_STEPS, 2, 1472)}),
    "whisper": ("whisper-base", None,
                dict(M14_TRAIN, global_batch=4, seq_len=1500),
                {"whisper_decode": (1500, 4, 1500 - M14_DECODE_STEPS),
                 "whisper_decode_seq_data": (1500, 1,
                                             1500 - M14_DECODE_STEPS)})}
# the ranks start the vlm / audio runs once this file says the MoE
# references beside them are done and freed
M14_VA_GO = "moe_reference_done"
M14_VA_WAIT_S = 300
# the hybrid and ssm families on the same mesh, after the vlm / audio
# runs in the same ranks: serving only (their training on the card waits
# for a backward of K6 / K7 and K5 at head dim 80, ROADMAP §2), each
# seeded on the card in bf16 (Model.init(M14_REC_SEED)) at full width and
# cut in depth - zamba2-2.7b to 12 of its 54 layers, two applications of
# its shared block, so its strips' A axis holds 2; rwkv6-1.6b to 6 of
# its 24.  Each decode run's prefill cell takes 4 (or 1) x 2048 tokens
# (the Mamba2 / RWKV6 layers on every head of the rank's rows, zamba2's
# shared block through K4 on 16 of its 32 heads, head dim 80), then
# M14_DECODE_STEPS teacher-forced decode steps: 4 lanes in the default
# layout (K3 on the rank's 16 KV heads), 1 lane with the sequence over
# the data axis (ops.seq_parallel_decode, no kernel).  Both runs in bf16
# (the deployment dtype: walls, peak, launches) and in float32 on the
# same weights (fp32_copy), each against one device on the same weights
# (run before the ranks start).  The float32 runs carry the agreement
# check (m14_serve_check's bars, 0 argmax flips, each state leaf within
# M14_REC_STATE_BAR of its largest |entry|): in bf16 these seeded models
# amplify any rounding - one device with K3 against one device with the
# plain decode parts by as much as the mesh does - so the bf16 runs'
# distance from one device is printed beside the model's own bf16 noise
# (one device bf16 against float32), not held to a bar.
# name -> (arch, layers); runs: name -> (S, B, P)
M14_REC = {"zamba2": ("zamba2-2.7b", 12), "rwkv6": ("rwkv6-1.6b", 6)}
M14_REC_RUNS = {"decode": (2048 + M14_DECODE_STEPS, 4, 2048),
                "decode_seq_data": (2048 + M14_DECODE_STEPS, 1, 2048)}
M14_REC_DTYPES = ("bfloat16", "float32")
M14_REC_SEED = 5
# float32 state leaves against one device, of each leaf's largest
# |entry|: 1.5e-3 at zamba2's shared strips, 2e-5 at its SSM states
# (16 steps, my chip call 4 of PR 31), ~7x
M14_REC_STATE_BAR = 1e-2


def m14_setup():
    """The config, its TrainConfig (checkpoints under M14_DIR/<name>) and
    the numpy-seeded global batches of the M14_STEPS steps (the same in
    every process, unlike the pipeline's: ROADMAP §3)."""
    cfg = get_config("granite-3-2b").replace(n_layers=M14_LAYERS)
    tc = lambda name: TrainConfig(checkpoint_dir=str(M14_DIR / name),
                                  **M14_TRAIN)
    B, S = M14_TRAIN["global_batch"], M14_TRAIN["seq_len"]
    batches = {s: {"tokens": np.random.default_rng(100 + s).integers(
        0, cfg.vocab_size, (B, S), dtype=np.int32)} for s in range(M14_STEPS)}
    return cfg, tc, batches


def m14_moe_setup():
    """olmoe-1b-7b at M14_MOE_LAYERS layers, its TrainConfig at a capacity
    factor (checkpoints under M14_DIR/<name>) and the numpy-seeded global
    batches of the M14_STEPS steps."""
    cfg = get_config("olmoe-1b-7b").replace(n_layers=M14_MOE_LAYERS)
    tc = lambda name: TrainConfig(checkpoint_dir=str(M14_DIR / name),
                                  **M14_MOE_TRAIN)
    B, S = M14_MOE_TRAIN["global_batch"], M14_MOE_TRAIN["seq_len"]
    batches = {s: {"tokens": np.random.default_rng(200 + s).integers(
        0, cfg.vocab_size, (B, S), dtype=np.int32)} for s in range(M14_STEPS)}
    return cfg, tc, batches


def m14_va_setup(name: str):
    """A vlm / audio run's config (M14_VA), its TrainConfig (checkpoints
    under M14_DIR/<name>), the numpy-seeded global batches of the
    M14_STEPS steps (tokens, and llava's image or whisper's frames, N(0,
    0.02^2) in float32: the pipeline hands them to the model in bf16) and
    its serving runs."""
    arch, layers, train, serve = M14_VA[name]
    cfg = get_config(arch)
    if layers:
        cfg = cfg.replace(n_layers=layers)
    tc = lambda tag: TrainConfig(checkpoint_dir=str(M14_DIR / tag), **train)
    B, S = train["global_batch"], train["seq_len"]
    rng = np.random.default_rng(400 + list(M14_VA).index(name))
    emb = lambda n: (rng.standard_normal((B, n, cfg.d_model))
                     * 0.02).astype(np.float32)
    batches = {}
    for s in range(M14_STEPS):
        if cfg.family == "vlm":
            b = {"vision_embeds": emb(cfg.frontend_tokens)}
            s_text = S - cfg.frontend_tokens
        else:
            b, s_text = {"audio_embeds": emb(S)}, S
        b["tokens"] = rng.integers(0, cfg.vocab_size, (B, s_text),
                                   dtype=np.int32)
        batches[s] = b
    return cfg, tc, batches, serve


def m14_va_launches(cfg) -> dict:
    """A vlm / audio training run's kernel launches a rank: a forward
    attention (K4) and, under remat full, its recompute, then its
    backward (K5), per layer and step; whisper's encoder (not remat, as
    in the JAX package) once forward, its decoder's self and cross
    attention twice."""
    L, E = cfg.n_layers, cfg.encoder_layers
    dec = 2 * L if cfg.family == "audio" else L
    want = {k: 0 for k in COUNTERS}
    want.update(K4=(E + 2 * dec) * M14_STEPS, K5=(E + dec) * M14_STEPS)
    return want


def m14_va_reference() -> dict:
    """The vlm / audio runs on one device, before the ranks start (llava's
    ~20 GB would not fit beside them): the single-device Trainer from the
    seeded weights serves the runs' prefill and decode steps on them
    (m14_serve_reference), then takes M14_STEPS steps through its own
    step on the same batches.  {name: {"steps": [(loss, grad norm)],
    "serve": the serving reference, "peak_gb", "wall_s"}}."""
    out = {}
    for name in M14_VA:
        cfg, tc, batches, serve = m14_va_setup(name)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr = Trainer(cfg, tc(f"{name}_single"))
        tr.pipeline.host_batch = lambda s: batches[s]
        ref_serve = m14_serve_reference(tr.model, tr.state.params, cfg,
                                        serve)
        steps = []
        for s in range(M14_STEPS):
            tr.state, m = tr.train_step(tr.state,
                                        tr.pipeline.device_batch(s))
            steps.append((float(m["loss"]), float(m["grad_norm"])))
        torch.cuda.synchronize()
        out[name] = {"steps": steps, "serve": ref_serve,
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "wall_s": time.perf_counter() - t0}
        del tr
        _free()
    return out


def m14_va_rank(rank: int, mesh) -> dict:
    """A rank's vlm / audio runs (M14_VA), once the MoE references beside
    the ranks are done (M14_VA_GO): the mesh Trainer on train_cell's
    shardings serves the runs through the cells' steps on its seeded
    parameter shards (m14_serve, records under "serve", files
    M14_DIR/<name>_serve<rank>.pt), then takes M14_STEPS steps of its own
    step on rank 0's batches, its collectives (COMM), walls and kernel
    launches counted; the peak over the whole run."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.specs import train_cell
    t0 = time.perf_counter()
    while not (M14_DIR / M14_VA_GO).exists():
        if time.perf_counter() - t0 > M14_VA_WAIT_S:
            raise AssertionError(f"M14: the MoE references did not finish "
                                 f"in {M14_VA_WAIT_S} s")
        time.sleep(0.5)
    out = {}
    for name in M14_VA:
        cfg, tc, batches, serve = m14_va_setup(name)
        tcfg = tc(f"{name}_mesh")
        shape = ShapeSpec("train", tcfg.seq_len, tcfg.global_batch, "train")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr = Trainer(cfg, tcfg, mesh=mesh,
                     state_shardings=train_cell(cfg, shape, mesh,
                                                tcfg)[2][0])
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        tr.pipeline.host_batch = lambda s: batches[s]
        serving = m14_serve(cfg, tr.state.params, mesh, rank, serve,
                            f"{name}_serve")
        _free()
        out[name] = dict(m14_steps(tr), serve=serving, build_s=build_s,
                         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        del tr
        _free()
    return out


def m14_va_check(res, ref: dict) -> dict:
    """The vlm / audio runs of every rank: losses equal rank 0's and
    within M14_BARS of the single-device Trainer's, kernel launches
    m14_va_launches' exactly, and the serving runs against the single-
    device prefill and decode (m14_serve_check)."""
    out = {}
    for name in M14_VA:
        cfg, _, _, serve = m14_va_setup(name)
        want = m14_va_launches(cfg)
        r = ref[name]
        got0 = [(m["loss"], m["grad_norm"])
                for m in res[0]["va"][name]["metrics"]]
        for rr in res:
            mr = rr["va"][name]
            got = [(m["loss"], m["grad_norm"]) for m in mr["metrics"]]
            comm = mr["comm_per_step"][-1]
            log(f"# M14 {cfg.name} ({cfg.n_layers} L) rank {rr['rank']}: "
                f"losses / grad norms "
                f"{[(round(a, 5), round(b, 5)) for a, b in got]}; step wall "
                f"{[round(t, 3) for t in mr['step_wall_s']]} s; kernel "
                f"launches {mr['launches']}; collectives a step "
                + ", ".join(f"{k} {v['calls']} calls {v['bytes'] / 1e9:.3f} "
                            f"GB" for k, v in sorted(comm.items()))
                + f"; peak {mr['peak_mem_gb']:.2f} GB; built in "
                f"{mr['build_s']:.1f} s")
            if got != got0:
                raise AssertionError(f"M14 {name}: rank {rr['rank']}'s "
                                     f"losses differ from rank 0's")
            if mr["launches"] != want:
                raise AssertionError(f"M14 {name}: rank {rr['rank']} "
                                     f"launched {mr['launches']}, want "
                                     f"{want}")
        for s, ((l_m, g_m), (l_r, g_r)) in enumerate(zip(got0, r["steps"])):
            dl, dg = abs(l_m - l_r), abs(g_m - g_r) / g_r
            log(f"# M14 {cfg.name} step {s}: 2x2 mesh loss {l_m:.5f} / grad "
                f"norm {g_m:.5f}, single device {l_r:.5f} / {g_r:.5f}: "
                f"|loss diff| {dl:.2e} (bar {M14_BARS['loss']}), grad norm "
                f"rel diff {dg:.2e} (bar {M14_BARS['grad_norm']})")
            if not (np.isfinite(l_m) and dl <= M14_BARS["loss"]
                    and dg <= M14_BARS["grad_norm"]):
                raise AssertionError(f"M14 {name} step {s}: the mesh step "
                                     f"and one device disagree")
        tag = f"{name}_serve"
        serving = m14_serve_check(
            r["serve"], [{"rank": rr["rank"], tag: rr["va"][name]["serve"]}
                         for rr in res], tag, cfg)
        log(f"# M14 {cfg.name}: the single-device reference (serving and "
            f"{M14_STEPS} steps) took {r['wall_s']:.1f} s, peak "
            f"{r['peak_gb']:.2f} GB")
        out[name] = {"config": cfg.name, "layers": cfg.n_layers,
                     "single_device": {k: v for k, v in r.items()
                                       if k != "serve"},
                     "serving": serving,
                     "ranks": [dict({k: v for k, v in rr["va"][name].items()
                                     if k != "serve"}, rank=rr["rank"])
                               for rr in res]}
    return out


def m14_rec_setup(name: str, dtype: str = "bfloat16"):
    """A recurrent run's config (M14_REC, cut in depth) in `dtype`."""
    arch, layers = M14_REC[name]
    return get_config(arch).replace(n_layers=layers, dtype=dtype)


def m14_rec_models(name: str):
    """{dtype: (model, params)}: the bf16 model seeded with
    Model.init(M14_REC_SEED) and its float32 copy (fp32_copy: the same
    values)."""
    model = build_model(m14_rec_setup(name))
    params = model.init(M14_REC_SEED)
    return {"bfloat16": (model, params),
            "float32": fp32_copy(model, params)}


def m14_rec_reference() -> dict:
    """The recurrent families' serving runs on one device, before the
    ranks start, in both dtypes (m14_serve_reference).  {name: {dtype:
    the reference}, "peak_gb", "wall_s"}."""
    out = {}
    for name in M14_REC:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        models = m14_rec_models(name)
        out[name] = {dt: m14_serve_reference(m, p, m.cfg, M14_REC_RUNS)
                     for dt, (m, p) in models.items()}
        torch.cuda.synchronize()
        out[name].update(peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                         wall_s=time.perf_counter() - t0)
        del models
        _free()
    return out


def m14_rec_rank(rank: int, mesh) -> dict:
    """A rank's recurrent runs (M14_REC): the models seeded as the
    reference's, their parameters handed to the cells' steps as this
    rank's DTensor shards (the prefill cell's shardings; the full tensors
    freed), then m14_serve in each dtype (records under the dtype, files
    M14_DIR/<name>_<dtype>_serve<rank>.pt); the build wall and the peak
    over both."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.specs import prefill_cell
    from repro_torch.sharding.shards import shard
    out = {}
    for name in M14_REC:
        S, B, _ = M14_REC_RUNS["decode"]
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = {}
        for dt, (m, p) in m14_rec_models(name).items():
            cell = prefill_cell(m.cfg, ShapeSpec("p", S, B, "prefill"), mesh)
            params[dt] = map_tree(shard, p, cell[2][0])
            del m, p
        _free()
        torch.cuda.synchronize()
        out[name] = {"build_s": time.perf_counter() - t0}
        for dt in M14_REC_DTYPES:
            out[name][dt] = m14_serve(m14_rec_setup(name, dt), params.pop(dt),
                                      mesh, rank, M14_REC_RUNS,
                                      f"{name}_{dt}_serve")
            _free()
        out[name]["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def m14_rec_bf16(ref16: dict, ref32: dict, res, name: str) -> dict:
    """The bf16 runs of every rank: finite logits, kernel launches
    m14_serve_launches' exactly; their distance from one device in bf16
    (logits, argmax flips) printed beside the model's own bf16 noise, one
    device bf16 against float32 on the same weights."""
    cfg, tag = m14_rec_setup(name), f"{name}_bfloat16_serve"
    summary = {}
    for rr in res:
        got = torch.load(M14_DIR / f"{tag}{rr['rank']}.pt")
        for run, rec in rr["rec"][name]["bfloat16"].items():
            r0, r1 = next(((st, st + sz) for d, st, sz in rec["rows"]
                           if d == 0), (0, ref16[run]["logits"].shape[1]))
            gl = got[run]["logits"]
            wl, w32 = ref16[run]["logits"][:, r0:r1], \
                ref32[run]["logits"][:, r0:r1]
            launches = {k: v for k, v in rec["launches"].items() if v}
            err, noise = float((gl - wl).abs().max()), \
                float((wl - w32).abs().max())
            flips = int((gl.argmax(-1) != wl.argmax(-1)).sum())
            noise_flips = int((wl.argmax(-1) != w32.argmax(-1)).sum())
            log(f"# M14 {cfg.name} bf16 {run} rank {rr['rank']}: logits "
                f"max |mesh - one device| {err:.4f}, {flips} argmax flips "
                f"of {gl.argmax(-1).numel()}; one device bf16 against "
                f"float32 {noise:.4f}, {noise_flips} flips; prefill "
                f"{rec['prefill_s']:.3f} s, decode "
                f"{rec['decode_step_s'] * 1e3:.1f} ms a step; launches "
                f"{launches}")
            if not bool(torch.isfinite(gl).all()):
                raise AssertionError(f"M14 {cfg.name} bf16 {run}: rank "
                                     f"{rr['rank']}'s logits not finite")
            if launches != m14_serve_launches(cfg, run):
                raise AssertionError(f"M14 {cfg.name} bf16 {run}: rank "
                                     f"{rr['rank']} launched {launches}, "
                                     f"want {m14_serve_launches(cfg, run)}")
            summary.setdefault(run, []).append(dict(
                rec, rank=rr["rank"], logits_max_abs_diff=err,
                argmax_flips=flips, bf16_noise=noise,
                bf16_noise_flips=noise_flips))
    return summary


def m14_rec_check(res, ref: dict) -> dict:
    """The recurrent runs of every rank against one device: the float32
    runs through m14_serve_check (logits within its bars, no argmax flip
    allowed, every state leaf and strip within M14_REC_STATE_BAR of its
    largest |entry|), the bf16 runs through m14_rec_bf16; in both, the
    kernel launches - zamba2 K4 once a shared-block application a
    prefill and K3 once an application a decode step in the default
    layout, none over data; rwkv6 none."""
    out = {}
    for name in M14_REC:
        cfg = m14_rec_setup(name, "float32")
        tag = f"{name}_float32_serve"
        f32 = m14_serve_check(
            ref[name]["float32"], [{"rank": rr["rank"],
                                    tag: rr["rec"][name]["float32"]}
                                   for rr in res], tag, cfg,
            allow_flips=False, cache_rel=M14_REC_STATE_BAR)
        bf16 = m14_rec_bf16(ref[name]["bfloat16"], ref[name]["float32"],
                            res, name)
        for rr in res:
            mr = rr["rec"][name]
            log(f"# M14 {cfg.name} ({cfg.n_layers} L) rank {rr['rank']}: "
                f"peak {mr['peak_mem_gb']:.2f} GB, built in "
                f"{mr['build_s']:.1f} s")
        log(f"# M14 {cfg.name}: the single-device references (bf16 and "
            f"float32) took {ref[name]['wall_s']:.1f} s, peak "
            f"{ref[name]['peak_gb']:.2f} GB")
        out[name] = {"config": cfg.name, "layers": cfg.n_layers,
                     "single_device": {k: ref[name][k]
                                       for k in ("wall_s", "peak_gb")},
                     "serving_float32": f32, "serving_bf16": bf16,
                     "ranks": [dict({k: v for k, v in rr["rec"][name].items()
                                     if k not in M14_REC_DTYPES},
                                    rank=rr["rank"]) for rr in res]}
    return out


def moe_drops(x: torch.Tensor, router: torch.Tensor, cfg, factor: float,
              tp: int) -> tuple:
    """The pairs one MoE layer's input x (B, S, d) drops at capacity
    factor `factor`: (the per-row dispatch's - models/moe.py dispatch, a
    pair past C in its expert's row - and the exchange's on a model axis
    of tp with the rows gathered - models/moe_a2a.py: a pair past c_pair
    of its destination rank, then a received pair past c_loc of its
    expert, in the receiver's order: by source rank, then slot)."""
    E, K = cfg.moe_experts, cfg.moe_top_k
    B, S, _ = x.shape
    f = cfg.replace(moe_capacity_factor=factor)
    _, _, top = moe.route({"router": router}, x, f)
    flat = top.reshape(B, S * K)
    pos = torch.gather(torch.cumsum(moe._one_hot(flat, E, torch.int32), 1),
                       2, flat[..., None])[..., 0] - 1
    rows = int((pos >= moe.capacity(S, f)).sum())
    e_loc, S_l = E // tp, S // tp
    T = B * S_l
    c_pair = math.ceil(T * K / tp * factor)
    c_loc = math.ceil(tp * c_pair / e_loc * factor)
    pair_drops, recv = 0, [[] for _ in range(tp)]
    for m in range(tp):
        e = top[:, m * S_l:(m + 1) * S_l].reshape(-1)      # (token, k) order
        dst = e // e_loc
        slot = torch.gather(torch.cumsum(moe._one_hot(dst, tp, torch.int32),
                                         0), 1, dst[:, None])[:, 0] - 1
        keep = slot < c_pair
        pair_drops += int((~keep).sum())
        for r in range(tp):
            recv[r].append(e[keep & (dst == r)] % e_loc)
    expert_drops = 0
    for r in range(tp):
        le = torch.cat(recv[r])
        eslot = torch.gather(torch.cumsum(moe._one_hot(le, e_loc,
                                                       torch.int32), 0),
                             1, le[:, None])[:, 0] - 1
        expert_drops += int((eslot >= c_loc).sum())
    return rows, pair_drops + expert_drops


def m14_moe_drops(model, params, batches, factors, tp: int) -> dict:
    """{factor: [per-row drops, exchange drops]} summed over the MoE layers
    of a no-grad forward of each batch (models/moe.py moe_ffn's inputs,
    captured)."""
    calls = []
    inner = moe.moe_ffn

    def capture(p, x, cfg, *rest):
        calls.append((p["router"], x))
        return inner(p, x, cfg, *rest)
    moe.moe_ffn = capture
    try:
        with torch.no_grad():
            for b in batches:
                model.forward(params, {"tokens": b["tokens"]})
    finally:
        moe.moe_ffn = inner
    out = {}
    for f in factors:
        d = [moe_drops(x, r, model.cfg, f, tp) for r, x in calls]
        out[f] = [sum(a for a, _ in d), sum(b for _, b in d)]
    del calls
    return out


def m14_moe_no_drop(cfg) -> float:
    """The capacity factor E / K: the per-row capacity is the row."""
    return cfg.moe_experts / cfg.moe_top_k


def m14_moe_factor():
    """The exchange run's capacity factor: the smallest of
    M14_MOE_FACTORS at which the exchange drops no pair of the M14_STEPS
    batches at the seeded weights (m14_moe_drops on one device; the
    per-row dispatch's drops printed beside).  Returns (factor, {factor:
    drops})."""
    cfg, tc, batches = m14_moe_setup()
    model = build_model(cfg)
    params = model.init(seed=tc("drops").seed)
    dev = model.device
    bs = [{"tokens": torch.from_numpy(b["tokens"]).to(dev)}
          for b in batches.values()]
    published = cfg.moe_capacity_factor
    drops = m14_moe_drops(model, params, bs, (published,) + M14_MOE_FACTORS
                          + (m14_moe_no_drop(cfg),), M14_MESH[1])
    del model, params, bs
    _free()
    log(f"# M14 MoE drops (per-row dispatch, exchange on the model axis "
        f"of {M14_MESH[1]}) in the {M14_STEPS} batches at the seeded "
        f"weights, by capacity factor: {drops}")
    factor = next((f for f in M14_MOE_FACTORS if drops[f][1] == 0), None)
    if factor is None:
        raise AssertionError(f"M14 MoE: the exchange drops pairs at every "
                             f"factor of {M14_MOE_FACTORS}: {drops}")
    return factor, drops


def m14_moe_runs(factor: float):
    """(run, capacity factor, REPRO_MOE_A2A, the single-device reference's
    capacity factor) of the MoE family's two mesh runs."""
    cfg = get_config("olmoe-1b-7b")
    published = cfg.moe_capacity_factor
    return (("rows", published, False, published),
            ("a2a", factor, True, m14_moe_no_drop(cfg)))


def m14_moe_reference(factor: float) -> dict:
    """The MoE runs on one device: the single-device Trainer at each run's
    reference factor (m14_moe_runs), from the same seeded weights,
    M14_STEPS steps through its own step, each step's drops counted first
    (m14_moe_drops): the per-row dispatch's at the reference's factor and
    the exchange's at the mesh run's.  {run: {"steps": [(loss, grad
    norm)], "drops": [[per-row, exchange]] a step}}."""
    cfg, tc, batches = m14_moe_setup()
    out = {}
    for run, f, _, f_ref in m14_moe_runs(factor):
        tr = Trainer(cfg.replace(moe_capacity_factor=f_ref),
                     tc(f"{run}_single"))
        tr.pipeline.host_batch = lambda s: batches[s]
        steps, drops = [], []
        for s in range(M14_STEPS):
            b = tr.pipeline.device_batch(s)
            d = m14_moe_drops(tr.model, tr.state.params, [b], (f_ref, f),
                              M14_MESH[1])
            drops.append([d[f_ref][0], d[f][1]])
            tr.state, m = tr.train_step(tr.state, b)
            steps.append((float(m["loss"]), float(m["grad_norm"])))
        out[run] = {"steps": steps, "drops": drops}
        del tr
        _free()
    return out


def m14_steps(tr) -> dict:
    """M14_STEPS steps of a mesh Trainer's own step on its pipeline's
    batches, after the launch counts are reset: each step's metrics,
    collectives (COMM) and wall, and the kernel launches of them all."""
    from repro_torch.sharding import shards
    reset_counts()
    metrics, comm, walls = [], [], []
    for s in range(M14_STEPS):
        t0 = time.perf_counter()
        b = tr.pipeline.device_batch(s)
        shards.reset_comm()
        tr.state, m = tr.train_step(tr.state, b)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        comm.append(json.loads(json.dumps(shards.COMM)))
        metrics.append({k: float(v) for k, v in m.items()})
        del b
    return {"metrics": metrics, "comm_per_step": comm,
            "step_wall_s": walls, "launches": read_counts()}


def m14_moe_rank(rank: int, mesh, factor: float) -> dict:
    """A rank's MoE runs (m14_moe_runs) through Trainer(mesh=,
    state_shardings=train_cell(...)): M14_STEPS steps of the Trainer's
    own step on rank 0's batches, the collectives (COMM) and kernel
    launches of each run; then on the per-row run's weights the serving
    run of M14_MOE_SERVE (m14_serve, records under "moe_serve"), and
    those weights, gathered, saved by rank 0 for the reference."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.specs import train_cell
    from repro_torch.sharding.shards import gather_full
    cfg, tc, batches = m14_moe_setup()
    out = {}
    for run, f, a2a, _ in m14_moe_runs(factor):
        c = cfg.replace(moe_capacity_factor=f)
        tcfg = tc(f"moe_{run}")
        shape = ShapeSpec("train", tcfg.seq_len, tcfg.global_batch, "train")
        if a2a:
            os.environ["REPRO_MOE_A2A"] = "1"
        try:
            t0 = time.perf_counter()
            tr = Trainer(c, tcfg, mesh=mesh,
                         state_shardings=train_cell(c, shape, mesh,
                                                    tcfg)[2][0])
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            tr.pipeline.host_batch = lambda s: batches[s]
            torch.cuda.reset_peak_memory_stats()
            steps = m14_steps(tr)
        finally:
            os.environ.pop("REPRO_MOE_A2A", None)
        out[run] = dict(steps, factor=f, build_s=build_s,
                        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        if run == "rows":
            out["moe_serve"] = m14_serve(c, tr.state.params, mesh, rank,
                                         M14_MOE_SERVE, "moe_serve")
            full = {p: gather_full(t) for p, t in
                    leaves_with_paths(tr.state.params)}
            if rank == 0:
                torch.save({p: t.cpu() for p, t in full.items()},
                           M14_DIR / "moe_params.pt")
            del full
        del tr
        _free()
    return out


def bit_digest(t: torch.Tensor) -> list:
    """Two int64 sums over a tensor's raw bits (the plain sum and one
    weighted by position), on the card: equal tensors give equal digests,
    and a changed element changes them."""
    x = t.detach().contiguous().view(-1)
    bits = x.view({2: torch.int16, 4: torch.int32}[x.element_size()]).long()
    w = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
    return [int(bits.sum()), int((bits * w).sum())]


def m14_serve_inputs(cfg, runs=M14_SERVE):
    """Each serving run's numpy-seeded prompts (B, P) and teacher-forced
    decode tokens (steps, B, 1), the same in every process; a vlm run's
    image (B, frontend_tokens, d_model) ahead of the prompt, an audio
    run's frames (B, S, d_model) for its S cross positions, both N(0,
    0.02^2) float32 from a generator of their own."""
    rng = np.random.default_rng(300)
    out = {name: {"prompt": rng.integers(0, cfg.vocab_size, (B, P),
                                         dtype=np.int32),
                  "tokens": rng.integers(0, cfg.vocab_size,
                                         (M14_DECODE_STEPS, B, 1),
                                         dtype=np.int32)}
           for name, (S, B, P) in runs.items()}
    for i, (name, (S, B, P)) in enumerate(runs.items()):
        emb = np.random.default_rng(310 + i)
        if cfg.family == "vlm":
            out[name]["vision_embeds"] = (emb.standard_normal(
                (B, cfg.frontend_tokens, cfg.d_model)) * 0.02).astype(
                    np.float32)
        elif cfg.family == "audio":
            out[name]["audio_embeds"] = (emb.standard_normal(
                (B, S, cfg.d_model)) * 0.02).astype(np.float32)
    return out


def m14_prompt(cfg, inp: dict) -> dict:
    """A serving run's prompt batch in the cell's batch keys: the tokens,
    and the frontend's embeddings where the family has them."""
    return {"tokens" if k == "prompt" else k: v for k, v in inp.items()
            if k != "tokens"}


def m14_serve(cfg, params, mesh, rank: int, runs=M14_SERVE,
              tag: str = "serve") -> dict:
    """A rank's serving runs (default M14_SERVE) through the cells' steps:
    each run's
    prefill cell step fills its cache shard (the first with the state's
    parameter DTensors, gathered inside the step; the others with the
    tree gathered once), a decode run then takes its serve cell's step
    M14_DECODE_STEPS times.  Logits and cache shards to
    M14_DIR/<tag><rank>.pt; returns each run's layout, row and cache
    bounds, walls and kernel launches."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.specs import (prefill_cell, serve_cell,
                                          strips_spec)
    from repro_torch.sharding.shards import (gather_full, local_shape,
                                             local_slice, slice_bounds)
    dev = leaves(params)[0].device
    local = lambda a, sh, dt=None: local_slice(
        torch.from_numpy(a).to(dev, dt), sh.placements, mesh).contiguous()
    spec = lambda s: None if s is None else [
        list(e) if isinstance(e, tuple) else e for e in s]
    full, out, arrays = None, {}, {}
    for name, (S, B, P) in runs.items():
        inp = m14_serve_inputs(cfg, runs)[name]
        pstep, pargs, psh = prefill_cell(
            cfg, ShapeSpec(name, S, B, "prefill"), mesh)
        names = sorted(pargs[2])
        cache = {n: torch.zeros(local_shape(pargs[2][n].shape,
                                            psh[2][n].placements, mesh),
                                dtype=pargs[2][n].dtype, device=dev)
                 for n in names}
        # each leaf's block from its own spec (the recurrent states' too)
        rec = {"cache_spec": spec(strips_spec(psh[2])),
               "rows": slice_bounds((B, P), psh[1]["tokens"].placements,
                                    mesh),
               "cache_bounds": {n: slice_bounds(pargs[2][n].shape,
                                                psh[2][n].placements, mesh)
                                for n in names}}
        batch = {k: local(a, psh[1][k], None if k == "tokens"
                          else pargs[1][k].dtype)
                 for k, a in m14_prompt(cfg, inp).items()}
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache, lens = pstep(
            params if full is None else full, batch, cache)
        torch.cuda.synchronize()
        rec["prefill_s"] = time.perf_counter() - t0
        logs = [logits.float()]
        if full is None:
            full = map_tree(gather_full, params)
        if name != "prefill":
            dstep, _, dsh = serve_cell(cfg, ShapeSpec(name, S, B, "decode"),
                                       mesh)
            if spec(strips_spec(dsh[1])) != rec["cache_spec"]:
                raise AssertionError(f"M14 {name}: the prefill and decode "
                                     f"cells lay the cache out differently")
            # a vlm's image positions lead its prompt's text
            image = cfg.frontend_tokens if cfg.family == "vlm" else 0
            lens = local(np.full((B,), image + P, np.int32), dsh[3])
            t0 = time.perf_counter()
            for i in range(M14_DECODE_STEPS):
                logits, cache = dstep(full, cache,
                                      local(inp["tokens"][i], dsh[2]), lens)
                lens = lens + 1
                logs.append(logits.float())
            torch.cuda.synchronize()
            rec["decode_step_s"] = (time.perf_counter() - t0) \
                / M14_DECODE_STEPS
        rec["launches"] = read_counts()
        arrays[name] = {"logits": torch.stack(logs).cpu(),
                        **{n: cache[n].cpu() for n in names}}
        out[name] = rec
        del cache, logs
    torch.save(arrays, M14_DIR / f"{tag}{rank}.pt")
    return out


def m14_dryrun() -> dict:
    """launch/dryrun.py's record of the M14 train cell (2x2, M14_LAYERS
    layers, 4 x 2048, remat full) in a fake world of four, this process
    standing for rank 0: run after the gloo world is gone."""
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_debug_mesh
    cfg, _, _ = m14_setup()
    dryrun.fake_world(M14_WORLD)
    try:
        mesh = make_debug_mesh(*M14_MESH, device_type="cpu")
        B, S = M14_TRAIN["global_batch"], M14_TRAIN["seq_len"]
        return dryrun.run_cell(cfg.name, "m14", False, cfg=cfg,
                               shape=ShapeSpec("m14", S, B, "train"),
                               mesh=mesh)
    finally:
        dist.destroy_process_group()


def m14_rank(rank: int, world: int, moe_factor: float):
    """One rank of phase_m14 (a spawned process of its own on cuda:0): the
    mesh Trainer takes M14_STEPS steps on rank 0's numpy-seeded batches,
    each step's collectives and the kernel launches counted, then saves
    its checkpoint (Trainer.run's last save: the full tensors, rank 0
    writing); each leaf's local shard digested for the elastic check;
    the serving cells (m14_serve); then the MoE runs (m14_moe_rank, the
    exchange at moe_factor); then the vlm and audio runs (m14_va_rank).
    Results to M14_DIR/rank<r>.json."""
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.specs import train_cell
    from repro_torch.sharding import shards
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(M14_DIR / "store"), world),
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=300))
    try:
        cfg, tc, batches = m14_setup()
        tcfg = tc("mesh")
        mesh = make_debug_mesh(*M14_MESH)
        shape = ShapeSpec("train", tcfg.seq_len, tcfg.global_batch, "train")
        t0 = time.perf_counter()
        tr = Trainer(cfg, tcfg, mesh=mesh,
                     state_shardings=train_cell(cfg, shape, mesh, tcfg)[2][0])
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        placed = torch.cuda.memory_allocated()
        tr.pipeline.host_batch = lambda s: batches[s]
        comm = []
        batch_of, step_of = tr.pipeline.device_batch, tr.train_step

        def device_batch(s):
            shards.reset_comm()
            return batch_of(s)

        def train_step(state, batch):
            out = step_of(state, batch)
            torch.cuda.synchronize()
            comm.append(json.loads(json.dumps(shards.COMM)))
            return out
        tr.pipeline.device_batch, tr.train_step = device_batch, train_step
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        out = tr.run(M14_STEPS)
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated()
        digests = {}
        for path, leaf in leaves_with_paths(tr.state):
            digests[path] = {
                "bounds": shards.slice_bounds(leaf.shape, leaf.placements,
                                              mesh),
                "digest": bit_digest(leaf.to_local())}
        res = {"rank": rank, "coord": mesh.get_coordinate(),
               "metrics": out["metrics"], "final_step": out["final_step"],
               "launches": launches, "comm_per_step": comm,
               "peak_mem_gb": peak / 1e9, "build_s": build_s,
               "allocated_after_state": placed, "digests": digests}
        res["serve"] = m14_serve(cfg, tr.state.params, mesh, rank)
        del tr
        _free()
        res["moe"] = m14_moe_rank(rank, mesh, moe_factor)
        res["va"] = m14_va_rank(rank, mesh)
        res["rec"] = m14_rec_rank(rank, mesh)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        res["dryrun"] = m14_dryrun()
    (M14_DIR / f"rank{rank}.json").write_text(json.dumps(res))


def m14_reference(cfg, tc, batches) -> list:
    """The same steps by the single-device Trainer in this process, from
    the same seeded weights, through its own step (Trainer.run would also
    save the ~6 GB state): [(loss, grad norm)] a step."""
    tr = Trainer(cfg, tc("single"))
    tr.pipeline.host_batch = lambda s: batches[s]
    out = []
    for s in range(M14_STEPS):
        tr.state, m = tr.train_step(tr.state, tr.pipeline.device_batch(s))
        out.append((float(m["loss"]), float(m["grad_norm"])))
    del tr
    _free()
    return out


def m14_elastic(cfg, tc, res):
    """The checkpoint the 2x2 mesh saved, restored without a mesh (the
    single-device Trainer restores the newest in its directory): every
    rank's shard of every leaf has the bits the rank held.  Then the
    serving runs' single-device reference on those weights
    (m14_serve_reference).  Returns (shards checked, the reference)."""
    tr = Trainer(cfg, tc("mesh"))
    if tr.start_step != M14_STEPS:
        raise AssertionError(f"M14: restored at step {tr.start_step}")
    leaves_ = dict(leaves_with_paths(tr.state))
    n = 0
    for rr in res:
        for path, d in rr["digests"].items():
            t = leaves_[path]
            for dim, start, size in d["bounds"]:
                t = t.narrow(dim, start, size)
            if bit_digest(t) != d["digest"]:
                raise AssertionError(f"M14 elastic: rank {rr['rank']}'s "
                                     f"{path} differs after the restore")
            n += 1
    ref = m14_serve_reference(tr.model, tr.state.params, cfg)
    del tr, leaves_
    _free()
    return n, ref


def m14_serve_reference(model, params, cfg, runs=M14_SERVE) -> dict:
    """The serving runs (default M14_SERVE) on one device: Model.prefill
    of the whole batch, then the decode steps (seq_parallel=True where the
    mesh run shards the sequence: the naive decode, as the JAX package's
    serve cell)."""
    dev, dt = model.device, pdtype(cfg)
    out = {}
    with torch.no_grad():
        for name, (S, B, P) in runs.items():
            inp = m14_serve_inputs(cfg, runs)[name]
            cache = model.init_cache(B, S, enc_len=S) \
                if cfg.family == "audio" else model.init_cache(B, S)
            batch = {k: torch.from_numpy(a).to(dev, None if k == "tokens"
                                               else dt)
                     for k, a in m14_prompt(cfg, inp).items()}
            logits, cache, lens = model.prefill(params, batch, cache)
            logs = [logits.float()]
            if name != "prefill":
                for i in range(M14_DECODE_STEPS):
                    logits, cache = model.decode_step(
                        params, torch.from_numpy(inp["tokens"][i]).to(dev),
                        lens, cache, seq_parallel=name.endswith("seq_data"))
                    lens = lens + 1
                    logs.append(logits.float())
            out[name] = {"logits": torch.stack(logs).cpu(),
                         **{n: t.cpu() for n, t in cache.items()}}
            del cache
    return out


def _cut(t: torch.Tensor, bounds) -> torch.Tensor:
    for dim, start, size in bounds:
        t = t.narrow(dim, start, size)
    return t


def m14_serve_launches(cfg, name: str) -> dict:
    """A serving run's kernel launches a rank: K4 for each attention of
    the prefill (a layer's; whisper's encoder layers and its decoder's
    self and cross attention; zamba2's shared block's applications,
    rwkv6 none - their scans are the plain state-returning ones), then in
    the default layout's decode K3 for each decoder attention a step
    (whisper's self and cross; zamba2's applications); a
    sequence-sharded decode (ops.seq_parallel_decode) launches none, nor
    do the recurrent layers' steps."""
    L = cfg.n_layers
    if cfg.family in ("hybrid", "ssm"):
        prefill = step = n_shared_applications(cfg)
    elif cfg.family == "audio":
        prefill, step = cfg.encoder_layers + 2 * L, 2 * L
    else:
        prefill, step = L, L
    want = {"K4": prefill} if prefill else {}
    if name != "prefill" and not name.endswith("seq_data") and step:
        want["K3"] = step * M14_DECODE_STEPS
    return want


def m14_serve_check(ref: dict, res, tag: str = "serve",
                    cfg=None, allow_flips: bool = True,
                    cache_rel: float = 0.0) -> dict:
    """Every rank's serving runs against the single-device reference:
    logits of its rows within MODEL_BARS (prefill: the dense prefill's,
    decode: the dense or the seq-parallel decode step's), each step's
    argmax equal or a near tie (the reference's logit of the rank's token
    within SERVED_TOKEN_BAR of its max), its cache shard within
    M14_CACHE_BAR of the reference cache's slice (every leaf at its own
    bounds: whisper's self and cross strips, the recurrent states), and
    its kernel launches (m14_serve_launches), nothing else.  tag: the
    ranks' records (rr[tag]) and files (M14_DIR/<tag><rank>.pt); cfg the
    model's config (default M14's); allow_flips=False: no argmax may differ,
    near tie or not; cache_rel: each leaf's difference over its largest
    |entry| (the recurrent states: float32, of any scale) against that
    bar in place of M14_CACHE_BAR."""
    cfg = cfg or m14_setup()[0]
    summary = {}
    for rr in res:
        got = torch.load(M14_DIR / f"{tag}{rr['rank']}.pt")
        for name, rec in rr[tag].items():
            want, mine = ref[name], got[name]
            r0, r1 = next(((st, st + sz) for d, st, sz in rec["rows"]
                           if d == 0), (0, want["logits"].shape[1]))
            wl = want["logits"][:, r0:r1]
            gl = mine["logits"]
            errs = (gl - wl).abs().amax(dim=(1, 2, 3)).tolist()
            bars = [MODEL_BARS["dense prefill"]] + [MODEL_BARS[
                "seq-parallel decode step" if name.endswith("seq_data")
                else "dense decode step"]] * (len(errs) - 1)
            g_tok, w_tok = gl.argmax(-1), wl.argmax(-1)
            gap = (wl.amax(-1) - wl.gather(-1, g_tok[..., None])[..., 0])
            flips = int((g_tok != w_tok).sum())
            cache_err = max(float((mine[n].float() - _cut(
                want[n], rec["cache_bounds"][n]).float()).abs().max())
                / (max(float(want[n].float().abs().max()), 1e-30)
                   if cache_rel else 1.0)
                for n in mine if n != "logits")
            cache_bar = cache_rel or M14_CACHE_BAR
            launches = {k: v for k, v in rec["launches"].items() if v}
            log(f"# M14 {name} rank {rr['rank']} (cache spec "
                f"{rec['cache_spec']}, rows {r0}-{r1}): logits max |diff| "
                f"{max(errs):.4f} (bars {bars[0]} / {bars[-1]}), "
                f"{flips} argmax flips of {g_tok.numel()} (largest gap "
                f"{float(gap.max()):.4f}, bar {SERVED_TOKEN_BAR}), cache "
                f"shard {cache_err:.4g} (bar {cache_bar}"
                + (" of each leaf's largest |entry|" if cache_rel else "")
                + f"); prefill "
                f"{rec['prefill_s']:.3f} s"
                + (f", decode {rec['decode_step_s'] * 1e3:.1f} ms a step"
                   if "decode_step_s" in rec else "")
                + f"; launches {launches}")
            if any(e > b for e, b in zip(errs, bars)) \
                    or float(gap.max()) > SERVED_TOKEN_BAR \
                    or cache_err > cache_bar or (flips and not allow_flips):
                raise AssertionError(f"M14 {name}: rank {rr['rank']} "
                                     f"disagrees with one device")
            if launches != m14_serve_launches(cfg, name):
                raise AssertionError(f"M14 {name}: rank {rr['rank']} "
                                     f"launched {launches}, want "
                                     f"{m14_serve_launches(cfg, name)}")
            summary.setdefault(name, []).append(dict(
                rec, rank=rr["rank"], logits_max_abs_diff=max(errs),
                argmax_flips=flips, cache_max_abs_diff=cache_err))
    return summary


def m14_moe_check(res, ref: dict, factor: float, drops0: dict) -> dict:
    """The MoE runs of every rank: losses equal rank 0's, within M14_BARS
    of the single-device Trainer (ref, m14_moe_reference: at the same
    factor for the per-row run; for the exchange's at E / K, neither
    dropping a pair in its steps), K4 2 x layers and K5 layers launches a
    step and nothing else, all_to_all calls in the exchange run's
    collectives and none in the per-row run's."""
    L = M14_MOE_LAYERS
    want = {k: 0 for k in COUNTERS}
    want.update(K4=2 * L * M14_STEPS, K5=L * M14_STEPS)
    out = {"layers": L, "drops_at_seed": drops0, "runs": {}}
    for run, f, a2a, f_ref in m14_moe_runs(factor):
        r = ref[run]
        got0 = [(m["loss"], m["grad_norm"]) for m in
                res[0]["moe"][run]["metrics"]]
        for rr in res:
            mr = rr["moe"][run]
            got = [(m["loss"], m["grad_norm"]) for m in mr["metrics"]]
            comm = mr["comm_per_step"][-1]
            log(f"# M14 MoE {run} (capacity factor {f}, REPRO_MOE_A2A "
                f"{'1' if a2a else 'unset'}) rank {rr['rank']}: losses / "
                f"grad norms {[(round(a, 5), round(b, 5)) for a, b in got]}"
                f", aux {[round(m['aux'], 5) for m in mr['metrics']]}; step "
                f"wall {[round(t, 3) for t in mr['step_wall_s']]} s; kernel "
                f"launches {mr['launches']}; collectives a step "
                + ", ".join(f"{k} {v['calls']} calls {v['bytes'] / 1e9:.3f} "
                            f"GB" for k, v in sorted(comm.items()))
                + f"; peak {mr['peak_mem_gb']:.2f} GB; built in "
                f"{mr['build_s']:.1f} s")
            if got != got0:
                raise AssertionError(f"M14 MoE {run}: rank {rr['rank']}'s "
                                     f"losses differ from rank 0's")
            if mr["launches"] != want:
                raise AssertionError(f"M14 MoE {run}: rank {rr['rank']} "
                                     f"launched {mr['launches']}, want "
                                     f"{want}")
            if ("all_to_all" in comm) != a2a:
                raise AssertionError(f"M14 MoE {run}: all_to_all calls "
                                     f"{comm.get('all_to_all')}")
        for s, ((l_m, g_m), (l_r, g_r)) in enumerate(zip(got0, r["steps"])):
            dl, dg = abs(l_m - l_r), abs(g_m - g_r) / g_r
            log(f"# M14 MoE {run} step {s}: 2x2 mesh loss {l_m:.5f} / grad "
                f"norm {g_m:.5f}, single device at factor {f_ref} "
                f"{l_r:.5f} / {g_r:.5f}: |loss diff| {dl:.2e} (bar "
                f"{M14_BARS['loss']}), grad norm rel diff {dg:.2e} (bar "
                f"{M14_BARS['grad_norm']}); drops (per-row at {f_ref}, "
                f"exchange at {f}): {r['drops'][s]}")
            if not (np.isfinite(l_m) and dl <= M14_BARS["loss"]
                    and dg <= M14_BARS["grad_norm"]):
                raise AssertionError(f"M14 MoE {run} step {s}: the mesh "
                                     f"step and one device disagree")
            if a2a and r["drops"][s] != [0, 0]:
                raise AssertionError(f"M14 MoE: pairs dropped: "
                                     f"{r['drops'][s]}")
        out["runs"][run] = {
            "factor": f, "a2a": a2a, "reference_factor": f_ref,
            "single_device": r,
            "ranks": [dict(rr["moe"][run], rank=rr["rank"]) for rr in res]}
    return out


def m14_moe_serve_check(res) -> dict:
    """The MoE serving run of every rank (M14_MOE_SERVE, on the per-row
    run's weights, which rank 0 saved) against one device on those
    weights, as m14_serve_check holds granite's."""
    cfg, _, _ = m14_moe_setup()
    model = build_model(cfg)
    saved = torch.load(M14_DIR / "moe_params.pt")
    with torch.no_grad():
        for path, t in leaves_with_paths(model.params):
            t.copy_(saved[path])
    del saved
    ref = m14_serve_reference(model, model.params, cfg, M14_MOE_SERVE)
    del model
    _free()
    return m14_serve_check(ref, [{"rank": rr["rank"],
                                  "moe_serve": rr["moe"]["moe_serve"]}
                                 for rr in res], "moe_serve", cfg)


def m14_clis():
    """(name, argv) of the serve CLI (granite-3-2b smoke, head dim 64,
    paged) and the three examples on the card, a few steps each."""
    d = str(M14_DIR / "examples")
    return [("serve CLI", ["-m", "repro_torch.launch.serve", "--arch",
                           "granite-3-2b", "--paged"]),
            ("quickstart", ["examples/torch_quickstart.py", "--steps", "4",
                            "--ckpt-dir", d + "/quickstart"]),
            ("train_lm", ["examples/torch_train_lm.py", "--steps", "4",
                          "--ckpt-dir", d + "/train_lm"]),
            ("serve_lm", ["examples/torch_serve_lm.py", "--chunked"])]


def phase_m14():
    """Sharded training on the card (M14a): four ranks on cuda:0 in a gloo
    world on make_debug_mesh(2, 2), granite-3-2b at full width with
    M14_LAYERS of its 40 layers, M14_STEPS steps of 4 x 2048 tokens
    through Trainer(mesh=, state_shardings=train_cell(...)).  Every
    rank's losses must equal rank 0's and the single-device Trainer's
    steps from the same seeded weights within M14_BARS; every rank
    launches K4 2 x layers and K5 layers times a step, on its 16 / 4 head
    shard, and nothing else; the checkpoint saved on the mesh restores
    without one with the same bits; the serve CLI and the three examples
    run once each (m14_clis), beside that restore.  The ranks then serve
    M14_SERVE's runs through the prefill and serve cells' steps (M14b,
    m14_serve), held against one device on the restored weights
    (m14_serve_check), and rank 0's dry run of the train cell counts the
    state collectives each rank made a step (m14_dryrun).  Then the MoE
    family in the same ranks (m14_moe_rank): olmoe-1b-7b at
    M14_MOE_LAYERS layers trains on the per-row dispatch and on the
    REPRO_MOE_A2A exchange (its factor from m14_moe_factor), each held
    against the single-device Trainer at its factor, run here beside the
    ranks (m14_moe_reference, m14_moe_check), and serves M14_MOE_SERVE
    against one device (m14_moe_serve_check).  Then the vlm and audio
    families in the same ranks (M14_VA, m14_va_rank): llava-next-34b at
    1 of 60 layers and whisper-base whole each serve through the cells'
    steps on their seeded weights and train M14_STEPS steps, against
    one device on the same weights, run before the ranks start
    (m14_va_reference, m14_va_check).  Four ranks on one card share its
    SMs and HBM, and gloo moves the collectives through host memory: the
    step times are not a speed of four cards.  Returns (e2e, captured,
    runs)."""
    import torch.multiprocessing as mp
    shutil.rmtree(M14_DIR, ignore_errors=True)
    M14_DIR.mkdir(parents=True)
    cfg, tc, batches = m14_setup()
    t0 = time.perf_counter()
    ref = m14_reference(cfg, tc, batches)
    ref_s = time.perf_counter() - t0
    moe_factor, moe_drops0 = m14_moe_factor()
    t0 = time.perf_counter()
    va_ref = m14_va_reference()
    va_ref_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec_ref = m14_rec_reference()
    rec_ref_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ctx = mp.start_processes(m14_rank, args=(M14_WORLD, moe_factor),
                             nprocs=M14_WORLD, join=False,
                             start_method="spawn")
    try:
        # the MoE runs' single-device references, beside the ranks
        t1 = time.perf_counter()
        moe_ref = m14_moe_reference(moe_factor)
        moe_ref_s = time.perf_counter() - t1
        _free()
        (M14_DIR / M14_VA_GO).write_text("")
        while not ctx.join(timeout=5):
            if time.perf_counter() - t0 > M14_JOIN_S:
                raise AssertionError(f"M14: the ranks did not finish in "
                                     f"{M14_JOIN_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    wall = time.perf_counter() - t0
    res = [json.loads((M14_DIR / f"rank{r}.json").read_text())
           for r in range(M14_WORLD)]
    L = cfg.n_layers
    want = {"K1": 0, "K2": 0, "K3": 0, "K4": 2 * L * M14_STEPS,
            "K5": L * M14_STEPS, "K6": 0, "K7": 0}
    losses0 = [(m["loss"], m["grad_norm"]) for m in res[0]["metrics"]]
    for rr in res:
        got = [(m["loss"], m["grad_norm"]) for m in rr["metrics"]]
        comm = rr["comm_per_step"][-1]
        log(f"# M14 rank {rr['rank']} {tuple(rr['coord'])}: losses / grad "
            f"norms {[(round(a, 5), round(b, 5)) for a, b in got]}; step "
            f"wall {[round(m['step_time_s'], 3) for m in rr['metrics']]} s; "
            f"kernel launches {rr['launches']}; collectives a step "
            + ", ".join(f"{k} {v['calls']} calls {v['bytes'] / 1e9:.3f} GB"
                        for k, v in sorted(comm.items()))
            + f"; peak {rr['peak_mem_gb']:.2f} GB; built in "
            f"{rr['build_s']:.1f} s")
        if got != losses0:
            raise AssertionError(f"M14: rank {rr['rank']}'s losses differ "
                                 f"from rank 0's")
        if rr["launches"] != want:
            raise AssertionError(f"M14: rank {rr['rank']} launched "
                                 f"{rr['launches']}, want {want}")
    for s, ((l_m, g_m), (l_r, g_r)) in enumerate(zip(losses0, ref)):
        dl, dg = abs(l_m - l_r), abs(g_m - g_r) / g_r
        log(f"# M14 step {s}: 2x2 mesh loss {l_m:.5f} / grad norm "
            f"{g_m:.5f}, single device {l_r:.5f} / {g_r:.5f}: |loss diff| "
            f"{dl:.2e} (bar {M14_BARS['loss']}), grad norm rel diff "
            f"{dg:.2e} (bar {M14_BARS['grad_norm']})")
        if not (np.isfinite(l_m) and dl <= M14_BARS["loss"]
                and dg <= M14_BARS["grad_norm"]):
            raise AssertionError(f"M14 step {s}: the mesh step and the "
                                 f"single-device step disagree")
    # the serve CLI and the three examples, on the card, each a process of
    # its own, started together and run beside the elastic check
    t1 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    clis = {name: subprocess.Popen(
        [sys.executable, *args], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for name, args in m14_clis()}
    n_leaves, serve_ref = m14_elastic(cfg, tc, res)
    log(f"# M14 elastic: the 2x2 checkpoint restored without a mesh, "
        f"{n_leaves} rank shards bit-equal (digests)")
    serving = m14_serve_check(serve_ref, res)
    del serve_ref
    # the dry run of the same train cell (rank 0, on the meta device in a
    # fake world) counts the collectives every rank made a step (the
    # pipeline's broadcast of the batch lies outside the step)
    dry = res[0]["dryrun"]
    for rr in res:
        step = {k: v for k, v in rr["comm_per_step"][-1].items()
                if k != "broadcast"}
        log(f"# M14 dry run against rank {rr['rank']}: state collectives "
            f"{dry['collectives_state']} / the card's {step}; arguments "
            f"{dry['memory']['argument_size_bytes'] / 1e9:.3f} GB a rank, "
            f"torch.cuda.memory_allocated() "
            f"{rr['allocated_after_state'] / 1e9:.3f} GB once the state "
            f"was placed (with the model's full tensors, the gather "
            f"target)")
        if step != dry["collectives_state"]:
            raise AssertionError("M14: the dry run's collectives differ "
                                 "from the card's")
    log(f"# M14 dry run: {dry['cost']['flops']:.4e} FLOPs, all collectives "
        f"{dry['collectives']}, kernels {dry['kernels']}, traced in "
        f"{dry['trace_s']} s")
    t1 = time.perf_counter()
    moe = m14_moe_check(res, moe_ref, moe_factor, moe_drops0)
    moe["serving"] = m14_moe_serve_check(res)
    moe.update(reference_s=moe_ref_s,
               checks_s=time.perf_counter() - t1, card=card())
    log(f"# M14 MoE: the single-device references took {moe_ref_s:.1f} s "
        f"beside the ranks, the checks and the serving reference "
        f"{moe['checks_s']:.1f} s; the ranks share one card, so no time "
        f"here is a speed of four cards; on {card()}")
    va = m14_va_check(res, va_ref)
    va.update(reference_s=va_ref_s, card=card())
    del va_ref
    log(f"# M14 vlm / audio: the single-device references took "
        f"{va_ref_s:.1f} s before the ranks started; on {card()}")
    rec = m14_rec_check(res, rec_ref)
    rec.update(reference_s=rec_ref_s, card=card())
    del rec_ref
    log(f"# M14 hybrid / ssm: the single-device references took "
        f"{rec_ref_s:.1f} s before the ranks started; on {card()}")
    shutil.rmtree(M14_DIR / "mesh", ignore_errors=True)
    lines = {}
    for name, p in clis.items():
        out, err = p.communicate(timeout=300)
        lines[name] = out.strip().splitlines()
        log(f"# M14 {name}: " + " | ".join(lines[name][-3:]))
        if p.returncode != 0 or not lines[name]:
            raise AssertionError(f"M14 {name} failed:\n{out[-2000:]}\n"
                                 f"{err[-2000:]}")
    cli_s = time.perf_counter() - t1
    line = lines["serve CLI"][-1]
    if not line.startswith("served 8 requests"):
        raise AssertionError(f"the serve CLI printed {line!r}")
    if not lines["train_lm"][-1].startswith("done at step 3"):
        raise AssertionError(f"torch_train_lm ended {lines['train_lm'][-1]!r}")
    log(f"# M14 the CLI and the examples ran in {cli_s:.1f} s beside the "
        f"elastic check")
    log(f"# M14: {M14_WORLD} ranks trained in {wall:.1f} s (spawn, build, "
        f"seeding, {M14_STEPS} steps and the checkpoint); the single-device "
        f"reference took {ref_s:.1f} s; on {card()}")
    e2e = {"config": cfg.name, "layers": L, "mesh": list(M14_MESH),
           "global_batch": M14_TRAIN["global_batch"],
           "seq_len": M14_TRAIN["seq_len"], "steps": M14_STEPS,
           "ranks_wall_s": wall, "reference_s": ref_s,
           "single_device": ref, "elastic_shards": n_leaves,
           "serve_cli": line, "cli_and_examples_s": cli_s, "card": card(),
           "serving": serving, "dryrun": dry, "moe": moe,
           "vlm_audio": va, "recurrent": rec,
           "ranks": [{k: v for k, v in rr.items()
                      if k not in ("digests", "serve", "dryrun", "moe",
                                   "va", "rec")}
                     for rr in res]}
    # the kernels at the shard's shape, bf16, for the timing phase: K4 and
    # K5 on (2, 2048, 16 / 4, 64)
    a5 = k5_training_args(torch.bfloat16, seed=3, shape=M14_SHARD)
    a4 = {k: a5[k] for k in ("q", "k", "v", "causal", "window")}
    captured = {"K4@m14_shard": ([], a4), "K5@m14_shard": ([], a5)}
    return e2e, captured, {
        "m14_rank0": {"launches": res[0]["launches"]},
        **{f"m14_moe_{run}_rank0": {"launches": res[0]["moe"][run]
                                    ["launches"]}
           for run, *_ in m14_moe_runs(moe_factor)},
        **{f"m14_{name}_rank0": {"launches": res[0]["va"][name]["launches"]}
           for name in M14_VA},
        **{f"m14_{name}_{dt}_rank0": {"launches": {
            k: sum(r["launches"][k] for r in res[0]["rec"][name][dt]
                   .values()) for k in COUNTERS}}
           for name in M14_REC for dt in M14_REC_DTYPES}}


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


def teacher_forced_check(model, params, finished, bar, images=None):
    """Every generated token of `finished` ((uid, prompt, generated
    tokens) each) must be the argmax of a teacher-forced kernel forward
    over the request's prompt and generated tokens at its position, or
    within `bar` of that argmax (a near tie).  images (n, P, d_model): the
    vlm family's image of each request, ahead of its prompt.  Returns the
    near ties."""
    ties = []
    for n, (uid, prompt, out) in enumerate(finished):
        seq = list(prompt) + list(out)
        batch = {"tokens": torch.tensor([seq[:-1]], dtype=torch.int32,
                                        device=model.device)}
        if images is not None:
            batch["vision_embeds"] = images[n:n + 1]
        logits = model.forward(params, batch)[0][0]
        start = logits.shape[0] - len(seq) + 1 + len(prompt) - 1
        for i, tok in enumerate(out):
            row = logits[start + i]
            top = int(torch.argmax(row))
            if top == tok:
                continue
            gap = float(row[top] - row[tok])
            if gap > bar:
                raise AssertionError(
                    f"request {uid} token {i}: generated {tok}, the "
                    f"teacher-forced forward's argmax is {top}, {gap:.3f} "
                    f"above it (bar {bar})")
            ties.append({"uid": uid, "index": i, "token": tok,
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
    eng, tick_s, syncs, wall, _ = run_traffic(
        model, params, "recurrent", True, scfg=REC_SCFG,
        waves=traffic("random", cfg.vocab_size, REC_PROMPTS))
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
    ties = teacher_forced_check(
        model, params, [(r.uid, r.prompt, r.out_tokens) for r in done],
        REC_F32_BARS[arch]) if check_tokens else None
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


def _scan_weight(t, *rest, **_):
    return t.numel()


def phase_recurrent():
    """zamba2-2.7b and rwkv6-1.6b at full width, REC_LAYERS of their
    layers.  bf16, the deployment
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
        cfg = get_config(arch).replace(n_layers=REC_LAYERS[arch])
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
# phase 3, the dense family at full width
# ---------------------------------------------------------------------------

# the dense family's other configurations at full width, one model at a
# time, seeded weights, bf16: the paper's OPT (MHA, sinusoidal positions)
# and QWEN (GQA group 7) and gemma3-4b (head dim 256, a 1024-position
# window on 5 of 6 layers, QK-norm) serve the chunked run's traffic
# (gemma3-4b also on the dense engine, K4 / K3); olmo-1b (K4 / K5 at head
# dim 128, MHA) and gemma3-4b (head dim 256, G 2, its windows) train
# DF_TRAIN_STEPS steps of the training phase's shape; granite-8b runs one
# forward of DF_FORWARD_BATCH tokens
DF_SERVE = {"opt-6.7b": ("chunked",), "qwen-7b": ("chunked",),
            "gemma3-4b": ("chunked", "dense")}
# the layers they serve with since PR 29, beside the MoE family's runs: a
# quarter of opt's 32 and qwen's 28, and 12 of gemma3-4b's 34, two of them
# global (one in every 6)
DF_SERVE_LAYERS = {"opt-6.7b": 8, "qwen-7b": 7, "gemma3-4b": 12}
DF_TRAIN_ARCHS, DF_TRAIN_STEPS = ("olmo-1b", "gemma3-4b"), 3
DF_FORWARD_ARCH, DF_FORWARD_BATCH = "granite-8b", (1, 2048)
# per engine: (kernel, module, wrapper, weight) captured in its warm-up run
DF_CAPTURE = {"chunked": (("K1", paged_prefill,
                           "batched_paged_prefill_attention", _k1_weight),
                          ("K2", flash_decode, "paged_flash_decode",
                           _lens_weight)),
              "dense": (("K4", flash_attention, "flash_attention_fwd",
                         _k4_weight),
                        ("K3", flash_decode, "flash_decode", _lens_weight))}


def _free():
    gc.collect()
    torch.cuda.empty_cache()


def _seeded_model(arch, n_layers=None):
    """The published config (with n_layers of its layers when given),
    seeded.  Returns (model, params, parameter count)."""
    cfg = get_config(arch)
    if n_layers:
        cfg = cfg.replace(n_layers=n_layers)
    t0 = time.perf_counter()
    model = build_model(cfg)
    params = model.init(seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"# {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.norm}, "
        f"{'rope' if cfg.use_rope else 'sinusoidal positions'}, "
        f"{n_params / 1e9:.2f} B params ({cfg.dtype}), built and seeded in "
        f"{time.perf_counter() - t0:.1f} s")
    return model, params, n_params


def dense_family_serving(arch):
    """The seeded model at full width, DF_SERVE_LAYERS[arch] of its
    layers, serves (serve_runs(DF_SERVE[arch])).  Returns (runs,
    captured, e2e, traces)."""
    model, params, n_params = _seeded_model(arch, DF_SERVE_LAYERS[arch])
    runs, captured, e2e, traces = serve_runs(model, params, arch,
                                             DF_SERVE[arch])
    e2e["params"] = n_params
    del model, params
    _free()
    return runs, captured, e2e, traces


def serve_runs(model, params, arch, names):
    """The model serves the chunked run's traffic on each engine of
    `names`: a warm-up run (the largest kernel calls captured), then a
    counted run (counted_run: launches n_layers x the engine's, 0
    implicit syncs), every generated token checked against a teacher-
    forced kernel forward at SERVED_TOKEN_BAR, and the traffic once more
    under the profiler.  Returns (runs, captured, e2e, traces)."""
    runs, captured, e2e, traces = {}, {}, {}, {}
    for run in names:
        caps = [Capture(mod, attr, w) for _, mod, attr, w in DF_CAPTURE[run]]
        with caps[0], caps[1]:
            run_traffic(model, params, run, count_syncs=False)
        for (key, *_), cap in zip(DF_CAPTURE[run], caps):
            captured[f"{key}@{arch}"] = cap.best
        got = counted_run(model, params, run)
        ties = teacher_forced_check(model, params, got["finished"],
                                    SERVED_TOKEN_BAR)
        log(f"# {arch} {run}: every generated token the teacher-forced "
            f"forward's argmax or within {SERVED_TOKEN_BAR:.2f} of it, near "
            f"ties {ties}")
        got["e2e"]["near_ties"] = ties
        name = f"{arch} {run}"
        runs[name], e2e[run] = got, got["e2e"]
        traces[name] = phase_trace(model, params, run, got["e2e"]["wall_s"])
    return runs, captured, e2e, traces


def train_flops(cfg, n_params, B, S):
    """Model FLOPs of one training step: 6 x params x tokens, plus 12 x
    batch x heads x head_dim x the attended (query, key) pairs of every
    layer under its window (S (S + 1) / 2 a causal layer)."""
    pairs = sum(cost.attention_pairs(S, S, True, T._windowed(cfg, g))
                for g in T._layer_windows(cfg))
    return 6 * n_params * B * S + 12 * B * cfg.n_heads * cfg.head_dim * pairs


def initial_loss(cfg) -> float:
    """The loss a seeded model starts from: ln(vocab) + sigma^2 / 2, the
    mean log-sum-exp over vocab Gaussian logits of variance sigma^2 (their
    mean is the target's expected logit, 0).  The final norm gives rows
    of unit RMS and the unembedding's entries are N(0, 0.02^2), so
    sigma^2 = 0.02^2 x d_model: 0.41 at d_model 2048, 1.43 at 7168."""
    return math.log(cfg.vocab_size) + 0.02 ** 2 * cfg.d_model / 2


def numpy_batch(cfg, B, S, device, seed=0):
    """A training batch of B rows of S positions seeded by numpy (the same
    in every process, unlike the pipeline's: ROADMAP §3): tokens, and for
    the vlm family frontend_tokens image embeddings (N(0, 0.02^2), in
    bfloat16 as the pipeline hands them over) ahead of S - frontend_tokens
    tokens."""
    rng = np.random.default_rng(seed)
    P = cfg.frontend_tokens
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (B, S - P), dtype=np.int32)).to(device)}
    if P:
        batch["vision_embeds"] = torch.from_numpy((rng.standard_normal(
            (B, P, cfg.d_model)) * 0.02).astype(np.float32)).to(
                device, torch.bfloat16)
    return batch


TRAIN_FLOPS_FORMULA = ("(6 * params * tokens + 12 * batch * heads * "
                       "head_dim * attended pairs of every layer under its "
                       "window) / (median step s * 989e12)")


def dense_family_training(arch, n_layers=None, train=TRAIN, bars=TRAIN_BARS,
                          flops_of=None, seeded_batches=False):
    """`arch` at its published widths (n_layers of its layers when given),
    TrainConfig(**train): one step's loss and gradient norm through the
    kernels against impl="ref" (train_check within `bars`, default
    TRAIN_BARS, on numpy_batch), then DF_TRAIN_STEPS counted steps on
    the pipeline's batches: K4 2 x
    n_layers and K5 n_layers launches a step, nothing else, finite losses
    from within 1 of initial_loss(cfg); one more step under the profiler.
    The largest K5 and K4 calls are kept as K5@<arch> and K4@<arch>_train.
    flops_of(cfg, n_params, B, S) -> (model FLOPs of a step, the MFU's
    formula), default train_flops's.  seeded_batches: the counted steps
    on numpy_batch's batches (seeds 1, 2, ...) in place of the
    pipeline's.  Returns (run, captured, e2e, trace)."""
    cfg = get_config(arch)
    if n_layers:
        cfg = cfg.replace(n_layers=n_layers)
    tcfg = TrainConfig(**train)
    B, S = tcfg.global_batch, tcfg.seq_len
    model = build_model(cfg)
    state = init_train_state(model, 0, tcfg)
    pipe = DataPipeline(cfg, tcfg)
    n_params = sum(p.numel() for p in leaves(state.params))
    log(f"# training {arch}: {cfg.n_layers} layers, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, "
        f"{cfg.norm}, vocab {cfg.vocab_size}, {n_params / 1e9:.3f} B "
        f"params, batch {B} x {S}, remat {tcfg.remat}")
    check = train_check(model, state.params,
                        numpy_batch(cfg, B, S, model.device), bars)
    step = make_train_step(model, tcfg)
    batches = [numpy_batch(cfg, B, S, model.device, seed=1 + s)
               if seeded_batches else pipe.device_batch(s)
               for s in range(DF_TRAIN_STEPS + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times, outs = [], []
    with Capture(flash_backward, "flash_attention_bwd", _k5_weight) as c5, \
            Capture(flash_attention, "flash_attention_fwd", _k4_weight) as c4:
        for b in batches[:DF_TRAIN_STEPS]:
            t = time.perf_counter()
            state, m = step(state, b)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            outs.append(m)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    L, N = cfg.n_layers, DF_TRAIN_STEPS
    want = {k: 0 for k in COUNTERS}
    want.update(K4=2 * L * N, K5=L * N)
    losses = [float(m["loss"]) for m in outs]
    gnorms = [float(m["grad_norm"]) for m in outs]
    lr = [float(m["lr"]) for m in outs]
    start = initial_loss(cfg)
    log(f"# {arch} training: {N} steps, kernel launches {launches} "
        f"(want {want}), losses {[round(x, 4) for x in losses]} at lr "
        f"{lr}, initial_loss {start:.4f} (ln(vocab) "
        f"{math.log(cfg.vocab_size):.4f}), step ms "
        f"{[round(t * 1e3, 1) for t in times]}, peak memory "
        f"{peak / 1e9:.2f} GB (1e9 bytes)")
    if launches != want:
        raise AssertionError(f"{arch} training launches {launches} != "
                             f"{want}")
    if not all(np.isfinite(losses + gnorms)) or abs(losses[0] - start) > 1.0:
        raise AssertionError(f"{arch} training: losses {losses} not finite "
                             f"from near initial_loss {start:.3f}")
    trace = device_trace(lambda: step(state, batches[-1]))
    trace.update(run=f"{arch} train", steps=1)
    med = float(np.median(times[1:]))
    flops, formula = flops_of(cfg, n_params, B, S) if flops_of else (
        train_flops(cfg, n_params, B, S), TRAIN_FLOPS_FORMULA)
    e2e = {"config": cfg.name, "layers": cfg.n_layers, "params": n_params,
           "global_batch": B, "seq_len": S, "remat": tcfg.remat, "steps": N,
           "step_ms": [t * 1e3 for t in times],
           "step_ms_median_after_first": med * 1e3,
           "tokens_per_s": B * S / med, "peak_mem_gb": peak / 1e9,
           "model_flops_per_step": flops,
           "mfu": flops / (med * PEAK_FLOP_S), "mfu_formula": formula,
           "losses": losses, "grad_norms": gnorms, "lr": lr,
           "kernel_launches": launches,
           "kernels_vs_ref": {"loss": [check[None][0], check["ref"][0]],
                              "grad_norm": [check[None][1],
                                            check["ref"][1]]}}
    log(f"# {arch} training: median step {med * 1e3:.1f} ms, "
        f"{B * S / med:.0f} tokens/s, mfu {e2e['mfu']:.3f}; trace: device "
        f"busy {trace['device_busy_s']:.3f} s of "
        f"{trace['profiled_wall_s']:.3f} s")
    del state, model, step, batches
    _free()
    return {"launches": launches}, {f"K5@{arch}": c5.best,
                                    f"K4@{arch}_train": c4.best}, e2e, trace


def dense_family_forward():
    """granite-8b at full width: one forward of a numpy-seeded
    DF_FORWARD_BATCH batch through the kernels (K4 n_layers launches,
    nothing else) against impl="ref" within MODEL_BARS["forward"], then 3
    timed forwards."""
    model, params, n_params = _seeded_model(DF_FORWARD_ARCH)
    cfg = model.cfg
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, DF_FORWARD_BATCH, dtype=np.int32)).to(
            model.device)}
    torch.cuda.synchronize()
    reset_counts()
    with Capture(flash_attention, "flash_attention_fwd", _k4_weight) as c4:
        got = model.forward(params, batch)[0]
        torch.cuda.synchronize()
    launches = read_counts()
    want = {k: 0 for k in COUNTERS}
    want["K4"] = cfg.n_layers
    if launches != want or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{DF_FORWARD_ARCH} forward: launches "
                             f"{launches} (want {want}) or non-finite logits")
    ref = model.forward(params, batch, impl="ref")[0]
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    del got, ref
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.forward(params, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    bar = MODEL_BARS["forward"]
    log(f"# {DF_FORWARD_ARCH} forward {DF_FORWARD_BATCH}: kernel launches "
        f"{launches}, logits max |kernels - ref| {err:.3e} (bf16 bar {bar}, "
        f"logit scale {scale:.2f}), {med * 1e3:.1f} ms")
    if err > bar:
        raise AssertionError(f"{DF_FORWARD_ARCH} forward: kernels and ref "
                             f"disagree")
    e2e = {"config": cfg.name, "params": n_params,
           "batch": list(DF_FORWARD_BATCH), "kernel_launches": launches,
           "logits_max_abs_err": err, "logit_scale": scale,
           "forward_ms": [t * 1e3 for t in times],
           "forward_ms_median": med * 1e3,
           "tokens_per_s": DF_FORWARD_BATCH[0] * DF_FORWARD_BATCH[1] / med}
    del model, params
    _free()
    return {"launches": launches}, {f"K4@{DF_FORWARD_ARCH}": c4.best}, e2e


def phase_dense_family():
    """The served models, the training runs and granite-8b's forward, one
    model at a time.  Returns (runs, captured, e2e, traces)."""
    runs, captured, e2e, traces = {}, {}, {}, {}
    for arch in DF_SERVE:
        r, c, e2e[arch], t = dense_family_serving(arch)
        runs.update(r)
        captured.update(c)
        traces.update(t)
    for arch in DF_TRAIN_ARCHS:
        r, c, e, traces[f"{arch} train"] = dense_family_training(arch)
        e2e.setdefault(arch, {})["train"] = e
        runs[f"{arch} train"] = r
        captured.update(c)
    r, c, e2e[DF_FORWARD_ARCH] = dense_family_forward()
    runs[f"{DF_FORWARD_ARCH} forward"] = r
    captured.update(c)
    return runs, captured, e2e, traces


# ---------------------------------------------------------------------------
# phase 3, sequence-parallel decode (M11)
# ---------------------------------------------------------------------------

# the long-context decode the JAX package's seq-sharded cache layout is
# for: granite-3-2b at full width, batch 1, a M11_CONTEXT-token prompt
# prefilled into a dense cache (2.7 GB of bf16 K/V), then M11_STEPS greedy
# steps through K3 and through ops.decode_attention_naive; the partials
# are held against K3 over M11_SLICES slices of one layer's strips
M11_CONTEXT, M11_STEPS, M11_SLICES = 32768, 16, 4
# float32: a greedy token of the seq-parallel decode that is not K3's must
# be within NEAR_TIE of the top logit of K3's decode fed the same tokens
# (the engines' teacher-forced near-tie rule, tests/traffic.py), and the
# logits within M11_F32_BAR of K3's (5.7e-6 measured on an H100 80GB HBM3,
# 700 W; the tokens equal).  In bf16 the two paths part by one rounding
# of the attention output, amplified through 40 layers (0.0773, the
# MODEL_BARS entry), so there a differing token is held to the bar of a
# served bf16 token, SERVED_TOKEN_BAR (measured: one differing token, at
# step 12, 0.035 below the top)
NEAR_TIE = 2e-3
M11_F32_BAR = 1e-5


def _merged_partials(q, kc, vc, lens, n):
    """_decode_partials over n equal slices of the strips (the last one
    shorter), merged as seq_parallel_decode merges the gathered partials:
    the single-process form of an n-rank world."""
    S = kc.shape[1]
    per = -(-S // n)
    parts = [ops._decode_partials(q, kc[:, r * per:(r + 1) * per],
                                  vc[:, r * per:(r + 1) * per],
                                  torch.clamp(lens - r * per, 0, per))
             for r in range(n)]
    m, l, o = (torch.stack(t) for t in zip(*parts))
    _, l_c, o_c = ops.ref.combine_partial_softmax(m, l, o)
    B, _, Hq, D = q.shape
    o = o_c / torch.clamp_min(l_c, 1e-20)[..., None]
    return o.reshape(B, 1, Hq, D).to(q.dtype)


def _one_rank_nccl(fn):
    """fn() inside a one-rank NCCL process group on this card (the
    rendezvous on a free localhost port), destroyed after."""
    import socket

    import torch.distributed as dist
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        return fn()
    finally:
        dist.destroy_process_group()


def m11_partials_check(model, cache, lens):
    """The M11 functions against K3 over layer 0's strips, one query of
    the model's shape: the partials over M11_SLICES slices, merged, and
    seq_parallel_decode in a one-rank NCCL group; bf16 within one output
    rounding step, and on float32 copies of the strips within 1e-5."""
    cfg = model.cfg
    g = torch.Generator(device=model.device).manual_seed(5)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn((1, 1, cfg.n_heads, cfg.head_dim), generator=g,
                        device=model.device).to(dtype)
        kc, vc = cache["k"][0].to(dtype), cache["v"][0].to(dtype)
        want = ops.flash_decode(q, kc, vc, lens)
        merged = _merged_partials(q, kc, vc, lens, M11_SLICES)
        gathered = _one_rank_nccl(
            lambda: ops.seq_parallel_decode(q, kc, vc, lens))
        out[str(dtype)[6:]] = {
            "partials_merged": compare(merged, want, dtype),
            "seq_parallel_decode_nccl": compare(gathered, want, dtype)}
        del kc, vc
    log(f"# M11 over layer 0's {lens.tolist()[0]} positions: "
        f"_decode_partials on {M11_SLICES} slices merged, and "
        f"seq_parallel_decode in a one-rank NCCL group (all_gather_into_"
        f"tensor on the card), against K3: max abs err {out} (bar bf16 "
        f"2^-7 rel + 1e-6, float32 1e-5)")
    return out


def _greedy_decode(model, params, cache, lens, first, n, seq_parallel,
                   forced=None):
    """n decode steps from `first` (B, 1): each step's input the argmax
    of the step before, or forced[i - 1] (teacher forcing: forced[i] is
    the input after step i), each through serve_step.make_serve_step.
    Counted: the kernel launches, the implicit host syncs (sync debug
    mode), the wall time.  Returns (logits (n B, V) and tokens [n B],
    step-major; launches, syncs, wall s)."""
    tok, logits, toks = first, [], []
    step = serve_step.make_serve_step(model, seq_parallel=seq_parallel)
    # the first switch into the sync debug mode in a process warns, once,
    # that the mode is a prototype: switched here, that notice is not
    # counted as a sync
    torch.cuda.set_sync_debug_mode("warn")
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    reset_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        t0 = time.perf_counter()
        try:
            for i in range(n):
                lg, _ = step(params, cache, tok, lens + i)
                logits.append(lg[:, -1])
                nxt = torch.argmax(lg[:, -1], -1, keepdim=True).to(
                    torch.int32)
                toks.append(nxt)
                tok = nxt if forced is None else forced[i]
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    where = [f"{w.filename}:{w.lineno} {str(w.message)[:120]}"
             for w in caught if "synchroniz" in str(w.message)]
    if where:
        log(f"# implicit syncs at {where}")
    return (torch.cat(logits), [int(t) for t in torch.cat(toks)[:, 0]],
            launches, len(where), wall)


def m11_decode(model, params, cache, lens, first, tie_bar, logit_bar):
    """M11_STEPS greedy decode steps with seq_parallel=True (from a copy
    of the cache) and through K3 (on the cache itself), counted; where the
    tokens differ, K3 once more fed the seq-parallel tokens.  Raises
    unless the seq-parallel logits lie within logit_bar of K3's on the
    same inputs, every seq-parallel token is K3's or within tie_bar of the
    top of K3's logits on the same inputs, K3 launched n_layers x
    M11_STEPS times and nothing else, the naive decode launched nothing,
    and neither loop synchronised.  Returns the e2e fields."""
    cfg = model.cfg
    sp_cache = {k: v.clone() for k, v in cache.items()}
    sp = _greedy_decode(model, params, sp_cache, lens, first, M11_STEPS,
                        True)
    del sp_cache
    k3 = _greedy_decode(model, params, cache, lens, first, M11_STEPS, False)
    forced = [torch.tensor([[t]], dtype=torch.int32, device=model.device)
              for t in sp[1]]
    tf = k3 if sp[1] == k3[1] else _greedy_decode(
        model, params, cache, lens, first, M11_STEPS, False, forced=forced)
    err = float((sp[0] - tf[0]).abs().max())
    gaps = [float(tf[0][i].max() - tf[0][i][t])
            for i, t in enumerate(sp[1])]
    none = {k: 0 for k in COUNTERS}
    want_k3 = dict(none, K3=cfg.n_layers * M11_STEPS)
    ms = (sp[4] / M11_STEPS * 1e3, k3[4] / M11_STEPS * 1e3)
    dtype = cfg.dtype
    log(f"# M11 decode ({dtype}), {M11_STEPS} greedy steps at "
        f"{M11_CONTEXT}+: tokens equal {sp[1] == k3[1]}, seq-parallel "
        f"logits vs K3's (fed the same tokens) max |diff| {err:.3e} (bar "
        f"{logit_bar}), largest gap of a seq-parallel token below the top "
        f"of K3's logits {max(gaps):.3e} (bar {tie_bar}); kernel launches "
        f"seq-parallel {sp[2]}, K3 {k3[2]}; implicit syncs {sp[3]} / "
        f"{k3[3]}; step ms naive {ms[0]:.2f}, K3 {ms[1]:.2f}")
    if sp[2] != none or k3[2] != want_k3:
        raise AssertionError(f"M11 launches {sp[2]} / {k3[2]}, want "
                             f"{none} / {want_k3}")
    if sp[3] or k3[3]:
        raise AssertionError("M11: implicit host syncs in the decode loop")
    if not bool(torch.isfinite(sp[0]).all()) or err > logit_bar:
        raise AssertionError("M11: seq-parallel logits and K3's disagree")
    if max(gaps) > tie_bar:
        raise AssertionError(f"M11: greedy tokens differ past a near tie: "
                             f"{sp[1]} vs {k3[1]}")
    return {"step_ms_seq_parallel_naive": ms[0], "step_ms_k3": ms[1],
            "tokens_equal": sp[1] == k3[1], "tokens_seq_parallel": sp[1],
            "tokens_k3": k3[1], "logits_max_abs_diff": err,
            "largest_gap": max(gaps), "implicit_syncs": sp[3] + k3[3],
            "kernel_launches": {"seq_parallel": sp[2], "k3": k3[2]}}


def phase_m11(model, params):
    """granite-3-2b at full width, batch 1: a M11_CONTEXT-token prompt
    prefilled (K4) into a dense cache; the partials and the one-rank NCCL
    seq_parallel_decode against K3 (m11_partials_check); then m11_decode
    in bf16 - the logits within MODEL_BARS["seq-parallel decode step"],
    a differing token within SERVED_TOKEN_BAR, the bar of a served bf16
    token against a teacher-forced one - and, from the same prefilled
    cache and first token, in float32 (the model's weights and the cache
    cast, exactly), where a differing token must be a near tie within
    NEAR_TIE and the logits within M11_F32_BAR.  Returns (runs, e2e)."""
    cfg = model.cfg
    rng = np.random.default_rng(11)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (
        1, M11_CONTEXT), dtype=np.int32)).to(model.device)
    cache = model.init_cache(1, M11_CONTEXT + M11_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lp, cache, lens = model.prefill(params, {"tokens": toks}, cache)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    kv_gb = sum(t.numel() * t.element_size() for t in cache.values()) / 1e9
    log(f"# M11: granite-3-2b prefilled {M11_CONTEXT} tokens into a dense "
        f"cache of {kv_gb:.2f} GB in {prefill_s:.2f} s")
    first = torch.argmax(lp[:, -1], -1, keepdim=True).to(torch.int32)
    cache32 = {k: v.float() for k, v in cache.items()}
    bf16 = m11_decode(model, params, cache, lens, first, SERVED_TOKEN_BAR,
                      MODEL_BARS["seq-parallel decode step"])
    # the decode wrote past lens only: positions [0, lens) are the prompt's
    parity = m11_partials_check(model, cache, lens)
    del cache
    _free()
    m32, p32 = fp32_copy(model, params)
    f32 = m11_decode(m32, p32, cache32, lens, first, NEAR_TIE, M11_F32_BAR)
    del m32, p32, cache32
    _free()
    e2e = {"config": cfg.name, "context": M11_CONTEXT, "steps": M11_STEPS,
           "kv_cache_gb": kv_gb, "prefill_s": prefill_s, "parity": parity,
           "bfloat16": bf16, "float32": f32,
           "note": "one card: the all-gather runs in a one-rank NCCL group; "
                   "traffic between cards is not measured"}
    runs = {"m11 seq_parallel": {"launches": bf16["kernel_launches"][
        "seq_parallel"]}, "m11 k3": {"launches": bf16["kernel_launches"][
            "k3"]}}
    return runs, e2e


# ---------------------------------------------------------------------------
# phase 3, whisper-base (M13 encoder-decoder, M9 cross-attention)
# ---------------------------------------------------------------------------

# 16 clips of whisper's 30 s window after its conv frontend (1500 frames;
# the frontend is a stub, as in the JAX package), a 4-token decoder prompt
# and 124 greedy tokens in its 448-token text context; training 3 steps of
# 8 x 1500 (the pipeline gives audio and tokens one length); the engine: 4
# requests on 2 slots, dense, stepwise, and each alone
WHISPER = "whisper-base"
W_CLIPS, W_FRAMES, W_PROMPT, W_NEW, W_TEXT = 16, 1500, 4, 124, 448
W_TRAIN = dict(global_batch=8, seq_len=1500, remat="full", warmup_steps=2,
               total_steps=100)
W_TRAIN_STEPS = 3
W_ENGINE_PROMPTS, W_ENGINE_NEW = (4, 9, 17, 30), 16
W_SCFG = dict(max_batch=2, max_seq=W_TEXT, max_new_tokens=W_ENGINE_NEW,
              paged=False, chunked=False)


def _q_len_weight(same: bool):
    """K4 calls with Sq == Skv (self-attention, the encoder) or Sq != Skv
    (cross-attention), by their work; the others -1 (never kept)."""
    def weight(q, k, v, **_):
        return _k4_weight(q, k, v) if (q.shape[1] == k.shape[1]) == same \
            else -1
    return weight


def _strip_weight(S: int):
    """K3 calls over strips of S positions, by their lengths."""
    def weight(q, kc, vc, *rest, **kw):
        return _lens_weight(q, kc, vc, *rest, **kw) if kc.shape[1] == S \
            else -1
    return weight


def whisper_serving(model, params):
    """W_CLIPS clips through init_cache(W_CLIPS, W_TEXT, enc_len=W_FRAMES),
    prefill and W_NEW greedy decode steps (counted: K4 3 x layers in the
    prefill, K3 2 x layers a step, nothing else; 0 implicit syncs in the
    decode loop); the prefill's logits against Model.forward's, each
    step's against a teacher-forced forward over prompt plus output.
    Returns (runs, captured, e2e)."""
    cfg = model.cfg
    rng = np.random.default_rng(12)
    audio = torch.from_numpy((rng.standard_normal(
        (W_CLIPS, W_FRAMES, cfg.d_model)) * 0.02).astype(np.float32)).to(
            model.device, torch.bfloat16)
    prompt = torch.from_numpy(rng.integers(1, cfg.vocab_size, (
        W_CLIPS, W_PROMPT), dtype=np.int32)).to(model.device)
    batch = {"tokens": prompt, "audio_embeds": audio}
    argmax = lambda lg: torch.argmax(lg[:, -1], -1, keepdim=True).to(
        torch.int32)
    # a warm-up pass keeps the largest K4 (encoder, cross) and K3 (self,
    # cross) calls; a Capture weighs a K3 call by its lengths, on the host,
    # so it runs outside the counted pass.  Each Capture wraps the wrapper
    # as it finds it: two on one wrapper are made one after the other
    with contextlib.ExitStack() as stack:
        caps = [stack.enter_context(Capture(mod, attr, weight))
                for mod, attr, weight in (
                    (flash_attention, "flash_attention_fwd",
                     _q_len_weight(True)),
                    (flash_attention, "flash_attention_fwd",
                     _q_len_weight(False)),
                    (flash_decode, "flash_decode", _strip_weight(W_TEXT)),
                    (flash_decode, "flash_decode",
                     _strip_weight(W_FRAMES)))]
        cache = model.init_cache(W_CLIPS, W_TEXT, enc_len=W_FRAMES)
        lp, cache, lens = model.prefill(params, batch, cache)
        tok = argmax(lp)
        for i in range(W_NEW):
            tok = argmax(model.decode_step(params, tok, lens + i, cache)[0])
    cache = model.init_cache(W_CLIPS, W_TEXT, enc_len=W_FRAMES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    lp, cache, lens = model.prefill(params, batch, cache)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    pre = read_counts()
    first = argmax(lp)
    logits, toks, dec, syncs, wall = _greedy_decode(
        model, params, cache, lens, first, W_NEW, False)
    peak = torch.cuda.max_memory_allocated()
    L = cfg.n_layers
    want_pre = dict({k: 0 for k in COUNTERS},
                    K4=cfg.encoder_layers + 2 * L)
    want_dec = dict({k: 0 for k in COUNTERS}, K3=2 * L * W_NEW)
    if pre != want_pre or dec != want_dec or syncs:
        raise AssertionError(f"whisper serving: launches {pre} / {dec} "
                             f"(want {want_pre} / {want_dec}), {syncs} "
                             f"implicit syncs")
    # logits (W_NEW, V) per clip are rows i * W_CLIPS + b of `logits`
    steps = logits.view(W_NEW, W_CLIPS, -1).transpose(0, 1)
    out = torch.tensor(toks, device=model.device).view(W_NEW, W_CLIPS).t()
    fwd = model.forward(params, batch)[0]
    err_pre = float((lp[:, -1] - fwd[:, -1]).abs().max())
    seq = torch.cat([prompt, first, out[:, :-1].to(torch.int32)], 1)
    tf = model.forward(params, {"tokens": seq, "audio_embeds": audio})[0]
    err_dec = float((steps - tf[:, W_PROMPT:]).abs().max())
    scale = float(tf.abs().max())
    del fwd, tf
    bars = (MODEL_BARS["whisper prefill"], MODEL_BARS["whisper decode step"])
    n_tok = W_CLIPS * W_NEW
    log(f"# whisper serving: {W_CLIPS} clips x {W_FRAMES} frames, prompt "
        f"{W_PROMPT}, {W_NEW} greedy tokens each: prefill "
        f"{prefill_s * 1e3:.1f} ms, kernel launches {pre}; decode "
        f"{wall / W_NEW * 1e3:.2f} "
        f"ms a step, {n_tok / wall:.0f} tokens/s, kernel launches {dec}, "
        f"implicit syncs {syncs}; peak {peak / 1e9:.2f} GB; logits max "
        f"|prefill - forward| {err_pre:.3e} (bar {bars[0]}), |decode - "
        f"teacher-forced forward| {err_dec:.3e} (bar {bars[1]}), logit "
        f"scale {scale:.2f}")
    if not bool(torch.isfinite(steps).all()) or err_pre > bars[0] \
            or err_dec > bars[1]:
        raise AssertionError("whisper serving: logits disagree with the "
                             "forward")
    e2e = {"clips": W_CLIPS, "frames": W_FRAMES, "prompt": W_PROMPT,
           "new_tokens": W_NEW, "text_context": W_TEXT,
           "prefill_ms": prefill_s * 1e3, "decode_step_ms":
           wall / W_NEW * 1e3, "decode_tokens_per_s": n_tok / wall,
           "peak_mem_gb": peak / 1e9, "prefill_launches": pre,
           "decode_launches": dec, "implicit_syncs": syncs,
           "prefill_vs_forward": err_pre, "decode_vs_forward": err_dec,
           "logit_scale": scale}
    captured = {f"K4@{WHISPER}_encoder": caps[0].best,
                f"K4@{WHISPER}_cross": caps[1].best,
                f"K3@{WHISPER}_self": caps[2].best,
                f"K3@{WHISPER}_cross": caps[3].best}
    runs = {"whisper prefill": {"launches": pre},
            "whisper decode": {"launches": dec}}
    return runs, captured, e2e


def whisper_train_flops(cfg, n_params, B, S):
    """Model FLOPs of one whisper training step with S frames and S
    tokens a row: 6 x params x the row's S (each parameter touches one
    frame or one token: the encoder's frames, the decoder's and the
    unembedding's tokens), plus 12 x batch x heads x head_dim x the
    attended pairs: the encoder's and the cross-attention's S^2 a layer,
    the decoder self-attention's S (S + 1) / 2."""
    pairs = cfg.encoder_layers * S * S + cfg.n_layers * (
        S * S + S * (S + 1) // 2)
    return 6 * n_params * B * S + 12 * B * cfg.n_heads * cfg.head_dim * pairs


def whisper_training():
    """W_TRAIN_STEPS steps of the pipeline's batches (audio frames and
    tokens of one length): K4 (encoder + decoder self + cross, and the
    decoder's again under remat) and K5 (every attention) launches, finite
    losses from near ln(vocab), step time, MFU and peak memory.  Returns
    (run, captured, e2e)."""
    cfg = get_config(WHISPER)
    tcfg = TrainConfig(**W_TRAIN)
    B, S = tcfg.global_batch, tcfg.seq_len
    model = build_model(cfg)
    state = init_train_state(model, 0, tcfg)
    pipe = DataPipeline(cfg, tcfg)
    n_params = sum(p.numel() for p in leaves(state.params))
    step = make_train_step(model, tcfg)
    batches = [pipe.device_batch(s) for s in range(W_TRAIN_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times, outs = [], []
    with Capture(flash_backward, "flash_attention_bwd", _k5_weight) as c5:
        for b in batches:
            t = time.perf_counter()
            state, m = step(state, b)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            outs.append(m)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    E, L, N = cfg.encoder_layers, cfg.n_layers, W_TRAIN_STEPS
    want = dict({k: 0 for k in COUNTERS}, K4=(E + 4 * L) * N,
                K5=(E + 2 * L) * N)
    losses = [float(m["loss"]) for m in outs]
    gnorms = [float(m["grad_norm"]) for m in outs]
    ln_v = math.log(cfg.vocab_size)
    med = float(np.median(times[1:]))
    flops = whisper_train_flops(cfg, n_params, B, S)
    log(f"# whisper training: {N} steps of {B} x {S} (frames and tokens), "
        f"remat {tcfg.remat}, {n_params / 1e6:.1f} M params: kernel "
        f"launches {launches} (want {want}), losses "
        f"{[round(x, 4) for x in losses]}, ln(vocab) {ln_v:.4f}, step ms "
        f"{[round(t * 1e3, 1) for t in times]}, {B * S / med:.0f} tokens/s, "
        f"mfu {flops / (med * PEAK_FLOP_S):.3f}, peak {peak / 1e9:.2f} GB")
    if launches != want:
        raise AssertionError(f"whisper training launches {launches} != "
                             f"{want}")
    if not all(np.isfinite(losses + gnorms)) or abs(losses[0] - ln_v) > 1.0:
        raise AssertionError(f"whisper training: losses {losses} not finite "
                             f"from near ln(vocab)")
    e2e = {"config": cfg.name, "params": n_params, "global_batch": B,
           "seq_len": S, "remat": tcfg.remat, "steps": N,
           "step_ms": [t * 1e3 for t in times],
           "step_ms_median_after_first": med * 1e3,
           "tokens_per_s": B * S / med, "peak_mem_gb": peak / 1e9,
           "model_flops_per_step": flops,
           "mfu": flops / (med * PEAK_FLOP_S),
           "mfu_formula": "(6 * params * batch * seq + 12 * batch * heads "
                          "* head_dim * (encoder and cross layers x seq^2 "
                          "+ decoder layers x seq (seq + 1) / 2)) / (median "
                          "step s after the first * 989e12)",
           "losses": losses, "grad_norms": gnorms,
           "kernel_launches": launches}
    del state, model, step, batches
    _free()
    return {"launches": launches}, {f"K5@{WHISPER}_train": c5.best}, e2e


def whisper_engine(model, params):
    """The 4 requests through ServeEngine (dense, stepwise admission, 2
    slots), counted (K3 2 x layers per decode step, nothing else; 0
    implicit syncs in the ticks); each request again alone on an engine
    of the same config: the outputs equal (one request's lane computes
    the same bits beside another lane or an idle one)."""
    cfg = model.cfg
    rng = np.random.default_rng(13)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in W_ENGINE_PROMPTS]
    reset_counts()
    eng, tick_s, syncs, wall, _ = run_traffic(
        model, params, "whisper", True, scfg=W_SCFG,
        waves=[[(0, p, 0) for p in prompts]])
    launches = read_counts()
    got = {r.uid: r.out_tokens for r in eng.sched.finished}
    steps = eng.jit_calls
    want = dict({k: 0 for k in COUNTERS}, K3=2 * cfg.n_layers * steps)
    alone = []
    for p in prompts:
        e, *_ = run_traffic(model, params, "whisper", False, scfg=W_SCFG,
                            waves=[[(0, p, 0)]])
        alone.append(e.sched.finished[0].out_tokens)
    equal = sum(got[uid] == out for uid, out in
                zip(sorted(got), alone))
    log(f"# whisper engine: {len(got)} requests x {W_ENGINE_NEW} tokens on "
        f"{W_SCFG['max_batch']} slots in {len(tick_s)} ticks, {steps} decode "
        f"steps, kernel launches {launches} (want {want}), implicit syncs "
        f"{syncs}; {equal} of {len(prompts)} requests equal to the request "
        f"served alone")
    if launches != want or syncs or equal != len(prompts) or any(
            len(o) != W_ENGINE_NEW for o in got.values()):
        raise AssertionError("whisper engine: launches, syncs or outputs")
    stats = eng.stats()
    return {"launches": launches}, {
        "requests": len(got), "ticks": len(tick_s), "decode_steps": steps,
        "wall_s": wall, "gen_tok_s": stats["gen_tokens"] / wall,
        "tick_ms_median": float(np.median(tick_s)) * 1e3,
        "kernel_launches": launches, "implicit_syncs": syncs,
        "requests_equal_alone": equal}


def phase_whisper():
    """whisper-base at full width: serving through the model's entry
    points, the engine, then training.  Returns (runs, captured, e2e)."""
    model, params, n_params = _seeded_model(WHISPER)
    runs, captured, e2e = whisper_serving(model, params)
    e2e = {"params": n_params, "serving": e2e}
    runs["whisper engine"], e2e["engine"] = whisper_engine(model, params)
    del model, params
    _free()
    runs["whisper train"], c, e2e["train"] = whisper_training()
    captured.update(c)
    return runs, captured, e2e


# ---------------------------------------------------------------------------
# phase 3, the MoE family (M13)
# ---------------------------------------------------------------------------

# olmoe-1b-7b at full width and depth; qwen3-moe-235b-a22b at its published
# widths with MOE_LAYERS of its 94 layers (one layer is 4.98 GB of bf16
# weights: the whole model, ~470 GB, does not fit one card; 8 layers are
# 42.3 GB).  Each serves the chunked run's traffic (RUNS["chunked"])
MOE_ARCHS = ("olmoe-1b-7b", "qwen3-moe-235b-a22b")
MOE_LAYERS = {"qwen3-moe-235b-a22b": 8}
# the one-rank NCCL a2a against moe_ffn: a capacity factor at which
# nothing drops in either (both capacities then exceed every count)
MOE_A2A_FACTOR = 8.0
# olmoe-1b-7b's training on one card: 8 of its 16 layers, 3.56 B
# parameters, ~43 GB of bf16 weights and gradients and float32 AdamW
# moments (its whole state, ~90 GB, does not fit the card)
MOE_TRAIN_LAYERS = 8
# a served MoE run against the same engine and traffic through
# impl="ref", event by event up to the first event where the two part
# (moe_events_check): the router probabilities of each moe_ffn call and
# the logits of each sampling call.  bf16: the ref run takes the kernel
# run's routing (see Routing), so the two part only through rounding;
# float32 (olmoe's float32 copy): each run routes on its own.  Bars:
# max |probability difference| and max |logit difference| over the live
# rows; the logits in bf16 at the chunk batch's and decode step's
# MODEL_BARS.  Measured on an H100 80GB HBM3 (700 W), deterministic for
# the seeded weights but for the float32 logits: bf16 probabilities
# 0.0050 (olmoe) and 0.0022 (qwen3-moe), logits 0.039 and 0.049; float32
# probabilities 9.8e-7, logits 5.1e-6 and 8.0e-6 in two calls; each bar
# ~2-2.5x the larger measurement
MOE_PROB_BARS = {"bfloat16": 0.01, "float32": 2e-6}
MOE_LOGIT_BARS = {"bfloat16": MODEL_BARS["chunk batch"], "float32": 2e-5}
# the MoE layer alone in bf16 against the same function on float32 copies
# of its operands (the same routing: the router reads x in float32 either
# way): within four bf16 rounding steps of the output's largest |entry|
MOE_LAYER_RTOL = 2.0 ** -5


def _gap(p: torch.Tensor, K: int) -> float:
    """The least gap between neighbours of the top K + 1 of p (E,)."""
    top = torch.sort(p.float(), descending=True).values[:K + 1]
    return float((top[:-1] - top[1:]).min())


class Routing:
    """Wraps repro_torch.models.moe.moe_ffn, the serving steps' sampler
    and the engine's chunk-batch and decode steps for one run, recording
    in call order, on the card (no host sync), ("moe", router
    probabilities, top_idx, live) per MoE call and ("sample", logits,
    live) per sampling call.  live marks what the engine keeps: in a
    decode step its live lanes, in a chunk batch each row's real
    positions (a sampling call: the rows with any); None outside the
    engine.  A lane that is not live may read pages its slot does not own
    yet (the null page, which every idle lane writes), so its values
    differ from run to run; capacity is per row and a row's pad positions
    follow its real ones, so neither reaches what is kept.  With
    `forced` (the top_idx of another run's MoE calls, or after replay()
    this run's so far) each MoE call takes the top_idx of the call of the
    same index, its gates renormalised from its own probabilities at
    those experts: teacher-forced routing; its own top_idx is still what
    it records."""

    def __init__(self, forced=None):
        self.events, self.forced, self._i = [], forced, 0
        self._live = None

    def replay(self):
        self.forced = [e[2] for e in self.events if e[0] == "moe"]
        self.events, self._i = [], 0

    def __enter__(self):
        self._saved = [(moe, "moe_ffn", moe.moe_ffn),
                       (serve_step, "sample_token", serve_step.sample_token),
                       (engine, "sample_token", engine.sample_token),
                       (engine, "make_chunk_batch_step",
                        engine.make_chunk_batch_step),
                       (engine, "make_fused_decode_step",
                        engine.make_fused_decode_step)]
        orig_moe, orig_sample = moe.moe_ffn, serve_step.sample_token
        make_chunks = engine.make_chunk_batch_step
        make_decode = engine.make_fused_decode_step

        def chunk_batch_step(*a, **kw):
            step = make_chunks(*a, **kw)

            def run(params, batch, *rest):
                n = batch["true_lens"] - batch["offset"]
                S = batch["tokens"].shape[1]
                self._live = torch.arange(S, device=n.device)[None] \
                    < n[:, None]
                return step(params, batch, *rest)
            return run

        def fused_decode_step(*a, **kw):
            step = make_decode(*a, **kw)

            def run(params, cache, tokens, lens, live, generator):
                self._live = live[:, None]
                return step(params, cache, tokens, lens, live, generator)
            return run

        def moe_ffn(params, x, cfg):
            probs, gates, top = moe.route(params, x, cfg)
            self.events.append(("moe", probs, top, self._live))
            if self.forced is None:
                return orig_moe(params, x, cfg)
            top = self.forced[self._i]
            self._i += 1
            gates = torch.gather(probs, -1, top)
            gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True),
                                            1e-9)
            return moe.dispatch(params, x, gates, top, cfg), \
                moe.aux_loss(probs, top, cfg)

        def sample_token(logits, **kw):
            self.events.append(("sample", logits[:, -1].float(), None
                                if self._live is None else
                                self._live.any(1)))
            return orig_sample(logits, **kw)

        moe.moe_ffn = moe_ffn
        serve_step.sample_token = engine.sample_token = sample_token
        engine.make_chunk_batch_step = chunk_batch_step
        engine.make_fused_decode_step = fused_decode_step
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self._saved:
            setattr(mod, attr, fn)


@contextlib.contextmanager
def through_ref(model):
    """The model's serving entry points with impl="ref" (instance
    attributes over the methods), so an engine runs the plain versions."""
    names = ("prefill", "prefill_paged", "prefill_chunks", "prefill_chunk",
             "prefill_suffix", "verify_chunks", "decode_step", "forward")
    for name in names:
        setattr(model, name, functools.partial(getattr(type(model), name),
                                               model, impl="ref"))
    try:
        yield model
    finally:
        for name in names:
            delattr(model, name)


def moe_events_check(k: Routing, r: Routing, K: int, dtype: str) -> dict:
    """The kernel run's events against the ref run's, one by one and over
    what the engine keeps (Routing's live), up to and including the first
    where they part: a sampling call whose tokens differ, or an MoE call
    whose (own) routing differs.  Up to there every MoE call's
    probabilities must lie within MOE_PROB_BARS and every sampling call's
    logits within MOE_LOGIT_BARS.  Reports every routing flip with its
    probability gap (the least gap between neighbours of the token's top
    K + 1 probabilities, kernel run) - in bf16 they do not part the runs,
    whose routing is the kernel run's - and the first sampled token that
    differs with its logit gap in the kernel run."""
    if [e[0] for e in k.events] != [e[0] for e in r.events]:
        raise AssertionError("MoE: the two runs made different calls")
    prob_err = logit_err = 0.0
    flips, parted, n_checked = [], None, 0
    for i, (a, b) in enumerate(zip(k.events, r.events)):
        n_checked = i + 1
        live = a[-1]
        diff = (a[1] - b[1]).abs().amax(-1)
        if live is not None:
            diff = torch.where(live, diff, 0.0)
        if a[0] == "moe":
            prob_err = max(prob_err, float(diff.max()))
            differ = (a[2] != b[2]).any(-1)
            if live is not None:
                differ = differ & live
            for idx in differ.nonzero().tolist():
                flips.append({"event": i, "row": idx, "gap": _gap(
                    a[1][tuple(idx)], K)})
            if differ.any() and dtype == "float32":
                parted = {"event": i, "kind": "routing"}
        else:
            logit_err = max(logit_err, float(diff.max()))
            ta, tb = a[1].argmax(-1), b[1].argmax(-1)
            parts = ta != tb
            if live is not None:
                parts = parts & live
            if parts.any():
                row = int(parts.nonzero()[0, 0])
                parted = {"event": i, "kind": "token", "row": row,
                          "gap": float(a[1][row, ta[row]]
                                       - a[1][row, tb[row]])}
        if parted is not None:
            break
    report = {"events": len(k.events), "events_checked": n_checked,
              "max_prob_diff": prob_err, "max_logit_diff": logit_err,
              "routing_flips": len(flips),
              "flip_gaps": sorted(f["gap"] for f in flips)[:16],
              "flip_gap_max": max((f["gap"] for f in flips), default=None),
              "parted_at": parted}
    if prob_err > MOE_PROB_BARS[dtype] or logit_err > MOE_LOGIT_BARS[dtype]:
        raise AssertionError(f"MoE {dtype}: kernels and ref disagree before "
                             f"their runs part: {report}")
    return report


def _moe_served(model, params, route: Routing, ref: bool):
    """The chunked traffic under `route` (through impl="ref" when ref),
    uncounted; returns {uid: tokens} and, for ref, the launch counts."""
    reset_counts()
    ctx = through_ref(model) if ref else contextlib.nullcontext()
    with ctx, route:
        eng, *_ = run_traffic(model, params, "chunked", count_syncs=False)
    return ({r.uid: list(r.out_tokens) for r in eng.sched.finished},
            read_counts())


def _moe_weight(params, x, cfg):
    return x.shape[0] * x.shape[1]


def _moe_decode_weight(params, x, cfg):
    return x.shape[0] if x.shape[1] == 1 else -1


def moe_serving(model, params, arch):
    """The chunked traffic on the paged + chunked + batched engine: a
    warm-up run recording the routing and the sampled logits (the largest
    K1 / K2 and MoE calls captured), the counted run (counted_run: K1 /
    K2 n_layers x the engine's chunk batches / decodes, 0 implicit syncs;
    its tokens equal to the warm-up's), the ref run of the same traffic
    with the warm-up's routing (no kernel launch) held to it by
    moe_events_check, then model_check with the ref pass taking the
    kernel pass's routing, and the traffic under the profiler.  Returns
    (runs, captured, e2e, trace, the captured MoE calls)."""
    K = model.cfg.moe_top_k
    caps = [Capture(mod, attr, w) for _, mod, attr, w in DF_CAPTURE["chunked"]]
    c_moe = Capture(moe, "moe_ffn", _moe_weight)
    rk = Routing()
    with caps[0], caps[1], c_moe:
        # a Capture wraps the function it finds when it is made
        c_dec = Capture(moe, "moe_ffn", _moe_decode_weight)
        with c_dec:
            warm, _ = _moe_served(model, params, rk, ref=False)
    captured = {f"{key}@{arch}": cap.best for (key, *_), cap in
                zip(DF_CAPTURE["chunked"], caps)}
    got = counted_run(model, params, "chunked")
    counted = {uid: out for uid, _, out in got["finished"]}
    if counted != warm:
        raise AssertionError(f"{arch}: the counted run's tokens differ from "
                             f"the warm-up run's")
    rr = Routing(forced=[e[2] for e in rk.events if e[0] == "moe"])
    ref_out, ref_counts = _moe_served(model, params, rr, ref=True)
    if any(ref_counts.values()):
        raise AssertionError(f"{arch}: the ref run launched {ref_counts}")
    vs_ref = moe_events_check(rk, rr, K, "bfloat16")
    vs_ref["requests_equal"] = sum(ref_out[u] == t for u, t in warm.items())
    log(f"# {arch} chunked against the same engine through impl=\"ref\" "
        f"(its routing the kernel run's): {vs_ref['requests_equal']} of "
        f"{len(warm)} requests equal; {vs_ref}")
    del rk, rr
    # model_check: the ref pass takes the kernel pass's routing
    route = Routing()
    c4 = Capture(flash_attention, "flash_attention_fwd", _k4_weight)
    c3 = Capture(flash_decode, "flash_decode", _lens_weight)
    with route, c4, c3:
        errs = model_check(model, params, on_pass=lambda impl: (
            route.replay() if impl == "ref" else None))
    captured[f"K4@{arch}"], captured[f"K3@{arch}"] = c4.best, c3.best
    own = [e[2] for e in route.events if e[0] == "moe"]
    if len(own) != len(route.forced):
        raise AssertionError("model_check: the passes made different calls")
    mc = {"logits_max_abs_diff": errs, "routing_flips_vs_kernel_pass": sum(
        int((a != f).any(-1).sum()) for a, f in zip(own, route.forced))}
    log(f"# {arch} model_check (ref pass on the kernel pass's routing): "
        f"{mc}")
    got["e2e"]["vs_ref"], got["e2e"]["model_check"] = vs_ref, mc
    trace = phase_trace(model, params, "chunked", got["e2e"]["wall_s"])
    return ({f"{arch} chunked": got}, captured, got["e2e"], trace,
            {"chunk": c_moe.best, "decode": c_dec.best})


def moe_layer(cfg, calls):
    """The MoE layer alone at the warm-up run's largest chunk-batch call
    and at an 8-lane decode call: median CUDA-event ms, the bound (the
    expert weights, router, input and output bytes over the HBM rate
    against every slot's products, empty slots included, over the bf16
    rate), and the error against the same function on float32 copies of
    its operands."""
    out = {}
    for name, (args, _) in calls.items():
        p, x, _ = args
        flush = torch.empty(64 * 1024 * 1024 // 4, dtype=torch.float32,
                            device=x.device)
        B, S = x.shape[:2]
        C = moe.capacity(S, cfg)
        y = moe.moe_ffn(p, x, cfg)[0]
        y32 = moe.moe_ffn({k: v.float() for k, v in p.items()}, x.float(),
                          cfg)[0]
        err = float((y.float() - y32).abs().max())
        scale = float(y32.abs().max())
        n_mats = 3 if cfg.act == "silu" else 2
        nbytes = sum(v.numel() * v.element_size() for v in p.values()) \
            + 2 * x.numel() * x.element_size()
        flops = 2 * n_mats * cfg.moe_experts * B * C * cfg.d_model \
            * cfg.d_ff + 2 * B * S * cfg.d_model * cfg.moe_experts
        t_b, t_o = nbytes / PEAK_BYTES_S, flops / PEAK_FLOP_S
        ms = time_ms(lambda: moe.moe_ffn(p, x, cfg), flush)
        out[name] = {"x": list(x.shape), "capacity": C, "ms": ms,
                     "bound_ms": max(t_b, t_o) * 1e3,
                     "bound_by": "bytes" if t_b >= t_o else "operations",
                     "bytes": nbytes, "flops": flops,
                     "max_abs_err_vs_f32": err, "f32_scale": scale}
        log(f"# {cfg.name} MoE layer at {name} x {tuple(x.shape)} (C "
            f"{C}): {ms:.3f} ms, bound {max(t_b, t_o) * 1e3:.3f} ms "
            f"({out[name]['bound_by']}: {nbytes / 1e6:.0f} MB, "
            f"{flops / 1e9:.1f} GFLOP); bf16 vs float32 operands max abs "
            f"err {err:.3e} (bar {MOE_LAYER_RTOL} x {scale:.3f})")
        if not np.isfinite(err) or err > MOE_LAYER_RTOL * scale:
            raise AssertionError(f"{cfg.name} MoE layer: bf16 and float32 "
                                 f"disagree")
    return out


def moe_a2a_check(cfg, call):
    """moe_ffn_a2a_local in a one-rank NCCL group (its all_to_all_single
    and all_reduce on the card) against moe_ffn at capacity factor
    MOE_A2A_FACTOR on the first row of the captured chunk-batch call, in
    bf16 (within
    MOE_LAYER_RTOL of the output's scale: the a2a computes its expert
    products in float32, moe_ffn rounds the hidden layer and the outputs
    to bf16) and on float32 copies (1e-5 absolute); the aux losses within
    1e-6."""
    (p, x, _), _ = call
    x = x[:1]
    cfg8 = cfg.replace(moe_capacity_factor=MOE_A2A_FACTOR)
    out = {}
    for dt in ("bfloat16", "float32"):
        pp = p if dt == "bfloat16" else {k: v.float() for k, v in p.items()}
        xx = x if dt == "bfloat16" else x.float()
        want, aux = moe.moe_ffn(pp, xx, cfg8)
        got, aux_a = _one_rank_nccl(lambda: moe_ffn_a2a_local(pp, xx, cfg8))
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        bar = MOE_LAYER_RTOL * scale if dt == "bfloat16" else F32_TOL
        out[dt] = {"max_abs_err": err, "scale": scale,
                   "aux_diff": abs(float(aux) - float(aux_a))}
        if err > bar or out[dt]["aux_diff"] > 1e-6:
            raise AssertionError(f"a2a {dt}: {out[dt]} (bar {bar})")
        del pp, xx
    log(f"# {cfg.name} moe_ffn_a2a_local in a one-rank NCCL group against "
        f"moe_ffn at capacity factor {MOE_A2A_FACTOR}: {out}")
    return out


def moe_fp32(model, params):
    """olmoe's float32 copy: the chunked traffic through the kernels and
    through impl="ref", each routing on its own, held by
    moe_events_check with the float32 bars."""
    m32, p32 = fp32_copy(model, params)
    rk, rr = Routing(), Routing()
    got, _ = _moe_served(m32, p32, rk, ref=False)
    want, counts = _moe_served(m32, p32, rr, ref=True)
    if any(counts.values()):
        raise AssertionError(f"float32 ref run launched {counts}")
    rep = moe_events_check(rk, rr, model.cfg.moe_top_k, "float32")
    rep["requests_equal"] = sum(want[u] == t for u, t in got.items())
    log(f"# {model.cfg.name} float32 chunked, kernels against impl=\"ref\" "
        f"(each its own routing): {rep['requests_equal']} of {len(got)} "
        f"requests equal; {rep}")
    del m32, p32, rk, rr
    _free()
    return rep


def moe_active_params(cfg) -> int:
    """The parameters one token's forward multiplies by: every layer's
    attention projections, its router and K of its E experts, and the
    unembedding (the embedding is a lookup, the norms elementwise)."""
    d, hd = cfg.d_model, cfg.head_dim
    attn = d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
    mats = 3 if cfg.act == "silu" else 2
    per_layer = attn + d * cfg.moe_experts \
        + cfg.moe_top_k * mats * d * cfg.d_ff
    return cfg.n_layers * per_layer + cfg.vocab_size * d


def moe_train_flops(cfg, n_params, B, S):
    """train_flops over the active parameters (moe_active_params) in place
    of every parameter: what a token's forward and backward multiply,
    never the E - K experts it skips, nor the empty capacity slots the
    per-row dispatch computes."""
    active = moe_active_params(cfg)
    pairs = S * (S + 1) // 2 * cfg.n_layers
    flops = 6 * active * B * S + 12 * B * cfg.n_heads * cfg.head_dim * pairs
    return flops, ("(6 * active params * tokens + 12 * batch * heads * "
                   "head_dim * causal pairs of every layer) / (median step "
                   "s * 989e12); active params: every layer's attention "
                   "projections, router and top-K experts, and the "
                   f"unembedding: {active}")


def moe_training():
    """olmoe-1b-7b at full width with MOE_TRAIN_LAYERS of its 16 layers,
    bf16, TrainConfig(**TRAIN) (4 x 2048 tokens, remat full), the
    published capacity factor: dense_family_training's checks and counts
    - the first step through the kernels against impl="ref" within
    M14_BARS (an MoE step's routing follows its inputs' rounding), K4
    2 x 8 and K5 8 launches a step - on numpy-seeded batches, MFU over
    the active parameters (moe_train_flops).  Returns (run, e2e, trace)."""
    run, _, e2e, trace = dense_family_training(
        "olmoe-1b-7b", MOE_TRAIN_LAYERS, bars=M14_BARS,
        flops_of=moe_train_flops, seeded_batches=True)
    e2e["capacity_factor"] = get_config("olmoe-1b-7b").moe_capacity_factor
    return run, e2e, trace


def phase_moe():
    """olmoe-1b-7b (full width and depth) and qwen3-moe-235b-a22b (its
    published widths, MOE_LAYERS[arch] of 94 layers), one at a time: the
    serving checks (moe_serving), then for olmoe the MoE layer alone, the
    one-rank NCCL a2a and the float32 copy's serving; then olmoe's
    training at MOE_TRAIN_LAYERS layers (moe_training).  Returns (runs,
    captured, e2e, traces)."""
    runs, captured, e2e, traces = {}, {}, {}, {}
    for arch in MOE_ARCHS:
        model, params, n_params = _seeded_model(arch, MOE_LAYERS.get(arch))
        r, c, e, traces[f"{arch} chunked"], calls = moe_serving(
            model, params, arch)
        runs.update(r)
        captured.update(c)
        e2e[arch] = {"params": n_params, "layers": model.cfg.n_layers,
                     "chunked": e}
        if arch == "olmoe-1b-7b":
            e2e[arch]["layer"] = moe_layer(model.cfg, calls)
            e2e[arch]["a2a_one_rank_nccl"] = moe_a2a_check(model.cfg,
                                                           calls["chunk"])
        # the captured MoE calls hold views of the stacked weights
        del calls
        if arch == "olmoe-1b-7b":
            e2e[arch]["float32"] = moe_fp32(model, params)
        del model, params
        _free()
    run, e2e["olmoe-1b-7b"]["training"], traces["olmoe-1b-7b train"] = \
        moe_training()
    runs["olmoe-1b-7b train"] = run
    _free()
    return runs, captured, e2e, traces


# ---------------------------------------------------------------------------
# phase 3, the vision-language family (M13)
# ---------------------------------------------------------------------------

# llava-next-34b at full width and depth (60 layers, 56 / 8 heads of 128,
# 34.39 B parameters: 68.8 GB of bf16 weights).  Its vision frontend is a
# stub, as in the JAX package: the batch carries 576 patch embeddings a
# row.  The engine serves it as a text model, as the JAX engine does
# (ROADMAP §3): RUNS["chunked"].  The image path runs through the model's
# entry points: VLM_ROWS rows of an image and a VLM_TEXT-token prompt,
# make_prefill_step into a dense cache of 576 + VLM_TEXT + VLM_NEW
# positions, then VLM_NEW greedy steps through make_serve_step; the same
# rows again with the real lengths VLM_TRUE_LENS (two rows padded)
VLM = "llava-next-34b"
VLM_ROWS, VLM_TEXT, VLM_NEW = 4, 256, 32
VLM_TRUE_LENS = (256, 200, 256, 131)
# training at the published widths with VLM_TRAIN_LAYERS of the 60 layers
# (the whole model's ~447 GB of training state does not fit one card; 4
# layers are 3.15 B parameters, ~41 GB): 2 rows of 2048 positions, 576
# image and 1472 text, remat full
VLM_TRAIN_LAYERS = 4
VLM_TRAIN = dict(TRAIN, global_batch=2)
# the float32 copy: VLM_F32_LAYERS of the 60 layers (5.38 B parameters,
# 21.5 GB), the image path with the float32 bars
VLM_F32_LAYERS = 8
# per dtype: a served token against the teacher-forced forward with the
# same image (bf16: SERVED_TOKEN_BAR, the bar of a served bf16 token;
# float32: the near-tie rule, NEAR_TIE), and a row's first logits in the
# padded batch against the row prefilled alone (bf16: the bar of a dense
# prefill; float32: 1e-4 - the two prefills run GEMMs and K4 calls of
# other shapes, which sum in other orders).  The image must move the first
# logits by more than VLM_IMAGE_EFFECT x the latter: a dropped or
# misplaced image would move them by nothing or land the tail on another
# position
VLM_BARS = {"bfloat16": {"token": SERVED_TOKEN_BAR,
                         "alone": MODEL_BARS["dense prefill"]},
            "float32": {"token": NEAR_TIE, "alone": 1e-4}}
VLM_IMAGE_EFFECT = 10
# model_check of the bf16 model: llava's logits are ~1.8x granite-3-2b's
# (a logit scale of 7-9: the init's logit sigma is 0.02 sqrt(d_model), 1.7
# at 7168), and over 60 layers its bf16 forward through impl="ref" lies
# 0.198 from the float32 forward on the same weights (its own bf16 noise,
# measured on an H100 80GB HBM3, 700 W), past MODEL_BARS["forward"], which
# were measured at granite's logit scale of ~4.  So, as phase_recurrent
# holds its deep seeded models, an entry point is held within
# REC_NOISE_MARGIN x that noise, measured in the run
# (fp32_streamed_forward), where that is above its MODEL_BARS entry.  The
# tight check is the float32 copy's: kernels vs ref within
# VLM_F32_MODEL_BAR (5.0e-5 at most, the forward, on the same card)
VLM_F32_MODEL_BAR = 1e-4


def fp32_streamed_forward(model, params, batch):
    """Model.forward's logits in float32 on the model's own weights
    through impl="ref", one layer's weights widened to float32 at a time
    (the whole of llava in float32 would take 137 GB)."""
    cfg = model.cfg.replace(dtype="float32")
    with torch.no_grad():
        x = model._assemble_input(params, batch)[0].float()
        for l, is_global in enumerate(T._layer_windows(cfg)):
            p = {name: {k: v[l].float() for k, v in group.items()}
                 for name, group in params["blocks"].items()}
            x = T._block(p, x, cfg, T._windowed(cfg, is_global), "ref")
        x = apply_norm({k: v.float() for k, v in
                        params["final_norm"].items()}, x, cfg)
        return unembed(params["tok"], x, cfg)


def noise_bars(model, params):
    """MODEL_BARS, each raised to REC_NOISE_MARGIN x the bf16 model's own
    noise where that is larger: max |forward through impl="ref" -
    fp32_streamed_forward| over model_check's prompts.  Returns (bars,
    noise)."""
    batch = {"tokens": torch.from_numpy(check_tokens(
        model.cfg.vocab_size)).to(model.device, torch.int32)}
    ref16 = model.forward(params, batch, impl="ref")[0]
    noise = float((ref16 - fp32_streamed_forward(model, params, batch))
                  .abs().max())
    log(f"# {model.cfg.name}: bf16 forward (impl=\"ref\") against the "
        f"float32 forward on the same weights {noise:.4f} (the model's own "
        f"bf16 noise), logit scale {float(ref16.abs().max()):.2f}")
    return {k: max(v, REC_NOISE_MARGIN * noise)
            for k, v in MODEL_BARS.items()}, noise


def vlm_image_path(model, params, tag):
    """VLM_ROWS rows, each numpy-seeded image embeddings (N(0, 0.02^2),
    bfloat16) and a VLM_TEXT-token prompt: a warm-up pass (the largest K4
    and K3 calls kept), then make_prefill_step (counted: K4 n_layers,
    nothing else; lens 576 + VLM_TEXT) and VLM_NEW greedy steps through
    make_serve_step (counted: K3 n_layers a step, nothing else, 0
    implicit syncs); every generated token (the prefill's and each
    step's) against a teacher-forced
    forward over the image, the prompt and the tokens before it; the rows
    with VLM_TRUE_LENS, each row's first logits and lens against the row
    prefilled alone; the first logits without the image.  Returns (runs,
    captured, e2e)."""
    cfg, dev = model.cfg, model.device
    bars = VLM_BARS[cfg.dtype]
    P = cfg.frontend_tokens
    rng = np.random.default_rng(14)
    images = torch.from_numpy((rng.standard_normal(
        (VLM_ROWS, P, cfg.d_model)) * 0.02).astype(np.float32)).to(
            dev, torch.bfloat16)
    text = torch.from_numpy(rng.integers(1, cfg.vocab_size, (
        VLM_ROWS, VLM_TEXT), dtype=np.int32)).to(dev)
    batch = {"tokens": text, "vision_embeds": images}
    max_len = P + VLM_TEXT + VLM_NEW
    prefill = serve_step.make_prefill_step(model)
    step = serve_step.make_serve_step(model)
    argmax = lambda lg: torch.argmax(lg[:, -1], -1, keepdim=True).to(
        torch.int32)
    # a Capture weighs a K3 call by its lengths, on the host: the warm-up
    # pass, not the counted one
    with Capture(flash_attention, "flash_attention_fwd", _k4_weight) as c4, \
            Capture(flash_decode, "flash_decode", _lens_weight) as c3:
        lp, cache, lens = prefill(params, batch, model.init_cache(
            VLM_ROWS, max_len))
        tok = argmax(lp)
        for i in range(VLM_NEW):
            tok = argmax(step(params, cache, tok, lens + i)[0])
    del cache
    cache = model.init_cache(VLM_ROWS, max_len)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    lp, cache, lens = prefill(params, batch, cache)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    pre = read_counts()
    first = argmax(lp)
    _, toks, dec, syncs, wall = _greedy_decode(model, params, cache, lens,
                                               first, VLM_NEW, False)
    peak = torch.cuda.max_memory_allocated()
    del cache
    L = cfg.n_layers
    want_pre = dict({k: 0 for k in COUNTERS}, K4=L)
    want_dec = dict({k: 0 for k in COUNTERS}, K3=L * VLM_NEW)
    if pre != want_pre or dec != want_dec or syncs \
            or lens.tolist() != [P + VLM_TEXT] * VLM_ROWS:
        raise AssertionError(f"{tag} image path: launches {pre} / {dec} "
                             f"(want {want_pre} / {want_dec}), {syncs} "
                             f"implicit syncs, lens {lens.tolist()}")
    out = torch.tensor(toks, device=dev).view(VLM_NEW, VLM_ROWS).t()
    gen = torch.cat([first, out.to(torch.int32)], 1).tolist()
    ties = teacher_forced_check(
        model, params, [(b, text[b].tolist(), gen[b])
                        for b in range(VLM_ROWS)], bars["token"], images)
    # the same rows with VLM_TRUE_LENS real tokens, against each row alone
    tl = torch.tensor(VLM_TRUE_LENS, dtype=torch.int32, device=dev)
    padded = text * (torch.arange(VLM_TEXT, device=dev) < tl[:, None])
    lp_pad, _, lens_pad = prefill(
        params, {"tokens": padded, "vision_embeds": images, "true_lens": tl},
        model.init_cache(VLM_ROWS, max_len))
    err_alone = 0.0
    for b, n in enumerate(VLM_TRUE_LENS):
        lp_b, _, lens_b = prefill(
            params, {"tokens": text[b:b + 1, :n],
                     "vision_embeds": images[b:b + 1]},
            model.init_cache(1, max_len))
        if not int(lens_pad[b]) == int(lens_b[0]) == P + n:
            raise AssertionError(f"{tag} padded row {b}: lens "
                                 f"{int(lens_pad[b])}, alone "
                                 f"{int(lens_b[0])}, want {P + n}")
        err_alone = max(err_alone, float((lp_pad[b] - lp_b[0]).abs().max()))
    lp_text = prefill(params, {"tokens": text},
                      model.init_cache(VLM_ROWS, max_len))[0]
    effect = float((lp - lp_text).abs().max())
    scale = float(lp.abs().max())
    n_tok = VLM_ROWS * VLM_NEW
    log(f"# {tag} image path: {VLM_ROWS} rows x ({P} image + {VLM_TEXT} "
        f"text) positions, {VLM_NEW} greedy tokens each: prefill "
        f"{prefill_s * 1e3:.1f} ms, kernel launches {pre}; decode "
        f"{wall / VLM_NEW * 1e3:.2f} ms a step, {n_tok / wall:.0f} "
        f"tokens/s, kernel launches {dec}, implicit syncs {syncs}; peak "
        f"{peak / 1e9:.2f} GB (1e9 bytes); every token the teacher-forced "
        f"forward's argmax or within {bars['token']:.3g} of it, near ties "
        f"{ties}; padded rows {list(VLM_TRUE_LENS)}: lens "
        f"{lens_pad.tolist()}, first logits max |batch - alone| "
        f"{err_alone:.3e} (bar {bars['alone']}); the image moves the first "
        f"logits by {effect:.3f} (at least {VLM_IMAGE_EFFECT} x "
        f"{bars['alone']}); logit scale {scale:.2f}")
    if err_alone > bars["alone"] \
            or effect <= VLM_IMAGE_EFFECT * bars["alone"] \
            or not bool(torch.isfinite(lp).all()):
        raise AssertionError(f"{tag} image path: padded rows or the image's "
                             f"effect")
    e2e = {"rows": VLM_ROWS, "image_positions": P, "text": VLM_TEXT,
           "new_tokens": VLM_NEW, "prefill_ms": prefill_s * 1e3,
           "decode_step_ms": wall / VLM_NEW * 1e3,
           "decode_tokens_per_s": n_tok / wall, "peak_mem_gb": peak / 1e9,
           "prefill_launches": pre, "decode_launches": dec,
           "implicit_syncs": syncs, "near_ties": ties,
           "true_lens": list(VLM_TRUE_LENS), "padded_vs_alone": err_alone,
           "image_effect": effect, "logit_scale": scale}
    runs = {f"{tag} image prefill": {"launches": pre},
            f"{tag} image decode": {"launches": dec}}
    return runs, {"K4": c4.best, "K3": c3.best}, e2e


def phase_vlm():
    """llava-next-34b at full width and depth: the chunked traffic through
    the paged engine (serve_runs, text only), model_check, the image path;
    then the float32 copy of VLM_F32_LAYERS layers through the image
    path, and VLM_TRAIN_LAYERS layers training on image batches.  Returns
    (runs, captured, e2e, traces)."""
    model, params, n_params = _seeded_model(VLM)
    after_init = torch.cuda.memory_allocated()
    log(f"# {VLM}: {after_init / 1e9:.2f} GB (1e9 bytes) allocated after "
        f"the init")
    runs, captured, e2e, traces = serve_runs(model, params, VLM,
                                             ("chunked",))
    e2e.update(params=n_params, layers=model.cfg.n_layers,
               allocated_after_init_gb=after_init / 1e9)
    bars, e2e["bf16_noise"] = noise_bars(model, params)
    e2e["model_check"] = model_check(model, params, bars=bars)
    r, c, e2e["image"] = vlm_image_path(model, params, VLM)
    runs.update(r)
    captured.update({f"{k}@{VLM}_image": v for k, v in c.items()})
    del model, params
    _free()
    model, params, _ = _seeded_model(VLM, VLM_F32_LAYERS)
    m32, p32 = fp32_copy(model, params)
    del model, params
    _free()
    r, _, e2e["float32"] = vlm_image_path(m32, p32, f"{VLM} float32")
    e2e["float32"].update(layers=VLM_F32_LAYERS, model_check=model_check(
        m32, p32, bars=dict.fromkeys(MODEL_BARS, VLM_F32_MODEL_BAR)))
    runs.update(r)
    del m32, p32
    _free()
    r, c, e2e["train"], traces[f"{VLM} train"] = dense_family_training(
        VLM, VLM_TRAIN_LAYERS, VLM_TRAIN)
    runs[f"{VLM} train"] = r
    captured.update(c)
    return runs, captured, e2e, traces


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
    """launch/cost.py k1_work on this call's rows: (bytes, FLOPs)."""
    q = a["q"]
    offs, tls = a["q_offsets"].cpu().numpy(), a["true_lens"].cpu().numpy()
    pairs, kv_pos = cost.chunk_rows_work(
        list(zip(offs.tolist(), tls.tolist())), a.get("window", 0))
    return cost.k1_work(q.shape, a["k_pages"].shape[2], q.element_size(),
                        pairs, kv_pos)


def k2_work(a):
    """launch/cost.py decode_work on the lanes' visible positions."""
    q = a["q"]
    lens, window = a["cache_len"].long(), a.get("window", 0)
    pos = int((lens.clamp(max=window) if window > 0 else lens).sum())
    return cost.decode_work(q.shape, a["k_pages"].shape[2],
                            q.element_size(), pos)


def k3_work(a):
    """launch/cost.py decode_work on the lanes' visible positions."""
    q, kc = a["q"], a["k_cache"]
    lens = a["cache_len"]
    lens = lens.cpu().numpy() if torch.is_tensor(lens) \
        else [lens] * q.shape[0]
    pos = cost.decode_positions(lens, kc.shape[1], a.get("window", 0))
    return cost.decode_work(q.shape, kc.shape[2], q.element_size(), pos)


def k4_work(a):
    """launch/cost.py k4_work: (bytes, FLOPs) under the call's mask."""
    kw = _k4_kw(a)
    return cost.k4_work(a["q"].shape, a["k"].shape, a["q"].element_size(),
                        kw["causal"], kw["window"])


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
    window = a.get("window", 0)
    if window > 0:
        mask &= col[None, None, :] > row[:, :, None] - window
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
    mask = _decode_mask(a["cache_len"], skv, a.get("window", 0), q.device)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(qq, kk, vv, attn_mask=mask)


def _decode_mask(lens, skv, window, device):
    """(B, 1, 1, skv) mask of the positions a decode query at lens - 1
    attends: below lens, and past lens - 1 - window under a window."""
    col = torch.arange(skv, device=device)[None, :]
    lens = lens[:, None].long()
    mask = col < lens
    if window > 0:
        mask &= col >= lens - window
    return mask[:, None, None, :].contiguous()


def k3_library(a):
    """One scaled_dot_product_attention call over the whole strips with a
    per-lane length (and window) mask."""
    q, kc = a["q"], a["k_cache"]
    S = kc.shape[1]
    lens = a["cache_len"]
    lens = lens if torch.is_tensor(lens) else torch.full(
        (q.shape[0],), lens, device=q.device)
    mask = _decode_mask(lens, S, a.get("window", 0), q.device)
    return _sdpa(q, kc, a["v_cache"], attn_mask=mask)


def k4_library(a):
    """One causal scaled_dot_product_attention call (its is_causal mask is
    top-left aligned, as K4's, and the calls timed here have Sq == Skv);
    under a window, with the causal window as an explicit mask."""
    kw = _k4_kw(a)
    if kw["window"] <= 0:
        return _sdpa(a["q"], a["k"], a["v"], is_causal=kw["causal"])
    return _sdpa(a["q"], a["k"], a["v"], attn_mask=_window_mask(
        a["q"].shape[1], a["k"].shape[1], kw["window"], a["q"].device))


def _window_mask(sq, skv, window, device):
    """The causal window as an explicit (sq, skv) mask: key j is attended
    by query i where i - window < j <= i."""
    row = torch.arange(sq, device=device)[:, None]
    col = torch.arange(skv, device=device)[None, :]
    return (col <= row) & (col > row - window)


def k5_work(a):
    """launch/cost.py k5_work: (bytes, FLOPs) under the call's mask."""
    kw = _k5_kw(a)
    return cost.k5_work(a["q"].shape, a["k"].shape, a["q"].element_size(),
                        kw["causal"], kw["window"])


def k5_library(a):
    """The backward alone of one causal scaled_dot_product_attention call
    with enable_gqa: torch.autograd.grad of its output with respect to
    q, k and v, on inputs laid out as (B, H, S, D) beforehand; under a
    window, with the causal window as an explicit mask."""
    qq, kk, vv = (a[n].transpose(1, 2).contiguous().requires_grad_(True)
                  for n in ("q", "k", "v"))
    dd = a["do"].transpose(1, 2).contiguous()
    kw = _k5_kw(a)
    mask = dict(attn_mask=_window_mask(qq.shape[2], kk.shape[2],
                                       kw["window"], qq.device)) \
        if kw["window"] > 0 else dict(is_causal=kw["causal"])
    out = torch.nn.functional.scaled_dot_product_attention(
        qq, kk, vv, enable_gqa=True, **mask)
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
    """launch/cost.py k6_work over 128-step chunks (K6's CHUNK)."""
    x = a["x"]
    return cost.k6_work(x.shape, a["Bm"].shape[-1], x.element_size(),
                        mamba2_scan.CHUNK)


def k7_work(a):
    """launch/cost.py k7_work (products over 32-step chunks)."""
    r = a["r"]
    return cost.k7_work(r.shape, a["v"].shape[-1], r.element_size())


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
    elif key == "K1":
        err, err32 = k1_compare(call(a), a, dtype), \
            k1_compare(call(f32), f32, torch.float32)
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
        # training step's forward (4 x 2048 tokens, 32 / 8 heads of 64); K1's
        # speculative verify launch (rows of spec_k + 1 with ragged q_lens)
        for tag, label in (("d80", "at_zamba2_d80"), ("train", "at_train"),
                           ("verify", "at_spec_verify")):
            if f"{key}_{tag}" in captured:
                row[label] = _timed(key, captured[f"{key}_{tag}"], flush)
        # the dense family's shapes: qwen-7b (G 7, head dim 128), opt-6.7b
        # (G 1, 128), gemma3-4b (G 2, 256; its training as K5@gemma3-4b and
        # K4@gemma3-4b_train), olmo-1b's training, granite-8b
        for ck, args_kw in captured.items():
            if ck.startswith(f"{key}@"):
                row[f"at_{ck[len(key) + 1:]}"] = _timed(key, args_kw, flush)
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
    time by kernel name, and the device's busy share of that wall time.
    The sums are read from the profiler's raw events: key_averages()
    gives the same sums but first builds an event tree, which took many
    times the traced run's own wall."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}                       # kernel name -> [device us, count]
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA"):
            acc = by_name.setdefault(e.name(), [0.0, 0])
            acc[0] += e.duration_ns() / 1e3
            acc[1] += 1
    busy = sum(us for us, _ in by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)
    if not busy:
        log("# the profiler recorded no device time: not measured")
    port = {}
    for key, names in PORT_KERNEL_NAMES.items():
        mine = [v for k, v in by_name.items() if any(n in k for n in names)]
        if mine:
            us = sum(v[0] for v in mine)
            port[key] = {"ms": us / 1e3, "launches": sum(v[1] for v in mine),
                         "share_of_busy": us / 1e6 / busy if busy else None}
    return {"profiled_wall_s": wall, "device_busy_s": busy,
            "busy_share": busy / wall,
            "memcpy_ms": sum(us for k, (us, _) in by_name.items()
                             if "Memcpy" in k) / 1e3,
            "top_kernels_ms": [[k[:80], us / 1e3, n]
                               for k, (us, n) in top[:10]],
            "port_kernels": port}


def phase_trace(model, params, run: str, counted_wall_s: float):
    """The run's traffic once more under the device-only profiler."""
    out = device_trace(lambda: run_traffic(model, params, run,
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
    at = lambda phase: log(f"# {phase} done at "
                           f"{time.perf_counter() - t0:.1f} s")
    phase_device_and_build()
    phase_kernel_parity()
    k4_tiles = phase_k4_tiles(K4_SHAPES)
    at("build, kernel parity and K4's tiles")
    k4_paper = phase_paper()
    at("K4 at the paper's workloads")
    runs, captured, mp = phase_slice()
    m6_runs, m6_captured = phase_m6(*mp)
    runs.update(m6_runs)
    captured.update(m6_captured)
    runs.update(phase_m6d_m7(*mp, runs["chunked"]))
    trace = phase_trace(*mp, "chunked", runs["chunked"]["e2e"]["wall_s"])
    trace_dense = phase_trace(*mp, "dense", runs["dense"]["e2e"]["wall_s"])
    trace_pm = phase_trace(*mp, "paged_monolithic",
                           runs["paged_monolithic"]["e2e"]["wall_s"])
    m6_traces = {run: phase_trace(*mp, run, runs[run]["e2e"]["wall_s"])
                 for run in M6_RUNS}
    at("granite-3-2b serving")
    e2e_m10, m10_captured, m10_launches = phase_m10(*mp, runs)
    captured.update(m10_captured)
    runs.update(m10_launches)
    at("M10")
    m11_runs, e2e_m11 = phase_m11(*mp)
    runs.update(m11_runs)
    at("M11")
    del mp                       # the serving model, before the training one
    _free()
    runs["train"], train_captured, e2e_train, trace_train = phase_train()
    captured.update(train_captured)
    at("training")
    _free()
    e2e_m14, m14_captured, m14_launches = phase_m14()
    captured.update(m14_captured)
    runs.update(m14_launches)
    at("M14")
    _free()
    runs["recurrent"], rec_captured, e2e_rec, trace_rec = phase_recurrent()
    captured.update(rec_captured)
    _free()
    at("recurrent")
    df_runs, df_captured, e2e_df, trace_df = phase_dense_family()
    runs.update(df_runs)
    captured.update(df_captured)
    at("dense family")
    w_runs, w_captured, e2e_whisper = phase_whisper()
    runs.update(w_runs)
    captured.update(w_captured)
    at("whisper")
    moe_runs, moe_captured, e2e_moe, trace_moe = phase_moe()
    runs.update(moe_runs)
    captured.update(moe_captured)
    at("moe")
    vlm_runs, vlm_captured, e2e_vlm, trace_vlm = phase_vlm()
    runs.update(vlm_runs)
    captured.update(vlm_captured)
    at("vlm")
    rows = phase_times(runs, captured)
    next(r for r in rows if r["name"].startswith("K4"))["tile_sweep"] = \
        k4_tiles
    at("times")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"trace": trace}), flush=True)
    print(json.dumps({"trace_dense": trace_dense}), flush=True)
    print(json.dumps({"trace_paged_monolithic": trace_pm}), flush=True)
    print(json.dumps({"trace_train": trace_train}), flush=True)
    print(json.dumps({"trace_recurrent": trace_rec}), flush=True)
    for run, tr in m6_traces.items():
        print(json.dumps({f"trace_{run}": tr}), flush=True)
    print(json.dumps({"trace_dense_family": trace_df}), flush=True)
    print(json.dumps({"trace_moe": trace_moe}), flush=True)
    print(json.dumps({"trace_vlm": trace_vlm}), flush=True)
    print(json.dumps({"e2e": runs["chunked"]["e2e"]}), flush=True)
    print(json.dumps({"e2e_dense": runs["dense"]["e2e"]}), flush=True)
    print(json.dumps({"e2e_paged_monolithic":
                      runs["paged_monolithic"]["e2e"]}), flush=True)
    print(json.dumps({"e2e_train": e2e_train}), flush=True)
    print(json.dumps({"e2e_recurrent": e2e_rec}), flush=True)
    for run, ref in M6_RUNS.items():
        print(json.dumps({f"e2e_{run}": dict(runs[run]["e2e"], reference=dict(
            runs[ref]["e2e"], name=ref))}), flush=True)
    print(json.dumps({"e2e_dense_family": e2e_df}), flush=True)
    for run, ref in (("telemetry", "chunked"), ("deadline", "deadline_free"),
                     ("fleet", None)):
        e2e = dict(runs[run]["e2e"])
        if ref is not None:
            e2e["reference"] = dict(runs[ref]["e2e"], name=ref)
        print(json.dumps({f"e2e_{run}": e2e}), flush=True)
    print(json.dumps({"e2e_m10": {k: v if k not in M10_RUNS else [
        {f: x for f, x in rr.items() if f != "finished"} for rr in v]
        for k, v in e2e_m10.items()}}), flush=True)
    print(json.dumps({"e2e_m11": e2e_m11}), flush=True)
    print(json.dumps({"e2e_m14": e2e_m14}), flush=True)
    print(json.dumps({"e2e_whisper": e2e_whisper}), flush=True)
    print(json.dumps({"e2e_moe": e2e_moe}), flush=True)
    print(json.dumps({"e2e_vlm": e2e_vlm}), flush=True)
    print(json.dumps({"k4_paper": k4_paper}), flush=True)
    log(f"# total {time.perf_counter() - t0:.1f} s")
    print(card(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
