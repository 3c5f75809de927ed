"""Continuous-batching serve engine: dense or paged KV cache, monolithic or
chunked prefill, batched one-launch ticks; the recurrent families (hybrid,
ssm) on their state caches with stepwise admission.

Slot-based: up to `max_batch` sequences share one batched KV cache -
dense strips (one (L, max_batch, max_seq, Hkv, D) K and V), or a global
page pool (serve/paged_cache.py) reached through a block table; queueing,
admission order, chunk planning and latency accounting live in the
token-budget scheduler (serve/scheduler.py); this module owns the device
state and the page bookkeeping.  It follows the JAX package's ServeEngine
counter for counter on two schedules (ServeConfig.chunked), the first
with two ways to admit:

  monolithic  (chunked=False, dense or paged) admission prefills each
              queued request's whole prompt in one launch - padded to a
              multiple of PREFILL_BUCKET into the slot's dense strip, or
              to a page multiple straight into its pages after the
              worst-case reservation ceil((prompt + max_new) / page_size)
              (when the free list cannot cover it, the request stays
              queued) - and samples its first token, fetched at once (one
              host sync per admission).  Then each tick is ONE fused
              decode launch over every lane and ONE fetch of the tokens.
  stepwise    (chunked=False, paged=False, the hybrid and ssm families,
              whose state cannot be prefilled into one batch lane) admission
              feeds the prompt token by token through the single-token
              decode step on the admitted slot's lane, then samples and
              fetches the first token; the ticks are those of monolithic.
  chunked     (paged only) every tick has tick_token_budget tokens of
              work: each decoding slot takes one, prompt chunks of
              PREFILLING slots fill the rest.  The tick is ONE chunk-batch
              launch (every planned chunk packed into a ragged batch,
              first tokens of completed prompts sampled on the device),
              ONE fused decode launch, and ONE device-to-host transfer of
              the token array.  A slot that is still prefilling keeps
              lens 0 and a zeroed row in the DEVICE block table, so the
              decode launch's write lane for it lands in the reserved null
              page.

Host-side decisions read the host mirror of the lengths (`_lens_np`),
never the device tensor, so the only synchronisations are the token
fetches (_fetch_tokens per tick, _fetch_first_token per monolithic
admission).  Uploads go through fresh pinned buffers copied
asynchronously; the host block table is always copied first, because
torch.from_numpy aliases the array and the allocator mutates it in place.

Settings outside these paths (prefix cache, preemption, speculation,
deadlines, span tracing, the sequential chunked oracle, tensor
parallelism) raise NotImplementedError naming their ROADMAP item.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..configs.base import ServeConfig
from ..models.model import ATTENTION_FAMILIES, RECURRENT_LEAVES
from .paged_cache import PageAllocator, pages_needed
from .scheduler import (ChunkTask, Request, RequestState,
                        TokenBudgetScheduler)
from .serve_step import (make_chunk_batch_step, make_fused_decode_step,
                         make_paged_prefill_step, make_prefill_step,
                         make_serve_step, sample_token)
from .telemetry import LaunchRecord, MetricsRegistry, Telemetry, TickRecord

# dense-cache prompts are padded to a multiple of this before the
# monolithic prefill (the JAX engine's jit bucket; kept so that both
# engines prefill the same shapes and write the same strip positions)
PREFILL_BUCKET = 16


def _refuse_unported(scfg: ServeConfig):
    """NotImplementedError for every ServeConfig setting this slice of the
    port does not serve, naming the ROADMAP item that brings it."""
    todo = [
        (scfg.chunked and not scfg.batched,
         "batched=False (sequential chunked oracle path)", "M6"),
        (scfg.prefix_cache, "prefix_cache=True", "M6"),
        (scfg.preemption, "preemption=True", "M6"),
        (scfg.speculative, "speculative=True", "M6"),
        (scfg.default_deadline_tokens > 0, "request deadlines", "M6"),
        (scfg.telemetry, "telemetry=True (span tracer)", "M6"),
        (scfg.tp_degree > 1, f"tp_degree={scfg.tp_degree}", "M10"),
    ]
    for bad, what, item in todo:
        if bad:
            raise NotImplementedError(
                f"{what} is not ported to the PyTorch engine yet (ROADMAP "
                f"{item}); it serves chunked=True with batched=True on the "
                f"paged cache, and chunked=False on the dense or paged "
                f"cache")


def _registry_counter(name: str):
    """Attribute view over a registry counter (reads and `self.x += n`
    writes go through the MetricsRegistry, the one source of truth)."""
    def fget(self):
        return int(self.tm.registry.get(name).value)

    def fset(self, v):
        self.tm.registry.get(name).set_total(v)

    return property(fget, fset)


def _registry_gauge(name: str):
    def fget(self):
        return int(self.tm.registry.get(name).value)

    def fset(self, v):
        self.tm.registry.get(name).set(v)

    return property(fget, fset)


class ServeEngine:
    def __init__(self, model, params, scfg: ServeConfig):
        """model: a models.Model; params: its parameter tree (Model.init,
        Model.params or models/convert.py).  The engine runs on the device
        of the model's parameters."""
        self.model = model
        self.params = params
        self.scfg = scfg.validate()
        _refuse_unported(scfg)
        self.device = model.device
        B = scfg.max_batch
        self.tm = Telemetry(registry=MetricsRegistry())
        m = self.tm.registry
        m.counter("serve_jit_calls_total",
                  "Model-step launches dispatched")
        m.counter("serve_host_syncs_total",
                  "Device->host transfers (token fetches)")
        m.counter("serve_prefill_tokens_total",
                  "Prompt tokens actually computed by prefill")
        m.counter("serve_gen_tokens_total", "Generation tokens emitted")
        m.counter("serve_decode_launches_total",
                  "Token-emitting launches (fused decode)")
        m.counter("serve_kv_pages_read_total",
                  "KV pages read by token-emitting launches (analytic "
                  "host-side count, not a device counter)")
        m.counter("serve_requests_submitted_total",
                  "Requests accepted by submit()")
        m.counter("serve_requests_finished_total",
                  "Requests finished (length or stop token)")
        m.gauge("serve_peak_pages",
                "High-water mark of pool pages in use")
        m.gauge("serve_peak_live_pages",
                "High-water mark of distinct pages referenced by slots")
        m.gauge("serve_outstanding_work_tokens",
                "Queued + in-flight work tokens (prompt remaining plus "
                "unspent generation budget)")
        self.paged = scfg.paged
        self._attention_family = model.cfg.family in ATTENTION_FAMILIES
        self.allocator: Optional[PageAllocator] = None
        if self.paged:
            if not self._attention_family:
                raise ValueError(f"paged serving needs an attention family, "
                                 f"got {model.cfg.family}")
            if scfg.max_seq % scfg.page_size:
                raise ValueError(
                    f"max_seq ({scfg.max_seq}) must be a multiple of "
                    f"page_size ({scfg.page_size})")
            num_pages = scfg.pool_pages()
            self.allocator = PageAllocator(num_pages, scfg.page_size, B,
                                           scfg.max_seq,
                                           usable_pages=scfg.usable_pages,
                                           metrics=m)
            self.cache = model.init_cache(B, scfg.max_seq,
                                          page_size=scfg.page_size,
                                          num_pages=num_pages)
        else:
            self.cache = model.init_cache(B, scfg.max_seq)
        self.lens = torch.zeros((B,), dtype=torch.int32, device=self.device)
        self.tokens = torch.zeros((B, 1), dtype=torch.int32,
                                  device=self.device)
        self.slots: List[Optional[Request]] = [None] * B
        self.sched = TokenBudgetScheduler(scfg, metrics=m)
        self._uid = 0
        self._admit_seq = 0
        self._gen = torch.Generator(device=self.device).manual_seed(
            scfg.seed)
        self._finished_this_tick: List[Request] = []
        self._tick_profile = (0, 0)
        self._table_dirty = False    # device block table behind the host's
        # host mirror of `lens`: every host-side decision reads this instead
        # of syncing the device tensor - lengths follow from scheduling
        self._lens_np = np.zeros((B,), np.int64)
        self._knobs = dict(temperature=scfg.temperature, top_k=scfg.top_k,
                           top_p=scfg.top_p)
        self._decode = make_serve_step(model)
        self._prefill = make_prefill_step(model)
        self._prefill_paged = make_paged_prefill_step(model)
        self._prefill_chunks = make_chunk_batch_step(model, **self._knobs)
        self._decode_fused = make_fused_decode_step(model, **self._knobs)

    # registry-backed views (one source of truth: the metrics registry)
    jit_calls = _registry_counter("serve_jit_calls_total")
    host_syncs = _registry_counter("serve_host_syncs_total")
    prefill_tokens = _registry_counter("serve_prefill_tokens_total")
    gen_tokens = _registry_counter("serve_gen_tokens_total")
    decode_launches = _registry_counter("serve_decode_launches_total")
    kv_pages_read = _registry_counter("serve_kv_pages_read_total")
    peak_pages = _registry_gauge("serve_peak_pages")
    peak_live_pages = _registry_gauge("serve_peak_live_pages")

    @property
    def launch_log(self) -> List[tuple]:
        """Per-tick dispatch rows (jit_calls, host_syncs, host_wall_s,
        n_chunk_tasks, n_decode), a view over self.tm.ticks."""
        return [t.as_tuple() for t in self.tm.ticks]

    def launch_records(self) -> List[LaunchRecord]:
        """Per-launch data-movement records, launch order."""
        return list(self.tm.launches)

    @property
    def queue(self) -> List[Request]:
        """Requests waiting for admission (owned by the scheduler)."""
        return self.sched.queue

    # ------------------------------------------------------------------
    # host <-> device
    # ------------------------------------------------------------------
    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A host array as a device tensor, without synchronising: copied
        into a fresh pinned buffer and sent asynchronously (the caching
        host allocator keeps the buffer until the copy has run).  The
        copy also cuts any alias to host state mutated later.  On the CPU
        it is a plain copy."""
        if self.device.type == "cpu":
            return torch.from_numpy(np.array(a, copy=True))
        buf = torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
        return buf.to(self.device, non_blocking=True)

    def _fetch_tokens(self) -> np.ndarray:
        """THE tick's device->host transfer: the (B, 1) token array after
        the fused steps wrote every lane's sampled token into it."""
        self.host_syncs += 1
        return self.tokens.cpu().numpy()

    def _fetch_first_token(self, tok: torch.Tensor) -> int:
        """A monolithic admission's device->host transfer: the first
        generated token, sampled on the device from the prompt's last
        logits (the host needs it now to tell whether the request already
        finished)."""
        self.host_syncs += 1
        return int(tok[0, 0])

    def _note_launch(self, kind: str, rows: int, live_rows: int,
                     true_tokens: int, padded_tokens: int,
                     kv_pages_read: int, kv_pages_written: int,
                     new_kv_tokens: int):
        self.tm.launch(LaunchRecord(
            tick=self.sched.ticks, kind=kind, rows=rows,
            live_rows=live_rows, true_tokens=true_tokens,
            padded_tokens=padded_tokens, kv_pages_read=kv_pages_read,
            kv_pages_written=kv_pages_written, new_kv_tokens=new_kv_tokens,
            work_clock=self.sched.work_clock))

    def _row_pages(self, slot: int, true_len: int) -> int:
        """KV pages slot's attention reads at KV length `true_len`, counted
        from the allocator's block-table row."""
        n = -(-int(true_len) // self.scfg.page_size)
        return int(np.count_nonzero(self.allocator.table[slot, :n]))

    def _span_pages(self, start: int, end: int) -> int:
        """Pages the K/V writes of token positions [start, end) touch."""
        if end <= start:
            return 0
        ps = self.scfg.page_size
        return end // ps - start // ps + (1 if end % ps else 0)

    # ------------------------------------------------------------------
    def submit(self, prompt: List[int],
               max_new_tokens: Optional[int] = None,
               stop_tokens: Optional[Sequence[int]] = None,
               priority: int = 0,
               deadline: Optional[int] = None,
               max_retries: Optional[int] = None) -> int:
        """Enqueue a request.  What can never be served - an empty prompt,
        no generation budget, overflowing max_seq, a page reservation
        larger than the pool - fails here.  `stop_tokens` (merged with
        ServeConfig.eos_id) end generation the tick one is produced;
        higher `priority` admits first."""
        n_new = self.scfg.max_new_tokens if max_new_tokens is None \
            else max_new_tokens
        if not prompt:
            raise ValueError("empty prompt")
        if n_new < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {n_new}")
        if deadline is not None:
            raise NotImplementedError(
                "request deadlines are not ported to the PyTorch engine "
                "yet (ROADMAP M6)")
        if max_retries is not None and max_retries < 0:
            raise ValueError(f"max_retries must be >= 0 (None = "
                             f"unbounded), got {max_retries}")
        if len(prompt) + n_new > self.scfg.max_seq:
            raise ValueError(
                f"request does not fit: {len(prompt)} prompt + {n_new} new "
                f"tokens > max_seq {self.scfg.max_seq}")
        if self.paged:
            need = pages_needed(len(prompt) + n_new, self.scfg.page_size)
            usable = min(self.allocator.max_pages_per_seq,
                         self.allocator.usable_pages)
            if need > usable:
                raise ValueError(
                    f"request needs {need} pages; the engine can grant at "
                    f"most {usable} (pool {self.allocator.num_pages}, "
                    f"max_seq {self.scfg.max_seq}, page "
                    f"{self.scfg.page_size})")
        stops = frozenset(stop_tokens or ())
        if self.scfg.eos_id is not None:
            stops = stops | {self.scfg.eos_id}
        self._uid += 1
        req = Request(self._uid, list(prompt), n_new, stop_tokens=stops,
                      priority=int(priority), max_retries=max_retries)
        self.sched.submit(req)
        self.tm.registry.get("serve_requests_submitted_total").inc()
        return self._uid

    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def load_stats(self) -> Dict[str, int]:
        """Occupancy view for dispatch decisions: queue depth, in-flight
        requests, outstanding work tokens and page headroom (host-side
        reads only)."""
        inflight = [r for r in self.slots if r is not None]
        work = sum(r.prompt_remaining + r.remaining_new
                   for r in inflight + self.queue)
        self.tm.registry.get("serve_outstanding_work_tokens").set(work)
        return {"queue_depth": len(self.queue),
                "inflight": len(inflight),
                "free_slots": sum(s is None for s in self.slots),
                "outstanding_work_tokens": work,
                "free_pages": int(self.allocator.free_pages) if self.paged
                else 1 << 30,            # dense KV never backpressures
                "evictable_pages": 0}

    def stats(self) -> Dict[str, float]:
        """Scheduler latency aggregates (TTFT / time-between-tokens, wall
        and work clock), budget accounting, prefill counters and dispatch
        accounting (launches, device->host transfers, host wall per
        tick)."""
        out: Dict[str, float] = dict(self.sched.stats())
        out.update({"prefill_tokens": self.prefill_tokens,
                    "prefix_hit_tokens": 0,
                    "prompt_tokens": self.prefill_tokens,
                    "cow_copies": 0,
                    "cached_pages": 0,
                    "peak_pages": self.peak_pages,
                    "peak_live_pages": self.peak_live_pages})
        out["tick_token_budget"] = self.scfg.tick_token_budget
        out["chunked"] = self.scfg.chunked
        out["batched"] = self.scfg.batched
        out["jit_calls"] = self.jit_calls
        out["host_syncs"] = self.host_syncs
        out["speculative"] = False
        out["telemetry"] = False
        out["tp_degree"] = self.scfg.tp_degree
        out["gen_tokens"] = self.gen_tokens
        out["decode_launches"] = self.decode_launches
        out["kv_pages_read"] = self.kv_pages_read
        out["tokens_per_launch"] = (self.gen_tokens / self.decode_launches
                                    if self.decode_launches else 0.0)
        out["tokens_per_kv_page"] = (self.gen_tokens / self.kv_pages_read
                                     if self.kv_pages_read else 0.0)
        if self.launch_log:
            calls = [r[0] for r in self.launch_log]
            syncs = [r[1] for r in self.launch_log]
            walls = [r[2] for r in self.launch_log]
            busy = [r[0] for r in self.launch_log if r[3] and r[4]]
            out["jit_calls_per_tick_max"] = max(calls)
            out["jit_calls_per_tick_mean"] = float(np.mean(calls))
            out["jit_calls_per_busy_tick_max"] = max(busy) if busy else 0
            out["host_syncs_per_tick_max"] = max(syncs)
            out["tick_host_wall_p50"] = float(np.percentile(walls, 50))
            out["tick_host_wall_p95"] = float(np.percentile(walls, 95))
        return out

    def check_invariants(self):
        """Host-side consistency checks (the replay fixtures call this after
        every tick): allocator refcount conservation and block-table
        mirroring (paged), slot back-references, queue states and the lens
        mirror.  Never touches a device tensor."""
        if self.paged:
            self.allocator.check_invariants()
        for i, r in enumerate(self.slots):
            if r is None:
                if self.paged:
                    assert not self.allocator.table[i].any(), \
                        f"slot {i} empty but its table row is live"
                assert self._lens_np[i] == 0, \
                    f"slot {i} empty but lens mirror {self._lens_np[i]}"
            else:
                assert r.slot == i, f"slot {i} back-reference broken"
                assert r.state in (RequestState.PREFILLING,
                                   RequestState.DECODING), \
                    f"slot {i} holds a {r.state} request"
        for r in self.queue:
            assert r.state is RequestState.QUEUED
            assert r.slot is None, \
                f"queued request {r.uid} still holds slot {r.slot}"
            assert r.remaining_new >= 1

    def kv_cache_bytes(self) -> int:
        """Allocated cache bytes, every leaf: K and V strips or pools, the
        block table when paged, the recurrent states of the hybrid and ssm
        families.  Caches are preallocated, so allocated == peak."""
        return sum(t.numel() * t.element_size() for t in self.cache.values())

    # ------------------------------------------------------------------
    # emission / completion
    # ------------------------------------------------------------------
    def _emit(self, req: Request, tok: int,
              work: Optional[int] = None) -> bool:
        """Record one generated token; True when the request is finished
        (stop token or length budget).  `work` back-stamps the token's
        work clock (emission is deferred to the tick's fetch)."""
        req.out_tokens.append(tok)
        self.gen_tokens += 1
        self.sched.note_token(req, time.time(), work=work)
        if tok in req.stop_tokens:
            req.finish_reason = "stop"
            return True
        if len(req.out_tokens) >= req.max_new_tokens:
            req.finish_reason = "length"
            return True
        return False

    def _finish(self, req: Request):
        """Free the request's slot; its pages go back to the pool the same
        tick."""
        i = req.slot
        req.state = RequestState.DONE
        req.done = True
        self.slots[i] = None
        # a device-side fill: assigning a Python scalar (lens[i] = 0) would
        # copy it from the host and synchronise
        self.lens[i:i + 1].zero_()
        self._lens_np[i] = 0
        if self.paged:
            self.allocator.free_slot(i)
            self._table_dirty = True     # zero the slot's device row
        self.sched.note_finished(req)
        self.tm.registry.get("serve_requests_finished_total").inc()
        self._finished_this_tick.append(req)

    def _sync_table(self):
        """Upload the block table, MASKING rows of slots that are not yet
        decoding: a PREFILLING slot keeps lens 0, so the decode launch's
        write lane for it must land in the null page, not in the pages its
        chunks are filling.  The host table is copied before the upload
        (see _upload)."""
        tbl = self.allocator.table.copy()
        masked = [i for i, r in enumerate(self.slots)
                  if r is not None and r.state is not RequestState.DECODING]
        if masked:
            tbl[masked] = 0
        self.cache["block_table"] = self._upload(tbl)
        self._table_dirty = False

    # ------------------------------------------------------------------
    # admission (monolithic prefill)
    # ------------------------------------------------------------------
    def _admit(self):
        """Prefill queued requests into free slots, whole prompts at once,
        in ServeConfig.admission_policy order; stops at the first candidate
        that cannot be placed (no slot, or - paged - not enough free
        pages: backpressure, it stays queued)."""
        while True:
            req = self.sched.peek()
            if req is None:
                return
            slot = self._free_slot()
            if slot is None:
                return
            if self.paged:
                if not self._admit_paged(slot, req):
                    return
            elif self._attention_family:
                self._admit_prefill(slot, req)
            else:
                self._admit_stepwise(slot, req)

    def _padded_prompt(self, prompt: List[int], bucket: int):
        """(1, s_pad) device tokens, the prompt zero-padded to a multiple
        of `bucket` (capped at max_seq), and the real length."""
        s_real = len(prompt)
        s_pad = min(-(-s_real // bucket) * bucket, self.scfg.max_seq)
        toks = np.zeros((1, s_pad), np.int32)
        toks[0, :s_real] = prompt
        return self._upload(toks), s_real

    def _place(self, slot: int, req: Request, logits: torch.Tensor,
               s_real: int):
        """Common tail of both monolithic admissions: record the slot
        state and sample the first generated token from the prompt's last
        logits (a stop token here finishes the request at once)."""
        # device-side writes: assigning a Python scalar into a CUDA tensor
        # (lens[slot] = s_real) would copy it from the host and synchronise
        self.lens[slot:slot + 1].fill_(s_real)
        self._lens_np[slot] = s_real
        tok = sample_token(logits, generator=self._gen, **self._knobs)
        self.tokens[slot:slot + 1] = tok
        nxt = self._fetch_first_token(tok)
        self.slots[slot] = req
        req.slot = slot
        req.prefill_pos = len(req.prompt)
        req.state = RequestState.DECODING
        req.admit_seq = self._admit_seq
        self._admit_seq += 1
        if self._emit(req, nxt):
            self._finish(req)

    def _admit_prefill(self, slot: int, req: Request):
        """Dense cache: one prefill of the padded prompt straight into the
        slot's strips (a view of the engine's cache), which then hold what
        the JAX engine's sub-cache copy leaves there: the prompt's K/V at
        [0, s_pad), older contents past it."""
        self.sched.pop(req)
        toks, s_real = self._padded_prompt(req.prompt, PREFILL_BUCKET)
        s_pad = toks.shape[1]
        strips = {"k": self.cache["k"][:, slot:slot + 1],
                  "v": self.cache["v"][:, slot:slot + 1]}
        batch = {"tokens": toks,
                 "true_lens": self._upload(np.array([s_real], np.int32))}
        self.jit_calls += 1
        logits, _, _ = self._prefill(self.params, batch, strips)
        self._note_launch("prefill", rows=1, live_rows=1,
                          true_tokens=s_real, padded_tokens=s_pad,
                          kv_pages_read=0, kv_pages_written=0,
                          new_kv_tokens=s_real)
        self.prefill_tokens += s_real
        self.sched.note_work(s_real)
        self._place(slot, req, logits, s_real)

    def _admit_stepwise(self, slot: int, req: Request):
        """Token-by-token prefill through the single-token decode step (the
        recurrent families).  The JAX engine runs each of these steps over
        every lane, which advances the recurrent state of every other live
        slot by one token per prompt token, and never clears a reused
        slot's state.  Here the admitted slot's recurrent leaves are zeroed
        first, and every step runs on that slot's lane alone - views of its
        batch row, updated in place - so no other lane's state or K/V strip
        moves.  The host counters are the JAX engine's: one launch per
        prompt token, one "stepwise" record, one fetch of the first
        token."""
        self.sched.pop(req)
        lane = {k: v[:, slot:slot + 1] for k, v in self.cache.items()}
        for name in RECURRENT_LEAVES[self.model.cfg.family]:
            lane[name].zero_()
        n = len(req.prompt)
        toks = self._upload(np.asarray(req.prompt, np.int32)[None])
        pos = self._upload(np.arange(n, dtype=np.int32))
        for t in range(n):
            self.jit_calls += 1
            logits, _ = self._decode(self.params, lane, toks[:, t:t + 1],
                                     pos[t:t + 1])
        self._note_launch("stepwise", rows=1, live_rows=1, true_tokens=n,
                          padded_tokens=n, kv_pages_read=0,
                          kv_pages_written=0, new_kv_tokens=n)
        self.prefill_tokens += n
        self.sched.note_work(n)
        self._place(slot, req, logits, n)

    def _admit_paged(self, slot: int, req: Request) -> bool:
        """Paged cache: reserve the request's worst case up front and
        prefill the prompt straight into its pages.  False = out of pages
        (reservations that can never fit were refused at submit)."""
        ps = self.scfg.page_size
        need = pages_needed(len(req.prompt) + req.max_new_tokens, ps)
        if not self.allocator.can_alloc(need):
            return False
        self.sched.pop(req)
        pages = self.allocator.alloc(slot, need)
        self._note_alloc()
        toks, s_real = self._padded_prompt(req.prompt, ps)
        page_ids = self._upload(np.asarray(pages[:toks.shape[1] // ps],
                                           np.int32))
        self.cache["block_table"] = self._upload(self.allocator.table)
        batch = {"tokens": toks,
                 "true_lens": self._upload(np.array([s_real], np.int32))}
        self.jit_calls += 1
        logits, self.cache, _ = self._prefill_paged(self.params, batch,
                                                    self.cache, page_ids)
        self._note_launch("prefill_paged", rows=1, live_rows=1,
                          true_tokens=s_real, padded_tokens=toks.shape[1],
                          kv_pages_read=self._row_pages(slot, s_real),
                          kv_pages_written=self._span_pages(0, s_real),
                          new_kv_tokens=s_real)
        self.prefill_tokens += s_real
        self.sched.note_work(s_real)
        self._place(slot, req, logits, s_real)
        return True

    def _tick_monolithic(self) -> List[Request]:
        """Admit (whole-prompt prefills), then one fused decode launch over
        every lane and one fetch of the tokens."""
        w0 = self.sched.work_clock
        self._admit()
        if self._finished_this_tick and self.paged:
            # a request can finish AT admission (stop token / length 1 on
            # its first token): its pages went back to the pool, but the
            # device table still maps its lane to them - re-upload before
            # the decode step, or the lane's write (lens 0) lands in
            # position 0 of a freed page
            self._sync_table()
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            if self.sched.work_clock > w0:      # admissions that finished
                self.sched.note_tick(0, self.sched.work_clock - w0)
            return self._finished_this_tick
        self._tick_profile = (0, len(active))
        live = np.zeros((len(self.slots),), bool)
        live[active] = True
        self.jit_calls += 1
        self.decode_launches += 1
        pages_read = 0
        if self.paged:
            self.kv_pages_read += sum(
                -(-(int(self._lens_np[i]) + 1) // self.scfg.page_size)
                for i in active)
            pages_read = sum(self._row_pages(i, int(self._lens_np[i]) + 1)
                             for i in active)
        self.cache, self.tokens, self.lens = self._decode_fused(
            self.params, self.cache, self.tokens, self.lens,
            self._upload(live), self._gen)
        self._note_launch("decode", rows=len(self.slots),
                          live_rows=len(active), true_tokens=len(active),
                          padded_tokens=len(self.slots),
                          kv_pages_read=pages_read,
                          kv_pages_written=len(active) if self.paged else 0,
                          new_kv_tokens=len(active))
        self.sched.note_work(len(active))
        self._lens_np[active] += 1
        toks = self._fetch_tokens()
        for i in active:
            req = self.slots[i]
            if self._emit(req, int(toks[i, 0])):
                self._finish(req)
        self.sched.note_tick(len(active),
                             self.sched.work_clock - w0 - len(active))
        if self._finished_this_tick and self.paged:
            self._sync_table()
        return self._finished_this_tick

    # ------------------------------------------------------------------
    # chunked prefill (token-budget schedule)
    # ------------------------------------------------------------------
    def _note_alloc(self):
        self.peak_pages = max(self.peak_pages, self.allocator.used_pages)
        self.peak_live_pages = max(self.peak_live_pages,
                                   self.allocator.live_pages())

    def _reserve_chunked(self, slot: int, req: Request) -> bool:
        """Reserve the request's worst-case pages and mark it PREFILLING
        with its cursor at 0; the chunks stream in over the coming ticks.
        False = not enough free pages (it stays queued)."""
        need = pages_needed(len(req.target) + req.remaining_new,
                            self.scfg.page_size)
        if not self.allocator.can_alloc(need):
            return False
        self.allocator.alloc(slot, need)
        self._note_alloc()
        self.slots[slot] = req
        req.slot = slot
        req.prefill_pos = 0
        req.state = RequestState.PREFILLING
        req.admit_seq = self._admit_seq
        self._admit_seq += 1
        return True

    def _run_chunk_batch(self, tasks: List[ChunkTask]):
        """Execute every prefill chunk planned this tick in ONE launch: the
        scheduler packs the tasks into a ragged K-row batch (power-of-two
        bucketed, dead rows on the all-null table), each row with its own
        offset / cursor / table row; first tokens of completed prompts are
        sampled on the device into tokens / lens.  Returns the final rows'
        deferred emissions [(req, slot, work-clock stamp)]; their values
        surface in the tick's one fetch."""
        pack = self.sched.pack_chunks(tasks)
        finals = []
        for t in tasks:
            t.req.prefill_pos = t.start + t.length
            self.prefill_tokens += t.length
            self.sched.note_work(t.length)
            self.sched.chunks_run += 1
            if t.req.prefill_pos >= len(t.req.target):
                t.req.state = RequestState.DECODING
                self._table_dirty = True     # unmask the slot's device row
                self._lens_np[t.slot] = len(t.req.target)
                finals.append((t.req, t.slot, self.sched.work_clock))
        tables = np.zeros((pack.tokens.shape[0],
                           self.allocator.table.shape[1]), np.int32)
        live = pack.row_slots >= 0
        tables[live] = self.allocator.table[pack.row_slots[live]]
        batch = {"tokens": self._upload(pack.tokens),
                 "offset": self._upload(pack.offsets),
                 "true_lens": self._upload(pack.true_lens),
                 "final_slot": self._upload(pack.final_slots)}
        self.jit_calls += 1
        self.sched.packs_run += 1
        self.cache, self.tokens, self.lens = self._prefill_chunks(
            self.params, batch, self.cache, self._upload(tables),
            self.tokens, self.lens, self._gen)
        n_true = sum(t.length for t in tasks)
        self._note_launch(
            "chunk_batch", rows=int(pack.tokens.shape[0]),
            live_rows=len(tasks), true_tokens=n_true,
            padded_tokens=int(pack.tokens.shape[0] * pack.tokens.shape[1]),
            kv_pages_read=sum(self._row_pages(t.slot, t.start + t.length)
                              for t in tasks),
            kv_pages_written=sum(self._span_pages(t.start,
                                                  t.start + t.length)
                                 for t in tasks),
            new_kv_tokens=n_true)
        return finals

    def _tick_chunked(self) -> List[Request]:
        """One budgeted iteration: admit, fill the budget with prefill
        chunks (one chunk-batch launch), one fused decode launch for the
        slots that were already decoding, one fetch.  Total work never
        exceeds tick_token_budget."""
        w0 = self.sched.work_clock
        # admission first: slots + page reservations for as many queued
        # requests as the policy head allows (no prompt computation yet);
        # head-of-line backpressure when the head cannot be placed
        while True:
            req = self.sched.peek()
            if req is None:
                break
            slot = self._free_slot()
            if slot is None or not self._reserve_chunked(slot, req):
                break
            self.sched.pop(req)
        if self._table_dirty:
            self._sync_table()
        decode_slots = [i for i, r in enumerate(self.slots)
                        if r is not None
                        and r.state is RequestState.DECODING]
        prefilling = [(i, r) for i, r in enumerate(self.slots)
                      if r is not None
                      and r.state is RequestState.PREFILLING]
        budget = self.sched.prefill_budget(len(decode_slots))
        chunks = self.sched.plan_chunks(prefilling, budget)
        self._tick_profile = (len(chunks), len(decode_slots))
        finals = self._run_chunk_batch(chunks) if chunks else []
        if decode_slots:
            live = np.zeros((len(self.slots),), bool)
            live[decode_slots] = True
            self.jit_calls += 1
            self.decode_launches += 1
            self.kv_pages_read += sum(
                -(-(int(self._lens_np[i]) + 1) // self.scfg.page_size)
                for i in decode_slots)
            pages_read = sum(self._row_pages(i, int(self._lens_np[i]) + 1)
                             for i in decode_slots)
            self.cache, self.tokens, self.lens = self._decode_fused(
                self.params, self.cache, self.tokens, self.lens,
                self._upload(live), self._gen)
            self._note_launch("decode", rows=len(self.slots),
                              live_rows=len(decode_slots),
                              true_tokens=len(decode_slots),
                              padded_tokens=len(self.slots),
                              kv_pages_read=pages_read,
                              kv_pages_written=len(decode_slots),
                              new_kv_tokens=len(decode_slots))
            self.sched.note_work(len(decode_slots))
            self._lens_np[decode_slots] += 1
        if finals or decode_slots:
            # THE device->host transfer: every sampled token of the tick
            toks = self._fetch_tokens()
            for req, slot, work in finals:
                if self._emit(req, int(toks[slot, 0]), work=work):
                    self._finish(req)
            for i in decode_slots:
                req = self.slots[i]
                if self._emit(req, int(toks[i, 0])):
                    self._finish(req)
        self.sched.note_tick(len(decode_slots),
                             self.sched.work_clock - w0 - len(decode_slots))
        if self._table_dirty:
            self._sync_table()
        return self._finished_this_tick

    def tick(self) -> List[Request]:
        """One engine iteration: monolithic (admissions + one fused
        decode) or chunked (one token-budgeted round of chunks + decode).
        Returns the requests that finished in it.  Appends a dispatch row
        to launch_log: (jit_calls, host_syncs, host_wall_s, n_chunk_tasks,
        n_decode)."""
        self._finished_this_tick = []
        self._tick_profile = (0, 0)
        j0, s0 = self.jit_calls, self.host_syncs
        t0 = time.perf_counter()
        out = self._tick_chunked() if self.scfg.chunked \
            else self._tick_monolithic()
        self.tm.ticks.append(TickRecord(
            self.jit_calls - j0, self.host_syncs - s0,
            time.perf_counter() - t0, *self._tick_profile))
        return out

    def run_until_done(self, max_ticks: int = 10_000) -> List[Request]:
        """Tick until queue and slots drain; raises if `max_ticks` runs out
        with work still pending (a hung scheduler must not pass for a
        finished trace)."""
        done: List[Request] = []
        for _ in range(max_ticks):
            done.extend(self.tick())
            if not self.queue and all(s is None for s in self.slots):
                return done
        raise RuntimeError(
            f"run_until_done: {max_ticks} ticks exhausted with "
            f"{len(self.queue)} queued and "
            f"{sum(s is not None for s in self.slots)} in-flight requests "
            f"still pending ({len(done)} finished)")
