"""Continuous-batching serve engine: dense or paged KV cache, monolithic or
chunked prefill, batched one-launch ticks, speculative decoding, the radix
prefix cache and preemption; the recurrent families (hybrid, ssm) on their
state caches with stepwise admission.

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
              page.  batched=False runs one launch per chunk instead
              (_run_chunk, the sequential oracle), each final chunk
              fetching its first token at once.

Speculative decoding (speculative=True, chunked + batched): each tick a
DECODING slot may propose a draft chain by n-gram lookup over its own
history (serve/drafting.py), out of the budget its guaranteed token
leaves; all chains verify in ONE extra launch through K1's q_lens lane
(serve_step.make_spec_verify_step), which samples the target's token at
every position, accepts the matching draft prefix and sets tokens / lens
on the device; the acceptance counts come back in the tick's one fetch.
The work clock advances per accepted token only.

Prefix cache (prefix_cache=True, paged): finished requests publish their
full prompt pages into a radix tree (serve/prefix_cache.py); admission
attaches the longest cached prefix refcounted and prefills only the rest
(a monolithic admission as one K=1 chunk, _admit_prefix -> _run_chunk).
A slot about to write into a shared page gets a private copy first
(copy-on-write, _cow_guard).

Preemption (preemption=True, chunked): when the page pool or the slot
table cannot place a queued request that outranks a running one, the
lowest-priority victims are shed one at a time (_try_preempt): their
fully written pages park in the prefix tree (or return to the pool), and
they requeue as RESUMING with prompt + generated-so-far as their target,
so a resumed greedy request emits what an uninterrupted one would.

Request deadlines (submit(deadline=...) or
ServeConfig.default_deadline_tokens): a request whose work-clock age - the
engine work executed since its submit - reaches its deadline is expired
at the top of the next tick, whether queued, prefilling or decoding
(_expire_deadlines -> _expire): it finishes TIMEOUT, and its slot and
pages are freed that tick the way a preemption victim's are (fully
written positions publish into the prefix tree).  request_statuses()
names every accepted request's state.  submit(max_retries=...) is stored
for the fleet router (serve/router.py), which redispatches a dead
replica's requests at most that many times.

Span tracing (ServeConfig.telemetry): request lifecycle phases, launches
and the tick's plan / device_get / tick phases go into a bounded ring
(serve/telemetry.py SpanTracer), exportable as Perfetto JSON
(export_trace).  Every stamp is the host's clock and every argument a host
value, so tracing adds no launch and no device read; a launch span is the
host's dispatch time, not the device's (device time comes from the
profiler).

Host-side decisions read the host mirror of the lengths (`_lens_np`),
never the device tensor, so the only synchronisations are the token
fetches (_fetch_tokens per tick, _fetch_first_token per monolithic
admission and per final chunk of the sequential oracle).  Uploads go
through fresh pinned buffers copied asynchronously; the host block table
is always copied first, because torch.from_numpy aliases the array and
the allocator mutates it in place.

Tensor parallelism (tp_degree > 1) raises NotImplementedError naming its
ROADMAP item (M10).
"""
from __future__ import annotations

import math
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..configs.base import ServeConfig
from ..models.model import ATTENTION_FAMILIES, RECURRENT_LEAVES
from .paged_cache import PageAllocator, page_kv_bytes, pages_needed
from .prefix_cache import RadixPrefixCache
from .scheduler import (ChunkTask, DraftTask, Request, RequestState,
                        TokenBudgetScheduler)
from .serve_step import (make_chunk_batch_step, make_chunk_prefill_step,
                         make_fused_decode_step, make_paged_prefill_step,
                         make_prefill_step, make_serve_step,
                         make_spec_verify_step, sample_token)
from .telemetry import (TRACK_ENGINE, TRACK_QUEUE, LaunchRecord,
                        MetricsRegistry, SpanTracer, Telemetry, TickRecord,
                        export_chrome_trace, movement_breakdown)

# dense-cache prompts are padded to a multiple of this before the
# monolithic prefill (the JAX engine's jit bucket; kept so that both
# engines prefill the same shapes and write the same strip positions)
PREFILL_BUCKET = 16


def _refuse_unported(scfg: ServeConfig):
    """NotImplementedError for the ServeConfig setting this slice of the
    port does not serve (tensor parallelism), naming its ROADMAP item."""
    if scfg.tp_degree > 1:
        raise NotImplementedError(
            f"tp_degree={scfg.tp_degree} is not ported to the PyTorch "
            f"engine yet (ROADMAP M10); it serves chunked=True (batched or "
            f"the sequential oracle) on the paged cache and chunked=False "
            f"on the dense or paged cache, with speculative decoding, the "
            f"prefix cache, preemption, request deadlines and the span "
            f"tracer")


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
        # one metrics registry per engine (the scheduler, allocator and
        # prefix cache register into it), plus the span tracer when
        # ServeConfig.telemetry is on.  The metric names and help strings
        # are the JAX engine's, so the two registries compare one to one
        tracer = SpanTracer(scfg.telemetry_spans) if scfg.telemetry else None
        self.tm = Telemetry(registry=MetricsRegistry(), tracer=tracer)
        m = self.tm.registry
        m.counter("serve_jit_calls_total",
                  "Jitted model-step launches dispatched")
        m.counter("serve_host_syncs_total",
                  "Device->host transfers (token fetches and admission "
                  "samples)")
        m.counter("serve_prefill_tokens_total",
                  "Prompt tokens actually computed by prefill")
        m.counter("serve_prefix_hit_tokens_total",
                  "Prompt tokens served from the prefix cache instead of "
                  "being recomputed")
        m.counter("serve_cow_copies_total",
                  "Device-side copy-on-write page copies")
        m.counter("serve_gen_tokens_total", "Generation tokens emitted")
        m.counter("serve_decode_launches_total",
                  "Token-emitting launches (fused decode + spec verify)")
        m.counter("serve_kv_pages_read_total",
                  "KV pages read by token-emitting launches (analytic "
                  "host-side count, not a device counter)")
        m.counter("serve_requests_submitted_total",
                  "Requests accepted by submit()")
        m.counter("serve_requests_finished_total",
                  "Requests finished (length or stop token)")
        m.gauge("serve_peak_pages",
                "High-water mark of pool pages in use (cached included)")
        m.gauge("serve_peak_live_pages",
                "High-water mark of distinct pages referenced by slots")
        m.gauge("serve_outstanding_work_tokens",
                "Queued + in-flight work tokens (prompt remaining plus "
                "unspent generation budget) - the load signal load_stats() "
                "publishes for the fleet router")
        m.gauge("serve_tp_degree",
                "Tensor-parallel degree of this engine (devices the "
                "head-sharded KV page pool spans; 1 = single-device)")
        m.counter("serve_tp_shard_kv_bytes_read_total",
                  "KV bytes read PER DEVICE by token-emitting launches "
                  "(kv_pages_read converted through the head-sharded "
                  "per-shard page bytes; equals the full page bytes at "
                  "tp_degree 1)")
        m.counter("serve_tp_table_bytes_replicated_total",
                  "Block-table bytes uploaded times tp_degree - the "
                  "replication overhead of keeping the table as scalar-"
                  "prefetch state on every shard")
        m.get("serve_tp_degree").set(scfg.tp_degree)
        # bytes of one page on one device: the whole page (tp_degree 1)
        self._shard_page_bytes = page_kv_bytes(model.cfg, scfg.page_size)
        self.paged = scfg.paged
        self._attention_family = model.cfg.family in ATTENTION_FAMILIES
        if scfg.speculative and not self._attention_family:
            raise ValueError(f"speculative serving needs an attention "
                             f"family, got {model.cfg.family}")
        if scfg.prefix_cache and not scfg.paged:
            raise ValueError("prefix_cache requires paged=True")
        self.allocator: Optional[PageAllocator] = None
        self.prefix: Optional[RadixPrefixCache] = None
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
            if scfg.prefix_cache:
                self.prefix = RadixPrefixCache(self.allocator,
                                               scfg.page_size, metrics=m)
                self.prefix.event_cb = self._prefix_event
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
        # set by the first submit with a deadline: until then the per-tick
        # expiry sweep is one boolean check
        self._deadlines_active = False
        self._table_dirty = False    # device block table behind the host's
        # host mirror of `lens`: every host-side decision reads this instead
        # of syncing the device tensor - lengths follow from scheduling
        self._lens_np = np.zeros((B,), np.int64)
        self._knobs = dict(temperature=scfg.temperature, top_k=scfg.top_k,
                           top_p=scfg.top_p)
        self._decode = make_serve_step(model)
        self._prefill = make_prefill_step(model)
        self._prefill_paged = make_paged_prefill_step(model)
        # one step serves the prefix-cached suffix and the sequential
        # oracle's chunks: a suffix is a final chunk
        self._prefill_chunk = make_chunk_prefill_step(model)
        self._prefill_chunks = make_chunk_batch_step(model, **self._knobs)
        self._decode_fused = make_fused_decode_step(model, **self._knobs)
        self._spec_verify = make_spec_verify_step(model, **self._knobs)

    # registry-backed views (one source of truth: the metrics registry)
    jit_calls = _registry_counter("serve_jit_calls_total")
    host_syncs = _registry_counter("serve_host_syncs_total")
    prefill_tokens = _registry_counter("serve_prefill_tokens_total")
    prefix_hit_tokens = _registry_counter("serve_prefix_hit_tokens_total")
    cow_copies = _registry_counter("serve_cow_copies_total")
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

    # ------------------------------------------------------------------
    # telemetry surface
    # ------------------------------------------------------------------
    def export_trace(self, path, clock: str = "wall") -> Dict[str, Any]:
        """Write the span tracer's records as Chrome trace-event JSON
        (open in Perfetto or chrome://tracing): request phases on per-slot
        tracks, engine phases and launches on engine tracks.  clock="wall"
        for the host's wall clock, "work" for the deterministic work
        clock.  Returns the trace dict (path=None writes nothing)."""
        if self.tm.tracer is None:
            raise ValueError(
                "span tracing is off: build the engine with "
                "ServeConfig(telemetry=True) to record spans")
        return export_chrome_trace(path, self.tm.tracer,
                                   self.scfg.max_batch, clock=clock)

    def metrics_snapshot(self) -> Dict[str, Any]:
        """JSON-ready snapshot of every registered metric."""
        return self.tm.registry.snapshot()

    def prometheus_metrics(self) -> str:
        """Every registered metric in Prometheus text exposition format."""
        return self.tm.registry.prometheus_text()

    def movement_stats(self) -> Dict[str, Dict[str, float]]:
        """Data-movement breakdown per launch kind from the launch
        records: a first-order byte model (HBM, SRAM) and the energy the
        paper's 16 nm table gives those bytes (telemetry.
        movement_breakdown) - neither is a measurement of the GPU."""
        return movement_breakdown(self.tm.launches, self.model.cfg,
                                  self.scfg)

    def _prefix_event(self, name: str, **args):
        """Prefix-cache hit / publish / evict instants onto the engine
        track (RadixPrefixCache.event_cb; a no-op with the tracer off)."""
        tr = self.tm.tracer
        if tr is not None:
            tr.add_event(name, "prefix", TRACK_ENGINE, self.sched.ticks,
                         self.sched.work_clock, tr.now(), **args)

    def _wall(self) -> float:
        """Tracer wall stamp (host clock); 0.0, never read, with the
        tracer off."""
        tr = self.tm.tracer
        return tr.now() if tr is not None else 0.0

    def _phase(self, req: Request, phase: str, track: int, **args):
        """A request's lifecycle phase onto the tracer (no-op off)."""
        self.tm.request_phase(req.uid, phase, track, self.sched.ticks,
                              self.sched.work_clock, **args)

    def _event(self, req: Request, name: str, track: int, **args):
        self.tm.request_event(req.uid, name, track, self.sched.ticks,
                              self.sched.work_clock, **args)

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

    def _fetch_tokens(self, n_acc: Optional[torch.Tensor] = None):
        """THE tick's device->host transfer: the (B, 1) token array after
        the fused steps wrote every lane's sampled token into it.  With
        the verify launch's (K,) acceptance counts `n_acc`, both come back
        in the same transfer (concatenated on the device) as (tokens,
        counts)."""
        self.host_syncs += 1
        if n_acc is None:
            return self.tokens.cpu().numpy()
        B = self.tokens.shape[0]
        both = torch.cat([self.tokens[:, 0], n_acc.to(self.tokens.dtype)])
        both = both.cpu().numpy()
        return both[:B, None], both[B:]

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
                     new_kv_tokens: int, wall0: float = 0.0,
                     wall1: float = 0.0):
        """Record one launch's data-movement record and, with the tracer
        on, its span on the engine track from wall0 to wall1 (host
        stamps around the dispatch)."""
        self.tm.launch(LaunchRecord(
            tick=self.sched.ticks, kind=kind, rows=rows,
            live_rows=live_rows, true_tokens=true_tokens,
            padded_tokens=padded_tokens, kv_pages_read=kv_pages_read,
            kv_pages_written=kv_pages_written, new_kv_tokens=new_kv_tokens,
            work_clock=self.sched.work_clock), wall0, wall1)

    def _note_kv_pages_read(self, n_pages: int):
        """Count pages a token-emitting launch read, in pages and in
        per-device bytes (the whole page at tp_degree 1)."""
        n = int(n_pages)
        self.kv_pages_read += n
        self.tm.registry.get("serve_tp_shard_kv_bytes_read_total").inc(
            n * self._shard_page_bytes)

    def _note_table_upload(self, nbytes: int):
        """Count one block-table upload (the bytes times tp_degree, 1)."""
        self.tm.registry.get("serve_tp_table_bytes_replicated_total").inc(
            int(nbytes))

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
        larger than the pool, a deadline the prompt's own prefill would
        already miss - fails here.  `stop_tokens` (merged with
        ServeConfig.eos_id) end generation the tick one is produced;
        higher `priority` admits first.  `deadline` is a work-clock
        deadline in tokens (default ServeConfig.default_deadline_tokens, 0
        or None = none): once the engine has executed that much work since
        the submit, the request expires TIMEOUT at the top of the next
        tick.  `max_retries` caps how many times a fleet router may
        redispatch the request off a failed replica (None = unbounded)."""
        n_new = self.scfg.max_new_tokens if max_new_tokens is None \
            else max_new_tokens
        if not prompt:
            raise ValueError("empty prompt")
        if n_new < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {n_new}")
        if deadline is None:
            deadline = self.scfg.default_deadline_tokens or None
        if deadline is not None:
            if deadline <= 0:
                raise ValueError(f"deadline must be >= 1 work token, "
                                 f"got {deadline}")
            if deadline <= len(prompt):
                # the prompt alone costs len(prompt) work tokens of prefill
                # before a first token can exist
                raise ValueError(
                    f"deadline ({deadline}) is not above the prompt's "
                    f"minimum prefill work ({len(prompt)} tokens): the "
                    f"request could never produce a token in time")
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
                      priority=int(priority), deadline_tokens=deadline,
                      max_retries=max_retries)
        if deadline is not None:
            self._deadlines_active = True
        self.sched.submit(req)
        self.tm.registry.get("serve_requests_submitted_total").inc()
        self._phase(req, "QUEUED", TRACK_QUEUE,
                    prompt_tokens=len(prompt), priority=int(priority))
        return self._uid

    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def prefix_stats(self) -> Dict[str, int]:
        """Prefill / prefix-cache counters (zeros when caching is off)."""
        return {"prefill_tokens": self.prefill_tokens,
                "prefix_hit_tokens": self.prefix_hit_tokens,
                "prompt_tokens": self.prefill_tokens
                + self.prefix_hit_tokens,
                "cow_copies": self.cow_copies,
                "cached_pages": self.prefix.cached_pages
                if self.prefix is not None else 0,
                "peak_pages": self.peak_pages,
                "peak_live_pages": self.peak_live_pages}

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
                "evictable_pages": self.prefix.evictable_pages()
                if self.prefix is not None else 0}

    def stats(self) -> Dict[str, float]:
        """Scheduler latency aggregates (TTFT / time-between-tokens, wall
        and work clock), budget accounting, prefill counters and dispatch
        accounting (launches, device->host transfers, host wall per
        tick)."""
        out: Dict[str, float] = dict(self.sched.stats())
        out.update(self.prefix_stats())
        out["tick_token_budget"] = self.scfg.tick_token_budget
        out["chunked"] = self.scfg.chunked
        out["batched"] = self.scfg.batched
        out["jit_calls"] = self.jit_calls
        out["host_syncs"] = self.host_syncs
        out["speculative"] = self.scfg.speculative
        out["telemetry"] = self.tm.enabled
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
        mirroring (paged), the prefix tree against the allocator, slot
        back-references, queue states and the lens mirror.  Never touches
        a device tensor."""
        if self.prefix is not None:
            self.prefix.check_invariants()
        elif self.paged:
            self.allocator.check_invariants()
        if self.paged:
            # the per-device byte count follows the page count exactly
            shard_bytes = int(self.tm.registry.get(
                "serve_tp_shard_kv_bytes_read_total").value)
            assert shard_bytes == self.kv_pages_read \
                * self._shard_page_bytes, \
                (f"per-shard KV byte accounting drifted: {shard_bytes} != "
                 f"{self.kv_pages_read} pages x {self._shard_page_bytes} "
                 f"bytes/shard-page")
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
            assert r.state in (RequestState.QUEUED, RequestState.RESUMING)
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
        """Free the request's slot; its pages go back to the pool (or its
        full prompt pages into the prefix tree) the same tick."""
        i = req.slot
        req.state = RequestState.DONE
        req.done = True
        self.slots[i] = None
        # a device-side fill: assigning a Python scalar (lens[i] = 0) would
        # copy it from the host and synchronise
        self.lens[i:i + 1].zero_()
        self._lens_np[i] = 0
        if self.prefix is not None:
            self.prefix.release(i, req.prompt)
        elif self.paged:
            self.allocator.free_slot(i)
        if self.paged:
            self._table_dirty = True     # zero the slot's device row
        self.sched.note_finished(req)
        self.tm.registry.get("serve_requests_finished_total").inc()
        self._phase(req, "DONE", i, reason=req.finish_reason,
                    out_tokens=len(req.out_tokens))
        self._finished_this_tick.append(req)

    def _expire(self, req: Request):
        """Deadline timeout: take the request out of the engine - queued,
        prefilling or decoding - and free what it holds the same tick.  A
        slot-holding request frees like a preemption victim (only fully
        valid positions publish into the prefix tree: the cursor while
        prefilling, the lens mirror while decoding; without the tree its
        pages return to the pool), its lane zeroed on the device and the
        table marked dirty; no device value is read.  It finishes TIMEOUT
        (finish_reason "timeout") in the tick's finished list."""
        i = req.slot
        if i is not None:
            if self.prefix is not None:
                if req.state is RequestState.PREFILLING:
                    n_valid = req.prefill_pos
                    seq = list(req.target)
                else:
                    seq = req.prompt + list(req.out_tokens)
                    n_valid = int(self._lens_np[i])
                self.prefix.release(i, seq[:n_valid])
            elif self.paged:
                self.allocator.free_slot(i)
            self.slots[i] = None
            self.lens[i:i + 1].zero_()       # device-side, no host sync
            self._lens_np[i] = 0
            req.slot = None
            if self.paged:
                self._table_dirty = True
        else:
            self.sched.queue.remove(req)
        req.state = RequestState.TIMEOUT
        req.done = True
        req.finish_reason = "timeout"
        self.sched.timeouts += 1
        self.sched.note_finished(req)
        self._phase(req, "TIMEOUT", i if i is not None else TRACK_QUEUE,
                    out_tokens=len(req.out_tokens))
        self._finished_this_tick.append(req)

    def _expire_deadlines(self):
        """Top-of-tick sweep (both tick flavors): expire every request,
        queued or in flight, whose work-clock age reached its deadline
        (the scheduler's predicate, sched.expired).  Before admission and
        planning, so an expired request does no work in the tick and the
        pages it frees are admissible at once."""
        if not self._deadlines_active:
            return
        expired = [r for r in self.sched.queue if self.sched.expired(r)]
        expired += [r for r in self.slots
                    if r is not None and self.sched.expired(r)]
        for r in expired:
            self._expire(r)

    def request_statuses(self) -> Dict[int, str]:
        """{uid: state} for every request this engine has accepted:
        terminal ("done" / "timeout" / "failed") or live ("queued" /
        "prefilling" / "decoding" / "resuming"), from the finished list,
        the queue and the slots."""
        out: Dict[int, str] = {}
        for r in self.sched.finished:
            out[r.uid] = r.state.value
        for r in self.queue:
            out[r.uid] = r.state.value
        for r in self.slots:
            if r is not None:
                out[r.uid] = r.state.value
        return out

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
        self._note_table_upload(tbl.nbytes)
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
        self._stamp_admit(req)
        self._phase(req, "DECODING", slot)
        if self._emit(req, nxt):
            self._finish(req)

    def _stamp_admit(self, req: Request):
        """Monotone admission stamp: preemption sheds the most recently
        admitted PREFILLING victim first (least sunk prefill work)."""
        req.admit_seq = self._admit_seq
        self._admit_seq += 1

    def _admit_prefill(self, slot: int, req: Request):
        """Dense cache: one prefill of the padded prompt straight into the
        slot's strips (a view of the engine's cache), which then hold what
        the JAX engine's sub-cache copy leaves there: the prompt's K/V at
        [0, s_pad), older contents past it."""
        self.sched.pop(req)
        self._phase(req, "PREFILLING", slot)
        toks, s_real = self._padded_prompt(req.prompt, PREFILL_BUCKET)
        s_pad = toks.shape[1]
        strips = {"k": self.cache["k"][:, slot:slot + 1],
                  "v": self.cache["v"][:, slot:slot + 1]}
        batch = {"tokens": toks,
                 "true_lens": self._upload(np.array([s_real], np.int32))}
        self.jit_calls += 1
        w0 = self._wall()
        logits, _, _ = self._prefill(self.params, batch, strips)
        self._note_launch("prefill", rows=1, live_rows=1,
                          true_tokens=s_real, padded_tokens=s_pad,
                          kv_pages_read=0, kv_pages_written=0,
                          new_kv_tokens=s_real, wall0=w0,
                          wall1=self._wall())
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
        self._phase(req, "PREFILLING", slot)
        lane = {k: v[:, slot:slot + 1] for k, v in self.cache.items()}
        for name in RECURRENT_LEAVES[self.model.cfg.family]:
            lane[name].zero_()
        n = len(req.prompt)
        toks = self._upload(np.asarray(req.prompt, np.int32)[None])
        pos = self._upload(np.arange(n, dtype=np.int32))
        w0 = self._wall()
        for t in range(n):
            self.jit_calls += 1
            logits, _ = self._decode(self.params, lane, toks[:, t:t + 1],
                                     pos[t:t + 1])
        self._note_launch("stepwise", rows=1, live_rows=1, true_tokens=n,
                          padded_tokens=n, kv_pages_read=0,
                          kv_pages_written=0, new_kv_tokens=n, wall0=w0,
                          wall1=self._wall())
        self.prefill_tokens += n
        self.sched.note_work(n)
        self._place(slot, req, logits, n)

    def _ensure_free(self, n: int, protect=frozenset()) -> bool:
        """True if n pages are (or can be made) free: with the prefix cache
        LRU-evicts unreferenced cached pages, never those in `protect`
        (about to be attached) or any a slot references."""
        if self.allocator.can_alloc(n):
            return True
        if self.prefix is not None:
            self.prefix.evict(n - self.allocator.free_pages,
                              protect=frozenset(protect))
        return self.allocator.can_alloc(n)

    def _copy_page(self, src: int, dst: int):
        """The data half of copy-on-write: page src into page dst in every
        layer's K and V pool, on the device (views of the stacked (L, P,
        ps, Hkv, D) pools; no host sync)."""
        for key in ("k_pages", "v_pages"):
            pool = self.cache[key]
            pool[:, dst].copy_(pool[:, src])

    def _admit_paged(self, slot: int, req: Request) -> bool:
        """Paged cache: reserve the request's worst case up front and
        prefill the prompt straight into its pages.  False = out of pages
        (reservations that can never fit were refused at submit)."""
        if self.prefix is not None:
            return self._admit_prefix(slot, req)
        ps = self.scfg.page_size
        need = pages_needed(len(req.prompt) + req.max_new_tokens, ps)
        if not self.allocator.can_alloc(need):
            return False
        self.sched.pop(req)
        self._phase(req, "PREFILLING", slot)
        pages = self.allocator.alloc(slot, need)
        self._note_alloc()
        toks, s_real = self._padded_prompt(req.prompt, ps)
        page_ids = self._upload(np.asarray(pages[:toks.shape[1] // ps],
                                           np.int32))
        self.cache["block_table"] = self._upload(self.allocator.table)
        self._note_table_upload(self.allocator.table.nbytes)
        batch = {"tokens": toks,
                 "true_lens": self._upload(np.array([s_real], np.int32))}
        self.jit_calls += 1
        w0 = self._wall()
        logits, self.cache, _ = self._prefill_paged(self.params, batch,
                                                    self.cache, page_ids)
        self._note_launch("prefill_paged", rows=1, live_rows=1,
                          true_tokens=s_real, padded_tokens=toks.shape[1],
                          kv_pages_read=self._row_pages(slot, s_real),
                          kv_pages_written=self._span_pages(0, s_real),
                          new_kv_tokens=s_real, wall0=w0,
                          wall1=self._wall())
        self.prefill_tokens += s_real
        self.sched.note_work(s_real)
        self._place(slot, req, logits, s_real)
        return True

    def _reserve_prefix(self, slot: int, req: Request) -> Optional[int]:
        """Prefix-cached reservation: attach the longest cached prefix of
        the request's target, allocate the rest of its worst case, and
        copy-on-write the final cached page when the whole prompt is
        covered (its last token is recomputed for its logits, and that
        token's K/V lands in that page).  Returns the cursor computation
        starts from, or None when out of pages even after eviction.  A
        RESUMING request's target is prompt + pre-preemption output: the
        match finds the pages that survived, only the rest re-prefills."""
        ps = self.scfg.page_size
        target = req.target
        P = len(target)
        matched = self.prefix.match(target)
        full_cover = bool(matched) and len(matched) * ps >= P
        shared = matched[:-1] if full_cover else matched
        n_fresh = pages_needed(P + req.remaining_new, ps) - len(shared)
        if not self._ensure_free(n_fresh, protect=matched):
            return None
        if shared:
            self.allocator.attach(slot, shared)
        owned = self.allocator.alloc(slot, n_fresh)
        if full_cover:
            self._copy_page(matched[-1], owned[len(shared)])
            self.cow_copies += 1
        self._note_alloc()
        start = P - 1 if full_cover else len(shared) * ps
        self.prefix_hit_tokens += start
        return start

    def _admit_prefix(self, slot: int, req: Request) -> bool:
        """Prefix-cached monolithic admission: the uncached suffix prefills
        in one launch - it is the request's final chunk, so _run_chunk
        runs it (and samples the first token).  False = out of pages even
        after eviction."""
        start = self._reserve_prefix(slot, req)
        if start is None:
            return False
        self.sched.pop(req)
        self.slots[slot] = req
        req.slot = slot
        req.prefill_pos = start
        req.state = RequestState.PREFILLING
        self._stamp_admit(req)
        self._phase(req, "PREFILLING", slot, cached_tokens=start)
        # the decode launch later this tick walks the slot's device row
        self.cache["block_table"] = self._upload(self.allocator.table)
        self._note_table_upload(self.allocator.table.nbytes)
        self._run_chunk(ChunkTask(req, slot, start,
                                  len(req.prompt) - start))
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
        if self.prefix is not None:
            self._cow_guard()
        live = np.zeros((len(self.slots),), bool)
        live[active] = True
        self.jit_calls += 1
        self.decode_launches += 1
        pages_read = 0
        if self.paged:
            self._note_kv_pages_read(sum(
                -(-(int(self._lens_np[i]) + 1) // self.scfg.page_size)
                for i in active))
            pages_read = sum(self._row_pages(i, int(self._lens_np[i]) + 1)
                             for i in active)
        lw0 = self._wall()
        self.cache, self.tokens, self.lens = self._decode_fused(
            self.params, self.cache, self.tokens, self.lens,
            self._upload(live), self._gen)
        self._note_launch("decode", rows=len(self.slots),
                          live_rows=len(active), true_tokens=len(active),
                          padded_tokens=len(self.slots),
                          kv_pages_read=pages_read,
                          kv_pages_written=len(active) if self.paged else 0,
                          new_kv_tokens=len(active), wall0=lw0,
                          wall1=self._wall())
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
            self._maybe_evict_watermark()
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
        """Reserve the request's worst-case pages (through the prefix cache
        when it is on) and mark it PREFILLING with its cursor at the cached
        prefix's end; the chunks stream in over the coming ticks.  False =
        not enough free pages (it stays queued)."""
        if self.prefix is not None:
            start = self._reserve_prefix(slot, req)
            if start is None:
                return False
        else:
            need = pages_needed(len(req.target) + req.remaining_new,
                                self.scfg.page_size)
            if not self.allocator.can_alloc(need):
                return False
            self.allocator.alloc(slot, need)
            self._note_alloc()
            start = 0
        self.slots[slot] = req
        req.slot = slot
        req.prefill_pos = start
        req.state = RequestState.PREFILLING
        self._stamp_admit(req)
        self._phase(req, "PREFILLING", slot, cached_tokens=start)
        return True

    def _run_chunk(self, task: ChunkTask):
        """One planned chunk in one launch (K1 at K = 1): its K/V lands in
        the slot's pages and its queries attend over everything already
        written (cached prefix, earlier chunks).  A final chunk samples
        the first token on the device, fetches it at once and flips the
        request to DECODING.  The sequential oracle (batched=False) and
        the prefix-cached monolithic admission run chunks this way."""
        req, slot = task.req, task.slot
        ps = self.scfg.page_size
        start, n = task.start, task.length
        s_pad = -(-n // ps) * ps
        toks = np.zeros((1, s_pad), np.int32)
        toks[0, :n] = req.target[start:start + n]
        batch = {"tokens": self._upload(toks),
                 "offset": self._upload(np.array([start], np.int32)),
                 "true_lens": self._upload(np.array([start + n], np.int32))}
        self.jit_calls += 1
        w0 = self._wall()
        logits, self.cache, _ = self._prefill_chunk(
            self.params, batch, self.cache,
            self._upload(self.allocator.table[slot]))
        req.prefill_pos = start + n
        self.prefill_tokens += n
        self.sched.note_work(n)
        self.sched.chunks_run += 1
        self._note_launch("chunk", rows=1, live_rows=1, true_tokens=n,
                          padded_tokens=s_pad,
                          kv_pages_read=self._row_pages(slot, start + n),
                          kv_pages_written=self._span_pages(start,
                                                            start + n),
                          new_kv_tokens=n, wall0=w0, wall1=self._wall())
        if req.prefill_pos >= len(req.target):
            # device-side writes, no host scalar copies (see _place)
            self.lens[slot:slot + 1].fill_(len(req.target))
            self._lens_np[slot] = len(req.target)
            tok = sample_token(logits, generator=self._gen, **self._knobs)
            self.tokens[slot:slot + 1] = tok
            nxt = self._fetch_first_token(tok)
            req.state = RequestState.DECODING
            self._phase(req, "DECODING", slot)
            self._table_dirty = True     # unmask the slot's device row
            if self._emit(req, nxt):
                self._finish(req)

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
                self._phase(t.req, "DECODING", t.slot)
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
        w0 = self._wall()
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
            new_kv_tokens=n_true, wall0=w0, wall1=self._wall())
        return finals

    def _run_spec_verify(self, tasks: List[DraftTask]):
        """Every draft chain planned this tick in ONE launch through K1's
        q_lens lane: the scheduler packs the chains into a ragged verify
        batch with per-row table rows from the host allocator; the device
        samples the target at every chain position, accepts the matching
        draft prefix, writes the bonus token into tokens and the new KV
        frontier into lens (rejected positions past it are dead).  Returns
        (the SpecBatch, the (K,) acceptance counts on the device, for the
        tick's one fetch)."""
        pack = self.sched.pack_drafts(tasks, self._lens_np)
        tables = np.zeros((pack.tokens.shape[0],
                           self.allocator.table.shape[1]), np.int32)
        live = pack.row_slots < self.scfg.max_batch
        tables[live] = self.allocator.table[pack.row_slots[live]]
        batch = {"tokens": self._upload(pack.tokens),
                 "offset": self._upload(pack.offsets),
                 "true_lens": self._upload(pack.true_lens),
                 "q_lens": self._upload(pack.q_lens),
                 "draft_lens": self._upload(pack.draft_lens),
                 "row_slot": self._upload(pack.row_slots)}
        self.jit_calls += 1
        self.decode_launches += 1
        ps = self.scfg.page_size
        self._note_kv_pages_read(sum(-(-int(t) // ps)
                                     for t in pack.true_lens[live]))
        w0 = self._wall()
        self.cache, self.tokens, self.lens, n_acc = \
            self._spec_verify(self.params, batch, self.cache,
                              self._upload(tables), self.tokens, self.lens,
                              self._gen)
        n_q = sum(1 + len(t.draft) for t in pack.tasks)
        self._note_launch(
            "spec_verify", rows=int(pack.tokens.shape[0]),
            live_rows=len(pack.tasks), true_tokens=n_q,
            padded_tokens=int(pack.tokens.shape[0] * pack.tokens.shape[1]),
            kv_pages_read=sum(self._row_pages(t.slot,
                                              t.offset + 1 + len(t.draft))
                              for t in pack.tasks),
            kv_pages_written=sum(
                self._span_pages(t.offset, t.offset + 1 + len(t.draft))
                for t in pack.tasks),
            new_kv_tokens=n_q, wall0=w0, wall1=self._wall())
        return pack, n_acc

    # ------------------------------------------------------------------
    # preemption: shed lower-priority load when the page pool or the slot
    # table cannot place a higher-priority admission candidate
    # ------------------------------------------------------------------
    def _next_victim(self, cand: Request) -> Optional[Request]:
        """Only requests CAND strictly outranks are eligible (equal
        priority never preempts).  PREFILLING victims first - lowest
        priority, most recently admitted first - then DECODING ones,
        lowest priority, longest remaining generation first."""
        best, best_key = None, None
        for r in self.slots:
            if r is None or r.priority >= cand.priority:
                continue
            if r.state is RequestState.PREFILLING:
                key = (0, r.priority, -r.admit_seq)
            elif r.state is RequestState.DECODING:
                key = (1, r.priority, -r.remaining_new, -r.admit_seq)
            else:
                continue
            if best_key is None or key < best_key:
                best, best_key = r, key
        return best

    def _preempt(self, victim: Request):
        """Shed one running request: drop its slot's reference on every
        page (private pages return to the pool, tree pages survive), zero
        its lane, and requeue it as RESUMING; a mid-decode victim resumes
        from prompt + generated-so-far (Request.target).  With the prefix
        cache its fully written pages park in the tree, keyed by the
        tokens whose K/V they hold - only fully valid positions: the
        cursor of a PREFILLING victim, the lens mirror of a DECODING one
        (the pending token's K/V is unwritten, and rejected draft K/V past
        lens must never enter the tree)."""
        slot = victim.slot
        free0 = self.allocator.free_pages
        if self.prefix is not None:
            if victim.state is RequestState.PREFILLING:
                n_valid = victim.prefill_pos
                seq = list(victim.target)
            else:
                seq = victim.prompt + list(victim.out_tokens)
                n_valid = int(self._lens_np[slot])
            cached0 = self.prefix.cached_pages
            self.prefix.release(slot, seq[:n_valid])
            self.sched.pages_parked += self.prefix.cached_pages - cached0
        else:
            self.allocator.free_slot(slot)
        self.sched.pages_reclaimed += self.allocator.free_pages - free0
        self.sched.preemptions += 1
        victim.n_preemptions += 1
        self._event(victim, "PREEMPT", slot,
                    pages_reclaimed=self.allocator.free_pages - free0)
        self._phase(victim, "RESUMING", TRACK_QUEUE)
        self.slots[slot] = None
        self.lens[slot:slot + 1].zero_()     # device-side, no host sync
        self._lens_np[slot] = 0
        victim.slot = None
        victim.prefill_pos = 0
        if victim.out_tokens:
            victim.resume_tokens = victim.prompt + list(victim.out_tokens)
        victim.state = RequestState.RESUMING
        self.sched.requeue(victim)
        self._table_dirty = True     # the lane must mask to the null page

    def _try_preempt(self, cand: Request) -> bool:
        """Shed ONE victim toward placing CAND (admission retries after
        each).  False when preemption is off, no victim is eligible, or
        shedding every eligible victim and evicting the whole prefix cache
        could still not cover CAND's worst-case reservation."""
        if not self.scfg.preemption:
            return False
        victim = self._next_victim(cand)
        if victim is None:
            return False
        need = pages_needed(len(cand.target) + cand.remaining_new,
                            self.scfg.page_size)
        headroom = self.allocator.free_pages
        if self.prefix is not None:
            headroom += self.prefix.evictable_pages()
        # distinct pages: one shared by two victims frees only once
        victim_pages = {p for r in self.slots
                        if r is not None and r.priority < cand.priority
                        for p in self.allocator.slot_pages(r.slot)}
        if need > headroom + len(victim_pages):
            return False
        self._preempt(victim)
        return True

    def _tick_chunked(self) -> List[Request]:
        """One budgeted iteration: admit (preempting where a queued request
        outranks a running one and cannot be placed), fill the budget with
        draft chains and prefill chunks, then ONE chunk-batch launch, ONE
        verify launch, ONE fused decode launch for the slots without a
        chain, and ONE fetch.  Total work never exceeds
        tick_token_budget.  batched=False runs one launch per chunk.
        With the tracer on, the planning (admission included) and the
        fetch are spans of their own."""
        w0 = self.sched.work_clock
        wp0 = self._wall()
        # admission first (a decoding victim shed here must not join this
        # tick's launches): reserve slots + pages for as many queued
        # requests as the policy head allows; when the head cannot be
        # placed, shed victims one at a time and retry, else head-of-line
        # backpressure
        while True:
            req = self.sched.peek()
            if req is None:
                break
            resuming = req.state is RequestState.RESUMING
            placed = False
            while True:
                slot = self._free_slot()
                if slot is not None and self._reserve_chunked(slot, req):
                    placed = True
                    break
                if not self._try_preempt(req):
                    break
            if not placed:
                break
            self.sched.pop(req)
            if resuming:
                self.sched.resumes += 1
                req.n_resumes += 1
                self._event(req, "RESUME", req.slot)
        if self._table_dirty:
            self._sync_table()
        decode_slots = [i for i, r in enumerate(self.slots)
                        if r is not None
                        and r.state is RequestState.DECODING]
        prefilling = [(i, r) for i, r in enumerate(self.slots)
                      if r is not None
                      and r.state is RequestState.PREFILLING]
        # drafts come out of the budget left after every decoding slot's
        # guaranteed token; prefill planning gets what remains
        spec_tasks: List[DraftTask] = []
        if self.scfg.speculative and decode_slots:
            room = self.scfg.tick_token_budget - len(decode_slots)
            spec_tasks = self.sched.plan_drafts(
                [(i, self.slots[i]) for i in decode_slots], room)
        spec_tokens = sum(len(t.draft) for t in spec_tasks)
        budget = self.sched.prefill_budget(len(decode_slots) + spec_tokens)
        chunks = self.sched.plan_chunks(prefilling, budget)
        self._tick_profile = (len(chunks), len(decode_slots))
        tr = self.tm.tracer
        if tr is not None:
            tr.add_span("plan", "tick", TRACK_ENGINE, self.sched.ticks,
                        w0, self.sched.work_clock, wp0, tr.now(),
                        n_chunks=len(chunks), n_decode=len(decode_slots),
                        n_drafts=len(spec_tasks))
        finals = []
        if chunks and self.scfg.batched:
            finals = self._run_chunk_batch(chunks)
        else:
            for task in chunks:
                self._run_chunk(task)
        # drafted slots verify their chain in the spec launch; the rest
        # take their one token through the fused decode
        spec_slots = {t.slot for t in spec_tasks}
        plain_slots = [i for i in decode_slots if i not in spec_slots]
        if decode_slots and self.prefix is not None:
            self._cow_guard({t.slot: len(t.draft) for t in spec_tasks})
        spec_pack = spec_nacc = None
        if spec_tasks:
            spec_pack, spec_nacc = self._run_spec_verify(spec_tasks)
        if plain_slots:
            live = np.zeros((len(self.slots),), bool)
            live[plain_slots] = True
            self.jit_calls += 1
            self.decode_launches += 1
            self._note_kv_pages_read(sum(
                -(-(int(self._lens_np[i]) + 1) // self.scfg.page_size)
                for i in plain_slots))
            pages_read = sum(self._row_pages(i, int(self._lens_np[i]) + 1)
                             for i in plain_slots)
            lw0 = self._wall()
            self.cache, self.tokens, self.lens = self._decode_fused(
                self.params, self.cache, self.tokens, self.lens,
                self._upload(live), self._gen)
            self._note_launch("decode", rows=len(self.slots),
                              live_rows=len(plain_slots),
                              true_tokens=len(plain_slots),
                              padded_tokens=len(self.slots),
                              kv_pages_read=pages_read,
                              kv_pages_written=len(plain_slots),
                              new_kv_tokens=len(plain_slots), wall0=lw0,
                              wall1=self._wall())
            self.sched.note_work(len(plain_slots))
            self._lens_np[plain_slots] += 1
        gen_work = len(plain_slots)
        if finals or plain_slots or spec_pack is not None:
            # THE device->host transfer: every sampled token of the tick,
            # and with a verify launch every chain's acceptance count
            wf0 = self._wall()
            if spec_pack is not None:
                toks, naccs = self._fetch_tokens(spec_nacc)
            else:
                toks = self._fetch_tokens()
            if tr is not None:
                tr.add_span("device_get", "tick", TRACK_ENGINE,
                            self.sched.ticks, self.sched.work_clock,
                            self.sched.work_clock, wf0, tr.now())
            for req, slot, work in finals:
                if self._emit(req, int(toks[slot, 0]), work=work):
                    self._finish(req)
            if spec_pack is not None:
                for r, t in enumerate(spec_pack.tasks):
                    n = int(naccs[r])
                    self.sched.note_spec(len(t.draft), n)
                    self._event(t.req, "SPEC_VERIFY", t.slot,
                                drafted=len(t.draft), accepted=n)
                    # the host mirror from the fetched count, never a
                    # device read
                    self._lens_np[t.slot] = t.offset + n + 1
                    # the accepted drafts and the target's bonus token; the
                    # work clock advances per accepted token only
                    for tok in list(t.draft[:n]) + [int(toks[t.slot, 0])]:
                        self.sched.note_work(1)
                        gen_work += 1
                        if self._emit(t.req, tok):
                            self._finish(t.req)
                            break
            for i in plain_slots:
                req = self.slots[i]
                if self._emit(req, int(toks[i, 0])):
                    self._finish(req)
        self.sched.note_tick(gen_work,
                             self.sched.work_clock - w0 - gen_work)
        if self._finished_this_tick:
            self._maybe_evict_watermark()
        if self._table_dirty:
            self._sync_table()
        return self._finished_this_tick

    def _cow_guard(self, spec_spans: Optional[Dict[int, int]] = None):
        """Give any decoding slot about to WRITE into a shared page a
        private copy first, so no launch ever writes a cached page.
        Generation pages are private by construction (the one structural
        copy happens at admission), so this is a defensive sweep.
        `spec_spans` maps slots with a draft chain to its length m: the
        verify launch writes positions lens .. lens + m, and every page of
        that range gets the same guard.  Reads the host lens mirror; a
        copy re-uploads the (masked, copied) table."""
        ps = self.scfg.page_size
        spans = spec_spans or {}
        dirty = False
        for i, req in enumerate(self.slots):
            if req is None or req.state is not RequestState.DECODING:
                continue
            lo = int(self._lens_np[i]) // ps
            hi = (int(self._lens_np[i]) + spans.get(i, 0)) // ps
            for idx in range(lo, hi + 1):
                page = int(self.allocator.table[i, idx])
                if self.allocator.refcount(page) > 1:
                    src, dst = self.allocator.cow(i, idx)
                    self._copy_page(src, dst)
                    self.cow_copies += 1
                    dirty = True
        if dirty:
            self._sync_table()

    def _maybe_evict_watermark(self):
        """Evict cached pages until the free list holds
        prefix_evict_watermark of the usable pool (0 = off)."""
        if self.prefix is not None and self.scfg.prefix_evict_watermark > 0:
            target = math.ceil(self.scfg.prefix_evict_watermark
                               * self.allocator.usable_pages)
            short = target - self.allocator.free_pages
            if short > 0:
                self.prefix.evict(short)

    def tick(self) -> List[Request]:
        """One engine iteration: monolithic (admissions + one fused
        decode) or chunked (one token-budgeted round of chunks + decode).
        Returns the requests that finished in it.  Appends a dispatch row
        to launch_log: (jit_calls, host_syncs, host_wall_s, n_chunk_tasks,
        n_decode).  Requests past their deadline expire first (before
        the row's counts start)."""
        self._finished_this_tick = []
        self._tick_profile = (0, 0)
        self._expire_deadlines()
        j0, s0 = self.jit_calls, self.host_syncs
        tick0 = self.sched.ticks
        work0 = self.sched.work_clock
        wt0 = self._wall()
        t0 = time.perf_counter()
        out = self._tick_chunked() if self.scfg.chunked \
            else self._tick_monolithic()
        self.tm.ticks.append(TickRecord(
            self.jit_calls - j0, self.host_syncs - s0,
            time.perf_counter() - t0, *self._tick_profile))
        tr = self.tm.tracer
        if tr is not None:
            tr.add_span("tick", "tick", TRACK_ENGINE, tick0, work0,
                        self.sched.work_clock, wt0, tr.now(),
                        jit_calls=self.jit_calls - j0,
                        host_syncs=self.host_syncs - s0,
                        n_chunks=self._tick_profile[0],
                        n_decode=self._tick_profile[1])
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
