"""Token-budget continuous-batching scheduler with chunked prefill.

The paper's core scheduling idea is LATENCY BALANCING: 3D-FlashAttention
splits attention into fine-grained tile chunks so no tier ever stalls
behind a long-running neighbor, forming a bubble-free pipeline.  A serve
engine has the same problem one level up: a monolithic admission-time
prefill of a 4k-token prompt stalls every active decode slot for the whole
prefill - a request-level pipeline bubble.  This module applies the same
cure at the same granularity knob: prompts are split into fixed-size
chunks (ServeConfig.prefill_chunk) and interleaved with decode inside a
fixed per-tick TOKEN BUDGET (ServeConfig.tick_token_budget), so decode
latency stays flat while long prompts stream in (Sarathi-style chunked
prefill / stall-free batching).

Per tick:

  budget = tick_token_budget
  - every DECODING slot consumes 1 token (decode is never descheduled);
  - the remaining budget is filled with prompt chunks for PREFILLING
    slots - the OLDEST request is guaranteed its chunk first (no
    starvation), the rest shortest-remaining-first (short interactive
    prompts reach their first token ahead of a 4k neighbor) - each chunk
    `prefill_chunk` tokens (the final chunk of a prompt may be shorter);
  - a chunk is scheduled only if it fits the remaining budget whole, so
    chunk starts stay page-aligned and the budget is a hard ceiling.

Request lifecycle (Request.state):

  QUEUED ──admit──> PREFILLING ──last chunk──> DECODING ──stop/len──> DONE
              (pages reserved,     (first token        (pages freed or
               cursor at cached     sampled from        published to the
               prefix end)          prompt logits)      prefix cache)

The scheduler is TENSOR-PARALLEL INVARIANT by construction: it plans in
tokens, slots, and pages - never devices - so ServeConfig.tp_degree does
not appear anywhere in admission, chunk packing, preemption, or the work
clock.  A tp=N engine therefore runs the identical tick plan as tp=1 on
the same trace, which is why the TP conformance suite can assert EQUAL
work-clock totals, not merely comparable ones (docs/tensor_parallel.md).

Admission policy is pluggable: "fifo" (arrival order) or "sjf" (shortest
prompt first - minimizes mean TTFT at the cost of long-prompt fairness).
Backpressure is per-policy head-of-line: when the chosen candidate cannot
be placed (no slot / no pages), admission stops for the tick.

The scheduler also owns per-request latency accounting.  Every emitted
token is stamped with wall-clock time AND the engine's WORK CLOCK (total
prefill + decode tokens executed so far): work-clock TTFT/TBT are exact,
deterministic measures of scheduling bubbles - a decode slot that waits
behind a monolithic 4k prefill sees a 4k-work gap between tokens - while
wall-clock numbers measure the same thing in (noisier) seconds.
`stats()` aggregates p50/p95 of both.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np

from ..configs.base import ServeConfig
from .drafting import ngram_draft
from .telemetry import MetricsRegistry


def _registry_counter(name: str):
    """Class-level compatibility view over a registry counter: reads and
    `self.x += n` writes on the old attribute names go straight through
    the MetricsRegistry, so the registry is the one source of truth while
    every existing call site (and test) keeps its spelling."""
    def fget(self):
        return int(self.metrics.get(name).value)

    def fset(self, v):
        self.metrics.get(name).set_total(v)

    return property(fget, fset)


class RequestState(str, Enum):
    QUEUED = "queued"            # submitted, waiting for a slot / pages
    PREFILLING = "prefilling"    # slot + pages held, prompt streaming in
    DECODING = "decoding"        # prompt complete, generating tokens
    RESUMING = "resuming"        # preempted: re-queued, pages shed, waiting
    DONE = "done"                # finished (length / stop token)
    TIMEOUT = "timeout"          # expired: work-clock deadline reached
    FAILED = "failed"            # terminal: redispatch retry budget spent


# the states a request can never leave (DONE / TIMEOUT / FAILED); anything
# else is still live - queued, in flight, or parked for resume
TERMINAL_STATES = frozenset((RequestState.DONE, RequestState.TIMEOUT,
                             RequestState.FAILED))


@dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int
    stop_tokens: FrozenSet[int] = frozenset()
    priority: int = 0            # higher admits (and preempts) first
    out_tokens: List[int] = field(default_factory=list)
    done: bool = False
    state: RequestState = RequestState.QUEUED
    slot: Optional[int] = None
    # prompt tokens already resident in the KV cache (cached prefix +
    # chunks prefilled so far); the request's prefill cursor
    prefill_pos: int = 0
    finish_reason: str = ""      # "length" | "stop" | "timeout" | "failed"
    # --- deadlines / fault tolerance -------------------------------------
    # work-clock deadline: the request expires (TIMEOUT) once the engine
    # has executed this many work tokens since its submit (None = never).
    # Deterministic by construction - the work clock is.
    deadline_tokens: Optional[int] = None
    # redispatch retry budget (fleet-level): how many times the router may
    # move this request off a failed replica before it goes terminal
    # FAILED (None = unbounded)
    max_retries: Optional[int] = None
    n_redispatches: int = 0
    # --- preemption ------------------------------------------------------
    # monotone admission stamp (engine-issued): the preemption policy sheds
    # the most recently admitted PREFILLING victim first
    admit_seq: int = -1
    n_preemptions: int = 0
    n_resumes: int = 0
    # a DECODING victim's KV holds prompt + generated tokens; the resume
    # prefill must rebuild ALL of it before the next decode step, so this
    # snapshot replaces `prompt` as the chunk path's target (None until the
    # request is preempted mid-decode)
    resume_tokens: Optional[List[int]] = None
    # --- latency accounting (wall seconds + engine work-clock tokens) ----
    # stamps are carried across preempt/resume, never reset: TTFT/TBT stay
    # monotone and a resume delay shows up as a (real) latency gap
    t_submit: float = 0.0
    w_submit: int = 0
    token_wall: List[float] = field(default_factory=list)
    token_work: List[int] = field(default_factory=list)
    token_tick: List[int] = field(default_factory=list)

    @property
    def target(self) -> List[int]:
        """The token sequence the chunk-prefill path must make resident:
        the prompt, or - resuming after a mid-decode preemption - the
        prompt plus every token generated before the preemption (the final
        resume chunk's logits then sample the NEXT token, exactly as the
        uninterrupted decode would have)."""
        return self.prompt if self.resume_tokens is None \
            else self.resume_tokens

    @property
    def remaining_new(self) -> int:
        """Generation budget still unspent (resume reservations size pages
        to target + remaining_new = prompt + max_new, same as admission)."""
        return self.max_new_tokens - len(self.out_tokens)

    @property
    def prompt_remaining(self) -> int:
        return len(self.target) - self.prefill_pos

    def ttft_wall(self) -> Optional[float]:
        return self.token_wall[0] - self.t_submit if self.token_wall else None

    def ttft_work(self) -> Optional[int]:
        return self.token_work[0] - self.w_submit if self.token_work else None

    def tbt_wall(self) -> List[float]:
        return [b - a for a, b in zip(self.token_wall, self.token_wall[1:])]

    def tbt_work(self) -> List[int]:
        return [b - a for a, b in zip(self.token_work, self.token_work[1:])]


@dataclass(frozen=True)
class ChunkTask:
    """One planned prefill chunk: `length` prompt tokens of `req` starting
    at absolute position `start`, to run in slot `slot` this tick."""
    req: Request
    slot: int
    start: int
    length: int


def bucket_rows(k: int) -> int:
    """Round a chunk-batch row count up to the next power of two.  The
    batched chunk step compiles once per (row-bucket, chunk-shape) pair,
    so bucketing bounds steady-state recompiles to log2(max rows) shapes
    instead of one per distinct K the planner happens to emit."""
    b = 1
    while b < k:
        b *= 2
    return b


@dataclass(frozen=True)
class ChunkBatch:
    """One tick's planned chunks packed into a device-ready ragged batch:
    row r of every array describes tasks[r]; rows past len(tasks) are DEAD
    padding up to the power-of-two bucket (zero tokens, offset 0,
    true_len 0, sentinel slot, and - engine-side - an all-null block-table
    row), so they compute nothing and update nothing."""
    tasks: Tuple[ChunkTask, ...]
    tokens: np.ndarray      # (K_pad, S_pad) int32, each row zero-padded
    offsets: np.ndarray     # (K_pad,) int32 absolute chunk starts
    true_lens: np.ndarray   # (K_pad,) int32 cursors AFTER each chunk
    # slot of each row whose chunk COMPLETES its prompt; non-final and
    # padding rows carry the out-of-range sentinel max_batch, which the
    # batched step's mode="drop" scatter discards
    final_slots: np.ndarray  # (K_pad,) int32
    row_slots: np.ndarray    # (K_pad,) int32 owning slot, -1 for padding

    @property
    def k_real(self) -> int:
        return len(self.tasks)


@dataclass(frozen=True)
class DraftTask:
    """One planned speculative verify lane: `draft` proposed tokens for
    `req` (DECODING in slot `slot`), whose KV frontier sits at absolute
    position `offset` (= the slot's lens at planning time).  The verify
    row's tokens are [pending, *draft]: the pending token's KV write plus
    the draft chain, scored in one ragged-chunk launch."""
    req: Request
    slot: int
    offset: int
    draft: Tuple[int, ...]


@dataclass(frozen=True)
class SpecBatch:
    """One tick's planned draft chains packed into a device-ready ragged
    batch for the verify step: row r describes tasks[r] in the
    prefill_chunks layout - tokens [pending, d_1..d_m, pad] at offset =
    the slot's lens, true_len = lens + 1 + m, q_lens = 1 + m (the
    kernel's draft-length lane), draft_lens = m for acceptance masking.
    Rows past len(tasks) are DEAD padding up to the power-of-two bucket
    (all-zero, sentinel slot dropped by the device scatter)."""
    tasks: Tuple[DraftTask, ...]
    tokens: np.ndarray       # (K_pad, spec_k + 1) int32
    offsets: np.ndarray      # (K_pad,) int32: each slot's lens
    true_lens: np.ndarray    # (K_pad,) int32: lens + 1 + m
    q_lens: np.ndarray       # (K_pad,) int32: 1 + m
    draft_lens: np.ndarray   # (K_pad,) int32: m
    row_slots: np.ndarray    # (K_pad,) int32 slot; sentinel max_batch pads


def _percentile(xs: Sequence[float], p: float) -> float:
    return float(np.percentile(np.asarray(list(xs), np.float64), p)) \
        if xs else 0.0


class TokenBudgetScheduler:
    """Host-side scheduling policy: admission queue ordering, per-tick
    chunk planning under the token budget, and latency bookkeeping.  The
    engine owns all device state and page accounting; the scheduler never
    touches the device."""

    def __init__(self, scfg: ServeConfig,
                 metrics: Optional[MetricsRegistry] = None):
        self.scfg = scfg
        self.queue: List[Request] = []
        self.finished: List[Request] = []
        # every counter below lives in the metrics registry (one typed
        # source of truth; serve/telemetry.py); the old attribute names -
        # ticks, work_clock, chunks_run, ... - remain as registry-backed
        # properties so call sites and tests keep their spelling.  A
        # standalone scheduler (unit tests) gets its own registry; the
        # engine passes its shared one in.
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        m = self.metrics
        m.counter("sched_ticks_total", "Engine ticks executed")
        m.counter("sched_work_tokens_total",
                  "Deterministic work clock: total prefill + decode tokens "
                  "executed (advances only for ACCEPTED tokens under "
                  "speculation)")
        m.counter("sched_chunks_run_total", "Prefill chunks executed")
        m.counter("sched_packs_run_total",
                  "Batched ragged chunk launches (at most 1 per tick)")
        # preemption accounting (incremented by the engine)
        m.counter("sched_preemptions_total", "Running requests shed by "
                  "priority preemption")
        m.counter("sched_resumes_total",
                  "Preempted requests re-admitted through the chunk path")
        m.counter("sched_pages_reclaimed_total",
                  "KV pages returned to the pool by preemption shedding")
        m.counter("sched_pages_parked_total", "Victim KV pages published "
                  "into the prefix tree on preemption")
        # speculative-decoding accounting (serve/drafting.py proposes,
        # the engine's verify launch accepts/rejects).  Drafted tokens
        # consume tick budget but NOT work clock: the work clock advances
        # only for ACCEPTED (emitted) tokens, so work-clock TTFT/TBT and
        # the final work_tokens total are directly comparable between
        # speculative-on and speculative-off runs of the same trace.
        m.counter("sched_spec_drafted_total",
                  "Speculative draft tokens sent to the verify launch")
        m.counter("sched_spec_accepted_total",
                  "Speculative draft tokens accepted (emitted)")
        m.counter("sched_spec_rejected_total",
                  "Speculative draft tokens rejected by the verify launch")
        # request deadlines (the engine expires through expired(); the
        # counter advances once per expired request)
        m.counter("sched_timeouts_total",
                  "Requests expired by their work-clock deadline (finished "
                  "with TIMEOUT status, pages freed the same tick)")
        # SLO-driven priority aging (incremented in pop() at admission)
        m.counter("sched_priority_boosts_total",
                  "Admissions whose work-clock-aged effective priority "
                  "exceeded the submitted priority (priority_aging)")
        m.gauge("sched_queue_depth",
                "Requests waiting for admission (RESUMING included)")
        m.gauge("sched_queue_depth_by_priority",
                "Admission queue depth per priority class",
                labelnames=("priority",))
        m.histogram("sched_spec_chain_accept_ratio",
                    "Per-chain speculative acceptance ratio "
                    "(accepted / drafted)",
                    buckets=(0.0, 0.25, 0.5, 0.75, 1.0))
        # per-tick budget accounting: (decode_tokens, prefill_tokens)
        self.tick_log: List[Tuple[int, int]] = []

    # registry-backed compatibility views (one source of truth: metrics)
    ticks = _registry_counter("sched_ticks_total")
    work_clock = _registry_counter("sched_work_tokens_total")
    chunks_run = _registry_counter("sched_chunks_run_total")
    packs_run = _registry_counter("sched_packs_run_total")
    preemptions = _registry_counter("sched_preemptions_total")
    resumes = _registry_counter("sched_resumes_total")
    pages_reclaimed = _registry_counter("sched_pages_reclaimed_total")
    pages_parked = _registry_counter("sched_pages_parked_total")
    spec_drafted = _registry_counter("sched_spec_drafted_total")
    spec_accepted = _registry_counter("sched_spec_accepted_total")
    spec_rejected = _registry_counter("sched_spec_rejected_total")
    priority_boosts = _registry_counter("sched_priority_boosts_total")
    timeouts = _registry_counter("sched_timeouts_total")

    # -- queue / admission policy -----------------------------------------
    def submit(self, req: Request):
        req.t_submit = time.time()
        req.w_submit = self.work_clock
        self.queue.append(req)

    def requeue(self, req: Request):
        """Park a preempted victim back in the queue (RESUMING).  Its
        submit stamps are NOT reset - TTFT/TBT stay monotone across the
        preempt/resume - and its uid keeps its original FIFO position, so
        within its priority class a victim resumes ahead of newcomers."""
        self.queue.append(req)

    def expired(self, req: Request) -> bool:
        """Deadline check, in the deterministic work clock: True once the
        engine has executed `deadline_tokens` work tokens since the
        request's submit without it finishing.  The ENGINE sweeps with
        this at the top of every tick and frees the expired request's slot
        and pages the same tick - a deadline can bound latency but never
        hang or strand capacity."""
        return (req.deadline_tokens is not None
                and not req.done
                and self.work_clock - req.w_submit >= req.deadline_tokens)

    def effective_priority(self, req: Request) -> int:
        """Priority used for ADMISSION ORDERING.  With priority_aging on,
        a queued (or preempted-and-parked) request gains +1 effective
        priority for every priority_age_tokens of work-clock age since it
        was submitted, so a low-priority request's wait is bounded: after
        (gap * priority_age_tokens) tokens of engine work it outranks any
        higher class and becomes the admission head.  Deterministic by
        construction - age is measured on the work clock, not wall time.
        Aging deliberately does NOT feed the preemption policy: an aged
        request admits ahead of newcomers but never evicts running work
        (base priority keeps preempt/victim cycles impossible)."""
        if not self.scfg.priority_aging:
            return req.priority
        age = self.work_clock - req.w_submit
        return req.priority + age // self.scfg.priority_age_tokens

    def peek(self) -> Optional[Request]:
        """Next admission candidate: highest EFFECTIVE priority first
        (base priority, work-clock-aged when priority_aging is on), then
        the configured policy within the class - SJF picks the shortest
        remaining prefill (stable on arrival order); FIFO the oldest."""
        if not self.queue:
            return None
        if self.scfg.admission_policy == "sjf":
            return min(self.queue,
                       key=lambda r: (-self.effective_priority(r),
                                      len(r.target), r.uid))
        return min(self.queue,
                   key=lambda r: (-self.effective_priority(r), r.uid))

    def pop(self, req: Request):
        if self.scfg.priority_aging \
                and self.effective_priority(req) > req.priority:
            self.priority_boosts += 1
        self.queue.remove(req)

    def queue_depth_by_priority(self) -> Dict[str, int]:
        """Current queue-depth gauge per priority class (RESUMING victims
        included - they are queued load like any other)."""
        out: Dict[str, int] = {}
        for r in self.queue:
            key = str(r.priority)
            out[key] = out.get(key, 0) + 1
        return out

    # -- budget shaping ----------------------------------------------------
    def prefill_budget(self, n_decode: int) -> int:
        """Tokens of prefill work this tick may carry.  Decode slots have
        already taken one token each off the top (decode is never
        descheduled); with decode_priority the remainder is additionally
        capped at max_prefill_fraction * tick_token_budget, so the work of
        a tick - and with it the work-clock TBT of every in-flight decode
        - stays bounded however deep the prefill queue is."""
        budget = self.scfg.tick_token_budget - n_decode
        if self.scfg.decode_priority:
            budget = min(budget, int(self.scfg.max_prefill_fraction
                                     * self.scfg.tick_token_budget))
        return max(budget, 0)

    # -- chunk planning ----------------------------------------------------
    def plan_chunks(self, prefilling: Sequence[Tuple[int, Request]],
                    budget: int) -> List[ChunkTask]:
        """Fill `budget` tokens with prefill chunks over the PREFILLING
        slots.  The OLDEST request (lowest uid) is guaranteed the first
        chunk - so a long prompt always advances and can never be starved
        by a stream of newcomers - then the rest of the budget goes
        SHORTEST-REMAINING-FIRST (ties broken by admission order): a
        nearly-done short prompt reaches its first token ahead of a 4k
        neighbor that would otherwise monopolize the budget, which is
        what keeps short-request TTFT flat under mixed traffic.  Each
        chunk is `prefill_chunk` tokens except a prompt's final
        remainder; a chunk only runs if it fits the remaining budget
        whole, so the budget is never exceeded and every chunk start
        stays page-aligned.  Higher-priority requests outrank the SRF
        order (priority-aware chunk fill); a resuming request's target is
        its prompt plus pre-preemption output (Request.target)."""
        if not prefilling:
            return []
        chunk = self.scfg.prefill_chunk
        srf = sorted(prefilling,
                     key=lambda sr: (-sr[1].priority,
                                     sr[1].prompt_remaining, sr[1].uid))
        # the guaranteed-progress floor goes to the oldest request OF THE
        # HIGHEST PRESENT PRIORITY CLASS: within a class no stream of
        # newcomers can starve a long prompt, while a high-priority
        # admission (e.g. one that just preempted its way in) is never
        # stuck behind a lower-priority neighbor's prefill
        oldest = min(prefilling,
                     key=lambda sr: (-sr[1].priority, sr[1].uid))
        order = [oldest] + [sr for sr in srf if sr is not oldest]
        planned: Dict[int, int] = {r.uid: r.prefill_pos for _, r in order}
        cap = self.scfg.max_chunks_per_tick or len(order) * 1_000_000
        tasks: List[ChunkTask] = []
        progressed = True
        while budget > 0 and progressed and len(tasks) < cap:
            progressed = False
            for slot, req in order:
                cursor = planned[req.uid]
                remaining = len(req.target) - cursor
                if remaining <= 0:
                    continue
                take = min(chunk, remaining)
                if take > budget:
                    continue
                tasks.append(ChunkTask(req, slot, cursor, take))
                planned[req.uid] = cursor + take
                budget -= take
                progressed = True
                if len(tasks) >= cap:
                    break
        return tasks

    def pack_chunks(self, tasks: Sequence[ChunkTask]) -> ChunkBatch:
        """Pack one tick's planned chunks into the ragged batch the
        one-launch tick executes: every task becomes a row of a
        (K_pad, prefill_chunk) token matrix with its own offset / cursor /
        owning slot, K_pad bucketed to the next power of two
        (bucket_rows) so steady-state traffic reuses a handful of
        compiled shapes.  Multiple chunks of the SAME request may share a
        batch - plan_chunks emits them in cursor order, and the batched
        kernel scatters every row's K/V before any row's attention reads
        the pool, so the later chunk sees the earlier one exactly.
        Row padding inside a chunk is masked to the null page by the
        model (pad positions of row A must never race row B's real
        writes); dead rows carry the max_batch sentinel slot the device
        scatter drops."""
        s_pad = self.scfg.prefill_chunk
        k_pad = bucket_rows(len(tasks))
        sentinel = self.scfg.max_batch
        tokens = np.zeros((k_pad, s_pad), np.int32)
        offsets = np.zeros((k_pad,), np.int32)
        true_lens = np.zeros((k_pad,), np.int32)
        final_slots = np.full((k_pad,), sentinel, np.int32)
        row_slots = np.full((k_pad,), -1, np.int32)
        for r, t in enumerate(tasks):
            tokens[r, :t.length] = t.req.target[t.start:t.start + t.length]
            offsets[r] = t.start
            true_lens[r] = t.start + t.length
            row_slots[r] = t.slot
            if t.start + t.length >= len(t.req.target):
                final_slots[r] = t.slot
        return ChunkBatch(tuple(tasks), tokens, offsets, true_lens,
                          final_slots, row_slots)

    # -- speculative drafting ----------------------------------------------
    def plan_drafts(self, decoding: Sequence[Tuple[int, Request]],
                    room: int) -> List[DraftTask]:
        """Propose draft chains for this tick's DECODING slots by n-gram
        lookup over each request's own token history (prompt + generated
        so far).  Drafted tokens consume tick budget: `room` is the
        budget left after every decode slot took its guaranteed token
        (the engine hands prefill planning what remains after drafts, so
        budget stays a hard ceiling).  Per-request caps: spec_k, and
        remaining_new - 1 so a fully accepted chain plus its bonus token
        can never overrun the generation budget - or the page
        reservation, which admission sized for exactly max_new_tokens.
        Slots are visited in slot order (deterministic); a request whose
        history never repeats gets no draft and decodes normally."""
        if room <= 0:
            return []
        scfg = self.scfg
        tasks: List[DraftTask] = []
        for slot, req in decoding:
            cap = min(scfg.spec_k, req.remaining_new - 1, room)
            if cap < 1:
                continue
            draft = ngram_draft(req.prompt + req.out_tokens, cap,
                                scfg.spec_ngram)
            if not draft:
                continue
            tasks.append(DraftTask(req, slot, -1, tuple(draft)))
            room -= len(draft)
            if room <= 0:
                break
        return tasks

    def pack_drafts(self, tasks: Sequence[DraftTask],
                    lens: np.ndarray) -> SpecBatch:
        """Pack one tick's draft chains into the ragged batch the verify
        launch scores: row r = [pending token, draft chain, pad] at
        offset lens[slot], bucketed to the next power of two like
        pack_chunks so steady-state traffic reuses a handful of compiled
        shapes.  `lens` is the engine's host lens mirror (the pending
        token of a DECODING slot is its last emitted token; its KV is
        not yet written, which is why the row starts at offset = lens
        and carries 1 + m real queries)."""
        s_spec = self.scfg.spec_k + 1
        k_pad = bucket_rows(len(tasks))
        sentinel = self.scfg.max_batch
        tokens = np.zeros((k_pad, s_spec), np.int32)
        offsets = np.zeros((k_pad,), np.int32)
        true_lens = np.zeros((k_pad,), np.int32)
        q_lens = np.zeros((k_pad,), np.int32)
        draft_lens = np.zeros((k_pad,), np.int32)
        row_slots = np.full((k_pad,), sentinel, np.int32)
        packed = []
        for r, t in enumerate(tasks):
            m = len(t.draft)
            off = int(lens[t.slot])
            tokens[r, 0] = t.req.out_tokens[-1]
            tokens[r, 1:1 + m] = t.draft
            offsets[r] = off
            true_lens[r] = off + 1 + m
            q_lens[r] = 1 + m
            draft_lens[r] = m
            row_slots[r] = t.slot
            packed.append(DraftTask(t.req, t.slot, off, t.draft))
        return SpecBatch(tuple(packed), tokens, offsets, true_lens,
                         q_lens, draft_lens, row_slots)

    def note_spec(self, drafted: int, accepted: int):
        """Record one verify lane's outcome: `drafted` tokens proposed,
        `accepted` of them emitted.  Counters only - the work clock is
        advanced by the engine per ACCEPTED token at emission time."""
        self.spec_drafted += drafted
        self.spec_accepted += accepted
        self.spec_rejected += drafted - accepted
        if drafted:
            self.metrics.get("sched_spec_chain_accept_ratio") \
                .observe(accepted / drafted)

    # -- accounting --------------------------------------------------------
    def note_work(self, n_tokens: int):
        self.work_clock += n_tokens

    def note_tick(self, decode_tokens: int, prefill_tokens: int):
        self.ticks += 1
        self.tick_log.append((decode_tokens, prefill_tokens))
        self.metrics.get("sched_queue_depth").set(len(self.queue))

    def note_token(self, req: Request, wall: float,
                   work: Optional[int] = None):
        """Stamp one emitted token.  `work` overrides the work-clock value
        recorded for it: the one-launch tick runs every chunk before any
        token value reaches the host, so it snapshots each final chunk's
        work clock at planning time and stamps the deferred emission with
        it - keeping work-clock TTFT/TBT identical to the sequential
        per-chunk path."""
        req.token_wall.append(wall)
        req.token_work.append(self.work_clock if work is None else work)
        req.token_tick.append(self.ticks)

    def note_finished(self, req: Request):
        self.finished.append(req)

    # -- stats -------------------------------------------------------------
    def token_stalls(self, reqs: Optional[Sequence[Request]] = None
                     ) -> List[int]:
        """Per-token TICK-WORK STALL: the total tokens of work the engine
        executed in the tick that emitted the token.  Tick duration is
        proportional to the work it carries, so this is the deterministic
        size of the scheduling bubble a token sat behind - a token emitted
        in the same tick as a monolithic 4k prefill is stamped ~4k, while
        a budgeted tick can never stamp more than tick_token_budget."""
        per_tick = [d + p for d, p in self.tick_log]
        return [per_tick[t] for r in (self.finished if reqs is None
                                      else reqs)
                for t in r.token_tick]

    def stats(self) -> Dict[str, float]:
        """Latency aggregates over finished requests: p50/p95 TTFT,
        time-between-tokens, and per-token tick-work stalls, in wall
        seconds and in work-clock tokens."""
        reqs = self.finished
        ttft_wall = [r.ttft_wall() for r in reqs if r.token_wall]
        ttft_work = [r.ttft_work() for r in reqs if r.token_work]
        tbt_wall = [d for r in reqs for d in r.tbt_wall()]
        tbt_work = [d for r in reqs for d in r.tbt_work()]
        stalls = self.token_stalls()
        per_tick = [d + p for d, p in self.tick_log]
        self.metrics.get("sched_queue_depth").set(len(self.queue))
        depth_by_prio = self.queue_depth_by_priority()
        for prio, n in depth_by_prio.items():
            self.metrics.get("sched_queue_depth_by_priority") \
                .labels(prio).set(n)
        return {
            "requests": len(reqs),
            "ticks": self.ticks,
            "work_tokens": self.work_clock,
            "chunks_run": self.chunks_run,
            "packs_run": self.packs_run,
            "preemptions": self.preemptions,
            "resumes": self.resumes,
            "pages_reclaimed": self.pages_reclaimed,
            "pages_parked": self.pages_parked,
            "spec_drafted": self.spec_drafted,
            "spec_accepted": self.spec_accepted,
            "spec_rejected": self.spec_rejected,
            "spec_acceptance_rate": self.spec_accepted / self.spec_drafted
            if self.spec_drafted else 0.0,
            "spec_chain_accept_mean":
            self.metrics.get("sched_spec_chain_accept_ratio").mean,
            "priority_boosts": self.priority_boosts,
            "timeouts": self.timeouts,
            "queue_depth": len(self.queue),
            "queue_depth_by_priority": depth_by_prio,
            "max_tick_tokens": max(per_tick) if per_tick else 0,
            "ttft_wall_p50": _percentile(ttft_wall, 50),
            "ttft_wall_p95": _percentile(ttft_wall, 95),
            "tbt_wall_p50": _percentile(tbt_wall, 50),
            "tbt_wall_p95": _percentile(tbt_wall, 95),
            "ttft_work_p50": _percentile(ttft_work, 50),
            "ttft_work_p95": _percentile(ttft_work, 95),
            "tbt_work_p50": _percentile(tbt_work, 50),
            "tbt_work_p95": _percentile(tbt_work, 95),
            "stall_work_p50": _percentile(stalls, 50),
            "stall_work_p95": _percentile(stalls, 95),
            "stall_work_max": max(stalls) if stalls else 0,
        }
