"""Fleet router: prefix-aware dispatch over N independent serve engines -
the JAX package's serve/router.py, ported onto the port's ServeEngine.

The paper's core economy - keep data where it already lives instead of
round-tripping it through a shared buffer - applies one level above the
kernel: a request whose KV prefix is already resident on some replica
should LAND on that replica, not recompute the prefix somewhere else.
This module is that scheduling layer.  A `FleetRouter` fronts N
independent `ServeEngine` replicas (each with its own page pool, radix
prefix tree, scheduler, and telemetry registry) and owns the fleet
lifecycle: `submit()` / `tick()` (`step()`) / `run_until_done()` mirror
the single-engine API, so callers swap an engine for a fleet without
code changes.

Dispatch is a cache-hit-weighted score, evaluated per submit:

  score(r) = saved_r
             - load_weight     * outstanding_work_r
             - pressure_weight * page_shortfall_r * page_size

  saved_r            prompt tokens replica r's radix tree already caches,
                     read with the side-effect-free `RadixPrefixCache.
                     peek()` - peeking N-1 losing replicas must not bump
                     their LRU stamps, refcounts, or hit counters (a
                     router probe is not a hit).  Capped at len(prompt)-1
                     because a fully cached prompt still recomputes its
                     last token for logits.
  outstanding_work_r replica r's queued + in-flight work tokens (prompt
                     remaining + unspent generation budget), from the
                     engine's registry-backed `load_stats()` - the
                     queue-depth / in-flight-work term.
  page_shortfall_r   pages of the request's reservation that replica r
                     could not grant right now even after LRU eviction
                     (free + evictable headroom) - the page-pool-pressure
                     term, scaled to tokens by page_size.

All three terms are deterministic host-side integers; ties break to the
LOWEST replica index, so a replayed trace routes bit-identically.
Placement is STICKY: a request never migrates after submit (its KV pages
live in one replica's pool; preemption inside a replica parks and
resumes there).  Per-replica admission backpressure is a queue-depth cap
(`spill_queue_depth`): when the best-scoring replica's queue is at the
cap the request SPILLS to the next-best under the cap (counted in
`fleet_spills_total`); if every replica is at the cap the best one takes
it anyway - the cap sheds imbalance, it never rejects work.

Fleet telemetry: the router has its own `MetricsRegistry` (dispatch /
spill / affinity-hit counters, per-replica dispatch labels),
`fleet_snapshot()` adds a summed view over every replica's registry,
`fleet_stats()` aggregates the engines' `stats()`, and `export_trace()`
merges every replica's Perfetto trace into one file with one process
(track group) per replica.

Every replica is built on the one `model` and the one parameter tree
the router was given: the weights are never copied, and each replica's
steps are the same functions of that model.  What a replica owns is its
KV cache, block table and host bookkeeping.  A request's rows share
chunk batches with other requests' rows, and which ones depends on the
fleet's size; the attention kernels compute each row in blocks of its
own, so only the projections' matrix products (whose algorithm may
depend on the batch's row count) can move a request's last bits between
fleet sizes.

A fleet of tensor-parallel replicas (ServeConfig.tp_degree > 1) runs in
every rank of the serve mesh: each rank runs the whole router, and the
replicas of one degree share the mesh's one process group
(launch/mesh.py), as the JAX replicas share the first tp_degree devices.
The router's decisions are host logic, the same on every rank, so each
replica's ticks - and their collectives - come in the same order
everywhere.

Everything here is host-side: scores, placements, the watchdog and the
fault-recovery path read host bookkeeping (load_stats, the prefix tree's
peek, the work clock) and never a device tensor, and each replica's tick
is called through the instance (`eng.tick()`), so a replaced tick - the
chaos harness's "stuck" fault - is what runs.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass
from enum import Enum
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..configs.base import ServeConfig
from .engine import ServeEngine
from .paged_cache import pages_needed
from .scheduler import Request, RequestState, TERMINAL_STATES
from .telemetry import MetricsRegistry


class ReplicaState(str, Enum):
    """Replica lifecycle the router drives:

        HEALTHY --drain()--> DRAINING --undrain()--> HEALTHY
           |                     |
         fail() / watchdog     fail() / watchdog
           v                     v
          DEAD <---------------DEAD          (terminal)

    HEALTHY replicas receive new dispatch; DRAINING replicas stop
    receiving dispatch but keep ticking until their queue and slots empty
    (then stay DRAINING, parked, until undrain()); DEAD replicas are
    never ticked again and their queued + in-flight requests are
    REDISPATCHED to survivors through the resume path."""
    HEALTHY = "healthy"
    DRAINING = "draining"
    DEAD = "dead"


@dataclass(frozen=True)
class FleetConfig:
    """Router-level knobs (per-replica behavior stays in ServeConfig)."""
    n_replicas: int = 2
    policy: str = "affinity"        # affinity | round_robin
    # score weights: tokens of cached prefix a unit of each term is worth
    load_weight: float = 0.1        # per outstanding work token
    pressure_weight: float = 4.0    # per token of ungrantable reservation
    # per-replica admission backpressure: spill to the next-best replica
    # when the chosen one has this many requests queued (0 = off)
    spill_queue_depth: int = 0
    # SLO-aware dispatch: subtract slo_weight * (replica's observed
    # work-clock p95 TTFT over its finished requests) from the score, so
    # a replica that has been DELIVERING slow first tokens sheds load to
    # faster peers even when raw outstanding work looks comparable.
    # 0 (default) = off, bit-identical to pre-SLO routing.
    slo_weight: float = 0.0
    # health probe: a replica with outstanding work whose work clock has
    # not advanced for this many consecutive fleet ticks is declared DEAD
    # (tick watchdog) and its requests redispatch to survivors.  0 = off.
    watchdog_ticks: int = 0

    def validate(self) -> "FleetConfig":
        if self.n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, "
                             f"got {self.n_replicas}")
        if self.policy not in ("affinity", "round_robin"):
            raise ValueError(f"policy must be 'affinity' or 'round_robin', "
                             f"got {self.policy!r}")
        if self.load_weight < 0 or self.pressure_weight < 0 \
                or self.slo_weight < 0:
            raise ValueError("score weights must be >= 0")
        if self.spill_queue_depth < 0:
            raise ValueError(f"spill_queue_depth must be >= 0, "
                             f"got {self.spill_queue_depth}")
        if self.watchdog_ticks < 0:
            raise ValueError(f"watchdog_ticks must be >= 0 (0 = off), "
                             f"got {self.watchdog_ticks}")
        return self


class FleetRouter:
    """N serve-engine replicas behind one engine-shaped front door."""

    def __init__(self, model, params, scfg: ServeConfig,
                 fcfg: Optional[FleetConfig] = None):
        """model: a models.Model; params: its parameter tree.  Every
        replica serves this one model and this one tree (never a copy)."""
        self.fcfg = (fcfg or FleetConfig()).validate()
        self.scfg = scfg
        # replicas share the model and its parameters; each owns its cache
        self.engines: List[ServeEngine] = [
            ServeEngine(model, params, scfg)
            for _ in range(self.fcfg.n_replicas)]
        # fleet uid -> (replica index, replica-local Request); fleet uids
        # are issued in submit order, so the SAME trace through different
        # fleet sizes keys its outputs identically
        self._fuid = 0
        self.placement: Dict[int, int] = {}
        self.requests: Dict[int, Request] = {}
        self._rr_next = 0               # round_robin cursor
        # replica lifecycle (HEALTHY -> DRAINING -> DEAD): DEAD replicas
        # are never ticked or invariant-checked again (their host-side
        # state is abandoned wholesale - that is what "lost" means)
        self.states: List[ReplicaState] = \
            [ReplicaState.HEALTHY] * self.fcfg.n_replicas
        # tick watchdog: last observed work clock + consecutive stale
        # ticks per replica (a busy replica whose clock freezes is wedged)
        self._last_work = [0] * self.fcfg.n_replicas
        self._stale_ticks = [0] * self.fcfg.n_replicas
        # fleet tick a drain() started on, until the replica empties
        self._drain_start: Dict[int, int] = {}
        # requests that went terminal AT THE ROUTER (FAILED: retry budget
        # spent during a fail()); drained into the next tick()'s finished
        # list so run_until_done callers see every terminal request
        self._terminated: List[Request] = []
        self.metrics = MetricsRegistry()
        m = self.metrics
        m.counter("fleet_requests_total", "Requests accepted by the router")
        m.counter("fleet_dispatch_total",
                  "Requests dispatched, per replica", labelnames=("replica",))
        m.counter("fleet_spills_total",
                  "Dispatches diverted off the best-scoring replica by the "
                  "spill_queue_depth admission cap")
        m.counter("fleet_affinity_hits_total",
                  "Dispatches whose chosen replica already cached >= 1 "
                  "prompt page at decision time")
        m.counter("fleet_affinity_hit_tokens_total",
                  "Prompt tokens already cached on the chosen replica at "
                  "decision time (peek-measured, whole pages)")
        m.counter("fleet_ticks_total",
                  "Fleet ticks (one tick of every replica)")
        m.gauge("fleet_replicas", "Engine replicas fronted by this router")
        m.get("fleet_replicas").set(self.fcfg.n_replicas)
        # --- fault tolerance ------------------------------------------
        m.gauge("fleet_replica_state",
                "Replica lifecycle state (0 = healthy, 1 = draining, "
                "2 = dead)", labelnames=("replica",))
        m.counter("fleet_drains_total", "drain() calls accepted")
        m.counter("fleet_failures_total",
                  "Replicas declared dead (fail() or watchdog)")
        m.counter("fleet_watchdog_trips_total",
                  "Replica failures declared by the tick watchdog "
                  "(busy replica, frozen work clock)")
        m.counter("fleet_redispatches_total",
                  "Requests moved off a dead replica onto a survivor "
                  "(resume-path re-entry)")
        m.counter("fleet_retries_exhausted_total",
                  "Requests gone terminal FAILED because a redispatch "
                  "would exceed their max_retries budget")
        m.histogram("fleet_drain_duration_ticks",
                    "Fleet ticks from drain() to the replica emptying",
                    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256))
        for i in range(self.fcfg.n_replicas):
            m.get("fleet_replica_state").labels(str(i)).set(0)

    # ------------------------------------------------------------------
    # dispatch scoring
    # ------------------------------------------------------------------
    def _peek_saved(self, eng: ServeEngine,
                    prompt: Sequence[int]) -> Tuple[int, int, bool]:
        """(saved_tokens, cached_pages, full_cover) on one replica, via
        the side-effect-free peek - probing must not perturb the replica's
        LRU order, refcounts, or hit accounting."""
        if eng.prefix is None:
            return 0, 0, False
        pages = eng.prefix.peek(prompt)
        ps = eng.scfg.page_size
        full = len(pages) * ps >= len(prompt)
        saved = min(len(pages) * ps, len(prompt) - 1)
        return saved, len(pages), full

    def _observed_ttft(self, eng: ServeEngine) -> float:
        """Replica's observed work-clock p95 TTFT over its finished
        requests (0.0 before any finishes).  Deterministic host-side
        integers in, nearest-rank percentile out - no numpy, no device
        reads - so SLO-weighted dispatch replays bit-identically."""
        vals = sorted(r.ttft_work() for r in eng.sched.finished
                      if r.token_work)
        if not vals:
            return 0.0
        return float(vals[max(0, math.ceil(0.95 * len(vals)) - 1)])

    def _score(self, ridx: int, prompt: Sequence[int],
               n_new: int) -> Tuple[float, int]:
        """(score, saved_tokens) of dispatching to replica `ridx`.  All
        inputs are deterministic host-side state; equal scores are broken
        by replica index at the call site."""
        eng = self.engines[ridx]
        saved, n_cached, full = self._peek_saved(eng, prompt)
        load = eng.load_stats()
        pressure = 0
        if eng.paged:
            need = pages_needed(len(prompt) + n_new, eng.scfg.page_size)
            # cached pages are attached, not allocated - but a fully
            # cached prompt COWs its final page, which costs one fresh one
            need -= max(0, n_cached - (1 if full else 0))
            headroom = load["free_pages"] + load["evictable_pages"]
            pressure = max(0, need - headroom)
        score = (saved
                 - self.fcfg.load_weight * load["outstanding_work_tokens"]
                 - self.fcfg.pressure_weight * pressure
                 * eng.scfg.page_size)
        if self.fcfg.slo_weight:
            # the SLO term: what this replica has been DELIVERING, not
            # just what it is holding - a replica with a history of slow
            # first tokens sheds new load to faster peers
            score -= self.fcfg.slo_weight * self._observed_ttft(eng)
        return score, saved

    def _choose(self, prompt: Sequence[int],
                n_new: int) -> Tuple[int, int, int]:
        """(chosen replica, best-scoring replica, saved tokens on the
        chosen one).  chosen != best iff the admission cap spilled.  Only
        HEALTHY replicas are candidates: DRAINING replicas take no new
        dispatch (that is the point of draining) and DEAD ones are gone;
        with no healthy replica left the router refuses the request
        loudly rather than queueing it onto a corpse."""
        n = len(self.engines)
        healthy = [i for i in range(n)
                   if self.states[i] is ReplicaState.HEALTHY]
        if not healthy:
            raise RuntimeError(
                "no healthy replica to dispatch to: states "
                f"{[s.value for s in self.states]}")
        if self.fcfg.policy == "round_robin":
            base = self._rr_next % len(healthy)
            self._rr_next += 1
            order = [healthy[(base + k) % len(healthy)]
                     for k in range(len(healthy))]
            saved_of = {}               # peeked lazily, accounting only
        else:
            scored = {i: self._score(i, prompt, n_new) for i in healthy}
            # highest score wins; ties to the lowest index (sort is
            # stable and the key's second element pins the order), so
            # replays are bit-reproducible
            order = sorted(healthy, key=lambda i: (-scored[i][0], i))
            saved_of = {i: scored[i][1] for i in healthy}
        best = chosen = order[0]
        cap = self.fcfg.spill_queue_depth
        if cap:
            for i in order:
                if len(self.engines[i].queue) < cap:
                    chosen = i
                    break
            # every replica at the cap: the best one absorbs the request
            # (backpressure sheds imbalance, it never rejects work)
        if chosen not in saved_of:
            saved_of[chosen] = self._peek_saved(self.engines[chosen],
                                                prompt)[0]
        return chosen, best, saved_of[chosen]

    # ------------------------------------------------------------------
    # engine-shaped lifecycle
    # ------------------------------------------------------------------
    def submit(self, prompt: List[int],
               max_new_tokens: Optional[int] = None,
               stop_tokens: Optional[Sequence[int]] = None,
               priority: int = 0,
               deadline: Optional[int] = None,
               max_retries: Optional[int] = None) -> int:
        """Route one request and enqueue it on the chosen replica.
        Returns a FLEET uid (monotone in submit order, stable across
        fleet sizes); the placement is sticky for the request's life -
        unless its replica DIES, in which case the router redispatches it
        to a survivor (fail()).  `deadline` / `max_retries` pass through
        to the engine: a work-clock deadline (TIMEOUT on expiry) and the
        redispatch retry budget (terminal FAILED once spent)."""
        n_new = self.scfg.max_new_tokens if max_new_tokens is None \
            else max_new_tokens
        ridx, best, saved = self._choose(prompt, n_new)
        eng = self.engines[ridx]
        eng.submit(prompt, max_new_tokens, stop_tokens, priority,
                   deadline=deadline, max_retries=max_retries)
        req = eng.sched.queue[-1]
        self._fuid += 1
        fuid = self._fuid
        req.fleet_uid = fuid            # stamped for finished-tick callers
        self.placement[fuid] = ridx
        self.requests[fuid] = req
        m = self.metrics
        m.get("fleet_requests_total").inc()
        m.get("fleet_dispatch_total").labels(str(ridx)).inc()
        if ridx != best:
            m.get("fleet_spills_total").inc()
        if saved > 0:
            m.get("fleet_affinity_hits_total").inc()
            m.get("fleet_affinity_hit_tokens_total").inc(saved)
        return fuid

    # ------------------------------------------------------------------
    # replica lifecycle: drain / fail / redispatch
    # ------------------------------------------------------------------
    def _set_state(self, ridx: int, state: ReplicaState):
        self.states[ridx] = state
        level = {ReplicaState.HEALTHY: 0, ReplicaState.DRAINING: 1,
                 ReplicaState.DEAD: 2}[state]
        self.metrics.get("fleet_replica_state").labels(str(ridx)).set(level)

    def drain(self, ridx: int):
        """Stop dispatching NEW requests to replica `ridx` and let it
        empty: it keeps ticking, its queued and in-flight requests run to
        completion in place (placement stays sticky - nothing migrates),
        and once its queue and slots are empty the drain duration lands
        in `fleet_drain_duration_ticks`.  The replica then stays parked
        (DRAINING) until undrain() returns it to rotation."""
        if self.states[ridx] is ReplicaState.DEAD:
            raise ValueError(f"replica {ridx} is dead; dead replicas "
                             f"cannot drain")
        if self.states[ridx] is ReplicaState.DRAINING:
            return
        self._set_state(ridx, ReplicaState.DRAINING)
        self._drain_start[ridx] = \
            int(self.metrics.get("fleet_ticks_total").value)
        self.metrics.get("fleet_drains_total").inc()

    def undrain(self, ridx: int):
        """Return a DRAINING replica to dispatch rotation."""
        if self.states[ridx] is ReplicaState.DEAD:
            raise ValueError(f"replica {ridx} is dead; dead replicas "
                             f"cannot rejoin the fleet")
        if self.states[ridx] is ReplicaState.HEALTHY:
            return
        self._drain_start.pop(ridx, None)
        self._set_state(ridx, ReplicaState.HEALTHY)

    def fail(self, ridx: int) -> List[int]:
        """Declare replica `ridx` DEAD and redispatch every request it
        still owed - queued AND in-flight - to surviving replicas.  The
        dead engine is never ticked again; its host/device state is
        abandoned wholesale (that is what losing a replica means), which
        is why survivors' page conservation is the invariant that
        matters, not the corpse's.

        Redispatch re-enters through the RESUME path: a request with
        generated tokens re-submits on the survivor with resume_tokens =
        prompt + generated-so-far, exactly like a preemption victim - the
        chunk path rebuilds its KV (reusing any prefix-cached pages the
        survivor already holds) and the final resume chunk's logits
        sample the next token bit-identically to an undisturbed run.  A
        request whose max_retries budget is already spent goes terminal
        FAILED instead (surfaced through outputs()/statuses() and the
        next tick's finished list).  Returns the redispatched fleet uids.
        Idempotent: failing a dead replica is a no-op."""
        if self.states[ridx] is ReplicaState.DEAD:
            return []
        self._set_state(ridx, ReplicaState.DEAD)
        self._drain_start.pop(ridx, None)
        self.metrics.get("fleet_failures_total").inc()
        lost = sorted(f for f, r in self.placement.items()
                      if r == ridx and not self.requests[f].done)
        moved: List[int] = []
        m = self.metrics
        for fuid in lost:
            req = self.requests[fuid]
            if req.max_retries is not None \
                    and req.n_redispatches >= req.max_retries:
                req.state = RequestState.FAILED
                req.done = True
                req.finish_reason = "failed"
                m.get("fleet_retries_exhausted_total").inc()
                self._terminated.append(req)
                continue
            if req.out_tokens and not self.scfg.chunked:
                raise RuntimeError(
                    "in-flight failure recovery requires chunked=True: "
                    "a mid-decode request resumes through the chunk path")
            self._redispatch(fuid, req)
            moved.append(fuid)
        return moved

    def _redispatch(self, fuid: int, old: Request):
        """Move one lost request onto the best surviving replica.  The
        fleet uid is PRESERVED (outputs()/statuses() keys never change);
        the replica-local Request is fresh - survivor-local uid, fresh
        latency stamps on the survivor's work clock - carrying over the
        prompt, generated tokens, priority, stop set, deadline, and retry
        accounting.  With prior output the fresh request enters RESUMING
        with resume_tokens = prompt + generated (the preemption-resume
        contract); mid-prefill progress on the corpse is simply lost and
        re-prefills (the survivor's prefix cache absorbs what it can)."""
        ridx, best, saved = self._choose(old.prompt, old.max_new_tokens)
        eng = self.engines[ridx]
        eng.submit(old.prompt, old.max_new_tokens,
                   stop_tokens=old.stop_tokens, priority=old.priority,
                   deadline=old.deadline_tokens,
                   max_retries=old.max_retries)
        req = eng.sched.queue[-1]
        req.fleet_uid = fuid
        req.n_redispatches = old.n_redispatches + 1
        if old.out_tokens:
            req.out_tokens = list(old.out_tokens)
            req.resume_tokens = old.prompt + list(old.out_tokens)
            req.state = RequestState.RESUMING
        self.placement[fuid] = ridx
        self.requests[fuid] = req
        m = self.metrics
        m.get("fleet_redispatches_total").inc()
        m.get("fleet_dispatch_total").labels(str(ridx)).inc()
        if saved > 0:
            m.get("fleet_affinity_hits_total").inc()
            m.get("fleet_affinity_hit_tokens_total").inc(saved)

    def _collect_terminated(self) -> List[Request]:
        out, self._terminated = self._terminated, []
        return out

    def _run_watchdog(self) -> List[Request]:
        """The health probe: a replica that HAS work (queued or in
        flight) but whose work clock froze for watchdog_ticks consecutive
        fleet ticks is wedged - declare it dead and redispatch.  Work is
        the right staleness signal (not tick counts): a wedged engine may
        well keep 'ticking' while executing nothing."""
        finished: List[Request] = []
        for i, eng in enumerate(self.engines):
            if self.states[i] is ReplicaState.DEAD:
                continue
            busy = bool(eng.queue) or any(s is not None for s in eng.slots)
            work = eng.sched.work_clock
            if busy and work == self._last_work[i]:
                self._stale_ticks[i] += 1
                if self._stale_ticks[i] >= self.fcfg.watchdog_ticks:
                    self.metrics.get("fleet_watchdog_trips_total").inc()
                    self.fail(i)
                    finished.extend(self._collect_terminated())
            else:
                self._stale_ticks[i] = 0
            self._last_work[i] = work
        return finished

    def _note_drained(self):
        """Close out drain-duration accounting for replicas that emptied."""
        now = int(self.metrics.get("fleet_ticks_total").value)
        for ridx in list(self._drain_start):
            eng = self.engines[ridx]
            if not eng.queue and all(s is None for s in eng.slots):
                self.metrics.get("fleet_drain_duration_ticks").observe(
                    now - self._drain_start.pop(ridx))

    def tick(self) -> List[Request]:
        """One fleet iteration: every LIVE replica ticks once, in replica
        order (replicas are independent, so the order is cosmetic - but
        fixed, for deterministic merged telemetry); DEAD replicas are
        skipped forever.  Returns the requests that went terminal this
        tick - finished, timed out, or router-FAILED - each stamped with
        `.fleet_uid`."""
        finished: List[Request] = self._collect_terminated()
        for i, eng in enumerate(self.engines):
            if self.states[i] is ReplicaState.DEAD:
                continue
            finished.extend(eng.tick())
        self.metrics.get("fleet_ticks_total").inc()
        if self.fcfg.watchdog_ticks:
            finished.extend(self._run_watchdog())
        self._note_drained()
        return finished

    # the engine API spells one iteration `tick`; `step` is the router
    # alias some fleet-level callers prefer
    step = tick

    def statuses(self) -> Dict[int, str]:
        """{fleet uid: terminal-or-live state} for every submitted
        request: "done" | "timeout" | "failed" for terminal requests,
        else the live scheduler state ("queued", "prefilling", ...)."""
        return {fuid: r.state.value for fuid, r in self.requests.items()}

    def run_until_done(self, max_ticks: int = 10_000,
                       on_exhaust: str = "raise") -> List[Request]:
        """Tick until every LIVE replica's queue and slots drain (same
        semantics as ServeEngine.run_until_done).  On tick exhaustion
        with on_exhaust="return", the warning reports per-request
        terminal statuses (done/timeout/failed counts) and names the
        fleet uids still running, so a stalled fleet is diagnosable from
        the warning alone."""
        done: List[Request] = []
        for _ in range(max_ticks):
            done.extend(self.tick())
            if self.idle:
                return done
        if self.idle:
            return done
        pending = sum(
            len(e.queue) + sum(s is not None for s in e.slots)
            for i, e in enumerate(self.engines)
            if self.states[i] is not ReplicaState.DEAD)
        by_status: Dict[str, int] = {}
        running: List[int] = []
        for fuid, r in self.requests.items():
            by_status[r.state.value] = by_status.get(r.state.value, 0) + 1
            if r.state not in TERMINAL_STATES:
                running.append(fuid)
        msg = (f"FleetRouter.run_until_done: {max_ticks} ticks exhausted "
               f"with {pending} requests still pending "
               f"({len(done)} finished); statuses: "
               f"{dict(sorted(by_status.items()))}; still running "
               f"fleet uids: {sorted(running)}")
        if on_exhaust == "raise":
            raise RuntimeError(msg)
        import warnings
        warnings.warn(msg)
        return done

    @property
    def idle(self) -> bool:
        """True when no live replica holds work (DEAD replicas are
        abandoned state, not pending work - their lost requests were
        either redispatched or went terminal FAILED at fail() time)."""
        return all(not e.queue and all(s is None for s in e.slots)
                   for i, e in enumerate(self.engines)
                   if self.states[i] is not ReplicaState.DEAD)

    def outputs(self) -> Dict[int, List[int]]:
        """{fleet uid: generated tokens} for every submitted request -
        the differential-conformance view (fleet uids are submit-ordered,
        so 1-replica and N-replica runs of one trace key identically)."""
        return {fuid: list(r.out_tokens)
                for fuid, r in self.requests.items()}

    def check_invariants(self):
        """Every LIVE replica's engine invariants plus the router's own
        bookkeeping: placements in range, dispatch counters conserved.
        DEAD replicas are skipped - a failed engine's internal state is
        abandoned, not repaired; what must stay consistent is the
        survivors and the router's request ledger."""
        for i, eng in enumerate(self.engines):
            if self.states[i] is not ReplicaState.DEAD:
                eng.check_invariants()
        n = len(self.engines)
        assert all(0 <= r < n for r in self.placement.values()), \
            "placement outside the fleet"
        dispatched = sum(
            child.value for _, child in
            self.metrics.get("fleet_dispatch_total").label_items())
        redispatched = self.metrics.get("fleet_redispatches_total").value
        assert len(self.placement) \
            == self.metrics.get("fleet_requests_total").value, \
            "placement ledger out of sync with submissions"
        assert dispatched == len(self.placement) + redispatched, \
            "dispatch accounting out of sync with placements + redispatches"

    # ------------------------------------------------------------------
    # fleet telemetry
    # ------------------------------------------------------------------
    _SUM_KEYS = ("requests", "work_tokens", "gen_tokens", "prefill_tokens",
                 "prefix_hit_tokens", "prompt_tokens", "jit_calls",
                 "host_syncs", "chunks_run", "packs_run", "preemptions",
                 "resumes", "priority_boosts", "cow_copies", "timeouts")

    def dispatch_counts(self) -> List[int]:
        """Requests dispatched per replica, replica order."""
        by_label = dict(self.metrics.get("fleet_dispatch_total")
                        .label_items())
        return [int(by_label[(str(i),)].value) if (str(i),) in by_label
                else 0 for i in range(len(self.engines))]

    def fleet_stats(self) -> Dict[str, Any]:
        """Aggregated engine stats (summed per-replica counters) plus the
        router's dispatch accounting - the fleet analog of
        ServeEngine.stats()."""
        per = [e.stats() for e in self.engines]
        out: Dict[str, Any] = {
            k: sum(s[k] for s in per) for k in self._SUM_KEYS}
        out["n_replicas"] = len(self.engines)
        out["policy"] = self.fcfg.policy
        # every replica shares one ServeConfig, so one degree describes
        # the fleet; stats() sums would be meaningless for a degree
        out["tp_degree"] = self.scfg.tp_degree
        out["ticks"] = int(self.metrics.get("fleet_ticks_total").value)
        out["dispatch"] = self.dispatch_counts()
        out["spills"] = int(self.metrics.get("fleet_spills_total").value)
        out["affinity_hits"] = int(
            self.metrics.get("fleet_affinity_hits_total").value)
        out["affinity_hit_tokens"] = int(
            self.metrics.get("fleet_affinity_hit_tokens_total").value)
        out["replica_states"] = [s.value for s in self.states]
        out["redispatches"] = int(
            self.metrics.get("fleet_redispatches_total").value)
        out["failures"] = int(
            self.metrics.get("fleet_failures_total").value)
        out["drains"] = int(self.metrics.get("fleet_drains_total").value)
        out["retries_exhausted"] = int(
            self.metrics.get("fleet_retries_exhausted_total").value)
        out["per_replica"] = per
        return out

    @staticmethod
    def _sum_value(acc: Dict[str, Any], name: str, value: Any):
        """Fold one replica's metric value into the summed view: scalars
        add, labeled metrics add per label, histograms add count/sum."""
        if isinstance(value, dict):
            if "buckets" in value:          # histogram
                slot = acc.setdefault(name, {"count": 0, "sum": 0.0})
                slot["count"] += value["count"]
                slot["sum"] += value["sum"]
            else:                           # labeled children
                slot = acc.setdefault(name, {})
                for k, v in value.items():
                    slot[k] = slot.get(k, 0) + v
            return
        acc[name] = acc.get(name, 0) + value

    def fleet_snapshot(self) -> Dict[str, Any]:
        """The fleet registry view: the router's own metrics, every
        replica's full registry snapshot, and a `sum` section folding the
        per-replica counters/gauges together (gauges sum too - fleet
        queue depth is the sum of replica queue depths; peak watermarks
        become a fleet-wide upper bound)."""
        replicas = [e.metrics_snapshot() for e in self.engines]
        summed: Dict[str, Any] = {}
        for snap in replicas:
            for name, meta in snap.items():
                self._sum_value(summed, name, meta["value"])
        return {"router": self.metrics.snapshot(),
                "replicas": replicas,
                "sum": summed}

    def export_trace(self, path, clock: str = "wall") -> Dict[str, Any]:
        """Merge every replica's Perfetto trace into one file with one
        process-pair (engine + requests track group) per replica, pids
        offset so Perfetto renders `replica0:engine`, `replica0:requests`,
        `replica1:engine`, ...  Requires ServeConfig(telemetry=True).
        With clock="wall" the replicas share the host clock but not an
        epoch-aligned tracer start; clock="work" is the deterministic,
        replay-stable view."""
        events: List[Dict[str, Any]] = []
        for i, eng in enumerate(self.engines):
            trace = eng.export_trace(None, clock=clock)
            for ev in trace["traceEvents"]:
                ev = dict(ev)
                ev["pid"] = 2 * i + ev["pid"]
                if ev.get("ph") == "M" and ev.get("name") == "process_name":
                    ev["args"] = {
                        "name": f"replica{i}:{ev['args']['name']}"}
                events.append(ev)
        merged = {"traceEvents": events, "displayTimeUnit": "ms",
                  "otherData": {"clock": clock,
                                "n_replicas": len(self.engines)}}
        if path is not None:
            with open(path, "w") as f:
                json.dump(merged, f, indent=None, separators=(",", ":"))
        return merged
