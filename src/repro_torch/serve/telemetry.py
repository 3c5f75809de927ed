"""Engine-wide telemetry: the metrics registry, the span tracer, per-launch
data-movement records, the data-movement cost model and a Perfetto trace
exporter - the JAX package's serve/telemetry.py, ported.

  MetricsRegistry   counters / gauges / histograms, each registered exactly
                    once with a help string; snapshots export as JSON or
                    Prometheus text.  The engine, scheduler, page allocator
                    and prefix cache all register into one registry per
                    engine.
  SpanTracer        a bounded ring buffer of lifecycle spans and instant
                    events (ServeConfig.telemetry).  Every record is
                    stamped with the host's wall clock (seconds since the
                    tracer's epoch), the engine's deterministic work clock
                    and the tick index, so the work-clock view of a
                    replayed trace is reproducible record for record
                    (deterministic_trace) while the wall view stays
                    readable in Perfetto.
  LaunchRecord      per kernel launch: rows launched, true vs padded
                    tokens, KV pages read / written (counted from the page
                    allocator's block table).
  TickRecord        per tick: launches, host transfers, host wall time.
  movement_breakdown  a first-order byte model over the launch records
                    (HBM and SRAM bytes per launch kind) folded through
                    the paper's 16 nm energy table (core/energy.py).  The
                    bytes are a model, not a device counter, and the
                    energy is the paper's design's, not the GPU's.
  export_chrome_trace  Chrome trace-event JSON (what Perfetto and
                    chrome://tracing open): request phases on per-slot
                    tracks, engine phases and launches on engine tracks.

Everything here is host-side Python over counts the engine already
computes; none of it reads a device tensor, and every wall stamp is the
host's time.perf_counter().  A launch span is therefore the time the host
took to DISPATCH the launch (the device runs it asynchronously), never the
launch's device time - that comes from the profiler.
"""
from __future__ import annotations

import json
import time
from collections import deque
from dataclasses import dataclass, field
from typing import (Any, Dict, Iterable, Iterator, List, Optional, Sequence,
                    Tuple)

import torch

from ..core.energy import Activity, EnergyTable, energy_of

__all__ = [
    "Counter", "Gauge", "Histogram", "LaunchRecord", "MetricError",
    "MetricsRegistry", "Span", "SpanTracer", "Telemetry", "TickRecord",
    "TraceEvent", "export_chrome_trace", "movement_breakdown",
]


# ===========================================================================
# metrics registry
# ===========================================================================

class MetricError(ValueError):
    """Raised on duplicate registration, a missing help string, or a
    label-shape mismatch - the registration-drift hazards the registry
    exists to make impossible."""


class _Metric:
    """Base: a named instrument with a mandatory help string.  Metrics
    with `labelnames` hold one value per observed label tuple (accessed
    through .labels(...)); unlabeled metrics hold a single value."""

    kind = "untyped"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = ()):
        if not name or not name.replace("_", "").isalnum():
            raise MetricError(f"invalid metric name {name!r}")
        if not help or not help.strip():
            raise MetricError(f"metric {name!r} registered without a help "
                              f"string")
        self.name = name
        self.help = help.strip()
        self.labelnames = tuple(labelnames)
        self._children: Dict[Tuple[str, ...], "_Metric"] = {}

    def labels(self, *values) -> "_Metric":
        """Child instrument for one label-value tuple (created lazily)."""
        if len(values) != len(self.labelnames):
            raise MetricError(
                f"{self.name}: got {len(values)} label values for "
                f"labels {self.labelnames}")
        key = tuple(str(v) for v in values)
        child = self._children.get(key)
        if child is None:
            child = type(self)(self.name, self.help)
            self._children[key] = child
        return child

    def label_items(self) -> List[Tuple[Tuple[str, ...], "_Metric"]]:
        return sorted(self._children.items())


class Counter(_Metric):
    """Monotone event count.  `set_total` exists ONLY so legacy attribute
    views (``engine.jit_calls += 1`` style) can write through the
    registry; it still refuses to run the counter backwards."""

    kind = "counter"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = ()):
        super().__init__(name, help, labelnames)
        self.value: float = 0

    def inc(self, n: float = 1):
        if n < 0:
            raise MetricError(f"{self.name}: counter increment {n} < 0")
        self.value += n

    def set_total(self, v: float):
        if v < self.value:
            raise MetricError(f"{self.name}: counter cannot decrease "
                              f"({self.value} -> {v})")
        self.value = v


class Gauge(_Metric):
    """Point-in-time value (queue depth, free pages, peak watermark)."""

    kind = "gauge"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = ()):
        super().__init__(name, help, labelnames)
        self.value: float = 0

    def set(self, v: float):
        self.value = v

    def max_update(self, v: float):
        """Watermark update: keep the high-water mark."""
        if v > self.value:
            self.value = v


class Histogram(_Metric):
    """Cumulative-bucket histogram (Prometheus semantics: each bucket
    counts observations <= its upper bound, plus the implicit +Inf)."""

    kind = "histogram"
    DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        self.buckets = tuple(sorted(buckets))
        if not self.buckets:
            raise MetricError(f"{name}: histogram needs >= 1 bucket")
        self.bucket_counts = [0] * (len(self.buckets) + 1)   # + Inf
        self.count = 0
        self.sum = 0.0

    def observe(self, v: float):
        self.count += 1
        self.sum += v
        for i, ub in enumerate(self.buckets):
            if v <= ub:
                self.bucket_counts[i] += 1
                return
        self.bucket_counts[-1] += 1

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


class MetricsRegistry:
    """One typed home for every metric an engine emits.  Registration is
    exactly-once (a second register of the same name raises MetricError),
    every metric carries a help string, and the whole registry exports as
    a JSON snapshot or Prometheus text - the drift-proofing the old three
    dict conventions lacked."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}

    # -- registration -----------------------------------------------------
    def _register(self, metric: _Metric) -> _Metric:
        if metric.name in self._metrics:
            raise MetricError(f"metric {metric.name!r} registered twice")
        self._metrics[metric.name] = metric
        return metric

    def counter(self, name: str, help: str,
                labelnames: Sequence[str] = ()) -> Counter:
        return self._register(Counter(name, help, labelnames))

    def gauge(self, name: str, help: str,
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge(name, help, labelnames))

    def histogram(self, name: str, help: str,
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = Histogram.DEFAULT_BUCKETS
                  ) -> Histogram:
        return self._register(Histogram(name, help, labelnames, buckets))

    # -- access -----------------------------------------------------------
    def get(self, name: str) -> _Metric:
        return self._metrics[name]

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def __iter__(self) -> Iterator[_Metric]:
        return iter(self._metrics[n] for n in self.names())

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def catalog(self) -> Dict[str, str]:
        """{name: help} for every registered metric."""
        return {m.name: m.help for m in self}

    # -- export -----------------------------------------------------------
    @staticmethod
    def _scalar(v: float):
        return int(v) if float(v).is_integer() else float(v)

    def _metric_value(self, m: _Metric):
        if isinstance(m, Histogram):
            return {"buckets": list(m.buckets),
                    "bucket_counts": list(m.bucket_counts),
                    "count": m.count, "sum": m.sum, "mean": m.mean}
        if m.labelnames:
            return {",".join(k): self._scalar(c.value)
                    for k, c in m.label_items()}
        return self._scalar(m.value)

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """JSON-ready snapshot: {name: {kind, help, value}}."""
        return {m.name: {"kind": m.kind, "help": m.help,
                         "value": self._metric_value(m)}
                for m in self}

    def prometheus_text(self) -> str:
        """Prometheus text exposition format (one # HELP / # TYPE pair
        per metric; labeled metrics render one sample per label tuple)."""
        out: List[str] = []
        for m in self:
            out.append(f"# HELP {m.name} {m.help}")
            out.append(f"# TYPE {m.name} {m.kind}")
            if isinstance(m, Histogram):
                cum = 0
                for ub, c in zip(m.buckets, m.bucket_counts):
                    cum += c
                    out.append(f'{m.name}_bucket{{le="{ub}"}} {cum}')
                out.append(f'{m.name}_bucket{{le="+Inf"}} {m.count}')
                out.append(f"{m.name}_sum {m.sum}")
                out.append(f"{m.name}_count {m.count}")
            elif m.labelnames:
                for key, child in m.label_items():
                    lbl = ",".join(f'{n}="{v}"'
                                   for n, v in zip(m.labelnames, key))
                    out.append(f"{m.name}{{{lbl}}} "
                               f"{self._scalar(child.value)}")
            else:
                out.append(f"{m.name} {self._scalar(m.value)}")
        return "\n".join(out) + "\n"


# ===========================================================================
# spans and events
# ===========================================================================

# track ids for the Chrome-trace export: requests live on per-slot tracks
# (track = slot index); these engine-level tracks sit alongside them
TRACK_ENGINE = -1      # per-tick engine phases (plan / launches / fetch)
TRACK_QUEUE = -2       # requests waiting for admission (QUEUED / RESUMING)


@dataclass(frozen=True)
class Span:
    """One closed interval: a request lifecycle phase or an engine tick
    phase.  `work0`/`work1` are deterministic work-clock stamps; `wall0`/
    `wall1` are seconds since the tracer's epoch."""
    name: str
    cat: str                     # "request" | "tick" | "launch"
    track: int                   # slot index, TRACK_ENGINE, or TRACK_QUEUE
    tick: int                    # engine tick index at span START
    work0: int
    work1: int
    wall0: float
    wall1: float
    args: Tuple[Tuple[str, Any], ...] = ()

    def deterministic_key(self) -> tuple:
        """Everything but the wall stamps - the bit-reproducible view."""
        return ("span", self.name, self.cat, self.track, self.tick,
                self.work0, self.work1, self.args)


@dataclass(frozen=True)
class TraceEvent:
    """One instant: PREEMPT, RESUME, FINISH, SPEC_VERIFY, prefix-cache
    hit/evict - anything with a moment but no duration."""
    name: str
    cat: str
    track: int
    tick: int
    work: int
    wall: float
    args: Tuple[Tuple[str, Any], ...] = ()

    def deterministic_key(self) -> tuple:
        return ("event", self.name, self.cat, self.track, self.tick,
                self.work, self.args)


def _freeze_args(kw: Dict[str, Any]) -> Tuple[Tuple[str, Any], ...]:
    return tuple(sorted(kw.items()))


class SpanTracer:
    """Bounded ring buffer of spans and instant events, in record order.
    When full the OLDEST records drop (and are counted in `dropped`), so
    a long-running engine's tracer is a flight recorder, not a leak."""

    def __init__(self, capacity: int = 65536):
        if capacity < 1:
            raise ValueError(f"tracer capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._buf: deque = deque(maxlen=capacity)
        self.dropped = 0
        self.epoch = time.perf_counter()

    def now(self) -> float:
        """Wall seconds since this tracer's epoch."""
        return time.perf_counter() - self.epoch

    def _append(self, rec):
        if len(self._buf) == self.capacity:
            self.dropped += 1
        self._buf.append(rec)

    def add_span(self, name: str, cat: str, track: int, tick: int,
                 work0: int, work1: int, wall0: float, wall1: float,
                 **args):
        self._append(Span(name, cat, track, tick, int(work0), int(work1),
                          wall0, wall1, _freeze_args(args)))

    def add_event(self, name: str, cat: str, track: int, tick: int,
                  work: int, wall: float, **args):
        self._append(TraceEvent(name, cat, track, tick, int(work), wall,
                                _freeze_args(args)))

    def records(self) -> List[Any]:
        return list(self._buf)

    def spans(self) -> List[Span]:
        return [r for r in self._buf if isinstance(r, Span)]

    def events(self) -> List[TraceEvent]:
        return [r for r in self._buf if isinstance(r, TraceEvent)]

    def __len__(self) -> int:
        return len(self._buf)

    def deterministic_trace(self) -> List[tuple]:
        """The wall-clock-free view of every record, in order: two replays
        of the same seeded traffic trace must produce EXACTLY this list."""
        return [r.deterministic_key() for r in self._buf]


# ===========================================================================
# per-launch data-movement records
# ===========================================================================

@dataclass(frozen=True)
class LaunchRecord:
    """Data-movement attribution for one kernel launch.  Page counts come
    from the PageAllocator's block-table accounting (the engine counts
    mapped pages over each row's true span), so they can be cross-checked
    exactly against ceil(true_len / page_size) math - one source of
    truth, not a parallel convention."""
    tick: int
    kind: str                # prefill | prefill_paged | chunk | chunk_batch
    #                          | decode | spec_verify | stepwise
    rows: int                # kernel rows launched (after pow2 bucketing)
    live_rows: int           # rows carrying real work
    true_tokens: int         # real query tokens computed
    padded_tokens: int       # rows * row width (incl. bucket/pad waste)
    kv_pages_read: int       # pages the launch's attention reads
    kv_pages_written: int    # pages its K/V writes touch
    new_kv_tokens: int       # KV positions written (true)
    work_clock: int          # scheduler work clock AFTER the launch


@dataclass(frozen=True)
class TickRecord:
    """One tick's dispatch accounting - the typed record behind the
    legacy ``launch_log`` 5-tuple compatibility view."""
    jit_calls: int
    host_syncs: int
    host_wall_s: float
    n_chunk_tasks: int
    n_decode: int

    def as_tuple(self) -> tuple:
        return (self.jit_calls, self.host_syncs, self.host_wall_s,
                self.n_chunk_tasks, self.n_decode)


# ===========================================================================
# telemetry facade (what the engine holds)
# ===========================================================================

class Telemetry:
    """One engine's telemetry surface: the shared metrics registry
    (always on - it IS the stats() backing store), the span tracer
    (optional, ServeConfig.telemetry), per-launch movement records, and
    the per-tick dispatch records behind the launch_log view."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[SpanTracer] = None,
                 launch_capacity: int = 65536):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = tracer
        self.launches: deque = deque(maxlen=launch_capacity)
        self.ticks: List[TickRecord] = []
        # open request-phase spans: uid -> (phase, track, tick0, work0, wall0)
        self._open: Dict[int, tuple] = {}

    @property
    def enabled(self) -> bool:
        return self.tracer is not None

    # -- request lifecycle -------------------------------------------------
    def request_phase(self, uid: int, phase: str, track: int, tick: int,
                      work: int, **args):
        """Close the request's open phase span (if any) and open `phase`.
        Terminal phases (DONE) close without opening.  No-op with the
        tracer off."""
        tr = self.tracer
        if tr is None:
            return
        wall = tr.now()
        open_ = self._open.pop(uid, None)
        if open_ is not None:
            old_phase, old_track, tick0, work0, wall0 = open_
            tr.add_span(f"r{uid}:{old_phase}", "request", old_track, tick0,
                        work0, work, wall0, wall, uid=uid, phase=old_phase)
        if phase == "DONE":
            tr.add_event(f"r{uid}:DONE", "request",
                         open_[1] if open_ else track, tick, work, wall,
                         uid=uid, **args)
        else:
            self._open[uid] = (phase, track, tick, work, wall)

    def request_event(self, uid: int, name: str, track: int, tick: int,
                      work: int, **args):
        tr = self.tracer
        if tr is not None:
            tr.add_event(f"r{uid}:{name}", "request", track, tick, work,
                         tr.now(), uid=uid, **args)

    def open_phases(self) -> Dict[int, str]:
        """uid -> open phase name (diagnostics; drained traces are empty)."""
        return {uid: rec[0] for uid, rec in self._open.items()}

    # -- launches ----------------------------------------------------------
    def launch(self, rec: LaunchRecord, wall0: float, wall1: float):
        """Record one kernel launch: a movement record plus a span on the
        engine track."""
        self.launches.append(rec)
        tr = self.tracer
        if tr is not None:
            tr.add_span(rec.kind, "launch", TRACK_ENGINE, rec.tick,
                        rec.work_clock, rec.work_clock, wall0, wall1,
                        rows=rec.rows, live_rows=rec.live_rows,
                        true_tokens=rec.true_tokens,
                        padded_tokens=rec.padded_tokens,
                        kv_pages_read=rec.kv_pages_read,
                        kv_pages_written=rec.kv_pages_written)


# ===========================================================================
# movement attribution: launch records -> HBM / SRAM bytes and energy
# ===========================================================================

def _itemsize(cfg) -> int:
    """Bytes of one element of the torch dtype `cfg.dtype` names."""
    return getattr(torch, cfg.dtype).itemsize


def _kv_token_bytes(cfg) -> int:
    """Bytes of K+V one token holds across every layer."""
    itemsize = _itemsize(cfg)
    return 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * itemsize


def movement_breakdown(launches: Iterable[LaunchRecord], cfg, scfg,
                       energy_table=None,
                       tp_degree: int = 1) -> Dict[str, Dict[str, float]]:
    """Fold per-launch movement records into a paper-style (Fig. 6)
    data-movement breakdown per launch kind, in estimated HBM and SRAM
    bytes and energy.

    tp_degree > 1 adds a "per_device" section attributing the totals to
    ONE device of a head-sharded tensor-parallel engine: KV bytes divide
    by tp_degree (each shard streams only its Hkv/tp head slice of every
    page), while weights, activations, and the block table are replicated
    - every device streams them in full.  (Host arithmetic only: the
    port's engine does not shard yet, ROADMAP M10.)

    The byte model is a first-order serving roofline, not a device
    counter:

      KV read    pages_read * page_size tokens of K+V stream from HBM
      KV write   every newly written KV position streams back once
      weights    each launch streams the active parameters once
      acts       every padded query token moves one d_model activation
                 vector in and out per layer
      SRAM       every HBM byte is staged through on-chip SRAM once in
                 and once out (the flash kernels are single-pass by
                 construction, so 2x is the floor, not a guess)

    Energy folds the byte totals through core/energy.py's per-action
    table (e_dram_byte / e_sram_byte), the paper's 16 nm constants that
    its reproduction figures use: the energy of the paper's design moving
    these bytes, not a measurement of the GPU that served them.
    `padding_overhead` is the fraction of
    moved query tokens that were bucket/row padding - the cost of the
    power-of-two compile-shape bucketing, made visible per kind.
    """
    tbl = energy_table if energy_table is not None \
        else EnergyTable.default16nm()
    itemsize = _itemsize(cfg)
    kv_tok = _kv_token_bytes(cfg)
    weight_bytes_per_launch = cfg.active_param_count() * itemsize
    act_tok = 2 * cfg.n_layers * cfg.d_model * itemsize

    kinds: Dict[str, Dict[str, float]] = {}
    for rec in launches:
        row = kinds.setdefault(rec.kind, {
            "launches": 0, "rows": 0, "live_rows": 0, "true_tokens": 0,
            "padded_tokens": 0, "kv_pages_read": 0, "kv_pages_written": 0,
            "new_kv_tokens": 0, "kv_read_bytes": 0.0, "kv_write_bytes": 0.0,
            "weight_bytes": 0.0, "act_bytes": 0.0, "hbm_bytes": 0.0,
            "sram_bytes": 0.0, "energy_j": 0.0, "padding_overhead": 0.0})
        row["launches"] += 1
        row["rows"] += rec.rows
        row["live_rows"] += rec.live_rows
        row["true_tokens"] += rec.true_tokens
        row["padded_tokens"] += rec.padded_tokens
        row["kv_pages_read"] += rec.kv_pages_read
        row["kv_pages_written"] += rec.kv_pages_written
        row["new_kv_tokens"] += rec.new_kv_tokens
        row["kv_read_bytes"] += rec.kv_pages_read * scfg.page_size * kv_tok
        row["kv_write_bytes"] += rec.new_kv_tokens * kv_tok
        row["weight_bytes"] += weight_bytes_per_launch
        row["act_bytes"] += rec.padded_tokens * act_tok

    total = {k: 0.0 for k in ("launches", "rows", "live_rows",
                              "true_tokens", "padded_tokens",
                              "kv_pages_read", "kv_pages_written",
                              "new_kv_tokens", "kv_read_bytes",
                              "kv_write_bytes", "weight_bytes", "act_bytes",
                              "hbm_bytes", "sram_bytes", "energy_j")}
    for row in kinds.values():
        row["hbm_bytes"] = (row["kv_read_bytes"] + row["kv_write_bytes"]
                            + row["weight_bytes"] + row["act_bytes"])
        row["sram_bytes"] = 2.0 * row["hbm_bytes"]
        row["energy_j"] = energy_of(
            Activity(dram_bytes=row["hbm_bytes"],
                     sram_bytes=row["sram_bytes"]), tbl).total
        row["padding_overhead"] = (
            1.0 - row["true_tokens"] / row["padded_tokens"]
            if row["padded_tokens"] else 0.0)
        for k in total:
            total[k] += row[k]
    total["padding_overhead"] = (
        1.0 - total["true_tokens"] / total["padded_tokens"]
        if total["padded_tokens"] else 0.0)
    if total["hbm_bytes"]:
        for row in kinds.values():
            row["hbm_share"] = row["hbm_bytes"] / total["hbm_bytes"]
    kinds["total"] = total
    if tp_degree > 1:
        per_dev_hbm = ((total["kv_read_bytes"] + total["kv_write_bytes"])
                       / tp_degree
                       + total["weight_bytes"] + total["act_bytes"])
        kinds["per_device"] = {
            "tp_degree": float(tp_degree),
            "kv_read_bytes": total["kv_read_bytes"] / tp_degree,
            "kv_write_bytes": total["kv_write_bytes"] / tp_degree,
            "weight_bytes": total["weight_bytes"],     # replicated
            "act_bytes": total["act_bytes"],           # replicated
            "hbm_bytes": per_dev_hbm,
            "sram_bytes": 2.0 * per_dev_hbm,
            "energy_j": energy_of(
                Activity(dram_bytes=per_dev_hbm,
                         sram_bytes=2.0 * per_dev_hbm), tbl).total,
        }
    return kinds


# ===========================================================================
# Chrome trace-event export (Perfetto / chrome://tracing)
# ===========================================================================

_PID_ENGINE = 0
_PID_REQUESTS = 1
# engine-track tids inside the engine process
_TID_TICKS = 0
_TID_LAUNCHES = 1


def _track_ids(track: int, n_slots: int) -> Tuple[int, int]:
    """Map a telemetry track to a (pid, tid) pair: engine phases and
    launches live in the engine process; request phases live in the
    requests process, one thread per slot, with the admission queue as
    the thread after the last slot."""
    if track == TRACK_ENGINE:
        return _PID_ENGINE, _TID_LAUNCHES
    if track == TRACK_QUEUE:
        return _PID_REQUESTS, n_slots
    return _PID_REQUESTS, track


def export_chrome_trace(path, tracer: SpanTracer, n_slots: int,
                        clock: str = "wall") -> Dict[str, Any]:
    """Write the tracer's records as Chrome trace-event JSON - the format
    Perfetto (ui.perfetto.dev) and chrome://tracing open directly.

    `clock` selects the timestamp domain: "wall" (microseconds of wall
    time since the tracer epoch - the human view) or "work" (the
    deterministic work clock, one microsecond per work token - the view
    that is bit-identical across replays of the same trace).  Returns
    the trace dict it wrote; pass path=None to skip writing.
    """
    if clock not in ("wall", "work"):
        raise ValueError(f"clock must be 'wall' or 'work', got {clock!r}")

    def ts_span(s: Span) -> Tuple[float, float]:
        if clock == "wall":
            return s.wall0 * 1e6, max((s.wall1 - s.wall0) * 1e6, 0.0)
        return float(s.work0), float(max(s.work1 - s.work0, 0))

    def ts_event(e: TraceEvent) -> float:
        return e.wall * 1e6 if clock == "wall" else float(e.work)

    events: List[Dict[str, Any]] = [
        {"ph": "M", "pid": _PID_ENGINE, "tid": 0, "name": "process_name",
         "args": {"name": "engine"}},
        {"ph": "M", "pid": _PID_ENGINE, "tid": _TID_TICKS,
         "name": "thread_name", "args": {"name": "ticks"}},
        {"ph": "M", "pid": _PID_ENGINE, "tid": _TID_LAUNCHES,
         "name": "thread_name", "args": {"name": "launches"}},
        {"ph": "M", "pid": _PID_REQUESTS, "tid": 0, "name": "process_name",
         "args": {"name": "requests"}},
        {"ph": "M", "pid": _PID_REQUESTS, "tid": n_slots,
         "name": "thread_name", "args": {"name": "queue"}},
    ]
    for slot in range(n_slots):
        events.append({"ph": "M", "pid": _PID_REQUESTS, "tid": slot,
                       "name": "thread_name",
                       "args": {"name": f"slot{slot}"}})
    for rec in tracer.records():
        if isinstance(rec, Span):
            pid, tid = _track_ids(rec.track, n_slots)
            if rec.cat == "tick":
                pid, tid = _PID_ENGINE, _TID_TICKS
            ts, dur = ts_span(rec)
            events.append({"ph": "X", "name": rec.name, "cat": rec.cat,
                           "pid": pid, "tid": tid, "ts": ts, "dur": dur,
                           "args": dict(rec.args)})
        else:
            pid, tid = _track_ids(rec.track, n_slots)
            events.append({"ph": "i", "s": "t", "name": rec.name,
                           "cat": rec.cat, "pid": pid, "tid": tid,
                           "ts": ts_event(rec), "args": dict(rec.args)})
    trace = {"traceEvents": events, "displayTimeUnit": "ms",
             "otherData": {"clock": clock,
                           "dropped_records": tracer.dropped}}
    if path is not None:
        with open(path, "w") as f:
            json.dump(trace, f, indent=None, separators=(",", ":"))
    return trace
