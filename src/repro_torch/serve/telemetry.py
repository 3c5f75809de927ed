"""Engine telemetry: the metrics registry, per-launch data-movement records
and per-tick dispatch records.

  MetricsRegistry   counters / gauges / histograms, each registered exactly
                    once with a help string; snapshots export as JSON or
                    Prometheus text.  The engine, scheduler and page
                    allocator all register into one registry per engine.
  LaunchRecord      per kernel launch: rows launched, true vs padded
                    tokens, KV pages read / written (counted from the page
                    allocator's block table).
  TickRecord        per tick: launches, host transfers, host wall time.

Everything here is host-side Python over counts the engine already
computes; none of it reads a device tensor.  The span tracer, its Chrome
trace export and the data-movement cost breakdown come with the rest of
the engine's telemetry (ROADMAP M6).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "LaunchRecord", "MetricError",
    "MetricsRegistry", "Telemetry", "TickRecord",
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
        """{name: help} for every registered metric (the doc-coverage
        check in tests/test_telemetry.py walks this)."""
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
    """One engine's telemetry surface: the shared metrics registry (the
    stats() backing store), per-launch movement records, and the per-tick
    dispatch records behind the engine's launch_log view."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 launch_capacity: int = 65536):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.launches: deque = deque(maxlen=launch_capacity)
        self.ticks: List[TickRecord] = []

    def launch(self, rec: LaunchRecord):
        """Record one kernel launch's movement record."""
        self.launches.append(rec)
