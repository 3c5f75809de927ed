from .drafting import ngram_draft
from .engine import ServeEngine
from .paged_cache import (OutOfPages, PageAllocator, dense_kv_bytes,
                          paged_kv_bytes, pages_needed)
from .prefix_cache import RadixPrefixCache
from .router import FleetConfig, FleetRouter, ReplicaState
from .sampling import (apply_top_k, apply_top_p, sample, sample_chain,
                       speculative_accept)
from .scheduler import (ChunkBatch, ChunkTask, DraftTask, Request,
                        RequestState, SpecBatch, TokenBudgetScheduler,
                        bucket_rows)
from .serve_step import (make_chunk_batch_step, make_chunk_prefill_step,
                         make_fused_decode_step, make_paged_prefill_step,
                         make_prefill_step, make_serve_step,
                         make_spec_verify_step, make_suffix_prefill_step,
                         sample_token)
from .telemetry import (Counter, Gauge, Histogram, LaunchRecord,
                        MetricError, MetricsRegistry, SpanTracer, Telemetry,
                        TickRecord, export_chrome_trace, movement_breakdown)

__all__ = ["ChunkBatch", "ChunkTask", "Counter", "DraftTask", "FleetConfig",
           "FleetRouter", "Gauge", "Histogram", "LaunchRecord",
           "MetricError", "MetricsRegistry", "OutOfPages", "PageAllocator",
           "RadixPrefixCache", "ReplicaState", "Request", "RequestState",
           "ServeEngine", "SpanTracer", "SpecBatch", "Telemetry",
           "TickRecord", "TokenBudgetScheduler", "apply_top_k",
           "apply_top_p", "bucket_rows", "dense_kv_bytes",
           "export_chrome_trace", "make_chunk_batch_step",
           "make_chunk_prefill_step", "make_fused_decode_step",
           "make_paged_prefill_step", "make_prefill_step", "make_serve_step",
           "make_spec_verify_step", "make_suffix_prefill_step",
           "movement_breakdown", "ngram_draft", "paged_kv_bytes",
           "pages_needed", "sample", "sample_chain", "sample_token",
           "speculative_accept"]
