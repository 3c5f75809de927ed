from .drafting import ngram_draft
from .engine import ServeEngine
from .paged_cache import (OutOfPages, PageAllocator, dense_kv_bytes,
                          paged_kv_bytes, pages_needed)
from .sampling import apply_top_k, apply_top_p, sample
from .scheduler import (ChunkBatch, ChunkTask, Request, RequestState,
                        TokenBudgetScheduler, bucket_rows)
from .serve_step import (make_chunk_batch_step, make_fused_decode_step,
                         sample_token)
from .telemetry import (Counter, Gauge, Histogram, LaunchRecord,
                        MetricError, MetricsRegistry, Telemetry, TickRecord)

__all__ = ["ChunkBatch", "ChunkTask", "Counter", "Gauge", "Histogram",
           "LaunchRecord", "MetricError", "MetricsRegistry", "OutOfPages",
           "PageAllocator", "Request", "RequestState", "ServeEngine",
           "Telemetry", "TickRecord", "TokenBudgetScheduler", "apply_top_k",
           "apply_top_p", "bucket_rows", "dense_kv_bytes",
           "make_chunk_batch_step", "make_fused_decode_step", "ngram_draft",
           "paged_kv_bytes", "pages_needed", "sample", "sample_token"]
