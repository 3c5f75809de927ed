"""Paged KV-cache bookkeeping: fixed-size pages, a free list, block tables.

The device side is a global page pool per layer - (num_pages, page_size,
Hkv, D) slabs shared by every sequence (see models/model.py init_cache) -
plus one (max_batch, max_pages_per_seq) int32 block table.  This module owns
the HOST side: which pages are free, which belong to which slot, and the
numpy mirror of the block table.  All methods are O(pages moved); nothing
here touches the device (the engine uploads the table itself, copying the
host mirror first - see ServeEngine._sync_table).

Page 0 is the reserved NULL page.  Block-table rows of idle slots point at
it, so the batched decode step's masked K/V writes from inactive lanes land
in a page no live sequence owns (reads are masked by `lens` anyway).  Usable
capacity is therefore ``num_pages - 1`` pages.

Capacity math (see docs/serving.md): a request of P prompt tokens with N
generation budget holds ceil((P + N) / page_size) pages from admission to
completion, vs. a dense slot's ceil(max_seq / page_size).  With mixed
request lengths the pool can be sized well below max_batch * max_seq and
still never reject mid-flight: admission reserves the worst case up front,
so the only backpressure point is `can_alloc` at admit time.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..configs.base import (ModelConfig, ServeConfig, dense_equivalent_pages,
                            pages_for_tokens)
from .telemetry import MetricsRegistry

# canonical page math lives in configs.base; re-exported under the serving
# vocabulary ("how many pages does this request need")
pages_needed = pages_for_tokens

# bytes per element of the dtypes a config may name
_ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def dense_kv_bytes(cfg: ModelConfig, scfg: ServeConfig) -> int:
    """Bytes of the dense (L, max_batch, max_seq, Hkv, D) K+V cache."""
    dt = _ITEMSIZE[cfg.dtype]
    return (2 * cfg.n_layers * scfg.max_batch * scfg.max_seq
            * cfg.n_kv_heads * cfg.head_dim * dt)


def paged_kv_bytes(cfg: ModelConfig, scfg: ServeConfig,
                   num_pages: int = 0) -> int:
    """Bytes of the paged (L, num_pages, page_size, Hkv, D) K+V pool."""
    if num_pages <= 0:
        num_pages = dense_equivalent_pages(scfg.max_batch, scfg.max_seq,
                                           scfg.page_size)
    dt = _ITEMSIZE[cfg.dtype]
    return (2 * cfg.n_layers * num_pages * scfg.page_size
            * cfg.n_kv_heads * cfg.head_dim * dt)


def page_kv_bytes(cfg: ModelConfig, page_size: int) -> int:
    """Bytes of K+V ONE page holds across every layer - the unit the
    engine's analytic kv_pages_read accounting converts to bytes."""
    dt = _ITEMSIZE[cfg.dtype]
    return 2 * cfg.n_layers * page_size * cfg.n_kv_heads * cfg.head_dim * dt


def shard_page_kv_bytes(cfg: ModelConfig, page_size: int,
                        tp_degree: int) -> int:
    """Bytes of K+V one page holds ON ONE DEVICE of a head-sharded
    tensor-parallel pool: each of the tp_degree shards owns an
    Hkv/tp_degree head slice of every page, so per-device page bytes are
    exactly page_kv_bytes / tp_degree.  The allocator's page ids and block
    table are replicated (every shard walks the same table), which is why
    the engine's per-shard byte accounting can reuse the single allocator
    unchanged - the cross-check in tests/conformance.py asserts
    shard_bytes * tp_degree == kv_pages_read * page_kv_bytes."""
    if tp_degree < 1:
        raise ValueError(f"tp_degree must be >= 1, got {tp_degree}")
    if cfg.n_kv_heads % tp_degree:
        raise ValueError(
            f"n_kv_heads ({cfg.n_kv_heads}) must divide by tp_degree "
            f"({tp_degree}) for a head-sharded page pool")
    return page_kv_bytes(cfg, page_size) // tp_degree


class OutOfPages(RuntimeError):
    """Raised by alloc() when the free list cannot cover a reservation."""


class PageAllocator:
    """Free-list page allocator + per-slot page lists + block-table mirror.

    Pages are REFERENCE COUNTED: `alloc` hands out private pages (refcount
    1), `attach` lets a slot share pages another holder already references
    (refcount + 1 each - prefix caching shares cached prompt pages this
    way), and `unref` returns a page to the free list only when its last
    reference drops.  `cow` gives a slot a private replacement for a shared
    page before a write would touch it (copy-on-write bookkeeping; the
    engine copies the device-side page contents).  Exclusive use - alloc /
    free_slot only - behaves exactly like the pre-refcount allocator.
    """

    def __init__(self, num_pages: int, page_size: int, max_batch: int,
                 max_seq: int, usable_pages: int = 0,
                 metrics: Optional[MetricsRegistry] = None):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is the null page)")
        self.num_pages = num_pages
        self.page_size = page_size
        # soft capacity cap (ServeConfig.usable_pages): only pages
        # 1..usable_pages are ever handed out; the device pool keeps its
        # full num_pages shape, so capacity pressure can be dialed without
        # recompiling anything
        self.usable_pages = usable_pages or (num_pages - 1)
        if not 1 <= self.usable_pages <= num_pages - 1:
            raise ValueError(f"usable_pages ({usable_pages}) must be in "
                             f"[1, {num_pages - 1}]")
        self.max_pages_per_seq = pages_needed(max_seq, page_size)
        # LIFO free list; page 0 stays reserved forever
        self._free: List[int] = list(range(self.usable_pages, 0, -1))
        # fault-injection hook: pages withheld from circulation by
        # quarantine() (deterministic page-pool-exhaustion chaos).  They
        # are neither free nor referenced - check_invariants accounts for
        # them explicitly, so invariants stay assertable mid-fault.
        self._quarantined: List[int] = []
        self._refs = np.zeros(num_pages, np.int32)
        self._slot_pages: List[List[int]] = [[] for _ in range(max_batch)]
        self.table = np.zeros((max_batch, self.max_pages_per_seq), np.int32)
        # page-movement counters (serve/telemetry.py registry; the engine
        # shares its registry in, a standalone allocator gets its own)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        m = self.metrics
        self._m_alloc = m.counter("pool_pages_allocated_total",
                                  "Private pages handed out by alloc/cow")
        self._m_freed = m.counter("pool_pages_freed_total",
                                  "Pages whose last reference dropped and "
                                  "returned to the free list")
        self._m_attach = m.counter("pool_pages_attached_total",
                                   "Shared-page attachments (prefix-cache "
                                   "reuse; one refcount increment each)")
        self._m_cow = m.counter("pool_cow_pages_total",
                                "Copy-on-write page splits")
        self._m_free_g = m.gauge("pool_free_pages",
                                 "Pages currently on the free list")
        self._m_used_g = m.gauge("pool_used_pages",
                                 "Usable pages currently referenced")
        self._note_pool()

    def _note_pool(self):
        self._m_free_g.set(len(self._free))
        self._m_used_g.set(self.used_pages)

    # -- queries ----------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.usable_pages - len(self._free) - len(self._quarantined)

    @property
    def quarantined_pages(self) -> int:
        return len(self._quarantined)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def slot_pages(self, slot: int) -> List[int]:
        return list(self._slot_pages[slot])

    def refcount(self, page: int) -> int:
        return int(self._refs[page])

    def live_pages(self) -> int:
        """Distinct pages referenced by at least one slot (the serving
        working set; excludes pages held only by a prefix cache)."""
        return len({p for lst in self._slot_pages for p in lst})

    # -- mutation ---------------------------------------------------------
    def alloc(self, slot: int, n: int) -> List[int]:
        """Append n private pages to `slot`; returns the slot's FULL page
        list (shared pages first if any were attached)."""
        if n > len(self._free):
            raise OutOfPages(f"want {n} pages, {len(self._free)} free")
        owned = self._slot_pages[slot]
        if len(owned) + n > self.max_pages_per_seq:
            raise ValueError(f"slot {slot} would exceed max_seq "
                             f"({len(owned)} + {n} pages)")
        take = [self._free.pop() for _ in range(n)]
        for p in take:
            self._refs[p] = 1
        self.table[slot, len(owned):len(owned) + n] = take
        owned.extend(take)
        self._m_alloc.inc(n)
        self._note_pool()
        return list(owned)

    def attach(self, slot: int, pages: List[int]) -> List[int]:
        """Append already-referenced pages to `slot` (refcount + 1 each);
        returns the slot's full page list.  The caller (the prefix cache)
        guarantees the pages hold valid K/V for the slot's prompt prefix."""
        owned = self._slot_pages[slot]
        if len(owned) + len(pages) > self.max_pages_per_seq:
            raise ValueError(f"slot {slot} would exceed max_seq "
                             f"({len(owned)} + {len(pages)} pages)")
        for p in pages:
            if self._refs[p] <= 0:
                raise ValueError(f"cannot attach free page {p}")
            self._refs[p] += 1
        self.table[slot, len(owned):len(owned) + len(pages)] = pages
        owned.extend(pages)
        self._m_attach.inc(len(pages))
        return list(owned)

    def unref(self, page: int):
        """Drop one reference; the last reference frees the page."""
        if page == 0 or self._refs[page] <= 0:
            raise ValueError(f"unref of page {page} (refs "
                             f"{int(self._refs[page])})")
        self._refs[page] -= 1
        if self._refs[page] == 0:
            self._free.append(page)
            self._m_freed.inc()
            self._note_pool()

    def cow(self, slot: int, index: int):
        """Replace the shared page at `slot` position `index` with a fresh
        private copy (bookkeeping only - the engine copies the device-side
        page data).  Returns (old_page, new_page)."""
        if not self._free:
            raise OutOfPages("copy-on-write needs a free page")
        old = self._slot_pages[slot][index]
        new = self._free.pop()
        self._refs[new] = 1
        self._slot_pages[slot][index] = new
        self.table[slot, index] = new
        self._m_alloc.inc()
        self._m_cow.inc()
        self.unref(old)
        self._note_pool()
        return old, new

    def free_slot(self, slot: int):
        """Drop `slot`'s reference on every page it holds and null its
        table row; pages nobody else references return to the pool."""
        for p in reversed(self._slot_pages[slot]):
            self.unref(p)
        self._slot_pages[slot] = []
        self.table[slot, :] = 0

    def detach(self, slot: int) -> List[int]:
        """Empty `slot`'s page list and table row WITHOUT touching
        refcounts; returns the list.  The caller takes over each page's
        reference (prefix-cache publish transfers them to the tree)."""
        pages = self._slot_pages[slot]
        self._slot_pages[slot] = []
        self.table[slot, :] = 0
        return pages

    def quarantine(self, n: int) -> int:
        """Withhold up to `n` FREE pages from circulation (returns how many
        were actually taken).  The deterministic page-pool-exhaustion
        fault: admission sees a smaller free list and backpressures (or
        preempts) exactly as under real pressure, while the pages - never
        referenced, never free - stay fully accounted in
        check_invariants.  Referenced pages are never touched, so no
        in-flight KV is ever yanked."""
        take = min(n, len(self._free))
        for _ in range(take):
            self._quarantined.append(self._free.pop())
        self._note_pool()
        return take

    def release_quarantine(self) -> int:
        """Return every quarantined page to the free list (fault over);
        returns how many came back."""
        n = len(self._quarantined)
        while self._quarantined:
            self._free.append(self._quarantined.pop())
        self._note_pool()
        return n

    # -- invariants --------------------------------------------------------
    def check_invariants(self, tree_pages=()):
        """Allocator accounting must balance: refcounts equal the number of
        holders (slot memberships + prefix-cache membership), no page is
        both free and referenced, the null page is never handed out, and
        every block-table row mirrors its slot's page list exactly (no
        page both free and mapped through a stale row).  The serve-path
        test fixtures call this after every tick (tests/traffic.py)."""
        tree = set(tree_pages)
        free = set(self._free)
        assert len(free) == len(self._free), "duplicate page in free list"
        assert 0 not in free, "null page on the free list"
        quarantined = set(self._quarantined)
        assert len(quarantined) == len(self._quarantined), \
            "duplicate page in quarantine"
        assert not quarantined & free, "page both free and quarantined"
        assert all(int(self._refs[p]) == 0 for p in quarantined), \
            "referenced page in quarantine"
        counts: dict = {}
        for lst in self._slot_pages:
            for p in lst:
                counts[p] = counts.get(p, 0) + 1
        for p in tree:
            counts[p] = counts.get(p, 0) + 1
        assert 0 not in counts, "null page referenced"
        for p in range(1, self.num_pages):
            r = int(self._refs[p])
            assert r == counts.get(p, 0), \
                f"page {p}: refcount {r} != holders {counts.get(p, 0)}"
            if p in quarantined:
                continue                 # checked above: refcount 0, not free
            if p <= self.usable_pages:
                assert (p in free) == (r == 0), \
                    f"page {p} both free and referenced (refs {r})"
            else:
                assert r == 0 and p not in free, \
                    f"page {p} beyond the usable cap is in circulation"
        for slot, pages in enumerate(self._slot_pages):
            row = self.table[slot]
            assert row[:len(pages)].tolist() == pages, \
                f"slot {slot}: table row diverged from page list"
            assert not row[len(pages):].any(), \
                f"slot {slot}: stale table entries past its page list"
        referenced = sum(1 for p in range(1, self.num_pages)
                         if self._refs[p] > 0)
        assert len(free) + referenced + len(quarantined) \
            == self.usable_pages, \
            f"page conservation violated: {len(free)} free + {referenced} " \
            f"referenced + {len(quarantined)} quarantined " \
            f"!= {self.usable_pages} usable"
        assert all(p <= self.usable_pages for p in free), \
            "page beyond the usable cap on the free list"
