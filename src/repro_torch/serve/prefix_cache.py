"""Radix-tree prefix cache: prompt-page reuse with copy-on-write paging.

The JAX package's serve/prefix_cache.py, copied: host-side only, over the
port's PageAllocator and MetricsRegistry.

Real serving traffic is full of repeated prompt prefixes - shared system
prompts, few-shot templates, multi-turn chat where every turn resends the
conversation so far.  The paged KV pool (serve/paged_cache.py) already
stores K/V in position-independent pages; this module adds the host-side
index that lets a NEW request reuse pages an earlier request computed:

  radix tree   keyed by page-sized token blocks, with path compression
               (one node can label a run of many blocks).  `match` walks
               the longest cached prefix of a prompt, whole pages only -
               a page is shared either completely or not at all, so the
               K/V inside shared pages is immutable by construction.
  refcounts    live in the PageAllocator: the tree holds one reference on
               every cached page, each slot using the page holds another.
               Pages return to the free list only when the last reference
               drops - a page is never both free and referenced.
  copy-on-write  a slot that must WRITE into a shared page (refcount > 1)
               first gets a private copy (allocator.cow + a device-side
               page copy by the engine).  The one structural writer is a
               fully cached prompt: its last token is recomputed for
               logits, and that token's K/V lands in the final cached
               page - so admission COWs exactly that page.
  LRU eviction tail-first from the least-recently-used leaves: only pages
               whose sole reference is the tree's are evictable, so an
               in-flight request can never lose a page it is attending
               over.  Trimming from the tail keeps every surviving node a
               valid prefix.

Capacity math (docs/prefix_caching.md): with H requests sharing a P-token
prefix, the pool holds the prefix ONCE (ceil(P / page_size) pages) instead
of H times, and admission prefills only each request's suffix - prefill
compute and peak working-set pages both drop by roughly the hit rate.
"""
from __future__ import annotations

from typing import (Callable, Dict, FrozenSet, List, Optional, Sequence, Set,
                    Tuple)

from .paged_cache import PageAllocator
from .telemetry import MetricsRegistry

Block = Tuple[int, ...]


class _Node:
    """One radix-tree edge: a run of page-sized token blocks and the
    physical page holding each block's K/V."""
    __slots__ = ("blocks", "pages", "children", "parent", "last_used")

    def __init__(self, blocks: List[Block], pages: List[int],
                 parent: Optional["_Node"]):
        self.blocks = blocks
        self.pages = pages
        self.children: Dict[Block, "_Node"] = {}
        self.parent = parent
        self.last_used = 0


class RadixPrefixCache:
    """Host-side prefix index over a PageAllocator's page pool."""

    def __init__(self, allocator: PageAllocator, page_size: int,
                 metrics: Optional[MetricsRegistry] = None):
        self.alloc = allocator
        self.page_size = page_size
        self.root = _Node([], [], None)
        self._clock = 0
        self._pages: Set[int] = set()       # pages the tree holds a ref on
        # cache-traffic counters (serve/telemetry.py registry; the engine
        # shares its registry in, a standalone cache gets its own) plus an
        # optional event hook for hit / publish / evict instants (the
        # port's engine has no span tracer to point it at yet)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        m = self.metrics
        self._m_lookups = m.counter("prefix_lookups_total",
                                    "Prefix-cache match() walks")
        self._m_hits = m.counter("prefix_hits_total",
                                 "match() walks that found >= 1 cached page")
        self._m_hit_pages = m.counter("prefix_hit_pages_total",
                                      "Cached pages returned by match()")
        self._m_pub = m.counter("prefix_published_pages_total",
                                "Prompt pages newly inserted into the tree")
        self._m_evict = m.counter("prefix_evicted_pages_total",
                                  "Cached pages LRU-evicted back to the "
                                  "pool")
        self._m_cached_g = m.gauge("prefix_cached_pages",
                                   "Pages currently held by the tree")
        self.event_cb: Optional[Callable[..., None]] = None

    def _event(self, name: str, **args):
        if self.event_cb is not None:
            self.event_cb(name, **args)

    # -- helpers ------------------------------------------------------------
    def _block_split(self, tokens: Sequence[int]) -> List[Block]:
        ps = self.page_size
        return [tuple(tokens[i * ps:(i + 1) * ps])
                for i in range(len(tokens) // ps)]

    def _touch(self, node: _Node):
        self._clock += 1
        node.last_used = self._clock

    @property
    def cached_pages(self) -> int:
        return len(self._pages)

    def evictable_pages(self) -> int:
        """Pages whose only reference is the tree's (LRU candidates)."""
        return sum(1 for p in self._pages if self.alloc.refcount(p) == 1)

    def cached_prefix_len(self, tokens: Sequence[int]) -> int:
        """Tokens of `tokens` currently resident in cached pages (whole
        pages only) - what a preempted request would NOT have to re-prefill
        if it resumed right now.  Built on the read-only `peek`, so
        measuring survival cannot perturb eviction order."""
        return len(self.peek(tokens)) * self.page_size

    def _walk(self, tokens: Sequence[int], touch: bool) -> List[int]:
        """Longest-cached-prefix walk shared by match / cached_prefix_len:
        page ids covering the longest cached prefix of `tokens`, whole
        pages only; bumps LRU timestamps along the path iff `touch`."""
        blocks = self._block_split(tokens)
        out: List[int] = []
        node = self.root
        i = 0
        while i < len(blocks):
            child = node.children.get(blocks[i])
            if child is None:
                break
            m, lim = 0, min(len(child.blocks), len(blocks) - i)
            while m < lim and child.blocks[m] == blocks[i + m]:
                m += 1
            out.extend(child.pages[:m])
            if touch:
                self._touch(child)
            if m < len(child.blocks):
                break                       # diverged (or prompt ended) mid-edge
            node, i = child, i + m
        return out

    # -- peek (read-only) -----------------------------------------------------
    def peek(self, tokens: Sequence[int]) -> List[int]:
        """Side-effect-free longest-cached-prefix lookup: the page ids
        `match` WOULD return, without claiming them.  Never bumps LRU
        stamps, never advances the tree clock, never touches refcounts,
        and records no metrics or trace events - so an outside observer
        (the fleet router scoring every replica per request) cannot
        perturb eviction order or hit-rate accounting on replicas that
        end up not receiving the request.  The result is advisory: pages
        may be evicted between peek and a later match/attach."""
        return self._walk(tokens, touch=False)

    # -- match ----------------------------------------------------------------
    def match(self, tokens: Sequence[int]) -> List[int]:
        """Page ids holding the longest cached prefix of `tokens`, whole
        pages only.  Bumps LRU timestamps along the path.  The caller must
        `attach` (or protect) the pages before anything else can evict.
        Use `peek` for a read-only lookup with none of these effects."""
        pages = self._walk(tokens, touch=True)
        self._m_lookups.inc()
        if pages:
            self._m_hits.inc()
            self._m_hit_pages.inc(len(pages))
            self._event("prefix_hit", pages=len(pages))
        return pages

    # -- publish ----------------------------------------------------------------
    def publish(self, tokens: Sequence[int], pages: Sequence[int]) -> List[int]:
        """Insert the prompt's full pages into the tree.

        `pages[j]` must hold the K/V of the prompt's j-th token block.  New
        blocks TRANSFER the caller's reference to the tree; blocks the tree
        already caches are returned as duplicates - the caller drops its
        reference on those (tree page and slot page may be the same id:
        unref then simply removes the slot's extra reference)."""
        n_before = len(self._pages)
        dups = self._insert(tokens, pages)
        n_new = len(self._pages) - n_before
        if n_new:
            self._m_pub.inc(n_new)
            self._event("prefix_publish", pages=n_new)
        self._m_cached_g.set(len(self._pages))
        return dups

    def _insert(self, tokens: Sequence[int],
                pages: Sequence[int]) -> List[int]:
        blocks = self._block_split(tokens)
        pages = list(pages[:len(blocks)])
        dups: List[int] = []
        node = self.root
        i = 0
        while i < len(blocks):
            child = node.children.get(blocks[i])
            if child is None:
                new = _Node(blocks[i:], pages[i:], node)
                node.children[blocks[i]] = new
                self._pages.update(pages[i:])
                self._touch(new)
                return dups
            m, lim = 0, min(len(child.blocks), len(blocks) - i)
            while m < lim and child.blocks[m] == blocks[i + m]:
                m += 1
            dups.extend(pages[i:i + m])
            self._touch(child)
            if m == len(child.blocks):
                node, i = child, i + m
                continue
            # diverged (or ran out of prompt) mid-edge: split child at m
            mid = _Node(child.blocks[:m], child.pages[:m], node)
            node.children[blocks[i]] = mid
            child.blocks = child.blocks[m:]
            child.pages = child.pages[m:]
            child.parent = mid
            mid.children[child.blocks[0]] = child
            mid.last_used = child.last_used
            if i + m < len(blocks):
                new = _Node(blocks[i + m:], pages[i + m:], mid)
                mid.children[blocks[i + m]] = new
                self._pages.update(pages[i + m:])
                self._touch(new)
            return dups
        return dups

    # -- release a finished request -----------------------------------------------
    def release(self, slot: int, prompt: Sequence[int]):
        """Publish a finished request's prompt pages instead of freeing
        them.  Pages past the prompt's last full page (the partial tail
        page and all generation pages) go back to the pool."""
        pages = self.alloc.detach(slot)
        n_pub = len(prompt) // self.page_size
        for p in self.publish(prompt, pages[:n_pub]):
            self.alloc.unref(p)             # tree already caches this block
        for p in pages[n_pub:]:
            self.alloc.unref(p)

    # -- eviction ---------------------------------------------------------------
    def evict(self, n_pages: int,
              protect: FrozenSet[int] = frozenset()) -> int:
        """Free up to n_pages cached pages, LRU leaves first, tail-first
        within a leaf.  Pages in `protect` or referenced by any slot
        (refcount > 1) are never touched.  Returns pages actually freed."""
        freed = 0
        while freed < n_pages:
            leaves = self._leaves()
            leaves.sort(key=lambda nd: nd.last_used)
            progressed = False
            for leaf in leaves:
                first_block = leaf.blocks[0]
                while leaf.pages and freed < n_pages:
                    pg = leaf.pages[-1]
                    if pg in protect or self.alloc.refcount(pg) > 1:
                        break
                    leaf.pages.pop()
                    leaf.blocks.pop()
                    self._pages.discard(pg)
                    self.alloc.unref(pg)
                    freed += 1
                    progressed = True
                if not leaf.pages and leaf.parent is not None:
                    del leaf.parent.children[first_block]
                if freed >= n_pages:
                    break
            if not progressed:
                break                       # everything left is pinned
        if freed:
            self._m_evict.inc(freed)
            self._event("prefix_evict", pages=freed)
        self._m_cached_g.set(len(self._pages))
        return freed

    def _leaves(self) -> List[_Node]:
        out, stack = [], [self.root]
        while stack:
            nd = stack.pop()
            kids = list(nd.children.values())
            if not kids and nd is not self.root:
                out.append(nd)
            stack.extend(kids)
        return out

    # -- invariants ---------------------------------------------------------------
    def check_invariants(self):
        """Tree bookkeeping must agree with the allocator: every cached
        page carries the tree's reference, and the _pages set mirrors the
        tree exactly.  Delegates the global no-page-both-free-and-
        referenced check to the allocator."""
        in_tree: Set[int] = set()
        stack = [self.root]
        while stack:
            nd = stack.pop()
            assert len(nd.blocks) == len(nd.pages)
            in_tree.update(nd.pages)
            stack.extend(nd.children.values())
        assert in_tree == self._pages, "tree / _pages set out of sync"
        for p in self._pages:
            assert p != 0, "null page cached"
            assert self.alloc.refcount(p) >= 1, f"cached page {p} unreferenced"
        self.alloc.check_invariants(tree_pages=self._pages)
