"""The prefix cache and the sequential chunk oracle of the port
(repro_torch.serve) against the JAX package.

Host side: the port's RadixPrefixCache is a copy of framework-free code,
so seeded publish / match / peek / release / evict sequences over the two
packages' allocators must give the same pages, trees and refcounts.

Engine: prefix-cached traffic - the shared_prefix trace with fewer slots
than requests, so later requests match pages earlier ones published;
prompts wholly cached, which copy their last page on write; a pool small
enough to evict - through the chunked engine (speculation on and off),
the monolithic one (_admit_prefix -> _run_chunk, K1 at K = 1) and the
sequential oracle (batched=False), every device-independent count equal
to the JAX engine's (tests/torch_replay.py).  The single-chunk step over
a cached prefix matches the JAX Model's prefill_suffix within 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformance import TRACES
from repro.configs.base import ServeConfig as JaxServeConfig
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve import paged_cache as jax_paged_cache
from repro.serve import prefix_cache as jax_prefix_cache
from repro_torch.configs import ServeConfig
from repro_torch.models import transformer as T
from repro_torch.models.layers import embed
from repro_torch.serve import (ServeEngine, paged_cache, prefix_cache,
                               serve_step)
from torch_replay import (assert_pages_conserved, assert_same_accounting,
                          assert_same_greedy, one_torch_thread, outputs,
                          replay_both, replay_trace_both, smoke_models,
                          trace_kw, waves)
from traffic import replay


_threads = pytest.fixture(scope="module", autouse=True)(one_torch_thread)


@pytest.fixture(scope="module")
def models():
    return smoke_models()


# ===========================================================================
# the radix tree against the JAX copy
# ===========================================================================

def _tree_ops(seed, n_ops=150):
    """Seeded ops over 4 slots and prompts drawn from 3 shared prefixes
    (page size 2), so matches, splits, duplicates and evictions occur."""
    rng = np.random.default_rng(seed)
    bases = [rng.integers(1, 5, 8).tolist() for _ in range(3)]
    ops = []
    for _ in range(n_ops):
        kind = str(rng.choice(["publish", "match", "peek", "evict",
                               "evict_protect", "release_partial"],
                              p=[.3, .25, .1, .15, .1, .1]))
        base = bases[int(rng.integers(0, 3))]
        cut = int(rng.integers(0, len(base) + 1))
        prompt = base[:cut] + rng.integers(1, 5, int(rng.integers(0, 5))
                                           ).tolist()
        ops.append((kind, int(rng.integers(0, 4)), prompt,
                    int(rng.integers(1, 6))))
    return ops


def _apply_tree(alloc, tree, op):
    """Apply one op; returns what it returned, or the exception type."""
    kind, slot, prompt, n = op
    try:
        if kind == "publish":
            # the slot computes its prompt: attach what the tree caches,
            # allocate the rest, publish on release
            got = tree.match(prompt)
            alloc.free_slot(slot)
            alloc.attach(slot, got)
            alloc.alloc(slot, -(-len(prompt) // 2) - len(got) + 1)
            tree.release(slot, prompt)
            return got
        if kind == "match":
            return tree.match(prompt)
        if kind == "peek":
            return tree.peek(prompt), tree.cached_prefix_len(prompt)
        if kind == "evict":
            return tree.evict(n)
        if kind == "evict_protect":
            protect = frozenset(tree.peek(prompt))
            return tree.evict(n, protect=protect)
        # a slot holding pages releases only a valid prefix of them
        pages = alloc.slot_pages(slot)
        if not pages:
            return None
        tree.release(slot, prompt[:2 * len(pages)])
        return len(pages)
    except (ValueError, RuntimeError) as e:
        return type(e).__name__


def _tree_state(tree):
    out, stack = [], [(tree.root, ())]
    while stack:
        nd, path = stack.pop()
        out.append((path, tuple(nd.blocks), tuple(nd.pages), nd.last_used))
        for key in sorted(nd.children):
            stack.append((nd.children[key], path + (key,)))
    return sorted(out)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_radix_prefix_cache_matches_jax(seed):
    a = paged_cache.PageAllocator(25, 2, 4, 32)
    b = jax_paged_cache.PageAllocator(25, 2, 4, 32)
    ta = prefix_cache.RadixPrefixCache(a, 2)
    tb = jax_prefix_cache.RadixPrefixCache(b, 2)
    for op in _tree_ops(seed):
        assert _apply_tree(a, ta, op) == _apply_tree(b, tb, op), op
        assert _tree_state(ta) == _tree_state(tb)
        assert ta._pages == tb._pages and a._free == b._free
        assert np.array_equal(a._refs, b._refs)
        assert np.array_equal(a.table, b.table)
        assert ta.evictable_pages() == tb.evictable_pages()
        ta.check_invariants()
    assert ta.metrics.snapshot() == tb.metrics.snapshot()


# ===========================================================================
# the single-chunk step over a cached prefix
# ===========================================================================

@pytest.mark.parametrize("offset", [16, 31])
def test_suffix_step_matches_jax_prefill_suffix(models, offset):
    """A prompt's first `offset` positions prefilled as one chunk, then
    the rest through the port's suffix step against the JAX Model's
    prefill_suffix: the final logits and the written pools within 1e-5.
    offset 31 starts the suffix at the last position of a page, as a
    wholly cached prompt's recomputed last token does."""
    jm, jp, tm, tp = models
    rng = np.random.default_rng(5)
    ps, n_pages, n = 16, 12, 56
    prompt = rng.integers(1, tm.cfg.vocab_size, n).astype(np.int32)
    row = np.zeros(8, np.int32)
    row[:4] = [7, 2, 9, 4]
    jcache = jm.init_cache(1, 128, page_size=ps, num_pages=n_pages)
    tcache = tm.init_cache(1, 128, page_size=ps, num_pages=n_pages)
    outs = {}
    for lib, step in (("jax", jm.prefill_suffix),
                      ("torch", serve_step.make_suffix_prefill_step(tm))):
        cache = jcache if lib == "jax" else tcache
        params = jp if lib == "jax" else tp
        arr = jnp.asarray if lib == "jax" else torch.from_numpy
        for start, end in ((0, offset), (offset, n)):
            s_pad = -(-(end - start) // ps) * ps
            toks = np.zeros((1, s_pad), np.int32)
            toks[0, :end - start] = prompt[start:end]
            batch = {"tokens": arr(toks),
                     "offset": arr(np.array([start], np.int32)),
                     "true_lens": arr(np.array([end], np.int32))}
            logits, cache, lens = step(params, batch, cache, arr(row))
        outs[lib] = (np.asarray(logits), cache, int(lens[0]))
    (jl, jc, jn), (tl, tc, tn) = outs["jax"], outs["torch"]
    assert jn == tn == n
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)
    for key in ("k_pages", "v_pages"):
        np.testing.assert_allclose(tc[key][:, 1:].numpy(),
                                   np.asarray(jc[key])[:, 1:], atol=1e-5,
                                   rtol=0)


def test_chunk_aliases_are_the_k1_batch(models):
    """The K = 1 entry points (chunk and suffix, model and stack level)
    are the batched path with one row."""
    _, _, tm, tp = models
    cfg = tm.cfg
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (1, 16))
                            .astype(np.int32))
    row = torch.tensor([3, 5, 0, 0], dtype=torch.int32)
    x = embed(tp["tok"], toks, cfg)
    got = {}
    for name, fn in (("suffix", T.stack_prefill_suffix_paged),
                     ("chunk", T.stack_prefill_chunk_paged)):
        cache = tm.init_cache(1, 64, page_size=16, num_pages=8)
        got[name] = fn(tp["blocks"], x, cfg, cache, row, 16)
    cache = tm.init_cache(1, 64, page_size=16, num_pages=8)
    off = torch.tensor([16], dtype=torch.int32)
    want = T.stack_prefill_chunks_paged(tp["blocks"], x, cfg, cache,
                                        row[None], off, off + 16)
    assert torch.equal(got["suffix"], want)
    assert torch.equal(got["chunk"], want)
    assert tm.prefill_suffix == tm.prefill_chunk


# ===========================================================================
# prefix-cached traffic through both engines
# ===========================================================================

@pytest.mark.parametrize("speculative", [False, True],
                         ids=["spec_off", "spec_on"])
def test_shared_prefix_hits_match_jax(models, speculative):
    """The shared_prefix trace on 2 slots: the third and fourth requests
    attach the 48-token prefix the first two published."""
    j_eng, t_eng, _ = replay_trace_both(models, "shared_prefix",
                                        speculative, max_batch=2)
    assert_same_accounting(j_eng, t_eng)
    assert_pages_conserved(t_eng)
    assert t_eng.prefix_hit_tokens > 0


def _base(vocab):
    rng = np.random.default_rng(8)
    return rng.integers(1, vocab, 32).tolist()      # exactly 2 pages


def _full_cover_waves(vocab):
    """A 2-page prompt, then twice more (wholly cached: the last token is
    recomputed into a private copy of the last page), then a prompt that
    extends it and one that diverges inside its second page."""
    base = _base(vocab)
    return waves([base], [base, base], [base + [5, 6, 7], base[:20] + [9]]
                 )(vocab)


@pytest.mark.parametrize("mode", ["chunked", "chunked_spec", "monolithic",
                                  "sequential"])
def test_full_cover_copies_on_write_like_jax(models, mode):
    kw = {"chunked": {}, "chunked_spec": {},
          "monolithic": dict(chunked=False),
          "sequential": dict(batched=False)}[mode]
    j_eng, t_eng, _ = replay_both(
        models, _full_cover_waves,
        trace_kw("shared_prefix", mode == "chunked_spec", max_batch=2,
                 **kw))
    assert_same_accounting(j_eng, t_eng)
    assert_pages_conserved(t_eng)
    assert t_eng.cow_copies >= 2
    assert t_eng.prefix_hit_tokens >= 2 * 31
    kinds = {r.kind for r in t_eng.launch_records()}
    if mode == "monolithic":
        assert kinds == {"chunk", "decode"}         # suffixes through K1
    if mode == "sequential":
        assert "chunk" in kinds and "chunk_batch" not in kinds


@pytest.mark.parametrize("mode", ["chunked", "monolithic"])
def test_prefix_on_equals_prefix_off(models, mode):
    """On the port alone: greedy outputs with the cache on equal those
    with it off, with fewer prompt tokens computed."""
    _, _, tm, tp = models
    kw = dict(max_batch=2, chunked=(mode == "chunked"))
    runs = {}
    for on in (False, True):
        eng = ServeEngine(tm, tp, ServeConfig(
            **trace_kw("shared_prefix", False, prefix_cache=on, **kw)))
        replay(eng, _full_cover_waves(tm.cfg.vocab_size), check=True)
        assert_pages_conserved(eng)
        runs[on] = eng
    assert_same_greedy(models, runs[True], outputs(runs[False]))
    assert runs[True].prefill_tokens < runs[False].prefill_tokens


def _churn_waves(vocab):
    """Four 32-token prefixes, each visited twice with distinct tails, then
    once more: more distinct prefixes than a small pool caches."""
    rng = np.random.default_rng(0)
    pres = [rng.integers(1, vocab, 32).tolist() for _ in range(4)]
    groups = [[p + [200 + i], p + [210 + i, 211]] for i, p in enumerate(pres)]
    groups += [[p + [220 + i]] for i, p in enumerate(pres)]
    return waves(*groups, period=12)(vocab)


@pytest.mark.parametrize("watermark", [0.0, 0.5])
@pytest.mark.parametrize("chunked", [True, False],
                         ids=["chunked", "monolithic"])
def test_eviction_churn_matches_jax(models, chunked, watermark):
    """usable_pages 10 with up to 2 requests of 3 pages in flight: cached
    prefixes evict LRU between waves (and down to the watermark's free
    share after each finishing tick)."""
    kw = trace_kw("shared_prefix", False, max_batch=2, max_seq=64,
                  max_new_tokens=8, num_pages=33, usable_pages=10,
                  chunked=chunked,
                  prefix_evict_watermark=watermark)
    j_eng, t_eng, _ = replay_both(models, _churn_waves, kw)
    assert_same_accounting(j_eng, t_eng)
    assert_pages_conserved(t_eng)
    snap = t_eng.tm.registry.snapshot()
    assert snap["prefix_evicted_pages_total"]["value"] > 0
    if watermark:
        assert t_eng.allocator.free_pages >= 5
    else:
        assert t_eng.prefix_hit_tokens > 0


# ===========================================================================
# the sequential chunk oracle (batched=False)
# ===========================================================================

@pytest.mark.parametrize("trace", sorted(TRACES))
def test_sequential_oracle_matches_jax(models, trace):
    """One launch per chunk, each final chunk fetching its first token at
    once: every count equal to the JAX engine's, outputs equal to the
    port's own batched run."""
    extra = dict(max_batch=2) if trace != "wave" else {}
    j_eng, t_eng, t_out = replay_trace_both(models, trace, False,
                                            batched=False, **extra)
    assert_same_accounting(j_eng, t_eng)
    assert_pages_conserved(t_eng)
    kinds = [r.kind for r in t_eng.launch_records()]
    assert "chunk_batch" not in kinds and "chunk" in kinds
    _, _, tm, tp = models
    batched = ServeEngine(tm, tp, ServeConfig(**trace_kw(trace, False,
                                                         **extra)))
    replay(batched, TRACES[trace].build(tm.cfg.vocab_size))
    assert_same_greedy(models, t_eng, outputs(batched))


def test_cow_guard_covers_the_verify_span(models):
    """A decoding slot whose pages at lens // 16 and (lens + 3) // 16 are
    shared (attached to a second slot by hand): the guard over a 3-token
    draft span copies both before any write, in both engines, and the
    port's copy holds the page's K/V."""
    jm, jp, tm, tp = models
    kw = trace_kw("shared_prefix", False, max_batch=2)
    tables = []
    for eng in (JaxServeEngine(jm, jp, JaxServeConfig(**kw)),
                ServeEngine(tm, tp, ServeConfig(**kw))):
        eng.submit(list(range(1, 41)), max_new_tokens=24)
        while int(eng._lens_np[0]) < 46:
            eng.tick()
        idx = [46 // 16, 49 // 16]
        shared = [int(eng.allocator.table[0, i]) for i in idx]
        eng.allocator.attach(1, shared)
        eng._cow_guard({0: 3})
        fresh = [int(eng.allocator.table[0, i]) for i in idx]
        assert eng.cow_copies == 2 and not set(fresh) & set(shared)
        if isinstance(eng, ServeEngine):
            for key in ("k_pages", "v_pages"):
                pool = eng.cache[key]
                assert torch.equal(pool[:, fresh], pool[:, shared])
        eng.allocator.free_slot(1)
        eng._sync_table()
        eng.run_until_done()
        eng.check_invariants()
        tables.append((shared, fresh, eng))
    (j_shared, j_fresh, j_eng), (t_shared, t_fresh, t_eng) = tables
    assert (j_shared, j_fresh) == (t_shared, t_fresh)
    assert_same_greedy(models, t_eng, outputs(j_eng))
