"""The port's serving stack (repro_torch.serve) against the JAX package's.

Host modules: the port's PageAllocator, TokenBudgetScheduler and n-gram
drafter are copies of framework-free code, so on the same seeded operation
sequences they must behave identically - same tables, free lists, packs.

Engine replay: the `mixed` and `wave` conformance traces (tests/
conformance.py) go through the JAX ServeEngine and the port's ServeEngine
on the granite-3-2b smoke config in float32 with the same weights, through
tests/traffic.py's replay (check_invariants after every tick), for every
configuration the port serves: paged + chunked + batched, and monolithic
prefill on the paged and on the dense cache.  Greedy outputs must be
equivalent (bit-equal, or within traffic's teacher-forced near-tie
tolerance of the JAX model), and the device-independent accounting exactly
equal: launch records, launch_log rows without the wall time, work clock,
generated tokens, host syncs, KV pages read, and every stats() value that
is not a wall time.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformance import BASE_SCFG, TRACES
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import ServeConfig as JaxServeConfig
from repro.models import build_model as jax_build_model
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve import drafting as jax_drafting
from repro.serve import sampling as jax_sampling
from repro.serve import paged_cache as jax_paged_cache
from repro.serve import scheduler as jax_scheduler
from repro_torch.configs import ServeConfig, get_smoke_config
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import (ServeEngine, drafting, paged_cache, sampling,
                               scheduler)
from repro_torch.serve.serve_step import _set_rows
from traffic import assert_greedy_equivalent, replay

# the conformance engine shape without speculation
SCFG = {k: v for k, v in BASE_SCFG.items()
        if k not in ("spec_k", "spec_ngram")}


# ===========================================================================
# host modules
# ===========================================================================

def _allocator_ops(seed: int, n_ops: int = 200):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n_ops):
        kind = rng.choice(["alloc", "free", "attach", "cow", "quarantine",
                           "release"], p=[.4, .25, .1, .1, .1, .05])
        ops.append((str(kind), int(rng.integers(0, 4)),
                    int(rng.integers(1, 6))))
    return ops


def _apply(alloc, op):
    """Apply one op; returns what it returned, or the exception type."""
    kind, slot, n = op
    try:
        if kind == "alloc":
            return alloc.alloc(slot, n)
        if kind == "free":
            return alloc.free_slot(slot)
        if kind == "attach":
            other = alloc.slot_pages((slot + 1) % 4)[:n]
            return alloc.attach(slot, other)
        if kind == "cow":
            pages = alloc.slot_pages(slot)
            return alloc.cow(slot, n % len(pages)) if pages else None
        if kind == "quarantine":
            return alloc.quarantine(n)
        return alloc.release_quarantine()
    except (ValueError, RuntimeError) as e:
        return type(e).__name__


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_page_allocator_matches_jax(seed):
    a = paged_cache.PageAllocator(41, 4, 4, 64)
    b = jax_paged_cache.PageAllocator(41, 4, 4, 64)
    for op in _allocator_ops(seed):
        assert _apply(a, op) == _apply(b, op), op
        assert np.array_equal(a.table, b.table)
        assert a._free == b._free
        assert np.array_equal(a._refs, b._refs)
        a.check_invariants()


def test_kv_byte_math_matches_jax():
    for arch in ("granite-3-2b", "gemma3-4b"):
        t, j = get_smoke_config(arch), jax_smoke_config(arch)
        ts, js = ServeConfig(**SCFG), JaxServeConfig(**SCFG)
        assert paged_cache.paged_kv_bytes(t, ts) \
            == jax_paged_cache.paged_kv_bytes(j, js)
        assert paged_cache.dense_kv_bytes(t, ts) \
            == jax_paged_cache.dense_kv_bytes(j, js)
        assert paged_cache.page_kv_bytes(t, 16) \
            == jax_paged_cache.page_kv_bytes(j, 16)


def _requests(mod, seed):
    rng = np.random.default_rng(seed)
    reqs = []
    for uid in range(1, 7):
        n = int(rng.integers(1, 300))
        r = mod.Request(uid, rng.integers(1, 99, n).tolist(), 8,
                        priority=int(rng.integers(0, 2)))
        r.prefill_pos = int(rng.integers(0, n)) // 16 * 16
        reqs.append(r)
    return reqs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chunk_planning_and_packing_match_jax(seed):
    kw = dict(SCFG, max_batch=6, max_chunks_per_tick=seed)
    got = scheduler.TokenBudgetScheduler(ServeConfig(**kw))
    want = jax_scheduler.TokenBudgetScheduler(JaxServeConfig(**kw))
    t_reqs, j_reqs = _requests(scheduler, seed), _requests(jax_scheduler,
                                                           seed)
    for budget in (16, 48, 64, 200):
        t_tasks = got.plan_chunks(list(enumerate(t_reqs)), budget)
        j_tasks = want.plan_chunks(list(enumerate(j_reqs)), budget)
        assert [(t.req.uid, t.slot, t.start, t.length) for t in t_tasks] \
            == [(t.req.uid, t.slot, t.start, t.length) for t in j_tasks]
        if not t_tasks:
            continue
        tp, jp = got.pack_chunks(t_tasks), want.pack_chunks(j_tasks)
        for f in ("tokens", "offsets", "true_lens", "final_slots",
                  "row_slots"):
            assert np.array_equal(getattr(tp, f), getattr(jp, f)), f
    assert got.prefill_budget(3) == want.prefill_budget(3)


def test_ngram_drafter_matches_jax():
    rng = np.random.default_rng(7)
    for _ in range(200):
        h = rng.integers(0, 4, int(rng.integers(0, 24))).tolist()
        k, n = int(rng.integers(0, 6)), int(rng.integers(1, 4))
        assert drafting.ngram_draft(h, k, n) \
            == jax_drafting.ngram_draft(h, k, n)


@pytest.mark.parametrize("bad", [
    dict(chunked=True, paged=False), dict(prefill_chunk=40),
    dict(tick_token_budget=8), dict(top_p=0.0), dict(temperature=-1.0),
    dict(admission_policy="lifo"), dict(usable_pages=10_000)])
def test_serve_config_validation_matches_jax(bad):
    kw = dict(SCFG, **bad)
    with pytest.raises(ValueError) as want:
        JaxServeConfig(**kw).validate()
    with pytest.raises(ValueError) as got:
        ServeConfig(**kw).validate()
    assert str(got.value) == str(want.value)


# ===========================================================================
# engine replay against the JAX engine
# ===========================================================================

@pytest.fixture(scope="module")
def models():
    """The JAX model and the port's, float32, the same weights."""
    jcfg = jax_smoke_config("granite-3-2b").replace(dtype="float32")
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = get_smoke_config("granite-3-2b").replace(dtype="float32")
    tm = build_model(tcfg, device="cpu")
    return jm, jp, tm, params_from_numpy(jax.device_get(jp), tcfg, "cpu")


# every ServeConfig the port serves, as overrides of SCFG
SERVED = {"chunked": {}, "monolithic_paged": dict(chunked=False),
          "monolithic_dense": dict(chunked=False, paged=False)}
# stats() keys whose values are wall-clock times, and the JAX engine's
# count of jit-compiled step variants (the eager port compiles none)
WALL_KEYS = {"ttft_wall_p50", "ttft_wall_p95", "tbt_wall_p50", "tbt_wall_p95",
             "tick_host_wall_p50", "tick_host_wall_p95"}
JAX_ONLY_KEYS = {"compile_count"}


def _replay_both(models, trace, served):
    jm, jp, tm, tp = models
    spec, kw = TRACES[trace], dict(SCFG, **SERVED[served])
    j_eng = JaxServeEngine(jm, jp, JaxServeConfig(**kw))
    j_out, _ = replay(j_eng, spec.build(jm.cfg.vocab_size), check=True)
    t_eng = ServeEngine(tm, tp, ServeConfig(**kw))
    t_out, t_done = replay(t_eng, spec.build(tm.cfg.vocab_size), check=True)
    if t_out != j_out:
        assert_greedy_equivalent(jm, jp, t_done, j_out)
    return j_eng, t_eng


@pytest.mark.parametrize("served", list(SERVED))
@pytest.mark.parametrize("trace", ["mixed", "wave"])
def test_engine_replay_matches_jax(models, trace, served):
    j_eng, t_eng = _replay_both(models, trace, served)
    assert [dataclasses.astuple(r) for r in t_eng.launch_records()] \
        == [dataclasses.astuple(r) for r in j_eng.launch_records()]
    strip = lambda rows: [(r[0], r[1], r[3], r[4]) for r in rows]
    assert strip(t_eng.launch_log) == strip(j_eng.launch_log)
    assert t_eng.sched.work_clock == j_eng.sched.work_clock
    assert t_eng.gen_tokens == j_eng.gen_tokens
    assert t_eng.host_syncs == j_eng.host_syncs
    assert t_eng.kv_pages_read == j_eng.kv_pages_read
    assert t_eng.load_stats() == j_eng.load_stats()
    if t_eng.paged:
        assert t_eng.allocator.used_pages == 0
    if served == "chunked":
        # every busy tick: one chunk-batch launch + one decode + one fetch
        for calls, syncs, _, n_chunks, n_dec in t_eng.launch_log:
            assert calls == bool(n_chunks) + bool(n_dec)
            assert syncs == (1 if calls else 0)
    else:
        # one prefill launch and one first-token fetch per admission, one
        # decode launch and one fetch per tick with a live lane
        kinds = [r.kind for r in t_eng.launch_records()]
        n_admit = kinds.count("prefill_paged" if t_eng.paged else "prefill")
        assert n_admit == t_eng.stats()["requests"]
        assert t_eng.host_syncs == n_admit + kinds.count("decode")


@pytest.mark.parametrize("served", list(SERVED))
def test_stats_match_jax(models, served):
    """stats() has the JAX engine's keys (but the jit compile count), and
    equal values for every key that is not a wall time - `chunked` and
    `batched` follow the config."""
    j_eng, t_eng = _replay_both(models, "mixed", served)
    got, want = t_eng.stats(), j_eng.stats()
    assert set(got) == set(want) - JAX_ONLY_KEYS
    for key in set(got) - WALL_KEYS:
        assert got[key] == want[key], key
    assert got["chunked"] == (served == "chunked")


@pytest.mark.parametrize("served", ["monolithic_paged", "monolithic_dense"])
def test_finish_at_admission_matches_jax(models, served):
    """A request whose first token is its last (max_new_tokens 1) or hits
    a stop token finishes at admission; the paged engine re-uploads the
    block table before that tick's decode, so the freed pages stay
    untouched, and the rest of the traffic decodes as in the JAX engine."""
    jm, jp, tm, tp = models
    kw = dict(SCFG, **SERVED[served])
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, tm.cfg.vocab_size, n).tolist()
               for n in (40, 9, 70, 17)]
    outs = []
    for eng in (JaxServeEngine(jm, jp, JaxServeConfig(**kw)),
                ServeEngine(tm, tp, ServeConfig(**kw))):
        eng.submit(prompts[0])
        eng.submit(prompts[1], max_new_tokens=1)
        eng.submit(prompts[2], max_new_tokens=5)
        eng.tick()
        eng.check_invariants()
        eng.submit(prompts[3], max_new_tokens=1)
        eng.run_until_done()
        eng.check_invariants()
        outs.append((eng, {r.uid: r.out_tokens for r in eng.sched.finished}))
    (j_eng, j_out), (t_eng, t_out) = outs
    assert {u: len(o) for u, o in t_out.items()} == {1: 24, 2: 1, 3: 5,
                                                      4: 1}
    if t_out != j_out:
        assert_greedy_equivalent(jm, jp, t_eng.sched.finished, j_out)
    assert [dataclasses.astuple(r) for r in t_eng.launch_records()] \
        == [dataclasses.astuple(r) for r in j_eng.launch_records()]
    assert t_eng.host_syncs == j_eng.host_syncs
    assert t_eng.sched.work_clock == j_eng.sched.work_clock


@pytest.mark.parametrize("knob", [
    dict(prefix_cache=True), dict(preemption=True), dict(speculative=True),
    dict(default_deadline_tokens=500), dict(telemetry=True),
    dict(tp_degree=2), dict(batched=False)])
def test_unported_settings_raise(models, knob):
    _, _, tm, tp = models
    with pytest.raises(NotImplementedError, match="ROADMAP M"):
        ServeEngine(tm, tp, ServeConfig(**dict(SCFG, **knob)))


def test_submit_validates_like_jax(models):
    _, _, tm, tp = models
    eng = ServeEngine(tm, tp, ServeConfig(**SCFG))
    with pytest.raises(ValueError):
        eng.submit([])
    with pytest.raises(ValueError):
        eng.submit([1] * 500, max_new_tokens=24)
    with pytest.raises(NotImplementedError, match="M6"):
        eng.submit([1, 2], deadline=100)
    uid = eng.submit([1, 2, 3], stop_tokens=[7])
    assert uid == 1 and eng.load_stats()["queue_depth"] == 1


# ===========================================================================
# sampling stack
# ===========================================================================

def _logits(seed):
    """(4, 64) logits with deliberate ties at the top and inside the k-th
    place, as numpy float32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    x[0, 5] = x[0, 9] = x[0].max() + 1.0          # tied maxima
    x[1, :8] = 0.5                                # ties across the k-th
    return x


@pytest.mark.parametrize("k", [0, 1, 8, 63])
def test_top_k_mask_matches_jax(k):
    x = _logits(k)
    got = sampling.apply_top_k(torch.from_numpy(x), k).numpy()
    want = np.asarray(jax_sampling.apply_top_k(jnp.asarray(x), k))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("p", [0.05, 0.5, 0.9, 1.0])
def test_top_p_mask_matches_jax(p):
    x = _logits(3)
    got = sampling.apply_top_p(torch.from_numpy(x), p).numpy()
    want = np.asarray(jax_sampling.apply_top_p(jnp.asarray(x), p))
    assert np.array_equal(got, want)


def test_greedy_sample_matches_jax_argmax_on_ties():
    x = _logits(0)
    got = sampling.sample(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_sampling.sample(jnp.asarray(x)))
    assert got.dtype == np.int32 and np.array_equal(got, want)
    assert got[0] == 5                            # first of the tied maxima


def test_temperature_sampling_stays_in_the_filtered_support():
    x = torch.from_numpy(_logits(1))
    gen = torch.Generator().manual_seed(0)
    support = sampling.apply_top_p(sampling.apply_top_k(x / 0.7, 5), 0.8) \
        > sampling.NEG_INF / 2
    draws = torch.stack([sampling.sample(x, gen, temperature=0.7, top_k=5,
                                         top_p=0.8) for _ in range(200)])
    assert bool(support.gather(1, draws.long().t()).all())
    again = torch.Generator().manual_seed(0)
    assert torch.equal(draws[0], sampling.sample(x, again, temperature=0.7,
                                                 top_k=5, top_p=0.8))
    with pytest.raises(ValueError):
        sampling.sample(x, None, temperature=0.7)


def test_final_slot_scatter_drops_the_sentinel():
    dst = torch.arange(4, dtype=torch.int32)
    out = _set_rows(dst, torch.tensor([2, 4, 0, 4], dtype=torch.int32),
                    torch.tensor([20, 99, 10, 98], dtype=torch.int32))
    assert out.tolist() == [10, 1, 20, 3] and dst.tolist() == [0, 1, 2, 3]
