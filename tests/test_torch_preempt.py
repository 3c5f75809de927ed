"""Preemption in the port (repro_torch.serve) against the JAX package.

The priority_burst conformance trace under slot pressure (2 slots) and
page pressure (18 usable pages), with speculation and the prefix cache
on and off, and seeded random arrival traffic on a tiny pool, through
the JAX engine and the port's: greedy outputs, launch records, work
clock, preemptions, resumes, pages reclaimed and parked, and every other
device-independent count equal (tests/torch_replay.py).  On the port
alone, a preempted run emits what the same requests emit uninterrupted,
and the victim policy picks what the JAX engine's picks.
"""
import copy

import numpy as np
import pytest

from repro.configs.base import ServeConfig as JaxServeConfig
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve.scheduler import Request as JaxRequest
from repro.serve.scheduler import RequestState as JaxRequestState
from repro_torch.configs import ServeConfig
from repro_torch.serve import Request, RequestState, ServeEngine
from torch_replay import (assert_pages_conserved, assert_same_accounting,
                          assert_same_greedy, one_torch_thread, outputs,
                          replay_both, replay_trace_both, smoke_models,
                          trace_kw)
from traffic import TrafficItem, priority_burst, random_arrivals, replay

PRESSURE = {"slots": dict(max_batch=2), "pages": dict(usable_pages=18)}


_threads = pytest.fixture(scope="module", autouse=True)(one_torch_thread)


@pytest.fixture(scope="module")
def models():
    return smoke_models()


@pytest.mark.parametrize("prefix", [False, True],
                         ids=["no_prefix", "prefix"])
@pytest.mark.parametrize("speculative", [False, True],
                         ids=["spec_off", "spec_on"])
@pytest.mark.parametrize("pressure", sorted(PRESSURE))
def test_priority_burst_preempts_like_jax(models, pressure, speculative,
                                          prefix):
    """The high-priority burst sheds a low-priority request that resumes
    and finishes."""
    j_eng, t_eng, _ = replay_trace_both(
        models, "priority_burst", speculative, prefix_cache=prefix,
        **PRESSURE[pressure])
    assert_same_accounting(j_eng, t_eng)
    assert_pages_conserved(t_eng)
    st = t_eng.stats()
    assert st["preemptions"] >= 1 and st["resumes"] == st["preemptions"]
    assert st["pages_reclaimed"] >= 1 and st["requests"] == 3
    assert all(r.n_resumes == r.n_preemptions for r in t_eng.sched.finished)


@pytest.mark.parametrize("speculative", [False, True],
                         ids=["spec_off", "spec_on"])
def test_decoding_victim_parks_its_pages_like_jax(models, speculative):
    """The burst at tick 10, when both background requests decode: the
    victim's pages up to its lens mirror (never draft K/V past it) park
    in the prefix tree, and its resume re-attaches them."""
    items = lambda v: priority_burst(v, (96, 96), (64,), 10,
                                     burst_priority=5, seed=1)
    j_eng, t_eng, _ = replay_both(models, items, trace_kw(
        "priority_burst", speculative, prefix_cache=True, usable_pages=18))
    assert_same_accounting(j_eng, t_eng)
    assert_pages_conserved(t_eng)
    st = t_eng.stats()
    assert st["preemptions"] >= 1 and st["pages_parked"] >= 1
    assert st["prefix_hit_tokens"] > 0


def _soak_kw(seed, prefix):
    return dict(max_batch=3, max_seq=256, max_new_tokens=4, paged=True,
                page_size=8, num_pages=200, usable_pages=17, chunked=True,
                prefill_chunk=16, tick_token_budget=24, preemption=True,
                max_chunks_per_tick=1, prefix_cache=prefix)


@pytest.mark.parametrize("prefix", [False, True],
                         ids=["no_prefix", "prefix"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_traffic_on_a_tiny_pool_matches_jax(models, seed, prefix):
    """Random arrivals, lengths, priorities and shared prefixes against
    17 usable pages: preemption, resume, eviction and backpressure
    interleave, and both engines make the same decisions tick for tick."""
    items = random_arrivals(models[0].cfg.vocab_size, 10, seed)
    j_eng, t_eng, _ = replay_both(models, lambda v: copy.deepcopy(items),
                                  _soak_kw(seed, prefix))
    assert_same_accounting(j_eng, t_eng)
    assert_pages_conserved(t_eng)
    assert t_eng.stats()["requests"] == len(items)


def test_random_traffic_does_preempt(models):
    """The tiny pool really preempts across the seeds above (otherwise
    the soak proves nothing)."""
    _, _, tm, tp = models
    total = 0
    for seed in (0, 1, 2):
        eng = ServeEngine(tm, tp, ServeConfig(**_soak_kw(seed, False)))
        replay(eng, random_arrivals(tm.cfg.vocab_size, 10, seed))
        total += eng.stats()["preemptions"]
    assert total >= 1


@pytest.mark.parametrize("batched", [True, False],
                         ids=["batched", "sequential"])
@pytest.mark.parametrize("prefix", [False, True],
                         ids=["no_prefix", "prefix"])
def test_preempted_equals_uninterrupted(models, prefix, batched):
    """On the port alone: the burst under page pressure (a victim shed
    and resumed) emits what the same requests emit with the whole pool
    usable (no preemption)."""
    _, _, tm, tp = models
    runs = {}
    for usable in (0, 18):
        eng = ServeEngine(tm, tp, ServeConfig(**trace_kw(
            "priority_burst", False, usable_pages=usable,
            prefix_cache=prefix, batched=batched)))
        replay(eng, priority_burst(tm.cfg.vocab_size, (96, 96), (64,), 3,
                                   burst_priority=5, seed=1), check=True)
        assert_pages_conserved(eng)
        runs[usable] = eng
    assert runs[0].stats()["preemptions"] == 0
    assert runs[18].stats()["preemptions"] >= 1
    assert_same_greedy(models, runs[18], outputs(runs[0]))


def test_equal_priority_never_preempts(models):
    """Pressure among equal priorities backpressures; nothing is shed."""
    _, _, tm, tp = models
    eng = ServeEngine(tm, tp, ServeConfig(**trace_kw(
        "priority_burst", False, usable_pages=18)))
    replay(eng, priority_burst(tm.cfg.vocab_size, (96, 96), (64,), 3,
                               burst_priority=0, seed=1), check=True)
    st = eng.stats()
    assert st["preemptions"] == 0 and st["requests"] == 3


def _population(rng, mod, state_enum):
    """Three slots of seeded requests: priorities 0-2, PREFILLING or
    DECODING, admission stamps and remaining budgets."""
    reqs = []
    for uid in range(1, 4):
        r = mod(uid, [1] * 20, int(rng.integers(2, 30)),
                priority=int(rng.integers(0, 3)))
        r.state = state_enum.PREFILLING if rng.random() < 0.5 \
            else state_enum.DECODING
        r.out_tokens = [1] * int(rng.integers(0, r.max_new_tokens))
        r.admit_seq = int(rng.integers(0, 100))
        reqs.append(r)
    return reqs


@pytest.mark.parametrize("seed", range(6))
def test_victim_choice_matches_jax(models, seed):
    """_next_victim on the same slot population (and candidate priority)
    picks the same request in both engines."""
    jm, jp, tm, tp = models
    kw = trace_kw("priority_burst", False)
    t_eng = ServeEngine(tm, tp, ServeConfig(**kw))
    j_eng = JaxServeEngine(jm, jp, JaxServeConfig(**kw))
    for cand_prio in (0, 1, 2, 3):
        picks = []
        for eng, mod, st in ((t_eng, Request, RequestState),
                             (j_eng, JaxRequest, JaxRequestState)):
            eng.slots = _population(np.random.default_rng(seed), mod, st)
            cand = mod(99, [1], 4, priority=cand_prio)
            v = eng._next_victim(cand)
            picks.append(None if v is None else v.uid)
        assert picks[0] == picks[1], (cand_prio, picks)


def test_decoding_victim_parks_only_written_positions(models):
    """One slot; a 40-token prompt decodes until a priority-5 request
    arrives at tick 9, when its lens mirror is 47: the pending token's
    position 47 ends a page but holds no K/V yet, so only 47 // 16 = 2
    pages park in the tree - as in the JAX engine."""
    prompt = list(range(1, 41))
    items = lambda v: [TrafficItem(0, prompt), TrafficItem(
        9, list(range(50, 70)), priority=5)]
    j_eng, t_eng, _ = replay_both(models, items, trace_kw(
        "priority_burst", False, prefix_cache=True, max_batch=1))
    assert_same_accounting(j_eng, t_eng)
    st = t_eng.stats()
    assert st["preemptions"] == 1 and st["pages_parked"] == 2
