"""Request deadlines in the port's engine (repro_torch.serve) against the
JAX package.

Six requests with work-clock deadlines (submit(deadline=...)) on 3 slots,
through both engines in every schedule the port serves - chunked
(batched, with the prefix cache, with speculation, and the sequential
oracle) and monolithic (paged and dense): the request_statuses() after
every tick, the state each expired request was in, sched_timeouts_total,
the work clock, the launch records, the span tracer's records (TIMEOUT
phases included) and the outputs must equal the JAX engine's.  The
chunked schedules expire one request while queued, one while
prefilling and one while decoding; check_invariants() holds after every
tick and every page is back in the pool (or the prefix tree) after the
drain.  ServeConfig.default_deadline_tokens and the submit-time checks
follow the JAX engine's too.
"""
import dataclasses

import pytest

from repro.configs.base import ServeConfig as JaxServeConfig
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.configs import ServeConfig
from repro_torch.serve import ServeEngine
from torch_replay import (assert_pages_conserved, assert_same_accounting,
                          assert_same_greedy, one_torch_thread, outputs,
                          smoke_models, trace_kw)
from traffic import TrafficItem, mixed_prompts, submit_item

LENS = (224, 130, 16, 9, 64, 40)
# the 224-token prompt expires mid-prefill (two other prompts share the
# chunk budget), the 16-token one mid-decode, the 9- and 40-token ones in
# the queue behind the three slots
DEADLINES = (230, None, 40, 20, None, 200)
MODES = {"chunked": {}, "prefix": dict(prefix_cache=True),
         "speculative": dict(speculative=True),
         "sequential": dict(batched=False),
         "monolithic": dict(chunked=False),
         "dense": dict(chunked=False, paged=False)}


_threads = pytest.fixture(scope="module", autouse=True)(one_torch_thread)


@pytest.fixture(scope="module")
def models():
    return smoke_models()


def _items(vocab):
    return [TrafficItem(0, p, deadline=d)
            for p, d in zip(mixed_prompts(vocab, lens=LENS), DEADLINES)]


def _drive(eng, items):
    """Submit everything, tick to the drain with check_invariants after
    every tick.  Returns (request_statuses() after every tick, the
    (uid, state) of each request as it expired)."""
    expired = []
    expire = eng._expire

    def noted(req):
        expired.append((req.uid, req.state.value))
        expire(req)
    eng._expire = noted
    for it in items:
        submit_item(eng, it)
    per_tick = []
    while eng.queue or any(s is not None for s in eng.slots):
        eng.tick()
        eng.check_invariants()
        per_tick.append(eng.request_statuses())
        assert len(per_tick) < 2000
    del eng._expire
    return per_tick, expired


def _kw(mode, **extra):
    extra = {**MODES[mode], **extra}
    return trace_kw("mixed", extra.pop("speculative", False), max_batch=3,
                    telemetry=True, **extra)


@pytest.fixture(scope="module")
def runs(models):
    """mode -> (JAX engine, port engine, JAX per-tick statuses and
    expiries, port's)."""
    jm, jp, tm, tp = models
    out = {}
    for mode in MODES:
        kw = _kw(mode)
        j_eng = JaxServeEngine(jm, jp, JaxServeConfig(**kw))
        t_eng = ServeEngine(tm, tp, ServeConfig(**kw))
        out[mode] = (j_eng, t_eng, _drive(j_eng, _items(jm.cfg.vocab_size)),
                     _drive(t_eng, _items(tm.cfg.vocab_size)))
    return out


@pytest.mark.parametrize("mode", sorted(MODES))
def test_deadlines_match_jax(models, runs, mode):
    j_eng, t_eng, j_run, t_run = runs[mode]
    assert t_run == j_run
    assert_same_accounting(j_eng, t_eng)
    assert_same_greedy(models, t_eng, outputs(j_eng))
    statuses = t_eng.request_statuses()
    assert set(statuses.values()) == {"done", "timeout"}
    assert statuses == j_eng.request_statuses()
    assert t_eng.sched.timeouts == j_eng.sched.timeouts \
        == sum(s == "timeout" for s in statuses.values())
    assert int(t_eng.tm.registry.get("sched_timeouts_total").value) \
        == t_eng.sched.timeouts
    assert t_eng.tm.tracer.deterministic_trace() \
        == j_eng.tm.tracer.deterministic_trace()
    assert t_eng.tm.open_phases() == j_eng.tm.open_phases()
    assert_pages_conserved(t_eng)
    for r in t_eng.sched.finished:
        assert (r.finish_reason == "timeout") == (r.state.value
                                                  == "timeout")
    expired_in = {state for _, state in t_run[1]}
    if MODES[mode].get("chunked", True):
        assert expired_in == {"queued", "prefilling", "decoding"}
    else:
        assert {"queued", "decoding"} <= expired_in


def test_done_requests_emit_what_they_emit_without_deadlines(models, runs):
    """A deadline takes requests out; the others' tokens do not move."""
    _, _, tm, tp = models
    t_eng = runs["chunked"][1]
    free = ServeEngine(tm, tp, ServeConfig(**_kw("chunked")))
    for it in _items(tm.cfg.vocab_size):
        submit_item(free, dataclasses.replace(it, deadline=None))
    free.run_until_done()
    want = outputs(free)
    done = {uid: out for uid, out in outputs(t_eng).items()
            if t_eng.request_statuses()[uid] == "done"}
    assert done and done == {uid: want[uid] for uid in done}
    timed_out = [r for r in t_eng.sched.finished if r.state.value
                 == "timeout"]
    assert all(r.out_tokens == want[r.uid][:len(r.out_tokens)]
               for r in timed_out)


@pytest.mark.parametrize("default", [150, 400])
def test_default_deadline_matches_jax(models, default):
    """ServeConfig.default_deadline_tokens applies to every submit that
    names no deadline of its own: at 150 work tokens some requests time
    out, at 400 none does."""
    jm, jp, tm, tp = models
    kw = _kw("chunked", default_deadline_tokens=default)
    engines = (JaxServeEngine(jm, jp, JaxServeConfig(**kw)),
               ServeEngine(tm, tp, ServeConfig(**kw)))
    got = []
    for eng in engines:
        items = [TrafficItem(0, p) for p in
                 mixed_prompts(eng.model.cfg.vocab_size, lens=LENS[1:])]
        got.append(_drive(eng, items))
        assert all(r.deadline_tokens == default for r in eng.sched.finished)
    assert got[0] == got[1]
    assert_same_accounting(*engines)
    assert (engines[1].sched.timeouts > 0) == (default == 150)


def test_submit_checks_match_jax(models):
    """A deadline <= 0 or not above the prompt's length, and a negative
    max_retries, raise ValueError in both engines; the request is not
    queued."""
    jm, jp, tm, tp = models
    kw = _kw("chunked")
    for eng in (JaxServeEngine(jm, jp, JaxServeConfig(**kw)),
                ServeEngine(tm, tp, ServeConfig(**kw))):
        for bad in (dict(deadline=0), dict(deadline=-1), dict(deadline=3),
                    dict(deadline=2), dict(max_retries=-2)):
            with pytest.raises(ValueError):
                eng.submit([5, 6, 7], **bad)
        assert not eng.queue
        uid = eng.submit([5, 6, 7], deadline=4, max_retries=0)
        req = eng.queue[-1]
        assert (uid, req.deadline_tokens, req.max_retries) == (1, 4, 0)
        assert eng.request_statuses() == {1: "queued"}
