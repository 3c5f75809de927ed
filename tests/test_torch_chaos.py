"""Chaos against the port's fleet router: the fault scenarios of
tests/test_chaos.py (all but the tensor-parallel kill, ROADMAP M10)
through the JAX FleetRouter and the port's under the same FaultPlan.

Each scenario replays with the full invariant sweep every tick
(tests/torch_chaos.py replay_fleet_chaos: survivors' engines, the
placement / dispatch / redispatch ledger, work clocks, no uid terminal
twice) and ends with every fleet uid terminal and every survivor's pages
conserved.  Against the JAX router: placements, dispatch counts,
redispatches, watchdog trips, statuses, the registry snapshots and every
replica's counts equal (assert_same_fleet).  Against the port's own
fault-free run of the same trace: every request that finished DONE
emitted the same tokens - a replica's death shows in the telemetry and
the latency, never in the tokens.
"""
import pytest

from conformance import TRACES
from repro_torch.configs import ServeConfig
from repro_torch.serve import FleetConfig, FleetRouter, ReplicaState
from torch_chaos import (Fault, FaultPlan, assert_same_fleet, fleets_both,
                         random_fault_plan, replay_fleet_chaos)
from torch_replay import one_torch_thread, smoke_models, trace_kw
from traffic import TrafficItem

# as in tests/test_torch_router.py: one slot a replica makes the fleet's
# shared_prefix requests hit and priority_burst's burst preempt
PRESSURE = {"priority_burst": dict(max_batch=1),
            "shared_prefix": dict(max_batch=1)}


_threads = pytest.fixture(scope="module", autouse=True)(one_torch_thread)


@pytest.fixture(scope="module")
def models():
    return smoke_models()


def _kw(trace, **extra):
    return trace_kw(trace, False, **{"max_new_tokens": 12,
                                     **PRESSURE.get(trace, {}), **extra})


_BASELINES = {}


def _baseline(models, trace, n=2, **extra):
    """The port's fault-free run of the trace (cached per shape)."""
    key = (trace, n, tuple(sorted(extra.items())))
    if key not in _BASELINES:
        _, _, tm, tp = models
        r = FleetRouter(tm, tp, ServeConfig(**_kw(trace, **extra)),
                        FleetConfig(n_replicas=n))
        out, _ = replay_fleet_chaos(r, TRACES[trace].build(tm.cfg.vocab_size),
                                    FaultPlan([]))
        _BASELINES[key] = out
    return _BASELINES[key]


def _done_equal(t, base):
    """Every request the faulted port fleet finished DONE emitted what the
    fault-free run did.  Returns those fleet uids."""
    done = {f for f, s in t.statuses().items() if s == "done"}
    assert done <= base.keys()
    assert {f: o for f, o in t.outputs().items() if f in done} \
        == {f: base[f] for f in done}
    return done


def _chaos(models, trace, plan, n=2, fcfg=None, **extra):
    j, t, _, _ = fleets_both(models, TRACES[trace].build,
                             _kw(trace, **extra), n, plan, **(fcfg or {}))
    assert_same_fleet(j, t)
    return t, _done_equal(t, _baseline(models, trace, n, **extra))


@pytest.mark.parametrize("trace", sorted(TRACES))
def test_kill_replica_mid_trace_like_jax(models, trace):
    """Replica 1 dies at tick 2: its queued and in-flight requests move to
    replica 0 through the resume path, and every request ends DONE with
    the fault-free tokens."""
    t, done = _chaos(models, trace, FaultPlan([Fault(2, "kill", 1)]))
    assert set(t.statuses().values()) == {"done"}
    assert done == set(t.requests)
    s = t.fleet_stats()
    assert s["failures"] == 1 and s["redispatches"] >= 1
    assert s["replica_states"] == ["healthy", "dead"]


def test_kill_moves_queued_and_in_flight(models):
    """fail() moves everything the dead replica owed - queued, prefilling
    and decoding requests (2 slots a replica) - each keeping its fleet
    uid with one redispatch; a second fail is a no-op; the tokens are the
    fault-free ones."""
    _, _, tm, tp = models
    kw = _kw("mixed", max_batch=2)
    r = FleetRouter(tm, tp, ServeConfig(**kw), FleetConfig(n_replicas=2))
    for it in TRACES["mixed"].build(tm.cfg.vocab_size):
        r.submit(it.prompt)
    r.tick()
    r.tick()
    owed = sorted(f for f, i in r.placement.items()
                  if i == 1 and not r.requests[f].done)
    states = {r.requests[f].state.value for f in owed}
    assert "queued" in states and states & {"prefilling", "decoding"}
    assert r.fail(1) == owed
    assert all(r.placement[f] == 0 and r.requests[f].n_redispatches == 1
               for f in owed)
    assert r.fail(1) == []
    r.run_until_done()
    r.check_invariants()
    assert set(r.statuses().values()) == {"done"}
    assert r.outputs() == _baseline(models, "mixed", max_batch=2)


def test_no_healthy_replica_raises(models):
    _, _, tm, tp = models
    r = FleetRouter(tm, tp, ServeConfig(**_kw("mixed", max_new_tokens=4)),
                    FleetConfig(n_replicas=2))
    r.fail(0)
    r.drain(1)
    with pytest.raises(RuntimeError, match="no healthy replica"):
        r.submit([1, 2, 3])
    with pytest.raises(ValueError):
        r.drain(0)
    with pytest.raises(ValueError):
        r.undrain(0)


def test_drain_then_undrain_like_jax(models):
    """A drain at tick 1 empties replica 0 in place without changing a
    token; the drain duration lands in its histogram; undrain returns
    the replica to rotation."""
    t, _ = _chaos(models, "mixed", FaultPlan([Fault(1, "drain", 0)]))
    assert set(t.statuses().values()) == {"done"}
    s = t.fleet_stats()
    assert s["drains"] == 1
    assert s["replica_states"] == ["draining", "healthy"]
    assert t.metrics.get("fleet_drain_duration_ticks").count == 1
    t.undrain(0)
    assert t.states[0] is ReplicaState.HEALTHY
    uid = t.submit([7, 8, 9, 10])
    t.run_until_done()
    assert t.statuses()[uid] == "done"


def test_stuck_tick_trips_watchdog_like_jax(models):
    """Replica 1's tick replaced by a no-op at tick 2 (work frozen, work
    held): the watchdog declares it dead after 3 stale ticks and its
    requests finish on replica 0 with the fault-free tokens."""
    t, _ = _chaos(models, "mixed", FaultPlan([Fault(2, "stuck", 1)]),
                  fcfg=dict(watchdog_ticks=3))
    assert set(t.statuses().values()) == {"done"}
    assert int(t.metrics.get("fleet_watchdog_trips_total").value) == 1
    assert t.states[1] is ReplicaState.DEAD
    assert t.fleet_stats()["redispatches"] >= 1


def test_watchdog_ignores_idle_replicas(models):
    _, _, tm, tp = models
    r = FleetRouter(tm, tp, ServeConfig(**_kw("mixed", max_new_tokens=4)),
                    FleetConfig(n_replicas=2, watchdog_ticks=2))
    r.submit([1, 2, 3, 4])
    r.run_until_done()
    for _ in range(6):
        r.tick()
    assert r.states == [ReplicaState.HEALTHY, ReplicaState.HEALTHY]
    assert int(r.metrics.get("fleet_watchdog_trips_total").value) == 0


def test_pool_squeeze_under_preemption_like_jax(models):
    """10 of replica 0's free pages quarantined at tick 2, released at
    tick 8: preemption absorbs the squeeze, the allocator's invariants
    hold through it, the tokens are the fault-free ones."""
    plan = FaultPlan([Fault(2, "pool_squeeze", 0, pages=10),
                      Fault(8, "pool_restore", 0)])
    t, _ = _chaos(models, "mixed", plan, preemption=True, prefix_cache=True)
    assert set(t.statuses().values()) == {"done"}
    assert t.engines[0].allocator.quarantined_pages == 0


def test_deadline_expiry_is_terminal_like_jax(models):
    """A deadline that lands mid-prefill ends its request TIMEOUT, pages
    freed, while the other request completes."""
    items = lambda v: [TrafficItem(0, list(range(1, 129)), deadline=140),
                       TrafficItem(0, list(range(200, 232)))]
    j, t, _, _ = fleets_both(models, items, _kw("mixed"), 1)
    assert_same_fleet(j, t)
    assert t.statuses() == {1: "timeout", 2: "done"}
    assert t.requests[1].finish_reason == "timeout"
    assert t.fleet_stats()["timeouts"] == 1


def test_retry_budget_exhaustion_goes_failed_like_jax(models):
    """max_retries=0 requests on a killed replica go FAILED at once,
    appear once in the finished stream and are counted."""
    items = lambda v: [TrafficItem(0, list(range(1 + i, 33 + i)),
                                   max_retries=0) for i in range(3)]
    j, t, _, done = fleets_both(models, items,
                                _kw("mixed", max_new_tokens=8), 2,
                                FaultPlan([Fault(1, "kill", 0)]))
    assert_same_fleet(j, t)
    statuses = t.statuses()
    failed = {f for f, s in statuses.items() if s == "failed"}
    assert failed and set(statuses.values()) <= {"done", "failed"}
    assert int(t.metrics.get("fleet_retries_exhausted_total").value) \
        == len(failed)
    assert sorted(r.fleet_uid for r in done) == sorted(statuses)
    assert all(t.requests[f].finish_reason == "failed" for f in failed)


def test_retry_budget_counts_moves(models):
    """max_retries=1 survives one kill and goes FAILED on the second."""
    _, _, tm, tp = models
    r = FleetRouter(tm, tp, ServeConfig(**_kw("mixed", max_new_tokens=64)),
                    FleetConfig(n_replicas=3))
    uid = r.submit(list(range(1, 200)), max_retries=1)
    r.tick()
    r.fail(r.placement[uid])
    assert r.requests[uid].n_redispatches == 1
    assert r.statuses()[uid] != "failed"
    r.tick()
    r.fail(r.placement[uid])
    assert r.statuses()[uid] == "failed"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_chaos_soak_like_jax(models, seed):
    """Seeded random plans of kills, drains and pool squeezes over 3
    replicas (one always survives), the watchdog on: every request
    terminal, the invariants every tick, the DONE tokens the fault-free
    ones, and the same plan for the same seed."""
    plan = random_fault_plan(seed, n_replicas=3, max_tick=10)
    _chaos(models, "mixed", plan, n=3, fcfg=dict(watchdog_ticks=4))
    assert random_fault_plan(seed, n_replicas=3, max_tick=10).faults \
        == plan.faults
