"""Shared harness of the port's fleet tests: the chaos harness of
tests/chaos.py for either package's FleetRouter, and one replay of a
trace (under a FaultPlan) through the JAX FleetRouter and the port's
with every device-independent count compared.

The fault vocabulary and the seeded plans are tests/chaos.py's (Fault,
FaultPlan, apply_fault, random_fault_plan): they drive a router through
its public surface only, so they serve both packages.  What is copied
here is the replay loop and its checks, which read replica and request
states by value, so the same loop drives the JAX router and the port's.

Routing, the replica lifecycle, the watchdog and redispatch are
deterministic host logic, so placements, dispatch counts, spills,
affinity hits, redispatches, watchdog trips, statuses, the fleet
registry snapshot and every replica's engine counts must be exactly
equal (tests/torch_replay.py assert_same_accounting, replica by replica).
Greedy outputs must be bit-equal or pass the teacher-forced near-tie
check against the JAX model.
"""
from typing import Callable, Dict, List, Sequence, Tuple

from chaos import (Fault, FaultPlan, apply_fault,  # noqa: F401
                   random_fault_plan)
from repro.configs.base import ServeConfig as JaxServeConfig
from repro.serve import FleetConfig as JaxFleetConfig
from repro.serve import FleetRouter as JaxFleetRouter
from repro_torch.configs import ServeConfig
from repro_torch.serve import FleetConfig, FleetRouter
from torch_replay import assert_same_accounting
from traffic import (TrafficItem, assert_fleet_pages_drained,
                     assert_greedy_equivalent)

TERMINAL = {"done", "timeout", "failed"}


def replay_fleet_chaos(router, items: Sequence[TrafficItem],
                       plan: FaultPlan, max_ticks: int = 50_000
                       ) -> Tuple[Dict[int, List[int]], list]:
    """tests/chaos.py replay_fleet_chaos for either package's router:
    the trace's items submitted at their ticks, `plan`'s faults applied
    before the tick they name, and after every tick the router's
    invariants (survivors' engines and the placement / dispatch ledger),
    no fleet uid terminal twice and no live replica's work clock going
    back.  After the drain every fleet uid is terminal and every
    survivor's pool holds only its prefix tree's pages.  Returns ({fleet
    uid: out_tokens}, terminal requests in completion order)."""
    pending_q = sorted(items, key=lambda it: it.tick)
    saved_ticks: Dict[int, Callable] = {}
    done: list = []
    seen_terminal: set = set()
    last_work = [0] * len(router.engines)
    tick = 0
    while pending_q or not router.idle or tick <= plan.max_tick():
        for fault in plan.at_tick(tick):
            apply_fault(router, fault, saved_ticks)
        while pending_q and pending_q[0].tick <= tick:
            item = pending_q.pop(0)
            item.uid = router.submit(item.prompt,
                                     max_new_tokens=item.max_new,
                                     stop_tokens=item.stop_tokens,
                                     priority=item.priority,
                                     deadline=item.deadline,
                                     max_retries=item.max_retries)
        finished = router.tick()
        done.extend(finished)
        router.check_invariants()
        for fuid in (r.fleet_uid for r in finished):
            assert fuid not in seen_terminal, \
                f"fleet uid {fuid} went terminal twice"
            seen_terminal.add(fuid)
        for i, eng in enumerate(router.engines):
            if router.states[i].value == "dead":
                continue
            assert eng.sched.work_clock >= last_work[i], \
                f"replica {i} work clock went backward"
            last_work[i] = eng.sched.work_clock
        tick += 1
        if tick >= max_ticks:
            raise RuntimeError(
                f"replay_fleet_chaos: {max_ticks} ticks exhausted; "
                f"statuses: {router.statuses()}")
    lost = {f: s for f, s in router.statuses().items()
            if s not in TERMINAL}
    assert not lost, f"requests lost (never terminal): {lost}"
    assert_fleet_pages_drained(router)
    return {r.fleet_uid: list(r.out_tokens) for r in done}, done


def fleets_both(models, items_fn, scfg_kw: dict, n: int,
                plan: FaultPlan = None, **fcfg_kw):
    """Replay the items `items_fn(vocab)` builds (fresh for each router)
    under `plan` through a JAX and a port FleetRouter of `n` replicas,
    ServeConfig(**scfg_kw), FleetConfig(n_replicas=n, **fcfg_kw).
    Returns (JAX router, port router, port outputs, port terminal
    requests)."""
    jm, jp, tm, tp = models
    plan = plan or FaultPlan([])
    j = JaxFleetRouter(jm, jp, JaxServeConfig(**scfg_kw),
                       JaxFleetConfig(n_replicas=n, **fcfg_kw))
    j_out, _ = replay_fleet_chaos(j, items_fn(jm.cfg.vocab_size), plan)
    t = FleetRouter(tm, tp, ServeConfig(**scfg_kw),
                    FleetConfig(n_replicas=n, **fcfg_kw))
    t_out, t_done = replay_fleet_chaos(t, items_fn(tm.cfg.vocab_size), plan)
    if t_out != j_out:
        assert_greedy_equivalent(jm, jp, t_done, j_out)
    return j, t, t_out, t_done


def assert_same_fleet(j, t):
    """Every device-independent count of the two fleets' runs equal:
    routing, lifecycle, statuses, the registries, and each replica's
    engine accounting."""
    assert t.placement == j.placement
    assert t.dispatch_counts() == j.dispatch_counts()
    assert t.statuses() == j.statuses()
    assert [s.value for s in t.states] == [s.value for s in j.states]
    js, ts = j.fleet_stats(), t.fleet_stats()
    assert set(ts) == set(js)
    for key in set(ts) - {"per_replica"}:
        assert ts[key] == js[key], key
    assert t.fleet_snapshot() == j.fleet_snapshot()
    for j_eng, t_eng in zip(j.engines, t.engines):
        assert_same_accounting(j_eng, t_eng)
        assert t_eng.request_statuses() == j_eng.request_statuses()
    for fuid, r in t.requests.items():
        jr = j.requests[fuid]
        assert (r.n_redispatches, r.finish_reason, r.state.value) \
            == (jr.n_redispatches, jr.finish_reason, jr.state.value)
