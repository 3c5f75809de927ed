"""The port's fleet router (repro_torch.serve.router) against the JAX
package's, and its own 1-replica-vs-N differential.

Every conformance trace (tests/conformance.py TRACES) replays through a
JAX FleetRouter and the port's at 2 replicas, on the same float32
weights: placements, dispatch counts, spills, affinity hits, statuses,
the fleet registry snapshot and every replica's engine counts must be
equal (tests/torch_chaos.py).  The port's own 1-replica and 2-replica
fleets must give equal outputs - exactly: a request's attention rows are
computed in blocks of their own, and the CPU's projections gave the
same bits at every batch size here.  Then the router's policy surface
beside the JAX router's: affinity follows cached prefixes (through the
side-effect-free peek), round-robin ignores them, the spill cap, the
slo_weight term, deterministic tie-breaking, drain under load, the
merged Perfetto trace, run_until_done(on_exhaust=) and FleetConfig's
checks.  The replicas share the one parameter tree.
"""
import json

import pytest

from conformance import TRACES
from repro.configs.base import ServeConfig as JaxServeConfig
from repro.serve import FleetConfig as JaxFleetConfig
from repro.serve import FleetRouter as JaxFleetRouter
from repro_torch.configs import ServeConfig
from repro_torch.serve import (FleetConfig, FleetRouter, ReplicaState,
                               ServeEngine)
from repro_torch.serve.scheduler import Request
from torch_chaos import assert_same_fleet, fleets_both
from torch_replay import one_torch_thread, smoke_models, trace_kw
from traffic import (TrafficItem, mixed_prompts, replay, replay_fleet,
                     shared_prefix_prompts)

# the pressure that makes a trace exercise what it is registered for
# (ROADMAP section 3) in a fleet, where its requests spread over the
# replicas: one slot a replica, so shared_prefix's requests meet a
# published prefix and priority_burst's burst finds its slot taken
PRESSURE = {"priority_burst": dict(max_batch=1),
            "shared_prefix": dict(max_batch=1)}

AFFINITY = dict(max_batch=4, max_seq=512, page_size=16, prefill_chunk=32,
                tick_token_budget=64, max_new_tokens=8, paged=True,
                chunked=True, batched=True, prefix_cache=True)


_threads = pytest.fixture(scope="module", autouse=True)(one_torch_thread)


@pytest.fixture(scope="module")
def models():
    return smoke_models()


def _trace_kw(trace, **extra):
    return trace_kw(trace, False, **{"max_new_tokens": 12,
                                     **PRESSURE.get(trace, {}), **extra})


def _items(trace):
    return TRACES[trace].build


def _pair(models, n, scfg_kw, **fcfg_kw):
    jm, jp, tm, tp = models
    return (JaxFleetRouter(jm, jp, JaxServeConfig(**scfg_kw),
                           JaxFleetConfig(n_replicas=n, **fcfg_kw)),
            FleetRouter(tm, tp, ServeConfig(**scfg_kw),
                        FleetConfig(n_replicas=n, **fcfg_kw)))


@pytest.fixture(scope="module")
def fleets(models):
    """trace -> (JAX 2-replica fleet, port 2-replica fleet, port outputs,
    port 1-replica fleet, its outputs)."""
    _, _, tm, tp = models
    out = {}
    for trace in sorted(TRACES):
        kw = _trace_kw(trace)
        j2, t2, out2, _ = fleets_both(models, _items(trace), kw, 2)
        t1 = FleetRouter(tm, tp, ServeConfig(**kw), FleetConfig(n_replicas=1))
        out1, _ = replay_fleet(t1, _items(trace)(tm.cfg.vocab_size))
        out[trace] = (j2, t2, out2, t1, out1)
    return out


@pytest.mark.parametrize("trace", sorted(TRACES))
def test_fleet_matches_jax(fleets, trace):
    j2, t2, _, _, _ = fleets[trace]
    assert_same_fleet(j2, t2)
    assert sum(t2.dispatch_counts()) == len(t2.requests)
    assert set(t2.statuses().values()) == {"done"}


@pytest.mark.parametrize("trace", sorted(TRACES))
def test_one_vs_two_replicas_equal(fleets, trace):
    """The same trace through 1 and 2 replicas: equal outputs, equal
    generated tokens, and equal work where neither the prefix cache nor
    preemption can move work between the topologies."""
    _, t2, out2, t1, out1 = fleets[trace]
    assert out1 == out2
    s1, s2 = t1.fleet_stats(), t2.fleet_stats()
    assert s1["requests"] == s2["requests"] == len(out1)
    assert s1["gen_tokens"] == s2["gen_tokens"]
    spec = TRACES[trace].scfg_kw
    if not spec.get("prefix_cache") and not spec.get("preemption"):
        assert s1["work_tokens"] == s2["work_tokens"]


def test_traces_exercise_their_features(fleets):
    assert fleets["shared_prefix"][1].fleet_stats()["prefix_hit_tokens"] > 0
    assert fleets["priority_burst"][1].fleet_stats()["preemptions"] >= 1


def test_replicas_share_the_parameters(models, fleets):
    """No replica copies the weights: every engine holds the router's
    model and parameter tree, and its own cache."""
    _, _, tm, tp = models
    t2 = fleets["mixed"][1]
    assert all(e.model is tm and e.params is tp for e in t2.engines)
    k0, k1 = (e.cache["k_pages"] for e in t2.engines)
    assert k0.data_ptr() != k1.data_ptr()


def test_one_replica_fleet_is_the_engine(models, fleets):
    """A 1-replica fleet adds no behavior: the bare engine's outputs,
    work clock and prefill totals."""
    _, _, tm, tp = models
    eng = ServeEngine(tm, tp, ServeConfig(**_trace_kw("mixed")))
    out_e, _ = replay(eng, _items("mixed")(tm.cfg.vocab_size))
    t1, out1 = fleets["mixed"][3], fleets["mixed"][4]
    assert out_e == out1
    se, sf = eng.stats(), t1.fleet_stats()
    for k in ("work_tokens", "gen_tokens", "prefill_tokens", "requests"):
        assert se[k] == sf[k], k


def _affinity(r):
    """One request warms a replica; the followers sharing its 128-token
    prefix land there under affinity.  Returns (home, followers'
    replicas)."""
    prompts = shared_prefix_prompts(r.engines[0].model.cfg.vocab_size, 128,
                                    (16, 24, 32))
    warm = r.submit(prompts[0])
    r.run_until_done()
    uids = [r.submit(p) for p in prompts[1:]]
    r.run_until_done()
    return r.placement[warm], [r.placement[u] for u in uids]


def _round_robin(r):
    uids = [r.submit(p) for p in mixed_prompts(
        r.engines[0].model.cfg.vocab_size, lens=(8, 8, 8, 8))]
    r.run_until_done()
    return [r.placement[u] for u in uids]


def _spill(r):
    """spill_queue_depth 1: the second follower bound for the warm
    replica spills; with both at the cap the best one absorbs the
    third."""
    prompts = shared_prefix_prompts(r.engines[0].model.cfg.vocab_size, 128,
                                    (16, 24, 32))
    warm = r.submit(prompts[0])
    r.run_until_done()
    home = r.placement[warm]
    uids = [r.submit(prompts[1]), r.submit(prompts[2]),
            r.submit(prompts[1][:32])]
    place = [r.placement[u] for u in uids]
    r.run_until_done()
    return home, place


@pytest.mark.parametrize("policy", ["affinity", "round_robin", "spill"])
def test_routing_policy_like_jax(models, policy):
    """Affinity sends followers to the replica caching their prefix (and
    they hit there, not on the cold one); round-robin alternates whatever
    is cached; the spill cap diverts one follower - in both packages
    alike."""
    fcfg = {"affinity": {}, "round_robin": dict(policy="round_robin"),
            "spill": dict(spill_queue_depth=1)}[policy]
    routers = _pair(models, 2, AFFINITY, **fcfg)
    for r in routers:
        if policy == "affinity":
            home, place = _affinity(r)
            assert place == [home, home]
            st = r.fleet_stats()
            assert (st["affinity_hits"], st["affinity_hit_tokens"]) \
                == (2, 256)
            assert r.engines[home].prefix_hit_tokens >= 256
            assert r.engines[1 - home].prefix_hit_tokens == 0
        elif policy == "round_robin":
            assert _round_robin(r) == [0, 1, 0, 1]
            assert r.dispatch_counts() == [2, 2]
        else:
            home, place = _spill(r)
            assert place == [home, 1 - home, home]
            assert r.metrics.get("fleet_spills_total").value == 1
        r.check_invariants()
    assert_same_fleet(*routers)


def test_slo_weight_sheds_load_like_jax(models):
    """A replica with a slow delivered p95 TTFT loses an otherwise tied
    dispatch once slo_weight > 0, and keeps it (lowest index) at 0."""
    kw = dict(AFFINITY, prefix_cache=False)
    prompt = list(range(1, 40))
    for slo, slow, want in ((0.0, (0,), 0), (1.0, (0,), 1),
                            (1.0, (0, 1), 0)):
        for r in _pair(models, 2, kw, slo_weight=slo):
            for i in slow:
                req = Request(uid=900, prompt=[1, 2], max_new_tokens=1)
                req.w_submit, req.token_work, req.done = 0, [500], True
                r.engines[i].sched.finished.append(req)
            assert r.placement[r.submit(prompt)] == want


def test_three_replica_wave_replays_deterministically(models):
    """Ties break to the lowest index on every input: two port replays of
    the wave trace over 3 replicas place and emit alike, and as the JAX
    router does."""
    kw = _trace_kw("wave", max_new_tokens=8)
    j, t, out, _ = fleets_both(models, _items("wave"), kw, 3)
    assert_same_fleet(j, t)
    _, _, tm, tp = models
    again = FleetRouter(tm, tp, ServeConfig(**kw), FleetConfig(n_replicas=3))
    out2, _ = replay_fleet(again, _items("wave")(tm.cfg.vocab_size))
    assert again.placement == t.placement and out2 == out


def test_drain_under_load_like_jax(models):
    """Replica 0, holding prefilling and decoding requests, drains: it
    takes no new work, empties in place, returns its pages, and the
    fleet's tokens are those of the JAX fleet (and of the trace without
    a drain)."""
    kw = _trace_kw("mixed")
    routers = _pair(models, 2, kw)
    for r in routers:
        prompts = [it.prompt for it in
                   _items("mixed")(r.engines[0].model.cfg.vocab_size)]
        for p in prompts:
            r.submit(p)
        r.tick()
        r.tick()
        states = {s.state.value for s in r.engines[0].slots if s}
        assert states & {"prefilling", "decoding"}
        r.drain(0)
        assert r.states[0].value == "draining"
        extra = [r.submit(list(range(50 + i, 90 + i))) for i in range(3)]
        assert all(r.placement[f] == 1 for f in extra)
        r.run_until_done()
        r.check_invariants()
        eng0 = r.engines[0]
        assert not eng0.queue and eng0.allocator.used_pages == (
            eng0.prefix.cached_pages if eng0.prefix else 0)
    assert_same_fleet(*routers)
    assert routers[1].states[0] is ReplicaState.DRAINING
    assert routers[1].outputs() == routers[0].outputs()


def test_merged_trace_and_snapshot_like_jax(models, tmp_path):
    """export_trace merges the replicas' Perfetto traces, one track group
    each; on the work clock it equals the JAX router's, and both clocks
    write JSON that parses back.  fleet_snapshot sums the replicas'
    registries."""
    kw = dict(AFFINITY, telemetry=True)
    routers = _pair(models, 2, kw)
    for r in routers:
        for p in mixed_prompts(r.engines[0].model.cfg.vocab_size,
                               lens=(16, 24, 16, 24)):
            r.submit(p)
        r.run_until_done()
    j, t = routers
    assert t.export_trace(None, clock="work") \
        == j.export_trace(None, clock="work")
    for clock in ("wall", "work"):
        path = tmp_path / f"fleet_{clock}.json"
        trace = t.export_trace(str(path), clock=clock)
        assert json.loads(path.read_text()) == trace
    names = {ev["args"]["name"] for ev in trace["traceEvents"]
             if ev.get("ph") == "M" and ev.get("name") == "process_name"}
    assert names == {"replica0:engine", "replica0:requests",
                     "replica1:engine", "replica1:requests"}
    assert {0, 2} <= {ev["pid"] for ev in trace["traceEvents"]
                      if ev.get("ph") != "M"}
    snap = t.fleet_snapshot()
    assert snap == j.fleet_snapshot()
    assert snap["sum"]["serve_gen_tokens_total"] \
        == sum(e.gen_tokens for e in t.engines) \
        == t.fleet_stats()["gen_tokens"]
    assert sum(snap["router"]["fleet_dispatch_total"]["value"].values()) \
        == 4


def test_run_until_done_exhaust_reports_statuses(models):
    kw = _trace_kw("mixed", max_new_tokens=24)
    _, _, tm, tp = models
    r = FleetRouter(tm, tp, ServeConfig(**kw), FleetConfig(n_replicas=2))
    uids = [r.submit(list(range(1, 120))) for _ in range(3)]
    with pytest.warns(UserWarning) as rec:
        r.run_until_done(max_ticks=1, on_exhaust="return")
    msg = str(rec[0].message)
    assert "statuses" in msg and "still running fleet uids" in msg
    assert all(r.statuses()[u] != "done" for u in uids)
    with pytest.raises(RuntimeError):
        r.run_until_done(max_ticks=1)
    r.run_until_done()
    assert set(r.statuses().values()) == {"done"}


def test_load_stats_and_fleet_config(models):
    """The router's load probe reads host state only (no fetch) and
    publishes the work total; FleetConfig refuses what the JAX one
    refuses."""
    _, _, tm, tp = models
    eng = ServeEngine(tm, tp, ServeConfig(**AFFINITY))
    ls = eng.load_stats()
    assert ls == {"queue_depth": 0, "inflight": 0, "free_slots": 4,
                  "outstanding_work_tokens": 0,
                  "free_pages": ls["free_pages"], "evictable_pages": 0}
    eng.submit([1, 2, 3, 4], max_new_tokens=6)
    assert eng.load_stats()["outstanding_work_tokens"] == 10
    assert eng.tm.registry.get("serve_outstanding_work_tokens").value == 10
    assert eng.host_syncs == 0
    for bad, match in ((dict(n_replicas=0), "n_replicas"),
                       (dict(policy="sticky-random"), "policy"),
                       (dict(spill_queue_depth=-1), "spill_queue_depth"),
                       (dict(load_weight=-0.5), "weights"),
                       (dict(slo_weight=-0.1), "weights"),
                       (dict(watchdog_ticks=-1), "watchdog_ticks")):
        with pytest.raises(ValueError, match=match):
            FleetConfig(**bad).validate()
    assert [m for m in ReplicaState] == [ReplicaState.HEALTHY,
                                         ReplicaState.DRAINING,
                                         ReplicaState.DEAD]
    with pytest.raises(ValueError, match="world size of at least 2"):
        FleetRouter(tm, tp, ServeConfig(**dict(AFFINITY, tp_degree=2)))
