"""The span tracer and the data-movement model of the port
(repro_torch.serve.telemetry) against the JAX package.

Each of the four conformance traces (tests/conformance.py TRACES), with
the pressure that makes priority_burst preempt (2 slots) and
shared_prefix hit (2 slots, ROADMAP section 3), replays through the JAX
engine and the port's with ServeConfig(telemetry=True): the tracer's
deterministic_trace(), the work-clock Chrome export, movement_stats()
(within 1e-9 relative) and the registry's names and help strings must
equal the JAX engine's, beside every count of tests/torch_replay.py.  On
the port alone, telemetry on and off give the same outputs, launch
records, launch_log rows without their wall time and host fetches; the
wall-clock export writes JSON that parses back; and the tracer, the
facade and movement_breakdown behave as the JAX module's do.
"""
import dataclasses
import json

import numpy as np
import pytest

from conformance import TRACES
from repro.serve.telemetry import LaunchRecord as JaxLaunchRecord
from repro.serve.telemetry import movement_breakdown as jax_movement
from repro_torch.configs import ServeConfig
from repro_torch.serve import ServeEngine
from repro_torch.serve.telemetry import (TRACK_ENGINE, TRACK_QUEUE,
                                         LaunchRecord, SpanTracer, Telemetry,
                                         export_chrome_trace,
                                         movement_breakdown)
from torch_replay import (assert_same_accounting, one_torch_thread, outputs,
                          replay_trace_both, smoke_models, trace_kw)
from traffic import replay

# the pressure that makes a trace exercise what it is registered for
PRESSURE = {"priority_burst": dict(max_batch=2),
            "shared_prefix": dict(max_batch=2)}


_threads = pytest.fixture(scope="module", autouse=True)(one_torch_thread)


@pytest.fixture(scope="module")
def models():
    return smoke_models()


def _rel_close(got, want, rtol=1e-9):
    """Two movement_breakdown dicts equal key for key, numbers within
    rtol relative."""
    assert got.keys() == want.keys()
    for kind in want:
        assert got[kind].keys() == want[kind].keys(), kind
        for k, w in want[kind].items():
            g = got[kind][k]
            assert abs(g - w) <= rtol * max(abs(w), 1e-300), (kind, k, g, w)


@pytest.fixture(scope="module")
def traced(models):
    """trace -> (JAX engine, port engine), both with the tracer on."""
    out = {}
    for trace in sorted(TRACES):
        j_eng, t_eng, _ = replay_trace_both(
            models, trace, False, telemetry=True,
            **PRESSURE.get(trace, {}))
        out[trace] = (j_eng, t_eng)
    return out


@pytest.mark.parametrize("trace", sorted(TRACES))
def test_trace_matches_jax(traced, trace):
    j_eng, t_eng = traced[trace]
    assert_same_accounting(j_eng, t_eng)
    got = t_eng.tm.tracer.deterministic_trace()
    assert got and got == j_eng.tm.tracer.deterministic_trace()
    assert t_eng.tm.tracer.dropped == j_eng.tm.tracer.dropped == 0
    assert t_eng.tm.open_phases() == j_eng.tm.open_phases()
    assert t_eng.export_trace(None, clock="work") \
        == j_eng.export_trace(None, clock="work")
    _rel_close(t_eng.movement_stats(), j_eng.movement_stats())
    assert t_eng.tm.registry.catalog() == j_eng.tm.registry.catalog()
    snap = lambda e: {k: v["value"] for k, v in
                      e.metrics_snapshot().items()}
    assert snap(t_eng) == snap(j_eng)
    assert t_eng.prometheus_metrics() == j_eng.prometheus_metrics()


def test_traces_exercise_their_features(traced):
    """The added pressure does what it is for: PREEMPT / RESUME instants
    on priority_burst, prefix-cache instants on shared_prefix."""
    names = lambda t: {r.name.split(":")[-1]
                       for r in traced[t][1].tm.tracer.events()}
    assert {"PREEMPT", "RESUME", "DONE"} <= names("priority_burst")
    assert {"prefix_hit", "prefix_publish"} <= names("shared_prefix")
    resuming = [s for s in traced["priority_burst"][1].tm.tracer.spans()
                if dict(s.args).get("phase") == "RESUMING"]
    assert resuming and all(s.track == TRACK_QUEUE for s in resuming)


def test_speculative_trace_matches_jax(models):
    """SPEC_VERIFY instants carry each chain's drafted and accepted
    counts, equal to the JAX engine's."""
    j_eng, t_eng, _ = replay_trace_both(models, "mixed", True,
                                        telemetry=True)
    assert_same_accounting(j_eng, t_eng)
    assert t_eng.tm.tracer.deterministic_trace() \
        == j_eng.tm.tracer.deterministic_trace()
    spec = [e for e in t_eng.tm.tracer.events()
            if e.name.endswith(":SPEC_VERIFY")]
    assert spec
    assert sum(dict(e.args)["drafted"] for e in spec) \
        == t_eng.stats()["spec_drafted"] > 0
    _rel_close(t_eng.movement_stats(), j_eng.movement_stats())


@pytest.mark.parametrize("trace", sorted(TRACES))
def test_telemetry_on_equals_off(models, traced, trace):
    """The tracer only observes: the same outputs, launch records,
    launch_log rows without wall time, launches and host fetches."""
    _, _, tm, tp = models
    on = traced[trace][1]
    off = ServeEngine(tm, tp, ServeConfig(**trace_kw(
        trace, False, **PRESSURE.get(trace, {}))))
    replay(off, TRACES[trace].build(tm.cfg.vocab_size), check=True)
    assert outputs(on) == outputs(off)
    assert [dataclasses.astuple(r) for r in on.launch_records()] \
        == [dataclasses.astuple(r) for r in off.launch_records()]
    strip = lambda e: [(r[0], r[1], r[3], r[4]) for r in e.launch_log]
    assert strip(on) == strip(off)
    assert (on.jit_calls, on.host_syncs) == (off.jit_calls, off.host_syncs)
    assert off.tm.tracer is None and not off.stats()["telemetry"]
    assert on.stats()["telemetry"] is True
    with pytest.raises(ValueError, match="telemetry=True"):
        off.export_trace(None)


def test_monolithic_and_dense_traces_match_jax(models):
    """The monolithic admissions' PREFILLING / DECODING phases and their
    prefill / decode launch spans, paged and dense."""
    for extra in (dict(chunked=False), dict(chunked=False, paged=False)):
        j_eng, t_eng, _ = replay_trace_both(models, "wave", False,
                                            telemetry=True, **extra)
        assert t_eng.tm.tracer.deterministic_trace() \
            == j_eng.tm.tracer.deterministic_trace()
        assert t_eng.export_trace(None, clock="work") \
            == j_eng.export_trace(None, clock="work")
        _rel_close(t_eng.movement_stats(), j_eng.movement_stats())


def test_wall_export_parses_back(traced, tmp_path):
    """Both clocks write JSON that parses back to the returned dict; the
    wall clock's stamps are non-negative and a span never ends before it
    starts."""
    eng = traced["mixed"][1]
    for clock in ("wall", "work"):
        path = tmp_path / f"trace_{clock}.json"
        trace = eng.export_trace(str(path), clock=clock)
        assert json.loads(path.read_text()) == trace
        assert trace["otherData"] == {"clock": clock, "dropped_records": 0}
        timed = [e for e in trace["traceEvents"] if e["ph"] != "M"]
        assert timed and all(e["ts"] >= 0 for e in timed)
        assert all(e["dur"] >= 0 for e in timed if e["ph"] == "X")
    with pytest.raises(ValueError, match="clock"):
        eng.export_trace(None, clock="sundial")
    kinds = {s.name for s in eng.tm.tracer.spans() if s.cat == "tick"}
    assert kinds == {"plan", "device_get", "tick"}
    launches = [s for s in eng.tm.tracer.spans() if s.cat == "launch"]
    assert [s.name for s in launches] \
        == [r.kind for r in eng.launch_records()]
    assert all(s.track == TRACK_ENGINE and s.wall1 >= s.wall0
               for s in launches)


def test_tracer_ring_and_facade():
    """A bounded ring that drops (and counts) the oldest records; the
    facade is a no-op without a tracer and pairs phases into spans with
    one."""
    tr = SpanTracer(capacity=4)
    for i in range(10):
        tr.add_event(f"e{i}", "request", 0, i, i, float(i))
    assert len(tr) == 4 and tr.dropped == 6
    assert [e.name for e in tr.events()] == ["e6", "e7", "e8", "e9"]
    with pytest.raises(ValueError):
        SpanTracer(capacity=0)
    off = Telemetry()
    assert not off.enabled
    off.request_phase(1, "QUEUED", TRACK_QUEUE, 0, 0)
    off.request_event(1, "PREEMPT", 0, 0, 0)
    assert off.open_phases() == {}
    on = Telemetry(tracer=SpanTracer())
    on.request_phase(7, "QUEUED", TRACK_QUEUE, 0, 0, prompt_tokens=3)
    on.request_phase(7, "DECODING", 2, 1, 5)
    assert on.open_phases() == {7: "DECODING"}
    on.request_phase(7, "DONE", 2, 3, 9, reason="length")
    assert on.open_phases() == {}
    assert on.tracer.deterministic_trace() == [
        ("span", "r7:QUEUED", "request", TRACK_QUEUE, 0, 0, 5, (
            ("phase", "QUEUED"), ("uid", 7))),
        ("span", "r7:DECODING", "request", 2, 1, 5, 9, (
            ("phase", "DECODING"), ("uid", 7))),
        ("event", "r7:DONE", "request", 2, 3, 9, (
            ("reason", "length"), ("uid", 7)))]
    trace = export_chrome_trace(None, on.tracer, 3, clock="work")
    assert [e["ts"] for e in trace["traceEvents"] if e["ph"] != "M"] \
        == [0.0, 5.0, 9.0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_movement_breakdown_matches_jax(models, dtype):
    """The byte model and the paper's 16 nm energy on synthetic launch
    records of every kind, against the JAX function (float32 and bf16
    item sizes; tp_degree 2's per-device section is host arithmetic)."""
    from repro.configs.base import ServeConfig as JaxServeConfig
    jm, _, tm, _ = models
    jcfg, tcfg = jm.cfg.replace(dtype=dtype), tm.cfg.replace(dtype=dtype)
    rng = np.random.default_rng(3)
    recs = []
    for i, kind in enumerate(("prefill", "prefill_paged", "chunk",
                              "chunk_batch", "decode", "spec_verify",
                              "stepwise", "decode")):
        rows = int(rng.integers(1, 9))
        live = int(rng.integers(1, rows + 1))
        true = int(rng.integers(live, 200))
        recs.append(dict(tick=i, kind=kind, rows=rows, live_rows=live,
                         true_tokens=true,
                         padded_tokens=true + int(rng.integers(0, 64)),
                         kv_pages_read=int(rng.integers(0, 40)),
                         kv_pages_written=int(rng.integers(0, 9)),
                         new_kv_tokens=true, work_clock=10 * i))
    kw = dict(page_size=16, max_seq=512)
    for tp in (1, 2):
        got = movement_breakdown([LaunchRecord(**r) for r in recs], tcfg,
                                 ServeConfig(**kw), tp_degree=tp)
        want = jax_movement([JaxLaunchRecord(**r) for r in recs], jcfg,
                            JaxServeConfig(**kw), tp_degree=tp)
        _rel_close(got, want)
    it = 4 if dtype == "float32" else 2
    kv_tok = 2 * tcfg.n_layers * tcfg.n_kv_heads * tcfg.head_dim * it
    d = got["decode"]
    assert d["kv_read_bytes"] == sum(r["kv_pages_read"] for r in recs
                                     if r["kind"] == "decode") * 16 * kv_tok
    assert d["weight_bytes"] == 2 * tcfg.active_param_count() * it
    assert d["sram_bytes"] == 2 * d["hbm_bytes"]
    assert movement_breakdown([], tcfg, ServeConfig(**kw))["total"][
        "launches"] == 0
