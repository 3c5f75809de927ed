"""Shared harness of the port's serving tests: the granite-3-2b smoke
models of both packages on the same float32 weights, and one replay of a
trace through the JAX ServeEngine and the port's ServeEngine with every
device-independent count compared.

The scheduler, allocator, prefix tree and drafter are deterministic host
logic, so launch records, the launch_log without its wall time, the work
clock, KV pages read, drafted and accepted tokens, prefix hits,
copy-on-write copies, the preemption counters and every stats() value
that is not a wall time must be exactly equal.  Greedy outputs must be
bit-equal or pass tests/traffic.py's teacher-forced near-tie check
against the JAX model (tol 2e-3): the port's logits differ from XLA's in
the last bits.
"""
import dataclasses
from typing import Dict, List

import jax
import numpy as np
import torch

from conformance import BASE_SCFG, TRACES
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import ServeConfig as JaxServeConfig
from repro.models import build_model as jax_build_model
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.configs import ServeConfig, get_smoke_config
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import ServeEngine
from traffic import TrafficItem, assert_greedy_equivalent, replay

# stats() keys whose values are wall-clock times, and the JAX engine's
# count of jit-compiled step variants (the eager port compiles none)
WALL_KEYS = {"ttft_wall_p50", "ttft_wall_p95", "tbt_wall_p50", "tbt_wall_p95",
             "tick_host_wall_p50", "tick_host_wall_p95"}
JAX_ONLY_KEYS = {"compile_count"}


def one_torch_thread():
    """Generator for a module-scoped autouse fixture: torch on one
    intra-op thread while the module runs.  The smoke-sized ops gain
    nothing from more, and with several test workers on one machine the
    threads of each worker's pool spin against the others' and slow every
    engine replay many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def smoke_models():
    """(JAX model, JAX params, port model, port params): granite-3-2b smoke
    config, float32, the JAX Model.init weights in both."""
    jcfg = jax_smoke_config("granite-3-2b").replace(dtype="float32")
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = get_smoke_config("granite-3-2b").replace(dtype="float32")
    tm = build_model(tcfg, device="cpu")
    return jm, jp, tm, params_from_numpy(jax.device_get(jp), tcfg, "cpu")


def trace_kw(trace: str, speculative: bool, **extra) -> dict:
    """The conformance engine shape of `trace` (tests/conformance.py
    make_scfg), with `extra` overriding any field."""
    return {**BASE_SCFG, **TRACES[trace].scfg_kw,
            "speculative": speculative, **extra}


def replay_both(models, items_fn, kw: dict):
    """Replay the items `items_fn(vocab)` builds (fresh for each engine)
    through both engines under ServeConfig(**kw), check_invariants after
    every tick.  Returns (JAX engine, port engine, port outputs)."""
    jm, jp, tm, tp = models
    j_eng = JaxServeEngine(jm, jp, JaxServeConfig(**kw))
    j_out, _ = replay(j_eng, items_fn(jm.cfg.vocab_size), check=True)
    t_eng = ServeEngine(tm, tp, ServeConfig(**kw))
    t_out, t_done = replay(t_eng, items_fn(tm.cfg.vocab_size), check=True)
    if t_out != j_out:
        assert_greedy_equivalent(jm, jp, t_done, j_out)
    return j_eng, t_eng, t_out


def replay_trace_both(models, trace: str, speculative: bool, **extra):
    return replay_both(models, TRACES[trace].build,
                       trace_kw(trace, speculative, **extra))


def waves(*groups: List[List[int]], period: int = 40):
    """An items builder: each group of prompts submitted together, one
    group every `period` ticks (long enough for the group before to
    finish and publish its pages)."""
    return lambda vocab: [TrafficItem(g * period, list(p))
                          for g, group in enumerate(groups) for p in group]


def assert_same_accounting(j_eng, t_eng):
    """Every device-independent count of the two engines' runs equal."""
    assert [dataclasses.astuple(r) for r in t_eng.launch_records()] \
        == [dataclasses.astuple(r) for r in j_eng.launch_records()]
    strip = lambda rows: [(r[0], r[1], r[3], r[4]) for r in rows]
    assert strip(t_eng.launch_log) == strip(j_eng.launch_log)
    assert t_eng.sched.work_clock == j_eng.sched.work_clock
    assert t_eng.sched.tick_log == j_eng.sched.tick_log
    assert t_eng.gen_tokens == j_eng.gen_tokens
    assert t_eng.host_syncs == j_eng.host_syncs
    assert t_eng.kv_pages_read == j_eng.kv_pages_read
    assert t_eng.load_stats() == j_eng.load_stats()
    assert t_eng.prefix_stats() == j_eng.prefix_stats()
    got, want = t_eng.stats(), j_eng.stats()
    assert set(got) == set(want) - JAX_ONLY_KEYS
    for key in set(got) - WALL_KEYS:
        assert got[key] == want[key], key
    for t, j in zip(sorted(t_eng.sched.finished, key=lambda r: r.uid),
                    sorted(j_eng.sched.finished, key=lambda r: r.uid)):
        assert (t.uid, t.token_work, t.token_tick, t.n_preemptions,
                t.n_resumes, t.finish_reason) \
            == (j.uid, j.token_work, j.token_tick, j.n_preemptions,
                j.n_resumes, j.finish_reason)
    if t_eng.paged:
        assert np.array_equal(t_eng.allocator.table, j_eng.allocator.table)
        assert t_eng.allocator._free == j_eng.allocator._free
        assert np.array_equal(t_eng.allocator._refs, j_eng.allocator._refs)


def assert_pages_conserved(eng):
    """After a drained trace every page is back in the pool, or parked,
    refcounted, in the prefix tree."""
    assert all(s is None for s in eng.slots)
    if eng.prefix is not None:
        eng.prefix.check_invariants()
        assert eng.allocator.used_pages == eng.prefix.cached_pages
    elif eng.paged:
        assert eng.allocator.used_pages == 0
        assert not eng.allocator.table.any()


def outputs(eng) -> Dict[int, List[int]]:
    return {r.uid: list(r.out_tokens) for r in eng.sched.finished}


def assert_same_greedy(models, eng, want: Dict[int, List[int]]):
    """The port engine's outputs equal `want`, or pass the teacher-forced
    near-tie check against the JAX model."""
    jm, jp, _, _ = models
    if outputs(eng) != want:
        assert_greedy_equivalent(jm, jp, eng.sched.finished, want)


def teacher_forced_logits(model, params, req) -> np.ndarray:
    """The port model's float64 logits over req's prompt + output."""
    seq = list(req.prompt) + list(req.out_tokens)
    logits, _ = model.forward(params, {"tokens": torch.tensor(
        [seq], dtype=torch.int32)})
    return logits[0].double().numpy()
