"""Speculative decoding in the port (repro_torch.serve) against the JAX
package: the sampling pieces (sample_chain, speculative_accept),
Model.verify_chunks and the verify step at the granite-3-2b smoke config
in float32 on the JAX weights, then the four conformance traces
(tests/conformance.py) with speculation on and off through both engines,
every device-independent count equal (tests/torch_replay.py), and the
port's spec-on runs against its spec-off runs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformance import TRACES
from repro.serve import sampling as jax_sampling
from repro.serve import serve_step as jax_serve_step
from repro_torch.configs import ServeConfig, get_smoke_config
from repro_torch.models import build_model
from repro_torch.serve import ServeEngine, sampling, serve_step
from torch_replay import (assert_pages_conserved, assert_same_accounting,
                          assert_same_greedy, one_torch_thread, outputs,
                          replay_trace_both, smoke_models,
                          teacher_forced_logits, trace_kw)
from traffic import replay


_threads = pytest.fixture(scope="module", autouse=True)(one_torch_thread)


@pytest.fixture(scope="module")
def models():
    return smoke_models()


# ===========================================================================
# sampling
# ===========================================================================

def _chain_logits(seed, K=5, S=4, V=48):
    """(K, S, V) float32 logits with tied maxima in some positions."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((K, S, V)).astype(np.float32)
    x[0, 1, 3] = x[0, 1, 30] = x[0, 1].max() + 1.0
    x[2, :, 7] = x[2, :, 8] = x[2].max() + 0.5
    return x


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_chain_greedy_matches_jax(seed):
    x = _chain_logits(seed)
    got = sampling.sample_chain(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_sampling.sample_chain(jnp.asarray(x)))
    assert got.dtype == np.int32 and np.array_equal(got, want)


def _chains(seed, K=8, S=5):
    """Seeded draft rows [pending, d_1 .. d_m, pad] with ragged m (dead
    rows m = 0 among them) and target tokens matching each row's draft up
    to a random point."""
    rng = np.random.default_rng(seed)
    draft = rng.integers(0, 6, (K, S)).astype(np.int32)
    draft_lens = rng.integers(0, S, K).astype(np.int32)
    draft_lens[-1] = 0
    target = rng.integers(0, 6, (K, S)).astype(np.int32)
    for k in range(K):
        n = int(rng.integers(0, S))
        target[k, :n] = draft[k, 1:n + 1]
    return target, draft, draft_lens


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_speculative_accept_matches_jax(seed):
    target, draft, lens = _chains(seed)
    n_t, b_t = sampling.speculative_accept(
        torch.from_numpy(target), torch.from_numpy(draft),
        torch.from_numpy(lens))
    n_j, b_j = jax_sampling.speculative_accept(
        jnp.asarray(target), jnp.asarray(draft), jnp.asarray(lens))
    assert n_t.dtype == torch.int32 and b_t.dtype == torch.int32
    assert np.array_equal(n_t.numpy(), np.asarray(n_j))
    assert np.array_equal(b_t.numpy(), np.asarray(b_j))
    assert (n_t.numpy() <= lens).all()


def test_sample_chain_sampled_stays_in_support_and_reproduces():
    """temperature > 0: every (row, position) draw lies in the filtered
    support of its own logits, and one generator seed gives one chain."""
    x = torch.from_numpy(_chain_logits(4, V=64))
    knobs = dict(temperature=0.7, top_k=6, top_p=0.8)
    support = sampling.apply_top_p(sampling.apply_top_k(x / 0.7, 6),
                                   0.8) > sampling.NEG_INF / 2
    gen = torch.Generator().manual_seed(0)
    draws = [sampling.sample_chain(x, gen, **knobs) for _ in range(100)]
    for d in draws:
        assert d.shape == x.shape[:2]
        assert bool(support.gather(2, d.long()[..., None]).all())
    again = torch.Generator().manual_seed(0)
    assert torch.equal(draws[0], sampling.sample_chain(x, again, **knobs))
    # independent draws per position: the chain is not one token repeated
    assert len({tuple(d.flatten().tolist()) for d in draws}) > 50


# ===========================================================================
# Model.verify_chunks and the verify step
# ===========================================================================

PS, N_PAGES, MAX_LEN = 8, 40, 96


@pytest.fixture(scope="module")
def verify_case(models):
    """Both models' paged caches after the same prefill of three prompts
    (lengths 13, 21, 8), and a verify batch of three chains (drafts of
    3, 0 and 2 tokens) plus a dead row, at S = spec_k + 1 = 5."""
    jm, jp, tm, tp = models
    rng = np.random.default_rng(3)
    perm = rng.permutation(np.arange(1, N_PAGES)).astype(np.int32)
    n = MAX_LEN // PS
    tables = np.zeros((4, n), np.int32)
    for r in range(3):
        tables[r, :4] = perm[4 * r:4 * r + 4]
    lens = np.array([13, 21, 8, 0], np.int32)
    toks = np.zeros((4, 24), np.int32)
    for r in range(3):
        toks[r, :lens[r]] = rng.integers(1, tm.cfg.vocab_size, lens[r])
    pre = {"tokens": toks, "offset": np.zeros(4, np.int32),
           "true_lens": lens}
    jcache = jm.init_cache(4, MAX_LEN, page_size=PS, num_pages=N_PAGES)
    _, jcache, _ = jm.prefill_chunks(
        jp, {k: jnp.asarray(v) for k, v in pre.items()}, jcache,
        jnp.asarray(tables))
    tcache = tm.init_cache(4, MAX_LEN, page_size=PS, num_pages=N_PAGES)
    _, tcache, _ = tm.prefill_chunks(
        tp, {k: torch.from_numpy(v) for k, v in pre.items()}, tcache,
        torch.from_numpy(tables))
    draft_lens = np.array([3, 0, 2, 0], np.int32)
    vt = np.zeros((4, 5), np.int32)
    for r in range(3):
        vt[r, :1 + draft_lens[r]] = rng.integers(1, tm.cfg.vocab_size,
                                                 1 + draft_lens[r])
    vbatch = {"tokens": vt, "offset": np.where(lens > 0, lens, 0),
              "true_lens": np.where(lens > 0, lens + 1 + draft_lens, 0),
              "q_lens": np.where(lens > 0, 1 + draft_lens, 0),
              "draft_lens": draft_lens,
              "row_slot": np.array([2, 0, 1, 4], np.int32)}
    vbatch = {k: np.asarray(v, np.int32) for k, v in vbatch.items()}
    return jcache, tcache, tables, vbatch


def _clone(cache):
    return {k: v.clone() for k, v in cache.items()}


def test_verify_chunks_matches_jax(models, verify_case):
    """Every position's logits within 1e-5 of the JAX Model's (the dead
    row's too, which the engine drops), and the pools the chain wrote."""
    jm, jp, tm, tp = models
    jcache, tcache, tables, vb = verify_case
    jl, jc = jm.verify_chunks(jp, {k: jnp.asarray(v) for k, v in vb.items()},
                              dict(jcache), jnp.asarray(tables))
    tl, tc = tm.verify_chunks(
        tp, {k: torch.from_numpy(v) for k, v in vb.items()},
        _clone(tcache), torch.from_numpy(tables))
    assert tl.dtype == torch.float32 and tl.shape == (4, 5,
                                                      tm.cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                               rtol=0)
    for key in ("k_pages", "v_pages"):
        np.testing.assert_allclose(tc[key][:, 1:].numpy(),
                                   np.asarray(jc[key])[:, 1:], atol=1e-5,
                                   rtol=0)


def test_spec_verify_step_matches_jax(models, verify_case):
    """Greedy verify step: acceptance counts, bonus tokens written at the
    row slots, new lens = offset + n_acc + 1, the dead row's sentinel slot
    dropped - exactly the JAX step's."""
    jm, jp, tm, tp = models
    jcache, tcache, tables, vb = verify_case
    tokens0 = np.arange(10, 14, dtype=np.int32)[:, None]
    lens0 = np.array([5, 6, 7, 8], np.int32)
    j_step = jax_serve_step.make_spec_verify_step(jm, temperature=0.0)
    _, j_tok, j_lens, j_nacc = j_step(
        jp, {k: jnp.asarray(v) for k, v in vb.items()}, dict(jcache),
        jnp.asarray(tables), jnp.asarray(tokens0), jnp.asarray(lens0),
        jax.random.PRNGKey(0))
    t_step = serve_step.make_spec_verify_step(tm, temperature=0.0)
    _, t_tok, t_lens, t_nacc = t_step(
        tp, {k: torch.from_numpy(v) for k, v in vb.items()},
        _clone(tcache), torch.from_numpy(tables),
        torch.from_numpy(tokens0), torch.from_numpy(lens0), None)
    assert np.array_equal(t_nacc.numpy(), np.asarray(j_nacc))
    assert np.array_equal(t_tok.numpy(), np.asarray(j_tok))
    assert np.array_equal(t_lens.numpy(), np.asarray(j_lens))
    assert t_lens[3] == 8 and t_tok[3, 0] == 13      # no row for slot 3


# ===========================================================================
# the four conformance traces through both engines
# ===========================================================================

def _tick_shapes(eng):
    """Per tick: (launches by kind, fetches)."""
    per = {}
    for r in eng.launch_records():
        per.setdefault(r.tick, []).append(r.kind)
    return per


@pytest.mark.parametrize("speculative", [False, True],
                         ids=["spec_off", "spec_on"])
@pytest.mark.parametrize("trace", sorted(TRACES))
def test_trace_matches_jax(models, trace, speculative):
    """Greedy outputs, launch records and log, work clock, KV pages read,
    drafted / accepted counts, prefix and preemption counters and stats()
    equal to the JAX engine's; a spec-on tick makes at most one chunk
    batch, one verify and one decode launch and one fetch."""
    j_eng, t_eng, _ = replay_trace_both(models, trace, speculative)
    assert_same_accounting(j_eng, t_eng)
    assert_pages_conserved(t_eng)
    assert (t_eng.stats()["spec_drafted"] > 0) == speculative
    for kinds in _tick_shapes(t_eng).values():
        for kind in ("chunk_batch", "spec_verify", "decode"):
            assert kinds.count(kind) <= 1, kinds
    for calls, syncs, _, _, _ in t_eng.launch_log:
        assert calls <= 3 and syncs <= 1


@pytest.mark.parametrize("trace", sorted(TRACES))
def test_spec_on_equals_spec_off(models, trace):
    """On the port alone: speculation changes how tokens are produced,
    never which - equal greedy outputs, work clocks and token counts,
    pages conserved on both."""
    _, _, tm, tp = models
    runs = {}
    for spec in (False, True):
        eng = ServeEngine(tm, tp, ServeConfig(**trace_kw(trace, spec)))
        replay(eng, TRACES[trace].build(tm.cfg.vocab_size), check=True)
        assert_pages_conserved(eng)
        runs[spec] = eng
    assert_same_greedy(models, runs[True], outputs(runs[False]))
    off, on = runs[False].stats(), runs[True].stats()
    assert on["work_tokens"] == off["work_tokens"]
    assert on["gen_tokens"] == off["gen_tokens"]
    assert on["spec_drafted"] > 0 and off["spec_drafted"] == 0


def test_spec_budget_respected(models):
    """Drafted tokens consume budget: no tick's decode + prefill work
    passes tick_token_budget."""
    _, _, tm, tp = models
    eng = ServeEngine(tm, tp, ServeConfig(**trace_kw("mixed", True)))
    replay(eng, TRACES["mixed"].build(tm.cfg.vocab_size), check=True)
    for d, p in eng.sched.tick_log:
        assert d + p <= eng.scfg.tick_token_budget
    assert eng.stats()["spec_drafted"] > 0


def test_long_generations_accept_chains_like_jax(models):
    """The shared-prefix trace with 96 new tokens a request: chains are
    accepted, the run needs fewer ticks and reads fewer KV pages per
    token than spec-off, and every count equals the JAX engine's."""
    kw = dict(max_new_tokens=96, max_seq=1024, tick_token_budget=96)
    j_on, t_on, _ = replay_trace_both(models, "shared_prefix", True, **kw)
    assert_same_accounting(j_on, t_on)
    _, _, tm, tp = models
    off = ServeEngine(tm, tp, ServeConfig(**trace_kw("shared_prefix", False,
                                                     **kw)))
    replay(off, TRACES["shared_prefix"].build(tm.cfg.vocab_size))
    s_on, s_off = t_on.stats(), off.stats()
    assert s_on["spec_accepted"] > 0
    assert s_on["ticks"] < s_off["ticks"]
    assert s_on["tokens_per_kv_page"] > s_off["tokens_per_kv_page"]
    assert_same_greedy(models, t_on, outputs(off))


def _filtered_support(row, temperature, top_k, top_p, slack=1e-3):
    """Tokens a temperature -> top-k -> top-p draw can return from the
    float64 logits `row`, widened by `slack` for rounding."""
    scaled = row / temperature
    V = scaled.shape[0]
    ok = np.ones(V, bool)
    if 0 < top_k < V:
        ok &= scaled >= np.sort(scaled)[V - top_k] - slack
    if top_p < 1.0:
        order = np.argsort(-scaled)
        probs = np.exp(scaled - scaled.max())
        probs /= probs.sum()
        cum = np.cumsum(probs[order])
        keep = (cum - probs[order]) < top_p
        ok &= scaled >= scaled[order[keep]].min() - slack
    return ok


def test_sampled_speculation_in_support_and_seeded(models):
    """temperature 0.8, top-k 20, top-p 0.95 with speculation: one seed
    reproduces the run, every token lies in the filtered support of the
    port model's own teacher-forced logits at its position, and the token
    counts and work clock equal a spec-off run's."""
    _, _, tm, tp = models
    kw = dict(temperature=0.8, top_k=20, top_p=0.95, seed=7)
    engs = []
    for spec in (True, True, False):
        eng = ServeEngine(tm, tp, ServeConfig(**trace_kw("mixed", spec,
                                                         **kw)))
        replay(eng, TRACES["mixed"].build(tm.cfg.vocab_size), check=True)
        engs.append(eng)
    on, again, off = engs
    assert outputs(on) == outputs(again)
    assert {u: len(t) for u, t in outputs(on).items()} \
        == {u: len(t) for u, t in outputs(off).items()}
    assert on.stats()["work_tokens"] == off.stats()["work_tokens"]
    assert on.stats()["spec_drafted"] > 0
    assert_pages_conserved(on)
    for req in on.sched.finished:
        logits = teacher_forced_logits(tm, tp, req)
        for i, tok in enumerate(req.out_tokens):
            row = logits[len(req.prompt) - 1 + i]
            assert _filtered_support(row, 0.8, 20, 0.95)[tok], (req.uid, i)


def test_speculation_needs_an_attention_family():
    cfg = get_smoke_config("zamba2-2.7b").replace(dtype="float32")
    m = build_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="attention family"):
        ServeEngine(m, m.params, ServeConfig(
            max_batch=2, max_seq=128, paged=True, chunked=True,
            prefill_chunk=16, tick_token_budget=32, speculative=True))
