"""The MoE family (M13) of the port against the JAX package on the CPU, at
the olmoe-1b-7b and qwen3-moe-235b-a22b smoke configs (2 layers, d_model
64, 8 experts, top 2; qwen3-moe with 4 / 2 heads and QK-norm), float32,
with the JAX Model.init weights carried over and every input made by
numpy from a seed.

moe_ffn's output and aux loss at the config's capacity factor and at 0.5,
where pairs are dropped (asserted); Model.forward's logits and aux; the
loss, aux and every gradient (loss.backward() against jax.grad, with and
without remat); the dense prefill and decode, the paged prefill and its
decode, and a ragged chunk batch and its decode (logits and caches); the
engine on olmoe's smoke model (3 requests on 2 slots: paged + chunked +
batched, monolithic on the dense cache, and speculative), its greedy
outputs, launch records and counters; one Trainer step against the JAX
train step on a numpy-seeded batch, and two steps of each smoke config
through the training launcher; and the reference's property that a
chunked prefill's logits differ from the monolithic prefill's exactly
when a pair is dropped (ROADMAP §3), which the port copies.

Routing: every call of moe_ffn in both packages is recorded (the port's
through a wrapper of repro_torch.models.moe.moe_ffn, the JAX package's
through a wrapper of repro.models.transformer.moe_ffn that sends its
router probabilities and top-k out with an ordered jax.debug.callback).
The two packages' top_idx must be equal call by call; where one differs,
the token's top K + 1 probabilities must hold two within 1e-6 of each
other (a tie the two routers may order either way), and only then is the
token left out of the comparisons.

Bars, float32 (the two frameworks sum the projections and einsums in
other orders): outputs, logits, caches, probabilities and losses 1e-5
absolute; each gradient leaf within 1e-5 of its largest |entry|, the bar
of tests/test_torch_train.py; the Trainer step's metrics 1e-5 relative.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import ServeConfig as JaxServeConfig
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.models import build_model as jax_build_model
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro.serve import ServeEngine as JaxServeEngine
from repro.train import init_train_state as j_init_train_state
from repro.train import make_train_step as j_make_train_step
from repro_torch.configs import (ServeConfig, TrainConfig, get_config,
                                 get_smoke_config)
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model, moe
from repro_torch.models.convert import (params_from_numpy,
                                        train_state_from_numpy)
from repro_torch.serve import ServeEngine
from repro_torch.train import trainable
from repro_torch.train.trainer import Trainer
from repro_torch.tree import leaves_with_paths
from torch_replay import (assert_pages_conserved, assert_same_accounting,
                          one_torch_thread)
from traffic import TrafficItem, replay

ARCHS = ("olmoe-1b-7b", "qwen3-moe-235b-a22b")
F32 = 1e-5
TIE = 1e-6
PS, MAX_LEN, N_PAGES = 4, 48, 37

_one_thread = pytest.fixture(scope="module", autouse=True)(one_torch_thread)


def _models(arch, **over):
    jcfg = jax_smoke_config(arch).replace(dtype="float32", **over)
    tcfg = get_smoke_config(arch).replace(dtype="float32", **over)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, device="cpu")
    return jm, jp, tm, params_from_numpy(jax.device_get(jp), tcfg, "cpu")


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    return _models(request.param)


def _np(x):
    return x.detach().float().numpy() if torch.is_tensor(x) \
        else np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# routing records
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def routing():
    """Record (probs, top_idx) of every moe_ffn call, in call order, in
    both packages: yields (JAX records, port records)."""
    jlog, tlog = [], []
    j_orig, t_orig = jtransformer.moe_ffn, moe.moe_ffn

    def j_wrapped(params, x, cfg):
        probs = jax.nn.softmax(jnp.einsum(
            "bsd,de->bse", x.astype(jnp.float32), params["router"]), -1)
        _, top = jax.lax.top_k(probs, cfg.moe_top_k)
        jax.debug.callback(lambda p, t: jlog.append(
            (np.asarray(p), np.asarray(t))), probs, top, ordered=True)
        return j_orig(params, x, cfg)

    def t_wrapped(params, x, cfg):
        probs, _, top = moe.route(params, x, cfg)
        tlog.append((_np(probs), top.numpy()))
        return t_orig(params, x, cfg)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(jtransformer, "moe_ffn", j_wrapped)
        m.setattr(moe, "moe_ffn", t_wrapped)
        yield jlog, tlog
        jax.effects_barrier()


def tie_gap(p: np.ndarray, K: int) -> float:
    """The least gap between neighbours of the top K + 1 of p (E,)."""
    top = np.sort(p)[::-1][:K + 1]
    return float(np.min(top[:-1] - top[1:]))


def assert_same_routing(jlog, tlog, K):
    """The records agree call by call: probabilities within F32, top_idx
    equal or, for a token, a tie within TIE.  Returns the flipped tokens
    as {call: [(b, s), ...]}."""
    assert len(tlog) == len(jlog) > 0
    flips = {}
    for c, ((jp, jt), (tp, tt)) in enumerate(zip(jlog, tlog)):
        assert tt.shape == jt.shape, c
        np.testing.assert_allclose(tp, jp, rtol=0, atol=F32, err_msg=c)
        for idx in map(tuple, np.argwhere(np.any(jt != tt, -1))):
            assert tie_gap(jp[idx], K) < TIE, (c, idx, jt[idx], tt[idx])
            flips.setdefault(c, []).append(idx)
    return flips


def _flipped_rows(flips, shape):
    """(B, S) mask of the (b, s) flipped in any call of that shape."""
    mask = np.zeros(shape, bool)
    for idxs in flips.values():
        for b, s in idxs:
            mask[b, s] = True
    return mask


# ---------------------------------------------------------------------------
# configs and the MoE FFN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_registered_at_their_published_widths(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    assert cfg.family == "moe"
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
              "d_ff", "vocab_size", "moe_experts", "moe_top_k",
              "moe_capacity_factor", "qk_norm", "tie_embeddings",
              "rope_theta"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    for c, j in ((cfg, jcfg), (get_smoke_config(arch),
                               jax_smoke_config(arch))):
        assert (c.param_count(), c.active_param_count()) \
            == (j.param_count(), j.active_param_count())
    assert cfg.active_param_count() < cfg.param_count()


def _dropped(top_idx: np.ndarray, cfg) -> np.ndarray:
    """(B, S, K) mask of the (token, k) pairs past their expert's per-row
    capacity in a call of top_idx's shape."""
    B, S, K = top_idx.shape
    C = moe.capacity(S, cfg)
    flat = top_idx.reshape(B, S * K)
    hot = flat[..., None] == np.arange(cfg.moe_experts)
    pos = np.take_along_axis(np.cumsum(hot, 1), flat[..., None], 2)[..., 0]
    return (pos > C).reshape(B, S, K)


@pytest.mark.parametrize("factor", [None, 0.5])
def test_moe_ffn_matches_jax(models, factor):
    """(3, 20) tokens through layer 0's experts: output and aux; at
    capacity factor 0.5 pairs are dropped."""
    jm, jp, tm, tp = models
    jcfg, cfg = jm.cfg, tm.cfg
    if factor is not None:
        jcfg = jcfg.replace(moe_capacity_factor=factor)
        cfg = cfg.replace(moe_capacity_factor=factor)
    x = np.random.default_rng(1).standard_normal((3, 20, 64)).astype(
        np.float32)
    jpl = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["moe"])
    tpl = {k: v[0] for k, v in tp["blocks"]["moe"].items()}
    assert tpl["router"].dtype == torch.float32
    jy, jaux = jmoe.moe_ffn(jpl, jnp.asarray(x), jcfg)
    ty, taux = moe.moe_ffn(tpl, torch.from_numpy(x), cfg)
    jprobs = np.asarray(jax.nn.softmax(jnp.asarray(x) @ jpl["router"], -1))
    jtop = np.asarray(jax.lax.top_k(jprobs, cfg.moe_top_k)[1])
    tprobs, _, ttop = moe.route(tpl, torch.from_numpy(x), cfg)
    flips = assert_same_routing([(jprobs, jtop)], [(_np(tprobs),
                                                    ttop.numpy())],
                                cfg.moe_top_k)
    keep = ~_flipped_rows(flips, (3, 20))
    assert ty.shape == (3, 20, 64) and ty.dtype == torch.float32
    np.testing.assert_allclose(_np(ty)[keep], _np(jy)[keep], rtol=0,
                               atol=F32)
    assert abs(float(taux) - float(jaux)) <= F32
    if factor is not None:
        assert _dropped(jtop, cfg).any()


# ---------------------------------------------------------------------------
# the model's entry points
# ---------------------------------------------------------------------------

def test_forward_matches_jax(models):
    jm, jp, tm, tp = models
    toks = np.random.default_rng(2).integers(0, 256, (2, 24)).astype(
        np.int32)
    with routing() as (jlog, tlog):
        jl, jaux = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)})
        tl, taux = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    flips = assert_same_routing(jlog, tlog, tm.cfg.moe_top_k)
    assert len(tlog) == tm.cfg.n_layers
    keep = ~_flipped_rows(flips, (2, 24))
    assert tl.shape == (2, 24, 256) and float(taux) > 0
    np.testing.assert_allclose(_np(tl)[keep], _np(jl)[keep], rtol=0,
                               atol=F32)
    assert abs(float(taux) - float(jaux)) <= F32


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_jax(models, remat):
    """loss = ce + 0.01 aux, its parts, and every gradient leaf (the
    router's and the experts' among them); with remat the aux comes out
    of the checkpointed layers."""
    jm, jp, tm, _ = models
    tp = trainable(params_from_numpy(jax.device_get(jp), tm.cfg, "cpu"))
    toks = np.random.default_rng(3).integers(0, 256, (2, 16)).astype(
        np.int32)
    jb = {"tokens": jnp.asarray(toks)}
    with routing() as (jlog, tlog):
        (jl, jm_), jg = jax.jit(jax.value_and_grad(
            lambda p: jm.loss(p, jb, remat=remat), has_aux=True))(jp)
        tl, tm_ = tm.loss(tp, {"tokens": torch.from_numpy(toks)},
                          remat=remat)
        tl.backward()
    # the JAX callbacks fire once per layer; with remat the port's
    # wrapper runs again in each layer's recompute
    n = tm.cfg.n_layers
    assert not assert_same_routing(jlog[:n], tlog[:n], tm.cfg.moe_top_k)
    for k, t in (("total", tl), ("ce", tm_["ce"]), ("aux", tm_["aux"])):
        want = jl if k == "total" else jm_[k]
        assert abs(float(t.detach()) - float(want)) <= F32, k
    want = dict(leaves_with_paths(jax.device_get(jg)))
    got = dict(leaves_with_paths(tp))
    assert sorted(got) == sorted(want)
    assert {"blocks/moe/router", "blocks/moe/experts_gate"} <= set(got)
    for path, p in got.items():
        g, w = _np(p.grad), np.asarray(want[path], np.float32)
        assert np.abs(g - w).max() <= F32 * np.abs(w).max(), path


def test_dense_prefill_and_decode_match_jax(models):
    """Two prompts padded to 16 (12 and 16 real tokens) into strips of
    32, then 4 decode steps: logits and both strips."""
    jm, jp, tm, tp = models
    rng = np.random.default_rng(4)
    toks = rng.integers(1, 256, (2, 16)).astype(np.int32)
    toks[0, 12:] = 0
    tl_ = np.array([12, 16], np.int32)
    with routing() as (jlog, tlog):
        jlp, jc, jlens = jax.jit(jm.prefill)(
            jp, {"tokens": jnp.asarray(toks),
                 "true_lens": jnp.asarray(tl_)}, jm.init_cache(2, 32))
        tlp, tc, tlens = tm.prefill(
            tp, {"tokens": torch.from_numpy(toks),
                 "true_lens": torch.from_numpy(tl_)}, tm.init_cache(2, 32))
        np.testing.assert_allclose(_np(tlp), _np(jlp), rtol=0, atol=F32)
        assert tlens.tolist() == np.asarray(jlens).tolist() == [12, 16]
        jstep = jax.jit(jm.decode_step)
        for _ in range(4):
            nxt = rng.integers(1, 256, (2, 1)).astype(np.int32)
            jd, jc = jstep(jp, jnp.asarray(nxt), jlens, jc)
            td, tc = tm.decode_step(tp, torch.from_numpy(nxt), tlens, tc)
            np.testing.assert_allclose(_np(td), _np(jd), rtol=0, atol=F32)
            jlens, tlens = jlens + 1, tlens + 1
    assert not assert_same_routing(jlog, tlog, tm.cfg.moe_top_k)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), rtol=0,
                                   atol=F32, err_msg=name)


def test_paged_prefill_chunks_and_decode_match_jax(models):
    """A paged prefill of a 13-token prompt (padded to 16) and two decode
    steps; then on a fresh pool a ragged chunk batch (two chunks of one
    sequence, a dead row, a chunk starting mid-page) and a batch of final
    chunks, then 3 decode steps with an idle lane: logits and pools."""
    jm, jp, tm, tp = models
    rng = np.random.default_rng(5)
    pools = lambda c: [_np(c[k])[:, 1:] for k in ("k_pages", "v_pages")]
    with routing() as (jlog, tlog):
        prompt = np.zeros((1, 16), np.int32)
        prompt[0, :13] = rng.integers(1, 256, 13)
        pages = np.arange(3, 7, dtype=np.int32)
        jb = {"tokens": jnp.asarray(prompt), "true_lens": jnp.asarray([13])}
        tb = {"tokens": torch.from_numpy(prompt),
              "true_lens": torch.tensor([13], dtype=torch.int32)}
        jlp, jc, jlens = jax.jit(jm.prefill_paged)(
            jp, jb, jm.init_cache(1, MAX_LEN, page_size=PS,
                                  num_pages=N_PAGES), jnp.asarray(pages))
        tlp, tc, tlens = tm.prefill_paged(
            tp, tb, tm.init_cache(1, MAX_LEN, page_size=PS,
                                  num_pages=N_PAGES), torch.from_numpy(pages))
        np.testing.assert_allclose(_np(tlp), _np(jlp), rtol=0, atol=F32)
        row = np.zeros((1, MAX_LEN // PS), np.int32)
        row[0, :4], row[0, 4] = pages, 9
        jc["block_table"], tc["block_table"] = jnp.asarray(row), \
            torch.from_numpy(row)
        nxt = np.array([[3]], np.int32)
        for _ in range(2):
            jd, jc = jax.jit(jm.decode_step)(jp, jnp.asarray(nxt), jlens, jc)
            td, tc = tm.decode_step(tp, torch.from_numpy(nxt), tlens, tc)
            np.testing.assert_allclose(_np(td), _np(jd), rtol=0, atol=F32)
            jlens, tlens = jlens + 1, tlens + 1
        for a, b in zip(pools(tc), pools(jc)):
            np.testing.assert_allclose(a, b, rtol=0, atol=F32)

        perm = rng.permutation(np.arange(1, N_PAGES)).astype(np.int32)
        prompts, tables = {}, {}
        for seq, n, pg in (("A", 20, perm[:7]), ("B", 37, perm[7:17])):
            prompts[seq] = rng.integers(1, 256, n)
            tables[seq] = np.zeros(MAX_LEN // PS, np.int32)
            tables[seq][:len(pg)] = pg
        jc = jm.init_cache(3, MAX_LEN, page_size=PS, num_pages=N_PAGES)
        tc = tm.init_cache(3, MAX_LEN, page_size=PS, num_pages=N_PAGES)
        j_chunks = jax.jit(jm.prefill_chunks)
        for plan in ([("A", 0, 16), ("B", 0, 16), ("B", 16, 16), None],
                     [("A", 16, 4), ("B", 32, 5)]):
            K = len(plan)
            toks = np.zeros((K, 16), np.int32)
            off, tl_, tb_ = (np.zeros(K, np.int32), np.zeros(K, np.int32),
                             np.zeros((K, MAX_LEN // PS), np.int32))
            for r, rw in enumerate(plan):
                if rw is not None:
                    seq, start, n = rw
                    toks[r, :n] = prompts[seq][start:start + n]
                    off[r], tl_[r], tb_[r] = start, start + n, tables[seq]
            jl, jc, _ = j_chunks(
                jp, {"tokens": jnp.asarray(toks), "offset": jnp.asarray(off),
                     "true_lens": jnp.asarray(tl_)}, jc, jnp.asarray(tb_))
            got, tc, _ = tm.prefill_chunks(
                tp, {"tokens": torch.from_numpy(toks),
                     "offset": torch.from_numpy(off),
                     "true_lens": torch.from_numpy(tl_)}, tc,
                torch.from_numpy(tb_))
            np.testing.assert_allclose(_np(got)[tl_ > 0],
                                       np.asarray(jl)[tl_ > 0], rtol=0,
                                       atol=F32)
        bt = np.stack([tables["A"], tables["B"],
                       np.zeros(MAX_LEN // PS, np.int32)])
        jc["block_table"], tc["block_table"] = jnp.asarray(bt), \
            torch.from_numpy(bt)
        lens = np.array([20, 37, 0], np.int32)
        tok = np.array([[5], [7], [0]], np.int32)
        for _ in range(3):
            jl, jc = jax.jit(jm.decode_step)(jp, jnp.asarray(tok),
                                             jnp.asarray(lens), jc)
            got, tc = tm.decode_step(tp, torch.from_numpy(tok),
                                     torch.from_numpy(lens), tc)
            np.testing.assert_allclose(_np(got)[:2], np.asarray(jl)[:2],
                                       rtol=0, atol=F32)
            tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
            lens = lens + np.array([1, 1, 0], np.int32)
    assert not assert_same_routing(jlog, tlog, tm.cfg.moe_top_k)
    for a, b in zip(pools(tc), pools(jc)):
        np.testing.assert_allclose(a, b, rtol=0, atol=F32)


def test_chunked_prefill_differs_from_monolithic_exactly_when_drops_do():
    """The reference's capacity follows each call's S, so a 32-token prompt
    prefilled in one paged call and in two 16-token chunks may drop
    different (token, k) pairs.  The last token's logits see a drop in
    the first layer at any position and one in the last layer at the last
    position only; they differ between the two plans exactly when the
    plans' drops differ there (ROADMAP §3), and agree within F32
    otherwise.  At capacity factor 4 (= E / K, so C = S) nothing drops;
    at 0.5 the plans' drops differ.  The port gives the JAX package's
    logits for both plans."""
    rng = np.random.default_rng(6)
    prompt = rng.integers(1, 256, (1, 32)).astype(np.int32)
    pages = np.arange(1, 9, dtype=np.int32)
    row = np.zeros((1, MAX_LEN // PS), np.int32)
    row[0, :8] = pages
    seen = {}
    for factor in (4.0, 1.25, 0.5):
        jm, jp, tm, tp = _models("olmoe-1b-7b", moe_capacity_factor=factor)
        out, drops = {}, {}
        for plan in ("mono", "chunked"):
            jc = jm.init_cache(1, MAX_LEN, page_size=PS, num_pages=N_PAGES)
            tc = tm.init_cache(1, MAX_LEN, page_size=PS, num_pages=N_PAGES)
            with routing() as (jlog, tlog):
                if plan == "mono":
                    jl = jax.jit(jm.prefill_paged)(
                        jp, {"tokens": jnp.asarray(prompt)}, jc,
                        jnp.asarray(pages))[0]
                    tl = tm.prefill_paged(
                        tp, {"tokens": torch.from_numpy(prompt)}, tc,
                        torch.from_numpy(pages))[0]
                for start in ((0, 16) if plan == "chunked" else ()):
                    b = {"tokens": prompt[:, start:start + 16],
                         "offset": np.array([start], np.int32),
                         "true_lens": np.array([start + 16], np.int32)}
                    jl, jc, _ = jax.jit(jm.prefill_chunks)(
                        jp, {k: jnp.asarray(v) for k, v in b.items()}, jc,
                        jnp.asarray(row))
                    tl, tc, _ = tm.prefill_chunks(
                        tp, {k: torch.from_numpy(v) for k, v in b.items()},
                        tc, torch.from_numpy(row))
            assert not assert_same_routing(jlog, tlog, 2)
            np.testing.assert_allclose(_np(tl), _np(jl), rtol=0, atol=F32)
            # per layer, the (1, 32, K) drop mask over the whole prompt
            masks = [_dropped(t, tm.cfg) for _, t in jlog]
            L = tm.cfg.n_layers
            drops[plan] = [np.concatenate(masks[l::L], 1) for l in range(L)]
            out[plan] = _np(jl)
        mono, chunked = drops["mono"], drops["chunked"]
        differ = bool((mono[0] != chunked[0]).any()
                      or (mono[-1][:, -1] != chunked[-1][:, -1]).any())
        diff = float(np.abs(out["mono"] - out["chunked"]).max())
        seen[factor] = (int(sum(m.sum() for m in mono + chunked)), differ,
                        diff)
        assert differ == (diff > 100 * F32), seen
        if not differ:
            assert diff <= F32, seen
    assert seen[4.0][0] == 0 and seen[0.5][1], seen


# ---------------------------------------------------------------------------
# the engine and the trainer
# ---------------------------------------------------------------------------

ENGINES = {
    "paged_chunked_batched": dict(paged=True, chunked=True, batched=True),
    "dense_monolithic": dict(paged=False, chunked=False),
    "speculative": dict(paged=True, chunked=True, batched=True,
                        speculative=True, spec_k=3, spec_ngram=2)}


@pytest.fixture(scope="module")
def olmoe():
    return _models("olmoe-1b-7b")


@pytest.mark.parametrize("engine", list(ENGINES))
def test_engine_matches_jax(olmoe, engine):
    """Three prompts of 11, 23 and 30 tokens (each a repeated 5-gram, so
    the drafter finds matches) on 2 slots - the third reuses a freed
    slot - 6 new tokens each, greedy: outputs, launch records, every
    counter, and the routing of every moe_ffn call."""
    jm, jp, tm, tp = olmoe
    # a JAX model of its own: the JAX engine keeps its jitted steps per
    # model object, and those of another test would record elsewhere
    jm = jax_build_model(jm.cfg)
    kw = dict(max_batch=2, max_seq=MAX_LEN, max_new_tokens=6, page_size=PS,
              prefill_chunk=16, tick_token_budget=20, **ENGINES[engine])
    rng = np.random.default_rng(7)
    prompts = [(rng.integers(1, 256, 5).tolist() * 6)[:n]
               for n in (11, 23, 30)]
    items = lambda: [TrafficItem(0, list(p)) for p in prompts]
    with routing() as (jlog, tlog):
        j_eng = JaxServeEngine(jm, jp, JaxServeConfig(**kw))
        j_out, _ = replay(j_eng, items())
        t_eng = ServeEngine(tm, tp, ServeConfig(**kw))
        t_out, _ = replay(t_eng, items())
    flips = assert_same_routing(jlog, tlog, tm.cfg.moe_top_k)
    assert len(t_out) == 3
    if not flips:
        assert t_out == j_out
    assert_same_accounting(j_eng, t_eng)
    assert_pages_conserved(t_eng)
    kinds = {r.kind for r in t_eng.launch_records()}
    assert kinds >= {"paged_chunked_batched": {"chunk_batch", "decode"},
                     "dense_monolithic": {"prefill", "decode"}}.get(
        engine, {"spec_verify"}), kinds


def test_trainer_step_matches_jax(olmoe, tmp_path):
    """One step of the port's Trainer, its state the JAX init state, on a
    numpy-seeded batch (the pipelines seed by Python's per-process hash:
    ROADMAP §3) against the JAX train step: loss, ce, aux, grad norm and
    lr."""
    jm, _, tm, _ = olmoe
    kw = dict(global_batch=2, seq_len=16, learning_rate=1e-3,
              warmup_steps=1, total_steps=4, log_every=1, remat="full")
    jtcfg = JaxTrainConfig(**kw)
    jstate = j_init_train_state(jm, jax.random.PRNGKey(0), jtcfg)
    host = jax.device_get(jstate)
    toks = np.random.default_rng(8).integers(0, 256, (2, 16)).astype(
        np.int32)
    _, out = jax.jit(j_make_train_step(jm, jtcfg))(
        jstate, {"tokens": jnp.asarray(toks)})
    tr = Trainer(tm.cfg, TrainConfig(checkpoint_dir=str(tmp_path), **kw),
                 device="cpu")
    tr.state = train_state_from_numpy(host.params, host.opt, host.ef,
                                      tm.cfg, "cpu")
    tr.pipeline.device_batch = lambda step: {"tokens": torch.from_numpy(
        toks)}
    got = tr.run(n_steps=1)["metrics"][0]
    assert got["aux"] > 0
    for k in ("loss", "ce", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose(got[k], float(out[k]), rtol=F32,
                                   err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_trains_the_moe_smoke_configs_on_the_cpu(arch, tmp_path,
                                                       capsys):
    launch_train.main(["--arch", arch, "--smoke", "--steps", "2", "--seq",
                       "16", "--global-batch", "2", "--device", "cpu",
                       "--ckpt-dir", str(tmp_path)])
    assert "finished at step 1" in capsys.readouterr().out
