"""The port's dense decoder (repro_torch.models) against the JAX package's
Model on the granite-3-2b and gemma3-4b smoke configs (gemma3 covers the
sliding window, the local:global layer pattern, QK-norm and tanh-gelu).

Both models run the same weights: the JAX Model.init tree, pulled to numpy
and carried over by repro_torch.models.convert.  A ragged chunk batch (two
chunks of one sequence in one batch, a dead row, a chunk starting
mid-page), a second batch of ragged final chunks, then three decode steps
with an idle lane go through both; logits and the written page pools are
compared after every step.  The same holds for the monolithic entry
points: Model.forward, a dense prefill of padded prompts followed by three
dense decode steps (one lane idle), and a paged prefill followed by paged
decode steps; logits, the dense strips and the pools are compared.

Bars (absolute): float32 logits 1e-5 and pools 1e-5 - not bit-equal,
because XLA and ATen sum the projections in different orders (seen: 4e-6
in the pools, 7e-7 in the logits).  bfloat16 logits 2e-2 and pools 0.125
(the two frameworks round the bf16 residual stream at different places;
seen: 6e-3 on logits of magnitude 0.5 and 0.084 in the pools).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_smoke_config
from repro_torch.models import build_model
from repro_torch.models.attention import (attn_prefill_chunk_paged,
                                          attn_prefill_chunks_paged)
from repro_torch.models.convert import params_from_numpy, tensor_from_numpy

BARS = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 0.125)}
PS, BATCH, MAX_LEN, N_PAGES, CHUNK = 4, 3, 48, 37, 16


def _models(arch, dtype):
    jcfg = jax_smoke_config(arch).replace(dtype=dtype)
    tcfg = get_smoke_config(arch).replace(dtype=dtype)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, device="cpu")
    return jm, jp, tm, params_from_numpy(jax.device_get(jp), tcfg, "cpu")


def _chunk_batch(rows, vocab_rows):
    K = len(rows)
    toks = np.zeros((K, CHUNK), np.int32)
    off = np.zeros(K, np.int32)
    tl = np.zeros(K, np.int32)
    tb = np.zeros((K, MAX_LEN // PS), np.int32)
    for r, row in enumerate(rows):
        if row is None:
            continue                              # dead padding row
        seq, start, n = row
        prompt, table = vocab_rows[seq]
        toks[r, :n] = prompt[start:start + n]
        off[r], tl[r], tb[r] = start, start + n, table
    return toks, off, tl, tb


def _pools(cache, to_np):
    return [to_np(cache[k])[:, 1:] for k in ("k_pages", "v_pages")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["granite-3-2b", "gemma3-4b"])
def test_chunks_then_decode_match_jax(arch, dtype):
    logit_bar, pool_bar = BARS[dtype]
    jm, jp, tm, tp = _models(arch, dtype)
    j_chunks, j_decode = jax.jit(jm.prefill_chunks), jax.jit(jm.decode_step)
    vocab = tm.cfg.vocab_size
    jcache = jm.init_cache(BATCH, MAX_LEN, page_size=PS, num_pages=N_PAGES)
    tcache = tm.init_cache(BATCH, MAX_LEN, page_size=PS, num_pages=N_PAGES)
    rng = np.random.default_rng(0)
    perm = rng.permutation(np.arange(1, N_PAGES)).astype(np.int32)
    rows = {}
    for name, n_prompt, pages in (("A", 20, perm[:7]), ("B", 37, perm[7:17])):
        table = np.zeros(MAX_LEN // PS, np.int32)
        table[:len(pages)] = pages
        rows[name] = (rng.integers(1, vocab, n_prompt), table)
    plans = [[("A", 0, 16), ("B", 0, 16), ("B", 16, 16), None],
             [("A", 16, 4), ("B", 32, 5)]]
    j_np = lambda a: np.asarray(jnp.asarray(a, jnp.float32))
    t_np = lambda t: t.float().numpy()
    for plan in plans:
        toks, off, tl, tb = _chunk_batch(plan, rows)
        jl, jcache, _ = j_chunks(
            jp, {"tokens": jnp.asarray(toks), "offset": jnp.asarray(off),
                 "true_lens": jnp.asarray(tl)}, jcache, jnp.asarray(tb))
        tl_, tcache, cursors = tm.prefill_chunks(
            tp, {"tokens": torch.from_numpy(toks),
                 "offset": torch.from_numpy(off),
                 "true_lens": torch.from_numpy(tl)}, tcache,
            torch.from_numpy(tb))
        assert tl_.dtype == torch.float32 and tl_.shape == (len(plan), 1,
                                                             vocab)
        live = tl > 0
        np.testing.assert_allclose(t_np(tl_)[live], j_np(jl)[live],
                                   atol=logit_bar, rtol=0)
        for got, want in zip(_pools(tcache, t_np), _pools(jcache, j_np)):
            np.testing.assert_allclose(got, want, atol=pool_bar, rtol=0)
    bt = np.stack([rows["A"][1], rows["B"][1],
                   np.zeros(MAX_LEN // PS, np.int32)])
    jcache["block_table"] = jnp.asarray(bt)
    tcache["block_table"] = torch.from_numpy(bt)
    lens = np.array([20, 37, 0], np.int32)       # lane 2 idle
    tok = np.array([[5], [7], [0]], np.int32)
    for _ in range(3):
        jl, jcache = j_decode(jp, jnp.asarray(tok), jnp.asarray(lens),
                              jcache)
        tl_, tcache = tm.decode_step(tp, torch.from_numpy(tok),
                                     torch.from_numpy(lens), tcache)
        np.testing.assert_allclose(t_np(tl_)[:2], j_np(jl)[:2],
                                   atol=logit_bar, rtol=0)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        lens = lens + np.array([1, 1, 0], np.int32)
    for got, want in zip(_pools(tcache, t_np), _pools(jcache, j_np)):
        np.testing.assert_allclose(got, want, atol=pool_bar, rtol=0)


def test_single_chunk_entry_point_is_the_k1_batch():
    _, _, tm, tp = _models("granite-3-2b", "float32")
    prompt = np.arange(1, 11, dtype=np.int32)
    table = torch.arange(1, 13, dtype=torch.int32)
    batch = {"tokens": torch.from_numpy(np.pad(prompt, (0, 6)))[None],
             "offset": torch.tensor([0], dtype=torch.int32),
             "true_lens": torch.tensor([10], dtype=torch.int32)}
    c1 = tm.init_cache(1, MAX_LEN, page_size=PS, num_pages=N_PAGES)
    c2 = tm.init_cache(1, MAX_LEN, page_size=PS, num_pages=N_PAGES)
    a, c1, _ = tm.prefill_chunk(tp, batch, c1, table)
    b, c2, _ = tm.prefill_chunks(tp, batch, c2, table[None])
    assert torch.equal(a, b)
    assert torch.equal(c1["k_pages"], c2["k_pages"])
    # the attention layer's K=1 entry point: every position real
    p = {k: v[0] for k, v in tp["blocks"]["attn"].items()}
    x = torch.randn(1, 8, tm.cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    pools = [tm.init_cache(1, MAX_LEN, page_size=PS, num_pages=N_PAGES)
             for _ in range(2)]
    y1 = attn_prefill_chunk_paged(p, x, tm.cfg, pools[0]["k_pages"][0],
                                  pools[0]["v_pages"][0], table, 4)
    eight = torch.tensor([4], dtype=torch.int32)
    y2 = attn_prefill_chunks_paged(p, x, tm.cfg, pools[1]["k_pages"][0],
                                   pools[1]["v_pages"][0], table[None],
                                   eight, eight + 8)
    assert torch.equal(y1, y2)
    assert torch.equal(pools[0]["k_pages"], pools[1]["k_pages"])


def test_bf16_leaves_convert_bit_exact():
    import ml_dtypes
    a = np.random.default_rng(0).standard_normal((3, 5)).astype(
        ml_dtypes.bfloat16)
    t = tensor_from_numpy(a, device="cpu")
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.view(torch.int16).numpy(),
                          a.view(np.int16))


def test_convert_refuses_a_dtype_mismatch():
    cfg = get_smoke_config("granite-3-2b")               # bfloat16
    tree = {"tok": {"embed": np.zeros((4, 4), np.float32)}}
    with pytest.raises(TypeError):
        params_from_numpy(tree, cfg, device="cpu")


def test_seeded_init_follows_the_jax_distributions():
    cfg = get_smoke_config("granite-3-2b").replace(
        dtype="float32", d_model=256, d_ff=512, vocab_size=1024)
    m = build_model(cfg, device="cpu")
    first = m.init(seed=3)["tok"]["embed"].clone()
    assert not torch.equal(m.init(seed=4)["tok"]["embed"], first)
    p = m.init(seed=3)
    assert torch.equal(p["tok"]["embed"], first)
    assert abs(float(p["tok"]["embed"].std()) - 0.02) < 1e-3
    wq = p["blocks"]["attn"]["wq"]
    assert wq.shape == (cfg.n_layers, cfg.d_model, cfg.n_heads * cfg.head_dim)
    assert abs(float(wq.std()) - cfg.d_model ** -0.5) < 3e-3
    w_out = p["blocks"]["mlp"]["w_out"]
    assert abs(float(w_out.std()) - cfg.d_ff ** -0.5) < 3e-3
    assert torch.equal(p["final_norm"]["scale"], torch.ones(cfg.d_model))
    assert set(p["blocks"]) == {"n1", "attn", "n2", "mlp"}


# ===========================================================================
# monolithic entry points: forward, dense prefill + decode, paged prefill
# ===========================================================================

MONO_CASES = [("granite-3-2b", "float32"), ("gemma3-4b", "float32"),
              ("granite-3-2b", "bfloat16")]
# real prompt lengths; the gemma3 smoke window is 32, so 37 crosses it
PROMPT_LENS = (37, 21, 5)


def _np32(x):
    return x.float().numpy() if torch.is_tensor(x) \
        else np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, bar):
    np.testing.assert_allclose(_np32(got), _np32(want), atol=bar, rtol=0)


@pytest.mark.parametrize("arch,dtype", MONO_CASES)
def test_forward_matches_jax(arch, dtype):
    logit_bar, _ = BARS[dtype]
    jm, jp, tm, tp = _models(arch, dtype)
    toks = np.random.default_rng(4).integers(
        1, tm.cfg.vocab_size, (2, 40)).astype(np.int32)
    jl, _ = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)})
    tl, aux = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    assert tl.dtype == torch.float32 and tl.shape == (2, 40,
                                                      tm.cfg.vocab_size)
    assert float(aux) == 0.0
    _close(tl, jl, logit_bar)


@pytest.mark.parametrize("arch,dtype", MONO_CASES)
def test_dense_prefill_then_decode_match_jax(arch, dtype):
    logit_bar, cache_bar = BARS[dtype]
    jm, jp, tm, tp = _models(arch, dtype)
    rng = np.random.default_rng(5)
    s_pad = 40
    toks = np.zeros((len(PROMPT_LENS), s_pad), np.int32)
    for r, n in enumerate(PROMPT_LENS):
        toks[r, :n] = rng.integers(1, tm.cfg.vocab_size, n)
    tl_np = np.array(PROMPT_LENS, np.int32)
    jcache = jm.init_cache(len(PROMPT_LENS), MAX_LEN)
    tcache = tm.init_cache(len(PROMPT_LENS), MAX_LEN)
    assert set(tcache) == {"k", "v"} and tcache["k"].shape == \
        (tm.cfg.n_layers, len(PROMPT_LENS), MAX_LEN, tm.cfg.n_kv_heads,
         tm.cfg.head_dim)
    jl, jcache, jlens = jax.jit(jm.prefill)(
        jp, {"tokens": jnp.asarray(toks), "true_lens": jnp.asarray(tl_np)},
        jcache)
    tl, tcache, tlens = tm.prefill(
        tp, {"tokens": torch.from_numpy(toks),
             "true_lens": torch.from_numpy(tl_np)}, tcache)
    assert tlens.tolist() == np.asarray(jlens).tolist() == list(PROMPT_LENS)
    _close(tl, jl, logit_bar)
    for key in ("k", "v"):
        _close(tcache[key], jcache[key], cache_bar)
    # three decode steps; lane 2 is idle (lens 0): it writes position 0 of
    # its own strip and attends over it, in both packages
    lens = np.array([PROMPT_LENS[0], PROMPT_LENS[1], 0], np.int32)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    j_decode = jax.jit(jm.decode_step)
    for _ in range(3):
        jl, jcache = j_decode(jp, jnp.asarray(tok), jnp.asarray(lens),
                              jcache)
        tl, tcache = tm.decode_step(tp, torch.from_numpy(tok),
                                    torch.from_numpy(lens), tcache)
        _close(tl[:2], jl[:2], logit_bar)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        lens = lens + np.array([1, 1, 0], np.int32)
    for key in ("k", "v"):
        _close(tcache[key], jcache[key], cache_bar)


@pytest.mark.parametrize("arch,dtype", MONO_CASES)
def test_paged_prefill_then_decode_match_jax(arch, dtype):
    logit_bar, pool_bar = BARS[dtype]
    jm, jp, tm, tp = _models(arch, dtype)
    rng = np.random.default_rng(6)
    n_real, s_pad = PROMPT_LENS[0], 40                  # 10 pages of 4
    toks = np.zeros((1, s_pad), np.int32)
    toks[0, :n_real] = rng.integers(1, tm.cfg.vocab_size, n_real)
    pages = rng.permutation(np.arange(1, N_PAGES))[:MAX_LEN // PS]
    pages = pages.astype(np.int32)
    page_ids = pages[:s_pad // PS]
    jcache = jm.init_cache(1, MAX_LEN, page_size=PS, num_pages=N_PAGES)
    tcache = tm.init_cache(1, MAX_LEN, page_size=PS, num_pages=N_PAGES)
    true_lens = np.array([n_real], np.int32)
    jl, jcache, jlens = jax.jit(jm.prefill_paged)(
        jp, {"tokens": jnp.asarray(toks),
             "true_lens": jnp.asarray(true_lens)},
        jcache, jnp.asarray(page_ids))
    tl, tcache, tlens = tm.prefill_paged(
        tp, {"tokens": torch.from_numpy(toks),
             "true_lens": torch.from_numpy(true_lens)},
        tcache, torch.from_numpy(page_ids))
    assert tlens.tolist() == np.asarray(jlens).tolist() == [n_real]
    _close(tl, jl, logit_bar)
    t_np = lambda t: t.float().numpy()
    j_np = lambda a: np.asarray(jnp.asarray(a, jnp.float32))
    for got, want in zip(_pools(tcache, t_np), _pools(jcache, j_np)):
        np.testing.assert_allclose(got, want, atol=pool_bar, rtol=0)
    jcache["block_table"] = jnp.asarray(pages[None])
    tcache["block_table"] = torch.from_numpy(pages[None].copy())
    lens = true_lens.copy()
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    j_decode = jax.jit(jm.decode_step)
    for _ in range(2):
        jl, jcache = j_decode(jp, jnp.asarray(tok), jnp.asarray(lens),
                              jcache)
        tl, tcache = tm.decode_step(tp, torch.from_numpy(tok),
                                    torch.from_numpy(lens), tcache)
        _close(tl, jl, logit_bar)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        lens = lens + 1
    for got, want in zip(_pools(tcache, t_np), _pools(jcache, j_np)):
        np.testing.assert_allclose(got, want, atol=pool_bar, rtol=0)
