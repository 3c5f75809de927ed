"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card: the edge cases of test_torch_kernels.py and test_torch_flash.py
(GQA groups 1 / 2 / 4, shuffled block tables, ragged rows, a chunk starting
mid-page, two chunks of one sequence in one batch, dead rows, q_lens pad
lanes, sliding window, softcap; causal and full attention over a length
that is no tile multiple, fewer queries than keys; dense decode lengths 0,
1 and the whole strip, one length for every lane; the FA-2 backward K5
over causal, full, window and softcap attention at S = 200 and 256, and
through autograd) at the kernels' head dims 64 and 128 (K3, K4 and K5
also 80, zamba2's shared attention block; K1-K5 also 256, gemma3-4b's, and
K1 and K2 GQA groups of 7, qwen-7b's 28 / 4 heads; K1-K4 also groups of
16 at head dim 128, qwen3-moe-235b-a22b's 64 / 4 heads; K4 and K5 also
llava-next-34b's 56 / 8 heads of 128, groups of 7, K4 also causal over a
576-position image prefix and its text); K4 and K5 at the
edges of their tensor-core tiles (lengths 1, 15, 17 and 200, fewer
queries than keys,
GQA groups of 1 to 8, a window shorter than one tile, softcap, no key at
all) and K5's bits from call to call; K1 at the edges of its tensor-core
tiles (pages of 16, chunks of 1 to 256 tokens - 5, the speculative verify
rows, among them - starting at a page, mid-page,
mid-tile and at the table's end, ragged rows and q_lens lanes ending inside
a 16-row fragment, two chunks of one sequence, a dead row, GQA groups of 1
to 8, a window shorter than one tile, softcap) and K2 at the edges of its
splits (lengths 0, 1, one split - 1, + 0, + 1, two splits +- 1 and the
whole table, a window that starts inside a split, every group size from 1
to 16), K2's bits alone against inside a batch and from call to call, and
the refusal of misaligned bf16 operands by K1 and K2; K1 (chunk and
verify lanes) and K2 on a head shard of granite-3-2b's 32 / 8 heads of 64
at tp 2 and 4, bit-equal to the same heads of the full call (tensor-
parallel serving); the head-split autograd pair of the sharded train
step (ops.head_sharded_attention: K4 forward and K5 backward on each
rank's 16 / 4 of granite-3-2b's 32 / 8 heads, two ranks of a gloo world
on the card) against the unsharded call, o and the gradients of q, k and
v bit-equal on every rank; K3 at the edges of
its splits (lengths 0, 1, around one and two splits, the whole strip and
past it, a strip that is no split multiple, a window that starts inside a
split, groups of 1 to 16 at head dims 64, 80 and 128), its bits alone
against inside a batch and from call to call at the dense serving shape
and zamba2's decode, and its refusal of misaligned bf16 operands; the
Mamba2 scan K6 and the RWKV6 scan K7 (a sequence shorter than one chunk,
one that is no chunk multiple, batch 1, an odd head count, dt near 0 and
a large dt * A, the decay w = 1 and w at the model's clamp over whole
chunks, w = 1e-3 far below it, u = 0, every state and key size the
kernels take, ragged state rows and columns, K7 over 16 chunks with a
ragged tail and 100 value columns, the full-width shapes of zamba2 and
rwkv6, and the refusal of a direct call autograd would have to
differentiate); the scans' backward kernels K6_bwd and K7_bwd against
their plain versions (float64 autograd through the chunked scans) over
sequences past and short of their 16-step stretches, ragged state rows,
dt near 0 and a large dt * A, the decay w = 1, at the model's clamp and
far below it (held against the naive scan's gradient), u = 0, every
state, key and value size they take and the full-width training shapes
of zamba2 and rwkv6, S of exactly two, one step past one and 1000
clamped steps of the bf16 K7_bwd's 64-step chunks, the S_in carries of
the bf16 K7_bwd bit for bit against K7's own state scan, their bits from
call to call, autograd through
ops.mamba2_scan / ops.rwkv6_scan (one forward and one backward launch),
and their refusals;
and K3, K4 and K5 at whisper-base's shapes (8 heads of 64: K4's full mask
over 4 x 1500 and 1500 x 1500, K3 over a 1500-position strip, K5's full
mask over 64 x 1500), in float32 and bfloat16; K4 at every tile its
source instantiates (core/hopper_mapping.py: three bfloat16 tiles a head
dim, the float32 kernel's one), and its refusal of any other tile.

Needs an NVIDIA GPU and nvcc: every test skips with a reason elsewhere.
Run on the card with
`python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py`.

Bars: float32 within 1e-5 absolute (fp32 math in both, other summation
order).  bfloat16: both compute in float32 from the same bfloat16 values
and round the output once, so within 2**-7 relative plus 1e-6 absolute.
K4 in bfloat16 rounds each softmax weight to bfloat16 before the PV
product, as its plain version does; an fp32 difference of an ulp in a
score can flip that rounding for one weight and move the output by one
bfloat16 step of that weight's term, which exceeds 2**-7 of the output
where the terms cancel (seen on the H100: 4 of 37888 elements, 2.4e-4 at
an output of 0.0055).  Its bar is therefore one rounding step of the
terms' magnitude: 2**-7 x (|o| + the attention of |v|) plus 1e-6.  The
log-sum-exp of K4 is float32 in both dtypes: 1e-5 absolute.  K5 rounds
p and ds to bfloat16 before their products, as its plain version does,
so its bfloat16 bar is the same kind: 2**-7 x (|g| + the magnitude of the
summed terms, ref.flash_attention_bwd(terms=True)) + 1e-6; in float32 its
gradients agree within 1e-5 of the largest |gradient|.  Dead rows, pad
lanes and empty decode lanes are exactly 0.  K6 and K7 in float32 run
the recurrence step by step, in bfloat16 the chunk-parallel matrix form
on the tensor cores (their float32 operands as two bf16 parts,
tests/test_torch_mamba2_parts.py and tests/test_torch_rwkv6_parts.py),
their plain versions the chunked matrix form (cumulative log decays, exp
of their differences; below the clamp, where K7's chunked plain version
overflows, K7 is held against the naive step-by-step scan): in float32 they
agree within 1e-5 of the largest term - `terms` is the plain scan of the
inputs' absolute values, the magnitude of the summed terms - and in
bfloat16 within one rounding step of the output, 2**-7 x |y|, plus that
float32 bar.  The scans' backward kernels: each gradient within 1e-5 of
its largest element or of its largest term (the plain backward of the
absolute values; ddt's two terms, of opposite signs there, added as
magnitudes), and a bfloat16 gradient also within 2**-7 x (|want| +
terms) - in float32 the kernel's ddt was seen past 1e-5 of its largest
element only at dt * A ~10-20 a step (1.9e-5 of it on an H100), where
ddt's terms cancel.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch.core import hopper_mapping
from repro_torch.kernels import build, flash_attention, flash_backward
from repro_torch.kernels import flash_decode
from repro_torch.kernels import mamba2_scan, ops, rwkv6_scan
from repro_torch.kernels import paged_prefill

pytestmark = pytest.mark.cuda

S, HKV, PS, N_PAGES, N_MAX = 8, 2, 4, 40, 8
# (head dim, GQA group) of qwen3-moe-235b-a22b: 64 query heads over 4 KV
# heads of 128, MAX_GROUP of the decode kernels
QWEN3_MOE = (128, 16)
# llava-next-34b's attention: 56 query heads over 8 KV heads of 128 (G 7)
LLAVA = dict(D=128, G=7, hkv=8)
VARIANTS = {"plain": (0, 0.0), "window": (5, 0.0), "softcap": (0, 2.0),
            "qlens": (0, 0.0)}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the hand-written kernels run only on "
                    "the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    if dtype == torch.bfloat16:
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _close_terms(got, want, terms):
    """bfloat16 K4 output: within 2**-7 x (|want| + terms) + 1e-6, where
    terms is the plain attention of |v| (the magnitude of the summed
    terms p_i |v_i| / l)."""
    got, want = got.float().cpu(), want.float().cpu()
    bar = 2.0 ** -7 * (want.abs() + terms.float().cpu()) + 1e-6
    bad = (got - want).abs() > bar
    assert not bool(bad.any()), (
        f"{int(bad.sum())} elements past the bar, max abs err "
        f"{float((got - want).abs().max()):.3e}")


def _prefill_case(G, D, dev, dtype, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(dev, dtype)
    k, v = f(N_PAGES, PS, HKV, D), f(N_PAGES, PS, HKV, D)
    q = f(6, S, HKV * G, D)
    perm = rng.permutation(np.arange(1, N_PAGES)).astype(np.int32)
    tables = np.zeros((6, N_MAX), np.int32)
    tables[0, :6] = perm[:6]
    tables[1, :8] = perm[6:14]
    tables[2, :4] = perm[14:18]
    tables[4, :5] = perm[18:23]
    tables[5] = tables[4]
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)
    return (q, k, v, i32(tables), i32([4, 17, 0, 0, 0, 8]),
            i32([12, 20, 8, 0, 8, 16]), i32([8, 2, 8, 0, 8, 5]))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("G", [1, 2, 4, 7])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_prefill_kernel_matches_plain(dev, D, G, variant, dtype):
    dt = DTYPES[dtype]
    q, k, v, tb, off, tl, ql = _prefill_case(G, D, dev, dt)
    ql = ql if variant == "qlens" else None
    window, softcap = VARIANTS[variant]
    n0 = paged_prefill.launches
    got = ops.batched_paged_prefill_attention(
        q, k, v, tb, off, tl, ql, window=window, logit_softcap=softcap)
    want = ops.batched_paged_prefill_attention(
        q, k, v, tb, off, tl, ql, window=window, logit_softcap=softcap,
        impl="ref")
    torch.cuda.synchronize()
    assert paged_prefill.launches == n0 + 1
    _close(got, want, dt)
    lanes = (ql if ql is not None else torch.clamp(tl - off, 0, S)).cpu()
    for r in range(6):
        assert not got[r, int(lanes[r]):].any(), f"row {r} pad lanes"
    assert not got[3].any(), "dead row not zero"


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_kernel_matches_plain_at_group_16(dev, variant, dtype):
    test_prefill_kernel_matches_plain(dev, *QWEN3_MOE, variant, dtype)


def _decode_case(G, D, dev, dtype, seed=1):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(dev, dtype)
    k, v = f(N_PAGES, PS, HKV, D), f(N_PAGES, PS, HKV, D)
    q = f(5, 1, HKV * G, D)
    perm = rng.permutation(np.arange(1, N_PAGES)).astype(np.int32)
    bt = np.zeros((5, N_MAX), np.int32)
    bt[0, :1], bt[1, :4], bt[2, :8], bt[3, :1] = (perm[:1], perm[1:5],
                                                  perm[5:13], perm[13:14])
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)
    return q, k, v, i32(bt), i32([3, 14, 32, 4, 0])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("variant", ["plain", "window", "softcap"])
@pytest.mark.parametrize("G", [1, 2, 4, 7])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_decode_kernel_matches_plain(dev, D, G, variant, dtype):
    dt = DTYPES[dtype]
    q, k, v, bt, lens = _decode_case(G, D, dev, dt)
    window, softcap = VARIANTS[variant]
    n0 = flash_decode.launches
    got = ops.paged_flash_decode(q, k, v, bt, lens, window=window,
                                 logit_softcap=softcap)
    want = ops.paged_flash_decode(q, k, v, bt, lens, window=window,
                                  logit_softcap=softcap, impl="ref")
    torch.cuda.synchronize()
    assert flash_decode.launches == n0 + 1
    _close(got, want, dt)
    assert not got[4].any(), "idle lane (length 0) not zero"


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("variant", ["plain", "window", "softcap"])
def test_decode_kernel_matches_plain_at_group_16(dev, variant, dtype):
    test_decode_kernel_matches_plain(dev, *QWEN3_MOE, variant, dtype)


# granite-3-2b's attention at its serving shapes: 32 query heads over 8 KV
# heads of 64 in a pool of 1025 pages of 16, table rows of 128 pages
GRANITE_POOL = dict(hq=32, hkv=8, D=64, pages=1025, ps=16, n_max=128)


def _granite_lanes(dev, dtype, seed=3):
    """(pools, {lane: kernel call on (q, k_pages, v_pages)}): K1's chunk
    lane on (4, 256) queries (a first chunk, a ragged final one, a mid-
    prompt one and a dead row), its verify lane on (8, 5) draft rows with
    ragged q_lens, and K2 on (8, 1), lengths spread over the table."""
    g = GRANITE_POOL
    gen = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev,
                                 dtype=torch.float32).to(dtype)
    k, v = (rnd(g["pages"], g["ps"], g["hkv"], g["D"]) for _ in range(2))
    perm = torch.randperm(g["pages"] - 1, generator=gen, device=dev) + 1
    tables = perm[:8 * g["n_max"]].to(torch.int32).reshape(8, -1)
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)
    chunk_tables = tables[:4].clone()
    chunk_tables[3] = 0
    lens = i32([38, 129, 301, 512, 701, 0, 1501, 1932])
    q_lens = i32([5, 1, 3, 5, 2, 1, 4, 5])
    q1 = rnd(4, 256, g["hq"], g["D"])
    qv = rnd(8, 5, g["hq"], g["D"])
    q2 = rnd(8, 1, g["hq"], g["D"])
    lanes = {
        "chunk": (q1, lambda q, kp, vp: ops.batched_paged_prefill_attention(
            q, kp, vp, chunk_tables, i32([0, 256, 1536, 0]),
            i32([256, 300, 1792, 0]))),
        "verify": (qv, lambda q, kp, vp: ops.batched_paged_prefill_attention(
            q, kp, vp, tables, lens, lens + q_lens, q_lens)),
        "decode": (q2, lambda q, kp, vp: ops.paged_flash_decode(
            q, kp, vp, tables, lens)),
    }
    return k, v, lanes


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("lane", ["chunk", "verify", "decode"])
def test_head_shard_is_bit_equal_to_the_full_heads(dev, lane, dtype, tp):
    """Tensor-parallel serving runs K1 (both lanes) and K2 on a rank's
    contiguous block of heads - query heads [r Hq / tp, (r + 1) Hq / tp)
    over KV heads [r Hkv / tp, (r + 1) Hkv / tp), G unchanged - made
    contiguous.  No per-head result may depend on how many heads the call
    has: each shard's output equals the same heads of the full call, bit
    for bit (the single-process half of chip_smoke.py's phase_m10)."""
    k, v, lanes = _granite_lanes(dev, DTYPES[dtype])
    q, call = lanes[lane]
    full = call(q, k, v)
    hq, hkv = q.shape[2] // tp, k.shape[2] // tp
    for r in range(tp):
        got = call(q[:, :, r * hq:(r + 1) * hq].contiguous(),
                   k[:, :, r * hkv:(r + 1) * hkv].contiguous(),
                   v[:, :, r * hkv:(r + 1) * hkv].contiguous())
        want = full[:, :, r * hq:(r + 1) * hq]
        assert torch.equal(got, want), \
            (r, float((got.float() - want.float()).abs().max()))


HEADS_TP = 2
HEADS_JOIN_S = 300


@pytest.fixture(scope="module")
def head_split_ranks(dev, tmp_path_factory):
    """The head-split cases run by HEADS_TP ranks on the card, each a
    process of its own (tests/torch_mesh_worker.py, a gloo world: NCCL
    refuses two ranks on one device): the inputs, and each rank's o and
    gradients."""
    d = str(tmp_path_factory.mktemp("heads"))
    rng = np.random.default_rng(5)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    cases = {f"{dt}": dict(q=f(1, 256, 32, 64), k=f(1, 256, 8, 64),
                           v=f(1, 256, 8, 64), do=f(1, 256, 32, 64))
             for dt in ("f32", "bf16")}
    np.savez(os.path.join(d, "inputs.npz"),
             **{f"{c}.{k}": v for c, a in cases.items() for k, v in a.items()})
    with open(os.path.join(d, "jobs.json"), "w") as fh:
        json.dump({"cuda": True, "jobs": [
            {"name": "heads", "kind": "heads", "cases": sorted(cases),
             "inputs": os.path.join(d, "inputs.npz")}]}, fh)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=f"{root}/src:{root}/tests")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(root, "tests", "torch_mesh_worker.py"),
         str(r), str(HEADS_TP), os.path.join(d, "store"),
         os.path.join(d, "jobs.json"), d], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(HEADS_TP)]
    t0 = time.monotonic()
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(
                timeout=max(t0 + HEADS_JOIN_S - time.monotonic(), 1))[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"the head-split ranks did not finish in "
                        f"{HEADS_JOIN_S} s")
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    ranks = []
    for r in range(HEADS_TP):
        with np.load(os.path.join(d, f"rank{r}.npz")) as z:
            ranks.append({k: z[k] for k in z.files})
    return cases, ranks


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_head_split_autograd_pair_matches_the_unsharded_call(
        dev, head_split_ranks, dtype):
    """The sharded train step's attention on the model axis: each of two
    ranks runs K4 on its 16 query / 4 KV heads of granite-3-2b's 32 / 8
    (G 4, head dim 64, causal over 256 positions) and K5 on the same
    shard; the gather's backward takes the rank's head slice of do, the
    split's backward all-gathers the head slices of dq, dk and dv.  Each
    rank's o and gradients equal the unsharded ops.flash_attention's
    through autograd bit for bit: a shard runs the same per-head work (no
    KV head is split between ranks) and the pair only moves data."""
    cases, ranks = head_split_ranks
    a = cases[dtype]
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    q, k, v = (torch.from_numpy(a[x]).to(dev, dt).requires_grad_(True)
               for x in ("q", "k", "v"))
    n4, n5 = flash_attention.launches, flash_backward.launches
    o = ops.flash_attention(q, k, v, causal=True)
    o.backward(torch.from_numpy(a["do"]).to(dev, dt))
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_backward.launches) == \
        (n4 + 1, n5 + 1)
    want = {"o": o, "dq": q.grad, "dk": k.grad, "dv": v.grad}
    for r, got in enumerate(ranks):
        for name, w in want.items():
            g = got[f"{dtype}.{name}"]
            w = w.detach().float().cpu().numpy()
            assert np.array_equal(g, w), \
                (r, name, float(np.abs(g - w).max()))


@pytest.mark.parametrize("D", [64, 128, 256])
def test_single_row_wrapper_runs_the_kernel(dev, D):
    q, k, v, tb, off, tl, _ = _prefill_case(4, D, dev, torch.float32)
    n0 = paged_prefill.launches
    got = ops.paged_prefill_attention(q[:1], k, v, tb[0], int(off[0]))
    want = ops.paged_prefill_attention(q[:1], k, v, tb[0], int(off[0]),
                                       impl="ref")
    torch.cuda.synchronize()
    assert paged_prefill.launches == n0 + 1
    _close(got, want, torch.float32)


def test_kernels_refuse_what_they_do_not_take(dev):
    q, k, v, tb, off, tl, ql = _prefill_case(2, 64, dev, torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        ops.batched_paged_prefill_attention(q[..., :32].contiguous(),
                                            k[..., :32].contiguous(),
                                            v[..., :32].contiguous(), tb,
                                            off, tl)
    with pytest.raises(ValueError, match="int32"):
        ops.batched_paged_prefill_attention(q, k, v, tb.long(), off, tl)
    with pytest.raises(ValueError):
        ops.batched_paged_prefill_attention(q, k.to(torch.bfloat16), v, tb,
                                            off, tl)
    qd, kd, vd, bt, lens = _decode_case(2, 64, dev, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        ops.paged_flash_decode(qd, kd.transpose(1, 2).contiguous()
                               .transpose(1, 2), vd, bt, lens)


# ---------------------------------------------------------------------------
# K4 flash_attention_fwd and K3 dense flash_decode
# ---------------------------------------------------------------------------

# (causal, window, softcap, Sq, Skv) per variant
FA_VARIANTS = {"causal": (True, 0, 0.0, 37, 37),
               "full": (False, 0, 0.0, 37, 37),
               "window": (True, 8, 0.0, 37, 37),
               "softcap": (True, 0, 30.0, 37, 37),
               "short_q": (True, 0, 0.0, 20, 37)}


def _randn(rng, dev, dtype, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(dev, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("variant", list(FA_VARIANTS))
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("D", [64, 80, 128, 256])
def test_flash_attention_kernel_matches_plain(dev, D, G, variant, dtype,
                                             hkv=HKV):
    dt = DTYPES[dtype]
    causal, window, softcap, sq, skv = FA_VARIANTS[variant]
    rng = np.random.default_rng(2)
    q = _randn(rng, dev, dt, 2, sq, hkv * G, D)
    k, v = _randn(rng, dev, dt, 2, skv, hkv, D), _randn(rng, dev, dt, 2, skv,
                                                        hkv, D)
    kw = dict(causal=causal, window=window, logit_softcap=softcap)
    n0 = flash_attention.launches
    o, lse = flash_attention.flash_attention_fwd(q, k, v, **kw)
    o_ref, lse_ref = flash_attention.reference(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1
    assert o.dtype == dt and lse.dtype == torch.float32
    assert lse.shape == (2, sq, hkv * G)
    if dt == torch.bfloat16:
        _close_terms(o, o_ref, flash_attention.reference(q, k, v.abs(),
                                                         **kw)[0])
    else:
        _close(o, o_ref, dt)
    _close(lse, lse_ref, torch.float32)
    got = ops.flash_attention(q, k, v, **kw)
    assert flash_attention.launches == n0 + 2 and torch.equal(got, o)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("variant", list(FA_VARIANTS))
def test_flash_attention_kernel_matches_plain_at_group_16(dev, variant,
                                                          dtype):
    test_flash_attention_kernel_matches_plain(dev, *QWEN3_MOE, variant,
                                              dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("variant", list(FA_VARIANTS))
def test_flash_attention_kernel_matches_plain_at_llava_heads(dev, variant,
                                                             dtype):
    test_flash_attention_kernel_matches_plain(dev, variant=variant,
                                              dtype=dtype, **LLAVA)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_kernel_over_an_image_prefix(dev, dtype):
    """llava's prefill: causal over 576 image positions and 40 text
    tokens, one row cut short of a tile."""
    dt = DTYPES[dtype]
    rng = np.random.default_rng(9)
    D, G, hkv = LLAVA["D"], LLAVA["G"], LLAVA["hkv"]
    q = _randn(rng, dev, dt, 2, 616, hkv * G, D)
    k, v = _randn(rng, dev, dt, 2, 616, hkv, D), _randn(rng, dev, dt, 2,
                                                        616, hkv, D)
    o, lse = flash_attention.flash_attention_fwd(q, k, v, causal=True)
    o_ref, lse_ref = flash_attention.reference(q, k, v, causal=True)
    if dt == torch.bfloat16:
        _close_terms(o, o_ref, flash_attention.reference(q, k, v.abs(),
                                                         causal=True)[0])
    else:
        _close(o, o_ref, dt)
    _close(lse, lse_ref, torch.float32)


DECODE_LENS = [0, 1, 40, 23]
# (window, softcap, one length for every lane) per variant
FD_VARIANTS = {"plain": (0, 0.0, None), "window": (8, 0.0, None),
               "softcap": (0, 30.0, None), "scalar": (0, 0.0, 17)}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("variant", list(FD_VARIANTS))
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("D", [64, 80, 128, 256])
def test_dense_decode_kernel_matches_plain(dev, D, G, variant, dtype):
    dt = DTYPES[dtype]
    window, softcap, scalar = FD_VARIANTS[variant]
    rng = np.random.default_rng(3)
    q = _randn(rng, dev, dt, 4, 1, HKV * G, D)
    k, v = _randn(rng, dev, dt, 4, 40, HKV, D), _randn(rng, dev, dt, 4, 40,
                                                       HKV, D)
    lens = scalar if scalar is not None else torch.tensor(
        DECODE_LENS, dtype=torch.int32, device=dev)
    kw = dict(window=window, logit_softcap=softcap)
    n0, n2 = flash_decode.dense_launches, flash_decode.launches
    got = ops.flash_decode(q, k, v, lens, **kw)
    want = ops.flash_decode(q, k, v, lens, impl="ref", **kw)
    torch.cuda.synchronize()
    assert flash_decode.dense_launches == n0 + 1
    assert flash_decode.launches == n2, "K3 counted as K2"
    _close(got, want, dt)
    if scalar is None:
        assert not got[0].any(), "empty lane (length 0) not zero"


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("variant", list(FD_VARIANTS))
def test_dense_decode_kernel_matches_plain_at_group_16(dev, variant, dtype):
    test_dense_decode_kernel_matches_plain(dev, *QWEN3_MOE, variant, dtype)


def test_flash_kernels_refuse_what_they_do_not_take(dev):
    rng = np.random.default_rng(4)
    q = _randn(rng, dev, torch.float32, 2, 8, 4, 64)
    k = _randn(rng, dev, torch.float32, 2, 8, 2, 64)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention.flash_attention_fwd(
            q[..., :32].contiguous(), k[..., :32].contiguous(),
            k[..., :32].contiguous())
    with pytest.raises(ValueError, match="batch"):
        flash_attention.flash_attention_fwd(q, k[:1], k[:1])
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention.flash_attention_fwd(q, k.transpose(1, 2).contiguous()
                                            .transpose(1, 2), k)
    with pytest.raises(ValueError):
        flash_attention.flash_attention_fwd(q, k.to(torch.bfloat16), k)
    qd = q[:, :1].contiguous()
    lens = torch.tensor([3, 5], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="int32"):
        flash_decode.flash_decode(qd, k, k, lens.long())
    with pytest.raises(ValueError, match="one query token"):
        flash_decode.flash_decode(q, k, k, lens)
    with pytest.raises(ValueError, match="at most"):
        flash_decode.flash_decode(
            _randn(rng, dev, torch.float32, 2, 1, 34, 64),
            k[:, :, :1].contiguous(), k[:, :, :1].contiguous(), lens)


# ---------------------------------------------------------------------------
# K5 flash_attention_bwd
# ---------------------------------------------------------------------------

# (causal, window, softcap) per variant
BWD_VARIANTS = {"causal": (True, 0, 0.0), "full": (False, 0, 0.0),
                "window": (True, 48, 0.0), "softcap": (True, 0, 25.0)}


def bwd_close(got, want, terms, dtype, names=("dq", "dk", "dv")):
    """K5 against its plain version: float32 within 1e-5 of the largest
    |gradient|; bfloat16 within one rounding step of the summed terms'
    magnitude, 2**-7 x (|want| + terms) + 1e-6 (terms from
    ref.flash_attention_bwd(terms=True)): both round p and ds to bfloat16
    before their products, and an ulp of difference in a score can flip
    one of those roundings."""
    for name, g, w, t in zip(names, got, want, terms):
        g, w = g.float().cpu(), w.float().cpu()
        err = (g - w).abs()
        if dtype == torch.bfloat16:
            bar = 2.0 ** -7 * (w.abs() + t.float().cpu()) + 1e-6
        else:
            bar = torch.full_like(w, 1e-5 * float(w.abs().max()))
        bad = err > bar
        assert not bool(bad.any()), (
            f"{name}: {int(bad.sum())} elements past the bar, max abs err "
            f"{float(err.max()):.3e} (max |{name}| {float(w.abs().max()):.3e})")


@pytest.mark.parametrize("S", [200, 256])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("variant", list(BWD_VARIANTS))
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("D", [64, 80, 128, 256])
def test_flash_backward_kernel_matches_plain(dev, D, G, variant, dtype, S,
                                             hkv=HKV):
    dt = DTYPES[dtype]
    causal, window, softcap = BWD_VARIANTS[variant]
    rng = np.random.default_rng(5)
    q = _randn(rng, dev, dt, 2, S, hkv * G, D)
    k, v = _randn(rng, dev, dt, 2, S, hkv, D), _randn(rng, dev, dt, 2, S,
                                                      hkv, D)
    do = _randn(rng, dev, dt, 2, S, hkv * G, D)
    kw = dict(causal=causal, window=window, logit_softcap=softcap)
    o, lse = flash_attention.flash_attention_fwd(q, k, v, **kw)
    n0 = flash_backward.launches
    got = flash_backward.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = flash_backward.reference(q, k, v, o, lse, do, **kw)
    terms = flash_backward.reference(q, k, v, o, lse, do, terms=True, **kw)
    torch.cuda.synchronize()
    assert flash_backward.launches == n0 + 1
    assert [g.dtype for g in got] == [dt] * 3
    bwd_close(got, want, terms, dt)
    # the same bits again: no atomics, one summation order
    again = flash_backward.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("S", [200, 256])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("variant", list(BWD_VARIANTS))
def test_flash_backward_kernel_matches_plain_at_llava_heads(dev, variant,
                                                            dtype, S):
    test_flash_backward_kernel_matches_plain(dev, variant=variant,
                                             dtype=dtype, S=S, **LLAVA)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_autograd_runs_k4_then_k5(dev, dtype):
    """A gradient through ops.flash_attention on CUDA tensors launches K4
    once and K5 once, and equals the plain rule's gradient."""
    dt = DTYPES[dtype]
    rng = np.random.default_rng(6)
    q = _randn(rng, dev, dt, 2, 100, 8, 64).requires_grad_(True)
    k = _randn(rng, dev, dt, 2, 100, 2, 64).requires_grad_(True)
    v = _randn(rng, dev, dt, 2, 100, 2, 64).requires_grad_(True)
    do = _randn(rng, dev, dt, 2, 100, 8, 64)
    n4, n5 = flash_attention.launches, flash_backward.launches
    o = ops.flash_attention(q, k, v)
    got = torch.autograd.grad(o, (q, k, v), do)
    torch.cuda.synchronize()
    assert flash_attention.launches == n4 + 1
    assert flash_backward.launches == n5 + 1
    o_r, lse_r = flash_attention.flash_attention_fwd(q.detach(), k.detach(),
                                                     v.detach())
    args = (q.detach(), k.detach(), v.detach(), o_r, lse_r, do)
    bwd_close(got, flash_backward.reference(*args),
              flash_backward.reference(*args, terms=True), dt)


def test_flash_backward_refuses_what_it_does_not_take(dev):
    rng = np.random.default_rng(7)
    q = _randn(rng, dev, torch.float32, 2, 8, 4, 64)
    k = _randn(rng, dev, torch.float32, 2, 8, 2, 64)
    o, lse = flash_attention.flash_attention_fwd(q, k, k)
    with pytest.raises(ValueError, match="do must be"):
        flash_backward.flash_attention_bwd(q, k, k, o, lse,
                                           q.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        flash_backward.flash_attention_bwd(
            q, k, k, o, lse, q.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="lse"):
        flash_backward.flash_attention_bwd(q, k, k, o, lse[:, :4], q)
    for d in (32, 96):     # K5 takes 64, 80, 128 and 256
        with pytest.raises(ValueError, match="head dim"):
            t = torch.nn.functional.pad(q, (0, d - 64)) if d > 64 \
                else q[..., :d].contiguous()
            kt = torch.nn.functional.pad(k, (0, d - 64)) if d > 64 \
                else k[..., :d].contiguous()
            flash_backward.flash_attention_bwd(t, kt, kt, t, lse, t)


# ---------------------------------------------------------------------------
# K4 and K5 at the edges of the tensor-core tiles (16-row mma fragments,
# 64-row blocks, 64-position KV tiles)
# ---------------------------------------------------------------------------

# (Sq, Skv): lengths that are no multiple of 16 or 64, one query, fewer
# queries than keys (the causal mask aligned at the top left), and Skv = 0,
# where every row is masked
EDGE_LENS = [(1, 1), (1, 200), (15, 17), (17, 200), (200, 200), (15, 0)]
# (causal, window, softcap): the window is shorter than one 16-row fragment
EDGE_VARIANTS = {"causal": (True, 0, 0.0), "full": (False, 0, 0.0),
                 "window": (True, 5, 0.0), "softcap": (True, 0, 30.0)}
# (D, G): every group size at head dim 64, then the other head dims
FWD_EDGE_DG = [(64, 1), (64, 2), (64, 4), (64, 8), (80, 2), (128, 2),
               (256, 2)]
BWD_EDGE_DG = [(64, 1), (64, 2), (64, 4), (64, 8), (80, 1), (128, 2),
               (256, 2)]


# K4 at every tile the source instantiates (core/hopper_mapping.py
# K4_TILES for bfloat16, f32_tile for float32), given explicitly: lengths
# across several tiles of either size, fewer queries than keys
TILE_CASES = [(dtype, D, tile) for D in sorted(hopper_mapping.K4_TILES)
              for dtype, tiles in (
                  ("bfloat16", hopper_mapping.K4_TILES[D]),
                  ("float32", (hopper_mapping.f32_tile(D),)))
              for tile in tiles]


@pytest.mark.parametrize("lens", [(200, 200), (70, 300)],
                         ids=lambda x: f"{x[0]}x{x[1]}")
@pytest.mark.parametrize("variant", ["causal", "full", "window", "softcap"])
@pytest.mark.parametrize("case", TILE_CASES,
                         ids=lambda c: f"{c[0]}-D{c[1]}-{c[2][0]}x{c[2][1]}")
def test_flash_attention_kernel_at_every_tile(dev, case, variant, lens):
    """K4 launched at each instantiated (block_q, block_kv), against its
    plain version at the bars of test_flash_attention_kernel_matches_plain
    (window 40: shorter than every KV tile but one)."""
    dtype, D, (bq, bkv) = case
    dt = DTYPES[dtype]
    causal, window, softcap = {"causal": (True, 0, 0.0),
                               "full": (False, 0, 0.0),
                               "window": (True, 40, 0.0),
                               "softcap": (True, 0, 30.0)}[variant]
    sq, skv = lens
    _, q, k, v = _edge_case(dev, dt, D, 2, sq, skv, seed=12)
    kw = dict(causal=causal, window=window, logit_softcap=softcap)
    n0 = flash_attention.launches
    o, lse = flash_attention.flash_attention_fwd(q, k, v, block_q=bq,
                                                 block_kv=bkv, **kw)
    o_ref, lse_ref = flash_attention.reference(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1
    if dt == torch.bfloat16:
        _close_terms(o, o_ref, flash_attention.reference(q, k, v.abs(),
                                                         **kw)[0])
    else:
        _close(o, o_ref, dt)
    _close(lse, lse_ref, torch.float32)


def test_flash_attention_refuses_a_tile_it_does_not_instantiate(dev):
    q = torch.zeros(1, 64, 4, 64, device=dev, dtype=torch.bfloat16)
    k = torch.zeros(1, 64, 2, 64, device=dev, dtype=torch.bfloat16)
    n0 = flash_attention.launches
    for bq, bkv in ((64, 128), (32, 32), (128, 128), (256, 64)):
        with pytest.raises(ValueError, match="instantiates"):
            flash_attention.flash_attention_fwd(q, k, k, block_q=bq,
                                                block_kv=bkv)
    with pytest.raises(ValueError, match="instantiates"):
        flash_attention.flash_attention_fwd(q.float(), k.float(), k.float(),
                                            block_q=128, block_kv=64)
    assert flash_attention.launches == n0


def _edge_case(dev, dt, D, G, sq, skv, seed):
    rng = np.random.default_rng(seed)
    q = _randn(rng, dev, dt, 2, sq, HKV * G, D)
    k = _randn(rng, dev, dt, 2, skv, HKV, D)
    v = _randn(rng, dev, dt, 2, skv, HKV, D)
    return rng, q, k, v


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("variant", list(EDGE_VARIANTS))
@pytest.mark.parametrize("lens", EDGE_LENS, ids=lambda x: f"{x[0]}x{x[1]}")
@pytest.mark.parametrize("dg", FWD_EDGE_DG, ids=lambda x: f"D{x[0]}G{x[1]}")
def test_flash_attention_kernel_at_tile_edges(dev, dg, lens, variant, dtype):
    """K4 against its plain version at the bars of
    test_flash_attention_kernel_matches_plain; rows with no key to attend
    (Skv = 0) give o = 0 exactly and lse = -1e30, as the plain version."""
    dt = DTYPES[dtype]
    (D, G), (sq, skv) = dg, lens
    causal, window, softcap = EDGE_VARIANTS[variant]
    _, q, k, v = _edge_case(dev, dt, D, G, sq, skv, seed=8)
    kw = dict(causal=causal, window=window, logit_softcap=softcap)
    n0 = flash_attention.launches
    o, lse = flash_attention.flash_attention_fwd(q, k, v, **kw)
    o_ref, lse_ref = flash_attention.reference(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1
    assert o.shape == q.shape and lse.shape == (2, sq, HKV * G)
    if dt == torch.bfloat16:
        _close_terms(o, o_ref, flash_attention.reference(q, k, v.abs(),
                                                         **kw)[0])
    else:
        _close(o, o_ref, dt)
    _close(lse, lse_ref, torch.float32)
    if skv == 0:
        assert not o.any(), "fully masked rows not exactly 0"


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("variant", list(EDGE_VARIANTS))
@pytest.mark.parametrize("lens", EDGE_LENS, ids=lambda x: f"{x[0]}x{x[1]}")
@pytest.mark.parametrize("dg", BWD_EDGE_DG, ids=lambda x: f"D{x[0]}G{x[1]}")
def test_flash_backward_kernel_at_tile_edges(dev, dg, lens, variant, dtype):
    """K5 against its plain version at the bars of bwd_close, o and lse from
    K4; with Skv = 0 dq is exactly 0 and dk, dv are empty; where every row
    attends one key, dq and dk are rounding noise (single_key_close)."""
    dt = DTYPES[dtype]
    (D, G), (sq, skv) = dg, lens
    causal, window, softcap = EDGE_VARIANTS[variant]
    rng, q, k, v = _edge_case(dev, dt, D, G, sq, skv, seed=9)
    do = _randn(rng, dev, dt, 2, sq, HKV * G, D)
    kw = dict(causal=causal, window=window, logit_softcap=softcap)
    o, lse = flash_attention.flash_attention_fwd(q, k, v, **kw)
    n0 = flash_backward.launches
    got = flash_backward.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = flash_backward.reference(q, k, v, o, lse, do, **kw)
    terms = flash_backward.reference(q, k, v, o, lse, do, terms=True, **kw)
    torch.cuda.synchronize()
    assert flash_backward.launches == n0 + 1
    assert [g.shape for g in got] == [q.shape, k.shape, v.shape]
    if skv == 0:
        assert not got[0].any(), "dq of fully masked rows not exactly 0"
        return
    if skv == 1 or (sq == 1 and causal):
        single_key_close(got, want, terms, q, k, o, do, dt)
        return
    bwd_close(got, want, terms, dt)


def single_key_close(got, want, terms, q, k, o, do, dtype):
    """K5 where every query row attends one key: o is that key's v, so ds =
    p (dp - delta) and with it dq and dk are 0 in exact arithmetic, and
    each version returns the float32 rounding of that cancellation.  dq and
    dk are held within 1e-5 of the cancelled terms' magnitude (scale x
    max sum_d |do o| x max |k| for dq, x max |q| x the rows per KV head
    for dk), plus one bfloat16 step of the value in bfloat16; dv as
    bwd_close holds it."""
    B, Sq, Hq, D = q.shape
    cancelled = float((do.float() * o.float()).abs().sum(-1).max()) / D ** 0.5
    rows = Sq * (Hq // k.shape[2])
    for name, g, w, other in (("dq", got[0], want[0], k),
                              ("dk", got[1], want[1], q)):
        g, w = g.float().cpu(), w.float().cpu()
        bar = 1e-5 * cancelled * float(other.float().abs().max()) \
            * (rows if name == "dk" else 1)
        if dtype == torch.bfloat16:
            bar = bar + 2.0 ** -7 * w.abs()
        err = (g - w).abs()
        assert bool((err <= bar).all()), (
            f"{name}: max abs err {float(err.max()):.3e} past the rounding "
            f"bar of a single attended key")
    bwd_close(got[2:], want[2:], terms[2:], dtype, names=("dv",))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("variant", ["causal", "full"])
@pytest.mark.parametrize("D", [64, 80, 128, 256])
def test_flash_backward_is_bit_deterministic(dev, D, variant, dtype):
    """Three K5 calls on the same inputs give the same bits in dq, dk and
    dv: no atomics, one summation order (remat and resume rely on it)."""
    dt = DTYPES[dtype]
    rng = np.random.default_rng(10)
    q = _randn(rng, dev, dt, 2, 700, 16, D)
    k, v = _randn(rng, dev, dt, 2, 700, 4, D), _randn(rng, dev, dt, 2, 700,
                                                      4, D)
    do = _randn(rng, dev, dt, 2, 700, 16, D)
    kw = dict(causal=variant == "causal")
    o, lse = flash_attention.flash_attention_fwd(q, k, v, **kw)
    first = flash_backward.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    for _ in range(2):
        again = flash_backward.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        for name, a, b in zip(("dq", "dk", "dv"), first, again):
            assert torch.equal(a, b), f"{name}: not the same bits"


def test_bf16_flash_kernels_refuse_misaligned_operands(dev):
    """The bf16 K4 and K5 move operands 16 bytes at a time (cp.async): a
    contiguous tensor that starts 2 bytes past a 16-byte boundary is
    refused with cudaErrorMisalignedAddress (716), not read wrongly."""
    rng = np.random.default_rng(11)
    q = _randn(rng, dev, torch.bfloat16, 1, 17, 4, 64)
    k = _randn(rng, dev, torch.bfloat16, 1, 17, 2, 64)
    shifted = torch.empty(q.numel() + 8, dtype=q.dtype, device=dev)
    odd = shifted[1:1 + q.numel()].view(q.shape)
    odd.copy_(q)
    assert odd.is_contiguous() and odd.data_ptr() % 16
    with pytest.raises(RuntimeError, match="cudaError_t 716"):
        flash_attention.flash_attention_fwd(odd, k, k)
    o, lse = flash_attention.flash_attention_fwd(q, k, k)
    with pytest.raises(RuntimeError, match="cudaError_t 716"):
        flash_backward.flash_attention_bwd(odd, k, k, o, lse, q)


# ---------------------------------------------------------------------------
# K1 at the edges of its tensor-core tiles, K2 at the edges of its splits
# ---------------------------------------------------------------------------

# K1: pages of 16, table rows of 48 pages (768 positions)
K1_PS, K1_NMAX, K1_PAGES = 16, 48, 256
# 5: the speculative verify launch's rows (spec_k + 1, ragged q_lens)
K1_CHUNKS = [1, 5, 15, 17, 64, 200, 256]
# (window, softcap, explicit q_lens) per variant: the window is shorter
# than one 64-position tile
K1_EDGE_VARIANTS = {"causal": (0, 0.0, False), "window": (37, 0.0, False),
                    "softcap": (0, 30.0, False), "qlens": (0, 0.0, True)}


def _k1_edge_case(dev, dt, D, G, S, seed):
    """Seven chunk rows of S tokens: a first chunk; one starting mid-page
    (7); a ragged final chunk starting mid-tile (100); a dead row; two
    consecutive chunks of one sequence sharing its table row (64, 64 + S);
    one whose prefix is exactly the table's n_max * page_size.  q_lens (for
    the qlens variant) end inside 16-row m-tiles where they can."""
    rng = np.random.default_rng(seed)
    f = lambda *sh: _randn(rng, dev, dt, *sh)
    k, v = f(K1_PAGES, K1_PS, HKV, D), f(K1_PAGES, K1_PS, HKV, D)
    q = f(7, S, HKV * G, D)
    end = K1_NMAX * K1_PS
    offs = [0, 7, 100, 0, 64, 64 + S, end - S]
    tls = [S, 7 + S, 100 + (S + 1) // 2, 0, 64 + S, 64 + 2 * S, end]
    perm = rng.permutation(np.arange(1, K1_PAGES)).astype(np.int32)
    tables = np.zeros((7, K1_NMAX), np.int32)
    used = 0
    for r in (0, 1, 2, 4, 6):
        n = -(-tls[5 if r == 4 else r] // K1_PS)   # row 5 reads row 4's
        tables[r, :n] = perm[used:used + n]
        used += n
    tables[5] = tables[4]
    qls = np.clip([S - 3, S - 1, (S + 1) // 2 - 1, 0, S, S // 3 + 1, S - 5],
                  0, S)
    i32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.int32,
                                 device=dev)
    return q, k, v, i32(tables), i32(offs), i32(tls), i32(qls)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("variant", list(K1_EDGE_VARIANTS))
@pytest.mark.parametrize("S", K1_CHUNKS)
@pytest.mark.parametrize("G", [1, 2, 4, 7, 8])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_prefill_kernel_at_tile_edges(dev, D, G, S, variant, dtype):
    """K1 against its plain version at the bars of
    test_prefill_kernel_matches_plain; pad lanes and the dead row exactly
    0."""
    dt = DTYPES[dtype]
    q, k, v, tb, off, tl, ql = _k1_edge_case(dev, dt, D, G, S, seed=12)
    window, softcap, explicit = K1_EDGE_VARIANTS[variant]
    ql = ql if explicit else None
    kw = dict(window=window, logit_softcap=softcap)
    n0 = paged_prefill.launches
    got = paged_prefill.batched_paged_prefill_attention(q, k, v, tb, off,
                                                        tl, ql, **kw)
    want = paged_prefill.reference(q, k, v, tb, off, tl, ql, **kw)
    torch.cuda.synchronize()
    assert paged_prefill.launches == n0 + 1
    _close(got, want, dt)
    lanes = (ql if ql is not None else torch.clamp(tl - off, 0, S)).cpu()
    for r in range(7):
        assert not got[r, int(lanes[r]):].any(), f"row {r} pad lanes"
    assert not got[3].any(), "dead row not zero"


# K2: pages of 16, table rows of 40 pages (640 positions, 3 splits)
K2_PS, K2_NMAX = 16, 40
SPLIT = flash_decode.SPLIT
K2_LENS = [0, 1, SPLIT - 1, SPLIT, SPLIT + 1, K2_PS * K2_NMAX, 2 * SPLIT - 1,
           2 * SPLIT + 1]
# (window, softcap) per variant: the window starts inside a split
K2_EDGE_VARIANTS = {"plain": (0, 0.0), "window": (100, 0.0),
                    "softcap": (0, 30.0)}


def _k2_case(dev, dt, D, G, lens, ps, n_max, seed):
    """One sequence per length over a shuffled pool, each with its own
    pages; unused table entries point at page 0."""
    rng = np.random.default_rng(seed)
    n_pages = 1 + len(lens) * n_max
    k = _randn(rng, dev, dt, n_pages, ps, HKV, D)
    v = _randn(rng, dev, dt, n_pages, ps, HKV, D)
    q = _randn(rng, dev, dt, len(lens), 1, HKV * G, D)
    perm = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
    bt = np.zeros((len(lens), n_max), np.int32)
    for b, n in enumerate(lens):
        bt[b, :-(-n // ps)] = perm[b * n_max:b * n_max + -(-n // ps)]
    i32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.int32,
                                 device=dev)
    return q, k, v, i32(bt), i32(lens)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("variant", list(K2_EDGE_VARIANTS))
@pytest.mark.parametrize("G", list(range(1, 17)))
@pytest.mark.parametrize("D", [64, 128, 256])
def test_decode_kernel_at_split_edges(dev, D, G, variant, dtype):
    """K2 against its plain version at the bars of
    test_decode_kernel_matches_plain, lengths 0, 1, around one and two
    splits and the whole table; the lane of length 0 exactly 0."""
    dt = DTYPES[dtype]
    q, k, v, bt, lens = _k2_case(dev, dt, D, G, K2_LENS, K2_PS, K2_NMAX,
                                 seed=13)
    window, softcap = K2_EDGE_VARIANTS[variant]
    kw = dict(window=window, logit_softcap=softcap)
    n0 = flash_decode.launches
    got = flash_decode.paged_flash_decode(q, k, v, bt, lens, **kw)
    want = flash_decode.reference(q, k, v, bt, lens, **kw)
    torch.cuda.synchronize()
    assert flash_decode.launches == n0 + 1
    _close(got, want, dt)
    assert not got[0].any(), "lane of length 0 not zero"


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("D", [64, 128, 256])
def test_decode_kernel_bits_do_not_depend_on_the_batch(dev, D, dtype):
    """K2's split is fixed, so each sequence of the serving shape's batch (8
    sequences of 38..1932 positions, 32 / 8 heads, pages of 16, 128-page
    table rows; at head dims 64, 128 and 256, where the float32 kernel has
    one K/V buffer) gets the same bits alone as inside the batch, and the
    batch the same bits from call to call."""
    dt = DTYPES[dtype]
    lens = [38, 129, 301, 512, 701, 0, 1501, 1932]
    rng = np.random.default_rng(14)
    k = _randn(rng, dev, dt, 8 * 128 + 1, 16, 8, D)
    v = _randn(rng, dev, dt, 8 * 128 + 1, 16, 8, D)
    q = _randn(rng, dev, dt, 8, 1, 32, D)
    bt = torch.from_numpy(rng.permutation(np.arange(1, 8 * 128 + 1))
                          .astype(np.int32).reshape(8, 128)).to(dev)
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    batch = flash_decode.paged_flash_decode(q, k, v, bt, lens)
    for _ in range(2):
        assert torch.equal(flash_decode.paged_flash_decode(q, k, v, bt, lens),
                           batch), "not the same bits from call to call"
    for b in range(8):
        alone = flash_decode.paged_flash_decode(
            q[b:b + 1].contiguous(), k, v, bt[b:b + 1].contiguous(),
            lens[b:b + 1].contiguous())
        assert torch.equal(alone[0], batch[b]), f"sequence {b} alone"
    _close(batch, flash_decode.reference(q, k, v, bt, lens), dt)


def test_bf16_paged_kernels_refuse_misaligned_operands(dev):
    """The bf16 K1 and K2 move K/V (and q) 16 bytes at a time (cp.async): a
    contiguous q or pool that starts 2 bytes past a 16-byte boundary is
    refused with cudaErrorMisalignedAddress (716), not read wrongly."""
    q, k, v, tb, off, tl, _ = _k1_edge_case(dev, torch.bfloat16, 64, 2, 17,
                                            seed=15)

    def odd(t):
        shifted = torch.empty(t.numel() + 8, dtype=t.dtype, device=dev)
        out = shifted[1:1 + t.numel()].view(t.shape)
        out.copy_(t)
        assert out.is_contiguous() and out.data_ptr() % 16
        return out

    for args in ((odd(q), k, v), (q, odd(k), v), (q, k, odd(v))):
        with pytest.raises(RuntimeError, match="cudaError_t 716"):
            paged_prefill.batched_paged_prefill_attention(*args, tb, off, tl)
    qd, kd, vd, bt, lens = _k2_case(dev, torch.bfloat16, 64, 4, [5, 300],
                                    16, 24, seed=16)
    for args in ((odd(qd), kd, vd), (qd, odd(kd), vd), (qd, kd, odd(vd))):
        with pytest.raises(RuntimeError, match="cudaError_t 716"):
            flash_decode.paged_flash_decode(*args, bt, lens)
    paged_prefill.batched_paged_prefill_attention(q, k, v, tb, off, tl)
    flash_decode.paged_flash_decode(qd, kd, vd, bt, lens)
    torch.cuda.synchronize()


# K3: strips of 300 positions (no multiple of the split), 2 KV heads
K3_S = 300
K3_LENS = [0, 1, SPLIT - 1, SPLIT, SPLIT + 1, 2 * SPLIT - 1, 2 * SPLIT + 1,
           K3_S, K3_S + 5]


def _k3_case(dev, dt, D, G, lens, S, hkv, seed):
    rng = np.random.default_rng(seed)
    q = _randn(rng, dev, dt, len(lens), 1, hkv * G, D)
    k = _randn(rng, dev, dt, len(lens), S, hkv, D)
    v = _randn(rng, dev, dt, len(lens), S, hkv, D)
    return q, k, v, torch.tensor(lens, dtype=torch.int32, device=dev)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("variant", list(K2_EDGE_VARIANTS))
@pytest.mark.parametrize("G", [1, 2, 3, 4, 8, 16])
@pytest.mark.parametrize("D", [64, 80, 128, 256])
def test_dense_decode_kernel_at_split_edges(dev, D, G, variant, dtype):
    """K3 against its plain version at the bars of
    test_dense_decode_kernel_matches_plain: lengths 0, 1, around one and two
    splits, the whole strip and past it (clamped to the strip), a strip
    that is no multiple of the split, a window that starts inside a split;
    G < 4 (every warp scoring positions; zamba2's G 1 at head dim 80) and
    G >= 4 (a warp per head); the lane of length 0 exactly 0."""
    dt = DTYPES[dtype]
    q, k, v, lens = _k3_case(dev, dt, D, G, K3_LENS, K3_S, HKV, seed=17)
    window, softcap = K2_EDGE_VARIANTS[variant]
    kw = dict(window=window, logit_softcap=softcap)
    n0, n2 = flash_decode.dense_launches, flash_decode.launches
    got = flash_decode.flash_decode(q, k, v, lens, **kw)
    want = flash_decode.dense_reference(q, k, v, lens, **kw)
    torch.cuda.synchronize()
    assert flash_decode.dense_launches == n0 + 1
    assert flash_decode.launches == n2, "K3 counted as K2"
    _close(got, want, dt)
    assert not got[0].any(), "lane of length 0 not zero"


# (lanes, S, Hq, Hkv, D): the dense serving shape; zamba2's decode;
# gemma3-4b's decode (G 2, head dim 256: one K/V buffer in float32)
K3_BIT_SHAPES = {"dense": ([0, 1, 257, 640, 1024, 1500, 1999, 2048], 2048, 32,
                           8, 64),
                 "zamba2_d80": ([0, 100, 300, 511], 512, 32, 32, 80),
                 "gemma3_d256": ([0, 1, 129, 700, 1024, 1900], 2048, 8, 4,
                                 256)}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", list(K3_BIT_SHAPES))
def test_dense_decode_kernel_bits_do_not_depend_on_the_batch(dev, shape,
                                                            dtype):
    """K3's split is fixed, so each lane of the dense serving shape (8
    strips of 2048, 32 / 8 heads of 64), of zamba2's decode (4 strips of
    512, 32 heads of 80, G 1) and of gemma3-4b's (6 strips of 2048, 8 / 4
    heads of 256) gets the same bits alone as inside the batch, and the
    batch the same bits from call to call."""
    dt = DTYPES[dtype]
    lens, S, hq, hkv, D = K3_BIT_SHAPES[shape]
    q, k, v, lens = _k3_case(dev, dt, D, hq // hkv, lens, S, hkv, seed=18)
    batch = flash_decode.flash_decode(q, k, v, lens)
    for _ in range(2):
        assert torch.equal(flash_decode.flash_decode(q, k, v, lens), batch), \
            "not the same bits from call to call"
    for b in range(len(lens)):
        one = lambda t: t[b:b + 1].contiguous()
        alone = flash_decode.flash_decode(one(q), one(k), one(v), one(lens))
        assert torch.equal(alone[0], batch[b]), f"lane {b} alone"
    _close(batch, flash_decode.dense_reference(q, k, v, lens), dt)
    assert not batch[0].any(), "lane of length 0 not zero"


def test_bf16_dense_decode_refuses_misaligned_operands(dev):
    """The bf16 K3 moves K/V (and q) 16 bytes at a time (cp.async): a
    contiguous q or cache that starts 2 bytes past a 16-byte boundary is
    refused with cudaErrorMisalignedAddress (716), not read wrongly."""
    q, k, v, lens = _k3_case(dev, torch.bfloat16, 80, 1, [5, 300], 300, 4,
                             seed=19)

    def odd(t):
        shifted = torch.empty(t.numel() + 8, dtype=t.dtype, device=dev)
        out = shifted[1:1 + t.numel()].view(t.shape)
        out.copy_(t)
        assert out.is_contiguous() and out.data_ptr() % 16
        return out

    n0 = flash_decode.dense_launches
    for args in ((odd(q), k, v), (q, odd(k), v), (q, k, odd(v))):
        with pytest.raises(RuntimeError, match="cudaError_t 716"):
            flash_decode.flash_decode(*args, lens)
    assert flash_decode.dense_launches == n0
    flash_decode.flash_decode(q, k, v, lens)
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# K6 mamba2_scan and K7 rwkv6_scan
# ---------------------------------------------------------------------------

CLAMP_W = float(np.exp(-np.exp(0.75)))
# (B, S, H, P, N, dt scale) per case: dt = softplus(N(0, 1)) * scale
MAMBA_CASES = {"short": (1, 50, 3, 64, 64, 1.0),
               "ragged": (2, 300, 5, 40, 64, 1.0),
               "dt_near_0": (2, 200, 3, 64, 64, 1e-6),
               "large_dt_a": (2, 200, 3, 64, 64, 10.0),
               "state16": (2, 150, 2, 64, 16, 1.0),
               "state32": (1, 129, 3, 24, 32, 1.0),
               "state128": (1, 140, 3, 64, 128, 1.0),
               "odd_p": (1, 100, 3, 21, 32, 1.0),
               "full_zamba2": (2, 2048, 80, 64, 64, 1.0)}
# (B, S, H, K, V, w: "random" | "one" | "clamp" | "below", u zero) per
# case; "below": w = 1e-3 a step, far below the model's clamp, where the
# chunked plain version's e^{-cw} overflows - held against the naive scan
RWKV_CASES = {"short": (1, 20, 3, 64, 64, "random", False),
              "ragged": (2, 100, 5, 64, 64, "random", False),
              "w_one": (2, 70, 3, 64, 64, "one", False),
              "w_clamp": (2, 96, 3, 64, 64, "clamp", False),
              "u_zero": (2, 70, 3, 64, 64, "random", True),
              "clamp_u_zero": (1, 64, 3, 64, 64, "clamp", True),
              "key16": (2, 50, 2, 16, 16, "random", False),
              "key32_ragged_cols": (1, 45, 3, 32, 40, "random", False),
              "many_chunks_v100": (1, 1000, 2, 64, 100, "random", False),
              "below_clamp": (2, 200, 3, 64, 64, "below", False),
              "full_rwkv6": (2, 2048, 32, 64, 64, "random", False)}


def mamba_args(dev, dtype, B, S, H, P, N, dt_scale, seed=0):
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))) * dt_scale
    return dict(x=_randn(rng, dev, dtype, B, S, H, P), dt=f32(dt),
                A=f32(np.abs(rng.standard_normal(H)) + 0.1),
                Bm=_randn(rng, dev, dtype, B, S, N),
                Cm=_randn(rng, dev, dtype, B, S, N))


def rwkv_args(dev, dtype, B, S, H, K, V, w_kind, u_zero, seed=0):
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    w = np.exp(-np.exp(np.clip(rng.standard_normal((B, S, H, K)), -8,
                               0.75)))
    if w_kind != "random":
        w[:] = {"one": 1.0, "clamp": CLAMP_W, "below": 1e-3}[w_kind]
    u = rng.standard_normal((H, K)) * 0.1 * (0.0 if u_zero else 1.0)
    return dict(r=_randn(rng, dev, dtype, B, S, H, K),
                k=_randn(rng, dev, dtype, B, S, H, K),
                v=_randn(rng, dev, dtype, B, S, H, V), w=f32(w), u=f32(u))


def scan_terms(kind, a, impl="ref"):
    """The plain scan (impl) of the inputs' absolute values: the magnitude
    of the terms each output sums (the decays are positive)."""
    if kind == "mamba2":
        return ops.mamba2_scan(a["x"].abs(), a["dt"], a["A"], a["Bm"].abs(),
                               a["Cm"].abs(), impl=impl)
    return ops.rwkv6_scan(a["r"].abs(), a["k"].abs(), a["v"].abs(), a["w"],
                          a["u"].abs(), impl=impl)


def scan_close(got, want, terms, dtype):
    g, w = got.float().cpu(), want.float().cpu()
    bar = 1e-5 * float(terms.float().abs().max())
    if dtype == torch.bfloat16:
        bar = 2.0 ** -7 * w.abs() + bar
    err = (g - w).abs()
    assert bool(torch.isfinite(g).all()), "non-finite kernel output"
    bad = err > bar
    assert not bool(bad.any()), (
        f"{int(bad.sum())} elements past the bar, max abs err "
        f"{float(err.max()):.3e} (max |y| {float(w.abs().max()):.3e}, "
        f"max term {float(terms.float().abs().max()):.3e})")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(MAMBA_CASES))
def test_mamba2_scan_kernel_matches_plain(dev, case, dtype):
    dt = DTYPES[dtype]
    a = mamba_args(dev, dt, *MAMBA_CASES[case])
    n0 = mamba2_scan.launches
    got = ops.mamba2_scan(**a)
    want = ops.mamba2_scan(**a, impl="ref")
    torch.cuda.synchronize()
    assert mamba2_scan.launches == n0 + 1
    assert got.dtype == dt and got.shape == a["x"].shape
    scan_close(got, want, scan_terms("mamba2", a), dt)
    assert torch.equal(mamba2_scan.mamba2_scan(**a), got), "not the same bits"


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(RWKV_CASES))
def test_rwkv6_scan_kernel_matches_plain(dev, case, dtype):
    dt = DTYPES[dtype]
    a = rwkv_args(dev, dt, *RWKV_CASES[case])
    # below the clamp the chunked plain version is not finite: the naive
    plain = "naive" if RWKV_CASES[case][5] == "below" else "ref"
    n0 = rwkv6_scan.launches
    got = ops.rwkv6_scan(**a)
    want = ops.rwkv6_scan(**a, impl=plain)
    torch.cuda.synchronize()
    assert rwkv6_scan.launches == n0 + 1
    assert got.dtype == dt and got.shape == a["v"].shape
    scan_close(got, want, scan_terms("rwkv6", a, plain), dt)
    assert torch.equal(rwkv6_scan.rwkv6_scan(**a), got), "not the same bits"


def test_scan_kernels_refuse_what_they_do_not_take(dev):
    m = mamba_args(dev, torch.bfloat16, 1, 8, 2, 64, 64, 1.0)
    r = rwkv_args(dev, torch.bfloat16, 1, 8, 2, 64, 64, "random", False)
    n6, n7 = mamba2_scan.launches, rwkv6_scan.launches
    with pytest.raises(ValueError, match="dt must be torch.float32"):
        mamba2_scan.mamba2_scan(**dict(m, dt=m["dt"].to(torch.bfloat16)))
    with pytest.raises(ValueError, match="w must be torch.float32"):
        rwkv6_scan.rwkv6_scan(**dict(r, w=r["w"].to(torch.bfloat16)))
    with pytest.raises(ValueError, match="Cm must be"):
        mamba2_scan.mamba2_scan(**dict(m, Cm=m["Cm"].float()))
    with pytest.raises(ValueError, match="shape"):
        mamba2_scan.mamba2_scan(**dict(m, Bm=m["Bm"][:, :4].contiguous()))
    with pytest.raises(ValueError, match="contiguous"):
        rwkv6_scan.rwkv6_scan(**dict(r, k=r["k"].transpose(1, 2)
                                     .contiguous().transpose(1, 2)))
    with pytest.raises(ValueError, match="state size"):
        mamba2_scan.mamba2_scan(**mamba_args(dev, torch.float32, 1, 8, 2,
                                             64, 48, 1.0))
    with pytest.raises(ValueError, match="key size"):
        rwkv6_scan.rwkv6_scan(**rwkv_args(dev, torch.float32, 1, 8, 2, 128,
                                          128, "random", False))
    # a direct kernel call autograd would differentiate raises instead of
    # returning a detached result; through ops it takes the autograd
    # Function (K6 forward, its backward kernel on the way back)
    x = m["x"].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no autograd graph"):
        mamba2_scan.mamba2_scan(**dict(m, x=x))
    u = r["u"].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no autograd graph"):
        rwkv6_scan.rwkv6_scan(**dict(r, u=u))
    with torch.no_grad():
        ops.mamba2_scan(**dict(m, x=x))
    assert ops.mamba2_scan(**dict(m, x=x)).grad_fn is not None
    assert ops.rwkv6_scan(**dict(r, u=u)).grad_fn is not None
    assert (mamba2_scan.launches, rwkv6_scan.launches) == (n6 + 2, n7 + 1)


# the scans' backward kernels: (B, S, H, P, N, dt scale) and (B, S, H, K,
# V, w, u zero) per case, as MAMBA_CASES / RWKV_CASES; S past and short of
# the kernels' 16-step stretches, P short of a 16-row block; the full
# widths at one sequence.  Across the bf16 K6_bwd's 128-step chunks: S of
# exactly two, ~1000 steps at large_dt_a's scale, P of two 64-column
# blocks, more than 10 heads (two head groups) at state 128, and zamba2's
# training shape.  Across the bf16 K7_bwd's 64-step chunks: S of exactly
# two, one step past one, 1000 steps at the model's clamp, and rwkv6's
# training shape
MAMBA_BWD_CASES = {"short": (1, 5, 3, 64, 64, 1.0),
                   "ragged": (2, 300, 5, 40, 64, 1.0),
                   "dt_near_0": (2, 100, 3, 64, 64, 1e-6),
                   "large_dt_a": (2, 100, 3, 64, 64, 10.0),
                   "state16": (2, 70, 2, 64, 16, 1.0),
                   "state32": (1, 33, 3, 24, 32, 1.0),
                   "state128": (1, 40, 3, 64, 128, 1.0),
                   "odd_p": (1, 50, 3, 21, 32, 1.0),
                   "full_zamba2": (1, 2048, 80, 64, 64, 1.0),
                   "two_chunks": (2, 256, 4, 64, 64, 1.0),
                   "long_large_dt_a": (1, 1000, 3, 64, 64, 10.0),
                   "wide_p": (1, 300, 3, 96, 32, 1.0),
                   "groups_state128": (1, 260, 13, 64, 128, 1.0),
                   "train_zamba2": (4, 2048, 80, 64, 64, 1.0)}
RWKV_BWD_CASES = {"short": (1, 5, 3, 64, 64, "random", False),
                  "ragged": (2, 100, 5, 64, 64, "random", False),
                  "w_one": (2, 70, 3, 64, 64, "one", False),
                  "w_clamp": (2, 96, 3, 64, 64, "clamp", False),
                  "u_zero": (2, 33, 3, 64, 64, "random", True),
                  "key16": (2, 50, 2, 16, 16, "random", False),
                  "key32": (1, 45, 3, 32, 32, "random", False),
                  "below_clamp": (1, 100, 2, 64, 64, "below", False),
                  "full_rwkv6": (1, 2048, 32, 64, 64, "random", False),
                  "two_chunks": (2, 128, 3, 64, 64, "random", False),
                  "one_past_a_chunk": (2, 65, 3, 64, 64, "random", False),
                  "long_clamp": (1, 1000, 2, 64, 64, "clamp", False),
                  "train_rwkv6": (4, 2048, 32, 64, 64, "random", False)}


def scan_bwd_close(got, want, terms, names):
    """A scan's backward kernel against its plain version (float64 inside,
    kernels/ref.py _grad_through), gradient by gradient: within 1e-5 of
    the gradient's largest element or of its largest term, whichever is
    larger (the kernel sums in float32; as scan_close), plus for a
    bfloat16 gradient one rounding step of the terms' magnitude, 2**-7 x
    (|want| + terms) - both round each gradient to bfloat16 once.  terms:
    the magnitude of the terms each gradient sums (mamba_bwd_terms,
    rwkv_bwd_terms)."""
    for name, g, w, t in zip(names, got, want, terms):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        bf16 = g.dtype == torch.bfloat16
        g, w, t = g.float().cpu(), w.float().cpu(), t.float().cpu().abs()
        assert bool(torch.isfinite(g).all()), f"{name}: not finite"
        bar = 1e-5 * max(float(w.abs().max()), float(t.max()))
        if bf16:
            bar = 2.0 ** -7 * (w.abs() + t) + bar
        err = (g - w).abs()
        bad = err > bar
        assert not bool(bad.any()), (
            f"{name}: {int(bad.sum())} elements past the bar, max abs err "
            f"{float(err.max()):.3e} (max |{name}| {float(w.abs().max()):.3e})")


def mamba_bwd_terms(a, dy):
    """The plain backward of the inputs' and dy's absolute values (A and
    dt are positive): each gradient's terms, all of one sign - but ddt's
    two, x^T g B and A a <h_{t-1}, g>, which the absolute values make
    T1 >= 0 and -T2 <= 0.  T1 = sum_p |x_p| dx_p / dt, so ddt's
    magnitude is T1 + T2 = 2 T1 - ddt."""
    x = a["x"].abs()
    t = list(mamba2_scan.reference_bwd(x, a["dt"], a["A"], a["Bm"].abs(),
                                       a["Cm"].abs(), dy.abs()))
    dt = a["dt"].double()
    t1 = (x.double() * t[0].double()).sum(-1) / torch.where(dt > 0, dt, 1.0)
    t[1] = (2 * t1 - t[1].double()).float()
    return t


def rwkv_bwd_terms(a, dy, plain):
    """The plain backward (plain) of the inputs' and dy's absolute values
    (w is positive): each gradient's terms, all of one sign."""
    return plain(a["r"].abs(), a["k"].abs(), a["v"].abs(), a["w"],
                 a["u"].abs(), dy.abs())


def _dy(like, seed):
    rng = np.random.default_rng(seed)
    return _randn(rng, like.device, like.dtype, *like.shape)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(MAMBA_BWD_CASES))
def test_mamba2_scan_backward_kernel_matches_plain(dev, case, dtype):
    dt = DTYPES[dtype]
    a = mamba_args(dev, dt, *MAMBA_BWD_CASES[case])
    dy = _dy(a["x"], 31)
    n0 = mamba2_scan.bwd_launches
    got = mamba2_scan.mamba2_scan_bwd(**a, dy=dy)
    want = mamba2_scan.reference_bwd(**a, dy=dy)
    torch.cuda.synchronize()
    assert mamba2_scan.bwd_launches == n0 + 1
    scan_bwd_close(got, want, mamba_bwd_terms(a, dy),
                   ("dx", "ddt", "dA", "dBm", "dCm"))
    again = mamba2_scan.mamba2_scan_bwd(**a, dy=dy)
    assert all(torch.equal(x, y) for x, y in zip(got, again)), \
        "not the same bits"


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(RWKV_BWD_CASES))
def test_rwkv6_scan_backward_kernel_matches_plain(dev, case, dtype):
    dt = DTYPES[dtype]
    a = rwkv_args(dev, dt, *RWKV_BWD_CASES[case])
    dy = _dy(a["v"], 32)
    # below the clamp the chunked plain version's e^{-cw} overflows: the
    # gradient of the naive step-by-step scan
    below = RWKV_BWD_CASES[case][5] == "below"

    def plain(r, k, v, w, u, dy):
        if below:
            from repro_torch.kernels import ref
            return ref._grad_through(ref.rwkv6_scan, (r, k, v, w, u), dy)
        return rwkv6_scan.reference_bwd(r, k, v, w, u, dy)
    n0 = rwkv6_scan.bwd_launches
    got = rwkv6_scan.rwkv6_scan_bwd(**a, dy=dy)
    want = plain(**a, dy=dy)
    torch.cuda.synchronize()
    assert rwkv6_scan.bwd_launches == n0 + 1
    scan_bwd_close(got, want, rwkv_bwd_terms(a, dy, plain),
                   ("dr", "dk", "dv", "dw", "du"))
    again = rwkv6_scan.rwkv6_scan_bwd(**a, dy=dy)
    assert all(torch.equal(x, y) for x, y in zip(got, again)), \
        "not the same bits"


@pytest.mark.parametrize("shape", [(2, 200, 3, 64, 64), (1, 2048, 32, 64, 64),
                                   (2, 100, 2, 32, 16)],
                         ids=lambda s: "x".join(map(str, s)))
def test_rwkv6_backward_carries_are_the_forward_state_scans(dev, shape):
    """The bf16 K7_bwd's carries launch runs K7's state scan forward (each
    chunk's S_in, csrc/rwkv6_chunk.cuh state_scan) beside its reverse:
    the S_in parts it leaves are the bits K7's forward leaves in its own
    scratch, chunk by chunk."""
    a = rwkv_args(dev, torch.bfloat16, *shape, "random", False)
    Bsz, S, H, K = a["r"].shape
    V = a["v"].shape[-1]
    nc = -(-S // rwkv6_scan.CHUNK)
    dy = _dy(a["v"], 38)
    stream = torch.cuda.current_stream().cuda_stream
    fwd = torch.zeros(Bsz * H * nc * 2 * K * V, dtype=torch.bfloat16,
                      device=dev)
    y = torch.empty_like(a["v"])
    ops_in = [a[n].data_ptr() for n in ("r", "k", "v", "w", "u")]
    build.check("rwkv6_scan", build.kernel("rwkv6_scan")(
        *ops_in, y.data_ptr(), fwd.data_ptr(), Bsz, S, H, K, V, 1, stream))
    carries, part_v, part_u = rwkv6_scan.bwd_scratch(Bsz, S, H, K, V,
                                                     torch.bfloat16, dev)
    carries.zero_()
    grads = [torch.empty_like(a[n]) for n in ("r", "k", "v", "w", "u")]
    build.check("rwkv6_scan_bwd", build.kernel("rwkv6_scan_bwd")(
        *ops_in, dy.data_ptr(), *(g.data_ptr() for g in grads),
        carries.data_ptr(), part_v.data_ptr(), part_u.data_ptr(), Bsz, S, H,
        K, V, 1, stream))
    torch.cuda.synchronize()
    shape5 = (Bsz, H, nc, 2 * K * V)
    got = carries[:fwd.numel()].view(shape5)[:, :, 1:]
    want = fwd.view(shape5)[:, :, 1:]
    assert torch.equal(got, want), "the carries differ from K7's"
    # and the adjoint's carries are there, past the last chunk's zero
    g_out = carries[fwd.numel():].view(shape5)[:, :, :-1]
    assert bool(torch.isfinite(g_out.float()).all())
    assert float(g_out.float().abs().max()) > 0


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_autograd_runs_the_scans_and_their_backward_kernels(dev, dtype):
    """A gradient through ops.mamba2_scan / ops.rwkv6_scan on CUDA tensors
    launches the forward kernel once and the backward kernel once, and
    equals the plain backward."""
    dt = DTYPES[dtype]
    for kind, args, mod, names in (
            ("mamba2", mamba_args(dev, dt, 2, 100, 3, 64, 64, 1.0),
             mamba2_scan, ("x", "dt", "A", "Bm", "Cm")),
            ("rwkv6", rwkv_args(dev, dt, 2, 100, 3, 64, 64, "random",
                                False), rwkv6_scan,
             ("r", "k", "v", "w", "u"))):
        a = {n: args[n].clone().requires_grad_(True) for n in names}
        n0, n1 = mod.launches, mod.bwd_launches
        y = getattr(ops, f"{kind}_scan")(**a)
        dy = _dy(y, 33)
        got = torch.autograd.grad(y, [a[n] for n in names], dy)
        torch.cuda.synchronize()
        assert (mod.launches, mod.bwd_launches) == (n0 + 1, n1 + 1), kind
        want = mod.reference_bwd(**{n: args[n] for n in names}, dy=dy)
        terms = mamba_bwd_terms(args, dy) if kind == "mamba2" \
            else rwkv_bwd_terms(args, dy, mod.reference_bwd)
        scan_bwd_close(got, want, terms, names)


def test_scan_backward_kernels_refuse_what_they_do_not_take(dev):
    m = mamba_args(dev, torch.bfloat16, 1, 8, 2, 64, 64, 1.0)
    r = rwkv_args(dev, torch.bfloat16, 1, 8, 2, 64, 64, "random", False)
    dym, dyr = _dy(m["x"], 34), _dy(r["v"], 35)
    n6, n7 = mamba2_scan.bwd_launches, rwkv6_scan.bwd_launches
    with pytest.raises(ValueError, match="dy must be"):
        mamba2_scan.mamba2_scan_bwd(**m, dy=dym.float())
    with pytest.raises(ValueError, match="dy must be"):
        rwkv6_scan.rwkv6_scan_bwd(**r, dy=dyr[:, :4].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        mamba2_scan.mamba2_scan_bwd(**m, dy=dym.transpose(1, 2).contiguous()
                                    .transpose(1, 2))
    with pytest.raises(ValueError, match="dt must be torch.float32"):
        mamba2_scan.mamba2_scan_bwd(**dict(m, dt=m["dt"].to(torch.bfloat16)),
                                    dy=dym)
    with pytest.raises(ValueError, match="state size"):
        a = mamba_args(dev, torch.float32, 1, 8, 2, 64, 48, 1.0)
        mamba2_scan.mamba2_scan_bwd(**a, dy=_dy(a["x"], 36))
    with pytest.raises(ValueError, match="value size"):
        a = rwkv_args(dev, torch.float32, 1, 8, 2, 64, 100, "random", False)
        rwkv6_scan.rwkv6_scan_bwd(**a, dy=_dy(a["v"], 37))
    assert (mamba2_scan.bwd_launches, rwkv6_scan.bwd_launches) == (n6, n7)


# whisper-base (8 heads of 64, G 1): the encoder's full attention over its
# 1500 audio frames, the prefill's cross-attention (4 decoder queries over
# the 1500 frames), the cross decode over a 1500-position strip (no
# multiple of K3's split), and the cross-attention backward in training
WHISPER_HEADS = 8
WHISPER_FWD = [(4, 1500), (1500, 1500)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("lens", WHISPER_FWD, ids=lambda x: f"{x[0]}x{x[1]}")
def test_flash_attention_kernel_at_whisper_shapes(dev, lens, dtype):
    """K4, full mask, at the bars of
    test_flash_attention_kernel_matches_plain."""
    dt = DTYPES[dtype]
    sq, skv = lens
    rng = np.random.default_rng(21)
    q = _randn(rng, dev, dt, 2, sq, WHISPER_HEADS, 64)
    k = _randn(rng, dev, dt, 2, skv, WHISPER_HEADS, 64)
    v = _randn(rng, dev, dt, 2, skv, WHISPER_HEADS, 64)
    n0 = flash_attention.launches
    o, lse = flash_attention.flash_attention_fwd(q, k, v, causal=False)
    o_ref, lse_ref = flash_attention.reference(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1
    if dt == torch.bfloat16:
        _close_terms(o, o_ref, flash_attention.reference(
            q, k, v.abs(), causal=False)[0])
    else:
        _close(o, o_ref, dt)
    _close(lse, lse_ref, torch.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_dense_decode_kernel_over_a_whisper_cross_strip(dev, dtype):
    """K3 over strips of 1500 positions at the bars of
    test_dense_decode_kernel_matches_plain: lengths 0, 1, 1000, 1499 and
    the whole strip; the lane of length 0 exactly 0."""
    dt = DTYPES[dtype]
    q, k, v, lens = _k3_case(dev, dt, 64, 1, [0, 1, 1000, 1499, 1500], 1500,
                             WHISPER_HEADS, seed=22)
    n0 = flash_decode.dense_launches
    got = flash_decode.flash_decode(q, k, v, lens)
    want = flash_decode.dense_reference(q, k, v, lens)
    torch.cuda.synchronize()
    assert flash_decode.dense_launches == n0 + 1
    _close(got, want, dt)
    assert not got[0].any(), "lane of length 0 not zero"


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_backward_kernel_at_a_whisper_cross_shape(dev, dtype):
    """K5, full mask, 64 queries over 1500 keys, at the bars of bwd_close;
    o and lse from K4."""
    dt = DTYPES[dtype]
    rng = np.random.default_rng(23)
    q = _randn(rng, dev, dt, 2, 64, WHISPER_HEADS, 64)
    k = _randn(rng, dev, dt, 2, 1500, WHISPER_HEADS, 64)
    v = _randn(rng, dev, dt, 2, 1500, WHISPER_HEADS, 64)
    do = _randn(rng, dev, dt, 2, 64, WHISPER_HEADS, 64)
    o, lse = flash_attention.flash_attention_fwd(q, k, v, causal=False)
    n0 = flash_backward.launches
    got = flash_backward.flash_attention_bwd(q, k, v, o, lse, do,
                                             causal=False)
    want = flash_backward.reference(q, k, v, o, lse, do, causal=False)
    terms = flash_backward.reference(q, k, v, o, lse, do, causal=False,
                                     terms=True)
    torch.cuda.synchronize()
    assert flash_backward.launches == n0 + 1
    bwd_close(got, want, terms, dt)
