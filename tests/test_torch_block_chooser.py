"""The paper's latency-balanced block chooser on Hopper (ROADMAP M14b):
repro_torch/core/schedule.py against the JAX package's core/schedule.py,
and repro_torch/core/hopper_mapping.py after tests/test_tpu_mapping.py,
plus the tiles K4's wrapper takes.  All exact: host arithmetic."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import schedule as jax_schedule
from repro_torch.core import hopper_mapping as hm
from repro_torch.core import schedule
from repro_torch.kernels import flash_attention

CU = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc" \
    / "flash_attention.cu"
HEAD_DIMS = sorted(hm.K4_TILES)
SEQS = [1, 16, 64, 100, 128, 256, 1500, 2048, 4096, 32768, 524288]


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("n_tiers", [1, 2, 3, 4, 7])
def test_balance_chain_equals_the_jax_copy(seed, n_tiers):
    rng = np.random.default_rng(seed)
    costs = rng.uniform(0.1, 10.0, int(rng.integers(1, 12))).tolist()
    assert schedule.balance_chain(costs, n_tiers) == \
        jax_schedule.balance_chain(costs, n_tiers)
    assert schedule.balanced_ii(costs, n_tiers) == \
        jax_schedule.balanced_ii(costs, n_tiers)
    assert hm.tier_assignment_for_chain(costs, n_tiers) == \
        jax_schedule.balance_chain(costs, n_tiers)


@pytest.mark.parametrize("d", [8, 64, 128, 256])
def test_pipeline_helpers_equal_the_jax_copy(d):
    ours, theirs = schedule.threed_flash_schedule(), \
        jax_schedule.threed_flash_schedule()
    assert [s.name for s in ours] == [s.name for s in theirs]
    for a, b in zip(ours, theirs):
        for f in ("macs", "exp_ops", "alu_ops", "tsv_out_bytes", "latency",
                  "ii"):
            assert getattr(a, f)(d) == getattr(b, f)(d)
    for n in (0, 1, 7):
        assert schedule.pipeline_cycles(n, ours, d) == \
            jax_schedule.pipeline_cycles(n, theirs, d)
    assert schedule.is_bubble_free(ours, d) == \
        jax_schedule.is_bubble_free(theirs, d)
    assert schedule.pipeline_depth(ours, d) == \
        jax_schedule.pipeline_depth(theirs, d)


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("seq", [2048, 32768])
def test_chooser_returns_a_valid_config(hd, seq):
    bc = hm.choose_block_config(hd, seq)
    assert (bc.block_q, bc.block_kv) in hm.K4_TILES[hd]
    assert bc.block_q % 16 == 0 and bc.block_kv % 16 == 0
    assert bc.fits and bc.smem_bytes <= 232448


def test_stage_structure_mirrors_the_papers_tiers():
    names = [n for n, _ in hm.stage_latencies(128, 64, 128)]
    assert names == ["qk", "rowmax", "expsum", "pv"]


def test_shared_memory_grows_with_the_tile():
    assert hm.smem_working_set(64, 64, 128) < \
        hm.smem_working_set(128, 64, 128) < hm.smem_working_set(128, 128, 128)
    # today's tile at head dim 256: (256 + 8) x (64 + 4 x 64) x 2 B
    assert hm.smem_working_set(64, 64, 256) == 264 * 320 * 2


def test_head_dim_256_cannot_take_a_kv_tile_of_128():
    bc = hm.block_config(64, 128, 256)
    assert bc.registers == 128 + 64 + 81 == 273
    assert bc.smem_bytes == 304128
    assert not bc.fits
    assert hm.block_config(64, 64, 256).registers == 241     # PERF.md


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("seq", SEQS)
def test_every_pick_is_an_instantiated_tile_that_fits(hd, seq):
    bc = hm.choose_block_config(hd, seq)
    assert (bc.block_q, bc.block_kv) in hm.K4_TILES[hd]
    assert bc.smem_bytes <= hm.SMEM_BLOCK
    assert bc.registers <= hm.REGS_THREAD
    assert bc.registers * 32 * (bc.block_q // 16) <= hm.REGS_SM


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("seq", SEQS)
def test_the_pick_is_bubble_free_wherever_a_candidate_is(hd, seq):
    bc = hm.choose_block_config(hd, seq)
    cands = hm.candidates(hd, seq)
    if any(c.bubble_free for c in cands):
        assert bc.bubble_free
    pool = [c for c in cands if c.bubble_free == bc.bubble_free]
    assert round(bc.balanced, 3) == min(round(c.balanced, 3) for c in pool)


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_float32_keeps_its_one_tile(hd):
    bc = hm.choose_block_config(hd, 2048, "float32")
    assert (bc.block_q, bc.block_kv) == hm.f32_tile(hd) == \
        (32 if hd == 256 else 64, 64)


def test_the_source_instantiates_exactly_the_candidates():
    text = CU.read_text()
    body = text[text.index('extern "C" int flash_attention_launch'):]
    got = {}
    for d, bq, bkv in re.findall(r"K4_TILE\((\d+), (\d+), (\d+)\)", body):
        got.setdefault(int(d), []).append((int(bq), int(bkv)))
    assert {d: sorted(t) for d, t in got.items()} == \
        {d: sorted(t) for d, t in hm.K4_TILES.items()}
    assert all((64, 64) in t and len(t) <= 3 for t in hm.K4_TILES.values())
    assert sorted(int(d) for d in re.findall(r"K4_F32\((\d+)\)", body)) \
        == HEAD_DIMS


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_the_wrapper_asks_the_chooser_and_refuses_other_tiles():
    # 0 asks the chooser with (D, max(Sq, Skv))
    assert flash_attention.tile(128, 4096, torch.bfloat16) == \
        (lambda b: (b.block_q, b.block_kv))(hm.choose_block_config(128, 4096))
    assert flash_attention.tile(256, 2048, torch.float32) == (32, 64)
    q = _meta(1, 40, 4, 64)
    k = _meta(1, 300, 2, 64)
    assert flash_attention.tile(64, 300, torch.bfloat16) == \
        flash_attention.tile(64, 300, torch.bfloat16, 0, 0)
    for bq, bkv in hm.K4_TILES[64]:
        o, _ = flash_attention.flash_attention_fwd(q, k, k, block_q=bq,
                                                   block_kv=bkv)
        assert o.shape == q.shape
    for bq, bkv in ((64, 128), (32, 64), (128, 128)):
        with pytest.raises(ValueError, match="instantiates"):
            flash_attention.flash_attention_fwd(q, k, k, block_q=bq,
                                                block_kv=bkv)
    with pytest.raises(ValueError, match="instantiates"):
        flash_attention.flash_attention_fwd(
            _meta(1, 8, 2, 64, dtype=torch.float32),
            _meta(1, 8, 2, 64, dtype=torch.float32),
            _meta(1, 8, 2, 64, dtype=torch.float32), block_q=128,
            block_kv=64)
    # the plain version, on the CPU, takes no tile but refuses a wrong one
    x = torch.randn(1, 8, 2, 64)
    o, _ = flash_attention.flash_attention_fwd(x, x, x, block_q=64,
                                               block_kv=64)
    assert torch.equal(o, flash_attention.flash_attention_fwd(x, x, x)[0])
    with pytest.raises(ValueError, match="instantiates"):
        flash_attention.flash_attention_fwd(x, x, x, block_q=64,
                                            block_kv=32)
