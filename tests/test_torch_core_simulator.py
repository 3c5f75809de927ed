"""The port's 3D-Flow co-design simulator (repro_torch.core: arch,
workloads, dataflows, simulator, thermal) against the JAX package's
repro.core, field for field and exactly: both are the same Python float
arithmetic, so every comparison is ==, tolerance 0.  The numbers are the
paper's 16 nm, 1 GHz model of a 3D NPU, not a device's.  Also the count
cross-check behind chip_smoke.py's phase_paper: launch/cost.py k4_work's
FLOPs for one layer of a paper workload equal the simulator's op count."""
import dataclasses

import numpy as np
import pytest

import repro.core as jc
from repro.configs import ARCH_MODULES as JAX_ARCHS
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.core import thermal as jax_thermal
import repro_torch.core as tc
from repro_torch.configs import ARCH_MODULES, get_config, get_smoke_config
from repro_torch.core import thermal
from repro_torch.launch import cost

DESIGNS = list(tc.DESIGNS)
GRID = [(m.name, m.attn.seq) for m in tc.paper_grid()]
GRID_IDS = [f"{n}-{s}" for n, s in GRID]
MAKERS = {"port": tc.PAPER_MODELS, "jax": jc.PAPER_MODELS}


def _fields(obj) -> dict:
    return dataclasses.asdict(obj)


def _table(pkg, seed):
    """EnergyTable.default16nm(), or with every field scaled by a
    numpy-seeded factor in [0.5, 2)."""
    cls = (tc if pkg == "port" else jc).EnergyTable
    if seed is None:
        return cls.default16nm()
    rng = np.random.default_rng(seed)
    return cls(**{f.name: getattr(cls(), f.name) * float(rng.uniform(0.5, 2))
                  for f in dataclasses.fields(cls)})


def test_design_order_and_paper_grid_equal_the_jax_package():
    assert list(tc.DESIGNS) == list(jc.DESIGNS)
    assert tc.PAPER_SEQS == jc.PAPER_SEQS
    assert list(tc.PAPER_MODELS) == list(jc.PAPER_MODELS)
    assert [_fields(m) for m in tc.paper_grid()] == \
        [_fields(m) for m in jc.paper_grid()]


def test_port_core_exports_every_name_of_the_jax_core():
    assert set(jc.__all__) <= set(tc.__all__)
    for name in tc.__all__:
        assert getattr(tc, name) is not None


@pytest.mark.parametrize("design", DESIGNS)
def test_get_spec_equals_the_jax_package(design):
    ours, theirs = tc.get_spec(design), jc.get_spec(design)
    assert _fields(ours) == _fields(theirs)
    for prop in ("pes_per_array", "total_pes", "onchip_bytes_per_cycle",
                 "offchip_bytes_per_cycle"):
        assert getattr(ours, prop) == getattr(theirs, prop), prop
    with pytest.raises(KeyError):
        tc.get_spec("no-such-design")


def _assert_same_result(ours, theirs):
    assert ours.row() == theirs.row()
    assert _fields(ours.activity) == _fields(theirs.activity)
    assert ours.activity.utilization == theirs.activity.utilization
    assert _fields(ours.energy) == _fields(theirs.energy)
    assert ours.energy.as_dict() == theirs.energy.as_dict()
    assert ours.energy.shares() == theirs.energy.shares()
    assert (ours.design, ours.workload, ours.seq, ours.cycles, ours.time_s,
            ours.utilization, ours.total_energy) == \
        (theirs.design, theirs.workload, theirs.seq, theirs.cycles,
         theirs.time_s, theirs.utilization, theirs.total_energy)


@pytest.mark.parametrize("level", ["attention", "model"])
@pytest.mark.parametrize("wl", GRID, ids=GRID_IDS)
@pytest.mark.parametrize("design", DESIGNS)
def test_simulation_equals_the_jax_package(design, wl, level):
    """Every SimResult.row() field, every Activity and EnergyBreakdown
    field and the energy shares of simulate_attention (the attention core)
    and simulate_model (with the projection / FFN GEMMs)."""
    name, seq = wl
    m_ours, m_theirs = (MAKERS[p][name](seq) for p in ("port", "jax"))
    if level == "attention":
        ours = tc.simulate_attention(design, m_ours.attn)
        theirs = jc.simulate_attention(design, m_theirs.attn)
    else:
        ours = tc.simulate_model(design, m_ours)
        theirs = jc.simulate_model(design, m_theirs)
    _assert_same_result(ours, theirs)


@pytest.mark.parametrize("seed", [None, 3])
def test_sweep_and_its_reductions_equal_the_jax_package(seed):
    """sweep over the 5 designs x paper_grid(), under the default energy
    table and a seeded one, and the figure reductions of its results."""
    ours = tc.sweep(DESIGNS, [m.attn for m in tc.paper_grid()],
                    table=_table("port", seed))
    theirs = jc.sweep(list(jc.DESIGNS), [m.attn for m in jc.paper_grid()],
                      table=_table("jax", seed))
    assert len(ours) == len(theirs) == 40
    for o, t in zip(ours, theirs):
        _assert_same_result(o, t)
    assert tc.normalized_energy(ours) == jc.normalized_energy(theirs)
    assert tc.normalized_energy(ours, baseline="2D-Fused") == \
        jc.normalized_energy(theirs, baseline="2D-Fused")
    assert tc.speedups(ours) == jc.speedups(theirs)
    assert tc.speedups(ours, ours="3D-Base") == \
        jc.speedups(theirs, ours="3D-Base")
    assert tc.mean_utilization(ours) == jc.mean_utilization(theirs)
    assert tc.data_movement(ours) == jc.data_movement(theirs)


@pytest.mark.parametrize("seed", [None, 0, 1, 2])
def test_thermal_report_equals_the_jax_package(seed):
    """The default ThermalSpec and three with fields changed from a numpy
    seed; the report, Tj and feasibility at a seeded limit."""
    kw = {}
    if seed is not None:
        rng = np.random.default_rng(seed)
        kw = dict(p_pe_w=float(rng.uniform(50e-6, 400e-6)),
                  array_dim=int(rng.integers(32, 257)),
                  n_tiers=int(rng.integers(1, 9)),
                  area_mm2=float(rng.uniform(8.0, 200.0)),
                  r_tier_cm2_k_per_w=float(rng.uniform(0.05, 0.5)),
                  r_theta_ja_k_per_w=float(rng.uniform(0.5, 5.0)),
                  ambient_c=float(rng.uniform(0.0, 45.0)),
                  util=float(rng.uniform(0.3, 1.0)))
    ours, theirs = thermal.ThermalSpec(**kw), jax_thermal.ThermalSpec(**kw)
    assert _fields(ours) == _fields(theirs)
    assert thermal.report(ours) == jax_thermal.report(theirs)
    assert tc.thermal_report(ours) == jc.thermal_report(theirs)
    assert tc.junction_temp_c(ours) == jc.junction_temp_c(theirs)
    t_max = 60.0 + 10.0 * (seed or 0)
    assert thermal.feasible(ours, t_max) == jax_thermal.feasible(theirs, t_max)


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", sorted(ARCH_MODULES))
def test_from_model_config_equals_the_jax_package(arch, smoke):
    """Every architecture registered in both packages, at seq 1024 and
    batch 2: the port's ModelConfig gives the JAX ModelConfig's workload
    (n_kv_heads and the head_dim default included)."""
    assert set(ARCH_MODULES) == set(JAX_ARCHS)
    ours_cfg = (get_smoke_config if smoke else get_config)(arch)
    theirs_cfg = (jax_get_smoke_config if smoke else jax_get_config)(arch)
    ours = tc.from_model_config(ours_cfg, 1024, batch=2)
    theirs = jc.from_model_config(theirs_cfg, 1024, batch=2)
    assert _fields(ours) == _fields(theirs)
    for prop in ("group_size", "total_head_instances", "qk_macs", "pv_macs",
                 "softmax_elems"):
        assert getattr(ours, prop) == getattr(theirs, prop), prop
    assert tc.from_model_config(ours_cfg, 1024) == \
        tc.AttentionWorkload(**dict(_fields(ours), batch=1))


@pytest.mark.parametrize("wl", GRID, ids=GRID_IDS)
def test_paper_configs_give_the_paper_workloads(wl):
    """chip_smoke.py phase_paper builds its K4 calls from the port's
    registered configs: each gives the simulator's paper workload, and
    its ModelWorkload's GEMM counts equal the JAX package's."""
    name, seq = wl
    ours = tc.PAPER_MODELS[name](seq)
    assert tc.from_model_config(get_config(name), seq) == ours.attn
    theirs = jc.PAPER_MODELS[name](seq)
    for prop in ("proj_macs", "ffn_macs", "weight_bytes"):
        assert getattr(ours, prop) == getattr(theirs, prop), prop


@pytest.mark.parametrize("wl", GRID, ids=GRID_IDS)
def test_k4_work_counts_the_simulator_ops_of_one_layer(wl):
    """One non-causal K4 call of one layer at batch 1: launch/cost.py
    k4_work's FLOPs are 2 (qk_macs + pv_macs) / n_layers, and its bytes
    q, K, V and o in bf16 plus the fp32 lse."""
    name, seq = wl
    a = tc.PAPER_MODELS[name](seq).attn
    q_shape = (a.batch, a.seq, a.n_heads, a.head_dim)
    k_shape = (a.batch, a.seq, a.n_kv_heads, a.head_dim)
    nbytes, flops = cost.k4_work(q_shape, k_shape, 2, False, 0)
    assert flops == 2 * (a.qk_macs + a.pv_macs) / a.n_layers
    assert nbytes == 2 * (2 * a.seq * a.n_heads * a.head_dim
                          + 2 * a.seq * a.n_kv_heads * a.head_dim) \
        + 4 * a.seq * a.n_heads
