"""Input specs and shardings for every (arch x shape) cell: the JAX
package's launch/specs.py on a DeviceMesh.

Nothing is allocated here: a shape is a tensor on the "meta" device (the
ShapeDtypeStruct counterpart: shape and dtype, no storage) and a sharding
is a per-leaf sharding/rules.py NamedSharding, a spec on the mesh, whose
.placements are the DTensor placements.  The trees follow the JAX
package's leaf for leaf - the train state (params, AdamW step / m / v,
ef), the batch, the caches - so tests hold the two packages' cells equal
spec by spec.

train_cell is what the mesh Trainer runs: its state shardings are
Trainer(mesh=, state_shardings=)'s.  prefill_cell and serve_cell return
the prefill and decode steps on the mesh (serve/serve_step.py
make_prefill_step / make_serve_step with mesh=), over the cell's cache
layout: the step takes the rank's shards of the cell's arguments, the
parameters as DTensors.  Every cell's step on a mesh takes all six
families (the MoE experts over the model axis, the router replicated:
the JAX rules; the per-row dispatch by default, the REPRO_MOE_A2A
exchange where it is set, models/moe.py; whisper's four strips and
zamba2's shared block's two in the one layout strips_spec reads; the
recurrent states' blocks as state_blocks reads them, each leaf from its
own spec; their train cells' steps through the scans' backward
kernels).  launch/dryrun.py runs every cell's step on the meta device.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..configs.base import ModelConfig, ShapeSpec, TrainConfig
from ..models.layers import pdtype
from ..models.model import Model, build_model
from ..sharding.rules import (NamedSharding, P, axis_names, axis_sizes,
                              cache_spec, dp_axes, param_sharding_tree,
                              spec_axis_size, tp_axis)
from ..tree import _is_namedtuple, map_tree, map_with_paths


def sds(shape, dtype) -> torch.Tensor:
    """A shape and a dtype, no storage."""
    return torch.empty(shape, dtype=dtype, device="meta")


def sanitize(shardings, shapes, mesh):
    """Drop spec entries that do not evenly divide the dimension (batch=1
    decode, odd vocab sizes, head counts < mesh axis, ...): the even
    shards the sharded step and DTensor placements need."""
    if isinstance(shardings, tuple) and not _is_namedtuple(shardings):
        return tuple(sanitize(s, a, mesh) for s, a in zip(shardings, shapes))

    def fix(sh, spec_shape):
        if not isinstance(sh, NamedSharding):
            return sh
        dims = spec_shape.shape
        spec = list(sh.spec) + [None] * (len(dims) - len(sh.spec))
        new = []
        for d, entry in zip(dims, spec):
            if entry is not None and d % spec_axis_size(mesh, entry) != 0:
                entry = None
            new.append(entry)
        return NamedSharding(mesh, P(*new))

    return map_tree(fix, shardings, shapes)


# ---------------------------------------------------------------------------
# batch specs
# ---------------------------------------------------------------------------

def batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Training / prefill batch shapes."""
    B, S = shape.global_batch, shape.seq_len
    dt = pdtype(cfg)
    batch = {}
    if cfg.family == "vlm":
        s_text = S - cfg.frontend_tokens
        batch["tokens"] = sds((B, s_text), torch.int32)
        batch["vision_embeds"] = sds((B, cfg.frontend_tokens, cfg.d_model),
                                     dt)
    elif cfg.family == "audio":
        batch["tokens"] = sds((B, S), torch.int32)
        batch["audio_embeds"] = sds((B, S, cfg.d_model), dt)
    else:
        batch["tokens"] = sds((B, S), torch.int32)
    return batch


def batch_shardings(cfg: ModelConfig, mesh) -> Dict[str, Any]:
    dp = dp_axes(axis_names(mesh))
    out = {"tokens": NamedSharding(mesh, P(dp, None))}
    if cfg.family == "vlm":
        out["vision_embeds"] = NamedSharding(mesh, P(dp, None, None))
    if cfg.family == "audio":
        out["audio_embeds"] = NamedSharding(mesh, P(dp, None, None))
    return out


# ---------------------------------------------------------------------------
# decode specs (serve_step: one new token against a prefilled cache)
# ---------------------------------------------------------------------------

def _meta_model(cfg: ModelConfig) -> Model:
    return build_model(cfg, "meta")


def decode_specs(model: Model, cfg: ModelConfig, shape: ShapeSpec):
    B, S = shape.global_batch, shape.seq_len
    cache = model.init_cache(B, S, enc_len=S)
    tokens = sds((B, 1), torch.int32)
    lens = sds((B,), torch.int32)
    return cache, tokens, lens


def _cache_leaf_spec(path: str, leaf, names, *, seq_sharded: bool,
                     seq_axis: str = "data"):
    dp = dp_axes(names)
    tp = tp_axis(names)
    nd = len(leaf.shape)
    if path.endswith(("k", "v")) and nd == 5:
        # (L/A, B, S, Hkv, D) attention caches
        return cache_spec(names, seq_sharded=seq_sharded, seq_axis=seq_axis)
    if path.endswith("ssm") and nd == 5:      # (L, B, H, P, N)
        return P(None, dp, tp, None, None)
    if path.endswith("wkv") and nd == 5:      # (L, B, H, K, V)
        return P(None, dp, tp, None, None)
    if path.endswith("conv") and nd == 4:     # (L, B, k-1, d_in)
        return P(None, dp, None, tp)
    if nd == 3:                               # (L, B, D) rwkv shift states
        return P(None, dp, None)
    return P()


def cache_shardings(cache, mesh, *, seq_sharded: bool,
                    seq_axis: str = "data"):
    names = axis_names(mesh)
    return map_with_paths(
        lambda path, leaf: NamedSharding(mesh, _cache_leaf_spec(
            path, leaf, names, seq_sharded=seq_sharded, seq_axis=seq_axis)),
        cache)


# ---------------------------------------------------------------------------
# full cell assembly
# ---------------------------------------------------------------------------

def train_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, tcfg: TrainConfig):
    """Returns (step_fn, arg_specs, in_shardings) for a train_step cell:
    arg_specs (state shapes, batch shapes), in_shardings (state
    shardings, batch shardings), both sanitized.  step_fn is the sharded
    train step (train/train_step.py make_train_step(mesh=)) over the
    cell's model on the meta device: the step the Trainer runs over its
    own model, here for its structure."""
    from ..optim import adamw_init, ef_init
    from ..train.train_step import TrainState, make_train_step, trainable
    model = _meta_model(cfg)
    trainable(model.params)       # the step's backward on the meta device
    step = make_train_step(model, tcfg, mesh=mesh)
    params = model.params
    opt = adamw_init(params)
    state_shape = TrainState(params=params, opt=opt,
                             ef=ef_init(params) if tcfg.grad_compression
                             else {})
    state_shard = TrainState(
        params=param_sharding_tree(params, mesh),
        opt=type(opt)(step=NamedSharding(mesh, P()),
                      m=param_sharding_tree(opt.m, mesh),
                      v=param_sharding_tree(opt.v, mesh)),
        ef=param_sharding_tree(state_shape.ef, mesh)
        if tcfg.grad_compression else {})
    bspecs = batch_specs(cfg, shape)
    bshard = batch_shardings(cfg, mesh)
    args = (state_shape, bspecs)
    shardings = sanitize((state_shard, bshard), args, mesh)
    return step, args, shardings


# the attention strips' leaves by family: the decoders' "k" / "v",
# whisper's self-attention and cross-attention strips, zamba2's shared
# block's
_STRIPS = (("k", "v"), ("self_k", "self_v", "cross_k", "cross_v"),
           ("shared_k", "shared_v"))
# the recurrent state leaves (models/mamba2.py, models/rwkv6.py)
_STATES = ("conv", "ssm", "wkv", "tm_prev", "cm_prev")


def strips_spec(cache_sharding):
    """The spec the attention strips of a cache share (sanitized): the
    "k" leaf's, whisper's "self_k" or zamba2's "shared_k", with every
    other strip of the cache checked to carry the same one (the mesh
    steps read and write them all through one CacheShard).  None for a
    cache without strips (rwkv6's)."""
    if not isinstance(cache_sharding, dict):
        return None
    for names in _STRIPS:
        if names[0] in cache_sharding:
            specs = {n: tuple(cache_sharding[n].spec) for n in names}
            if len(set(specs.values())) > 1:
                raise ValueError(f"the attention strips are laid out "
                                 f"differently: {specs}")
            return cache_sharding[names[0]].spec
    return None


def state_blocks(cache_sharding) -> Dict[str, Any]:
    """Each recurrent state leaf of a cache (sanitized shardings) -> (its
    rows' spec entry: the data axes its batch dim is split over, or None;
    {dim: the axis splitting that dim} for its other split dims).  Every
    leaf is read from its own spec: on the zamba2 smoke config on a 1x4
    mesh, ssm's 2 heads stay whole where conv's 128 channels split 32 a
    rank; rwkv6's wkv (L, B, H, K, V) takes the strips' spec, as in the
    JAX package (its name ends in "v": _cache_leaf_spec), so its K or H
    dim is split.  {} for a cache without states."""
    if not isinstance(cache_sharding, dict):
        return {}
    out = {}
    for name in _STATES:
        if name in cache_sharding:
            spec = tuple(cache_sharding[name].spec)
            out[name] = (spec[1] if len(spec) > 1 else None,
                         {d: e for d, e in enumerate(spec)
                          if d > 1 and e is not None})
    return out


def prefill_cell(cfg: ModelConfig, shape: ShapeSpec, mesh):
    """(step, (params, batch, cache) shapes, their shardings): the prefill
    step on the mesh (make_prefill_step(mesh=) over the cell's cache
    layout) and its arguments' specs."""
    from ..serve.serve_step import make_prefill_step
    model = _meta_model(cfg)
    params_shape = model.params
    pshard = param_sharding_tree(params_shape, mesh)
    B, S = shape.global_batch, shape.seq_len
    cache = model.init_cache(B, S, enc_len=S)
    p_seq_sharded, p_seq_axis = _kv_seq_sharded(cfg, shape, mesh)
    cshard = cache_shardings(cache, mesh, seq_sharded=p_seq_sharded,
                             seq_axis=p_seq_axis)
    bspecs = batch_specs(cfg, shape)
    bshard = batch_shardings(cfg, mesh)
    args = (params_shape, bspecs, cache)
    shardings = sanitize((pshard, bshard, cshard), args, mesh)
    step = make_prefill_step(model, mesh=mesh,
                             cache_spec=strips_spec(shardings[2]),
                             state=state_blocks(shardings[2]))
    return step, args, shardings


def _kv_seq_sharded(cfg: ModelConfig, shape: ShapeSpec, mesh):
    """Shard the KV-cache SEQUENCE dimension when either (a) the batch is too
    small for the data axis (batch-1 long-context decode) or (b) the KV head
    count does not divide the model axis - otherwise the cache would be
    REPLICATED across the model axis.  Returns (seq_sharded, seq_axis)."""
    sizes = axis_sizes(mesh)
    data_size = sizes.get("data", 1)
    model_size = sizes.get("model", 1)
    small_batch = shape.global_batch < data_size
    kv_indivisible = cfg.n_kv_heads % model_size != 0
    if small_batch:
        return True, "data"
    if kv_indivisible:
        return True, "model"
    return False, "data"


def serve_cell(cfg: ModelConfig, shape: ShapeSpec, mesh):
    """(step, (params, cache, tokens, lens) shapes, their shardings): the
    decode step on the mesh (make_serve_step(seq_parallel=, mesh=) over
    the cell's cache layout: sequence-parallel where _kv_seq_sharded
    shards the sequence) and its arguments' specs."""
    from ..serve.serve_step import make_serve_step
    model = _meta_model(cfg)
    names = axis_names(mesh)
    data_size = axis_sizes(mesh).get("data", 1)
    seq_sharded, seq_axis = _kv_seq_sharded(cfg, shape, mesh)
    params_shape = model.params
    pshard = param_sharding_tree(params_shape, mesh)
    cache, tokens, lens = decode_specs(model, cfg, shape)
    cshard = cache_shardings(cache, mesh, seq_sharded=seq_sharded,
                             seq_axis=seq_axis)
    dp = dp_axes(names) if shape.global_batch >= data_size else None
    tshard = NamedSharding(mesh, P(dp, None))
    lshard = NamedSharding(mesh, P(dp))
    args = (params_shape, cache, tokens, lens)
    shardings = sanitize((pshard, cshard, tshard, lshard), args, mesh)
    step = make_serve_step(model, seq_parallel=seq_sharded, mesh=mesh,
                           cache_spec=strips_spec(shardings[1]),
                           state=state_blocks(shardings[1]))
    return step, args, shardings
