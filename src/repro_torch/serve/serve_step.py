"""Serving steps: the single-token decode step (stepwise admission of the
recurrent families), the monolithic prefill steps (dense and paged), the
single-chunk step (the sequential chunk oracle and the prefix-cached
suffix), and the chunk-batch, fused decode and speculative verify steps
of the one-launch tick.

On a (data, model) mesh (mesh=, a launch/mesh.py DeviceMesh; the steps
of launch/specs.py prefill_cell and serve_cell), make_prefill_step and
make_serve_step return steps over the rank's shards, the counterparts of
the JAX steps jitted with the cell's shardings: the parameters arrive as
the cell's sharded DTensors and are gathered into full tensors (ZeRO-3,
as the mesh train step; the model's own tensors are not used, so a cell's
model may lie on the meta device), the batch, tokens and lens as this
rank's rows, and the dense cache as this rank's block of the strips in
the layout of the cell's cache spec (sharding/rules.py cache_spec: KV
heads over the model axis; the sequence over the data axis; the sequence
over the model axis).  The attention runs on the rank's heads and
sequence block (models/attention.py CacheShard); the logits are the
rank's rows'.  Every family: an MoE layer runs the per-row dispatch on
the rank's rows, and with REPRO_MOE_A2A set and S a multiple of the
model axis the prefill takes the expert-parallel exchange
(models/moe.py; decode's S = 1 never does); whisper's self and cross
strips share one layout (the spec of self_k), the encoder runs on the
model rank's head shard, and the decode reads the cross strips without
writing them; zamba2's Mamba2 layers and rwkv6's time-mix run every head
on the rank's rows, replicated over the model axis as the JAX package
lays their scans out, each state leaf holding the rank's block of its
heads or channels where its own spec splits it (CacheShard.state; the
decode gathers the conv outputs and the per-head outputs, and sums
rwkv6's partials over a split of its key channels), and zamba2's shared
block attends on the head shard through its strips (shared_k /
shared_v, in the strips' layout).

Each step is one eager call into the model; the chunk-batch and decode
steps add device-side sampling and masked updates of the engine's (B, 1)
tokens and (B,) lens - no per-slot host work and no transfer to the host
(the engine fetches the tokens once per tick).  Lane contract (what
chunked prefill leans on): the fused decode step computes every lane, but
a lane whose lens is 0 and whose block-table row is zeroed writes its K/V
into the reserved null page (a dense lane: position 0 of its own strip),
and its `live` mask keeps tokens / lens untouched.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..models.attention import CacheShard
from . import sampling


def _set_rows(dst: torch.Tensor, idx: torch.Tensor,
              vals: torch.Tensor) -> torch.Tensor:
    """dst (B,) with dst[idx[k]] = vals[k], rows whose idx is the
    out-of-range sentinel B dropped (the JAX scatter's mode="drop").  The
    sentinel rows land in one spare element past the end, which is cut
    off: no boolean indexing, no host synchronisation."""
    B = dst.shape[0]
    ext = torch.cat([dst, dst.new_zeros(1)])
    ext.scatter_(0, torch.clamp(idx.long(), max=B), vals.to(dst.dtype))
    return ext[:B]


def sample_token(logits: torch.Tensor, *, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 1.0,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
    """logits (B, 1, V) -> (B, 1) int32 through serve/sampling.py."""
    return sampling.sample(logits[:, -1], generator,
                           temperature=temperature, top_k=top_k,
                           top_p=top_p)[:, None]


def cache_shard(mesh, spec, state=None) -> CacheShard:
    """The CacheShard of a dense cache on `mesh`: its (L, B, S, Hkv, D)
    strips laid out by `spec` (a cache_spec, sanitized: the spec of "k",
    or whisper's "self_k", or zamba2's "shared_k", which the other
    strips share; None for a cache without strips) - the model axis for
    the head-sharded attention, whether the strips hold its KV-head
    block, and the axis their sequence is split over - and its recurrent
    state leaves laid out as `state` (launch/specs.py state_blocks: leaf
    -> (rows entry, {dim: axis})), each split dim's axis in
    CacheShard.state.  The strips and every state leaf must split the
    batch rows alike: the step gets one block of rows."""
    from ..launch.mesh import axis_mesh
    model_axis = axis_mesh(mesh, "model")
    state = state or {}
    rows = {leaf: r for leaf, (r, _) in state.items()}
    blocks = {}
    for leaf, (_, dims) in state.items():
        for d, entry in dims.items():
            if isinstance(entry, tuple):
                raise ValueError(f"state leaf {leaf!r}: dim {d} split "
                                 f"over several axes has no mesh step")
            if axis_mesh(mesh, entry) is not None:
                blocks.setdefault(leaf, {})[d] = axis_mesh(mesh, entry)
    if spec is None:
        if len(set(rows.values())) > 1:
            raise ValueError(f"the state leaves split their rows "
                             f"differently: {rows}")
        return CacheShard(model=model_axis, state=blocks)
    spec = tuple(spec) + (None,) * (5 - len(spec))
    seq_entry, head_entry = spec[2], spec[3]
    for entry in (seq_entry, head_entry):
        if isinstance(entry, tuple):
            raise ValueError(f"cache spec {spec}: a sequence or head dim "
                             f"split over several axes has no mesh step")
    if head_entry not in (None, "model"):
        raise ValueError(f"cache spec {spec}: KV heads split over "
                         f"{head_entry!r}, not the model axis")
    if any(r != spec[1] for r in rows.values()):
        raise ValueError(f"cache spec {spec}: the state leaves split their "
                         f"rows otherwise: {rows}")
    return CacheShard(model=model_axis,
                      heads=head_entry is not None and model_axis is not None,
                      seq=axis_mesh(mesh, seq_entry) if seq_entry else None,
                      state=blocks)


def _full_params(params):
    """The full parameters of a mesh step: the cell's sharded DTensors
    gathered into new full tensors on their device (sharding/shards.py
    gather_full: one all_gather a sharded mesh dim of a leaf), or plain
    tensors, taken as the full parameters every rank already holds.  The
    model's own tensors are not used (a cell's model lies on the meta
    device)."""
    from torch.distributed.tensor import DTensor

    from ..sharding.shards import gather_full
    from ..tree import leaves, map_tree
    is_d = [isinstance(p, DTensor) for p in leaves(params)]
    if not any(is_d):
        return params
    if not all(is_d):
        raise ValueError("a mesh step takes every parameter as a DTensor "
                         "(the cell's shardings) or none")
    return map_tree(gather_full, params)


def make_serve_step(model, *, seq_parallel: bool = False, mesh=None,
                    cache_spec=None, state=None):
    """serve_step(params, cache, tokens (B, 1), lens (B,)) -> (logits (B,
    1, V), cache): one new token per lane against the cache
    (Model.decode_step; seq_parallel=True decodes the attention through
    ops.decode_attention_naive).  On a mesh (the module docstring), the
    cache laid out by cache_spec (default sharding/rules.py cache_spec with
    seq_sharded=seq_parallel over the data axis): the default layout runs
    K3 on the rank's KV heads and gathers the heads over the model axis; a
    sequence-sharded one runs ops.seq_parallel_decode over its axis (no
    window, as the JAX package's naive decode), on the rank's heads where
    the strips hold a head block.  seq_parallel must say whether the
    spec shards the sequence.  state (launch/specs.py state_blocks): the
    recurrent families' state leaves, each the rank's block where its
    spec splits it (cache_shard); a cache with states and no strips
    (rwkv6's) takes no cache_spec and ignores seq_parallel, as its
    unsharded decode does."""
    if mesh is None:
        def serve_step(params, cache, tokens, lens):
            return model.decode_step(params, tokens, lens, cache,
                                     seq_parallel=seq_parallel)

        return serve_step
    from ..sharding.rules import axis_names
    from ..sharding.rules import cache_spec as default_spec
    spec = cache_spec if cache_spec is not None or state else default_spec(
        axis_names(mesh), seq_sharded=seq_parallel)
    shard = cache_shard(mesh, spec, state)
    if spec is not None and (shard.seq is not None) != bool(seq_parallel):
        raise ValueError(f"seq_parallel={seq_parallel} and cache spec "
                         f"{tuple(spec)}: the sequence-parallel decode runs "
                         f"exactly where the spec shards the sequence")

    def mesh_serve_step(params, cache, tokens, lens):
        from ..launch.mesh import check_mesh_family
        check_mesh_family(model.cfg, "decoding")
        return model.decode_step(_full_params(params), tokens, lens,
                                 cache, shard=shard)

    return mesh_serve_step


def make_prefill_step(model, *, mesh=None, cache_spec=None, state=None):
    """prefill_step(params, batch, cache) -> (last_logits, cache, lens):
    monolithic prefill into the dense cache (Model.prefill), the whole
    batch passed through - the audio family's audio_embeds and the vlm
    family's vision_embeds with the tokens (lens then counts the image
    positions too).  On a mesh (the module docstring), the cache laid out
    by cache_spec (default: sharding/rules.py cache_spec's default
    layout): K4 on the model rank's head shard, the rank's KV heads and
    positions of each prompt written into its block of the strips; an
    MoE layer's exchange (REPRO_MOE_A2A) gathers the rows over the axes
    the cache spec splits the batch over; the recurrent state leaves
    laid out as `state` (make_serve_step), the rank writing its block of
    each."""
    if mesh is None:
        def prefill_step(params, batch, cache):
            return model.prefill(params, batch, cache)

        return prefill_step
    from ..models.moe import MoEMesh
    from ..sharding.rules import axis_names, entry_axes
    from ..sharding.rules import cache_spec as default_spec
    spec = cache_spec if cache_spec is not None or state \
        else default_spec(axis_names(mesh), seq_sharded=False)
    shard = cache_shard(mesh, spec, state)
    moe_mesh = MoEMesh(mesh, entry_axes(tuple(spec)[1])) \
        if model.cfg.moe_experts else None

    def mesh_prefill_step(params, batch, cache):
        from ..launch.mesh import check_mesh_family
        check_mesh_family(model.cfg, "prefilling")
        return model.prefill(_full_params(params), batch, cache,
                             shard=shard, moe_mesh=moe_mesh)

    return mesh_prefill_step


def make_paged_prefill_step(model):
    """paged_prefill_step(params, batch, cache, page_ids) -> (last_logits,
    cache, lens).  batch["tokens"]: (1, S_pad) prompt padded to a page
    multiple, real length in batch["true_lens"]; page_ids: (S_pad //
    page_size,) pages owned by the sequence (PageAllocator)."""

    def paged_prefill_step(params, batch, cache, page_ids):
        return model.prefill_paged(params, batch, cache, page_ids)

    return paged_prefill_step


def make_suffix_prefill_step(model):
    """suffix_prefill_step(params, batch, cache, page_row) -> (last_logits,
    cache, lens).  Prefix-cached prefill: batch["tokens"] (1, S_pad) holds
    only the uncached prompt suffix (zero-padded), its absolute start in
    batch["offset"], the full prompt length in batch["true_lens"];
    page_row (n_max,) the sequence's block-table row, cached prefix pages
    first (Model.prefill_suffix)."""

    def suffix_prefill_step(params, batch, cache, page_row):
        return model.prefill_suffix(params, batch, cache, page_row)

    return suffix_prefill_step


def make_chunk_prefill_step(model, *, tp_mesh=None):
    """chunk_prefill_step(params, batch, cache, page_row) ->
    (chunk_last_logits, cache, cursor).  One chunk of one sequence's
    prompt: batch["tokens"] (1, S_pad) the chunk zero-padded to a page
    multiple, its absolute start in batch["offset"], the cursor after its
    last real token in batch["true_lens"] (the full prompt length only
    for the final chunk, whose logits seed decoding); page_row (n_max,)
    (Model.prefill_chunk).  tp_mesh head-shards the attention, as in
    make_chunk_batch_step."""

    def chunk_prefill_step(params, batch, cache, page_row):
        return model.prefill_chunk(params, batch, cache, page_row,
                                   tp_mesh=tp_mesh)

    return chunk_prefill_step


def make_chunk_batch_step(model, *, temperature: float, top_k: int = 0,
                          top_p: float = 1.0, tp_mesh=None):
    """chunk_batch_step(params, batch, cache, page_tables, tokens, lens,
    generator) -> (cache, tokens, lens).  One call for a whole tick's
    prefill plan: runs every packed chunk row (Model.prefill_chunks),
    samples the first token of every row that completed its prompt, and
    writes those tokens and cursors into tokens / lens at batch
    ["final_slot"] (the sentinel max_batch for non-final and dead rows,
    which is dropped).  tp_mesh (a launch/mesh.py serve mesh): the cache's
    pools are this rank's head shard, the attention runs on it and gathers
    back, and the sampling is replicated - every rank samples the same
    tokens from the same logits and the same generator state."""

    def chunk_batch_step(params, batch, cache, page_tables, tokens, lens,
                         generator):
        logits, cache, cursors = model.prefill_chunks(params, batch, cache,
                                                      page_tables,
                                                      tp_mesh=tp_mesh)
        toks = sample_token(logits, temperature=temperature, top_k=top_k,
                            top_p=top_p, generator=generator)
        slots = batch["final_slot"]
        tokens = _set_rows(tokens[:, 0], slots, toks[:, 0])[:, None]
        lens = _set_rows(lens, slots, cursors)
        return cache, tokens, lens

    return chunk_batch_step


def make_fused_decode_step(model, *, temperature: float, top_k: int = 0,
                           top_p: float = 1.0, tp_mesh=None):
    """fused_decode_step(params, cache, tokens, lens, live, generator) ->
    (cache, tokens, lens).  One batched decode step with sampling fused
    in: lanes where `live` (B,) is True take their sampled token and
    lens + 1, dead lanes pass through untouched.  tp_mesh: as in
    make_chunk_batch_step."""

    def fused_decode_step(params, cache, tokens, lens, live, generator):
        logits, cache = model.decode_step(params, tokens, lens, cache,
                                          tp_mesh=tp_mesh)
        toks = sample_token(logits, temperature=temperature, top_k=top_k,
                            top_p=top_p, generator=generator)
        tokens = torch.where(live[:, None], toks, tokens)
        lens = lens + live.to(lens.dtype)
        return cache, tokens, lens

    return fused_decode_step


def make_spec_verify_step(model, *, temperature: float, top_k: int = 0,
                          top_p: float = 1.0, tp_mesh=None):
    """spec_verify_step(params, batch, cache, page_tables, tokens, lens,
    generator) -> (cache, tokens, lens, n_acc).  One call verifies every
    draft chain planned this tick (the scheduler's SpecBatch): row r
    holds [pending token, d_1 .. d_m] at offset = the slot's lens, scored
    through K1 (Model.verify_chunks), the chain's K/V written into the
    slot's pages on the way.  The target's token is sampled at every
    position (sampling.sample_chain); a draft token is accepted iff it
    matches, and the first mismatch (or the chain's end) yields the
    target's own token as the bonus, so each row nets n_acc + 1 tokens.
    tokens[slot] becomes the bonus and lens[slot] offset + n_acc + 1;
    K/V past it is dead (masked, later overwritten).  Rows whose
    batch["row_slot"] is the sentinel max_batch are dropped.  The host
    reads n_acc in the tick's one fetch.  tp_mesh: as in
    make_chunk_batch_step (K1's verify lane on the head shard)."""

    def spec_verify_step(params, batch, cache, page_tables, tokens, lens,
                         generator):
        logits, cache = model.verify_chunks(params, batch, cache,
                                            page_tables, tp_mesh=tp_mesh)
        tgt = sampling.sample_chain(logits, generator,
                                    temperature=temperature, top_k=top_k,
                                    top_p=top_p)
        n_acc, bonus = sampling.speculative_accept(
            tgt, batch["tokens"], batch["draft_lens"])
        slots = batch["row_slot"]
        tokens = _set_rows(tokens[:, 0], slots, bonus)[:, None]
        lens = _set_rows(lens, slots, batch["offset"] + n_acc + 1)
        return cache, tokens, lens, n_acc

    return spec_verify_step
