"""Serving steps: the single-token decode step (stepwise admission of the
recurrent families), the monolithic prefill steps (dense and paged), the
single-chunk step (the sequential chunk oracle and the prefix-cached
suffix), and the chunk-batch, fused decode and speculative verify steps
of the one-launch tick.

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


def make_serve_step(model, *, seq_parallel: bool = False):
    """serve_step(params, cache, tokens (B, 1), lens (B,)) -> (logits (B,
    1, V), cache): one new token per lane against the cache
    (Model.decode_step; seq_parallel=True decodes the attention through
    ops.decode_attention_naive)."""

    def serve_step(params, cache, tokens, lens):
        return model.decode_step(params, tokens, lens, cache,
                                 seq_parallel=seq_parallel)

    return serve_step


def make_prefill_step(model):
    """prefill_step(params, batch, cache) -> (last_logits, cache, lens):
    monolithic prefill into the dense cache (Model.prefill), the whole
    batch passed through - the audio family's audio_embeds and the vlm
    family's vision_embeds with the tokens (lens then counts the image
    positions too)."""

    def prefill_step(params, batch, cache):
        return model.prefill(params, batch, cache)

    return prefill_step


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
