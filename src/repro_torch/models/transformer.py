"""Layer loops of every ported family: the dense and MoE decoders (full-
sequence forward, and prefill and decode over the dense or the paged KV
cache; an MoE block's FFN is models/moe.py's moe_ffn), the
hybrid zamba2 stack (Mamba2 layers with one shared-weight attention block
after every shared_attn_every-th layer), the RWKV6 stack, and whisper's
encoder-decoder (a non-causal encoder stack, then decoder blocks of causal
self-attention, cross-attention over the encoder output and the MLP).

A Python loop over layers takes the place of the JAX package's lax.scan:
layer l reads its slices of the stacked (L, ...) parameters and updates its
strips k[l] / v[l], its slab k_pages[l] / v_pages[l] or its recurrent state
of the cache in place.  The gemma3 local:global pattern and the hybrid
stack's shared block are a Python `if` per layer instead of lax.cond.  The
forwards are also the training forwards: with remat each layer runs under
torch.utils.checkpoint, the counterpart of jax.checkpoint on the scanned
body.  Each forward returns (x, aux): the MoE load-balancing losses summed
over the layers in float32 (carried out of the checkpointed layers), a
float32 zero for a stack without MoE; the cache-walking stacks drop the
aux, as the JAX ones do.  The JAX stacks' grad_cast,
optimization_barrier and constrain are XLA and sharding hints with no
counterpart here.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from . import moe
from .attention import (attn_decode, attn_decode_paged, attn_forward,
                        attn_prefill, attn_prefill_chunks_paged,
                        attn_prefill_cross, attn_prefill_paged)
from .layers import apply_norm, mlp
from .mamba2 import (mamba2_decode, mamba2_forward, mamba2_init_state,
                     mamba2_prefill)
from .rwkv6 import rwkv6_channel_mix, rwkv6_init_state, rwkv6_time_mix


def _layer_windows(cfg: ModelConfig) -> List[bool]:
    """Per-layer is_global flags for the gemma3 local:global pattern."""
    if cfg.sliding_window and cfg.global_every:
        return [i % cfg.global_every == cfg.global_every - 1
                for i in range(cfg.n_layers)]
    return [True] * cfg.n_layers


def _windowed(cfg: ModelConfig, is_global: bool) -> int:
    """The attention window of a layer: 0 (full) for a global layer of the
    local:global pattern, the config's sliding window otherwise."""
    if cfg.sliding_window and cfg.global_every:
        return 0 if is_global else cfg.sliding_window
    return cfg.sliding_window


def _layer(blocks, l: int):
    """Layer l's parameters out of the stacked (L, ...) tree."""
    return {name: {k: v[l] for k, v in group.items()}
            for name, group in blocks.items()}


def _ffn_aux(p, x: torch.Tensor, cfg: ModelConfig, moe_mesh=None):
    """Post-attention half of a block: norm -> (moe | mlp) -> residual.
    moe_mesh: a mesh step's moe.MoEMesh (moe.moe_ffn).  Returns (x, the
    MoE aux loss, or None without MoE)."""
    y_in = apply_norm(p["n2"], x, cfg)
    if cfg.moe_experts:
        y, aux = moe.moe_ffn(p["moe"], y_in, cfg) if moe_mesh is None \
            else moe.moe_ffn(p["moe"], y_in, cfg, moe_mesh)
        return x + y, aux
    return x + mlp(p["mlp"], y_in, cfg), None


def _ffn_tail(p, x: torch.Tensor, cfg: ModelConfig,
              moe_mesh=None) -> torch.Tensor:
    return _ffn_aux(p, x, cfg, moe_mesh)[0]


def _zero_aux(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _layers(blocks, n_layers: int):
    """Every layer's parameters out of the stacked (L, ...) tree, with one
    torch.unbind per leaf.  Its backward stacks the L slice gradients into
    the leaf's gradient once; slicing with v[l] (_layer) would instead
    add L zero-padded full-size gradients into each leaf."""
    per_leaf = {name: {k: torch.unbind(v) for k, v in group.items()}
                for name, group in blocks.items()}
    return [{name: {k: v[l] for k, v in group.items()}
             for name, group in per_leaf.items()} for l in range(n_layers)]


def _run(fn, remat: bool, *args):
    """fn(*args), under torch.utils.checkpoint when remat is on."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _block_aux(p, x: torch.Tensor, cfg: ModelConfig, window: int,
               impl: Optional[str], causal: bool = True, tp_mesh=None,
               moe_mesh=None):
    """An attention block over x; returns (x, MoE aux or None).  tp_mesh:
    the attention on this rank's head shard (attn_forward); moe_mesh: the
    MoE FFN's (_ffn_aux)."""
    h = attn_forward(p["attn"], apply_norm(p["n1"], x, cfg), cfg,
                     causal=causal, window=window, impl=impl,
                     tp_mesh=tp_mesh)
    return _ffn_aux(p, x + h, cfg, moe_mesh)


def _block(p, x: torch.Tensor, cfg: ModelConfig, window: int,
           impl: Optional[str], causal: bool = True) -> torch.Tensor:
    return _block_aux(p, x, cfg, window, impl, causal)[0]


def stack_forward(blocks, x: torch.Tensor, cfg: ModelConfig, *,
                  impl: Optional[str] = None, remat: bool = False,
                  tp_mesh=None, moe_mesh=None):
    """Causal self-attention blocks over the whole sequence x (B, S, D).
    remat=True keeps only each layer's input for the backward and runs the
    layer again there (the attention forward, and the MoE exchange's and
    the aux share's collectives, included).  tp_mesh: each attention on
    this rank's head shard (attn_forward); moe_mesh: each MoE FFN's mesh
    (moe.moe_ffn).  Returns (x, the layers' MoE aux losses summed in layer
    order, a float32 zero without MoE)."""
    aux = _zero_aux(x)
    for p, is_global in zip(_layers(blocks, cfg.n_layers),
                            _layer_windows(cfg)):
        x, a = _run(_block_aux, remat, p, x, cfg,
                    _windowed(cfg, is_global), impl, True, tp_mesh,
                    moe_mesh)
        if a is not None:
            aux = aux + a
    return x, aux


def stack_prefill(blocks, x: torch.Tensor, cfg: ModelConfig, cache, *,
                  impl: Optional[str] = None, shard=None,
                  moe_mesh=None) -> torch.Tensor:
    """Prefill from position 0 into the dense cache {"k"/"v": (L, B,
    S_max, Hkv, D)}, updated in place.  x: (B, S, D).  shard: the rank's
    block of the strips on a mesh (attention.CacheShard); moe_mesh: the
    MoE FFN's mesh (moe.moe_ffn)."""
    for l, is_global in enumerate(_layer_windows(cfg)):
        p = _layer(blocks, l)
        h = attn_prefill(p["attn"], apply_norm(p["n1"], x, cfg), cfg,
                         cache["k"][l], cache["v"][l],
                         window=_windowed(cfg, is_global), impl=impl,
                         shard=shard)
        x = _ffn_tail(p, x + h, cfg, moe_mesh)
    return x


def stack_decode(blocks, x: torch.Tensor, cfg: ModelConfig, cache,
                 lens: torch.Tensor, *, impl: Optional[str] = None,
                 seq_parallel: bool = False, shard=None) -> torch.Tensor:
    """Batched single-token decode against the dense cache; seq_parallel
    runs ops.decode_attention_naive in place of K3 (and drops the
    windows: attn_decode).  shard: the rank's block of the strips on a
    mesh (attention.CacheShard)."""
    for l, is_global in enumerate(_layer_windows(cfg)):
        p = _layer(blocks, l)
        h = attn_decode(p["attn"], apply_norm(p["n1"], x, cfg), cfg,
                        cache["k"][l], cache["v"][l], lens,
                        window=_windowed(cfg, is_global), impl=impl,
                        seq_parallel=seq_parallel, shard=shard)
        x = _ffn_tail(p, x + h, cfg)
    return x


def stack_prefill_paged(blocks, x: torch.Tensor, cfg: ModelConfig, cache,
                        page_ids: torch.Tensor, *,
                        impl: Optional[str] = None) -> torch.Tensor:
    """Paged prefill of ONE sequence, x: (1, S, D) with S a multiple of the
    page size, into its pages page_ids (S // page_size,); the block table
    passes through untouched (the engine owns it)."""
    for l, is_global in enumerate(_layer_windows(cfg)):
        p = _layer(blocks, l)
        h = attn_prefill_paged(p["attn"], apply_norm(p["n1"], x, cfg), cfg,
                               cache["k_pages"][l], cache["v_pages"][l],
                               page_ids, window=_windowed(cfg, is_global),
                               impl=impl)
        x = _ffn_tail(p, x + h, cfg)
    return x


def stack_prefill_chunks_paged(blocks, x: torch.Tensor, cfg: ModelConfig,
                               cache, page_tables: torch.Tensor,
                               offsets: torch.Tensor,
                               true_lens: torch.Tensor, *,
                               q_lens: Optional[torch.Tensor] = None,
                               impl: Optional[str] = None,
                               tp_mesh=None) -> torch.Tensor:
    """A ragged batch of mid-prompt chunks through every layer.  x: (K, S,
    D); cache: {"k_pages"/"v_pages": (L, P, page_size, Hkv, D)}, updated in
    place.  Two chunks of one sequence may share the batch (ordered
    offsets): each layer scatters every row's K/V before its attention
    reads the pool.  tp_mesh: the pools hold this rank's Hkv / N heads and
    each layer's attention runs head-sharded (attention.py)."""
    for l, is_global in enumerate(_layer_windows(cfg)):
        p = _layer(blocks, l)
        h = attn_prefill_chunks_paged(
            p["attn"], apply_norm(p["n1"], x, cfg), cfg,
            cache["k_pages"][l], cache["v_pages"][l], page_tables, offsets,
            true_lens, q_lens=q_lens, window=_windowed(cfg, is_global),
            impl=impl, tp_mesh=tp_mesh)
        x = _ffn_tail(p, x + h, cfg)
    return x


def stack_prefill_chunk_paged(blocks, x: torch.Tensor, cfg: ModelConfig,
                              cache, page_row: torch.Tensor, offset: int, *,
                              impl: Optional[str] = None,
                              tp_mesh=None) -> torch.Tensor:
    """ONE mid-prompt chunk of ONE sequence, the K=1 case of
    stack_prefill_chunks_paged: x (1, S, D) at positions offset +
    arange(S), every position real; page_row (n_max,)."""
    off = torch.full((1,), int(offset), dtype=torch.int32, device=x.device)
    return stack_prefill_chunks_paged(
        blocks, x, cfg, cache, page_row.reshape(1, -1).to(torch.int32),
        off, off + x.shape[1], impl=impl, tp_mesh=tp_mesh)


# the prefix-cache suffix is the final-chunk special case
stack_prefill_suffix_paged = stack_prefill_chunk_paged


def stack_decode_paged(blocks, x: torch.Tensor, cfg: ModelConfig, cache,
                       lens: torch.Tensor, *,
                       impl: Optional[str] = None,
                       tp_mesh=None) -> torch.Tensor:
    """Batched single-token decode through the block table (all layers
    share one table; each layer owns its own pool slab).  tp_mesh: as in
    stack_prefill_chunks_paged."""
    bt = cache["block_table"]
    for l, is_global in enumerate(_layer_windows(cfg)):
        p = _layer(blocks, l)
        h = attn_decode_paged(
            p["attn"], apply_norm(p["n1"], x, cfg), cfg,
            cache["k_pages"][l], cache["v_pages"][l], bt, lens,
            window=_windowed(cfg, is_global), impl=impl, tp_mesh=tp_mesh)
        x = _ffn_tail(p, x + h, cfg)
    return x


# ===========================================================================
# hybrid stack (zamba2): Mamba2 layers + one shared attention block
# ===========================================================================

def n_shared_applications(cfg: ModelConfig) -> int:
    k = cfg.shared_attn_every
    return cfg.n_layers // k if k else 0


def _shared_at(cfg: ModelConfig, idx: int) -> bool:
    """Whether the shared block follows Mamba2 layer idx."""
    k = cfg.shared_attn_every
    return bool(k) and idx % k == k - 1


def _hybrid_layer(p, shared, x: torch.Tensor, impl: Optional[str], *,
                  cfg: ModelConfig, tp_mesh=None) -> torch.Tensor:
    x = x + mamba2_forward(p, x, cfg, impl=impl)
    if shared is not None:
        x = _block_aux(shared, x, cfg, 0, impl, True, tp_mesh)[0]
    return x


def hybrid_layers(blocks, cfg: ModelConfig, tp_mesh=None) -> List[Callable]:
    """One callable per layer, f(x, impl) -> x: Mamba2 layer l, then the
    shared block where it follows layer l.  blocks: {"mamba": stacked (L,
    ...) Mamba2 leaves, "shared": one attention block (n1, attn, n2, mlp),
    unstacked}.  tp_mesh: the shared block's attention on this rank's
    head shard (attn_forward); the Mamba2 layers run every head."""
    shared = blocks["shared"]
    return [partial(_hybrid_layer, p["mamba"],
                    shared if _shared_at(cfg, idx) else None, cfg=cfg,
                    tp_mesh=tp_mesh)
            for idx, p in enumerate(_layers({"mamba": blocks["mamba"]},
                                            cfg.n_layers))]


def hybrid_forward(blocks, x: torch.Tensor, cfg: ModelConfig, *,
                   impl: Optional[str] = None, remat: bool = False,
                   tp_mesh=None):
    """The hybrid stack over the whole sequence x (B, S, D).  tp_mesh (the
    sharded train step's model axis): the shared block's attention on
    this rank's head shard, the Mamba2 layers replicated over the axis
    (the JAX "kv_rep" layout).  Returns (x, a float32 zero aux)."""
    for layer in hybrid_layers(blocks, cfg, tp_mesh):
        x = _run(layer, remat, x, impl)
    return x, _zero_aux(x)


def hybrid_init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                      device):
    """Per-layer conv windows and SSM states (L, batch, ...), and one dense
    K / V strip (A, batch, max_len, Hkv, D) per application of the shared
    block."""
    st = mamba2_init_state(cfg, batch, dtype, device)
    L = cfg.n_layers
    A = max(n_shared_applications(cfg), 1)
    kv = (A, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"conv": st["conv"].new_zeros((L,) + st["conv"].shape),
            "ssm": st["ssm"].new_zeros((L,) + st["ssm"].shape),
            "shared_k": torch.zeros(kv, dtype=dtype, device=device),
            "shared_v": torch.zeros(kv, dtype=dtype, device=device)}


def hybrid_prefill(blocks, x: torch.Tensor, cfg: ModelConfig, cache, *,
                   impl: Optional[str] = None, shard=None) -> torch.Tensor:
    """Full-sequence prefill from position 0: the chunked SSD scans fill
    the per-layer conv / SSM states, the shared block prefills its K / V
    strips; the cache is updated in place.  shard (a mesh step's
    attention.CacheShard): the cache holds the rank's block of the
    strips and of each state leaf, the shared block's attention runs on
    the model rank's head shard (K4) and the Mamba2 layers on every head
    (mamba2_prefill)."""
    k = cfg.shared_attn_every
    shared = blocks["shared"]
    for idx in range(cfg.n_layers):
        p = {name: v[idx] for name, v in blocks["mamba"].items()}
        y, st = mamba2_prefill(p, x, cfg, shard=shard)
        x = x + y
        cache["conv"][idx].copy_(st["conv"])
        cache["ssm"][idx].copy_(st["ssm"])
        if _shared_at(cfg, idx):
            h = attn_prefill(shared["attn"],
                             apply_norm(shared["n1"], x, cfg), cfg,
                             cache["shared_k"][idx // k],
                             cache["shared_v"][idx // k], impl=impl,
                             shard=shard)
            x = _ffn_tail(shared, x + h, cfg)
    return x


def hybrid_decode(blocks, x: torch.Tensor, cfg: ModelConfig, cache,
                  lens: torch.Tensor, *, impl: Optional[str] = None,
                  seq_parallel: bool = False, shard=None) -> torch.Tensor:
    """One token per lane: each Mamba2 layer steps its conv window and SSM
    state, the shared block decodes against its strips at lens (written
    in place; seq_parallel as in stack_decode).  shard: as in
    hybrid_prefill - the Mamba2 step on the rank's state blocks
    (mamba2_decode), the shared block through attn_decode's mesh path
    (K3 on the rank's KV heads, or ops.seq_parallel_decode where the
    strips' sequence is split)."""
    k = cfg.shared_attn_every
    shared = blocks["shared"]
    for idx in range(cfg.n_layers):
        p = {name: v[idx] for name, v in blocks["mamba"].items()}
        y, st = mamba2_decode(p, x, cfg, {"conv": cache["conv"][idx],
                                          "ssm": cache["ssm"][idx]},
                              shard=shard)
        x = x + y
        cache["conv"][idx].copy_(st["conv"])
        cache["ssm"][idx].copy_(st["ssm"])
        if _shared_at(cfg, idx):
            h = attn_decode(shared["attn"],
                            apply_norm(shared["n1"], x, cfg), cfg,
                            cache["shared_k"][idx // k],
                            cache["shared_v"][idx // k], lens, impl=impl,
                            seq_parallel=seq_parallel, shard=shard)
            x = _ffn_tail(shared, x + h, cfg)
    return x


# ===========================================================================
# RWKV6 stack
# ===========================================================================

def _rwkv_layer(p, x: torch.Tensor, impl: Optional[str], *,
                cfg: ModelConfig) -> torch.Tensor:
    h, _ = rwkv6_time_mix(p["mix"], apply_norm(p["n1"], x, cfg), cfg,
                          impl=impl)
    x = x + h
    h, _ = rwkv6_channel_mix(p["mix"], apply_norm(p["n2"], x, cfg), cfg)
    return x + h


def rwkv_layers(blocks, cfg: ModelConfig) -> List[Callable]:
    """One callable per layer, f(x, impl) -> x.  blocks: {"n1", "n2",
    "mix"} stacked (L, ...)."""
    return [partial(_rwkv_layer, p, cfg=cfg)
            for p in _layers(blocks, cfg.n_layers)]


def rwkv_forward(blocks, x: torch.Tensor, cfg: ModelConfig, *,
                 impl: Optional[str] = None, remat: bool = False,
                 tp_mesh=None):
    """The RWKV6 stack over the whole sequence x (B, S, D).  tp_mesh (the
    sharded train step's model axis) is taken and unused: the WKV scan
    runs every head, replicated over the axis, as in the JAX package.
    Returns (x, a float32 zero aux)."""
    for layer in rwkv_layers(blocks, cfg):
        x = _run(layer, remat, x, impl)
    return x, _zero_aux(x)


def rwkv_init_cache(cfg: ModelConfig, batch: int, dtype, device):
    st = rwkv6_init_state(cfg, batch, dtype, device)
    return {k: v.new_zeros((cfg.n_layers,) + v.shape)
            for k, v in st.items()}


def rwkv_prefill(blocks, x: torch.Tensor, cfg: ModelConfig, cache, *,
                 impl: Optional[str] = None, shard=None) -> torch.Tensor:
    """Full-sequence prefill: the state-returning chunked WKV scan fills
    each layer's wkv state, the last normed inputs its token-shift
    carries; the cache is updated in place.  shard (a mesh step's
    attention.CacheShard): wkv holds the rank's block of its heads
    (rwkv6_time_mix), the shift carries the whole width."""
    for l in range(cfg.n_layers):
        p = _layer(blocks, l)
        h, (tm_last, wkv) = rwkv6_time_mix(
            p["mix"], apply_norm(p["n1"], x, cfg), cfg, impl=impl,
            return_state=True, shard=shard)
        x = x + h
        h, cm_last = rwkv6_channel_mix(p["mix"], apply_norm(p["n2"], x, cfg),
                                       cfg)
        x = x + h
        cache["wkv"][l].copy_(wkv)
        cache["tm_prev"][l].copy_(tm_last)
        cache["cm_prev"][l].copy_(cm_last)
    return x


def rwkv_decode(blocks, x: torch.Tensor, cfg: ModelConfig, cache,
                lens: torch.Tensor, *, impl: Optional[str] = None,
                seq_parallel: bool = False, shard=None) -> torch.Tensor:
    """One token per lane through every layer's recurrent state (lens and
    seq_parallel are unused, as in the JAX package: the state carries the
    position and has no sequence axis).  shard: as in rwkv_prefill, the
    step on the rank's heads of wkv, y gathered over the model axis."""
    for l in range(cfg.n_layers):
        p = _layer(blocks, l)
        h, (tm_last, wkv) = rwkv6_time_mix(
            p["mix"], apply_norm(p["n1"], x, cfg), cfg,
            x_prev=cache["tm_prev"][l], wkv_state=cache["wkv"][l],
            impl=impl, shard=shard)
        x = x + h
        h, cm_last = rwkv6_channel_mix(p["mix"], apply_norm(p["n2"], x, cfg),
                                       cfg, x_prev=cache["cm_prev"][l])
        x = x + h
        cache["wkv"][l].copy_(wkv)
        cache["tm_prev"][l].copy_(tm_last)
        cache["cm_prev"][l].copy_(cm_last)
    return x


# ===========================================================================
# encoder-decoder (whisper)
# ===========================================================================

def encode(blocks, x_enc: torch.Tensor, cfg: ModelConfig, *,
           impl: Optional[str] = None, tp_mesh=None) -> torch.Tensor:
    """The encoder stack over the audio frames x_enc (B, S_enc, D), non-
    causal self-attention blocks, then its final norm.  blocks: {"encoder":
    stacked (L_enc, ...) blocks, "enc_norm", ...}.  tp_mesh: each
    attention on this rank's head shard (attn_forward)."""
    for p in _layers(blocks["encoder"], cfg.encoder_layers):
        x_enc = _block_aux(p, x_enc, cfg, 0, impl, False, tp_mesh)[0]
    return apply_norm(blocks["enc_norm"], x_enc, cfg)


def _decoder_block(p, x: torch.Tensor, enc_out: torch.Tensor,
                   impl: Optional[str], *, cfg: ModelConfig,
                   tp_mesh=None) -> torch.Tensor:
    """Causal self-attention, cross-attention over enc_out, the MLP;
    tp_mesh: both attentions on this rank's head shard."""
    x = x + attn_forward(p["attn"], apply_norm(p["n1"], x, cfg), cfg,
                         impl=impl, tp_mesh=tp_mesh)
    x = x + attn_forward(p["cross_attn"], apply_norm(p["n_cross"], x, cfg),
                         cfg, causal=False, kv_x=enc_out, impl=impl,
                         tp_mesh=tp_mesh)
    return _ffn_tail(p, x, cfg)


def encdec_forward(blocks, x_enc: torch.Tensor, x_dec: torch.Tensor,
                   cfg: ModelConfig, *, impl: Optional[str] = None,
                   remat: bool = False, tp_mesh=None):
    """Encoder, then the decoder stack over x_dec (B, S, D).  remat=True
    recomputes each decoder layer in the backward (the JAX package
    checkpoints the decoder's scan body only, not the encoder's).
    tp_mesh (the sharded train step's model axis): every attention, the
    encoder's and the decoder's self and cross, on this rank's head shard
    (attn_forward).  Returns (x_dec, a float32 zero aux)."""
    enc_out = encode(blocks, x_enc, cfg, impl=impl, tp_mesh=tp_mesh)
    layer = partial(_decoder_block, cfg=cfg, tp_mesh=tp_mesh)
    for p in _layers(blocks["decoder"], cfg.n_layers):
        x_dec = _run(layer, remat, p, x_dec, enc_out, impl)
    return x_dec, _zero_aux(x_dec)


def encdec_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                      enc_len: int, dtype, device):
    """Per decoder layer a self-attention strip of max_len and a cross
    strip of enc_len positions for K and for V, (L, batch, S, Hkv, D)."""
    mk = lambda s: torch.zeros((cfg.n_layers, batch, s, cfg.n_kv_heads,
                                cfg.head_dim), dtype=dtype, device=device)
    return {"self_k": mk(max_len), "self_v": mk(max_len),
            "cross_k": mk(enc_len), "cross_v": mk(enc_len)}


def encdec_prefill(blocks, x_enc: torch.Tensor, x_dec: torch.Tensor,
                   cfg: ModelConfig, cache, *,
                   impl: Optional[str] = None, shard=None) -> torch.Tensor:
    """Decoder prefill from position 0 in one pass: the encoder runs once,
    each decoder layer fills its self-attention strips with the prompt's
    K/V and its cross strips with the encoder output's; the cache is
    updated in place.  shard: the rank's block of all four strips on a
    mesh (attention.CacheShard), the encoder's attention on the model
    rank's head shard too.  Returns the decoder's (B, S, D)."""
    enc_out = encode(blocks, x_enc, cfg, impl=impl,
                     tp_mesh=shard.model if shard else None)
    for l in range(cfg.n_layers):
        p = _layer(blocks["decoder"], l)
        x_dec = x_dec + attn_prefill(
            p["attn"], apply_norm(p["n1"], x_dec, cfg), cfg,
            cache["self_k"][l], cache["self_v"][l], impl=impl, shard=shard)
        x_dec = x_dec + attn_prefill_cross(
            p["cross_attn"], apply_norm(p["n_cross"], x_dec, cfg), cfg,
            enc_out, cache["cross_k"][l], cache["cross_v"][l], impl=impl,
            shard=shard)
        x_dec = _ffn_tail(p, x_dec, cfg)
    return x_dec


def encdec_decode(blocks, x: torch.Tensor, cfg: ModelConfig, cache,
                  lens: torch.Tensor, enc_lens: torch.Tensor, *,
                  impl: Optional[str] = None,
                  seq_parallel: bool = False, shard=None) -> torch.Tensor:
    """One decoder token per lane: self-attention against the strips at
    lens (written in place), cross-attention over the first enc_lens
    positions of the cross strips (read only); seq_parallel as in
    stack_decode, for both.  shard: the rank's block of all four strips
    on a mesh (attention.CacheShard); enc_lens then counts the whole
    cross strip's positions."""
    for l in range(cfg.n_layers):
        p = _layer(blocks["decoder"], l)
        x = x + attn_decode(p["attn"], apply_norm(p["n1"], x, cfg), cfg,
                            cache["self_k"][l], cache["self_v"][l], lens,
                            impl=impl, seq_parallel=seq_parallel,
                            shard=shard)
        x = x + attn_decode(p["cross_attn"],
                            apply_norm(p["n_cross"], x, cfg), cfg,
                            cache["cross_k"][l], cache["cross_v"][l],
                            enc_lens, impl=impl, seq_parallel=seq_parallel,
                            cross=True, shard=shard)
        x = _ffn_tail(p, x, cfg)
    return x
