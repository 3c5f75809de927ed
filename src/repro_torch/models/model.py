"""The language model as an nn.Module, with its forward and serving entry
points: the dense and MoE decoders over the dense and the paged KV cache,
the vision-language decoder (family "vlm": the dense decoder, its prompt
led by batch["vision_embeds"], the vision frontend stub's patch
embeddings), the hybrid zamba2 (family "hybrid") and RWKV6 (family "ssm")
models over their recurrent-state caches, and whisper's encoder-decoder
(family "audio") over its self-attention and cross-attention strips.

`Model` holds the JAX package's parameter tree as nn.Parameters in the same
stacked layout - {"tok": {"embed"}, "final_norm": {"scale"}, "blocks":
...} with a leading layer axis on every per-layer leaf; the dense blocks
(the vlm family's too) are {"n1", "attn", "n2", "mlp"}, the MoE ones
{"n1", "attn", "n2", "moe"} (models/moe.py), the hybrid ones {"mamba":
Mamba2 leaves, "shared": one unstacked attention block}, the RWKV6 ones
{"n1", "n2", "mix"}, the audio ones {"encoder": stacked dense blocks, "decoder":
stacked dense blocks with "n_cross" and "cross_attn", "enc_norm"} - and
exposes it as a plain nested dict (`Model.params`).  Every
leaf is in the config's dtype but those the JAX init keeps in float32
(the MoE router, Mamba2's A_log and dt_bias, RWKV6's w_base and u).  Like the
JAX package's Model, the entry points take the parameter tree as their
first argument, so the same module runs its own seeded weights or weights
carried over from the JAX package (models/convert.py).  The serving entry
points run eagerly under torch.no_grad(); the cache in `cache` (dense
strips, the paged pool, or the recurrent states) is updated in place and
returned.  The paged and chunked entry points need an attention family
and raise for the others, whose JAX Model has no such entry.  `loss` is the
training entry point: it runs with autograd on, and its gradients reach
every parameter leaf that requires one (the train state switches
requires_grad on; the parameters are created without it).  As in the JAX
package, only forward, loss and the dense prefill take the vlm family's
image embeddings; decode and the paged, chunked and verify entry points
take tokens only.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
from torch import nn

from ..configs.base import (ModelConfig, dense_equivalent_pages,
                            pages_for_tokens)
from . import mamba2, moe, rwkv6
from . import transformer as T
from .layers import (MAX_POSITION, apply_norm, embed, pdtype,
                     sinusoidal_positions, unembed)

ATTENTION_FAMILIES = ("dense", "moe", "vlm")
PORTED_FAMILIES = ("dense", "moe", "vlm", "hybrid", "ssm", "audio")
# per family served stepwise, the cache leaves that carry a recurrent state
# (the batch on axis 1): a lane that starts a new sequence starts them from
# zero.  whisper's strips carry none: a new sequence overwrites its self-
# attention strip position by position, and the cross strips are read only
RECURRENT_LEAVES = {"hybrid": ("conv", "ssm"),
                    "ssm": ("wkv", "tm_prev", "cm_prev"), "audio": ()}


def _params(shapes: Dict[str, tuple], dtype, device,
            fp32=()) -> nn.ParameterDict:
    """One group of parameters, in `dtype` but the names in `fp32`."""
    return nn.ParameterDict({
        k: nn.Parameter(torch.empty(
            s, dtype=torch.float32 if k in fp32 else dtype, device=device),
            requires_grad=False)
        for k, s in shapes.items()})


def _tree(module):
    """A ParameterDict / ModuleDict nest as nested dicts of tensors."""
    if isinstance(module, nn.ParameterDict):
        return dict(module.items())
    return {k: _tree(m) for k, m in module.items()}


def _fill(group, stacked: bool, gen, consts=None, stds=None):
    """Seed one group the JAX package's way: a leaf named in `consts` is
    that constant, one named in `stds` N(0, std^2), every other N(0,
    1 / d_in) with d_in its (per-layer) first axis; drawn in float32 from
    `gen`, layer by layer for a stacked group."""
    consts, stds = consts or {}, stds or {}
    for name, t in group.items():
        if name in consts:
            t.fill_(consts[name])
            continue
        for piece in (t if stacked else [t]):
            std = stds.get(name, 1.0 / math.sqrt(piece.shape[0]))
            piece.copy_(torch.randn(piece.shape, generator=gen,
                                    device=piece.device,
                                    dtype=torch.float32) * std)


def _norm_shapes(cfg: ModelConfig, lead: tuple = ()) -> Dict[str, tuple]:
    d = (*lead, cfg.d_model)
    if cfg.norm == "rmsnorm":
        return {"scale": d}
    if cfg.norm == "layernorm":
        return {"scale": d, "bias": d}
    return {}


def _block_params(cfg: ModelConfig, lead: tuple, dt, dev,
                  cross: bool = False) -> nn.ModuleDict:
    """An attention + MLP block {"n1", "attn", "n2", "mlp"} - "moe" in
    place of "mlp" for an MoE config, its router float32 - with `lead`
    (the layer axis, or nothing for the hybrid stack's shared block) in
    front of every leaf; cross=True adds whisper's decoder cross-attention
    {"n_cross", "cross_attn"}."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    attn = {"wq": (*lead, d, nq), "wk": (*lead, d, nkv),
            "wv": (*lead, d, nkv), "wo": (*lead, nq, d)}
    if cfg.qk_norm:
        attn.update(q_norm=(*lead, hd), k_norm=(*lead, hd))
    block = nn.ModuleDict({
        "n1": _params(_norm_shapes(cfg, lead), dt, dev),
        "attn": _params(attn, dt, dev),
        "n2": _params(_norm_shapes(cfg, lead), dt, dev)})
    if cfg.moe_experts:
        block["moe"] = _params({k: (*lead, *s) for k, s in
                                moe.moe_shapes(cfg).items()}, dt, dev,
                               moe.FP32_LEAVES)
    else:
        ffn = {"w_in": (*lead, d, f), "w_out": (*lead, f, d)}
        if cfg.act == "silu":
            ffn["w_gate"] = (*lead, d, f)
        block["mlp"] = _params(ffn, dt, dev)
    if cross:
        block["n_cross"] = _params(_norm_shapes(cfg, lead), dt, dev)
        block["cross_attn"] = _params(attn, dt, dev)
    return block


class Model(nn.Module):
    """The dense, MoE or vision-language decoder, the hybrid zamba2 model,
    the RWKV6 model or the whisper encoder-decoder."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        if cfg.family not in PORTED_FAMILIES:
            raise ValueError(f"unknown family {cfg.family!r}; the port runs "
                             f"the families {PORTED_FAMILIES}")
        self.cfg = cfg
        dt, dev = pdtype(cfg), torch.device(device)
        L, d = cfg.n_layers, cfg.d_model
        tok = {"embed": (cfg.vocab_size, d)}
        if not cfg.tie_embeddings:
            tok["lm_head"] = (cfg.vocab_size, d)
        self.tok = _params(tok, dt, dev)
        self.final_norm = _params(_norm_shapes(cfg), dt, dev)
        if cfg.family in ATTENTION_FAMILIES:
            self.blocks = _block_params(cfg, (L,), dt, dev)
        elif cfg.family == "audio":
            self.blocks = nn.ModuleDict({
                "encoder": _block_params(cfg, (cfg.encoder_layers,), dt, dev),
                "decoder": _block_params(cfg, (L,), dt, dev, cross=True),
                "enc_norm": _params(_norm_shapes(cfg), dt, dev)})
        elif cfg.family == "hybrid":
            shapes = {k: (L, *s) for k, s in mamba2.mamba2_shapes(cfg).items()}
            self.blocks = nn.ModuleDict({
                "mamba": _params(shapes, dt, dev, mamba2.FP32_LEAVES),
                "shared": _block_params(cfg, (), dt, dev)})
        else:
            shapes = {k: (L, *s) for k, s in rwkv6.rwkv6_shapes(cfg).items()}
            self.blocks = nn.ModuleDict({
                "n1": _params(_norm_shapes(cfg, (L,)), dt, dev),
                "n2": _params(_norm_shapes(cfg, (L,)), dt, dev),
                "mix": _params(shapes, dt, dev, rwkv6.FP32_LEAVES)})

    @property
    def device(self) -> torch.device:
        return self.tok["embed"].device

    @property
    def params(self) -> Dict[str, Any]:
        """The parameter tree as nested dicts of tensors (JAX layout)."""
        return {"tok": dict(self.tok.items()),
                "final_norm": dict(self.final_norm.items()),
                "blocks": _tree(self.blocks)}

    @torch.no_grad()
    def init(self, seed: int = 0) -> Dict[str, Any]:
        """Fill the parameters with the JAX package's distributions - every
        projection N(0, 1/d_in), the embedding N(0, 0.02^2), norm scales 1,
        the MoE router and expert input projections N(0, 1/d) and expert
        output projections N(0, 1/d_ff) (moe_init), and the constants and
        scales of mamba2_init / rwkv6_init - drawn in
        fp32 from a torch.Generator on the model's device (the numbers
        differ from jax.random's), layer by layer.  Returns
        `self.params`."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        fam = self.cfg.family
        norms = {"scale": 1.0, "bias": 0.0}
        _fill(self.tok, False, gen, stds={"embed": 0.02, "lm_head": 0.02})
        _fill(self.final_norm, False, gen, consts=norms)
        if fam == "ssm":
            for group in ("n1", "n2"):
                _fill(self.blocks[group], True, gen, consts=norms)
            _fill(self.blocks["mix"], True, gen,
                  consts={"w_base": -1.0, "mix": 0.5, "cm_mix": 0.5,
                          "ln_x": 1.0},
                  stds={"w_b": 0.01, "u": 0.1})
            return self.params
        if fam == "audio":
            for stack in ("encoder", "decoder"):
                for name, group in self.blocks[stack].items():
                    _fill(group, True, gen, consts=norms if name in (
                        "n1", "n2", "n_cross") else {"q_norm": 1.0,
                                                     "k_norm": 1.0})
            _fill(self.blocks["enc_norm"], False, gen, consts=norms)
            return self.params
        block = self.blocks
        if fam == "hybrid":
            _fill(self.blocks["mamba"], True, gen, consts={
                "A_log": 0.0, "dt_bias": math.log(math.e - 1),
                "gate_norm": 1.0})
            block = self.blocks["shared"]
        stacked = fam in ATTENTION_FAMILIES
        for group in ("n1", "n2"):
            _fill(block[group], stacked, gen, consts=norms)
        _fill(block["attn"], stacked, gen,
              consts={"q_norm": 1.0, "k_norm": 1.0})
        if "moe" in block:
            _fill(block["moe"], stacked, gen, stds=moe.moe_stds(self.cfg))
        else:
            _fill(block["mlp"], stacked, gen)
        return self.params

    def init_cache(self, batch_size: int, max_len: int, enc_len: int = 0,
                   *, page_size: int = 0, num_pages: int = 0,
                   kv_heads: int = 0, shardings=None):
        """The dense layout by default: one (L, batch, max_len, Hkv, D)
        strip per K and V.  page_size > 0 selects the paged layout: a
        global (L, num_pages, page_size, Hkv, D) K and V pool shared by all
        sequences, plus a (batch, ceil(max_len / page_size)) int32 block
        table.  Page 0 is the reserved null page.  kv_heads (paged only; 0
        = n_kv_heads): the pools' head count - a tensor-parallel rank's
        shard, Hkv / tp_degree, allocated at that size.  The hybrid family keeps
        per-layer conv windows and float32 SSM states plus dense K / V
        strips for each application of its shared block; the ssm family
        per-layer float32 WKV states and token-shift carries (their
        recurrent leaves have the batch on axis 1, as the strips do); the
        audio family self-attention strips of max_len and cross strips of
        enc_len positions (max_len when 0) per decoder layer.  shardings
        (a mesh rank's dense layout: the sanitized cache shardings of
        launch/specs.py prefill_cell or serve_cell): each leaf zeros at
        the shape of the rank's block of it, what the cell's step takes
        (the strips' heads or positions, the recurrent states' rows,
        heads or channels)."""
        if shardings is None:
            return self._new_cache(self.device, batch_size, max_len,
                                   enc_len, page_size, num_pages, kv_heads)
        if page_size > 0:
            raise ValueError("a cell's shardings lay out the dense cache, "
                             "not the paged one")
        from ..sharding.shards import local_shape
        full = self._new_cache(torch.device("meta"), batch_size, max_len,
                               enc_len, 0, 0, 0)
        return {n: torch.zeros(local_shape(t.shape, shardings[n].placements,
                                           shardings[n].mesh),
                               dtype=t.dtype, device=self.device)
                for n, t in full.items()}

    def _new_cache(self, dev, batch_size: int, max_len: int, enc_len: int,
                   page_size: int, num_pages: int, kv_heads: int):
        cfg = self.cfg
        dt = pdtype(cfg)
        if cfg.family not in ATTENTION_FAMILIES:
            if page_size > 0:
                raise ValueError(f"paged KV cache needs an attention "
                                 f"family, got {cfg.family}")
            if cfg.family == "audio":
                return T.encdec_init_cache(cfg, batch_size, max_len,
                                           enc_len or max_len, dt, dev)
            if cfg.family == "hybrid":
                return T.hybrid_init_cache(cfg, batch_size, max_len, dt, dev)
            return T.rwkv_init_cache(cfg, batch_size, dt, dev)
        if page_size <= 0:
            shp = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads,
                   cfg.head_dim)
            return {"k": torch.zeros(shp, dtype=dt, device=dev),
                    "v": torch.zeros(shp, dtype=dt, device=dev)}
        n_max = pages_for_tokens(max_len, page_size)
        if num_pages <= 0:
            num_pages = dense_equivalent_pages(batch_size, max_len,
                                               page_size)
        shp = (cfg.n_layers, num_pages, page_size,
               kv_heads or cfg.n_kv_heads, cfg.head_dim)
        return {"k_pages": torch.zeros(shp, dtype=dt, device=dev),
                "v_pages": torch.zeros(shp, dtype=dt, device=dev),
                "block_table": torch.zeros((batch_size, n_max),
                                           dtype=torch.int32, device=dev)}

    def _embed(self, params, tokens: torch.Tensor,
               start: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Token embeddings of tokens (B, S), plus, for a model without
        rotary embeddings (OPT), the sinusoidal absolute position term where
        the JAX Model adds it: positions arange(S) from 0, or, given start
        (B,) int32 on the device, start[b] + arange(S) for row b, clamped
        at MAX_POSITION as the JAX package's table gather is (chunks, draft
        chains, decode steps).  No host sync."""
        cfg = self.cfg
        x = embed(params["tok"], tokens, cfg)
        if cfg.use_rope or cfg.rwkv:
            return x
        pos = torch.arange(tokens.shape[1], dtype=torch.int32,
                           device=x.device)
        if start is not None:
            pos = torch.clamp(start[:, None] + pos, max=MAX_POSITION)
        return x + sinusoidal_positions(pos, cfg.d_model).to(x.dtype)

    def _audio(self, batch) -> torch.Tensor:
        """The encoder's input: batch["audio_embeds"] (B, S_enc, d_model),
        the frontend stub's frame embeddings, plus sinusoidal positions
        from 0, in the frames' dtype."""
        enc = batch["audio_embeds"]
        pos = torch.arange(enc.shape[1], dtype=torch.int32,
                           device=enc.device)
        return enc + sinusoidal_positions(pos, self.cfg.d_model).to(
            enc.dtype)

    def _assemble_input(self, params, batch):
        """(x, prefix): the token embeddings of batch["tokens"], led, for
        the vlm family, by batch["vision_embeds"] (B, P, d_model) cast to
        their dtype - the decoder then runs causally over P + S positions,
        the image at positions 0..P-1 - and prefix = P (0 without
        images)."""
        x = self._embed(params, batch["tokens"])
        v = batch.get("vision_embeds") if self.cfg.family == "vlm" else None
        if v is None:
            return x, 0
        return torch.cat([v.to(x.dtype), x], 1), v.shape[1]

    def _forward(self, params, batch, impl: Optional[str], remat: bool,
                 tp_mesh=None, moe_mesh=None):
        cfg = self.cfg
        if cfg.family == "audio":
            x = self._embed(params, batch["tokens"])
            x, aux = T.encdec_forward(params["blocks"], self._audio(batch),
                                      x, cfg, impl=impl, remat=remat,
                                      tp_mesh=tp_mesh)
        else:
            x, _ = self._assemble_input(params, batch)
            stack = {"hybrid": T.hybrid_forward,
                     "ssm": T.rwkv_forward}.get(cfg.family, T.stack_forward)
            kw = {} if tp_mesh is None else {"tp_mesh": tp_mesh}
            if moe_mesh is not None:
                kw["moe_mesh"] = moe_mesh
            x, aux = stack(params["blocks"], x, cfg, impl=impl, remat=remat,
                           **kw)
        x = apply_norm(params["final_norm"], x, cfg)
        return unembed(params["tok"], x, cfg), aux

    @torch.no_grad()
    def forward(self, params, batch, *, impl: Optional[str] = None):
        """Teacher-forced pass over batch["tokens"] (B, S) int32 (the audio
        family's decoder tokens, with its frames in batch["audio_embeds"]
        (B, S_enc, d_model); the vlm family's text, led by the image in
        batch["vision_embeds"] (B, P, d_model) when given).  Returns
        (logits (B, P + S, V) float32 - P = 0 but for a vlm batch with
        images - and the aux loss: the MoE load-balancing losses summed
        over the layers, a float32 zero for the other families)."""
        return self._forward(params, batch, impl, remat=False)

    def loss(self, params, batch, *, impl: Optional[str] = None,
             remat: bool = False, aux_weight: float = 0.01, tp_mesh=None,
             dp_sum=None, moe_mesh=None):
        """Next-token cross-entropy of batch["tokens"] (B, S), with autograd
        on: the training loss.  batch may carry "labels" (B, S) in place of
        the tokens and a "loss_mask" (B, S) weighting each position; a vlm
        batch's image positions carry no loss (their logits are dropped).
        remat=True recomputes each layer in the backward.  The sharded
        train step's (every family): tp_mesh runs each attention on this
        rank's head shard (attn_forward: whisper's encoder and its
        decoder's self and cross too, zamba2's shared block; the Mamba2
        and RWKV6 layers run every head); dp_sum says the
        batch is this rank's rows of a global batch split over data-
        parallel ranks, and dp_sum(t) sums t over them in place - ce is
        then this rank's share of the global mean, its nll sum over the
        global count of (text) positions or mask weight, so the ranks'
        shares sum to the global ce and their gradients to its gradient,
        and so is each MoE layer's aux loss (models/moe.py); moe_mesh (a
        moe.MoEMesh): the MoE FFN's mesh, the REPRO_MOE_A2A exchange's.
        Returns (total = ce + aux_weight * aux, {"ce", "aux"}), 0-d
        float32 tensors: on a mesh the rank's shares."""
        if self.cfg.moe_experts and dp_sum is not None:
            moe_mesh = dataclasses.replace(moe_mesh or moe.MoEMesh(),
                                           dp_sum=dp_sum)
        logits, aux = self._forward(params, batch, impl, remat, tp_mesh,
                                    moe_mesh)
        tokens = batch["tokens"]
        labels = batch.get("labels", tokens)
        # a vlm batch's image positions lead the logits and carry no loss
        logits = logits[:, logits.shape[1] - tokens.shape[1]:]
        # next-token prediction
        lp = torch.log_softmax(logits[:, :-1].float(), -1)
        tgt = labels[:, 1:].long()
        nll = -torch.gather(lp, -1, tgt[..., None])[..., 0]
        mask = batch.get("loss_mask")
        if dp_sum is not None:
            if mask is not None:
                mask = mask[:, 1:].float()
                num, count = torch.sum(nll * mask), torch.sum(mask.detach())
            else:
                num = torch.sum(nll)
                count = torch.tensor(float(nll.numel()), device=nll.device)
            ce = num / torch.clamp_min(dp_sum(count), 1.0)
        elif mask is not None:
            mask = mask[:, 1:].float()
            ce = torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
        else:
            ce = torch.mean(nll)
        total = ce + aux_weight * aux
        return total, {"ce": ce, "aux": aux}

    def _prompt_tail(self, params, x: torch.Tensor, batch):
        """(logits (B, 1, V) float32 of each row's last real token, lens
        (B,) int32) after a prefill of x (B, S, D) - the prompt's P + S_text
        positions, P the image prefix ahead of batch["tokens"] (B, S_text):
        the last position, or, for prompts padded past their real length
        (batch["true_lens"], text tokens), position P + true_lens - 1."""
        B, S = x.shape[:2]
        x = apply_norm(params["final_norm"], x, self.cfg)
        tl = batch.get("true_lens")
        if tl is None:
            lens = torch.full((B,), S, dtype=torch.int32, device=x.device)
            return unembed(params["tok"], x[:, -1:], self.cfg), lens
        lens = tl.to(torch.int32) + (S - batch["tokens"].shape[1])
        idx = (lens - 1).long()[:, None, None].expand(-1, 1, x.shape[-1])
        return unembed(params["tok"], torch.gather(x, 1, idx), self.cfg), \
            lens

    @torch.no_grad()
    def prefill(self, params, batch, cache, *, impl: Optional[str] = None,
                shard=None, moe_mesh=None):
        """Fill the cache (init_cache's dense layout) with the prompts
        batch["tokens"] (B, S) from position 0.  Prompts padded to a
        bucketed S carry their real lengths in batch["true_lens"] (B,); the
        pad K/V is masked by the lengths downstream (a recurrent state, as
        in the JAX package, runs over the pad).  The audio family runs its
        encoder over batch["audio_embeds"] and fills the cross strips with
        its K/V.  The vlm family's image, batch["vision_embeds"] (B, P,
        d_model), fills positions 0..P-1 and the text follows it, so lens
        counts both: P + S, or P + true_lens.  shard (a mesh step,
        serve/serve_step.py): the cache is the rank's block of the strips,
        the audio family's self and cross strips alike, and of each
        recurrent state leaf, as its own spec splits it (models/attention.py
        CacheShard); moe_mesh (a
        moe.MoEMesh): the MoE FFN's mesh, the REPRO_MOE_A2A exchange's.
        Returns (logits
        of each row's last real token (B, 1, V) float32, cache, lens
        (B,))."""
        if self.cfg.family == "audio":
            x = self._embed(params, batch["tokens"])
            x = T.encdec_prefill(params["blocks"], self._audio(batch), x,
                                 self.cfg, cache, impl=impl, shard=shard)
        else:
            x, _ = self._assemble_input(params, batch)
            prefill = {"hybrid": T.hybrid_prefill,
                       "ssm": T.rwkv_prefill}.get(self.cfg.family,
                                                  T.stack_prefill)
            kw = {} if shard is None else {"shard": shard}
            if moe_mesh is not None:
                kw["moe_mesh"] = moe_mesh
            x = prefill(params["blocks"], x, self.cfg, cache, impl=impl,
                        **kw)
        logits, lens = self._prompt_tail(params, x, batch)
        return logits, cache, lens

    def _need_attention(self, what: str):
        if self.cfg.family not in ATTENTION_FAMILIES:
            raise ValueError(f"{what} needs an attention family, got "
                             f"{self.cfg.family}")

    @torch.no_grad()
    def prefill_paged(self, params, batch, cache, page_ids, *,
                      impl: Optional[str] = None):
        """Prefill ONE sequence's prompt (batch 1) into its pages.
        batch: {"tokens": (1, S_pad), "true_lens": (1,) optional} with
        S_pad a multiple of the page size; page_ids: (S_pad // page_size,)
        the sequence's pages.  Returns (last logits (1, 1, V) float32,
        cache, lens (1,))."""
        self._need_attention("paged prefill")
        x = self._embed(params, batch["tokens"])
        x = T.stack_prefill_paged(params["blocks"], x, self.cfg, cache,
                                  page_ids, impl=impl)
        logits, lens = self._prompt_tail(params, x, batch)
        return logits, cache, lens

    @torch.no_grad()
    def prefill_chunks(self, params, batch, cache, page_tables, *,
                       impl: Optional[str] = None, tp_mesh=None):
        """Prefill a ragged batch of K mid-prompt chunks in one pass.

        batch: {"tokens": (K, S) int32 chunk tokens (rows zero-padded),
        "offset": (K,) int32 absolute position of each row's first token,
        "true_lens": (K,) int32 cursor after each row's last real token};
        page_tables: (K, n_max) int32.  Dead padding rows carry true_lens 0
        and an all-null table row; their logits are garbage the caller
        drops.  tp_mesh (a launch/mesh.py serve mesh): the cache's pools
        are this rank's head shard and the attention runs head-sharded;
        everything else is replicated.  Returns (logits of each row's last
        real token (K, 1, V) float32, cache, cursors (K,))."""
        self._need_attention("chunked prefill")
        cfg = self.cfg
        tokens = batch["tokens"]
        offs, lens = batch["offset"], batch["true_lens"]
        x = self._embed(params, tokens, offs)
        x = T.stack_prefill_chunks_paged(params["blocks"], x, cfg, cache,
                                         page_tables, offs, lens, impl=impl,
                                         tp_mesh=tp_mesh)
        x = apply_norm(params["final_norm"], x, cfg)
        idx = torch.clamp(lens - offs - 1, min=0).long()
        x_last = torch.gather(
            x, 1, idx[:, None, None].expand(-1, 1, x.shape[-1]))
        return unembed(params["tok"], x_last, cfg), cache, lens

    @torch.no_grad()
    def verify_chunks(self, params, batch, cache, page_tables, *,
                      impl: Optional[str] = None, tp_mesh=None):
        """Score a ragged batch of speculative draft chains: row k holds
        [pending token, draft_1 .. draft_m] at positions batch["offset"]
        [k] + arange(S), the prefill_chunks contract (each row's K/V
        scatters into its pages, then the offset-causal kernel attends
        over everything resident), but every position's logits come back,
        since acceptance needs the target at each chain position.
        batch["q_lens"] (K,) holds each row's real query count 1 + m, fed
        to K1's q_lens lane so pad positions come back as exact zeros.
        K/V written past the accepted frontier stays behind the row's
        lens, masked wherever KV is read and overwritten by the next
        write.  tp_mesh: as in prefill_chunks.  Returns (logits (K, S, V)
        float32, cache)."""
        self._need_attention("speculative verification")
        cfg = self.cfg
        x = self._embed(params, batch["tokens"], batch["offset"])
        x = T.stack_prefill_chunks_paged(
            params["blocks"], x, cfg, cache, page_tables, batch["offset"],
            batch["true_lens"], q_lens=batch["q_lens"], impl=impl,
            tp_mesh=tp_mesh)
        x = apply_norm(params["final_norm"], x, cfg)
        return unembed(params["tok"], x, cfg), cache

    def prefill_chunk(self, params, batch, cache, page_row, *,
                      impl: Optional[str] = None, tp_mesh=None):
        """One mid-prompt chunk of one sequence: the K=1 case of
        prefill_chunks (batch holds one row; page_row is (n_max,)).  A
        final chunk's logits seed decoding."""
        return self.prefill_chunks(params, batch, cache,
                                   page_row.reshape(1, -1), impl=impl,
                                   tp_mesh=tp_mesh)

    # the prefix-cached suffix is a final chunk whose cursor is the full
    # prompt length (the JAX Model's name for it)
    prefill_suffix = prefill_chunk

    @torch.no_grad()
    def decode_step(self, params, tokens, lens, cache, *,
                    impl: Optional[str] = None, seq_parallel: bool = False,
                    enc_lens: Optional[torch.Tensor] = None, tp_mesh=None,
                    shard=None):
        """tokens: (B, 1) int32; lens: (B,) int32 positions to write; cache
        dense or paged (init_cache), the recurrent states, or the audio
        family's strips.  seq_parallel=True decodes the attention through
        ops.decode_attention_naive in place of K3 (a paged cache raises, as
        in the JAX package).  enc_lens (B,) int32: the cross strips'
        positions each lane attends (the audio family; default the strips'
        whole length, as in the JAX package - on a mesh the whole strip's,
        not the rank's block's).  tp_mesh head-shards the paged decode (as
        in prefill_chunks).  shard: the dense cache is the rank's block of
        the strips and states on a mesh (as in prefill; the cross strips
        are only read).  Returns (logits (B, 1, V) float32, cache)."""
        cfg = self.cfg
        blocks = params["blocks"]
        x = self._embed(params, tokens, lens)
        if cfg.family == "audio":
            if enc_lens is None:
                # the whole cross strip: on a mesh whose layout splits its
                # sequence, the rank's block times the axis's size
                n = shard.seq.size if shard is not None and shard.seq \
                    else 1
                enc_lens = torch.full_like(lens,
                                           cache["cross_k"].shape[2] * n)
            x = T.encdec_decode(blocks, x, cfg, cache, lens, enc_lens,
                                impl=impl, seq_parallel=seq_parallel,
                                shard=shard)
        elif cfg.family == "hybrid":
            x = T.hybrid_decode(blocks, x, cfg, cache, lens, impl=impl,
                                seq_parallel=seq_parallel, shard=shard)
        elif cfg.family == "ssm":
            x = T.rwkv_decode(blocks, x, cfg, cache, lens, impl=impl,
                              seq_parallel=seq_parallel, shard=shard)
        elif "k_pages" in cache:
            if seq_parallel:
                raise ValueError("paged decode does not compose with the "
                                 "sequence-parallel cache layout")
            x = T.stack_decode_paged(blocks, x, cfg, cache, lens, impl=impl,
                                     tp_mesh=tp_mesh)
        else:
            x = T.stack_decode(blocks, x, cfg, cache, lens, impl=impl,
                               seq_parallel=seq_parallel, shard=shard)
        x = apply_norm(params["final_norm"], x, cfg)
        return unembed(params["tok"], x, cfg), cache


def resolve_device(device, caller: str) -> torch.device:
    """`device` as a torch.device; a CUDA device on a machine without a GPU
    raises instead of quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{caller}: no CUDA device is available; pass device='cpu' "
            "to run the plain PyTorch path on the CPU")
    return dev


def build_model(cfg: ModelConfig, device="cuda") -> Model:
    """Allocate a Model on `device` (default the GPU; the parameters are
    uninitialised until Model.init or a load).  Raises on a machine without
    a GPU unless device="cpu" is asked for."""
    return Model(cfg, resolve_device(device, "build_model"))
