"""The dense decoder as an nn.Module, with its forward and serving entry
points over the dense and the paged KV cache.

`Model` holds the JAX package's parameter tree as nn.Parameters in the same
stacked layout - {"tok": {"embed"}, "final_norm": {"scale"}, "blocks":
{"n1", "attn", "n2", "mlp"}} with a leading layer axis on every block
leaf - and exposes it as a plain nested dict (`Model.params`).  Like the
JAX package's Model, the entry points take the parameter tree as their
first argument, so the same module runs its own seeded weights or weights
carried over from the JAX package (models/convert.py).  The entry points
run eagerly under torch.no_grad(); the KV cache in `cache` (dense strips or
the paged pool) is updated in place and returned.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
from torch import nn

from ..configs.base import (ModelConfig, dense_equivalent_pages,
                            pages_for_tokens)
from . import transformer as T
from .layers import apply_norm, embed, pdtype, unembed


def _params(shapes: Dict[str, tuple], dtype, device) -> nn.ParameterDict:
    return nn.ParameterDict({
        k: nn.Parameter(torch.empty(s, dtype=dtype, device=device),
                        requires_grad=False)
        for k, s in shapes.items()})


def _norm_shapes(cfg: ModelConfig, lead: tuple = ()) -> Dict[str, tuple]:
    d = (*lead, cfg.d_model)
    if cfg.norm == "rmsnorm":
        return {"scale": d}
    if cfg.norm == "layernorm":
        return {"scale": d, "bias": d}
    return {}


class Model(nn.Module):
    """Dense decoder (the port serves the dense family only so far)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet (ROADMAP M13); "
                f"the port serves dense decoders")
        if not cfg.use_rope:
            raise NotImplementedError(
                "absolute position embeddings are not ported yet "
                "(ROADMAP M13)")
        self.cfg = cfg
        dt, dev = pdtype(cfg), torch.device(device)
        L, d, f, hd = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.head_dim
        nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
        tok = {"embed": (cfg.vocab_size, d)}
        if not cfg.tie_embeddings:
            tok["lm_head"] = (cfg.vocab_size, d)
        attn = {"wq": (L, d, nq), "wk": (L, d, nkv), "wv": (L, d, nkv),
                "wo": (L, nq, d)}
        if cfg.qk_norm:
            attn.update(q_norm=(L, hd), k_norm=(L, hd))
        ffn = {"w_in": (L, d, f), "w_out": (L, f, d)}
        if cfg.act == "silu":
            ffn["w_gate"] = (L, d, f)
        self.tok = _params(tok, dt, dev)
        self.final_norm = _params(_norm_shapes(cfg), dt, dev)
        self.blocks = nn.ModuleDict({
            "n1": _params(_norm_shapes(cfg, (L,)), dt, dev),
            "attn": _params(attn, dt, dev),
            "n2": _params(_norm_shapes(cfg, (L,)), dt, dev),
            "mlp": _params(ffn, dt, dev)})

    @property
    def device(self) -> torch.device:
        return self.tok["embed"].device

    @property
    def params(self) -> Dict[str, Any]:
        """The parameter tree as nested dicts of tensors (JAX layout)."""
        return {"tok": dict(self.tok.items()),
                "final_norm": dict(self.final_norm.items()),
                "blocks": {g: dict(m.items())
                           for g, m in self.blocks.items()}}

    @torch.no_grad()
    def init(self, seed: int = 0) -> Dict[str, Any]:
        """Fill the parameters with the JAX package's distributions - every
        projection N(0, 1/d_in), the embedding N(0, 0.02^2), norm scales 1 -
        drawn in fp32 from a torch.Generator on the model's device (the
        numbers differ from jax.random's), layer by layer.  Returns
        `self.params`."""
        gen = torch.Generator(device=self.device).manual_seed(seed)

        def normal_(t: torch.Tensor, std: float):
            t.copy_(torch.randn(t.shape, generator=gen, device=t.device,
                                dtype=torch.float32) * std)

        for name, t in self.tok.items():
            normal_(t, 0.02)
        for group in ("n1", "n2"):
            for name, t in self.blocks[group].items():
                t.fill_(1.0 if name == "scale" else 0.0)
        for name, t in self.final_norm.items():
            t.fill_(1.0 if name == "scale" else 0.0)
        for group in ("attn", "mlp"):
            for name, t in self.blocks[group].items():
                for l in range(t.shape[0]):
                    if name in ("q_norm", "k_norm"):
                        t[l].fill_(1.0)
                    else:
                        normal_(t[l], 1.0 / math.sqrt(t.shape[1]))
        return self.params

    def init_cache(self, batch_size: int, max_len: int, *,
                   page_size: int = 0, num_pages: int = 0):
        """The dense layout by default: one (L, batch, max_len, Hkv, D)
        strip per K and V.  page_size > 0 selects the paged layout: a
        global (L, num_pages, page_size, Hkv, D) K and V pool shared by all
        sequences, plus a (batch, ceil(max_len / page_size)) int32 block
        table.  Page 0 is the reserved null page."""
        cfg = self.cfg
        dev, dt = self.device, pdtype(cfg)
        if page_size <= 0:
            shp = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads,
                   cfg.head_dim)
            return {"k": torch.zeros(shp, dtype=dt, device=dev),
                    "v": torch.zeros(shp, dtype=dt, device=dev)}
        n_max = pages_for_tokens(max_len, page_size)
        if num_pages <= 0:
            num_pages = dense_equivalent_pages(batch_size, max_len,
                                               page_size)
        shp = (cfg.n_layers, num_pages, page_size, cfg.n_kv_heads,
               cfg.head_dim)
        return {"k_pages": torch.zeros(shp, dtype=dt, device=dev),
                "v_pages": torch.zeros(shp, dtype=dt, device=dev),
                "block_table": torch.zeros((batch_size, n_max),
                                           dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def forward(self, params, batch, *, impl: Optional[str] = None):
        """Teacher-forced pass over batch["tokens"] (B, S) int32.  Returns
        (logits (B, S, V) float32, aux loss (a float32 zero: the dense
        family has no auxiliary loss))."""
        cfg = self.cfg
        x = embed(params["tok"], batch["tokens"], cfg)
        x = T.stack_forward(params["blocks"], x, cfg, impl=impl)
        x = apply_norm(params["final_norm"], x, cfg)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return unembed(params["tok"], x, cfg), aux

    def _prompt_tail(self, params, x: torch.Tensor, batch):
        """(logits (B, 1, V) float32 of each row's last real token, lens
        (B,) int32) after a prefill of x (B, S, D): the last position, or
        position true_lens - 1 for prompts padded past their real length
        (batch["true_lens"])."""
        B, S = x.shape[:2]
        x = apply_norm(params["final_norm"], x, self.cfg)
        tl = batch.get("true_lens")
        if tl is None:
            lens = torch.full((B,), S, dtype=torch.int32, device=x.device)
            return unembed(params["tok"], x[:, -1:], self.cfg), lens
        lens = tl.to(torch.int32)
        idx = (lens - 1).long()[:, None, None].expand(-1, 1, x.shape[-1])
        return unembed(params["tok"], torch.gather(x, 1, idx), self.cfg), \
            lens

    @torch.no_grad()
    def prefill(self, params, batch, cache, *, impl: Optional[str] = None):
        """Fill the dense cache {"k"/"v": (L, B, S_max, Hkv, D)} with the
        prompts batch["tokens"] (B, S) from position 0.  Prompts padded to
        a bucketed S carry their real lengths in batch["true_lens"] (B,);
        the pad K/V is masked by the lengths downstream.  Returns (logits of
        each row's last real token (B, 1, V) float32, cache, lens (B,))."""
        x = embed(params["tok"], batch["tokens"], self.cfg)
        x = T.stack_prefill(params["blocks"], x, self.cfg, cache, impl=impl)
        logits, lens = self._prompt_tail(params, x, batch)
        return logits, cache, lens

    @torch.no_grad()
    def prefill_paged(self, params, batch, cache, page_ids, *,
                      impl: Optional[str] = None):
        """Prefill ONE sequence's prompt (batch 1) into its pages.
        batch: {"tokens": (1, S_pad), "true_lens": (1,) optional} with
        S_pad a multiple of the page size; page_ids: (S_pad // page_size,)
        the sequence's pages.  Returns (last logits (1, 1, V) float32,
        cache, lens (1,))."""
        x = embed(params["tok"], batch["tokens"], self.cfg)
        x = T.stack_prefill_paged(params["blocks"], x, self.cfg, cache,
                                  page_ids, impl=impl)
        logits, lens = self._prompt_tail(params, x, batch)
        return logits, cache, lens

    @torch.no_grad()
    def prefill_chunks(self, params, batch, cache, page_tables, *,
                       impl: Optional[str] = None):
        """Prefill a ragged batch of K mid-prompt chunks in one pass.

        batch: {"tokens": (K, S) int32 chunk tokens (rows zero-padded),
        "offset": (K,) int32 absolute position of each row's first token,
        "true_lens": (K,) int32 cursor after each row's last real token};
        page_tables: (K, n_max) int32.  Dead padding rows carry true_lens 0
        and an all-null table row; their logits are garbage the caller
        drops.  Returns (logits of each row's last real token (K, 1, V)
        float32, cache, cursors (K,))."""
        cfg = self.cfg
        tokens = batch["tokens"]
        offs, lens = batch["offset"], batch["true_lens"]
        x = embed(params["tok"], tokens, cfg)
        x = T.stack_prefill_chunks_paged(params["blocks"], x, cfg, cache,
                                         page_tables, offs, lens, impl=impl)
        x = apply_norm(params["final_norm"], x, cfg)
        idx = torch.clamp(lens - offs - 1, min=0).long()
        x_last = torch.gather(
            x, 1, idx[:, None, None].expand(-1, 1, x.shape[-1]))
        return unembed(params["tok"], x_last, cfg), cache, lens

    def prefill_chunk(self, params, batch, cache, page_row, *,
                      impl: Optional[str] = None):
        """One mid-prompt chunk of one sequence: the K=1 case of
        prefill_chunks (batch holds one row; page_row is (n_max,))."""
        return self.prefill_chunks(params, batch, cache,
                                   page_row.reshape(1, -1), impl=impl)

    @torch.no_grad()
    def decode_step(self, params, tokens, lens, cache, *,
                    impl: Optional[str] = None):
        """tokens: (B, 1) int32; lens: (B,) int32 positions to write; cache
        dense or paged (init_cache).  Returns (logits (B, 1, V) float32,
        cache)."""
        cfg = self.cfg
        x = embed(params["tok"], tokens, cfg)
        if "k_pages" in cache:
            x = T.stack_decode_paged(params["blocks"], x, cfg, cache, lens,
                                     impl=impl)
        else:
            x = T.stack_decode(params["blocks"], x, cfg, cache, lens,
                               impl=impl)
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
