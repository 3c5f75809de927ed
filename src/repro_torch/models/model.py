"""The dense decoder as an nn.Module, with the paged serving entry points.

`Model` holds the JAX package's parameter tree as nn.Parameters in the same
stacked layout - {"tok": {"embed"}, "final_norm": {"scale"}, "blocks":
{"n1", "attn", "n2", "mlp"}} with a leading layer axis on every block
leaf - and exposes it as a plain nested dict (`Model.params`).  Like the
JAX package's Model, the entry points take the parameter tree as their
first argument, so the same module runs its own seeded weights or weights
carried over from the JAX package (models/convert.py).  The entry points
run eagerly under torch.no_grad(); the paged KV pool in `cache` is updated
in place and returned.
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
        """The paged layout: a global (L, num_pages, page_size, Hkv, D) K
        and V pool shared by all sequences, plus a (batch, ceil(max_len /
        page_size)) int32 block table.  Page 0 is the reserved null page."""
        if page_size <= 0:
            raise NotImplementedError(
                "the dense cache layout is not ported yet (ROADMAP M9); "
                "pass page_size > 0")
        cfg = self.cfg
        n_max = pages_for_tokens(max_len, page_size)
        if num_pages <= 0:
            num_pages = dense_equivalent_pages(batch_size, max_len,
                                               page_size)
        shp = (cfg.n_layers, num_pages, page_size, cfg.n_kv_heads,
               cfg.head_dim)
        dev, dt = self.device, pdtype(cfg)
        return {"k_pages": torch.zeros(shp, dtype=dt, device=dev),
                "v_pages": torch.zeros(shp, dtype=dt, device=dev),
                "block_table": torch.zeros((batch_size, n_max),
                                           dtype=torch.int32, device=dev)}

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
        """tokens: (B, 1) int32; lens: (B,) int32 positions to write.
        Returns (logits (B, 1, V) float32, cache)."""
        if "k_pages" not in cache:
            raise NotImplementedError(
                "decode against the dense cache is not ported yet "
                "(ROADMAP M9)")
        cfg = self.cfg
        x = embed(params["tok"], tokens, cfg)
        x = T.stack_decode_paged(params["blocks"], x, cfg, cache, lens,
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
