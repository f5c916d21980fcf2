"""Decoder-only LM, dense family.

Where the JAX package scans one stacked parameter group over the layers,
this module loops over an ``nn.ModuleList`` of blocks.  Caches are
preallocated per layer and updated in place.  Other families raise
``NotImplementedError`` naming the ROADMAP item that brings them.

Modes: 'train' (no cache), 'prefill' (populate caches, return last-token
logits), 'decode' (one token, in-place cache append).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..configs.base import ArchConfig
from .attention import Attention
from .layers import MLP, RMSNorm, dense_init_, rms_norm, trunc_normal_

# families still to port -> the ROADMAP.md queue-1 item that brings them
_LATER_FAMILIES = {"hybrid": 5, "ssm": 5, "moe": 6, "vlm": 6, "audio": 6}


class Block(nn.Module):
    """One pre-norm residual block: attention, then MLP."""

    def __init__(self, cfg: ArchConfig, dtype, device=None):
        super().__init__()
        d = cfg.d_model
        self.ln1 = RMSNorm(d, cfg.norm_eps, device)
        self.mix = Attention(d, cfg.n_heads, cfg.n_kv_heads, cfg.hd, dtype,
                             device)
        self.ln2 = RMSNorm(d, cfg.norm_eps, device)
        self.ffn = MLP(d, cfg.d_ff, cfg.mlp, dtype, device)

    def init(self, generator: torch.Generator) -> None:
        self.mix.init(generator)
        self.ffn.init(generator)

    def forward(self, x, cfg: ArchConfig, mode: str, cache: Optional[Dict],
                pos):
        o, cache = self.mix(self.ln1(x), cfg=cfg, mode=mode, cache=cache,
                            pos=pos)
        x = x + o
        return x + self.ffn(self.ln2(x)), cache


class DecoderLM(nn.Module):
    def __init__(self, cfg: ArchConfig, device="cuda"):
        super().__init__()
        if cfg.family != "dense":
            item = _LATER_FAMILIES.get(cfg.family)
            raise NotImplementedError(
                f"{cfg.name}: family {cfg.family!r} is not ported yet "
                f"(ROADMAP.md queue 1, item {item})")
        dev = resolve_device(device)
        self.cfg = cfg
        self.pdtype = getattr(torch, cfg.param_dtype)
        self.cdtype = getattr(torch, cfg.dtype)
        self.embed = nn.Parameter(torch.empty(cfg.vocab, cfg.d_model,
                                              dtype=self.pdtype, device=dev))
        self.blocks = nn.ModuleList(Block(cfg, self.pdtype, dev)
                                    for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, dev)
        self.lm_head = None if cfg.tie_embeddings else nn.Parameter(
            torch.empty(cfg.d_model, cfg.vocab, dtype=self.pdtype,
                        device=dev))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # -- params ----------------------------------------------------------
    def init(self, generator: torch.Generator) -> "DecoderLM":
        """Random weights from ``generator`` (a CPU generator: the same seed
        gives the same weights on every device)."""
        trunc_normal_(self.embed, 1.0, generator)
        for blk in self.blocks:
            blk.init(generator)
        if self.lm_head is not None:
            dense_init_(self.lm_head, self.cfg.d_model, generator)
        return self

    # -- embedding / head -------------------------------------------------
    def embed_inputs(self, tokens):
        return F.embedding(tokens, self.embed).to(self.cdtype)

    def head(self, x):
        x = rms_norm(x, self.final_norm.weight, self.cfg.norm_eps)
        w = self.embed.T if self.lm_head is None else self.lm_head
        return x @ w.to(x.dtype)

    # -- layers ------------------------------------------------------------
    def backbone(self, x, mode: str, caches: Optional[List[Dict]] = None,
                 pos=None):
        for i, blk in enumerate(self.blocks):
            x, _ = blk(x, self.cfg, mode,
                       caches[i] if caches is not None else None, pos)
        return x, caches

    # -- public entry points ------------------------------------------------
    def init_cache(self, B: int, cache_len: int) -> List[Dict]:
        """Zero caches, one dict per layer, updated in place by prefill and
        decode."""
        cfg = self.cfg
        shape = (B, cache_len, cfg.n_kv_heads, cfg.hd)
        quant = cfg.kv_cache_dtype == "int8"
        caches = []
        for _ in range(cfg.n_layers):
            kw = dict(dtype=torch.int8 if quant else self.cdtype,
                      device=self.device)
            c = {"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw),
                 "len": 0}
            if quant:
                c["k_scale"] = torch.zeros(shape[:3], device=self.device)
                c["v_scale"] = torch.zeros(shape[:3], device=self.device)
            caches.append(c)
        return caches

    @torch.inference_mode()
    def prefill(self, batch, cache_len: int):
        """Process the prompt; returns (last_logits (B,1,V), caches)."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = self.embed_inputs(tokens)
        pos = torch.arange(S, device=x.device)[None, :]
        caches = self.init_cache(B, cache_len)
        x, caches = self.backbone(x, "prefill", caches, pos)
        return self.head(x[:, -1:]), caches

    @torch.inference_mode()
    def decode_step(self, tokens, caches, positions):
        """One token for every sequence.  tokens (B, 1); positions (B, 1)."""
        x = self.embed_inputs(tokens)
        x, caches = self.backbone(x, "decode", caches, positions)
        return self.head(x), caches
