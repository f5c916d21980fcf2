"""Decoder-only LM: the dense, hybrid (RG-LRU + local attention) and ssm
(RWKV-6) families.

The JAX package scans stacked parameter groups over the layers (a group is
one ``block_kinds`` repetition); this module loops over an
``nn.ModuleList`` of sub-blocks, group g's kind i at index g * k + i.
Caches are preallocated per sub-block and updated in place.  Other
families raise ``NotImplementedError`` naming the ROADMAP item that brings
them.

Modes: 'train' (no cache), 'prefill' (populate caches, return last-token
logits), 'decode' (one token, in-place cache update).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..configs.base import ArchConfig
from .attention import Attention
from .layers import MLP, RMSNorm, dense_init_, rms_norm, trunc_normal_
from .rglru import RGLRU
from .rwkv6 import RWKVBlock

# families still to port -> the ROADMAP.md queue-1 item that brings them
_LATER_FAMILIES = {"moe": 7, "vlm": 7, "audio": 7}


def block_kinds(cfg: ArchConfig) -> Tuple[str, ...]:
    """Sub-block kinds within one group."""
    if cfg.family == "hybrid":
        return cfg.block_pattern            # e.g. ("rec", "rec", "attn")
    if cfg.family == "ssm":
        return ("rwkv",)
    return ("attn",)


def n_groups(cfg: ArchConfig) -> int:
    """Groups of ``block_kinds``.  As in the JAX package, a hybrid whose
    n_layers is no multiple of its pattern drops the remainder:
    recurrentgemma-9b's 38 layers make 12 groups of 3, 36 sub-blocks."""
    k = len(block_kinds(cfg))
    if cfg.n_layers % k and cfg.family != "hybrid":
        raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} vs pattern "
                         f"{k}")
    return cfg.n_layers // k


class Block(nn.Module):
    """One pre-norm residual block: attention (windowed for the hybrid) or
    the RG-LRU, then MLP."""

    def __init__(self, kind: str, cfg: ArchConfig, dtype, device=None):
        super().__init__()
        d = cfg.d_model
        self.kind = kind
        self.window = cfg.local_window if cfg.family == "hybrid" else 0
        self.ln1 = RMSNorm(d, cfg.norm_eps, device)
        self.mix = RGLRU(cfg, dtype, device) if kind == "rec" else \
            Attention(d, cfg.n_heads, cfg.n_kv_heads, cfg.hd, dtype, device)
        self.ln2 = RMSNorm(d, cfg.norm_eps, device)
        self.ffn = MLP(d, cfg.d_ff, cfg.mlp, dtype, device)

    def init(self, generator: torch.Generator) -> None:
        self.mix.init(generator)
        self.ffn.init(generator)

    def forward(self, x, cfg: ArchConfig, mode: str, cache: Optional[Dict],
                pos):
        if self.kind == "rec":
            o, cache = self.mix(self.ln1(x), cfg, mode, cache)
        else:
            o, cache = self.mix(self.ln1(x), cfg=cfg, mode=mode, cache=cache,
                                pos=pos, window=self.window)
        x = x + o
        return x + self.ffn(self.ln2(x)), cache


class DecoderLM(nn.Module):
    def __init__(self, cfg: ArchConfig, device="cuda"):
        super().__init__()
        if cfg.family in _LATER_FAMILIES:
            item = _LATER_FAMILIES[cfg.family]
            raise NotImplementedError(
                f"{cfg.name}: family {cfg.family!r} is not ported yet "
                f"(ROADMAP.md queue 1, item {item})")
        dev = resolve_device(device)
        self.cfg = cfg
        self.kinds = block_kinds(cfg)
        self.groups = n_groups(cfg)
        self.pdtype = getattr(torch, cfg.param_dtype)
        self.cdtype = getattr(torch, cfg.dtype)
        self.embed = nn.Parameter(torch.empty(cfg.vocab, cfg.d_model,
                                              dtype=self.pdtype, device=dev))
        self.blocks = nn.ModuleList(
            RWKVBlock(cfg, self.pdtype, dev) if kind == "rwkv"
            else Block(kind, cfg, self.pdtype, dev)
            for _ in range(self.groups) for kind in self.kinds)
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, dev)
        self.lm_head = None if cfg.tie_embeddings else nn.Parameter(
            torch.empty(cfg.d_model, cfg.vocab, dtype=self.pdtype,
                        device=dev))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # -- params ----------------------------------------------------------
    def init(self, generator: torch.Generator) -> "DecoderLM":
        """Random weights from ``generator``, drawn on its device (a CPU
        generator gives the same weights on every device; a CUDA one draws
        on the card)."""
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
        """Zero caches, one dict per sub-block, updated in place by prefill
        and decode: attention {"k", "v", "len"[, "k_scale", "v_scale"]}
        (a ring of min(cache_len, local_window) for the hybrid), RG-LRU
        {"h", "conv"}, RWKV {"time": {"shift", "state"}, "channel":
        {"shift"}}."""
        cfg = self.cfg
        kw = dict(dtype=self.cdtype, device=self.device)
        f32 = dict(dtype=torch.float32, device=self.device)
        d, w = cfg.d_model, cfg.lru_width or cfg.d_model
        caches = []
        for _ in range(self.groups):
            for kind in self.kinds:
                if kind == "rec":
                    caches.append({
                        "h": torch.zeros(B, w, **f32),
                        "conv": torch.zeros(B, cfg.conv_width - 1, w, **kw)})
                elif kind == "rwkv":
                    N = cfg.rwkv_head_dim
                    caches.append({
                        "time": {"shift": torch.zeros(B, d, **kw),
                                 "state": torch.zeros(B, d // N, N, N, **f32)},
                        "channel": {"shift": torch.zeros(B, d, **kw)}})
                else:
                    caches.append(self._attn_cache(B, cache_len))
        return caches

    def _attn_cache(self, B: int, cache_len: int) -> Dict:
        cfg = self.cfg
        T = min(cache_len, cfg.local_window) \
            if cfg.family == "hybrid" and cfg.local_window else cache_len
        shape = (B, T, cfg.n_kv_heads, cfg.hd)
        quant = cfg.kv_cache_dtype == "int8"
        kw = dict(dtype=torch.int8 if quant else self.cdtype,
                  device=self.device)
        c = {"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw),
             "len": 0}
        if quant:
            c["k_scale"] = torch.zeros(shape[:3], device=self.device)
            c["v_scale"] = torch.zeros(shape[:3], device=self.device)
        return c

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
