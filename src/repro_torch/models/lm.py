"""Decoder-only LM: the dense, vlm (dense with a prefix of projected patch
embeddings), moe (attention, then a routed MoE in place of the MLP),
hybrid (RG-LRU + local attention) and ssm (RWKV-6) families, each of
which serves and trains.  The audio family is ``encdec.EncDecLM``.

The JAX package scans stacked parameter groups over the layers (a group is
one ``block_kinds`` repetition); this module loops over an
``nn.ModuleList`` of sub-blocks, group g's kind i at index g * k + i.
Caches are preallocated per sub-block and updated in place (a moe
sub-block's cache is its attention's).  A vlm model's ``vision_proj``
(d, d) maps the patch embeddings (the InternViT frontend is a stub in
both packages), which go before the text in train and prefill; positions
run over patches and text, and decode embeds tokens alone.

Modes: 'train' (no cache; ``loss_fn``), 'prefill' (populate caches,
return last-token logits), 'decode' (one token, in-place cache update).
Train mode calls no kernel wrapper: attention runs ``chunked_attention``,
the RWKV-6 recurrence its chunked form and the RG-LRU a doubling scan, in
plain PyTorch under autograd, as the JAX package trains outside its Pallas
kernels.  With ``cfg.remat`` each sub-block of a train forward that
autograd records runs in ``torch.utils.checkpoint`` and is recomputed in
the backward pass, as the JAX package rematerializes its scanned group
body; a moe sub-block's aux sums are outputs of the checkpointed function,
so the recomputation neither counts them twice nor loses their grads.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..configs.base import ArchConfig
from ..sharding.partition import constrain, replicated_like
from .attention import Attention, attn_axes
from .layers import (MLP, RMSNorm, dense_init_, mlp_axes, rms_norm,
                     softmax_xent, stacked_axes, trunc_normal_)
from .moe import AUX_KEYS, MoE, moe_axes
from .rglru import RGLRU, rglru_axes
from .rwkv6 import RWKVBlock, rwkv_channel_axes, rwkv_time_axes


def block_kinds(cfg: ArchConfig) -> Tuple[str, ...]:
    """Sub-block kinds within one group."""
    if cfg.family == "hybrid":
        return cfg.block_pattern            # e.g. ("rec", "rec", "attn")
    if cfg.family == "ssm":
        return ("rwkv",)
    if cfg.family == "moe":
        return ("moe",)
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


def sub_block_axes(kind: str, cfg: ArchConfig) -> Dict:
    """Logical axes of one sub-block's parameters, keyed as the JAX
    pytree."""
    if kind == "rwkv":
        return {"ln1": (None,), "time": rwkv_time_axes(),
                "ln2": (None,), "channel": rwkv_channel_axes()}
    mix = attn_axes() if kind in ("attn", "moe") else rglru_axes()
    ffn = moe_axes() if kind == "moe" else mlp_axes(cfg.mlp)
    return {"ln1": (None,), "mix": mix, "ln2": (None,), "ffn": ffn}


def sub_block_cache_axes(kind: str, cfg: ArchConfig) -> Dict:
    """Logical axes of the JAX package's cache of one sub-block kind,
    stacked over the groups (leading None)."""
    if kind in ("attn", "moe"):
        out = {"k": (None, "batch", "kv_seq", "kv_heads", None),
               "v": (None, "batch", "kv_seq", "kv_heads", None),
               "len": (None,)}
        if cfg.kv_cache_dtype == "int8":
            out["k_scale"] = (None, "batch", "kv_seq", "kv_heads")
            out["v_scale"] = (None, "batch", "kv_seq", "kv_heads")
        return out
    if kind == "rec":
        return {"h": (None, "batch", "lru"),
                "conv": (None, "batch", None, "lru")}
    return {"time": {"shift": (None, "batch", "tensor"),
                     "state": (None, "batch", "tensor", None, None)},
            "channel": {"shift": (None, "batch", "tensor")}}


class Block(nn.Module):
    """One pre-norm residual block: attention (windowed for the hybrid) or
    the RG-LRU, then the MLP, or for kind "moe" the routed experts.
    ``forward`` returns (x, cache, aux): aux is the MoE's metrics, else
    None."""

    def __init__(self, kind: str, cfg: ArchConfig, dtype, device=None):
        super().__init__()
        d = cfg.d_model
        self.kind = kind
        self.window = cfg.local_window if cfg.family == "hybrid" else 0
        self.ln1 = RMSNorm(d, cfg.norm_eps, device)
        self.mix = RGLRU(cfg, dtype, device) if kind == "rec" else \
            Attention(d, cfg.n_heads, cfg.n_kv_heads, cfg.hd, dtype, device)
        self.ln2 = RMSNorm(d, cfg.norm_eps, device)
        self.ffn = MoE(cfg, dtype, device) if kind == "moe" else \
            MLP(d, cfg.d_ff, cfg.mlp, dtype, device)

    def init(self, generator: torch.Generator) -> None:
        self.mix.init(generator)
        self.ffn.init(generator)

    def forward(self, x, cfg: ArchConfig, mode: str, cache: Optional[Dict],
                pos):
        if self.kind == "rec":
            o, cache = self.mix(self.ln1(x), cfg, mode, cache)
        else:
            # under seq-sharded layouts attention needs the whole
            # sequence: gathered once here, not per query block
            h = constrain(self.ln1(x), ("batch", "seq", None))
            o, cache = self.mix(h, cfg=cfg, mode=mode, cache=cache,
                                pos=pos, window=self.window)
        x = x + o
        # the MLP is per token: it runs on the seq-sharded residual
        h2 = constrain(self.ln2(x), ("batch", "act_seq", None))
        if self.kind == "moe":
            o, aux = self.ffn(h2, cfg)
            return x + o, cache, aux
        return x + self.ffn(h2), cache, None


class DecoderLM(nn.Module):
    def __init__(self, cfg: ArchConfig, device="cuda"):
        super().__init__()
        if cfg.is_encdec:
            raise ValueError(f"{cfg.name}: an encoder-decoder; build it as "
                             "encdec.EncDecLM (ModelAPI does)")
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
        self.vision_proj = nn.Parameter(torch.empty(
            cfg.d_model, cfg.d_model, dtype=self.pdtype, device=dev)) \
            if cfg.vision_tokens else None

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
        if self.vision_proj is not None:
            dense_init_(self.vision_proj, self.cfg.d_model, generator)
        return self

    def param_axes(self) -> Dict:
        """Logical axes of the JAX pytree of this model's parameters
        (``blocks/b{i}`` stacked over the groups)."""
        cfg = self.cfg
        axes = {"embed": ("vocab", "fsdp"),
                "blocks": {f"b{i}": stacked_axes(sub_block_axes(kind, cfg))
                           for i, kind in enumerate(self.kinds)},
                "final_norm": (None,)}
        if not cfg.tie_embeddings:
            axes["lm_head"] = ("fsdp", "vocab")
        if cfg.vision_tokens:
            axes["vision_proj"] = ("fsdp", "tensor")
        return axes

    def cache_axes(self) -> Dict:
        """Logical axes of the JAX package's stacked caches."""
        return {f"b{i}": sub_block_cache_axes(kind, self.cfg)
                for i, kind in enumerate(self.kinds)}

    # -- embedding / head -------------------------------------------------
    def embed_inputs(self, tokens, patches=None):
        """Token embeddings in the compute dtype; with ``patches`` (B, V, d)
        on a vlm model, ``patches @ vision_proj`` before them."""
        # under a mesh the ids are replicated first (a few bytes a token):
        # DTensor's masked lookup in a vocab-sharded table builds its
        # mask from the ids' local shard, and fails when it must also
        # gather them (torch 2.13)
        ids = constrain(tokens, (None,) * tokens.dim())
        x = F.embedding(ids, self.embed).to(self.cdtype)
        if self.vision_proj is not None and patches is not None:
            pv = patches.to(self.cdtype) @ self.vision_proj.to(self.cdtype)
            x = torch.cat([pv, x], dim=1)
        return constrain(x, ("batch", "seq", None))

    def head(self, x):
        x = rms_norm(x, self.final_norm.weight, self.cfg.norm_eps)
        w = self.embed.T if self.lm_head is None else self.lm_head
        # act_seq keeps the logits seq-sharded under SP/FSDP layouts
        return constrain(x @ w.to(x.dtype), ("batch", "act_seq", "vocab"))

    # -- layers ------------------------------------------------------------
    def backbone(self, x, mode: str, caches: Optional[List[Dict]] = None,
                 pos=None):
        """The sub-blocks in order: (x, caches)."""
        x, _, caches = self.backbone_aux(x, mode, caches, pos)
        return x, caches

    def backbone_aux(self, x, mode: str,
                     caches: Optional[List[Dict]] = None, pos=None):
        """(x, aux, caches): aux sums each MoE metric (``AUX_KEYS``) over
        the sub-blocks, float32 0-d tensors; empty for the other
        families."""
        cfg = self.cfg
        remat = cfg.remat and mode == "train" and torch.is_grad_enabled()
        aux = {k: torch.zeros((), device=x.device) for k in AUX_KEYS} \
            if cfg.n_experts else {}

        def run(blk, h, cache):
            h, _, a = blk(h, cfg, mode, cache, pos)
            return (h,) if a is None else (h,) + tuple(a[k]
                                                      for k in AUX_KEYS)
        for i, blk in enumerate(self.blocks):
            if remat:
                out = checkpoint(run, blk, x, None, use_reentrant=False)
            else:
                out = run(blk, x, caches[i] if caches is not None else None)
            x = out[0]
            if (i + 1) % len(self.kinds) == 0:
                # the residual carried between groups (the one a
                # rematerialized group saves); seq-sharded under
                # ACT_SP_RULES
                x = constrain(x, ("batch", "act_seq", None))
            for k, v in zip(AUX_KEYS, out[1:]):
                aux[k] = aux[k] + v
        return x, aux, caches

    # -- public entry points ------------------------------------------------
    def loss_fn(self, batch):
        """Train forward: batch {tokens (B,S), labels (B,S)[, loss_mask
        (B,S)][, patches (B,V,d) for the vlm family]}.  Returns (loss,
        metrics {"loss"[, the MoE metrics], "total_loss"}): the mean token
        cross entropy with z-loss 1e-4, over the text tokens (the mask's
        when it is given); the moe family adds 0.01 x its load-balancing
        loss and 0.001 x its router z-loss, each averaged over the layer
        groups, and reports the three MoE metrics so averaged."""
        cfg = self.cfg
        if cfg.vision_tokens and "patches" not in batch:
            raise ValueError(f"{cfg.name}: a train batch needs 'patches' "
                             f"(B, {cfg.vision_tokens}, {cfg.d_model})")
        x = self.embed_inputs(batch["tokens"], batch.get("patches"))
        pos = replicated_like(
            torch.arange(x.shape[1], device=x.device)[None, :], x)
        x, aux, _ = self.backbone_aux(x, "train", None, pos)
        if cfg.vision_tokens:
            x = x[:, cfg.vision_tokens:]
        tok_loss = softmax_xent(self.head(x), batch["labels"])
        mask = batch.get("loss_mask")
        if mask is None:
            loss = tok_loss.mean()
        else:
            loss = (tok_loss * mask).sum() / torch.clamp(mask.sum(), min=1)
        metrics = {"loss": loss}
        if aux:
            scale = 1.0 / self.groups
            loss = loss + 0.01 * aux["moe_lb_loss"] * scale \
                + 0.001 * aux["moe_z_loss"] * scale
            metrics.update({k: v * scale for k, v in aux.items()})
        metrics["total_loss"] = loss
        return loss, metrics

    def forward(self, batch):
        """``loss_fn``: what ``torch.func.functional_call`` runs when the
        train step computes with other tensors in place of the parameters
        (its bf16 copies)."""
        return self.loss_fn(batch)

    def init_cache(self, B: int, cache_len: int) -> List[Dict]:
        """Zero caches, one dict per sub-block, updated in place by prefill
        and decode: attention and moe {"k", "v", "len"[, "k_scale",
        "v_scale"]}
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
        """Process the prompt {tokens (B,S)[, patches (B,V,d)]}: patches
        and text fill the caches' first V + S places.  Returns
        (last_logits (B,1,V), caches)."""
        tokens = batch["tokens"]
        B = tokens.shape[0]
        x = self.embed_inputs(tokens, batch.get("patches"))
        pos = torch.arange(x.shape[1], device=x.device)[None, :]
        caches = self.init_cache(B, cache_len)
        x, caches = self.backbone(x, "prefill", caches, pos)
        return self.head(x[:, -1:]), caches

    @torch.inference_mode()
    def decode_step(self, tokens, caches, positions):
        """One token for every sequence.  tokens (B, 1); positions (B, 1)."""
        x = self.embed_inputs(tokens)
        x, caches = self.backbone(x, "decode", caches, positions)
        return self.head(x), caches
