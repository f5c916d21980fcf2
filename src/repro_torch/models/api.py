"""Unified model API: build an architecture on a device and get its
train / prefill / decode entry points and input shapes."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..configs.base import ArchConfig, ShapeConfig
from .encdec import EncDecLM
from .lm import DecoderLM


class Spec(tuple):
    """An input's shape (the tuple itself) and its ``dtype``: the port's
    stand-in for ``jax.ShapeDtypeStruct``."""

    def __new__(cls, shape: Tuple[int, ...], dtype: torch.dtype):
        self = super().__new__(cls, shape)
        self.dtype = dtype
        return self

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self)


class ModelAPI:
    def __init__(self, cfg: ArchConfig, device="cuda"):
        self.cfg = cfg
        self.model = EncDecLM(cfg, device) if cfg.is_encdec \
            else DecoderLM(cfg, device)

    @property
    def device(self):
        return self.model.device

    def input_specs(self, shape: ShapeConfig) -> Dict[str, Spec]:
        """Shape and dtype of every model input, as the JAX package's
        ``input_specs``: int32 tokens, labels and positions; patches and
        frames in the compute dtype.

        train:   {[frames (B,S,d) | patches (B,V,d)], tokens, labels}
                 (tokens and labels (B,S), or (B,S-V) beside patches)
        prefill: {[frames | patches], tokens} (an enc-dec's tokens: a BOS,
                 (B,1))
        decode:  {tokens (B,1), positions (B,1)} (caches separately)
        """
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        i32, act = torch.int32, getattr(torch, cfg.dtype)
        V = cfg.vision_tokens
        if shape.kind == "decode":
            return {"tokens": Spec((B, 1), i32),
                    "positions": Spec((B, 1), i32)}
        d: Dict[str, Spec] = {}
        if cfg.is_encdec:
            d["frames"] = Spec((B, S, cfg.d_model), act)
        elif V:
            d["patches"] = Spec((B, V, cfg.d_model), act)
        text = Spec((B, S - V), i32)
        if shape.kind == "train":
            d["tokens"] = d["labels"] = text
        else:
            d["tokens"] = Spec((B, 1), i32) if cfg.is_encdec else text
        return d

    def input_axes(self, shape: ShapeConfig) -> Dict[str, Tuple]:
        """Logical axes of every input of ``input_specs``."""
        ax: Dict[str, Tuple] = {}
        for k in self.input_specs(shape):
            if k in ("frames", "patches"):
                ax[k] = ("batch", "seq", None) if k == "frames" \
                    else ("batch", None, None)
            else:
                ax[k] = ("batch", "seq") if shape.kind != "decode" \
                    else ("batch", None)
        return ax

    def cache_axes(self):
        """Logical axes of the JAX package's decode caches: an enc-dec's
        is (self caches, the cross (k, v) stacked over the layers)."""
        base = self.model.cache_axes()
        if self.cfg.is_encdec:
            cross = ((None, "batch", "kv_seq", "kv_heads", None),) * 2
            return (base, cross)
        return base

    def train_loss(self, batch):
        """(loss, metrics) of a train batch {tokens, labels[, loss_mask][,
        patches | frames]}."""
        return self.model.loss_fn(batch)

    def prefill(self, batch, shape: ShapeConfig):
        return self.model.prefill(batch, cache_len=shape.seq_len)

    def serve_step(self, batch, caches):
        """decode: one new token for every sequence in the batch."""
        return self.model.decode_step(batch["tokens"], caches,
                                      batch["positions"])
