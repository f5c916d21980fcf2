"""Unified model API: build an architecture on a device and get its
train / prefill / decode entry points and input shapes."""

from __future__ import annotations

from typing import Dict, Tuple

from ..configs.base import ArchConfig, ShapeConfig
from .lm import DecoderLM


class ModelAPI:
    def __init__(self, cfg: ArchConfig, device="cuda"):
        self.cfg = cfg
        self.model = DecoderLM(cfg, device)

    @property
    def device(self):
        return self.model.device

    def input_specs(self, shape: ShapeConfig) -> Dict[str, Tuple[int, ...]]:
        """Shape of every int32 model input.

        train/prefill: {tokens (B,S)[, labels (B,S)]}
        decode:        {tokens (B,1), positions (B,1)} (caches separately)
        """
        B, S = shape.global_batch, shape.seq_len
        if shape.kind == "train":
            return {"tokens": (B, S), "labels": (B, S)}
        if shape.kind == "prefill":
            return {"tokens": (B, S)}
        return {"tokens": (B, 1), "positions": (B, 1)}

    def train_loss(self, batch):
        """(loss, metrics) of a train batch {tokens, labels[, loss_mask]}."""
        return self.model.loss_fn(batch)

    def prefill(self, batch, shape: ShapeConfig):
        return self.model.prefill(batch, cache_len=shape.seq_len)

    def serve_step(self, batch, caches):
        """decode: one new token for every sequence in the batch."""
        return self.model.decode_step(batch["tokens"], caches,
                                      batch["positions"])
