"""Batched serving engine: prefill + greedy decode over preallocated KV
caches that every step updates in place (the port's counterpart of the
JAX engine's donated caches: appending one token never rewrites the
cache).

Prompts are left-padded with id 0 and carry no pad mask: every row sees
positions 0..S-1 and decodes at S + step, as in the JAX engine.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from ..configs.base import ShapeConfig
from ..models.api import ModelAPI


@dataclasses.dataclass
class Request:
    prompt: np.ndarray           # (S,) int32
    max_new: int = 16
    out: Optional[List[int]] = None


def pad_prompts(requests: List[Request], batch: int) -> np.ndarray:
    """(batch, S) int32 tokens, each prompt left-padded with 0 to the
    longest; rows past ``len(requests)`` are all padding."""
    S = max(len(r.prompt) for r in requests)
    toks = np.zeros((batch, S), np.int32)
    for i, r in enumerate(requests):
        toks[i, S - len(r.prompt):] = r.prompt
    return toks


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ServeEngine:
    def __init__(self, api: ModelAPI, *, batch: int, max_seq: int):
        self.api = api
        self.batch = batch
        self.max_seq = max_seq
        self.shape = ShapeConfig("serve", "prefill", max_seq, batch)
        self.stats = {"prefill_tokens": 0, "decode_steps": 0,
                      "prefill_s": 0.0, "decode_s": 0.0}

    def run_batch(self, requests: List[Request]) -> List[List[int]]:
        if not 0 < len(requests) <= self.batch:
            raise ValueError(f"{len(requests)} requests for a batch of "
                             f"{self.batch}")
        dev = self.api.device
        toks = pad_prompts(requests, self.batch)
        B, S = toks.shape
        t0 = time.perf_counter()
        logits, caches = self.api.prefill(
            {"tokens": torch.from_numpy(toks).to(dev)}, self.shape)
        cur = logits[:, -1].argmax(dim=-1).to(torch.int32).reshape(B, 1)
        _sync(dev)
        self.stats["prefill_s"] += time.perf_counter() - t0
        self.stats["prefill_tokens"] += B * S

        # tokens stay on the device; one copy to the host at the end
        steps = []
        max_new = max(r.max_new for r in requests)
        t0 = time.perf_counter()
        for step in range(max_new):
            steps.append(cur)
            logits, caches = self.api.serve_step(
                {"tokens": cur,
                 "positions": torch.full((B, 1), S + step, dtype=torch.int32,
                                         device=dev)},
                caches)
            cur = logits[:, -1].argmax(dim=-1).to(torch.int32).reshape(B, 1)
            self.stats["decode_steps"] += 1
        outs = torch.cat(steps, dim=1).cpu().numpy() if steps \
            else np.zeros((B, 0), np.int32)
        self.stats["decode_s"] += time.perf_counter() - t0
        return [outs[i, :r.max_new].tolist()
                for i, r in enumerate(requests)]
