"""Batched serving engine: prefill + greedy decode over preallocated KV
caches that every step updates in place (the port's counterpart of the
JAX engine's donated caches: appending one token never rewrites the
cache).

Prompts are left-padded with id 0 and carry no pad mask: every row sees
positions 0..S-1 and decodes at S + step, as in the JAX engine.

``ZerrowPromptSource`` feeds the engine from zarquet prompt shards through
the ``core/sched`` worker-pool executor: shard decompression overlaps
across workers, and the DeCache shares decoded shards between engine
replicas reading the same corpus.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Iterator, List, Optional

import numpy as np
import torch

from ..configs.base import ShapeConfig
from ..core import (BufferStore, DAG, NodeSpec, RMConfig, ResourceManager,
                    SipcReader, Table, make_executor)
from ..core import zarquet
from ..models.api import ModelAPI


def passthrough_fn(tables: List[Table]) -> Table:
    """Identity node: every output buffer is reshared (zero-copy).
    Module-level so it pickles into Flight worker processes."""
    return tables[0]


@dataclasses.dataclass
class Request:
    prompt: np.ndarray           # (S,) int32
    max_new: int = 16
    out: Optional[List[int]] = None


def make_prompt_shards(root: str, n_shards: int, prompts_per_shard: int,
                       seed: int = 0) -> List[str]:
    """Synthetic prompt corpus: zarquet shards with a utf8 'text' column."""
    rng = np.random.default_rng(seed)
    words = ["describe", "the", "zero", "copy", "arrow", "pipeline",
             "memory", "kernel", "shared", "data", "cache", "batch",
             "serve", "model", "token", "fast"]
    os.makedirs(root, exist_ok=True)
    paths = []
    for s in range(n_shards):
        texts = [" ".join(rng.choice(words, size=rng.integers(4, 16)))
                 for _ in range(prompts_per_shard)]
        p = os.path.join(root, f"prompts-{s:04d}.zq")
        zarquet.write_table(p, Table.from_pydict({"text": texts}))
        paths.append(p)
    return paths


class ZerrowPromptSource:
    """Streams ``Request`` batches out of zarquet prompt shards via the
    sched executor.  All shard DAGs are submitted in one ``run`` so loader
    decompression overlaps across the worker pool; prompts are
    byte-tokenized (ids 1..256, 0 stays PAD) so any vocab >= 257 works.
    With ``workers_mode='process'`` the shard loads run in spawned OS
    processes over the Flight data plane (file-backed store, SIPC wire
    references) and scale past the GIL."""

    def __init__(self, shard_paths: List[str], *, batch: int,
                 max_new: int = 16, workers: int = 1,
                 workers_mode: str = "thread",
                 reader_threads: Optional[int] = None,
                 max_prompt_len: Optional[int] = None,
                 memory_limit: Optional[int] = None,
                 cache_root: Optional[str] = None,
                 store: Optional[BufferStore] = None,
                 rm: Optional[ResourceManager] = None,
                 tenant: str = "default",
                 deadline_s: Optional[float] = None):
        self.paths = list(shard_paths)
        self.batch = batch
        self.max_new = max_new
        self.max_prompt_len = max_prompt_len
        # admission identity: shard DAGs carry the source's tenant (for
        # budget isolation) and an optional per-run deadline; when the RM
        # enforces deadlines, shard loads past it are cancelled and
        # surface as ``missed_shards`` instead of stalling the engine
        self.tenant = tenant
        self.deadline_s = deadline_s
        self.missed_shards = 0
        backing = ("file" if workers_mode == "process" or cache_root
                   else "ram")
        self.store = store or BufferStore(backing=backing, root=cache_root)
        self.rm = rm or ResourceManager(
            self.store, RMConfig(memory_limit=memory_limit,
                                 workers=workers,
                                 workers_mode=workers_mode,
                                 reader_threads=reader_threads,
                                 cache_root=cache_root))
        self.ex = make_executor(self.store, self.rm, workers=workers)

    def batches(self) -> Iterator[List[Request]]:
        dags = []
        deadline = None if self.deadline_s is None \
            else time.monotonic() + self.deadline_s
        for p in self.paths:
            est = max(os.path.getsize(p) * 8, 1 << 20)
            dags.append(DAG([
                NodeSpec("load", source=p, est_mem=est),
                NodeSpec("prompts", fn=passthrough_fn, deps=["load"],
                         est_mem=est // 4, keep_output=True),
            ], name=f"prompts-{os.path.basename(p)}",
                tenant=self.tenant, deadline=deadline))
        self.ex.run(dags)
        pending: List[Request] = []
        for dag in dags:
            msg = dag.nodes["prompts"].output
            if dag.cancelled or msg is None:
                # shed / deadline-missed shard: the engine degrades to
                # fewer prompts rather than crashing on a None output
                self.missed_shards += 1
                continue
            table = SipcReader(self.store).read_table(msg)
            col = table.combine().batches[0].column("text")
            for i in range(col.length):
                ids = np.frombuffer(col.get_bytes(i),
                                    dtype=np.uint8).astype(np.int32) + 1
                if self.max_prompt_len is not None:
                    ids = ids[:self.max_prompt_len]
                if len(ids) == 0:
                    continue
                pending.append(Request(prompt=ids, max_new=self.max_new))
                if len(pending) == self.batch:
                    yield pending
                    pending = []
            msg.release()
        if pending:
            yield pending

    def close(self) -> None:
        self.ex.close()
        self.store.close()


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
