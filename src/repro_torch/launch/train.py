"""Training entry point: Zerrow data pipeline -> train step -> async
Zerrow-backed checkpoints, with fleet monitoring hooks.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --steps 50                                   # on the CUDA card
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
        --steps 12

The same flags and printed lines as the JAX package's
``launch/train.py``, and ``--ckpt-every`` (its ``train_loop``'s
``ckpt_every``, 50 by default).  Weights are random, drawn on the
training device by a ``torch.Generator`` of that device seeded with 0.
The corpus is made under ``$TMPDIR/zerrow-corpus`` when that directory
is empty.  Without ``--device cpu`` it runs on CUDA, and raises when no
card is present; the pipeline's corpus join runs its relational kernels
on the same device.  The vlm and enc-dec models (internvl2-26b,
whisper-medium) raise ``ValueError``: their batches need patch or frame
embeddings that the text pipeline does not make (ROADMAP.md queue 3,
item s).  A step's printed time ends when its loss reaches the host.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from .. import resolve_device
from ..configs import get_arch, smoke_variant
from ..core import kdispatch
from ..data.pipeline import (PipelineConfig, ZerrowDataPipeline,
                             make_text_shards)
from ..models.api import ModelAPI
from ..runtime.checkpoint import CheckpointStore
from ..runtime.fault import FleetMonitor
from ..train.trainstep import init_state, make_train_step


def train_loop(arch_name: str, *, steps: int = 100, batch: int = 8,
               seq_len: int = 256, smoke: bool = True,
               ckpt_dir: str = None, ckpt_every: int = 50,
               data_dir: str = None, lr: float = 1e-3,
               log_every: int = 10, resume: bool = False,
               data_workers: int = 1, workers_mode: str = "thread",
               reader_threads: int = None, cache_root: str = None,
               device="cuda"):
    arch = get_arch(arch_name)
    if arch.is_encdec or arch.vision_tokens:
        need = "frames" if arch.is_encdec else "patches"
        raise ValueError(
            f"{arch.name}: a train batch needs {need!r}, which the text "
            "pipeline does not give, and the JAX package's launcher fails "
            "here too (ROADMAP.md queue 3, item s); train it through "
            f"ModelAPI.train_loss or make_train_step with {need} in the "
            "batch")
    device = resolve_device(device)
    kdispatch.set_device(device.type)
    if smoke:
        arch = smoke_variant(arch)
    arch = dataclasses.replace(arch, vocab=max(arch.vocab, 257))
    api = ModelAPI(arch, device)

    data_dir = data_dir or os.path.join(tempfile.gettempdir(),
                                        "zerrow-corpus")
    if not os.path.isdir(data_dir) or not os.listdir(data_dir):
        make_text_shards(data_dir, n_shards=2, rows_per_shard=4000)
    shards = sorted(os.path.join(data_dir, f)
                    for f in os.listdir(data_dir) if f.endswith(".zq"))
    pipe = ZerrowDataPipeline(shards, PipelineConfig(
        batch=batch, seq_len=seq_len, workers=data_workers,
        workers_mode=workers_mode, reader_threads=reader_threads,
        cache_root=cache_root))

    state = init_state(api, torch.Generator(device=device).manual_seed(0))
    store = None
    if ckpt_dir:
        store = CheckpointStore(ckpt_dir)
        if resume and store.latest_step() is not None:
            state, mani = store.restore(like=state)
            print(f"resumed from step {mani['step']}")
    step_fn = make_train_step(api, peak_lr=lr, total_steps=steps)

    monitor = FleetMonitor(n_workers=1)
    t_start = time.perf_counter()
    it = pipe.batches(epochs=10_000)
    losses = []
    for i in range(steps):
        batch_np = next(it)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, {
            k: torch.from_numpy(batch_np[k]).to(device)
            for k in ("tokens", "labels")})
        losses.append(float(metrics["loss"]))
        dt = time.perf_counter() - t0
        monitor.heartbeat(0, i, dt)
        if i % log_every == 0 or i == steps - 1:
            print(f"step {i:5d} loss {losses[-1]:.4f} "
                  f"lr {float(metrics['lr']):.2e} {dt*1e3:.0f}ms")
        if store and (i + 1) % ckpt_every == 0:
            store.save(i + 1, state)
    if store:
        store.close()
    print("pipeline stats:", {k: v for k, v in pipe.stats().items()
                              if k in ("decache_hits", "loads",
                                       "bytes_reshared", "bytes_deanon",
                                       "bytes_copied")})
    pipe.close()
    wall = time.perf_counter() - t_start
    print(f"done: {steps} steps in {wall:.1f}s; "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-friendly)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50,
                    help="snapshot every this many steps")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--data-workers", type=int, default=1,
                    help="data-pipeline worker-pool size (overlaps shard "
                         "decompression across loader nodes)")
    ap.add_argument("--workers-mode", default="thread",
                    choices=("thread", "process"),
                    help="run pipeline DAG nodes in threads or in spawned "
                         "Flight worker processes (tokenize/pack scale "
                         "past the GIL)")
    ap.add_argument("--reader-threads", type=int, default=None,
                    help="zarquet reader-pool width: fan column-chunk "
                         "decompression across this many threads inside "
                         "each shard load (default auto; 1 = serial)")
    ap.add_argument("--cache-root", default=None,
                    help="persistent content-addressed cache dir: packed "
                         "shards publish under node fingerprints and "
                         "restarts adopt unchanged shards instead of "
                         "re-tokenizing (differential caching)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "versions")
    a = ap.parse_args(argv)
    return train_loop(a.arch, steps=a.steps, batch=a.batch,
                      seq_len=a.seq_len, smoke=a.smoke, ckpt_dir=a.ckpt_dir,
                      ckpt_every=a.ckpt_every, resume=a.resume, lr=a.lr,
                      data_workers=a.data_workers,
                      workers_mode=a.workers_mode,
                      reader_threads=a.reader_threads,
                      cache_root=a.cache_root, device=a.device)


if __name__ == "__main__":
    main()
