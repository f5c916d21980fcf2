"""Serving entry point: batched prefill + greedy decode, in-place KV caches.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        --batch 4 --max-new 32                  # on the CUDA card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch recurrentgemma-9b --smoke --device cpu

With ``--prompt-shards N`` the requests come from zarquet prompt shards
through the core/sched worker-pool executor (``--workers`` overlaps shard
decompression) instead of being drawn randomly.  ``--workers-mode
process`` runs the shard loads in spawned OS processes over the Flight
data plane (file-backed store + SIPC wire references):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        --batch 8 --max-seq 1024 --max-new 32 --prompt-shards 4 \
        --prompts-per-shard 32 --workers 2 --workers-mode process

Weights are random, drawn on the serving device by a ``torch.Generator``
of that device seeded with 0 (a full-width model never passes through
host memory), and prompts are drawn with numpy's generator seeded with 0,
as in the JAX package's ``launch/serve.py``.  Without ``--device cpu`` it
runs on CUDA, and raises when no card is present.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from .. import resolve_device
from ..configs import get_arch, smoke_variant
from ..core import kdispatch
from ..kernels import ops
from ..models.api import ModelAPI
from ..serve.engine import (Request, ServeEngine, ZerrowPromptSource,
                            make_prompt_shards)


def main(argv=None) -> ServeEngine:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--kv-int8", action="store_true",
                    help="int8-quantized KV cache (halves cache memory)")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--prompt-shards", type=int, default=0,
                    help="serve prompts from N zarquet shards via the "
                         "sched executor (0 = random prompts)")
    ap.add_argument("--prompts-per-shard", type=int, default=32)
    ap.add_argument("--workers", type=int, default=1,
                    help="prompt-source worker-pool size")
    ap.add_argument("--workers-mode", default="thread",
                    choices=("thread", "process"),
                    help="run prompt-shard DAG nodes in threads or in "
                         "spawned Flight worker processes")
    ap.add_argument("--reader-threads", type=int, default=None,
                    help="zarquet reader-pool width inside each shard "
                         "load (default auto; 1 = serial)")
    ap.add_argument("--cache-root", default=None,
                    help="persistent content-addressed cache dir: prompt-"
                         "shard loads publish under node fingerprints and "
                         "re-launches adopt unchanged shards (CACHED) "
                         "instead of re-deserializing them")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "versions")
    a = ap.parse_args(argv)

    device = resolve_device(a.device)
    # the prompt source's Zerrow core (and its Flight workers) run their
    # relational kernels on the same device
    kdispatch.set_device(device.type)
    arch = get_arch(a.arch)
    if a.smoke:
        arch = smoke_variant(arch)
    if a.kv_int8:
        arch = dataclasses.replace(arch, kv_cache_dtype="int8")
    api = ModelAPI(arch, device)
    api.model.init(torch.Generator(device=device).manual_seed(0))
    engine = ServeEngine(api, batch=a.batch, max_seq=a.max_seq)

    source = None
    if a.prompt_shards > 0:
        shard_dir = os.path.join(tempfile.gettempdir(), "zerrow-prompts")
        paths = make_prompt_shards(shard_dir, a.prompt_shards,
                                   a.prompts_per_shard)
        source = ZerrowPromptSource(paths, batch=a.batch,
                                    max_new=a.max_new, workers=a.workers,
                                    workers_mode=a.workers_mode,
                                    reader_threads=a.reader_threads,
                                    cache_root=a.cache_root,
                                    max_prompt_len=a.max_seq // 2)
        batches = source.batches()
    else:
        rng = np.random.default_rng(0)
        batches = ([Request(prompt=rng.integers(
            1, arch.vocab, size=int(rng.integers(8, a.max_seq // 2))
        ).astype(np.int32), max_new=a.max_new) for _ in range(a.batch)]
            for _ in range(a.rounds))

    ops.reset_launch_counts()
    for r, reqs in enumerate(batches):
        if r >= a.rounds:
            break
        t0 = time.perf_counter()
        outs = engine.run_batch(reqs)
        dt = time.perf_counter() - t0
        toks = sum(len(o) for o in outs)
        print(f"round {r}: {toks} tokens in {dt:.2f}s "
              f"({toks / dt:.1f} tok/s)")
    if source is not None:
        source.close()
    s = engine.stats
    print(f"totals on {device}: prefill {s['prefill_tokens']} tok / "
          f"{s['prefill_s']:.2f}s | decode {s['decode_steps']} steps / "
          f"{s['decode_s']:.2f}s "
          f"({s['decode_s'] / max(s['decode_steps'], 1) * 1e3:.1f} ms/step)"
          f" | kernel launches {ops.launch_counts}")
    return engine


if __name__ == "__main__":
    main()
