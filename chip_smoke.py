#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

1. Device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 off, so float32 products are full float32.
2. Build: every kernel source of src/repro_torch/kernels/csrc, one nvcc
   each for sm_90a, all started together (each one's set-up time).  The
   tensor-core instructions (HMMA, HGMMA) of each flash and wkv6
   instantiation are counted in the built library (``cuobjdump -sass``):
   the run fails if a bf16 instantiation has none.  Each instantiation's
   registers, shared memory, spills and resident blocks per SM, as the
   card reports them; for every segreduce kernel, what ptxas reported
   (``-Xptxas -v``: registers, shared memory, spills; a spill fails).
3. Flash attention: held against its plain PyTorch version
   (``ref.attention_ref``) on the same CUDA tensors, at the serving shape
   and at the tile edges (ragged and cross lengths, every head dim, G 3 to
   16, a window whose first tile is not tile 0, strided and unaligned q);
   timed at the serving shape from the card's clock beside PyTorch's
   ``scaled_dot_product_attention`` (timed only; the port never calls it)
   and the kernel's bound.
4. Serve: smollm-135m at full width (30 layers, d_model 576, random
   weights drawn on the card from a seeded CUDA generator) through
   ``ModelAPI`` + ``ServeEngine``, 2 rounds of batch 8, prompts of 256-512
   tokens, max_seq 1024, 32 new tokens.  The launch counts are set to 0
   just before and read just after: every prefill must launch the kernel
   once per layer.  Round 0's prefill logits are recomputed with attention
   forced to the model's plain path (``attention.chunked_attention``), in
   bf16 and with the same weights computing in float32.  A profiled warm
   round gives the device's busy share and its largest kernels.
5. Relational kernels (splitmix64 hash and fold, sentinel gather, segment
   reductions): each wrapper against its plain PyTorch version on the
   same CUDA tensors, bit for bit, over every dtype family and edge case;
   the segment reductions for every set of count, sum, min and max on
   every path of segreduce.cu that takes the groups (G on both sides of
   32 and 255, up to SF10), and an ``order`` that names a row twice, which
   the few-groups paths must flag; then at the shapes of the star query at
   TPC-H scale factor 10, the kernel, its plain version and, where one
   PyTorch call computes the same function, that call, all timed from
   CUDA-graph replays of the kernel's binding (the validating wrapper
   syncs once per call, which a graph cannot hold), beside the bound and
   the copies of one call's arrays between host and card that
   ``core.kdispatch`` makes at its edge; segreduce on each of its paths,
   as four one-op calls, and at a many-groups shape (about 1.65 M groups),
   in turns.
6. The star query at SF10 through ``repro_torch.core.ops``: 15,000,000
   orders left-joined to 1,500,000 customers and grouped by 25 nations
   (sum/min/max/count of the amount in one segreduce launch), and the
   same through ``filter_join`` with an amount filter.  Each runs on
   ``cuda`` with the launch counts set to 0 just before and read just
   after, and on the port's ``cpu`` device; every output buffer must
   agree bit for bit, and the group totals must equal a numpy recount.
   A profiled cuda run gives the device's busy share and the time spent
   at the kdispatch edge (by call: ``grouped_reduce`` is the group-by's).
7. Recurrent kernels (WKV-6 and RG-LRU scans) and flash attention at hd
   256 with a 2048-token window: each against its plain PyTorch version on
   the same CUDA tensors over ragged lengths (the edges of the bf16 wkv6
   kernel's 16-token chunks), widths, head sizes (a wkv6 warp per 16
   columns of the state), dtypes, initial states, decays (down to 1e-30,
   where the bf16 kernel's chunks leave the factorised form) and inputs
   whose base is not 16-byte aligned (staged element by element); then timed
   at the serving shapes of the two
   models below from CUDA-graph replays, beside the plain version, the
   bound and, for attention, ``scaled_dot_product_attention``.
8. Serve rwkv6-3b at full width (32 layers, d_model 2560, 40 heads of 64,
   random weights drawn on the card from a seeded CUDA generator): 2 rounds
   of batch 8, prompts of 256-512 tokens, max_seq 1024, 32 new tokens; 32
   ``wkv6`` launches per prefill.  Round 0's prefill logits are recomputed
   with ``ops.wkv6`` swapped for its plain version, in bf16 and with the
   same weights computing in float32, and once more on the plain path in
   float64, whose gap to the plain float32 logits (the float32 noise
   floor) sets the float32 bound; every wkv6 launch of one more
   prefill is held to the plain version on its own inputs (and, per
   launch, how many bf16 outputs stand more than one ulp from it is
   printed); in float32, one decode step after S tokens is held against a
   prefill of S + 1 tokens.
   A profiled warm round.
9. Serve recurrentgemma-9b at full width (12 groups of (rec, rec, attn):
   36 sub-blocks, d_model 4096, lru_width 4096, 16 query heads and 1 KV
   head of 256, window 2048): one round of batch 8 as above, and one
   request of 3072 tokens at max_seq 4096, whose prefill attention the
   window cuts and whose decode writes the ring cache; 24 ``rglru_scan``
   and 12 ``flash_attention`` launches per prefill.  Both prefills are
   recomputed with the plain scan and attention (bf16 and float32), every
   launch of one more prefill is held to its plain version on its own
   inputs, and decode is held against prefill in float32.  A profiled
   warm round.
10. Row gather and dictionary decode (``take_rows``, ``dict_decode``; no
    path calls them), run right after phase 7: each wrapper against its
    plain version on the same CUDA tensors, bit for bit, over float32,
    bfloat16, int32, int64 and uint8 tables of any bits (NaN payloads,
    infinities, -0.0), widths 1 to 130, ragged M, int32 and int64 indices,
    unaligned bases and dictionaries on both sides of the shared-memory
    limit; out-of-range indices must raise ``IndexError`` and zero rows
    launch nothing.  Each of the five CUDA wrappers that take floats must
    refuse an input that requires grad while grad is enabled.  Then four
    cells timed from CUDA-graph replays: kernel, plain version and
    ``torch.index_select``, beside the byte bound.
11. The Zerrow core, threads (run right after phase 6, on its tables):
    both star queries written as plans over zarquet files of the same
    tables (``repro_torch.core.plan``; the fusion rule rewrites the
    filtered one onto ``filter_join``), compiled by ``compile_plans`` and
    run by ``make_executor`` over a RAM store with 4 worker threads.  The
    launch counts are set to 0 just before each run and read just after;
    the group-by's buffers must equal phase 6's and the numpy recount.
    Each query's wall time, the store's copied, de-anonymized and
    reshared bytes and the bytes ``kdispatch`` moved to and from the card
    are printed.
12. The Zerrow core, processes: the left-join query through 2 spawned
    Flight workers over a file-backed store.  The workers run on
    ``cuda`` (the parent hands them its device): their kernel launches,
    echoed in each reply, must equal the thread run's, the parent
    launches nothing, and the group-by equals phase 6's bit for bit.  A
    small star before it shows what a worker's first join costs (its CUDA
    context and the kernels' libraries).
13. Zerrow prompts: smollm-135m at full width served over
    ``ZerrowPromptSource`` (4 zarquet shards of 8 prompts, one DAG a
    shard) in thread and in process mode, batch 8, max_seq 1024, 32 new
    tokens: every prompt must be its shard text byte-tokenized, every
    prefill must launch flash attention once per layer, tokens in
    ``[0, vocab)``; then ``python -m repro_torch.launch.serve
    --prompt-shards 4 --workers 2 --workers-mode process`` as a user
    runs it, for 2 rounds.
14. The training input pipeline (run right after phase 13):
    ``ZerrowDataPipeline`` over a corpus of 2 zarquet shards of 250,000
    documents each (about 22 MB of text a shard) and the metadata of
    500,000 documents (keep_frac 0.75), batch 8 x 1024 tokens, in thread
    mode (4 workers) on ``cuda`` and on ``cpu``, then through 2 Flight
    workers on ``cuda``.  Every batch of each run must equal the numpy
    recount (the kept documents' bytes in order), so the three runs are
    bit-identical; the launch counts, set to 0 just before each run and
    read just after, must be 2 times what one shard's join by hand
    launches, in this process for threads and in the workers (the parent
    launching nothing) for processes.  Each run's wall time and stats.
15. Train smollm-135m at full width (30 layers, d_model 576, vocab 49152,
    float32 masters, bf16 compute, remat, AdamW; weights drawn on the card
    from a seeded CUDA generator) for 10 steps on phase 14's batches,
    peak lr 1e-3, warmup 3: every loss and grad norm finite, the mean
    loss of the last 5 steps below step 0's, no kernel launched on the
    model path (attention trains through ``chunked_attention``).  Median
    step time, tokens per second, peak memory, and a profiled step.
16. The card against the CPU: the same full-width model in float32 (TF32
    off), B 1 x S 128, from the same weights (drawn on the card, copied):
    step 0's grads per leaf within 1e-5 relative L2, the loss and grad
    norm of two steps within 1e-4.
17. Checkpoints: phase 15's train state saved through ``CheckpointStore``
    (async) and restored onto the card into a fresh state, bit for bit; a
    second save reuses every blob.  Then ``python -m
    repro_torch.launch.train --arch smollm-135m --steps 50 --ckpt-dir D``
    as a user runs it, with ``TMPDIR`` set to a fresh directory (it makes
    its own corpus), and again with ``--resume --steps 2``, which must
    resume from step 50; every loss finite.
18. Train rwkv6-3b at full width and depth (32 layers, 3.07 B
    parameters; run right after phase 17, as 19 and 21 are): float32
    masters, bf16 compute, remat, AdamW, 10 steps of B 4 x S 1024 (peak lr
    1e-3, warmup 3) on batches of ``ZerrowDataPipeline`` over one of phase
    14's shards, its metadata join on the card.  The launch counts, set to
    0 just before the pipeline and read after the last step, must be one
    shard's join and no model kernel (train mode runs the chunked WKV-6
    form in plain PyTorch).  Losses and grad norms finite, the mean of the
    last 3 losses below step 0's; median step, tokens per second, peak
    memory and a profiled step (device activity only).  Then phase 16's
    float32 card-against-CPU step at full width and 2 layers.
19. Train recurrentgemma-9b at full width, one group of (rec, rec, attn)
    (2.69 B parameters with the untied embedding and head), B 1 x S 4096
    (the 2048 window cuts train attention), as phase 18; the
    card-against-CPU step at that depth.
20. Serve qwen3-moe-30b-a3b at full width and 16 of its 48 layers (10.6
    B parameters, 42.4 GB of float32 weights; run right after phase 9):
    phase 8's traffic, 16 flash launches a prefill at hd 128 with 32 query
    and 4 KV heads; each prefill's ``moe_dropped`` printed.  Round 0's
    prefill through the kernel against chunked attention, in bf16 and
    float32, with the routing of every layer recorded in both: the
    token-layers routed differently are counted and printed, and the
    last-token logits held for the sequences routed alike (in float32 more
    than 1 % of flipped token-layers, or no sequence routed alike, fails);
    every flash launch of one more prefill held to its plain version on
    its own inputs; decode after S tokens against a prefill of S + 1 in
    float32 with capacity factor n_experts / top_k, so that no pair drops
    (decode's T = B tokens have capacity 1 at the served 1.25).  A profiled
    warm round.  Then flash timed at that prefill shape (B 8, S = T 512,
    H 32, KV 4, hd 128) as in phase 3.
21. Train qwen3-moe-30b-a3b at full width and 4 layers (3.11 B
    parameters), B 2 x S 1024, as phase 18, with the MoE metrics of each
    step printed and finite; in the card-against-CPU step at 2 layers the
    routing of each forward is compared first: where it agrees the grads
    are held to 1e-5 per leaf, where it differs the loss to 1e-3, and more
    than 1 % of token-layers routed differently fails.
22. Flash attention at the served shapes of the vlm and enc-dec
    families (run right after phase 20): internvl2-26b's prefill (B 8,
    48 query and 8 KV heads, G 6, hd 128, causal; 256 patches and 512
    tokens, and a ragged 461) and whisper-medium's encoder (B 8, S = T
    1500 frames, 16 heads, G 1, hd 64, non-causal) and decoder BOS prefill
    (S = T = 1), in bf16 and float32, each against its plain version;
    then the first two timed as in phase 3 (kernel, plain, sdpa, bound).
23. Serve internvl2-26b at full width and 24 of its 48 layers (10.5 B
    parameters, 42.1 GB of float32 weights) through ``ModelAPI.prefill``
    and ``serve_step``: 2 rounds of batch 8, each sequence 256 patch
    embeddings (seeded normals: the InternViT frontend is a stub) before
    a left-padded prompt of 256-512 random tokens, a cache of 1280, 32 new
    tokens.  Each prefill must launch flash 24 times, every launch at G 6
    over the patches and the text.  Round 0's prefill against the plain
    path in bf16 and float32, every flash launch of one more prefill
    against its plain version on its own inputs, decode against prefill
    in float32 (two sequences), a profiled warm round.
24. Serve whisper-medium uncut (24 + 24 layers, 0.76 B parameters) the
    same way: 2 rounds of batch 8, 1500 frame embeddings a sequence
    (seeded normals: the conv frontend is a stub) and a BOS prompt, a
    cache of 1500, 32 new tokens.  Each prefill must launch flash 48
    times: 24 non-causal over the 1500 frames (the encoder) and 24 at S =
    T = 1 (the decoder's BOS).  The same checks as phase 23.
25. Train internvl2-26b at full width and 5 layers (3.13 B parameters,
    56.3 GB at 18 bytes a parameter), B 2 x (256 patches + 768 tokens of
    the pipeline), as phase 18 trains but at peak lr 1e-4 (at 1e-3 this
    width's loss rises from step 3), then the float32 card-against-CPU
    step at 1 layer.
26. Train whisper-medium uncut (13.7 GB), B 8 x (1500 frames + 448 tokens
    of the pipeline), as phase 18, then the card-against-CPU step at 2 +
    2 layers.
27. A JSON line per kernel, then ``{"ok": true, "device": ...}`` as the
    last line.
28. Sharded training (run right after phase 17): smollm-135m at full
    width on ``torch.cuda.device_count()`` spawned NCCL ranks, one card
    each (world size 1 on a one-card machine), 3 AdamW steps of phase 14's
    B 8 x S 1024 batches with bf16 compute on float32 masters, from the
    same seeded weights: unsharded; on a ("data", "model") mesh under
    DEFAULT_RULES and FSDP_RULES, each held to the unsharded step (loss,
    grad norm, relative L2 per leaf within 1e-6); on a ("pod", "data",
    "model") mesh with ``grad_compression``, step 0's loss held likewise
    and every step's int8 codes, scales and residuals bit for bit to
    ``compress_grads_allreduce`` run on the CPU on the grads and residual
    the step captured.  The DEFAULT run's state is saved (rank 0 writes)
    and restored with ``shardings=`` onto the mesh and without them onto
    the CPU, bit for bit.  Each run's step times and peak memory, the
    median step on the mesh against unsharded, the world size and the
    card's name and power limit.  The ranks have a deadline; a hang or a
    failed rank kills them all and fails the phase.

Every check that fails exits non-zero before the last line is printed.
Without a CUDA card, or run from a directory without the repository's
``src/``, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import cProfile
import dataclasses
import hashlib
import itertools
import json
import os
import pstats
import queue
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import ShapeConfig, get_arch  # noqa: E402
from repro_torch.core import (  # noqa: E402
    BufferStore, RMConfig, ResourceManager, kdispatch, make_executor, plan,
    vkernels, zarquet)
from repro_torch.core import ops as rops  # noqa: E402
from repro_torch.core.arrow import Column, Table  # noqa: E402
from repro_torch.core.plan import compiler as plan_compiler  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    build, flash_attention, ops, ref, relational, take_gather, wkv6)
from repro_torch.models import attention  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.api import ModelAPI  # noqa: E402
from repro_torch.data.pipeline import (  # noqa: E402
    PipelineConfig, ZerrowDataPipeline, join_filter_fn, make_doc_meta,
    make_text_shards)
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    flatten_paths, jax_leaves, train_state_to_jax)
from repro_torch.runtime.checkpoint import CheckpointStore  # noqa: E402
from repro_torch.train.trainstep import (  # noqa: E402
    init_state, make_train_step)
from repro_torch.serve.engine import (  # noqa: E402
    Request, ServeEngine, ZerrowPromptSource, make_prompt_shards,
    pad_prompts)

# H100 SXM, NVIDIA data sheet (dense, at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12          # float32 outside the tensor cores

SERVE_SHAPE = dict(B=8, S=512, T=512, H=9, KV=3, hd=64)
# qwen3-moe-30b-a3b's served prefill: 32 query and 4 KV heads of 128
MOE_SHAPE = dict(B=8, S=512, T=512, H=32, KV=4, hd=128)
# bf16: the plain version computes in f32 and rounds once to bf16; the
# tensor-core kernel also rounds P to bf16 before the P V product (the
# JAX model's chunked_attention does the same).  Each p moves by at most
# 2^-8 of itself and P sums to 1 over a row, so the output moves by at
# most 2^-8 of the largest |v| it averages, and over many keys the errors
# partly cancel: tests/test_torch_flash_numerics.py measures at most one
# bf16 ulp of the output (0.0156 at |out| up to 4), so one output ulp
# still dominates the error and the bound stays 2e-2.
# f32: the FMA kernel; the two sum up to T = 512 terms in different
# orders; the worst case is T * 2^-24 * max|v| ~ 1.2e-4 at |v| <= 4.
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# Prefill logits, kernel vs the model's plain attention (chunked_attention,
# which rounds the probabilities to bf16 before the PV product, as the JAX
# path does), as relative L2 error and as max error over the largest
# |logit|.  bf16 model: the two attention paths differ by about one bf16
# ulp, but each flipped rounding is amplified through 30 layers of random
# weights, so the bound is loose and the f32 model carries the tight
# check: its attention outputs differ by f32 summation order only.  The
# same bounds hold the recurrent models of phases 8-9, where bf16 may also
# take half of bf16's own noise, and rwkv6-3b's float32 twice the float32
# noise floor measured against float64 (``kernel_vs_plain_prefill``).
LOGIT_TOL = {torch.bfloat16: 4e-2, torch.float32: 1e-3}


def check(ok: bool, what: str) -> None:
    if not ok:
        print(f"FAILED: {what}", flush=True)
        sys.exit(1)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def sync() -> None:
    torch.cuda.synchronize()


def time_ms(fn, iters: int = 20, reps: int = 7) -> list:
    """Device times of one call of ``fn``: ``iters`` calls captured in one
    CUDA graph, replayed ``reps`` times between CUDA events; each replay's
    time over ``iters``, sorted.  A replay issues nothing from the host
    between the calls, so the time is the card's and not Python's."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):                  # warm-up outside the capture
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    sync()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / iters)
    return sorted(times)


def bound(nbytes: float, flops: float, flop_per_s: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_per_s
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


def spread(t) -> str:
    return (f"median {statistics.median(t)!r} (min {min(t)!r}, max "
            f"{max(t)!r} over {len(t)} graph replays)")


@contextlib.contextmanager
def compute_dtype(api, dtype):
    """Run the model with float32 activations on its own float32 weights:
    the compute dtype is only where the embedding output is cast and the
    caches are made, so no copy of the weights is needed."""
    old, api.model.cdtype = api.model.cdtype, dtype
    try:
        yield
    finally:
        api.model.cdtype = old


def run_rounds(engine, rounds, label: str) -> list:
    outs = []
    for r, reqs in enumerate(rounds):
        before = dict(engine.stats)
        outs.append(engine.run_batch(reqs))
        s = {k: engine.stats[k] - before[k] for k in before}
        B = engine.batch
        print(f"{label} round {r}: prefill {s['prefill_tokens']} tokens in "
              f"{s['prefill_s'] * 1e3:.2f} ms "
              f"({s['prefill_tokens'] / s['prefill_s']:.0f} tok/s) | decode "
              f"{s['decode_steps']} steps in {s['decode_s'] * 1e3:.2f} ms "
              f"({s['decode_s'] / s['decode_steps'] * 1e3:.3f} ms/step, "
              f"{B * s['decode_steps'] / s['decode_s']:.0f} tok/s)")
    return outs


def check_tokens(outs, n: int, vocab: int, what: str) -> None:
    toks = np.array([t for o in outs for row in o for t in row])
    check(toks.size == n and toks.min() >= 0 and toks.max() < vocab,
          f"{what}: served tokens out of [0, vocab) or missing")


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm()).item()


def rel_max(a, b) -> float:
    a, b = a.double(), b.double()
    return ((a - b).abs().max() / b.abs().max()).item()


def compare_logits(a, b, tol, what: str) -> None:
    """Relative L2 and max |diff| / max |b| of two logit tensors, within
    ``tol`` (one bound for both, or a pair: L2, max); both finite."""
    tol_l2, tol_max = tol if isinstance(tol, tuple) else (tol, tol)
    check(bool(torch.isfinite(a).all() and torch.isfinite(b).all()),
          f"{what}: non-finite logits")
    rel, rmax = rel_l2(a, b), rel_max(a, b)
    agree = (a[:, -1].argmax(-1) == b[:, -1].argmax(-1)).sum().item()
    print(f"{what}: rel L2 {rel!r} (tol {tol_l2!r}), max |diff| / max "
          f"|logit| {rmax!r} (tol {tol_max!r}), max |logit| "
          f"{b.abs().max().item()!r}, argmax agrees on {agree}/{a.shape[0]}")
    check(rel <= tol_l2 and rmax <= tol_max, what)


def build_model(name: str):
    cfg = get_arch(name)
    t0 = time.perf_counter()
    api = ModelAPI(cfg, device=CUDA)
    api.model.init(torch.Generator(device=CUDA).manual_seed(0))
    sync()
    n = sum(p.numel() for p in api.model.parameters())
    print(f"serve: {cfg.name} {len(api.model.blocks)} sub-blocks "
          f"{api.model.kinds} x {api.model.groups}, d_model {cfg.d_model}, "
          f"{n} parameters in float32 on {api.device}, drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s; device memory allocated "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    return cfg, api


def layout(model) -> str:
    """The layers of a DecoderLM (sub-blocks by kind and group) or of an
    EncDecLM (encoder and decoder layers)."""
    if hasattr(model, "enc_blocks"):
        return (f"{len(model.enc_blocks)} encoder + {len(model.dec_blocks)}"
                " decoder layers")
    return (f"{len(model.blocks)} sub-blocks {model.kinds} x "
            f"{model.groups}")


def prompts(rng, cfg, n: int, lo: int, hi: int, max_new: int) -> list:
    return [Request(prompt=rng.integers(1, cfg.vocab, size=int(
        rng.integers(lo, hi + 1))).astype(np.int32), max_new=max_new)
        for _ in range(n)]


def attn_inputs(seed, B, S, T, H, KV, hd, dtype):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda").to(dtype)
            for shape in ((B, S, H, hd), (B, T, KV, hd), (B, T, KV, hd))]


def phase_device():
    print(f"device: {smi_line()}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


KERNEL_SOURCES = ("flash_attention", "wkv6", "rglru_scan", "splitmix64",
                  "sentinel_gather", "segreduce", "take_gather")


def phase_build() -> dict:
    secs = build.build_all(KERNEL_SOURCES)
    for name, t in secs.items():
        digest = hashlib.sha256(
            (build.CSRC / f"{name}.cu").read_bytes()).hexdigest()
        print(f"built {name} (nvcc, sm_90a) and loaded it in {t:.1f} s; "
              f"source sha256 {digest[:16]}")
    return {"flash_attention": instantiations(
                "flash_attention", "flash_fwd_bf16_kernel", "hd",
                flash_attention.SUPPORTED_HD),
            "wkv6": instantiations("wkv6", "wkv6_chunk_bf16_kernel", "N",
                                   wkv6.SUPPORTED_N),
            "segreduce": dict(ptxas=segreduce_ptxas())}


def segreduce_ptxas() -> list:
    """What ptxas reported for the kernels of segreduce.cu: each one's
    registers, static shared memory and spills printed, and returned for
    the 8-byte-value instantiations (the star query's); fails on a
    spill."""
    rows = []
    for k in build.ptxas_usage("segreduce"):
        name = re.search(r"\d+([a-z_]+_kernel)", k["kernel"]).group(1)
        args = re.findall(r"L[ib](\d+)E", k["kernel"].split(name, 1)[1])
        k = dict(k, kernel=f"{name}<{','.join(args)}>")
        print(f"segreduce ptxas: {k['kernel']}: {k['registers']} registers, "
              f"{k['smem']} bytes static shared memory, {k['spill_stores']} "
              f"/ {k['spill_loads']} bytes spill stores / loads, "
              f"{k['stack']} bytes stack")
        check(k["spill_stores"] == 0 and k["spill_loads"] == 0,
              f"segreduce {k['kernel']} spills")
        if args[:1] == ["8"]:
            rows.append(k)
    return rows


def tensor_core_counts(lib, bf16_kernel: str, dim: str) -> dict:
    """HMMA and HGMMA instructions in each kernel of the built library
    ``lib`` (``cuobjdump -sass``), by its dtype (``bf16_kernel`` names the
    bf16 kernel) and its template size ``dim``: {"bfloat16 hd 64": n,
    ...}."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            size = re.search(r"Li(\d+)EE", m.group(1))
            kind = "bfloat16" if bf16_kernel in m.group(1) else "float32"
            cur = f"{kind} {dim} {size.group(1) if size else '?'}"
            counts.setdefault(cur, 0)
        elif cur is not None and re.search(r"\b(HMMA|HGMMA)\b", line):
            counts[cur] += 1
    return counts


def instantiations(name: str, bf16_kernel: str, dim: str, sizes) -> dict:
    """Tensor-core instructions in the built library of ``name``, and
    what the card reports for each instantiation (``build.kernel_attrs``);
    fails if a bf16 one has no tensor-core instruction."""
    counts = tensor_core_counts(build.library_path(name), bf16_kernel, dim)
    print(f"{name} tensor-core instructions (HMMA/HGMMA in SASS): {counts}")
    insts = []
    for dtype in (torch.bfloat16, torch.float32):
        for size in sizes:
            label = f"{str(dtype)[6:]} {dim} {size}"
            attrs = build.kernel_attrs(name, dtype == torch.bfloat16, size)
            n = counts.get(label, 0)
            insts.append(dict(dtype=str(dtype)[6:], **{dim: size},
                              tensor_core_instructions=n, **attrs))
            print(f"{name} {label}: {n} tensor-core instructions, {attrs}")
            if dtype == torch.bfloat16:
                check(n > 0, f"{name} {label}: no HMMA/HGMMA instruction in "
                      "the built kernel")
    return dict(tensor_core_instructions=sum(
        i["tensor_core_instructions"] for i in insts
        if i["dtype"] == "bfloat16"), instantiations=insts)


def phase_kernel_vs_plain():
    sv = SERVE_SHAPE
    cases = [
        ("serving bf16 causal", sv, torch.bfloat16, True, 0),
        ("serving f32 causal", sv, torch.float32, True, 0),
        ("non-causal", sv, torch.bfloat16, False, 0),
        ("window 128", sv, torch.bfloat16, True, 128),
        ("MQA KV 1", dict(sv, KV=1), torch.bfloat16, True, 0),
        ("cross-length S 128 T 256",
         dict(sv, S=128, T=256), torch.bfloat16, True, 0),
        ("ragged S=T 200", dict(sv, S=200, T=200), torch.bfloat16, True, 0),
        ("hd 128", dict(sv, H=8, KV=2, hd=128), torch.bfloat16, True, 0),
        ("hd 128 f32 window 64", dict(sv, H=8, KV=2, hd=128),
         torch.float32, True, 64),
        ("hd 128 GQA 32/4 (qwen3-moe prefill)", MOE_SHAPE, torch.bfloat16,
         True, 0),
        ("hd 128 GQA 32/4 f32", MOE_SHAPE, torch.float32, True, 0),
        # the bf16 kernel's tile edges (BQ 64, BK 64 or 32 at hd 256)
        ("ragged cross S 100 T 130", dict(sv, B=2, S=100, T=130, H=4, KV=2),
         torch.bfloat16, True, 0),
        ("ragged cross non-causal window 48",
         dict(sv, B=2, S=100, T=130, H=4, KV=2, hd=16), torch.bfloat16,
         False, 48),
        ("hd 16", dict(sv, H=4, KV=2, hd=16), torch.bfloat16, True, 0),
        ("hd 32", dict(sv, H=4, KV=2, hd=32), torch.bfloat16, True, 0),
        ("hd 256 G 16", dict(sv, B=2, H=16, KV=1, hd=256), torch.bfloat16,
         True, 0),
        ("hd 256 G 16 ragged non-causal", dict(sv, B=2, S=77, T=150, H=16,
                                               KV=1, hd=256),
         torch.bfloat16, False, 0),
        ("window 128, S=T 1000 (first tile past 0)",
         dict(sv, B=1, S=1000, T=1000), torch.bfloat16, True, 128),
        ("hd 256 window 128, S=T 1000 (first tile past 0)",
         dict(sv, B=1, S=1000, T=1000, H=16, KV=1, hd=256), torch.bfloat16,
         True, 128),
        ("strided q (padded heads)", sv, torch.bfloat16, True, 0),
        ("unaligned q (padded hd)", dict(sv, B=2, S=200, T=200),
         torch.bfloat16, True, 0),
    ]
    errs = {}
    for i, (name, shp, dtype, causal, window) in enumerate(cases):
        q, k, v = attn_inputs(i, dtype=dtype, **shp)
        if name.startswith("strided q"):   # strides stay 16-byte multiples
            q = F.pad(q, (0, 0, 0, 1))[:, :, :shp["H"]]
        elif name.startswith("unaligned q"):   # strides of hd + 4 elements
            q = F.pad(q, (0, 4))[..., :shp["hd"]]
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
        want = ref.attention_ref(q, k, v, causal=causal, window=window)
        sync()
        err = (out.float() - want.float()).abs().max().item()
        tol = TOL[dtype]
        ok = bool(torch.isfinite(out).all()) and out.shape == want.shape \
            and torch.allclose(out.float(), want.float(), rtol=tol, atol=tol)
        print(f"kernel vs plain [{name}] {tuple(q.shape)} "
              f"{str(dtype)[6:]}: max_abs_err {err!r} (tol {tol}) "
              f"{'ok' if ok else 'MISMATCH'}")
        check(ok, f"flash_attention vs attention_ref [{name}]")
        errs[name] = err
    return errs["serving bf16 causal"], \
        errs["hd 128 GQA 32/4 (qwen3-moe prefill)"]


def phase_times(sv=SERVE_SHAPE, causal: bool = True):
    """Flash at a served prefill shape (smollm-135m's by default): kernel,
    plain version and sdpa from CUDA-graph replays, beside the bound."""
    q, k, v = attn_inputs(100, dtype=torch.bfloat16, **sv)
    B, S, T, H, KV, hd = (sv[n] for n in ("B", "S", "T", "H", "KV", "hd"))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              enable_gqa=True)

    def plain():
        return ref.attention_ref(q, k, v, causal=causal)

    def kernel():
        return ops.flash_attention(q, k, v, causal=causal)
    lib_err = (library().transpose(1, 2).float()
               - plain().float()).abs().max().item()
    # plain, kernel, kernel, plain: drift on the card falls on both sides
    plain_t = time_ms(plain)
    kern = time_ms(kernel)
    kern += time_ms(kernel)
    plain_t += time_ms(plain)
    lib = time_ms(library)
    nbytes = sum(x.numel() * x.element_size() for x in (q, k, v, q))
    # causal: half the pairs
    flops = 4 * B * H * S * T * hd * (0.5 if causal else 1.0)
    bound_ms, bound_by = bound(nbytes, flops, BF16_FLOP_PER_S)
    ms, plain_ms, lib_ms = (statistics.median(t)
                            for t in (kern, plain_t, lib))
    kind = "causal" if causal else "non-causal"
    print(f"times at {tuple(q.shape)} bf16 {kind}, ms per call: kernel "
          f"{spread(kern)}, plain {spread(plain_t)}, library (sdpa) "
          f"{spread(lib)} (max_abs_err vs plain {lib_err!r}); bound "
          f"{bound_ms!r} ms by {bound_by} ({nbytes} bytes, {flops:.0f} "
          f"flop); kernel at {bound_ms / ms:.4f} of the bound [{smi_line()}]")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib_ms)


def plain_attend(q, k, v, cfg, causal, window, mode):
    return attention.chunked_attention(q, k, v, causal=causal, window=window)


def phase_serve():
    cfg, api = build_model("smollm-135m")
    batch, max_seq, max_new, n_rounds = 8, 1024, 32, 2
    rng = np.random.default_rng(0)
    rounds = [prompts(rng, cfg, batch, 256, 512, max_new)
              for _ in range(n_rounds)]
    engine = ServeEngine(api, batch=batch, max_seq=max_seq)
    ops.reset_launch_counts()
    outs = run_rounds(engine, rounds, cfg.name)
    launches = dict(ops.launch_counts)
    print(f"launch counts over {n_rounds} prefills: {launches}")
    check(launches["flash_attention"] == cfg.n_layers * n_rounds,
          f"flash_attention launches {launches} != "
          f"{cfg.n_layers} x {n_rounds} prefills")
    check_tokens(outs, n_rounds * batch * max_new, cfg.vocab, cfg.name)

    # the first round's prefill again: through the kernel and with attention
    # forced to the model's plain path, in bf16 and with float32 compute
    padded = torch.from_numpy(pad_prompts(rounds[0], batch)).to(CUDA)
    for dtype in (torch.bfloat16, torch.float32):
        with compute_dtype(api, dtype):
            logits, caches = api.prefill({"tokens": padded}, engine.shape)
            with mock.patch.object(attention, "_attend", plain_attend):
                plain_logits, _ = api.prefill({"tokens": padded},
                                              engine.shape)
            step_logits, _ = api.serve_step(
                {"tokens": logits[:, -1].argmax(-1).to(torch.int32)[:, None],
                 "positions": torch.full((batch, 1), padded.shape[1],
                                         dtype=torch.int32, device=CUDA)},
                caches)
        sync()
        check(bool(torch.isfinite(step_logits.float()).all()),
              "non-finite decode logits")
        compare_logits(logits, plain_logits, LOGIT_TOL[dtype],
                       f"round 0 prefill logits, {str(dtype)[6:]} compute, "
                       "kernel vs chunked_attention")
        if dtype == torch.bfloat16:
            check(logits[:, -1].argmax(-1).tolist() == [o[0] for o in outs[0]],
                  "the recomputed prefill does not give the served first "
                  "tokens")
    phase_profile(engine, rounds[1])
    return launches


def phase_profile(engine, reqs):
    """Device busy share over one warm round (prefill + decode)."""
    profile_run(lambda: engine.run_batch(reqs), "one warm round")


# the hand-written kernels a served model launches, as the profiler names them
OWN_KERNEL_RE = re.compile(r"\b(flash_fwd_kernel|flash_fwd_bf16_kernel"
                           r"|wkv6_kernel|wkv6_chunk_bf16_kernel"
                           r"|rglru_scan_kernel)\b")


def profile_run(fn, label: str, top: int = 6) -> dict:
    """Run ``fn`` once under torch.profiler and print the device's busy
    share of the wall time (union of CUDA kernel and copy intervals), the
    part of it spent copying, the largest entries by device time, and the
    time and busy share of each of the port's model kernels.  Only the
    device's activity is traced: nothing here reads the host's, and
    tracing it added about 20 s to each profiled serving round of a few
    hundred thousand host ops and raised its idle share (internvl2-26b's
    warm round 0.5161 with the host traced, 0.3817 without, on the H100).
    The profiler still adds some host time, so the idle share it gives is
    an upper bound."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print(f"profile of {label}: the profiler recorded no CUDA event: "
              "device busy share not measured")
        return {}
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, float("-inf")
    for s0, s1 in spans:                   # union of device intervals
        if s1 > end:
            busy += s1 - max(s0, end)
            end = s1
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    copy_us = sum(us for name, us in by_name.items()
                  if name.startswith(("Memcpy", "Memset")))
    print(f"profile of {label}: wall {wall_us / 1e3:.2f} ms, device busy "
          f"{busy / 1e3:.2f} ms ({busy / wall_us:.4f} of wall, idle "
          f"{1 - busy / wall_us:.4f}), of which copies and sets "
          f"{copy_us / 1e3:.2f} ms; {len(kernels)} device events")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {us / 1e3:9.3f} ms  {us / busy:.4f} of busy  {name[:90]}")
    own = {}
    for e in kernels:
        m = OWN_KERNEL_RE.search(e.name)
        if m:
            us, n = own.get(m.group(1), (0.0, 0))
            own[m.group(1)] = (us + e.time_range.elapsed_us(), n + 1)
    if own:
        print("  the port's model kernels in it: " + "; ".join(
            f"{name} {us / 1e3:.3f} ms ({us / busy:.4f} of busy, {n} "
            f"launches)" for name, (us, n) in sorted(own.items())))
    return dict(wall_ms=wall_us / 1e3, busy_ms=busy / 1e3,
                copy_ms=copy_us / 1e3)


# --------------------------------------------------------------------------
# relational kernels and the star query at TPC-H scale factor 10
# --------------------------------------------------------------------------

# TPC-H v3.0.1: ORDERS has SF x 1,500,000 rows, CUSTOMER SF x 150,000
# (clause 4.2.5); the 25 names of NATION (clause 4.2.3)
SF = 10
N_ORDERS, N_CUST = SF * 1_500_000, SF * 150_000
NATIONS = ("ALGERIA", "ARGENTINA", "BRAZIL", "CANADA", "EGYPT", "ETHIOPIA",
           "FRANCE", "GERMANY", "INDIA", "INDONESIA", "IRAN", "IRAQ",
           "JAPAN", "JORDAN", "KENYA", "MOROCCO", "MOZAMBIQUE", "PERU",
           "CHINA", "ROMANIA", "SAUDI ARABIA", "VIETNAM", "RUSSIA",
           "UNITED KINGDOM", "UNITED STATES")
AGGS = {"total": ("amount", "sum"), "lo": ("amount", "min"),
        "hi": ("amount", "max"), "n": ("amount", "count")}
# launches of each relational kernel in one join + group-by
PER_QUERY = {"hash_fixed": 2, "combine_hashes": 2, "filter_join_gather": 2,
             "segreduce": 1}
REL_SOURCES = {"hash_fixed": ("splitmix64.cu", 132),
               "combine_hashes": ("splitmix64.cu", 157),
               "filter_join_gather": ("sentinel_gather.cu", 231),
               "segreduce": ("segreduce.cu", 288)}

FIXED = [np.int8, np.int16, np.int32, np.int64, np.uint8, np.uint16,
         np.uint32, np.uint64, np.float16, np.float32, np.float64, np.bool_]
INTS = [d for d in FIXED if np.dtype(d).kind in "iub"]
CUDA = torch.device("cuda")


def fixed_array(rng, n, dtype):
    """Values of ``dtype`` over its whole bit range; floats mix in -0.0,
    +0.0, infinities and NaNs of two payloads."""
    dt = np.dtype(dtype)
    if dt.kind == "b":
        return rng.random(n) < 0.5
    if dt.kind == "f":
        a = rng.standard_normal(n).astype(dt)
        specials = np.array([-0.0, 0.0, np.inf, -np.inf, np.nan], dt)
        pick = rng.random(n) < 0.3
        a[pick] = specials[rng.integers(0, 5, int(pick.sum()))]
        nan2 = np.array([np.nan], dt).view(f"u{dt.itemsize}") | 1
        a.view(f"u{dt.itemsize}")[rng.random(n) < 0.05] = nan2
        return a
    return rng.integers(0, 256, n * dt.itemsize, dtype=np.uint8).view(dt)


def dev(a) -> torch.Tensor:
    """A numpy array on the card, as ``core.kdispatch`` moves it."""
    return kdispatch._to_tensor(np.asarray(a), CUDA)


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int8 if t.dtype == torch.bool
                  else ref.SIGNED[t.element_size()])


def bit_err(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """The largest difference of the bits of ``got`` and ``want`` read as
    signed integers (over the first 1000 elements that differ); fails
    unless the dtypes, the shapes and all bits are the same."""
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{what}: {got.dtype} {tuple(got.shape)} vs {want.dtype} "
          f"{tuple(want.shape)}")
    a, b = bits(got).to(torch.int64), bits(want).to(torch.int64)
    bad = (a != b).nonzero().flatten()
    d = max((abs(int(x) - int(y)) for x, y in
             zip(a[bad[:1000]].tolist(), b[bad[:1000]].tolist())), default=0)
    if bad.numel():
        print(f"{what}: {bad.numel()} elements differ, max |diff| {d}")
    check(bad.numel() == 0, f"{what}: kernel and plain version differ")
    return float(d)


def segments(rng, n, n_groups):
    """(order, starts) of ``vkernels.group_ranges`` over random codes."""
    if n == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    return vkernels.group_ranges([rng.integers(0, n_groups, n)])


HOWS = ("count", "sum", "min", "max")
SUBSETS = [h for r in range(1, 5) for h in itertools.combinations(HOWS, r)]
# the most groups each path of csrc/segreduce.cu takes
PATH_GROUPS = {"private": relational.PRIVATE_MAX_GROUPS,
               "runs": float("inf")}
REDUCERS = {"count": lambda v, o, s, m: ops.grouped_count(o, s, m),
            "sum": ops.grouped_sum, "min": ops.grouped_min,
            "max": ops.grouped_max}


def segreduce_vs_plain(err, vals, order, starts, valid, what: str) -> None:
    """Every op set on every path that takes these groups (through the
    binding), the fused wrapper and the one-op wrappers, each against
    ``segreduce_many_ref`` on the same tensors, bit for bit."""
    n, G = order.numel(), starts.numel()
    want, counts = ref.segreduce_many_ref(HOWS, vals, order, starts, valid)
    for path, most in PATH_GROUPS.items():
        if G > most:
            continue
        for hows in SUBSETS:
            words, cnt, twice = relational.segreduce_cuda(
                path, hows, None if hows == ("count",) else vals,
                None if hows == ("count",) and valid is None else order,
                starts, valid, n)
            case = f"{what} {path} {'+'.join(hows)}"
            check(twice is None or twice.item() == 0,
                  f"{case}: a permutation flagged as none")
            for h, w in words.items():
                err("segreduce", w, want[h], case)
            err("segreduce", cnt, counts, case + " counts")
    got, got_counts = ops.grouped_reduce(vals, order, starts, valid, HOWS)
    for h in HOWS[1:]:
        err("segreduce", got[h], plain_result(h, want[h], vals),
            f"{what} grouped_reduce {h}")
    err("segreduce", got_counts, counts, f"{what} grouped_reduce counts")
    for h, fn in REDUCERS.items():
        res, c = fn(vals, order, starts, valid)
        err("segreduce", res, counts if h == "count"
            else plain_result(h, want[h], vals), f"{what} grouped_{h}")
        err("segreduce", c, counts, f"{what} grouped_{h} counts")


def plain_result(how, words, vals):
    """The plain version's 64-bit words as the wrappers return them."""
    if how == "sum":
        return words.view(torch.uint64) if vals.dtype == torch.uint64 \
            else words
    return ops._narrow(words, ops._extreme_dtype(vals))


def duplicated_order_raises(rng) -> int:
    """An ``order`` that names a row twice: the few-groups path flags it,
    and the wrapper raises ``ValueError`` where it takes that path; the
    sorted-run pass keeps the reference's result, as the CPU does.
    Returns the cases checked."""
    cases = 0
    for G in (26, 200):
        order, starts = segments(rng, 100_003, G)
        order = order.copy()
        order[5] = order[77_777]
        vals, order, starts = dev(rng.integers(-99, 99, 100_003)), \
            dev(order), dev(starts)
        if G <= PATH_GROUPS["private"]:
            _, _, twice = relational.segreduce_cuda(
                "private", HOWS, vals, order, starts, None, 100_003)
            check(twice.item() == 1, f"G={G} private: not flagged")
            cases += 1
        want, counts = ref.segreduce_many_ref(HOWS, vals, order, starts,
                                              None)
        path = relational.segreduce_path(G)
        if path != "runs":
            try:
                ops.grouped_reduce(vals, order, starts, None, HOWS)
                check(False, f"G={G}: a duplicated order did not raise")
            except ValueError as e:
                print(f"duplicated order, G={G} ({path}): raised {e}")
        words, cnt, _ = relational.segreduce_cuda(
            "runs", HOWS, vals, order, starts, None, 100_003)
        check(all(torch.equal(words[h], want[h]) for h in HOWS[1:])
              and torch.equal(cnt, counts),
              f"G={G}: the sorted-run pass differs from plain on a "
              "duplicated order")
        cases += 1
    return cases


def phase_relational_vs_plain() -> dict:
    """Every relational wrapper on CUDA tensors against its plain version
    on the same tensors, bit for bit."""
    rng = np.random.default_rng(0)
    cases = {k: 0 for k in PER_QUERY}
    errs = {k: 0.0 for k in PER_QUERY}

    def err(name, got, want, what):
        errs[name] = max(errs[name], bit_err(got, want, what))
        cases[name] += 1
    sizes = (0, 1, 2048 + 3, 1_000_003)      # off the block and tile sizes
    for dtype in FIXED:
        for n in sizes + (N_ORDERS,) * (dtype is np.int64):
            x = dev(fixed_array(rng, n, dtype))
            err("hash_fixed", ops.hash_fixed(x), ref.hash_fixed_ref(x),
                f"hash_fixed {np.dtype(dtype).name} n={n}")
    for mix_first in (False, True):
        for ncols in (0, 1, 3):
            for n in sizes + (N_ORDERS,) * (ncols == 1):
                c = dev(rng.integers(-(1 << 63), (1 << 63) - 1, (ncols, n),
                                     dtype=np.int64))
                err("combine_hashes", ops.combine_hashes(c, mix_first),
                    ref.combine_ref(c, mix_first),
                    f"combine_hashes ncols={ncols} n={n} "
                    f"mix_first={mix_first}")
    for dtype in FIXED:
        for nsrc in (0, 1, 2048 + 3, 1_000_003):
            src = dev(fixed_array(rng, nsrc, dtype))
            for m in (0, 1, 2048 + 3, 1_000_003):
                idx = dev(rng.integers(-1, nsrc, m) if nsrc
                          else np.full(m, -1, np.int64))
                fill = float("nan") if np.dtype(dtype).kind == "f" else 1
                err("filter_join_gather", ops.gather_payload(src, idx, fill),
                    ref.sentinel_gather_ref(
                        src, idx, ops._fill_word(fill, src.dtype)),
                    f"gather_payload {np.dtype(dtype).name} "
                    f"nsrc={nsrc} m={m}")
    sel = dev(np.arange(N_ORDERS, dtype=np.int64))
    idx = dev(rng.integers(-1, N_ORDERS, N_ORDERS))
    err("filter_join_gather", ops.filter_join_gather(sel, idx),
        ref.sentinel_gather_ref(sel, idx, -1),
        f"filter_join_gather m={N_ORDERS}")
    # the few-groups paths on both sides of their thresholds (32, 255),
    # the sorted-run pass past them, and the star query's group-by
    shapes = ((1, 1), (2048 + 3, 1), (100_003, 32), (100_003, 33),
              (100_003, 254), (100_003, 255), (100_003, 256),
              (1_000_003, 26), (3_000_000, 1_500_000))
    for dtype in INTS:
        for n, n_groups in shapes + ((N_ORDERS, 26),) * (dtype is np.int64):
            order, starts = segments(rng, n, n_groups)
            if n_groups == 1_500_000:
                check(len(starts) > 1_200_000, "too few groups drawn")
            elif n_groups < 1000:
                check(len(starts) == n_groups, "a group drawn empty")
            vals = dev(fixed_array(rng, n, dtype))
            order, starts = dev(order), dev(starts)
            for valid in (None, dev(rng.random(n) < 0.7)):
                segreduce_vs_plain(
                    err, vals, order, starts, valid,
                    f"{np.dtype(dtype).name} n={n} groups={n_groups} "
                    f"nulls={valid is not None}")
    empty = dev(np.empty(0, np.int64))
    for op, fn in REDUCERS.items():      # no group: nothing to launch
        res = fn(empty, empty, empty, None)
        check(res[0].numel() == 0 and res[1].numel() == 0,
              f"grouped_{op} of no group")
    cases["segreduce"] += duplicated_order_raises(rng)
    # uint64 and int64 sums that wrap
    for dtype, v, want in ((np.uint64, [2 ** 64 - 1, 2, 2 ** 63, 2 ** 63, 5],
                            [1, 5]),
                           (np.int64, [2 ** 62 + 1] * 4 + [-5], [4, -5])):
        vals = dev(np.array(v, dtype=dtype))
        order, starts = dev(np.arange(5)), dev(np.array([0, 4]))
        got = ops.grouped_sum(vals, order, starts)[0]
        err("segreduce", got, plain_result(
            "sum", ref.segreduce_ref("sum", vals, order, starts, None)[0],
            vals), f"{dtype.__name__} wrap")
        check(bits(got).tolist() == want, f"{dtype.__name__} sum {got}")
    sync()
    print(f"relational kernels vs plain versions, bit for bit: {cases} "
          f"comparisons, all identical (max |bit diff| {errs})")
    return errs


def h2d_d2h_ms(arrays_in, n_out_bytes_of, reps=3) -> float:
    """Host clock of one call's edge copies: the input arrays to the card
    and outputs of the given sizes (bytes) back, median of ``reps``."""
    outs = [torch.empty(b, dtype=torch.uint8, device=CUDA)
            for b in n_out_bytes_of]
    times = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        for a in arrays_in:
            dev(a)
        for o in outs:
            o.cpu()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def median_ms(fn) -> float:
    return statistics.median(time_ms(fn, iters=5, reps=5))


def phase_relational_times() -> dict:
    """Per query, at the SF10 shapes of the left-join star query: the
    kernel's launches (through its binding), the plain versions, one
    PyTorch call for the same function where there is one, the bound and
    the edge copies; each kernel's numbers summed over its launches in
    one query."""
    rng = np.random.default_rng(1)
    cust = rng.integers(0, N_CUST * 11 // 10, N_ORDERS)
    hit = cust < N_CUST
    pidx = np.arange(N_ORDERS, dtype=np.int64)       # every left key valid
    bidx = np.arange(N_CUST, dtype=np.int64)
    pi = np.nonzero(hit)[0]                          # probe-major pairs
    bi = cust[hit]
    sides = [(cust, "orders"), (bidx, "customers")]
    res = {}

    # hash_fixed: the two sides' int64 keys
    xs = [dev(a) for a, _ in sides]
    res["hash_fixed"] = dict(
        ms=sum(median_ms(lambda x=x: relational.hash_fixed_cuda(x))
               for x in xs),
        plain_ms=sum(median_ms(lambda x=x: ref.hash_fixed_ref(x))
                     for x in xs),
        library_ms=None,
        bytes=sum(16 * x.numel() for x in xs),
        edge_ms=sum(h2d_d2h_ms([a], [8 * len(a)]) for a, _ in sides))
    # combine_hashes: one key column per side
    cs = [ops.hash_fixed(x)[None] for x in xs]
    res["combine_hashes"] = dict(
        ms=sum(median_ms(lambda c=c: relational.combine_cuda(c, False))
               for c in cs),
        plain_ms=sum(median_ms(lambda c=c: ref.combine_ref(c)) for c in cs),
        library_ms=None,
        bytes=sum(16 * c.numel() for c in cs),
        edge_ms=sum(h2d_d2h_ms([a], [8 * len(a)]) for a, _ in sides))
    # filter_join_gather: left (sorted) and right (random) gathers
    gs = [(dev(pidx), dev(pi)), (dev(bidx), dev(bi))]

    def library_gather(src, idx):
        return torch.where(idx >= 0, src[idx.clamp(min=0)], -1)
    res["filter_join_gather"] = dict(
        ms=sum(median_ms(lambda s=s, i=i: relational.sentinel_gather_cuda(
            s, i, (1 << 64) - 1)) for s, i in gs),
        plain_ms=sum(median_ms(lambda s=s, i=i: ref.sentinel_gather_ref(
            s, i, -1)) for s, i in gs),
        library_ms=sum(median_ms(lambda s=s, i=i: library_gather(s, i))
                       for s, i in gs),
        bytes=sum(8 * (s.numel() + 2 * i.numel()) for s, i in gs),
        edge_ms=sum(h2d_d2h_ms([s, i], [8 * len(i)])
                    for s, i in ((pidx, pi), (bidx, bi))))
    # segreduce: the group-by of the left join: 15M rows, 26 groups
    # (25 nations and the null group of the misses), amount never null
    res["segreduce"] = segreduce_times(
        cust, np.where(hit, cust % 25, 25),
        rng.integers(0, 1_000_000, N_ORDERS))
    smi = smi_line()
    for name, r in res.items():
        r["bound_ms"] = r.pop("bytes") / HBM_BYTES_PER_S * 1e3
        r["bound_by"] = "bytes"
        print(f"times per left-join query at SF10 ({PER_QUERY[name]} "
              f"launches), {name}: kernel {r['ms']!r} ms, plain "
              f"{r['plain_ms']!r} ms, library {r['library_ms']!r} ms, "
              f"bound {r['bound_ms']!r} ms by bytes, host<->card copies at "
              f"the kdispatch edge {r['edge_ms']!r} ms [{smi}]")
    return res


def segreduce_times(cust, codes, amount) -> dict:
    """The left join's group-by at SF10 (n = 15M, G = 26, int64 amount, no
    nulls): count, sum, min and max in one call on each path (the wrapper
    picks ``private``), the same as four one-op calls, the plain version,
    and four PyTorch calls (``index_add_``, ``scatter_reduce_``); then the
    many-groups shape (the orders grouped by ``cust``, about 1.65 M
    groups) on the sorted-run pass, in one call and as four one-op calls;
    and every path at G = 1, 32 and 33 groups of random rows (the limit
    of the few-groups path).  The SF10 kernel cells are
    timed twice each, in turns (forward, then backward), all in this call.
    Bounds: ``order`` and the values read once, ``starts`` read and four
    results written once, 16 n + 40 G bytes."""
    order_np, starts_np = vkernels.group_ranges([codes])
    m_order_np, m_starts_np = vkernels.group_ranges([cust])
    vals, order, starts, gid = (dev(a) for a in (amount, order_np, starts_np,
                                                 codes))
    m_order, m_starts = dev(m_order_np), dev(m_starts_np)
    n, G, Gm = N_ORDERS, len(starts_np), len(m_starts_np)
    path = relational.segreduce_path(G)

    def fused(p, o=order, st=starts):
        return lambda: relational.segreduce_cuda(p, HOWS, vals, o, st, None,
                                                 n)

    def one_op(p, o, st):
        def run():
            relational.segreduce_cuda(p, ("count",), None, None, st, None, n)
            for h in HOWS[1:]:
                relational.segreduce_cuda(p, (h,), vals, o, st, None, n)
        return run
    cells = {"private": fused("private"), "runs": fused("runs"),
             "one_op": one_op(path, order, starts),
             "many_runs": fused("runs", m_order, m_starts),
             "many_one_op": one_op("runs", m_order, m_starts)}
    times = {k: [] for k in cells}
    for names in (list(cells), list(cells)[::-1]):
        for k in names:
            times[k].append(statistics.median(time_ms(cells[k], iters=5,
                                                      reps=5)))
    ms = {k: statistics.median(t) for k, t in times.items()}
    # every path that takes G, across the limit of the few-groups path, at
    # the same n over G groups of random rows
    sweep, rng = {}, np.random.default_rng(2)
    for g in (1, 32, 33):
        o_np, s_np = vkernels.group_ranges([rng.integers(0, g, n)])
        o, st = dev(o_np), dev(s_np)
        sweep[g] = {p: median_ms(fused(p, o, st))
                    for p, most in PATH_GROUPS.items() if g <= most}
        print(f"segreduce at n={n} G={g}, count+sum+min+max in one call, "
              f"ms by path: {sweep[g]}")
        del o, st
    lo, hi = -(1 << 63), (1 << 63) - 1
    ones = torch.ones(n, dtype=torch.int64, device=CUDA)
    library = (
        lambda: torch.zeros(G, dtype=torch.int64, device=CUDA)
        .index_add_(0, gid, ones),
        lambda: torch.zeros(G, dtype=torch.int64, device=CUDA)
        .index_add_(0, gid, vals),
        lambda: torch.full((G,), hi, dtype=torch.int64, device=CUDA)
        .scatter_reduce_(0, gid, vals, "amin"),
        lambda: torch.full((G,), lo, dtype=torch.int64, device=CUDA)
        .scatter_reduce_(0, gid, vals, "amax"))
    out = dict(
        ms=ms[path], path=path,
        plain_ms=median_ms(lambda: ref.segreduce_many_ref(
            HOWS, vals, order, starts, None)),
        library_ms=sum(median_ms(f) for f in library),
        bytes=16 * n + 40 * G,
        edge_ms=h2d_d2h_ms([order_np, starts_np, amount], [8 * G] * 4),
        paths={p: ms[p] for p in PATH_GROUPS},
        paths_by_groups=sweep,
        one_op_calls_ms=ms["one_op"], runs_of_each_cell=times,
        many_groups=dict(groups=Gm, runs_ms=ms["many_runs"],
                         one_op_calls_ms=ms["many_one_op"],
                         bound_ms=(16 * n + 40 * Gm) / HBM_BYTES_PER_S * 1e3))
    print(f"segreduce at n={n} G={G}, count+sum+min+max in one call, ms "
          f"(two turns' medians of 5 replays of 5 calls): private "
          f"{times['private']}, runs {times['runs']}; four one-op calls "
          f"({path}) {times['one_op']}; "
          f"plain {out['plain_ms']!r}; library (4 calls) "
          f"{out['library_ms']!r}; edge copies {out['edge_ms']!r}")
    print(f"segreduce at the many-groups shape (n={n}, G={Gm}, the orders "
          f"grouped by cust): runs {times['many_runs']}, four one-op calls "
          f"{times['many_one_op']}, bound "
          f"{out['many_groups']['bound_ms']!r} ms")
    return out


def star_tables(seed: int = 0):
    """ORDERS (cust uniform over 110 % of the customer ids, so about 9 %
    of the orders miss; amount in integer cents) and CUSTOMER (cust an
    arange, country a utf8 nation name) at SF10, from a seed."""
    rng = np.random.default_rng(seed)
    orders = Table.from_pydict({
        "cust": rng.integers(0, N_CUST * 11 // 10, N_ORDERS),
        "amount": rng.integers(0, 1_000_000, N_ORDERS)})
    names = Column.from_strings(NATIONS)
    off, vals = vkernels.take_var(names.offsets, names.values,
                                  np.arange(N_CUST) % len(NATIONS))
    customers = Table.from_pydict({
        "cust": np.arange(N_CUST, dtype=np.int64),
        "country": Column.utf8(off, vals)})
    return orders, customers


def star_left(orders, customers):
    j = rops.join(orders, customers, "cust", how="left")
    return j, rops.group_by(j, "country", AGGS)


def star_filtered(orders, customers):
    amount = orders.combine().batches[0].column("amount").values
    j = rops.filter_join(orders, customers, "cust", how="inner",
                         left_mask=amount >= 500_000)
    return j, rops.group_by(j, "country", AGGS)


def same_buffers(a: Table, b: Table, what: str) -> None:
    """Every column's raw buffers (values, offsets, validity, dictionary)
    with the same dtypes and the same bits."""
    def bufs(c):
        out = [(c.type, c.values), (None, c.offsets), (None, c.validity)]
        return out + (bufs(c.dictionary) if c.dictionary is not None else [])
    ba, bb = a.combine().batches[0], b.combine().batches[0]
    check(ba.schema.equals(bb.schema), f"{what}: schemas differ")
    for f, ca, cb in zip(ba.schema.fields, ba.columns, bb.columns):
        for (ta, x), (tb, y) in zip(bufs(ca), bufs(cb)):
            check(ta == tb and (x is None) == (y is None)
                  and (x is None or (x.dtype == y.dtype
                                     and x.shape == y.shape
                                     and np.array_equal(x.view(np.uint8),
                                                        y.view(np.uint8)))),
                  f"{what}: column {f.name} differs between cuda and cpu")


def recount(orders, keep):
    """The group-by's answer by a numpy recount: per nation (name order,
    then the null group of the misses), total, min, max and count of the
    amounts of the orders in ``keep``."""
    b = orders.combine().batches[0]
    cust, amount = b.column("cust").values, b.column("amount").values
    nat = np.where(cust < N_CUST, cust % len(NATIONS), len(NATIONS))[keep]
    amt = amount[keep]
    rank = np.argsort(np.argsort(np.array(NATIONS, dtype=object)))
    nat = np.where(nat < len(NATIONS), rank[np.minimum(nat, 24)], nat)
    n = np.bincount(nat, minlength=26)
    total = np.bincount(nat, weights=amt, minlength=26)   # < 2**53: exact
    lo = np.full(26, np.iinfo(np.int64).max)
    hi = np.full(26, np.iinfo(np.int64).min)
    np.minimum.at(lo, nat, amt)
    np.maximum.at(hi, nat, amt)
    rows = [i for i in range(26) if n[i]]
    return {"country": [sorted(NATIONS)[i] if i < 25 else None
                        for i in rows],
            "total": [int(total[i]) for i in rows],
            "lo": [int(lo[i]) for i in rows],
            "hi": [int(hi[i]) for i in rows], "n": [int(n[i]) for i in rows]}


def star_keeps(orders) -> dict:
    """The orders each star query keeps, by query name: all of them for
    the left join; for the filtered inner join, those of 500,000 cents or
    more whose customer exists."""
    b = orders.combine().batches[0]
    amount, cust = b.column("amount").values, b.column("cust").values
    return {"left join": np.ones(N_ORDERS, bool),
            "filtered inner join": (amount >= 500_000) & (cust < N_CUST)}


def phase_star(orders, customers):
    """Both star queries at SF10 on cuda (counted) and on the port's cpu
    device; bit-identical buffers, expected launches, a numpy recount,
    and a profiled cuda run with the time spent at the kdispatch edge.
    Returns the launches and each query's group-by output on cuda."""
    keeps = star_keeps(orders)
    launches = {k: 0 for k in PER_QUERY}
    walls, group_bys = {}, {}
    for name, query in (("left join", star_left),
                        ("filtered inner join", star_filtered)):
        keep = keeps[name]
        sync()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        j, g = query(orders, customers)
        sync()
        wall_cuda = time.perf_counter() - t0
        counts = dict(ops.launch_counts)
        with kdispatch.using_device("cpu"):
            t0 = time.perf_counter()
            j_cpu, g_cpu = query(orders, customers)
            wall_cpu = time.perf_counter() - t0
        same_buffers(j, j_cpu, f"{name}: join output")
        same_buffers(g, g_cpu, f"{name}: group-by output")
        want = dict(dict.fromkeys(ops.launch_counts, 0), **PER_QUERY)
        print(f"star query, {name}: {j.num_rows} joined rows, "
              f"{g.num_rows} groups; wall cuda {wall_cuda * 1e3:.1f} ms, "
              f"cpu {wall_cpu * 1e3:.1f} ms; launches {counts}; cuda and "
              "cpu outputs bit-identical")
        check(counts == want, f"{name}: launches {counts} != {want}")
        check(g.to_pydict() == recount(orders, keep),
              f"{name}: group-by disagrees with the numpy recount")
        for k in launches:
            launches[k] += counts[k]
        walls[name] = (wall_cuda, wall_cpu)
        group_bys[name] = g
        del j, j_cpu, g_cpu

    spent = {}

    def timed(key, fn):
        def inner(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[key] = spent.get(key, 0.0) + time.perf_counter() - t
        return inner
    with mock.patch.multiple(kdispatch, **{
            k: timed(k, getattr(kdispatch, k))
            for k in ("hash_fixed", "combine_hashes", "filter_join_gather",
                      "grouped_reduce")}):
        host = cProfile.Profile()
        prof = profile_run(lambda: host.runcall(star_left, orders,
                                                customers),
                           "the left-join star query on cuda", top=10)
    edge = sum(spent.values()) * 1e3
    print(f"in that run, kdispatch calls (edge copies, validation, kernels) "
          f"{edge:.1f} ms of {prof.get('wall_ms', float('nan')):.1f} ms wall"
          f": {({k: round(v * 1e3, 1) for k, v in spent.items()})}; the "
          "rest is host numpy in core.ops, by own time (cProfile):")
    stats = pstats.Stats(host)
    top = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:12]
    for (path, line, fn), (_, _, own, cum, _) in top:
        print(f"  {own * 1e3:10.1f} ms own {cum * 1e3:10.1f} ms cumulative  "
              f"{os.path.basename(path)}:{line}:{fn}")
    return launches, group_bys



# --------------------------------------------------------------------------
# the star query through the Zerrow core: plans, the DAG executor, Flight
# --------------------------------------------------------------------------

def star_plans(po: str, pc: str) -> dict:
    """Phase 6's two star queries as plans over zarquet files of the same
    tables, by query name."""
    return {
        "left join": plan.scan(po).join(plan.scan(pc), on="cust",
                                        how="left").group_by("country", AGGS),
        "filtered inner join": plan.scan(po)
        .filter(plan.col("amount") >= 500_000)
        .join(plan.scan(pc), on="cust", how="inner")
        .group_by("country", AGGS)}


def zerrow_env(mode: str, workers: int, root: str):
    """A store, a resource manager and the executor ``mode`` selects, as a
    user of the core builds them."""
    store = BufferStore(backing="file" if mode == "process" else "ram",
                        swap_dir=os.path.join(root, f"swap-{mode}"),
                        data_dir=os.path.join(root, f"store-{mode}")
                        if mode == "process" else None)
    rm = ResourceManager(store, RMConfig(workers=workers,
                                         workers_mode=mode))
    return store, make_executor(store, rm, workers=workers)


def run_plan(ex, store, name: str, query, want: Table, keep, orders,
             what: str) -> dict:
    """Compile one plan, run its DAG with the launch counts and the edge's
    byte counts set to 0 just before and read just after, and hold its
    group-by to ``want`` (bit for bit) and to the numpy recount."""
    cp = plan.compile_plans({name: query})
    fused = any(getattr(st.spec.fn, "func", None)
                is plan_compiler.filter_join_exec
                for st in cp.dag.nodes.values())
    check(fused == (name != "left join"),
          f"{what}: filter_join fusion {fused} for {name}")
    before = store.stats.snapshot()
    sync()
    ops.reset_launch_counts()
    kdispatch.reset_edge_bytes()
    t0 = time.perf_counter()
    ex.run([cp.dag])
    sync()
    wall = time.perf_counter() - t0
    launches = dict(ops.launch_counts)
    edge = dict(kdispatch.edge_bytes)
    msg = cp.dag.nodes[cp.sinks[name]].output
    g = cp.read(store, name)
    same_buffers(g, want, f"{what}, {name}: group-by vs phase 6's")
    check(g.to_pydict() == recount(orders, keep),
          f"{what}, {name}: group-by disagrees with the numpy recount")
    msg.release()
    after = store.stats.snapshot()
    stats = {k: after[k] - before[k] for k in
             ("bytes_copied", "bytes_deanon", "bytes_reshared",
              "reshare_hits", "bytes_adopted")}
    print(f"{what}, {name}: {len(cp.dag.nodes)} nodes "
          f"{sorted(cp.dag.nodes)}; wall {wall * 1e3:.1f} ms; launches "
          f"{launches}; store {stats}; kdispatch moved {edge['to_device']} "
          f"bytes to the card and {edge['from_device']} back; group-by "
          f"bit-identical to phase 6's and to the numpy recount")
    return dict(wall_s=wall, launches=launches, store=stats, edge=edge)


def first_join_cost(ex, store, root: str) -> None:
    """A small star twice through a fresh pool: the first request pays the
    worker's CUDA context and the kernels' libraries, the second not."""
    rng = np.random.default_rng(1)
    po, pc = os.path.join(root, "small-o.zq"), os.path.join(root,
                                                            "small-c.zq")
    zarquet.write_table(po, Table.from_pydict({
        "cust": rng.integers(0, 1100, 20000),
        "amount": rng.integers(0, 1_000_000, 20000)}))
    zarquet.write_table(pc, Table.from_pydict({
        "cust": np.arange(1000, dtype=np.int64),
        "country": [NATIONS[i % 25] for i in range(1000)]}))
    walls = []
    for _ in range(2):
        cp = plan.compile_plans({"q": star_plans(po, pc)["left join"]})
        t0 = time.perf_counter()
        ex.run([cp.dag])
        walls.append(time.perf_counter() - t0)
        cp.dag.nodes[cp.sinks["q"]].output.release()
    print(f"a small star (20,000 orders) through the fresh pool: first run "
          f"{walls[0] * 1e3:.1f} ms, second {walls[1] * 1e3:.1f} ms: a "
          f"worker's first join costs about "
          f"{(walls[0] - walls[1]) * 1e3:.1f} ms more (its CUDA context "
          f"and the kernels' libraries)")


def phase_zerrow_star(orders, customers, group_bys) -> dict:
    """Phases 11 and 12: the plan-compiled star queries through the
    executor's threads, then the left one through 2 Flight workers; each
    group-by held to phase 6's output.  Returns the launches of each
    run."""
    root = tempfile.mkdtemp(prefix="zerrow-star-")
    keeps = star_keeps(orders)
    launches = {}
    try:
        t0 = time.perf_counter()
        po, pc = os.path.join(root, "orders.zq"), os.path.join(
            root, "customers.zq")
        zarquet.write_table(po, orders)
        zarquet.write_table(pc, customers)
        print(f"zerrow: orders and customers written to zarquet "
              f"({os.path.getsize(po)} and {os.path.getsize(pc)} bytes) in "
              f"{time.perf_counter() - t0:.1f} s")
        plans = star_plans(po, pc)
        # a compiled query is the hand-driven one of phase 6 as DAG nodes:
        # projection pruning drops no key and no aggregated column, so
        # each query launches what PER_QUERY says, as in phase 6
        want = dict(dict.fromkeys(ops.launch_counts, 0), **PER_QUERY)
        store, ex = zerrow_env("thread", 4, root)
        try:
            for name, query in plans.items():
                r = run_plan(ex, store, name, query, group_bys[name],
                             keeps[name], orders, "zerrow threads")
                check(r["launches"] == want,
                      f"zerrow threads, {name}: launches {r['launches']} "
                      f"!= {want}")
                launches[f"threads, {name}"] = r["launches"]
        finally:
            ex.close()
            store.close()

        store, ex = zerrow_env("process", 2, root)
        try:
            t0 = time.perf_counter()
            pool = ex._ensure_pool()
            print(f"zerrow processes: {pool.live_workers} Flight workers "
                  f"on {pool.device} spawned and warmed in "
                  f"{time.perf_counter() - t0:.1f} s")
            check(pool.device == "cuda", f"workers on {pool.device}")
            first_join_cost(ex, store, root)
            ex.worker_stats.clear()
            chains, nodes, sock = (ex.chains_shipped, ex.chain_nodes_shipped,
                                   ex.socket_bytes)
            name = "left join"
            r = run_plan(ex, store, name, plans[name], group_bys[name],
                         keeps[name], orders, "zerrow processes")
            worker = {k.split(":", 1)[1]: v for k, v in
                      ex.worker_stats.items() if k.startswith("launches:")}
            worker = dict(dict.fromkeys(ops.launch_counts, 0), **worker)
            print(f"zerrow processes: the workers launched {worker}; "
                  f"{ex.chains_shipped - chains} chains shipped "
                  f"({ex.chain_nodes_shipped - nodes} nodes), socket bytes "
                  f"{ex.socket_bytes - sock}, worker store counters "
                  f"{ {k: v for k, v in ex.worker_stats.items() if ':' not in k} }")
            check(r["launches"] == dict.fromkeys(ops.launch_counts, 0),
                  f"zerrow processes: the parent launched {r['launches']}")
            check(worker == want,
                  f"zerrow processes: the workers launched {worker} != "
                  f"{want} (a worker on the CPU launches nothing)")
            check(ex.fallback_inline == 0 and ex.worker_retries == 0,
                  f"zerrow processes: {ex.fallback_inline} nodes inline, "
                  f"{ex.worker_retries} retries")
            launches[f"processes, {name}"] = worker
        finally:
            ex.close()
            store.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


def phase_zerrow_prompts() -> dict:
    """Phase 13: smollm-135m served over ZerrowPromptSource in thread and
    in process mode, then the launcher as a user runs it."""
    cfg, api = build_model("smollm-135m")
    batch, max_seq, max_new = 8, 1024, 32
    root = tempfile.mkdtemp(prefix="zerrow-prompts-")
    flash = {}
    try:
        # 4 batches a mode: each served batch repeats phase 4's path, so
        # more batches add time and no coverage
        shards = make_prompt_shards(root, 4, 8)
        texts = [t for p in shards
                 for t in zarquet.read_table(p).to_pydict()["text"]]
        want = [(np.frombuffer(t.encode(), np.uint8).astype(np.int32)
                 + 1)[:max_seq // 2] for t in texts]
        for mode in ("thread", "process"):
            src = ZerrowPromptSource(shards, batch=batch, max_new=max_new,
                                     workers=2, workers_mode=mode,
                                     max_prompt_len=max_seq // 2)
            engine = ServeEngine(api, batch=batch, max_seq=max_seq)
            served, outs = [], []
            sync()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            try:
                for reqs in src.batches():
                    outs.append(engine.run_batch(reqs))
                    served.extend(r.prompt for r in reqs)
            finally:
                src.close()
            sync()
            wall = time.perf_counter() - t0
            launches = dict(ops.launch_counts)
            s = engine.stats
            print(f"zerrow prompts, {mode} mode: {len(served)} prompts from "
                  f"{len(shards)} shards in {len(outs)} batches, served in "
                  f"{wall:.2f} s (prefill {s['prefill_s'] * 1e3:.1f} ms, "
                  f"decode {s['decode_steps']} steps "
                  f"{s['decode_s'] * 1e3:.1f} ms); launches {launches}")
            check(len(served) == len(want) and all(
                np.array_equal(a, b) for a, b in zip(served, want)),
                f"zerrow prompts, {mode}: prompts differ from the "
                "byte-tokenized shard texts")
            check(launches == dict(dict.fromkeys(ops.launch_counts, 0),
                                   flash_attention=cfg.n_layers * len(outs)),
                  f"zerrow prompts, {mode}: launches {launches} != "
                  f"{cfg.n_layers} flash a prefill x {len(outs)}")
            check_tokens(outs, len(served) * max_new, cfg.vocab,
                         f"zerrow prompts, {mode}")
            flash[f"zerrow prompts, {mode}"] = launches["flash_attention"]
        del api
        torch.cuda.empty_cache()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        engine = serve_launcher.main([
            "--arch", "smollm-135m", "--batch", str(batch), "--max-seq",
            str(max_seq), "--max-new", str(max_new), "--prompt-shards", "4",
            "--prompts-per-shard", "32", "--workers", "2",
            "--workers-mode", "process", "--rounds", "2"])
        sync()
        launches = dict(ops.launch_counts)
        print(f"launcher with --prompt-shards 4 --workers 2 --workers-mode "
              f"process: {time.perf_counter() - t0:.1f} s; launches "
              f"{launches}")
        check(engine.stats["decode_steps"] == 2 * max_new
              and launches["flash_attention"] == 2 * cfg.n_layers,
              f"launcher: {engine.stats}, launches {launches}")
        flash["launcher, prompt shards"] = launches["flash_attention"]
        del engine
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return flash


# --------------------------------------------------------------------------
# recurrent kernels, and serving rwkv6-3b and recurrentgemma-9b
# --------------------------------------------------------------------------

# rwkv6-3b's prefill shape (B 8, prompts padded to 512, 40 heads of 64) and
# recurrentgemma-9b's (B 8, S 512, lru_width 4096; attention 16 query heads
# and 1 KV head of 256, window 2048), and its long request (B 1, S 3072)
WKV_SHAPE = dict(B=8, S=512, H=40, N=64)
LRU_SHAPE = dict(B=8, S=512, W=4096)
HD256_SHAPES = {"serving": dict(B=8, S=512, H=16, KV=1, hd=256),
                "long": dict(B=1, S=3072, H=16, KV=1, hd=256)}
WINDOW = 2048
# wkv6: f32 out and state differ from the plain version by the order of
# the sums over n (the kernel folds 64 products in 2 chains and 4 lanes,
# the plain einsum in cuBLAS's order) and by fused multiply-adds: ~1e-6
# relative, 1e-4 as in tests/test_kernels.py; a bf16 output is that value
# rounded once, so it may differ by one bf16 ulp (2^-8 relative): 2e-2.
# The bf16 kernel's chunked form (f32 operands in three bf16 parts on the
# tensor cores) keeps its state within 1.5e-5 of 1 + |S| in the plain
# twin's worst case, w near 1 over 512 tokens, and rounds no more outputs
# wrongly than the f32 oracle (tests/test_torch_wkv6_numerics.py): the
# state stays at 1e-4 in every dtype.
WKV_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# rglru_scan rounds its product and sum separately, as the plain `a * h +
# b` does, so it is held bit for bit (tolerance 0).
# decode after S tokens vs prefill of S + 1 tokens, float32 compute: the
# starting tolerance of tests/test_models_smoke.py:102
DECODE_TOL = 5e-3


def wkv_inputs(g, B, S, H, N, dtype, decay):
    """r, k, v, w, u, state on the card: w near the model's floor e^-4
    (where the decay clip puts it), near 1 (slow decay, a growing state),
    over the model's range, tiny (log-uniform in [1e-30, 1e-3], past what
    the bf16 kernel's factorised chunk takes) or mixed (the model's range
    with one token in twenty tiny, so that both forms of a chunk follow
    each other)."""
    def rnd(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=g, device=CUDA)
    r, k, v = rnd(B, S, H, N, scale=0.5), rnd(B, S, H, N, scale=0.5), \
        rnd(B, S, H, N)
    z = torch.rand(B, S, H, N, generator=g, device=CUDA)
    tiny = torch.pow(10.0, -30.0 + 27.0 * z)
    model = np.exp(-4.0) + (1.0 - np.exp(-4.0)) * z
    w = {"floor": np.exp(-4.0) * (1.0 + 0.05 * z),
         "near 1": 1.0 - 1e-3 * z,
         "model": model,
         "tiny": tiny,
         "mixed": torch.where(torch.rand(B, S, H, 1, generator=g,
                                         device=CUDA) < 0.05, tiny,
                              model)}[decay]
    return (r.to(dtype), k.to(dtype), v.to(dtype), w, rnd(H, N, scale=0.1),
            rnd(B, H, N, N, scale=0.1))


def at_offset(x, offset: int):
    """x's values in a contiguous tensor that starts ``offset`` elements
    into a flat buffer (x itself at 0)."""
    if offset == 0:
        return x
    buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    return buf[offset:].view(x.shape).copy_(x)


def phase_recurrent_vs_plain() -> dict:
    """wkv6, rglru_scan and flash attention at hd 256 with a window, each
    on CUDA tensors against its plain version on the same tensors."""
    g = torch.Generator(device=CUDA).manual_seed(7)
    errs = {"wkv6": 0.0, "rglru_scan": 0.0, "flash_hd256": 0.0}
    n = dict.fromkeys(errs, 0)
    # lengths at the edges of a chunk (16 tokens) and inside one, at every
    # N (1, 2 and 4 warps a block); then r, k, v and w one element into a
    # flat buffer (offset 1), whose bases are not 16-byte aligned
    cases = [(dict(B=2, S=S, H=3, N=N), dtype, with_state, decay, 0)
             for N in (16, 32, 64) for S in (1, 8, 9, 15, 16, 17, 33, 512)
             for dtype in (torch.bfloat16, torch.float32)
             for with_state in (True, False)
             for decay in ("floor", "near 1", "tiny", "mixed")]
    cases += [(dict(B=2, S=S, H=3, N=N), dtype, True, decay, 1)
              for N in (16, 32, 64) for S in (1, 17, 512)
              for dtype in (torch.bfloat16, torch.float32)
              for decay in ("near 1", "mixed")]
    cases += [(WKV_SHAPE, torch.bfloat16, True, "model", 0),
              (WKV_SHAPE, torch.float32, False, "model", 0)]
    for shp, dtype, with_state, decay, offset in cases:
        r, k, v, w, u, st = wkv_inputs(g, dtype=dtype, decay=decay, **shp)
        r, k, v, w = (at_offset(x, offset) for x in (r, k, v, w))
        check((r.data_ptr() % 16 == 0) == (offset == 0),
              "wkv6: the offset case's base is 16-byte aligned")
        st = st if with_state else None
        out, s_out = ops.wkv6(r, k, v, w, u, st)
        want, want_s = ref.wkv6_ref(r, k, v, w, u, st)
        sync()
        tol = WKV_TOL[dtype]
        ok = (out.dtype == dtype and s_out.shape == want_s.shape
              and bool(torch.isfinite(out).all())
              and torch.allclose(out.float(), want.float(), rtol=tol,
                                 atol=tol)
              and torch.allclose(s_out, want_s, rtol=1e-4, atol=1e-4))
        err = (out.float() - want.float()).abs().max().item()
        check(ok, f"wkv6 vs wkv6_ref {shp} {dtype} state={with_state} "
              f"decay={decay} offset={offset}: max_abs_err {err!r}, state "
              f"{(s_out - want_s).abs().max().item()!r}")
        errs["wkv6"] = max(errs["wkv6"], err)
        n["wkv6"] += 1
    for S in (1, 3, 512, 3072):
        for W in (64, 4096, 4100):
            B = 8 if (S, W) == (512, 4096) else 2
            a = torch.rand(B, S, W, generator=g, device=CUDA)
            b = torch.randn(B, S, W, generator=g, device=CUDA)
            for h0 in (torch.randn(B, W, generator=g, device=CUDA), None):
                h, h_last = ops.rglru_scan(a, b, h0)
                want, want_last = ref.rglru_ref(a, b, h0)
                sync()
                err = max((h - want).abs().max().item(),
                          (h_last - want_last).abs().max().item())
                check(torch.equal(h, want) and torch.equal(h_last, want_last),
                      f"rglru_scan vs rglru_ref B={B} S={S} W={W} "
                      f"h0={h0 is not None}: max_abs_err {err!r}")
                errs["rglru_scan"] = max(errs["rglru_scan"], err)
                n["rglru_scan"] += 1
    for label, shp in HD256_SHAPES.items():
        for dtype in (torch.bfloat16, torch.float32):
            if dtype == torch.float32:
                shp = dict(shp, B=1)
            q, k, v = attn_inputs(shp["S"], T=shp["S"], dtype=dtype, **shp)
            out = ops.flash_attention(q, k, v, causal=True, window=WINDOW)
            want = ref.attention_ref(q, k, v, causal=True, window=WINDOW)
            sync()
            err = (out.float() - want.float()).abs().max().item()
            tol = TOL[dtype]
            check(bool(torch.isfinite(out).all()) and torch.allclose(
                out.float(), want.float(), rtol=tol, atol=tol),
                f"flash_attention hd 256 window {WINDOW} [{label}] {dtype}: "
                f"max_abs_err {err!r}")
            print(f"kernel vs plain [hd 256 window {WINDOW} {label}] "
                  f"{tuple(q.shape)} {str(dtype)[6:]}: max_abs_err {err!r} "
                  f"(tol {tol}) ok")
            if dtype == torch.bfloat16:
                errs["flash_hd256"] = max(errs["flash_hd256"], err)
            n["flash_hd256"] += 1
    print(f"recurrent kernels vs plain versions: {n} cases, max_abs_err "
          f"{errs} (wkv6 tol {WKV_TOL[torch.float32]} f32 / "
          f"{WKV_TOL[torch.bfloat16]} bf16, rglru_scan bit for bit, flash "
          f"tol {TOL})")
    return errs


def timed_pair(kernel, plain, plain_iters: int = 20):
    """Device ms of the kernel and of its plain version, kernel, plain,
    plain, kernel: drift on the card falls on both sides."""
    kern = time_ms(kernel)
    pl = time_ms(plain, iters=plain_iters, reps=3)
    pl += time_ms(plain, iters=plain_iters, reps=3)
    kern += time_ms(kernel)
    return kern, pl


def phase_recurrent_times() -> dict:
    """wkv6, rglru_scan and flash at hd 256 at the serving shapes: kernel,
    plain version and (attention) sdpa from CUDA-graph replays, beside the
    bound."""
    g = torch.Generator(device=CUDA).manual_seed(8)
    smi = smi_line()
    res = {}
    B, S, H, N = (WKV_SHAPE[x] for x in "BSHN")
    r, k, v, w, u, _ = wkv_inputs(g, dtype=torch.bfloat16, decay="model",
                                  **WKV_SHAPE)
    st = torch.zeros(B, H, N, N, device=CUDA)     # prefill's zero cache
    kern, pl = timed_pair(lambda: ops.wkv6(r, k, v, w, u, st),
                          lambda: ref.wkv6_ref(r, k, v, w, u, st),
                          plain_iters=2)
    nbytes = sum(x.numel() * x.element_size()
                 for x in (r, k, v, w, u, st, r, st))   # out like r, state
    flops = 5 * N * N * B * S * H
    # the bf16 kernel's products run on the tensor cores; the float32
    # kernel's on the CUDA cores
    bound_ms, by = bound(nbytes, flops, BF16_FLOP_PER_S)
    f32_bound_ms, f32_by = bound(nbytes, flops, F32_FLOP_PER_S)
    ms = statistics.median(kern)
    # one batch row: 40 blocks, at most one an SM, so each block runs
    # alone; and the float32 kernel on the same values in float32
    one = time_ms(lambda: ops.wkv6(r[:1], k[:1], v[:1], w[:1], u, st[:1]))
    r32, k32, v32 = (x.float() for x in (r, k, v))
    f32 = time_ms(lambda: ops.wkv6(r32, k32, v32, w, u, st))
    res["wkv6"] = dict(ms=ms, plain_ms=statistics.median(pl),
                       bound_ms=bound_ms, bound_by=by, library_ms=None,
                       one_row_ms=statistics.median(one),
                       f32_ms=statistics.median(f32),
                       f32_bound_ms=f32_bound_ms)
    print(f"wkv6 at {tuple(r.shape)} bf16 (w f32, state f32), ms per call: "
          f"kernel {spread(kern)}, plain {spread(pl)}; bound {bound_ms!r} ms"
          f" by {by} ({nbytes} bytes, {flops} flop at {BF16_FLOP_PER_S:.3g}"
          f"/s on the tensor cores), kernel at {bound_ms / ms:.4f} of it; "
          f"one batch row (B 1, a block an SM) {spread(one)}; the float32 "
          f"kernel on float32 r, k, v {spread(f32)}, its bound "
          f"{f32_bound_ms!r} ms by {f32_by} (the same flop at "
          f"{F32_FLOP_PER_S:.3g}/s on the CUDA cores); no PyTorch call "
          f"computes it [{smi}]")

    B, S, W = (LRU_SHAPE[x] for x in "BSW")
    a = torch.rand(B, S, W, generator=g, device=CUDA)
    b = torch.randn(B, S, W, generator=g, device=CUDA)
    h0 = torch.zeros(B, W, device=CUDA)
    kern, pl = timed_pair(lambda: ops.rglru_scan(a, b, h0),
                          lambda: ref.rglru_ref(a, b, h0), plain_iters=2)
    nbytes = 4 * (3 * B * S * W + 2 * B * W)
    bound_ms, by = bound(nbytes, 2 * B * S * W, F32_FLOP_PER_S)
    res["rglru_scan"] = dict(ms=statistics.median(kern),
                             plain_ms=statistics.median(pl),
                             bound_ms=bound_ms, bound_by=by, library_ms=None)
    print(f"rglru_scan at {tuple(a.shape)} f32 with h0, ms per call: kernel "
          f"{spread(kern)}, plain {spread(pl)}; bound {bound_ms!r} ms by {by}"
          f" ({nbytes} bytes); no PyTorch call computes it [{smi}]")

    for label, shp in HD256_SHAPES.items():
        B, S, H, KV, hd = (shp[x] for x in ("B", "S", "H", "KV", "hd"))
        q, k, v = attn_inputs(S + 1, T=S, dtype=torch.bfloat16, **shp)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        pos = torch.arange(S, device=CUDA)
        mask = (pos[None, :] <= pos[:, None]) \
            & (pos[None, :] > pos[:, None] - WINDOW)

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)
        lib_err = (library().transpose(1, 2).float() - ref.attention_ref(
            q, k, v, window=WINDOW).float()).abs().max().item()
        kern, pl = timed_pair(
            lambda: ops.flash_attention(q, k, v, window=WINDOW),
            lambda: ref.attention_ref(q, k, v, window=WINDOW), plain_iters=5)
        lib = time_ms(library, iters=5, reps=5)
        pairs = int(mask.sum())                  # visible (query, key) pairs
        nbytes = sum(x.numel() * x.element_size() for x in (q, k, v, q))
        flops = 4 * B * H * hd * pairs
        bound_ms, by = bound(nbytes, flops, BF16_FLOP_PER_S)
        res[f"flash_hd256_{label}"] = dict(
            shape=[B, S, H, KV, hd], window=WINDOW, ms=statistics.median(kern),
            plain_ms=statistics.median(pl), bound_ms=bound_ms, bound_by=by,
            library_ms=statistics.median(lib))
        print(f"flash hd 256 [{label}] at {tuple(q.shape)} KV {KV} bf16 "
              f"causal window {WINDOW}, ms per call: kernel {spread(kern)}, "
              f"plain {spread(pl)}, library (sdpa, boolean mask) "
              f"{spread(lib)} (max_abs_err vs plain {lib_err!r}); bound "
              f"{bound_ms!r} ms by {by} ({nbytes} bytes, {flops} flop over "
              f"{pairs} visible pairs) [{smi}]")
    return res


# --------------------------------------------------------------------------
# row gather and dictionary decode (take_gather.cu), and the gradient guard
# --------------------------------------------------------------------------

GATHER_DTYPES = (torch.float32, torch.bfloat16, torch.int32, torch.int64,
                 torch.uint8)
GATHER_LINES = {"take_rows": 30, "dict_decode": 63}     # take_gather.py
# the timed cells: (kernel, what it stands for, table rows R, width W,
# dtype, int32 indices M); TPC-H v3.0.1 ORDERS and CUSTOMER at SF10
# (clause 4.2.5) and the 25 names of NATION (clause 4.2.3)
GATHER_CELLS = (
    ("take_rows", "SF10 orders -> customers rows", N_CUST, 8, torch.float32,
     N_ORDERS),
    ("take_rows", "wide rows", 65_536, 256, torch.float32, 1_048_576),
    ("dict_decode", "NATION dictionary, in shared memory", len(NATIONS), 16,
     torch.float32, N_ORDERS),
    ("dict_decode", "large dictionary, through L2", 4096, 128,
     torch.bfloat16, 4_000_000),
)


def gather_table(g, R, W, dtype):
    """R x W elements of ``dtype`` over its whole bit range (NaNs of random
    payloads among them), drawn on the card; a float table begins with
    -0.0, inf, -inf and NaN."""
    size = torch.empty(0, dtype=dtype).element_size()
    t = torch.randint(0, 256, (R, W * size), dtype=torch.uint8, generator=g,
                      device=CUDA).view(dtype)
    if dtype.is_floating_point and t.numel():
        specials = torch.tensor([-0.0, float("inf"), float("-inf"),
                                 float("nan")], dtype=dtype, device=CUDA)
        n = min(4, t.numel())
        t.view(-1)[:n] = specials[:n]
    return t


def gather_pair(name, table, idx):
    """(the wrapper's output, its plain version's) on the same tensors."""
    if name == "take_rows":
        return ops.take_rows(table, idx), ref.take_rows_ref(table, idx)
    return ops.dict_decode(idx, table), ref.dict_decode_ref(idx, table)


def raises(exc, fn, what: str) -> str:
    """The message of the ``exc`` that ``fn()`` raises; fails if none."""
    try:
        fn()
    except exc as e:
        return str(e)
    check(False, f"{what}: no {exc.__name__} raised")


def phase_gather_vs_plain():
    """take_rows and dict_decode on CUDA tensors against their plain
    versions on the same tensors, bit for bit, and their edges.  Returns
    (max bit difference, launches) per kernel."""
    g = torch.Generator(device=CUDA).manual_seed(10)
    limit = take_gather.smem_limit()
    print(f"dict_decode stages a dictionary of up to {limit} bytes in shared "
          "memory (the device's per-block opt-in limit)")
    errs = dict.fromkeys(GATHER_LINES, 0.0)
    n = dict.fromkeys(GATHER_LINES, 0)
    sides = {True: 0, False: 0}             # dictionaries staged or not

    def held(name, table, idx, what):
        got, want = gather_pair(name, table, idx)
        errs[name] = max(errs[name], bit_err(got, want, f"{name} {what}"))
        n[name] += 1
        if name == "dict_decode":
            sides[take_gather.staged(table)] += 1
    ops.reset_launch_counts()
    for dtype in GATHER_DTYPES:
        size = torch.empty(0, dtype=dtype).element_size()
        for W in (1, 7, 8, 64, 130):
            at_limit = limit // (W * size)          # rows that just fit
            tables = [("take_rows", gather_table(g, 1000, W, dtype))] + [
                ("dict_decode", gather_table(g, R, W, dtype))
                for R in (25, at_limit, at_limit + 1)]
            for name, table in tables:
                R = table.shape[0]
                for M in (1, 7, 257, 100_003):
                    for idx_dtype in (torch.int32, torch.int64):
                        idx = torch.randint(0, R, (M,), generator=g,
                                            device=CUDA, dtype=idx_dtype)
                        held(name, table, idx, f"{str(dtype)[6:]} R={R} "
                             f"W={W} M={M} {str(idx_dtype)[6:]}")
    # bases off the 16-byte boundary, and a strided table
    for dtype, shift in ((torch.float32, 1), (torch.bfloat16, 3),
                         (torch.uint8, 5)):
        flat = gather_table(g, 1, 1000 * 8 + shift, dtype).view(-1)
        table = flat[shift:].view(1000, 8)
        idx = torch.randint(0, 1000, (10_001,), generator=g, device=CUDA)
        for name in GATHER_LINES:
            held(name, table, idx, f"{str(dtype)[6:]} base + {shift}")
            held(name, flat[:8000].view(1000, 8)[:, 1:7], idx,
                 f"{str(dtype)[6:]} strided")
    launches = dict(ops.launch_counts)
    check(all(launches[k] == n[k] for k in GATHER_LINES) and all(
        v == 0 for k, v in launches.items() if k not in GATHER_LINES),
        f"gather launches {launches} != one per comparison {n}")
    check(sides[True] > 0 and sides[False] > 0,
          f"dictionaries on one side of the shared-memory limit only {sides}")
    # out-of-range indices raise before any launch; zero rows launch nothing
    table = gather_table(g, 5, 3, torch.float32)
    for name in GATHER_LINES:
        for bad, idx_dtype in (([0, -1], torch.int32), ([5], torch.int32),
                               ([2 ** 31], torch.int64),
                               ([2 ** 32 + 1], torch.int64)):
            idx = torch.tensor(bad, dtype=idx_dtype, device=CUDA)
            msg = raises(IndexError, lambda: gather_pair(name, table, idx),
                         f"{name} index {bad}")
            check("out of range" in msg, f"{name}: {msg}")
        raises(IndexError, lambda: gather_pair(
            name, table[:0], torch.zeros(3, dtype=torch.int64, device=CUDA)),
            f"{name} from zero rows")
        for idx_dtype in (torch.int32, torch.int64):
            got, want = gather_pair(name, table,
                                    torch.empty(0, dtype=idx_dtype,
                                                device=CUDA))
            bit_err(got, want, f"{name} of zero rows")
            check(got.shape == (0, 3), f"{name} of zero rows: {got.shape}")
    check(dict(ops.launch_counts) == launches,
          f"an out-of-range or zero-row gather launched: "
          f"{dict(ops.launch_counts)} vs {launches}")
    sync()
    print(f"take_rows and dict_decode vs plain versions, bit for bit: {n} "
          f"comparisons ({sides[True]} dictionaries staged in shared memory, "
          f"{sides[False]} read through L2), all identical (max |bit diff| "
          f"{errs}); launches {launches}; out-of-range indices raise "
          "IndexError, zero rows launch nothing")
    return errs, {k: launches[k] for k in GATHER_LINES}


def phase_grad_guard() -> None:
    """Each CUDA wrapper that takes floats refuses an input that requires
    grad while grad is enabled, before any launch, and runs the same call
    under ``torch.no_grad()``."""
    g = torch.Generator(device=CUDA).manual_seed(11)
    q, k, v = attn_inputs(11, 1, 16, 16, 2, 1, 16, torch.float32)
    r, kk, vv, w, u, _ = wkv_inputs(g, 1, 4, 2, 16, torch.float32, "model")
    a, b = torch.rand(2, 1, 4, 8, generator=g, device=CUDA)
    table = torch.randn(5, 3, generator=g, device=CUDA)
    idx = torch.tensor([0, 4, 2], device=CUDA)
    calls = {"flash_attention": (lambda x: ops.flash_attention(x, k, v), q),
             "wkv6": (lambda x: ops.wkv6(r, kk, vv, w, x), u),
             "rglru_scan": (lambda x: ops.rglru_scan(x, b), a),
             "take_rows": (lambda x: ops.take_rows(x, idx), table),
             "dict_decode": (lambda x: ops.dict_decode(idx, x), table)}
    for name, (call, x) in calls.items():
        x = x.detach().requires_grad_()
        before = ops.launch_counts[name]
        with torch.enable_grad():
            msg = raises(RuntimeError, lambda: call(x),
                         f"{name} on an input that requires grad")
        check("queue 1, item 6" in msg and ops.launch_counts[name] == before,
              f"{name}: {msg!r}, launches {ops.launch_counts[name]} after "
              f"{before}")
        with torch.no_grad():
            call(x)
        check(ops.launch_counts[name] == before + 1,
              f"{name} did not launch under no_grad")
    sync()
    print(f"gradient guard: {list(calls)} each raise RuntimeError on an "
          "input that requires grad while grad is enabled, before any "
          "launch, and launch under torch.no_grad()")


def phase_gather_times() -> dict:
    """The four cells: the kernel through its binding (the validating
    wrapper syncs once per call, which a graph cannot hold), its plain
    version and ``torch.index_select`` from CUDA-graph replays, beside the
    bound: the indices, each distinct source row once and the output once
    at the memory rate."""
    g = torch.Generator(device=CUDA).manual_seed(12)
    smi = smi_line()
    res = {name: [] for name in GATHER_LINES}
    for name, label, R, W, dtype, M in GATHER_CELLS:
        table = torch.randn(R, W, generator=g, device=CUDA).to(dtype)
        idx = torch.randint(0, R, (M,), generator=g, device=CUDA,
                            dtype=torch.int32)
        if name == "take_rows":
            def kernel():
                return take_gather.take_rows_cuda(table, idx)

            def plain():
                return ref.take_rows_ref(table, idx)
        else:
            def kernel():
                return take_gather.dict_decode_cuda(idx, table)

            def plain():
                return ref.dict_decode_ref(idx, table)

        def library():
            return torch.index_select(table, 0, idx)
        err = bit_err(kernel(), library(), f"{name} [{label}] vs index_select")
        kern, pl = timed_pair(kernel, plain)
        lib = time_ms(library)
        row = W * table.element_size()
        distinct = torch.unique(idx).numel()
        nbytes = M * idx.element_size() + distinct * row + M * row
        bound_ms, by = bound(nbytes, 0, F32_FLOP_PER_S)
        staged = name == "dict_decode" and take_gather.staged(table)
        cell = dict(cell=label, R=R, W=W, M=M, dtype=str(dtype)[6:],
                    index="int32", staged=staged, ms=statistics.median(kern),
                    plain_ms=statistics.median(pl), bound_ms=bound_ms,
                    bound_by=by, library_ms=statistics.median(lib))
        res[name].append(cell)
        print(f"{name} [{label}] R {R} x W {W} {cell['dtype']}, M {M} int32 "
              f"indices{', dictionary in shared memory' if staged else ''}, "
              f"ms per call: kernel {spread(kern)}, plain {spread(pl)}, "
              f"library (index_select) {spread(lib)} (bits equal to the "
              f"kernel's, max |bit diff| {err!r}); bound {bound_ms!r} ms by "
              f"{by} ({nbytes} bytes, {distinct} distinct rows); kernel at "
              f"{bound_ms / cell['ms']:.4f} of the bound [{smi}]")
        del table, idx
        torch.cuda.empty_cache()
    return res


@contextlib.contextmanager
def patched(patches):
    """Each (target, name, fn) of ``patches`` in place for the block."""
    with contextlib.ExitStack() as stack:
        for target, name, fn in patches:
            stack.enter_context(mock.patch.object(target, name, fn))
        yield


def kernel_vs_plain_prefill(api, tokens, shape, plain_patches, what: str,
                            served_first, f64_patches=None,
                            extra=None) -> None:
    """The prefill logits through the kernels against those with each
    kernel swapped for its plain version, with float32 compute on the
    same weights (the tight check, ``LOGIT_TOL``) and in bf16.  In bf16
    every rounding that the two paths flip differently is amplified by the
    random layers, in rwkv6-3b's slowly decaying states most of all, so
    the bf16 bound is ``LOGIT_TOL``'s or half of the gap that bf16 rounding
    alone opens between the plain path's bf16 and float32 logits, whichever
    is larger: the kernel may not add more than half of bf16's own noise.

    With ``f64_patches`` (float64 twins of the plain versions) the plain
    path runs once more with float64 compute on the same f32 weights, and
    its gap to the plain float32 logits is the float32 noise floor.  Two
    float32 paths that each stand that far from float64 may stand twice as
    far from each other (triangle inequality), so each float32 bound (L2
    and max) is ``LOGIT_TOL``'s or twice the floor of its own measure,
    whichever is larger.  The model's own float32 steps (the norms, the
    RWKV decay and group norm) stay float32 in that path, as the model
    defines them.  ``extra``: the prefill's other inputs (patches,
    frames)."""
    batch = dict(extra or {}, tokens=tokens)
    logits = {}
    for dtype in (torch.bfloat16, torch.float32):
        with compute_dtype(api, dtype):
            logits[dtype], _ = api.prefill(batch, shape)
            with patched(plain_patches):
                logits[dtype, "plain"], _ = api.prefill(batch, shape)
    f32, bf16 = torch.float32, torch.bfloat16
    tol32 = LOGIT_TOL[f32]
    if f64_patches is not None:
        with compute_dtype(api, torch.float64), patched(f64_patches):
            f64, _ = api.prefill(batch, shape)
        sync()
        check(bool(torch.isfinite(f64).all()), f"{what}: non-finite float64 "
              "logits")
        floor = (rel_l2(logits[f32, "plain"], f64),
                 rel_max(logits[f32, "plain"], f64))
        tol32 = tuple(max(LOGIT_TOL[f32], 2 * x) for x in floor)
        print(f"{what}: float32 noise floor, plain path's float32 vs float64 "
              f"logits: rel L2 {floor[0]!r}, max |diff| / max |logit| "
              f"{floor[1]!r}; float32 bounds (the larger of "
              f"{LOGIT_TOL[f32]!r} and twice the floor) {tol32[0]!r} (L2), "
              f"{tol32[1]!r} (max)")
        del f64
    sync()
    compare_logits(logits[f32], logits[f32, "plain"], tol32,
                   f"{what} prefill logits, float32 compute, kernels vs "
                   "plain versions")
    floor = rel_l2(logits[bf16, "plain"], logits[f32, "plain"])
    tol = max(LOGIT_TOL[bf16], floor / 2)
    print(f"{what}: bf16 rounding alone, plain path's bf16 vs float32 "
          f"logits: rel L2 {floor!r}; bf16 bound {tol!r}")
    compare_logits(logits[bf16], logits[bf16, "plain"], tol,
                   f"{what} prefill logits, bf16 compute, kernels vs plain "
                   "versions")
    check(logits[bf16][:, -1].argmax(-1).tolist() == served_first,
          f"{what}: the recomputed prefill does not give the served first "
          "tokens")


def each_launch_vs_plain(api, tokens, shape, twins, what: str,
                         extra=None) -> dict:
    """One more bf16 prefill in which every call of each wrapper is held
    to its plain version on the same inputs, before the caches change:
    the path's own shapes and values, free of the amplification through
    the layers that the logits see.  ``twins``: (name, plain, tolerance by
    output dtype, 0 for bit for bit).  These launches are comparisons and
    come after the main path's counts were read."""
    errs, n, ulps = {}, {}, {}

    def as_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def twin(name, kernel, plain, tol):
        def call(*args, **kw):
            out = kernel(*args, **kw)
            for o, w in zip(as_tuple(out), as_tuple(plain(*args, **kw))):
                t = tol.get(o.dtype, 0.0)
                err = (o.float() - w.float()).abs().max().item()
                check(o.dtype == w.dtype and o.shape == w.shape
                      and torch.allclose(o.float(), w.float(), rtol=t,
                                         atol=t),
                      f"{what}: {name} launch {n.get(name, 0)} vs its plain "
                      f"version: max_abs_err {err!r} (tol {t})")
                errs[name] = max(errs.get(name, 0.0), err)
                if o.dtype == torch.bfloat16:
                    over = int((ulps_from(o, w) > 1).sum())
                    ulps.setdefault(name, []).append(f"{err:.3g}/{over}")
            n[name] = n.get(name, 0) + 1
            return out
        return call
    with compute_dtype(api, torch.bfloat16), contextlib.ExitStack() as stack:
        for name, plain, tol in twins:
            stack.enter_context(mock.patch.object(
                ops, name, twin(name, getattr(ops, name), plain, tol)))
        api.prefill(dict(extra or {}, tokens=tokens), shape)
    sync()
    print(f"{what}: every launch of a bf16 prefill against its plain version"
          f" on its own inputs: {n} launches, max_abs_err {errs}")
    for name, per in ulps.items():
        print(f"{what}: {name}'s bf16 output per launch, max |kernel - "
              f"plain| / elements more than one bf16 ulp (of the plain "
              f"value) from it: {' '.join(per)}")
    return errs


def ulps_from(got, want):
    """|got - want| in bf16 ulps of want, element by element (float64): an
    ulp of x is 2^(floor(log2 |x|) - 7), at least that of the least normal
    float32."""
    want = want.double()
    e = torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -126)))
    return (got.double() - want).abs() / torch.pow(2.0, e - 7)


def decode_vs_prefill(api, tokens, shape, what: str, extra=None,
                      offset: int = 0) -> None:
    """Float32 compute: the logits of one decode step after the S tokens
    against the last logits of a prefill of S + 1 tokens.  ``extra``: the
    prefill's other inputs; ``offset``: the positions they take before
    the tokens (a vlm's patches)."""
    B, S = tokens.shape
    extra = extra or {}
    with compute_dtype(api, torch.float32):
        logits, caches = api.prefill(dict(extra, tokens=tokens), shape)
        nxt = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        step, _ = api.serve_step(
            {"tokens": nxt, "positions": torch.full(
                (B, 1), offset + S, dtype=torch.int32, device=CUDA)}, caches)
        full, _ = api.prefill(dict(extra, tokens=torch.cat([tokens, nxt], 1)),
                              shape)
    sync()
    a, b = step[:, -1].float(), full[:, -1].float()
    err = (a - b).abs().max().item()
    print(f"{what}: decode after {S} tokens vs prefill of {S + 1}, float32 "
          f"compute: max |diff| {err!r}, max |logit| "
          f"{b.abs().max().item()!r} (allclose at {DECODE_TOL})")
    check(bool(torch.isfinite(a).all()) and torch.allclose(
        a, b, rtol=DECODE_TOL, atol=DECODE_TOL),
        f"{what}: decode disagrees with prefill")


def plain_wkv6(r, k, v, w, u, state=None):
    return ref.wkv6_ref(r, k, v, w, u, state)


def wkv6_f64(r, k, v, w, u, state=None):
    """The float64 twin of ``ref.wkv6_ref`` (which computes in float32 by
    design): the same loop in float64; out in r's dtype, state float64."""
    B, S, H, N = r.shape
    st = torch.zeros((B, H, N, N), dtype=torch.float64, device=r.device) \
        if state is None else state.double()
    u = u.double()[None, :, :, None]
    rf, kf, vf, wf = (x.double() for x in (r, k, v, w))
    outs = []
    for t in range(S):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]
        outs.append(torch.einsum("bhn,bhnm->bhm", rf[:, t], st + u * kv))
        st = st * wf[:, t, :, :, None] + kv
    return torch.stack(outs, dim=1).to(r.dtype), st


def phase_serve_rwkv() -> dict:
    cfg, api = build_model("rwkv6-3b")
    batch, max_seq, max_new = 8, 1024, 32
    rng = np.random.default_rng(1)
    rounds = [prompts(rng, cfg, batch, 256, 512, max_new) for _ in range(2)]
    engine = ServeEngine(api, batch=batch, max_seq=max_seq)
    ops.reset_launch_counts()
    outs = run_rounds(engine, rounds, cfg.name)
    launches = dict(ops.launch_counts)
    print(f"{cfg.name} launch counts over 2 prefills: {launches}")
    check(launches == dict(dict.fromkeys(launches, 0),
                           wkv6=cfg.n_layers * 2),
          f"{cfg.name}: launches {launches} != wkv6 {cfg.n_layers} x 2")
    check_tokens(outs, 2 * batch * max_new, cfg.vocab, cfg.name)
    padded = torch.from_numpy(pad_prompts(rounds[0], batch)).to(CUDA)
    kernel_vs_plain_prefill(api, padded, engine.shape,
                            [(ops, "wkv6", plain_wkv6)], cfg.name,
                            [o[0] for o in outs[0]],
                            f64_patches=[(ops, "wkv6", wkv6_f64)])
    each_launch_vs_plain(api, padded, engine.shape,
                         [("wkv6", plain_wkv6, WKV_TOL)], cfg.name)
    decode_vs_prefill(api, padded, engine.shape, cfg.name)
    profile_run(lambda: engine.run_batch(rounds[1]),
                f"one warm {cfg.name} round")
    del api, engine
    torch.cuda.empty_cache()
    return launches


def phase_serve_rgemma() -> dict:
    cfg, api = build_model("recurrentgemma-9b")
    rng = np.random.default_rng(2)
    max_new = 32
    runs = [("batch 8", 8, 1024, prompts(rng, cfg, 8, 256, 512, max_new)),
            ("long", 1, 4096, prompts(rng, cfg, 1, 3072, 3072, max_new))]
    n_rec = sum(k == "rec" for k in api.model.kinds) * api.model.groups
    n_attn = len(api.model.blocks) - n_rec
    engines, outs = {}, {}
    ops.reset_launch_counts()
    for label, batch, max_seq, reqs in runs:
        engines[label] = ServeEngine(api, batch=batch, max_seq=max_seq)
        outs[label] = run_rounds(engines[label], [reqs],
                                 f"{cfg.name} {label}")[0]
    launches = dict(ops.launch_counts)
    print(f"{cfg.name} launch counts over 2 prefills: {launches}")
    check(launches == dict(dict.fromkeys(launches, 0), rglru_scan=n_rec * 2,
                           flash_attention=n_attn * 2),
          f"{cfg.name}: launches {launches} != rglru_scan {n_rec} x 2, "
          f"flash_attention {n_attn} x 2")
    check(engines["long"].stats["prefill_tokens"] == 3072
          and WINDOW < 3072, "the long request does not pass the window")
    for label, batch, _, reqs in runs:
        check_tokens([outs[label]], batch * max_new, cfg.vocab,
                     f"{cfg.name} {label}")
        padded = torch.from_numpy(pad_prompts(reqs, batch)).to(CUDA)
        shape = engines[label].shape
        kernel_vs_plain_prefill(
            api, padded, shape,
            [(ops, "rglru_scan", ref.rglru_ref),
             (attention, "_attend", plain_attend)],
            f"{cfg.name} {label}", [o[0] for o in outs[label]])
        each_launch_vs_plain(
            api, padded, shape,
            [("rglru_scan", ref.rglru_ref, {}),
             ("flash_attention", ref.attention_ref, TOL)],
            f"{cfg.name} {label}")
        decode_vs_prefill(api, padded, shape, f"{cfg.name} {label}")
    profile_run(lambda: engines["batch 8"].run_batch(runs[0][3]),
                f"one warm {cfg.name} batch-8 round")
    del api, engines
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------------------
# training smollm-135m on the Zerrow pipeline's batches
# --------------------------------------------------------------------------

# the corpus: 2 shards of 250,000 documents (8-24 words each, about 22 MB
# of text a shard) and the metadata of 500,000 documents, 0.75 kept (cut
# from 4 shards, and smollm's 30 steps to 10, to make room for phases
# 22-26 in the script's time)
N_SHARDS, DOCS_PER_SHARD, KEEP_FRAC = 2, 250_000, 0.75
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_WARMUP, TRAIN_LR = 8, 1024, 10, 3, 1e-3
# card against CPU, float32 (TF32 off): step 0's grads per leaf by relative
# L2 (the two devices sum the same products in other orders, which moves a
# leaf by a few 1e-6 of its norm at most), the loss and grad norm of two
# steps by relative error
GRAD_TOL, STEP_TOL = 1e-5, 1e-4
# a step whose MoE routing differs between the devices: its loss within
# FLIP_LOSS_TOL; more than FLIP_MAX of the token-layers routed differently
# fails
FLIP_LOSS_TOL, FLIP_MAX = 1e-3, 0.01


def batch_digest(b) -> bytes:
    return hashlib.blake2b(b["tokens"].tobytes() + b["labels"].tobytes(),
                           digest_size=16).digest()


def expected_digests(shards, meta, B: int, S: int) -> list:
    """The digests of the batches the pipeline must yield, from numpy
    alone: per shard, the utf8 bytes (+1) of the documents whose keep flag
    is set, in document order, cut to whole spans of B x (S + 1)."""
    keep = zarquet.read_table(meta).combine().batches[0].column("keep").values
    span = B * (S + 1)
    out = []
    for path in shards:
        b = zarquet.read_table(path).combine().batches[0]
        text, doc = b.column("text"), b.column("doc").values
        lens = np.diff(text.offsets)
        kept = keep[doc] != 0
        starts = text.offsets[:-1][kept]
        ids = np.concatenate([text.values[s0:s0 + n] for s0, n in
                              zip(starts, lens[kept])]).astype(np.int32) + 1
        for i in range(len(ids) // span):
            arr = ids[i * span:(i + 1) * span].reshape(B, S + 1)
            out.append(batch_digest({
                "tokens": np.ascontiguousarray(arr[:, :-1]),
                "labels": np.ascontiguousarray(arr[:, 1:])}))
    return out


def run_pipeline(shards, meta, mode: str, workers: int, keep_first: int = 0):
    """One epoch of ZerrowDataPipeline: (digests, the first ``keep_first``
    batches, wall s, stats, launches in this process, the Flight workers'
    echoed launches)."""
    pipe = ZerrowDataPipeline(shards, PipelineConfig(
        batch=TRAIN_B, seq_len=TRAIN_S, workers=workers, workers_mode=mode,
        meta_path=meta))
    digests, first = [], []
    try:
        sync()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        for b in pipe.batches():
            digests.append(batch_digest(b))
            if len(first) < keep_first:
                first.append(b)
        sync()
        wall = time.perf_counter() - t0
        launches = dict(ops.launch_counts)
        stats = pipe.stats()
        worker = {k.split(":", 1)[1]: v for k, v in
                  getattr(pipe.ex, "worker_stats", {}).items()
                  if k.startswith("launches:")}
    finally:
        pipe.close()
    return digests, first, wall, stats, launches, worker


def phase_pipeline(root: str):
    """Phase 14: the training input pipeline at full width, its corpus
    join on the card's relational kernels.  Returns the launches by path
    and the first batches of the cuda run."""
    t0 = time.perf_counter()
    shards = make_text_shards(os.path.join(root, "corpus"), N_SHARDS,
                              DOCS_PER_SHARD, seed=0)
    meta = make_doc_meta(os.path.join(root, "meta"),
                         N_SHARDS * DOCS_PER_SHARD, keep_frac=KEEP_FRAC)
    text_bytes = sum(int(np.diff(zarquet.read_table(p).combine()
                                 .batches[0].column("text").offsets).sum())
                     for p in shards)
    want = expected_digests(shards, meta, TRAIN_B, TRAIN_S)
    print(f"train pipeline: corpus of {N_SHARDS} shards x {DOCS_PER_SHARD} "
          f"documents ({text_bytes} bytes of text; "
          f"{sum(os.path.getsize(p) for p in shards)} bytes of zarquet) and "
          f"metadata of {N_SHARDS * DOCS_PER_SHARD} documents, keep_frac "
          f"{KEEP_FRAC}, made in {time.perf_counter() - t0:.1f} s; "
          f"{len(want)} batches of {TRAIN_B} x {TRAIN_S} expected")
    # one shard joined by hand, as the pipeline's joinf node joins it
    tables = [zarquet.read_table(shards[0]),
              zarquet.read_table(meta, dict_columns=("lang",))]
    sync()
    ops.reset_launch_counts()
    join_filter_fn(tables)
    sync()
    per_shard = dict(ops.launch_counts)
    del tables
    want_launches = {k: N_SHARDS * v for k, v in per_shard.items()}
    print(f"train pipeline: one shard's join by hand launches {per_shard}")

    runs = {}
    for label, device, mode, workers in (("cuda, threads", "cuda", "thread",
                                          4),
                                         ("cpu, threads", "cpu", "thread", 4),
                                         ("cuda, processes", "cuda",
                                          "process", 2)):
        with kdispatch.using_device(device):
            runs[label] = r = run_pipeline(shards, meta, mode, workers,
                                           keep_first=TRAIN_STEPS + 1)
        digests, _, wall, stats, launches, worker = r
        print(f"train pipeline, {label} ({workers} workers): "
              f"{len(digests)} batches in {wall:.2f} s "
              f"({len(digests) * TRAIN_B * TRAIN_S / wall:.0f} tokens/s); "
              f"launches here {launches}; in the workers {worker}; stats "
              f"{ {k: v for k, v in stats.items() if k in ('decache_hits', 'loads', 'bytes_copied', 'bytes_deanon', 'bytes_reshared', 'reshare_hits')} }")
        check(digests == want, f"train pipeline, {label}: batches differ "
              f"from the numpy recount ({len(digests)} vs {len(want)})")
    zeros = dict.fromkeys(ops.launch_counts, 0)
    check(runs["cuda, threads"][4] == dict(zeros, **want_launches),
          f"train pipeline, cuda: launches {runs['cuda, threads'][4]} != "
          f"{N_SHARDS} x one shard's {per_shard}")
    check(runs["cpu, threads"][4] == zeros,
          f"train pipeline, cpu: launches {runs['cpu, threads'][4]}")
    proc_worker = dict(zeros, **runs["cuda, processes"][5])
    check(runs["cuda, processes"][4] == zeros,
          f"train pipeline, processes: the parent launched "
          f"{runs['cuda, processes'][4]}")
    check(proc_worker == runs["cuda, threads"][4],
          f"train pipeline, processes: the workers launched {proc_worker} "
          f"!= the thread run's {runs['cuda, threads'][4]}")
    tokens = len(want) * TRAIN_B * (TRAIN_S + 1)
    print(f"train pipeline: every batch of the three runs bit-identical to "
          f"the numpy recount (so cuda = cpu = processes); {tokens} packed "
          f"tokens of {text_bytes}: {tokens / text_bytes:.4f} kept "
          f"(keep_frac {KEEP_FRAC})")
    check(abs(tokens / text_bytes - KEEP_FRAC) < 0.02,
          "train pipeline: the kept share of tokens is not about keep_frac")
    return {"train pipeline": runs["cuda, threads"][4],
            "train pipeline, processes": proc_worker}, \
        runs["cuda, threads"][1], (shards, meta, per_shard)


# the inputs of a train batch: the pipeline's tokens and labels, and the
# patch or frame embeddings of the vlm and enc-dec families
TRAIN_KEYS = ("tokens", "labels", "patches", "frames")


def to_device(b, dev):
    return {k: torch.as_tensor(b[k]).to(dev) for k in TRAIN_KEYS if k in b}


def phase_train(batches):
    """Phase 15: smollm-135m at full width trains 10 steps on the
    pipeline's batches.  Returns (api, state)."""
    cfg = get_arch("smollm-135m")
    api = ModelAPI(cfg, device=CUDA)
    state = init_state(api, torch.Generator(device=CUDA).manual_seed(0))
    step = make_train_step(api, peak_lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                           total_steps=TRAIN_STEPS)
    n = sum(p.numel() for p in api.model.parameters())
    print(f"train: {cfg.name} {len(api.model.blocks)} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab}, {n} float32 parameters, "
          f"{cfg.dtype} compute, remat {cfg.remat}, {cfg.optimizer}; "
          f"B {TRAIN_B} x S {TRAIN_S}, peak lr {TRAIN_LR}, warmup "
          f"{TRAIN_WARMUP}")
    losses, norms, times = [], [], []
    sync()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    for b in batches[:TRAIN_STEPS]:
        t0 = time.perf_counter()
        state, m = step(state, to_device(b, CUDA))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        sync()
        times.append(time.perf_counter() - t0)
    launches = dict(ops.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(times[1:])
    print(f"train: losses {[round(x, 4) for x in losses]}")
    print(f"train: grad norms {[round(x, 4) for x in norms]}")
    print(f"train: {TRAIN_STEPS} steps; step 0 {times[0] * 1e3:.1f} ms, "
          f"median of steps 1-{TRAIN_STEPS - 1} {med * 1e3:.2f} ms "
          f"(min {min(times[1:]) * 1e3:.2f}, max {max(times[1:]) * 1e3:.2f}"
          f"), {TRAIN_B * TRAIN_S / med:.0f} tokens/s; max memory allocated "
          f"{peak / 2**30:.3f} GiB; launches {launches}")
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          "train: a loss or grad norm is not finite")
    check(float(np.mean(losses[-5:])) < losses[0],
          f"train: the loss did not fall ({losses[0]} -> mean of the last "
          f"5 {np.mean(losses[-5:])})")
    check(launches == dict.fromkeys(ops.launch_counts, 0),
          f"train: the model path launched {launches} (attention trains "
          "through chunked_attention)")
    profile_run(lambda: step(state, to_device(batches[TRAIN_STEPS], CUDA)),
                f"one train step (B {TRAIN_B} x S {TRAIN_S})", top=10)
    return api, state


@contextlib.contextmanager
def recording_routes():
    """A list that collects each MoE router call's chosen experts (gate_e,
    (T, k), copied to the host) while the block runs."""
    log, real = [], moe_mod.route

    def route(p, xt, cfg):
        out = real(p, xt, cfg)
        log.append(out[3].detach().to("cpu", copy=True))
        return out
    with mock.patch.object(moe_mod, "route", route):
        yield log


def route_flips(a, b):
    """Token-layers whose expert sets differ between two runs' gate_e
    lists (layer by layer, (T, k) each): (count, per token (T,) bool)."""
    n, per_token = 0, None
    for x, y in zip(a, b):
        d = (x.sort(1).values != y.sort(1).values).any(1)
        n += int(d.sum())
        per_token = d if per_token is None else per_token | d
    return n, per_token


def float64_grads(api, batch) -> list:
    """Step 0's grads of ``api``'s model (on the CPU) computed in float64
    throughout: a float64 copy of its weights, and every ``.float()`` of
    the model's own float32 steps (norms, recurrences, loss) giving
    float64; the grads in the order of ``jax_leaves``."""
    cfg = dataclasses.replace(api.cfg, dtype="float64",
                              param_dtype="float64")
    twin = ModelAPI(cfg, device="cpu")
    twin.model.load_state_dict(api.model.state_dict())
    for p in twin.model.parameters():
        p.data = p.data.double()

    def f64(t, *a, **k):
        return t if t.dtype == torch.float64 else t.double()
    with mock.patch.object(torch.Tensor, "float", f64):
        loss, _ = twin.train_loss(to_device(batch, "cpu"))
        params = [p for leaf in jax_leaves(twin.model) for p in leaf.params]
        return list(torch.autograd.grad(loss, params))


def phase_train_vs_cpu(batches, cfg=None, what: str = "train",
                       floor: bool = False) -> None:
    """Phases 16, 18, 19 and 21: the model (smollm-135m at full width
    unless ``cfg`` is given) in float32 on the card and on the CPU from the
    same weights (drawn on the card, copied to the CPU): step 0's grads
    per leaf, then the loss and grad norm of two train steps.

    For the moe family a top-k decided on probabilities a few 1e-7 apart
    can flip between the devices, and a flip changes that token's output
    and, through attention, the later tokens'.  So each forward's routing
    is recorded on both devices and compared first: where it agrees
    everywhere the grads are held to ``GRAD_TOL`` and a step's loss and
    grad norm to ``STEP_TOL``; where it differs, the differing
    token-layers are printed and the loss is held to ``FLIP_LOSS_TOL``; a
    flip count above ``FLIP_MAX`` of the token-layers fails.

    With ``floor`` (rwkv6-3b) the grads are also computed in float64 on
    the CPU: the chunked WKV-6 form's float32 grads of r, k and the token
    mix stand a few 1e-5 from float64 on either device, above
    ``GRAD_TOL``, so each leaf's grads on the card are held to float64
    within the larger of ``GRAD_TOL`` and twice the CPU's float32
    distance, as phase 8 bounds rwkv6-3b's float32 logits by its noise
    floor; the card against the CPU is printed."""
    cfg = dataclasses.replace(cfg or get_arch("smollm-135m"), dtype="float32")
    # one sequence of 128 tokens, beside its patches or frames whole
    b = [{k: np.array(x[k][:1, :128]) if k in ("tokens", "labels")
          else x[k][:1] for k in TRAIN_KEYS if k in x} for x in batches[:2]]
    t0 = time.perf_counter()
    apis = {"cpu": ModelAPI(cfg, device="cpu"),
            "cuda": ModelAPI(cfg, device=CUDA)}
    apis["cuda"].model.init(torch.Generator(device=CUDA).manual_seed(0))
    apis["cpu"].model.load_state_dict(apis["cuda"].model.state_dict())
    secs = {"weights": time.perf_counter() - t0}
    n_moe = len(apis["cpu"].model.blocks) if cfg.n_experts else 0
    routes, losses, grads = {}, {}, {}
    for name, api in apis.items():
        t1 = time.perf_counter()
        with recording_routes() as log:
            loss, _ = api.train_loss(to_device(b[0], api.device))
        routes[name] = [log[:n_moe]]
        losses[name] = loss.item()
        params = [p for leaf in jax_leaves(api.model) for p in leaf.params]
        grads[name] = list(torch.autograd.grad(loss, params))
        del loss
        secs[f"grads {name}"] = time.perf_counter() - t1
    if floor:
        grads["float64"] = float64_grads(apis["cpu"], b[0])
    # relative L2 per JAX leaf, from its per-layer pieces
    paths = [leaf.path for leaf in jax_leaves(apis["cpu"].model)]
    sizes = [len(leaf.params) for leaf in jax_leaves(apis["cpu"].model)]

    def per_leaf(x, y):
        out, i = {}, 0
        for path, n in zip(paths, sizes):
            num = den = 0.0
            for a, c in zip(grads[x][i:i + n], grads[y][i:i + n]):
                # y's dtype: float32 differences of near values are exact
                num += (a.to("cpu", c.dtype) - c).norm().item() ** 2
                den += c.norm().item() ** 2
            out[path] = (num / max(den, 1e-300)) ** 0.5
            i += n
        return out
    rels = {("cuda", "cpu"): per_leaf("cuda", "cpu")}
    if floor:
        rels["cpu", "float64"] = per_leaf("cpu", "float64")
        rels["cuda", "float64"] = per_leaf("cuda", "float64")
    for (x, y), r in rels.items():
        top = sorted(r.items(), key=lambda kv: -kv[1])[:4]
        print(f"{what}, step 0's grads, {x} vs {y}, relative L2, the worst "
              f"leaves: " + ", ".join(f"{p} {v!r}" for p, v in top))
    worst = max(rels["cuda", "cpu"].values())
    del grads
    metrics = {}
    for name, api in apis.items():
        t1 = time.perf_counter()
        state = init_state(api)
        step = make_train_step(api, peak_lr=TRAIN_LR, warmup=1,
                               total_steps=10)
        ms = []
        for x in b:
            with recording_routes() as log:
                state, m = step(state, to_device(x, api.device))
            routes[name].append(log[:n_moe])
            ms.append((float(m["loss"]), float(m["grad_norm"])))
        metrics[name] = ms
        del state, step
        secs[f"two steps {name}"] = time.perf_counter() - t1
    print(f"{what}, card vs cpu: seconds {secs}")
    flips = [route_flips(x, y)[0]
             for x, y in zip(routes["cuda"], routes["cpu"])]
    total = n_moe * b[0]["tokens"].size
    print(f"{what}, card vs cpu ({cfg.name}, {layout(apis['cpu'].model)}"
          f", float32, B 1 x S 128; {time.perf_counter() - t0:.1f}"
          f" s): step 0's grads, worst relative L2 over {len(sizes)} leaves "
          f"{worst!r} (tol {GRAD_TOL}); loss cuda {losses['cuda']!r} cpu "
          f"{losses['cpu']!r}; (loss, grad norm) of two steps cuda "
          f"{metrics['cuda']} cpu {metrics['cpu']}" + (
              f"; token-layers routed differently in the loss forward and "
              f"the two steps: {flips} of {total} each" if n_moe else ""))
    check(all(f <= FLIP_MAX * total for f in flips),
          f"{what}, card vs cpu: routing flips {flips} above {FLIP_MAX} of "
          f"{total} token-layers")
    if floor:
        bad = [(p, r, rels["cpu", "float64"][p])
               for p, r in rels["cuda", "float64"].items()
               if r > max(GRAD_TOL, 2 * rels["cpu", "float64"][p])]
        check(not bad, f"{what}: step 0's grads on the card farther from "
              f"float64 than max({GRAD_TOL}, twice the CPU's float32 "
              f"distance): {bad}")
    elif flips[0] == 0:
        check(worst <= GRAD_TOL, f"{what}, card vs cpu: step 0's grads")
    check(abs(losses["cuda"] - losses["cpu"]) <= (
        STEP_TOL if flips[0] == 0 else FLIP_LOSS_TOL) * abs(losses["cpu"]),
        f"{what}, card vs cpu: the loss of step 0's forward")
    for f, (l1, g1), (l0, g0) in zip(flips[1:], metrics["cuda"],
                                     metrics["cpu"]):
        if f == 0:
            check(abs(l1 - l0) <= STEP_TOL * abs(l0)
                  and abs(g1 - g0) <= STEP_TOL * abs(g0),
                  f"{what}, card vs cpu: loss or grad norm of a step")
        else:
            check(abs(l1 - l0) <= FLIP_LOSS_TOL * abs(l0),
                  f"{what}, card vs cpu: the loss of a step with routing "
                  "flips")
    # Parameters are not compared element by element after an update: Adam's
    # first step moves each weight by about lr * sign(g), so a near-zero
    # gradient that rounds to the other sign on one device moves that
    # weight by 2 * lr there.  The second step's loss and grad norm carry
    # the whole update instead.
    del apis


def phase_checkpoint(root: str, state) -> None:
    """Phase 17: the phase-15 train state saved through CheckpointStore
    (async) and restored onto the card into a fresh state, bit for bit; a
    second save reuses every blob.  Then the launcher as a user runs it,
    and again with --resume."""
    ck = os.path.join(root, "ckpt")
    store = CheckpointStore(ck)
    t0 = time.perf_counter()
    step = int(state["step"])
    mani = store.save(step, state)
    t_save = time.perf_counter() - t0
    store.flush()
    t_flush = time.perf_counter() - t0
    written = dict(store.stats)
    fresh_api = ModelAPI(get_arch("smollm-135m"), device=CUDA)
    fresh = init_state(fresh_api, torch.Generator(device=CUDA).manual_seed(1))
    t0 = time.perf_counter()
    restored, rmani = store.restore(like=fresh)
    sync()
    t_restore = time.perf_counter() - t0
    a, b = (flatten_paths(train_state_to_jax(s)) for s in (state, restored))
    check(sorted(a) == sorted(b) and all(
        a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
        for k in a), "checkpoint: the restored state is not bit-identical")
    check(all(t.device.type == "cuda" for t in
              [*fresh_api.model.parameters(), restored["step"],
               *flatten_paths(restored["opt"]).values()]),
          "checkpoint: a restored tensor is not on the card")
    store.save(step + 1, state)
    store.flush()
    reused = store.stats["blobs_reused"] - written["blobs_reused"]
    check(store.stats["blobs_written"] == written["blobs_written"]
          and reused == len(mani["tensors"]),
          f"checkpoint: the second save wrote "
          f"{store.stats['blobs_written'] - written['blobs_written']} blobs")
    store.close()
    print(f"checkpoint: step {rmani['step']}, {len(mani['tensors'])} tensors "
          f"({written['bytes_written']} bytes) saved in {t_save:.2f} s "
          f"({t_flush:.2f} s to flush the async writer), restored onto the "
          f"card bit for bit in {t_restore:.2f} s; the second save reused "
          f"all {reused} blobs")
    del fresh_api, fresh, restored

    env = dict(os.environ, TMPDIR=os.path.join(root, "launcher-tmp"),
               PYTHONPATH=os.path.join(ROOT, "src"))
    os.makedirs(env["TMPDIR"])
    d = os.path.join(root, "launcher-ckpt")
    outs = []
    for extra in (["--steps", "50"], ["--steps", "2", "--resume"]):
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
               "smollm-135m", "--ckpt-dir", d, *extra]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, env=env, cwd=root, capture_output=True,
                           text=True, timeout=600)
        print(f"launcher {' '.join(extra)}: exit {r.returncode} in "
              f"{time.perf_counter() - t0:.1f} s")
        print("\n".join("  " + x for x in r.stdout.splitlines()))
        check(r.returncode == 0, f"launcher {extra}: {r.stderr[-3000:]}")
        losses = [float(x.split()[3]) for x in r.stdout.splitlines()
                  if x.startswith("step ")]
        check(len(losses) > 0 and all(np.isfinite(losses)),
              f"launcher {extra}: losses {losses}")
        outs.append(r.stdout)
    check("resumed from step 50" in outs[1],
          "launcher --resume did not resume from step 50")


# --------------------------------------------------------------------------
# sharded training (phase 28)
# --------------------------------------------------------------------------

# steps of each run; the sharded steps against the unsharded one: the
# same float32 sums split over the ranks' shards, so 1e-6 relative (at
# world size 1 every shard is the whole tensor and they agree exactly)
SHARD_STEPS, SHARD_TOL, SHARD_DEADLINE_S = 3, 1e-6, 300.0


def _bits(a) -> bytes:
    return np.ascontiguousarray(a).view(np.uint8).tobytes()


def _free_port() -> int:
    import socket
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def _shard_rank(rank, world, port, q, cfg, device, batches, root):
    """One rank of phase 28, in a spawned process: joins the NCCL group
    (gloo on the CPU), runs ``shard_runs`` and puts its result (or its
    traceback) on ``q``."""
    import traceback
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    try:
        from repro_torch.launch.mesh import init_distributed
        init_distributed(device, timeout_s=120.0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        q.put((rank, True, shard_runs(cfg, device, batches, root)))
    except BaseException:
        tb = traceback.format_exc()
        print(f"sharded rank {rank}:\n{tb}", file=sys.stderr, flush=True)
        q.put((rank, False, tb))
        q.close()
        q.join_thread()        # the result reaches the parent before the
        os._exit(1)            # exit; peers that wait are killed there
    torch.distributed.destroy_process_group()


def shard_runs(cfg, device, batches, root) -> dict:
    """Phase 28's work on one rank: ``cfg`` trained SHARD_STEPS steps
    from the same seeded weights unsharded, on a ("data", "model") mesh
    under DEFAULT_RULES and FSDP_RULES, and on a ("pod", "data", "model")
    mesh with ``grad_compression`` (each step's int8 codes, scales and
    residuals held bit for bit to ``compress_grads_allreduce`` run on the
    CPU on the grads and residual the step captured); then the DEFAULT
    run's state saved and restored onto the mesh (``shardings=``) and
    onto the CPU.  Returns what rank 0 compares and measures."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import make_mesh, make_mesh_for
    from repro_torch.models.convert import to_host
    from repro_torch.runtime.compression import compress_grads_allreduce
    from repro_torch.sharding import partition
    from repro_torch.train.trainstep import shard_state, state_shardings
    dev = torch.device(device, torch.cuda.current_device()) \
        if device == "cuda" else torch.device(device)
    world = torch.distributed.get_world_size()
    rank = torch.distributed.get_rank()
    dsync = sync if device == "cuda" else (lambda: None)
    kw = dict(peak_lr=TRAIN_LR, warmup=1, total_steps=10)
    mesh2 = make_mesh_for(world, device=device)
    mp = mesh2.mesh.shape[1]
    pods = 2 if world % (2 * mp) == 0 else 1
    mesh3 = make_mesh((pods, world // pods // mp, mp),
                      ("pod", "data", "model"), device)
    out = {"world": world, "mesh2": tuple(mesh2.mesh.shape),
           "mesh3": tuple(mesh3.mesh.shape), "runs": {}}

    def train(name, mesh=None, rules=None, compress=False):
        api = ModelAPI(cfg, device=dev)
        state = init_state(api, torch.Generator(device=dev).manual_seed(0),
                           grad_compression=compress)
        if mesh is not None:
            state = shard_state(api, state, mesh, rules,
                                grad_compression=compress)
        step = make_train_step(api, mesh=mesh, rules=rules,
                               grad_compression=compress, **kw)
        r = {"losses": [], "norms": [], "times": [], "codes": 0,
             "code_faults": []}
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        for b in batches[:SHARD_STEPS]:
            cap = {} if compress else None
            dsync()
            t0 = time.perf_counter()
            state, m = step(state, to_device(b, dev), cap)
            r["losses"].append(float(m["loss"]))
            dsync()
            r["times"].append(time.perf_counter() - t0)
            r["norms"].append(float(m["grad_norm"]))
            if compress:
                # the CPU's plain run on the step's own grads and residual
                for path in cap["grads"]:
                    g = torch.from_numpy(to_host(cap["grads"][path]))
                    res = torch.from_numpy(to_host(cap["residual"][path]))
                    codes = {}
                    _, new_res = compress_grads_allreduce(
                        {path: g}, {path: res}, None, n_pods=2,
                        codes=codes)
                    q_card, s_card = cap["codes"][path]
                    same = (_bits(to_host(q_card))
                            == _bits(codes[path][0].numpy())
                            and _bits(to_host(s_card))
                            == _bits(codes[path][1].numpy()))
                    if pods == 1:     # one pod: no cross-pod sum either
                        same = same and _bits(to_host(
                            state["residual"][path])) == _bits(
                            new_res[path].numpy())
                    r["codes"] += 1
                    if not same:
                        r["code_faults"].append(path)
                del cap
        r["peak_gib"] = (torch.cuda.max_memory_allocated() / 2**30
                         if device == "cuda" else 0.0)
        r["dtensors"] = sum(isinstance(p, DTensor)
                            for p in api.model.parameters())
        r["params"] = sum(1 for _ in api.model.parameters())
        host = {k: v for k, v in flatten_paths(
            train_state_to_jax(state)).items()
            if not k.startswith("residual/")}
        out["runs"][name] = r
        return api, state, host

    _, _, plain = train("unsharded")
    worst = {}
    for name, mesh, rules, comp in (
            ("data,model DEFAULT_RULES", mesh2, partition.DEFAULT_RULES,
             False),
            ("data,model FSDP_RULES", mesh2, partition.FSDP_RULES, False),
            ("pod,data,model DEFAULT_RULES compressed", mesh3,
             partition.DEFAULT_RULES, True)):
        api, state, host = train(name, mesh, rules, comp)
        if rank == 0:
            errs = {k: rel_l2(torch.from_numpy(np.asarray(host[k],
                                                          np.float64)),
                              torch.from_numpy(np.asarray(plain[k],
                                                          np.float64)))
                    for k in plain if np.asarray(plain[k]).dtype.kind == "f"}
            k = max(errs, key=errs.get)
            worst[name] = (k, errs[k])
        if rules is partition.DEFAULT_RULES and not comp:
            saved_api, saved_state, saved_host = api, state, host
        else:
            del api, state
        del host
    out["worst"] = worst

    # checkpoints: save the sharded state (rank 0 writes), restore it onto
    # the mesh with shardings= and onto the CPU
    store = CheckpointStore(os.path.join(root, "sharded-ckpt"))
    t0 = time.perf_counter()
    store.save(SHARD_STEPS, saved_state)
    t_save = time.perf_counter() - t0
    like_api = ModelAPI(cfg, device=dev)
    like = init_state(like_api)
    sh = state_shardings(like_api, like, mesh2, partition.DEFAULT_RULES)
    t0 = time.perf_counter()
    on_mesh, _ = store.restore(like=like, shardings=sh)
    dsync()
    t_mesh = time.perf_counter() - t0
    got_mesh = flatten_paths(train_state_to_jax(on_mesh))
    placed = all(isinstance(p, DTensor)
                 for p in like_api.model.parameters())
    del on_mesh, like, like_api
    cpu_api = ModelAPI(cfg, device="cpu")
    t0 = time.perf_counter()
    on_cpu, _ = store.restore(like=init_state(cpu_api))
    t_cpu = time.perf_counter() - t0
    got_cpu = flatten_paths(train_state_to_jax(on_cpu))
    on_cpu_dev = {p.device.type for p in cpu_api.model.parameters()}
    store.close()
    out["ckpt"] = {
        "tensors": len(saved_host), "save_s": t_save, "mesh_s": t_mesh,
        "cpu_s": t_cpu, "placed": placed, "cpu_devices": sorted(on_cpu_dev),
        "mesh_same": sorted(got_mesh) == sorted(saved_host) and all(
            _bits(got_mesh[k]) == _bits(saved_host[k]) for k in saved_host),
        "cpu_same": sorted(got_cpu) == sorted(saved_host) and all(
            _bits(got_cpu[k]) == _bits(saved_host[k]) for k in saved_host)}
    del saved_api, saved_state
    return out


def phase_sharded(batches, cfg=None):
    """Phase 28: sharded training of smollm-135m at full width on
    ``torch.cuda.device_count()`` NCCL ranks, one card each (one on a
    one-card machine), spawned with a deadline: on a hang or a failed rank
    every rank is killed and the phase fails."""
    import multiprocessing
    cfg = cfg or get_arch("smollm-135m")
    world = torch.cuda.device_count() if CUDA.type == "cuda" else 1
    root = tempfile.mkdtemp(prefix="zerrow-sharded-")
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    b = [{k: np.array(x[k]) for k in ("tokens", "labels")}
         for x in batches[:SHARD_STEPS]]
    procs = [ctx.Process(target=_shard_rank, args=(
        r, world, port, q, cfg, CUDA.type, b, root)) for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    results, failure = {}, None
    try:
        end = t0 + SHARD_DEADLINE_S
        while len(results) < world and failure is None:
            left = end - time.perf_counter()
            if left <= 0:
                failure = f"the ranks outlived the {SHARD_DEADLINE_S} s " \
                    "deadline"
                break
            try:
                rank, ok, val = q.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [i for i, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and i not in results]
                if dead:
                    failure = f"ranks {dead} died without a result"
                continue
            if ok:
                results[rank] = val
            else:
                failure = f"rank {rank} failed:\n{val}"
        for p in procs:
            p.join(max(1.0, end - time.perf_counter()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(5)
        shutil.rmtree(root, ignore_errors=True)
    check(failure is None, f"sharded: {failure}")
    out = results[0]
    print(f"sharded: {cfg.name}, {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.dtype} compute on float32 masters, "
          f"{cfg.optimizer}, B {TRAIN_B} x S {TRAIN_S}, {SHARD_STEPS} "
          f"steps; world size {out['world']} (one NCCL rank a card); "
          f"meshes (data, model) {out['mesh2']} and (pod, data, model) "
          f"{out['mesh3']}; {time.perf_counter() - t0:.1f} s with the "
          f"ranks' start")
    plain = out["runs"]["unsharded"]
    for name, r in out["runs"].items():
        med = statistics.median(r["times"][1:])
        print(f"sharded, {name}: losses {r['losses']!r}; grad norms "
              f"{r['norms']!r}; step times "
              f"{[round(t * 1e3, 2) for t in r['times']]} ms"
              f" (median of steps 1-{SHARD_STEPS - 1} {med * 1e3:.2f} ms); "
              f"max memory allocated {r['peak_gib']:.3f} GiB; "
              f"{r['dtensors']} of {r['params']} parameters are DTensors"
              + (f"; worst leaf against the unsharded step "
                 f"{out['worst'][name][0]} {out['worst'][name][1]!r} "
                 f"relative L2" if name in out["worst"] else "")
              + (f"; int8 codes, scales and residuals of {r['codes']} "
                 "leaf-steps held to the CPU's plain run"
                 if r["codes"] else ""))
        check(all(np.isfinite(r["losses"])) and all(np.isfinite(r["norms"])),
              f"sharded, {name}: a loss or grad norm is not finite")
        if name == "unsharded":
            check(r["dtensors"] == 0, "sharded: the unsharded run holds "
                  "DTensors")
            continue
        check(r["dtensors"] == r["params"],
              f"sharded, {name}: {r['params'] - r['dtensors']} parameters "
              "are not DTensors")
        check(abs(r["losses"][0] - plain["losses"][0])
              <= SHARD_TOL * abs(plain["losses"][0]),
              f"sharded, {name}: step 0's loss {r['losses'][0]!r} against "
              f"{plain['losses'][0]!r}")
        if r["codes"]:
            check(not r["code_faults"], f"sharded, {name}: codes differ "
                  f"from the CPU's on {r['code_faults'][:5]}")
            continue
        check(all(abs(a - b) <= SHARD_TOL * abs(b) for a, b in zip(
            r["losses"] + r["norms"], plain["losses"] + plain["norms"])),
            f"sharded, {name}: losses or grad norms beyond {SHARD_TOL}")
        check(out["worst"][name][1] <= SHARD_TOL,
              f"sharded, {name}: {out['worst'][name]} beyond {SHARD_TOL}")
    ck = out["ckpt"]
    print(f"sharded, checkpoint: {ck['tensors']} tensors saved from the "
          f"mesh in {ck['save_s']:.2f} s (rank 0 writes); restored with "
          f"shardings= onto the mesh in {ck['mesh_s']:.2f} s (DTensors: "
          f"{ck['placed']}, bit for bit: {ck['mesh_same']}) and onto the "
          f"CPU in {ck['cpu_s']:.2f} s (devices {ck['cpu_devices']}, bit "
          f"for bit: {ck['cpu_same']})")
    check(ck["placed"] and ck["mesh_same"] and ck["cpu_same"]
          and ck["cpu_devices"] == ["cpu"], "sharded: checkpoint round trip")
    dt = statistics.median(out["runs"]["data,model DEFAULT_RULES"]
                           ["times"][1:])
    dp = statistics.median(plain["times"][1:])
    print(f"sharded: median step {dt * 1e3:.2f} ms on the mesh against "
          f"{dp * 1e3:.2f} ms unsharded ({(dt / dp - 1) * 100:+.1f} %: "
          f"DTensor's cost at world size {out['world']}); device: "
          f"{smi_line() if CUDA.type == 'cuda' else 'cpu'}")
    return out


# --------------------------------------------------------------------------
# training rwkv6-3b, recurrentgemma-9b and qwen3-moe-30b-a3b; serving the
# MoE
# --------------------------------------------------------------------------

# (n_layers, B, S, n_layers of the float32 card-against-CPU step); None
# keeps the published depth.  At 18 bytes a parameter (float32 master and
# grad, AdamW's mu and nu, the bf16 casts) one card holds rwkv6-3b whole
# (55.3 GB), recurrentgemma-9b as one group of (rec, rec, attn) with its
# untied embedding and head (2.69 B parameters, 48.4 GB) and
# qwen3-moe-30b-a3b at 4 of 48 layers (3.11 B, 56 GB); every width is the
# published one (PERF.md section 4)
# internvl2-26b at 5 of 48 layers (3.13 B, 56.3 GB) and whisper-medium
# whole (0.76 B, 13.7 GB) have their patches (256) or frames (1500) beside
# S tokens; the card-against-CPU step runs internvl2-26b at 1 layer and
# whisper-medium at 2 encoder and 2 decoder layers.  The last column is
# the peak lr: at d_model 6144, internvl2-26b's loss rose from step 3 on
# at TRAIN_LR's 1e-3 (11.6 -> 24.3 by step 5), so it trains at 1e-4
BIG_TRAIN = {"rwkv6-3b": (None, 4, 1024, 2, TRAIN_LR),
             "recurrentgemma-9b": (3, 1, 4096, 3, TRAIN_LR),
             "qwen3-moe-30b-a3b": (4, 2, 1024, 2, TRAIN_LR),
             "internvl2-26b": (5, 2, 768, 1, 1e-4),
             "whisper-medium": (None, 8, 448, 2, TRAIN_LR)}
BIG_STEPS, BIG_WARMUP = 10, 3
# serving qwen3-moe-30b-a3b: 16 of 48 layers, 42.4 GB of float32 masters
MOE_SERVE_LAYERS = 16
MODEL_KERNELS = ("flash_attention", "wkv6", "rglru_scan")


def big_cfg(name: str, n_layers):
    """``name`` at ``n_layers`` (an enc-dec: that many of each kind), or
    at its published depth for None."""
    cfg = get_arch(name)
    if n_layers is None:
        return cfg
    if cfg.is_encdec:
        return dataclasses.replace(cfg, n_layers=n_layers,
                                   encoder_layers=n_layers)
    return dataclasses.replace(cfg, n_layers=n_layers)


# Whisper's 30-second window: n_audio_ctx frames
N_FRAMES = 1500


def extra_inputs(cfg, B: int, g: torch.Generator) -> dict:
    """A batch's patch or frame embeddings (the frontends are stubs in
    both packages): seeded normals drawn on the card, in the compute
    dtype, as ``input_specs`` gives them; {} for a text model."""
    if cfg.is_encdec:
        name, n = "frames", N_FRAMES
    elif cfg.vision_tokens:
        name, n = "patches", cfg.vision_tokens
    else:
        return {}
    return {name: torch.randn((B, n, cfg.d_model), generator=g,
                              device=CUDA).to(getattr(torch, cfg.dtype))}


def pipeline_batches(corpus, B: int, S: int, n: int):
    """One epoch of ZerrowDataPipeline over the corpus's first shard at
    B x S, its metadata join on the card: (the first n batches, the
    number of batches)."""
    shards, meta, _ = corpus
    pipe = ZerrowDataPipeline(shards[:1], PipelineConfig(
        batch=B, seq_len=S, workers=4, workers_mode="thread",
        meta_path=meta))
    first, count = [], 0
    try:
        with kdispatch.using_device("cuda"):
            for b in pipe.batches():
                count += 1
                if len(first) < n:
                    first.append(b)
    finally:
        pipe.close()
    return first, count


def phase_train_big(name: str, corpus) -> dict:
    """Phases 18, 19, 21, 25 and 26: ``name`` at full width (depth as in
    ``BIG_TRAIN``), float32 masters, bf16 compute, remat, AdamW, 10 steps
    on the pipeline's batches (with seeded patches or frames beside them
    for the vlm and enc-dec families); then the float32 card-against-CPU
    step.  Returns the launches of the run (the pipeline's join)."""
    n_layers, B, S, cpu_layers, lr = BIG_TRAIN[name]
    cfg = big_cfg(name, n_layers)
    t0 = time.perf_counter()
    api = ModelAPI(cfg, device=CUDA)
    state = init_state(api, torch.Generator(device=CUDA).manual_seed(0))
    step = make_train_step(api, peak_lr=lr, warmup=BIG_WARMUP,
                           total_steps=BIG_STEPS)
    sync()
    n = sum(p.numel() for p in api.model.parameters())
    print(f"train {cfg.name}: {layout(api.model)}, d_model {cfg.d_model}, "
          f"vocab {cfg.vocab}, {n} float32 parameters, {cfg.dtype} compute, "
          f"remat {cfg.remat}, {cfg.optimizer}; B {B} x S {S}, peak lr "
          f"{lr}, warmup {BIG_WARMUP}; state made on the card in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    batches, n_batches = pipeline_batches(corpus, B, S, BIG_STEPS + 1)
    t_pipe = time.perf_counter() - t0
    g = torch.Generator(device=CUDA).manual_seed(1)
    batches = [dict(b, **extra_inputs(cfg, B, g)) for b in batches]
    extra = {k: tuple(v.shape) for k, v in batches[0].items()
             if k in ("patches", "frames")}
    losses, norms, times, aux = [], [], [], []
    for b in batches[:BIG_STEPS]:
        t0 = time.perf_counter()
        state, m = step(state, to_device(b, CUDA))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        sync()
        times.append(time.perf_counter() - t0)
        aux.append({k: float(m[k]) for k in moe_mod.AUX_KEYS if k in m})
    launches = dict(ops.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(times[1:])
    _, _, per_shard = corpus
    print(f"train {cfg.name}: the pipeline gave {n_batches} batches of {B} x "
          f"{S} from one shard in {t_pipe:.2f} s" + (
              f" (beside seeded {extra})" if extra else "") +
          f"; launches of the run {launches} (one shard's join: "
          f"{per_shard})")
    print(f"train {cfg.name}: losses {[round(x, 4) for x in losses]}")
    print(f"train {cfg.name}: grad norms {[round(x, 4) for x in norms]}")
    if cfg.n_experts:
        print(f"train {cfg.name}: MoE metrics a step (means over the "
              f"layers) {aux}")
        check(all(np.isfinite(v) for a in aux for v in a.values()),
              f"train {cfg.name}: an MoE metric is not finite")
    print(f"train {cfg.name}: {BIG_STEPS} steps; step 0 "
          f"{times[0] * 1e3:.1f} ms, median of steps 1-{BIG_STEPS - 1} "
          f"{med * 1e3:.2f} ms (min {min(times[1:]) * 1e3:.2f}, max "
          f"{max(times[1:]) * 1e3:.2f}), {B * S / med:.0f} tokens/s; max "
          f"memory allocated {peak / 2**30:.3f} GiB ({peak} bytes) "
          f"[{smi_line()}]")
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          f"train {cfg.name}: a loss or grad norm is not finite")
    check(float(np.mean(losses[-3:])) < losses[0],
          f"train {cfg.name}: the loss did not fall ({losses[0]} -> mean of "
          f"the last 3 {np.mean(losses[-3:])})")
    check(launches == dict(dict.fromkeys(ops.launch_counts, 0), **per_shard),
          f"train {cfg.name}: launches {launches} != one shard's join "
          f"{per_shard} and no model kernel (train mode runs the plain "
          "counterparts)")
    profile_run(lambda: step(state, to_device(batches[BIG_STEPS], CUDA)),
                f"one {cfg.name} train step (B {B} x S {S})", top=10)
    del api, state, step
    torch.cuda.empty_cache()
    phase_train_vs_cpu(batches, big_cfg(name, cpu_layers),
                       f"train {cfg.name}", floor=cfg.family == "ssm")
    torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def capacity_factor(api, cf: float):
    """The model's MoE capacity factor set to ``cf`` for the block."""
    old = api.model.cfg
    api.model.cfg = dataclasses.replace(old, capacity_factor=cf)
    try:
        yield
    finally:
        api.model.cfg = old


def moe_prefill_vs_plain(api, tokens, shape, what: str) -> None:
    """Prefill through the flash kernel against prefill with attention
    forced to ``chunked_attention``, in bf16 and float32 compute, each
    with the routing of every layer recorded.  A top-k over 128 experts
    decided on probabilities that the two attention paths move by about
    1e-6 flips now and then, and a flipped token's output moves, and with
    it the later tokens' through attention: so the token-layers routed
    differently are counted and printed, and the last-token logits are
    held (``LOGIT_TOL``) for the sequences routed alike everywhere.  In
    float32 more than ``FLIP_MAX`` of the token-layers routed differently,
    or no sequence routed alike, fails."""
    B = tokens.shape[0]
    for dtype in (torch.bfloat16, torch.float32):
        with compute_dtype(api, dtype):
            with recording_routes() as rk:
                logits, _ = api.prefill({"tokens": tokens}, shape)
            with recording_routes() as rp, mock.patch.object(
                    attention, "_attend", plain_attend):
                plain, _ = api.prefill({"tokens": tokens}, shape)
        sync()
        n, per_token = route_flips(rk, rp)
        alike = ~per_token.view(B, -1).any(1)
        total = len(rk) * per_token.numel()
        label = f"{what} prefill, {str(dtype)[6:]} compute"
        print(f"{label}: token-layers routed differently by the kernel and "
              f"the plain path {n} of {total} ({n / total:.2e}); sequences "
              f"routed alike in every layer {int(alike.sum())}/{B}")
        check(bool(torch.isfinite(logits).all()
                   and torch.isfinite(plain).all()),
              f"{label}: non-finite logits")
        if dtype == torch.float32:
            check(n <= FLIP_MAX * total and bool(alike.any()),
                  f"{label}: routing flips {n} of {total}")
        if alike.any():
            compare_logits(logits[alike], plain[alike], LOGIT_TOL[dtype],
                           f"{label}, kernel vs chunked_attention, the "
                           "sequences routed alike")


def phase_serve_moe():
    """Phase 20: qwen3-moe-30b-a3b at full width and 16 of its 48 layers,
    served as phase 4 serves smollm-135m; flash at hd 128 with 32 query
    and 4 KV heads."""
    cfg = dataclasses.replace(get_arch("qwen3-moe-30b-a3b"),
                              n_layers=MOE_SERVE_LAYERS)
    t0 = time.perf_counter()
    api = ModelAPI(cfg, device=CUDA)
    api.model.init(torch.Generator(device=CUDA).manual_seed(0))
    sync()
    n = sum(p.numel() for p in api.model.parameters())
    print(f"serve: {cfg.name} {len(api.model.blocks)} of 48 layers, d_model "
          f"{cfg.d_model}, {cfg.n_experts} experts top {cfg.top_k} (d_ff "
          f"{cfg.d_ff}), capacity factor {cfg.capacity_factor}, {n} "
          f"parameters in float32, drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s; device memory allocated "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    batch, max_seq, max_new = 8, 1024, 32
    rng = np.random.default_rng(3)
    rounds = [prompts(rng, cfg, batch, 256, 512, max_new) for _ in range(2)]
    engine = ServeEngine(api, batch=batch, max_seq=max_seq)
    dropped, real = [], moe_mod.moe_apply

    def moe_apply(p, x, c):
        out, aux = real(p, x, c)
        dropped.append((x.shape[1], aux["moe_dropped"]))
        return out, aux
    with mock.patch.object(moe_mod, "moe_apply", moe_apply):
        ops.reset_launch_counts()
        outs = run_rounds(engine, rounds, cfg.name)
        launches = dict(ops.launch_counts)
    print(f"{cfg.name} launch counts over 2 prefills: {launches}")
    check(launches == dict(dict.fromkeys(launches, 0),
                           flash_attention=cfg.n_layers * 2),
          f"{cfg.name}: launches {launches} != flash_attention "
          f"{cfg.n_layers} x 2")
    pre = [float(d) for s, d in dropped if s > 1]
    dec = [float(d) for s, d in dropped if s == 1]
    L = cfg.n_layers
    print(f"{cfg.name}: moe_dropped of each prefill, mean over its {L} "
          f"layers: {[sum(pre[i:i + L]) / L for i in range(0, len(pre), L)]}"
          f"; of the decode steps (T = B = {batch}, capacity 1): mean "
          f"{sum(dec) / len(dec)!r}")
    check_tokens(outs, 2 * batch * max_new, cfg.vocab, cfg.name)
    padded = torch.from_numpy(pad_prompts(rounds[0], batch)).to(CUDA)
    moe_prefill_vs_plain(api, padded, engine.shape, cfg.name)
    each_launch_vs_plain(api, padded, engine.shape,
                         [("flash_attention", ref.attention_ref, TOL)],
                         cfg.name)
    # no pair can drop when C >= T: capacity_factor = n_experts / top_k
    cf = cfg.n_experts / cfg.top_k
    with capacity_factor(api, cf):
        decode_vs_prefill(api, padded, engine.shape,
                          f"{cfg.name} (capacity factor {cf}: no pair "
                          "dropped)")
    profile_run(lambda: engine.run_batch(rounds[1]),
                f"one warm {cfg.name} round")
    del api, engine
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------------------
# serving the vlm (internvl2-26b) and enc-dec (whisper-medium) families
# --------------------------------------------------------------------------

# internvl2-26b's prefill: 256 patches and 512 tokens, 48 query and 8 KV
# heads of 128 (G 6); whisper-medium's encoder: 1500 frames, 16 heads of
# 64, non-causal
VLM_SHAPE = dict(B=8, S=768, T=768, H=48, KV=8, hd=128)
ENC_SHAPE = dict(B=8, S=N_FRAMES, T=N_FRAMES, H=16, KV=16, hd=64)
# serving internvl2-26b: 24 of 48 layers, 42.1 GB of float32 masters
VLM_SERVE_LAYERS = 24
WHISPER_BOS = 50258          # <|startoftranscript|>


def phase_flash_family_shapes() -> dict:
    """Phase 22: flash against its plain version at the served shapes of
    internvl2-26b and whisper-medium, in bf16 and float32; then the two
    prefill shapes timed.  Returns {shape: (max_abs_err, times)}."""
    cases = [
        ("internvl2-26b S=T 768 G 6 hd 128", VLM_SHAPE, True),
        ("internvl2-26b ragged S=T 717", dict(VLM_SHAPE, S=717, T=717), True),
        ("whisper-medium encoder S=T 1500 non-causal", ENC_SHAPE, False),
        ("whisper-medium decoder BOS S=T 1", dict(ENC_SHAPE, S=1, T=1),
         True),
    ]
    errs = {}
    for i, (name, shp, causal) in enumerate(cases):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = attn_inputs(200 + i, dtype=dtype, **shp)
            out = ops.flash_attention(q, k, v, causal=causal)
            want = ref.attention_ref(q, k, v, causal=causal)
            sync()
            err = (out.float() - want.float()).abs().max().item()
            tol = TOL[dtype]
            ok = bool(torch.isfinite(out).all()) and \
                out.shape == want.shape and torch.allclose(
                    out.float(), want.float(), rtol=tol, atol=tol)
            print(f"kernel vs plain [{name}] {tuple(q.shape)} "
                  f"{str(dtype)[6:]}: max_abs_err {err!r} (tol {tol}) "
                  f"{'ok' if ok else 'MISMATCH'}")
            check(ok, f"flash_attention vs attention_ref [{name}, "
                  f"{str(dtype)[6:]}]")
            if dtype == torch.bfloat16:
                errs[name] = max(errs.get(name, 0.0), err)
            del q, k, v, out, want
    vlm_err = max(e for n, e in errs.items() if n.startswith("internvl"))
    enc_err = errs[cases[2][0]]
    return dict(internvl2=(vlm_err, phase_times(VLM_SHAPE)),
                whisper=(enc_err, phase_times(ENC_SHAPE, causal=False)))


@contextlib.contextmanager
def recording_flash():
    """A list of (S, T, H, KV, hd, causal) of each flash call in the
    block; the wrapper still launches and counts."""
    log, real = [], ops.flash_attention

    def flash(q, k, v, *, causal=True, window=0):
        log.append((q.shape[1], k.shape[1], q.shape[2], k.shape[2],
                    q.shape[3], causal))
        return real(q, k, v, causal=causal, window=window)
    with mock.patch.object(ops, "flash_attention", flash):
        yield log


def serve_family_rounds(api, rounds, shape, max_new: int, offset: int,
                        label: str) -> list:
    """Each round's batch through ``ModelAPI.prefill`` and greedy
    ``serve_step`` (as ``ServeEngine`` drives text models; these take
    patches or frames beside the tokens).  ``offset``: the positions
    before the tokens.  Returns each round's new tokens (B, max_new)."""
    outs = []
    for r, batch in enumerate(rounds):
        B, S = batch["tokens"].shape
        sync()
        t0 = time.perf_counter()
        logits, caches = api.prefill(batch, shape)
        cur = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        sync()
        t1 = time.perf_counter()
        steps = []
        for i in range(max_new):
            steps.append(cur)
            logits, caches = api.serve_step(
                {"tokens": cur, "positions": torch.full(
                    (B, 1), offset + S + i, dtype=torch.int32, device=CUDA)},
                caches)
            cur = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        outs.append(torch.cat(steps, 1).cpu().numpy())
        t2 = time.perf_counter()
        n = B * (offset + S)
        print(f"{label} round {r}: prefill {n} positions ({B} x ({offset} "
              f"+ {S})) in {(t1 - t0) * 1e3:.2f} ms ({n / (t1 - t0):.0f} "
              f"positions/s) | decode {max_new} steps in "
              f"{(t2 - t1) * 1e3:.2f} ms ({(t2 - t1) / max_new * 1e3:.3f} "
              f"ms/step, {B * max_new / (t2 - t1):.0f} tok/s)")
        del caches
    return outs


def phase_serve_family(name: str) -> dict:
    """Phases 23 (internvl2-26b, 24 of 48 layers) and 24 (whisper-medium
    whole): 2 rounds of batch 8 with seeded patches or frames, 32 new
    tokens each; launches and shapes of flash counted, then the checks of
    phase 20 (kernel against plain path in bf16 and float32, every launch
    against its plain version, decode against prefill).  Returns the
    launches of the 2 rounds."""
    cfg = big_cfg(name, VLM_SERVE_LAYERS if name == "internvl2-26b"
                  else None)
    t0 = time.perf_counter()
    api = ModelAPI(cfg, device=CUDA)
    api.model.init(torch.Generator(device=CUDA).manual_seed(0))
    sync()
    n = sum(p.numel() for p in api.model.parameters())
    print(f"serve: {cfg.name} {layout(api.model)}, d_model {cfg.d_model}, "
          f"heads {cfg.n_heads}/{cfg.n_kv_heads} of {cfg.hd}, {n} parameters"
          f" in float32, drawn on the card in {time.perf_counter() - t0:.1f}"
          f" s; device memory allocated "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    batch, max_new = 8, 32
    rng = np.random.default_rng(4)
    g = torch.Generator(device=CUDA).manual_seed(5)
    rounds = []
    for _ in range(2):
        if cfg.is_encdec:
            tokens = torch.full((batch, 1), WHISPER_BOS, dtype=torch.int32,
                                device=CUDA)
        else:
            tokens = torch.from_numpy(pad_prompts(prompts(
                rng, cfg, batch, 256, 512, max_new), batch)).to(CUDA)
        rounds.append(dict(extra_inputs(cfg, batch, g), tokens=tokens))
    offset = 0 if cfg.is_encdec else cfg.vision_tokens
    # an enc-dec's cache holds the decoder's tokens; JAX's input_specs ties
    # its length to the frames
    seq = N_FRAMES if cfg.is_encdec else 1280
    shape = ShapeConfig("serve", "prefill", seq, batch)
    t0 = time.perf_counter()
    with recording_flash() as calls:
        ops.reset_launch_counts()
        outs = serve_family_rounds(api, rounds, shape, max_new, offset,
                                   cfg.name)
        launches = dict(ops.launch_counts)
    per = cfg.n_layers + cfg.encoder_layers
    print(f"{cfg.name} launch counts over 2 prefills: {launches}; flash "
          f"calls (S, T, H, KV, hd, causal) and their counts: "
          f"{ {c: calls.count(c) for c in sorted(set(calls))} }")
    check(launches == dict(dict.fromkeys(launches, 0),
                           flash_attention=per * 2),
          f"{cfg.name}: launches {launches} != flash_attention {per} x 2")
    for r, b in enumerate(rounds):
        S = b["tokens"].shape[1] + offset
        want = [(S, S, cfg.n_heads, cfg.n_kv_heads, cfg.hd, True)] \
            * cfg.n_layers
        if cfg.is_encdec:
            want = [(N_FRAMES, N_FRAMES, cfg.n_heads, cfg.n_kv_heads,
                     cfg.hd, False)] * cfg.encoder_layers + want
        check(calls[r * per:(r + 1) * per] == want,
              f"{cfg.name}: round {r}'s flash calls are not the served "
              "shapes")
    check_tokens(outs, 2 * batch * max_new, cfg.vocab, cfg.name)
    secs = {"rounds": time.perf_counter() - t0}
    b0 = rounds[0]
    extra = {k: v for k, v in b0.items() if k != "tokens"}
    t0 = time.perf_counter()
    kernel_vs_plain_prefill(api, b0["tokens"], shape,
                            [(attention, "_attend", plain_attend)],
                            cfg.name, outs[0][:, 0].tolist(), extra=extra)
    secs["kernel vs plain"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    each_launch_vs_plain(api, b0["tokens"], shape,
                         [("flash_attention", ref.attention_ref, TOL)],
                         cfg.name, extra=extra)
    secs["each launch"] = time.perf_counter() - t0
    two = {k: v[:2] for k, v in extra.items()}
    t0 = time.perf_counter()
    decode_vs_prefill(api, b0["tokens"][:2], shape,
                      f"{cfg.name} (2 sequences)", extra=two, offset=offset)
    secs["decode vs prefill"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    profile_run(lambda: serve_family_rounds(api, rounds[1:], shape, max_new,
                                            offset, f"{cfg.name} warm"),
                f"one warm {cfg.name} round")
    secs["profile"] = time.perf_counter() - t0
    print(f"{cfg.name} serving: seconds {secs}")
    del api, rounds, extra, two
    torch.cuda.empty_cache()
    return launches



def main() -> int:
    if not torch.cuda.is_available():
        print("FAILED: torch.cuda.is_available() is False: chip_smoke.py "
              "needs a CUDA card", flush=True)
        return 1
    t_start = time.perf_counter()

    def timed(label, fn, *args):
        """``fn(*args)``, and the seconds it took beside the script's."""
        t = time.perf_counter()
        out = fn(*args)
        now = time.perf_counter()
        print(f"[{label}: {now - t:.1f} s; the script at {now - t_start:.1f}"
              " s]", flush=True)
        return out
    timed("phase 1", phase_device)
    insts = timed("phase 2", phase_build)
    max_err, hd128_err = timed("phase 3", phase_kernel_vs_plain)
    times = timed("phase 3 times", phase_times)
    launches = timed("phase 4", phase_serve)
    rel_err = timed("phase 5", phase_relational_vs_plain)
    rel_times = timed("phase 5 times", phase_relational_times)
    t0 = time.perf_counter()
    orders, customers = star_tables()
    print(f"star tables at SF{SF}: orders {orders.num_rows} rows, customers "
          f"{customers.num_rows} rows, made in "
          f"{time.perf_counter() - t0:.1f} s")
    rel_launches, group_bys = timed("phase 6", phase_star, orders, customers)
    zerrow_launches = timed("phases 11-12", phase_zerrow_star, orders,
                            customers, group_bys)
    del orders, customers, group_bys
    prompt_flash = timed("phase 13", phase_zerrow_prompts)
    root = tempfile.mkdtemp(prefix="zerrow-train-")
    try:
        train_paths, train_batches, corpus = timed("phase 14",
                                                   phase_pipeline, root)
        train_api, train_state = timed("phase 15", phase_train,
                                       train_batches)
        timed("phase 16", phase_train_vs_cpu, train_batches)
        timed("phase 17", phase_checkpoint, root, train_state)
        del train_api, train_state
        torch.cuda.empty_cache()
        timed("phase 28", phase_sharded, train_batches)
        del train_batches
        for n, name in zip((18, 19, 21, 25, 26), BIG_TRAIN):
            train_paths[f"train {name}"] = timed(f"phase {n}",
                                                 phase_train_big, name,
                                                 corpus)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rec_err = timed("phase 7", phase_recurrent_vs_plain)
    rec_times = timed("phase 7 times", phase_recurrent_times)
    gather_err, gather_launches = timed("phase 10", phase_gather_vs_plain)
    timed("phase 10 grad guard", phase_grad_guard)
    gather_times = timed("phase 10 times", phase_gather_times)
    rwkv_launches = timed("phase 8", phase_serve_rwkv)
    rgemma_launches = timed("phase 9", phase_serve_rgemma)
    moe_launches = timed("phase 20", phase_serve_moe)
    hd128_times = timed("phase 20 times", phase_times, MOE_SHAPE)
    family = timed("phase 22", phase_flash_family_shapes)
    family_launches = {name: timed(f"phase {n}", phase_serve_family, name)
                       for n, name in ((23, "internvl2-26b"),
                                       (24, "whisper-medium"))}
    print(f"device: {smi_line()}")
    flash_paths = {"smollm-135m": launches["flash_attention"],
                   "recurrentgemma-9b": rgemma_launches["flash_attention"],
                   "qwen3-moe-30b-a3b": moe_launches["flash_attention"],
                   **{k: v["flash_attention"]
                      for k, v in family_launches.items()},
                   **prompt_flash}
    kernels = [dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:30",
        launches=sum(flash_paths.values()), launches_by_path=flash_paths,
        max_abs_err=max_err, **times, **insts["flash_attention"],
        hd256=dict(max_abs_err=rec_err["flash_hd256"],
                   serving=rec_times["flash_hd256_serving"],
                   long=rec_times["flash_hd256_long"]),
        hd128=dict(max_abs_err=hd128_err, serving=hd128_times,
                   shape=MOE_SHAPE),
        internvl2=dict(max_abs_err=family["internvl2"][0],
                       serving=family["internvl2"][1], shape=VLM_SHAPE,
                       causal=True),
        whisper_encoder=dict(max_abs_err=family["whisper"][0],
                             serving=family["whisper"][1], shape=ENC_SHAPE,
                             causal=False))]
    for name, line, launched in (
            ("wkv6", "src/repro/kernels/wkv6.py:27", rwkv_launches),
            ("rglru_scan", "src/repro/kernels/rglru_scan.py:21",
             rgemma_launches)):
        kernels.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{name}.cu",
            replaces=line, launches=launched[name],
            max_abs_err=rec_err[name], **rec_times[name],
            **insts.get(name, {})))
    for name, (src, line) in REL_SOURCES.items():
        t = rel_times[name]
        paths = {"star": rel_launches[name],
                 **{f"zerrow {k}": v[name]
                    for k, v in zerrow_launches.items()},
                 **{k: v[name] for k, v in train_paths.items() if v[name]}}
        kernels.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{src}",
            replaces=f"src/repro/kernels/relational.py:{line}",
            launches=sum(paths.values()), launches_by_path=paths,
            max_abs_err=rel_err[name],
            **{k: v for k, v in t.items() if k != "edge_ms"},
            **insts.get(name, {})))
    for name, line in GATHER_LINES.items():
        cells = gather_times[name]      # the first cell is the headline
        kernels.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/take_gather.cu",
            replaces=f"src/repro/kernels/take_gather.py:{line}",
            launches=gather_launches[name], launches_by_path={},
            max_abs_err=gather_err[name],
            **{k: cells[0][k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")},
            cells=cells))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
