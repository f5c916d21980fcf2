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
    ``ZerrowPromptSource`` (4 zarquet shards of 32 prompts, one DAG a
    shard) in thread and in process mode, batch 8, max_seq 1024, 32 new
    tokens: every prompt must be its shard text byte-tokenized, every
    prefill must launch flash attention once per layer, tokens in
    ``[0, vocab)``; then ``python -m repro_torch.launch.serve
    --prompt-shards 4 --workers 2 --workers-mode process`` as a user
    runs it, for 2 rounds.
14. A JSON line per kernel, then ``{"ok": true, "device": ...}`` as the
    last line.

Every check that fails exits non-zero before the last line is printed.
Without a CUDA card, or run from a directory without the repository's
``src/``, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import cProfile
import hashlib
import itertools
import json
import os
import pstats
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

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import (  # noqa: E402
    BufferStore, RMConfig, ResourceManager, kdispatch, make_executor, plan,
    vkernels, zarquet)
from repro_torch.core import ops as rops  # noqa: E402
from repro_torch.core.arrow import Column, Table  # noqa: E402
from repro_torch.core.plan import compiler as plan_compiler  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    build, flash_attention, ops, ref, relational, take_gather, wkv6)
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.api import ModelAPI  # noqa: E402
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.serve.engine import (  # noqa: E402
    Request, ServeEngine, ZerrowPromptSource, make_prompt_shards,
    pad_prompts)

# H100 SXM, NVIDIA data sheet (dense, at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12          # float32 outside the tensor cores

SERVE_SHAPE = dict(B=8, S=512, T=512, H=9, KV=3, hd=64)
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
    return errs["serving bf16 causal"]


def phase_times():
    sv = SERVE_SHAPE
    q, k, v = attn_inputs(100, dtype=torch.bfloat16, **sv)
    B, S, T, H, KV, hd = (sv[n] for n in ("B", "S", "T", "H", "KV", "hd"))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)
    lib_err = (library().transpose(1, 2).float()
               - ref.attention_ref(q, k, v).float()).abs().max().item()
    # plain, kernel, kernel, plain: drift on the card falls on both sides
    plain = time_ms(lambda: ref.attention_ref(q, k, v))
    kern = time_ms(lambda: ops.flash_attention(q, k, v))
    kern += time_ms(lambda: ops.flash_attention(q, k, v))
    plain += time_ms(lambda: ref.attention_ref(q, k, v))
    lib = time_ms(library)
    nbytes = sum(x.numel() * x.element_size() for x in (q, k, v, q))
    flops = 4 * B * H * S * T * hd * 0.5          # causal: half the pairs
    bound_ms, bound_by = bound(nbytes, flops, BF16_FLOP_PER_S)
    ms, plain_ms, lib_ms = (statistics.median(t) for t in (kern, plain, lib))
    print(f"times at {tuple(q.shape)} bf16 causal, ms per call: kernel "
          f"{spread(kern)}, plain {spread(plain)}, library (sdpa) "
          f"{spread(lib)} (max_abs_err vs plain {lib_err!r}); bound "
          f"{bound_ms!r} ms by {bound_by} ({nbytes} bytes, {flops:.0f} "
          f"flop); kernel at {bound_ms / ms:.4f} of the bound")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib_ms)


def plain_attend(q, k, v, cfg, causal, window):
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
    time and busy share of each of the port's model kernels.  The profiler
    adds host time, so the idle share it gives is an upper bound."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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
        shards = make_prompt_shards(root, 4, 32)
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
                            served_first, f64_patches=None) -> None:
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
    defines them."""
    logits = {}
    for dtype in (torch.bfloat16, torch.float32):
        with compute_dtype(api, dtype):
            logits[dtype], _ = api.prefill({"tokens": tokens}, shape)
            with patched(plain_patches):
                logits[dtype, "plain"], _ = api.prefill({"tokens": tokens},
                                                        shape)
    f32, bf16 = torch.float32, torch.bfloat16
    tol32 = LOGIT_TOL[f32]
    if f64_patches is not None:
        with compute_dtype(api, torch.float64), patched(f64_patches):
            f64, _ = api.prefill({"tokens": tokens}, shape)
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


def each_launch_vs_plain(api, tokens, shape, twins, what: str) -> dict:
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
        api.prefill({"tokens": tokens}, shape)
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


def decode_vs_prefill(api, tokens, shape, what: str) -> None:
    """Float32 compute: the logits of one decode step after the S tokens
    against the last logits of a prefill of S + 1 tokens."""
    B, S = tokens.shape
    with compute_dtype(api, torch.float32):
        logits, caches = api.prefill({"tokens": tokens}, shape)
        nxt = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        step, _ = api.serve_step(
            {"tokens": nxt, "positions": torch.full(
                (B, 1), S, dtype=torch.int32, device=CUDA)}, caches)
        full, _ = api.prefill({"tokens": torch.cat([tokens, nxt], 1)}, shape)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("FAILED: torch.cuda.is_available() is False: chip_smoke.py "
              "needs a CUDA card", flush=True)
        return 1
    phase_device()
    insts = phase_build()
    max_err = phase_kernel_vs_plain()
    times = phase_times()
    launches = phase_serve()
    rel_err = phase_relational_vs_plain()
    rel_times = phase_relational_times()
    t0 = time.perf_counter()
    orders, customers = star_tables()
    print(f"star tables at SF{SF}: orders {orders.num_rows} rows, customers "
          f"{customers.num_rows} rows, made in "
          f"{time.perf_counter() - t0:.1f} s")
    rel_launches, group_bys = phase_star(orders, customers)
    zerrow_launches = phase_zerrow_star(orders, customers, group_bys)
    del orders, customers, group_bys
    prompt_flash = phase_zerrow_prompts()
    rec_err = phase_recurrent_vs_plain()
    rec_times = phase_recurrent_times()
    gather_err, gather_launches = phase_gather_vs_plain()
    phase_grad_guard()
    gather_times = phase_gather_times()
    rwkv_launches = phase_serve_rwkv()
    rgemma_launches = phase_serve_rgemma()
    print(f"device: {smi_line()}")
    flash_paths = {"smollm-135m": launches["flash_attention"],
                   "recurrentgemma-9b": rgemma_launches["flash_attention"],
                   **prompt_flash}
    kernels = [dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:30",
        launches=sum(flash_paths.values()), launches_by_path=flash_paths,
        max_abs_err=max_err, **times, **insts["flash_attention"],
        hd256=dict(max_abs_err=rec_err["flash_hd256"],
                   serving=rec_times["flash_hd256_serving"],
                   long=rec_times["flash_hd256_long"]))]
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
                    for k, v in zerrow_launches.items()}}
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
