#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

1. Device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 off, so float32 products are full float32.
2. Build: every kernel source of src/repro_torch/kernels/csrc, one nvcc
   each for sm_90a, all started together (each one's set-up time).
3. Flash attention: held against its plain PyTorch version
   (``ref.attention_ref``) on the same CUDA tensors, at the serving shape
   and at the edge cases; timed at the serving shape from the card's clock
   beside PyTorch's ``scaled_dot_product_attention`` (timed only; the port
   never calls it) and the kernel's bound.
4. Serve: smollm-135m at full width (30 layers, d_model 576, random
   weights from a seed) through ``ModelAPI`` + ``ServeEngine``, 2 rounds of
   batch 8, prompts of 256-512 tokens, max_seq 1024, 32 new tokens.  The
   launch counts are set to 0 just before and read just after: every
   prefill must launch the kernel once per layer.  Round 1's prefill
   logits are recomputed with attention forced to the model's plain path
   (``attention.chunked_attention``), in the served bf16 model and in a
   float32 copy of it.  A profiled warm round gives the device's busy
   share and its largest kernels.
5. Relational kernels (splitmix64 hash and fold, sentinel gather, segment
   reductions): each wrapper against its plain PyTorch version on the
   same CUDA tensors, bit for bit, over every dtype family and edge case;
   then at the shapes of the star query at TPC-H scale factor 10, the
   kernel, its plain version and, where one PyTorch call computes the same
   function, that call, all timed from CUDA-graph replays of the kernel's
   binding (the validating wrapper syncs once per call, which a graph
   cannot hold), beside the bound and the copies of one call's arrays
   between host and card that ``core.kdispatch`` makes at its edge.
6. The star query at SF10 through ``repro_torch.core.ops``: 15,000,000
   orders left-joined to 1,500,000 customers and grouped by 25 nations
   (sum/min/max/count of the amount), and the same through ``filter_join``
   with an amount filter.  Each runs on ``cuda`` with the launch counts
   set to 0 just before and read just after, and on the port's ``cpu``
   device; every output buffer must agree bit for bit, and the group
   totals must equal a numpy recount.  A profiled cuda run gives the
   device's busy share and the time spent at the kdispatch edge.
7. A JSON line per kernel, then ``{"ok": true, "device": ...}`` as the
   last line.

Every check that fails exits non-zero before the last line is printed.
Without a CUDA card, or run from a directory without the repository's
``src/``, it exits non-zero and prints no result.
"""

from __future__ import annotations

import cProfile
import dataclasses
import json
import os
import pstats
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import kdispatch, vkernels  # noqa: E402
from repro_torch.core import ops as rops  # noqa: E402
from repro_torch.core.arrow import Column, Table  # noqa: E402
from repro_torch.kernels import build, ops, ref, relational  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.api import ModelAPI  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine, pad_prompts  # noqa

# H100 SXM, NVIDIA data sheet (dense, at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

SERVE_SHAPE = dict(B=8, S=512, T=512, H=9, KV=3, hd=64)
# bf16: kernel and plain version both compute in f32 and round once to
# bf16, so they differ by at most about one bf16 ulp (2^-8 relative).
# f32: the two sum up to T = 512 terms in different orders; the worst
# case is T * 2^-24 * max|v| ~ 1.2e-4 at |v| <= 4 (normal inputs).
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# Prefill logits, kernel vs the model's plain attention (chunked_attention,
# which rounds the probabilities to bf16 before the PV product, as the JAX
# path does), as relative L2 error and as max error over the largest
# |logit|.  bf16 model: the two attention paths differ by about one bf16
# ulp, but each flipped rounding is amplified through 30 layers of random
# weights, so the bound is loose and the f32 model carries the tight
# check: its attention outputs differ by f32 summation order only.
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


KERNEL_SOURCES = ("flash_attention", "splitmix64", "sentinel_gather",
                  "segreduce")


def phase_build():
    secs = build.build_all(KERNEL_SOURCES)
    for name, t in secs.items():
        print(f"built {name} (nvcc, sm_90a) and loaded it in {t:.1f} s")


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
    ]
    errs = {}
    for i, (name, shp, dtype, causal, window) in enumerate(cases):
        q, k, v = attn_inputs(i, dtype=dtype, **shp)
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
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    bound_ms = max(t_bytes, t_ops) * 1e3
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    ms, plain_ms, lib_ms = (statistics.median(t) for t in (kern, plain, lib))

    def spread(t):
        return (f"median {statistics.median(t)!r} (min {min(t)!r}, max "
                f"{max(t)!r} over {len(t)} graph replays)")
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
    cfg = get_arch("smollm-135m")
    t0 = time.perf_counter()
    api = ModelAPI(cfg, device="cuda")
    api.model.init(torch.Generator().manual_seed(0))
    sync()
    print(f"serve: {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model} "
          f"on {api.device}, init {time.perf_counter() - t0:.1f} s")
    batch, max_seq, max_new, n_rounds = 8, 1024, 32, 2
    rng = np.random.default_rng(0)
    rounds = [[Request(prompt=rng.integers(
        1, cfg.vocab, size=int(rng.integers(256, 513))).astype(np.int32),
        max_new=max_new) for _ in range(batch)] for _ in range(n_rounds)]
    engine = ServeEngine(api, batch=batch, max_seq=max_seq)

    ops.reset_launch_counts()
    outs = []
    for r, reqs in enumerate(rounds):
        before = dict(engine.stats)
        outs.append(engine.run_batch(reqs))
        s = {k: engine.stats[k] - before[k] for k in before}
        print(f"round {r}: prefill {s['prefill_tokens']} tokens in "
              f"{s['prefill_s'] * 1e3:.2f} ms "
              f"({s['prefill_tokens'] / s['prefill_s']:.0f} tok/s) | decode "
              f"{s['decode_steps']} steps in {s['decode_s'] * 1e3:.2f} ms "
              f"({s['decode_s'] / s['decode_steps'] * 1e3:.3f} ms/step, "
              f"{batch * s['decode_steps'] / s['decode_s']:.0f} tok/s)")
    launches = dict(ops.launch_counts)
    print(f"launch counts over {n_rounds} prefills: {launches}")
    check(launches["flash_attention"] == cfg.n_layers * n_rounds,
          f"flash_attention launches {launches} != "
          f"{cfg.n_layers} x {n_rounds} prefills")
    toks = np.array([t for o in outs for row in o for t in row])
    check(toks.size == n_rounds * batch * max_new
          and toks.min() >= 0 and toks.max() < cfg.vocab,
          "served tokens out of [0, vocab) or missing")

    # the first round's prefill again: through the kernel and with attention
    # forced to the model's plain path, in the served bf16 model and an f32
    # copy
    padded = torch.from_numpy(pad_prompts(rounds[0], batch)).cuda()
    api32 = ModelAPI(dataclasses.replace(cfg, dtype="float32"), "cuda")
    api32.model.load_state_dict(api.model.state_dict())
    for m in (api, api32):
        logits, caches = m.prefill({"tokens": padded}, engine.shape)
        with mock.patch.object(attention, "_attend", plain_attend):
            plain_logits, _ = m.prefill({"tokens": padded}, engine.shape)
        step_logits, _ = m.serve_step(
            {"tokens": logits[:, -1].argmax(-1).to(torch.int32)[:, None],
             "positions": torch.full((batch, 1), padded.shape[1],
                                     dtype=torch.int32, device="cuda")},
            caches)
        sync()
        a, b = logits.float(), plain_logits.float()
        check(bool(torch.isfinite(a).all() and torch.isfinite(b).all()
                   and torch.isfinite(step_logits.float()).all()),
              "non-finite logits")
        rel_l2 = ((a - b).norm() / b.norm()).item()
        rel_max = ((a - b).abs().max() / b.abs().max()).item()
        agree = (a[:, -1].argmax(-1) == b[:, -1].argmax(-1)).sum().item()
        tol = LOGIT_TOL[m.model.cdtype]
        print(f"round 0 prefill logits, {str(m.model.cdtype)[6:]} model, "
              f"kernel vs chunked_attention: rel L2 {rel_l2!r}, max |diff| / "
              f"max |logit| {rel_max!r} (tol {tol} each), max |logit| "
              f"{b.abs().max().item()!r}, argmax agrees on {agree}/{batch}")
        check(rel_l2 <= tol and rel_max <= tol,
              f"prefill logits of the {m.model.cdtype} model: kernel vs "
              "plain attention")
        if m is api:
            check(a[:, -1].argmax(-1).tolist() == [o[0] for o in outs[0]],
                  "the recomputed prefill does not give the served first "
                  "tokens")
    del api32
    phase_profile(engine, rounds[1])
    return launches


def phase_profile(engine, reqs):
    """Device busy share over one warm round (prefill + decode)."""
    profile_run(lambda: engine.run_batch(reqs), "one warm round")


def profile_run(fn, label: str, top: int = 6) -> dict:
    """Run ``fn`` once under torch.profiler and print the device's busy
    share of the wall time (union of CUDA kernel and copy intervals), the
    part of it spent copying, and the largest entries by device time.  The
    profiler adds host time, so the idle share it gives is an upper
    bound."""
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
             "segreduce": 4}
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


def plain_reduce(op, vals, order, starts, valid, out_dtype):
    acc, counts = ref.segreduce_ref(op, vals, order, starts, valid)
    if op == "count":
        return counts, counts
    if op == "sum":
        return acc.view(out_dtype), counts
    return ops._narrow(acc, out_dtype), counts


REDUCERS = {"count": lambda v, o, s, m: ops.grouped_count(o, s, m),
            "sum": ops.grouped_sum, "min": ops.grouped_min,
            "max": ops.grouped_max}


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
    for dtype in INTS:
        for n, n_groups in ((0, 1), (1, 1), (2048 + 3, 1), (1_000_003, 26),
                            (3_000_000, 1_500_000)):
            order, starts = segments(rng, n, n_groups)
            if n_groups == 1_500_000:
                check(len(starts) > 1_200_000, "too few groups drawn")
            vals = dev(fixed_array(rng, n, dtype))
            order, starts = dev(order), dev(starts)
            for valid in (None, dev(rng.random(n) < 0.7)):
                for op, fn in REDUCERS.items():
                    got = fn(vals, order, starts, valid)
                    out_dtype = got[0].dtype
                    want = plain_reduce(op, vals, order, starts, valid,
                                        out_dtype) if len(starts) else got
                    what = (f"grouped_{op} {np.dtype(dtype).name} n={n} "
                            f"groups={len(starts)} "
                            f"nulls={valid is not None}")
                    err("segreduce", got[0], want[0], what)
                    err("segreduce", got[1], want[1], what + " counts")
    # uint64 and int64 sums that wrap
    for dtype, v, want in ((np.uint64, [2 ** 64 - 1, 2, 2 ** 63, 2 ** 63, 5],
                            [1, 5]),
                           (np.int64, [2 ** 62 + 1] * 4 + [-5], [4, -5])):
        vals = dev(np.array(v, dtype=dtype))
        order, starts = dev(np.arange(5)), dev(np.array([0, 4]))
        got = ops.grouped_sum(vals, order, starts)[0]
        err("segreduce", got, plain_reduce("sum", vals, order, starts,
                                           None, got.dtype)[0],
            f"{dtype.__name__} wrap")
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
    codes = np.where(hit, cust % 25, 25)
    order_np, starts_np = vkernels.group_ranges([codes])
    amount = rng.integers(0, 1_000_000, N_ORDERS)
    vals, order, starts = dev(amount), dev(order_np), dev(starts_np)
    gid = dev(codes)
    G = len(starts_np)
    ones = torch.ones(N_ORDERS, dtype=torch.int64, device=CUDA)
    lo, hi = -(1 << 63), (1 << 63) - 1
    library = {
        "count": lambda: torch.zeros(G, dtype=torch.int64, device=CUDA)
        .index_add_(0, gid, ones),
        "sum": lambda: torch.zeros(G, dtype=torch.int64, device=CUDA)
        .index_add_(0, gid, vals),
        "min": lambda: torch.full((G,), hi, dtype=torch.int64, device=CUDA)
        .scatter_reduce_(0, gid, vals, "amin"),
        "max": lambda: torch.full((G,), lo, dtype=torch.int64, device=CUDA)
        .scatter_reduce_(0, gid, vals, "amax"),
    }
    per_op = {}
    for op in ("count", "sum", "min", "max"):
        v = None if op == "count" else vals
        per_op[op] = dict(
            ms=median_ms(lambda op=op, v=v: relational.segreduce_cuda(
                op, v, order, starts, None)),
            plain_ms=median_ms(lambda op=op, v=v: ref.segreduce_ref(
                op, v, order, starts, None)),
            library_ms=median_ms(library[op]),
            # a count with no validity needs only starts (read) and the
            # counts (written); the other reducers read order, values and
            # starts and write the results and the counts
            bytes=(16 * G if v is None
                   else 16 * N_ORDERS + 24 * G),
            edge_ms=h2d_d2h_ms(
                [order_np, starts_np] + ([amount] if v is not None else []),
                [8 * G] * (1 + (v is not None))))
        print(f"segreduce {op} at n={N_ORDERS} G={G}: kernel "
              f"{per_op[op]['ms']!r} ms, plain {per_op[op]['plain_ms']!r} "
              f"ms, library {per_op[op]['library_ms']!r} ms, edge "
              f"{per_op[op]['edge_ms']!r} ms")
    res["segreduce"] = {k: sum(d[k] for d in per_op.values())
                        for k in per_op["sum"]}
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


def phase_star() -> dict:
    """Both star queries at SF10 on cuda (counted) and on the port's cpu
    device; bit-identical buffers, expected launches, a numpy recount,
    and a profiled cuda run with the time spent at the kdispatch edge."""
    t0 = time.perf_counter()
    orders, customers = star_tables()
    print(f"star tables at SF{SF}: orders {orders.num_rows} rows, customers "
          f"{customers.num_rows} rows, made in "
          f"{time.perf_counter() - t0:.1f} s")
    amount = orders.combine().batches[0].column("amount").values
    cust = orders.combine().batches[0].column("cust").values
    launches = {k: 0 for k in PER_QUERY}
    walls = {}
    for name, query, keep in (
            ("left join", star_left, np.ones(N_ORDERS, bool)),
            ("filtered inner join", star_filtered,
             (amount >= 500_000) & (cust < N_CUST))):
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
        want = dict(PER_QUERY, flash_attention=0)
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
        del j, g, j_cpu, g_cpu

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
            for k in ("hash_fixed", "combine_hashes", "filter_join_gather")}), \
            mock.patch.dict(kdispatch.GROUPED_REDUCERS, {
                k: timed(f"grouped_{k}", f)
                for k, f in kdispatch.GROUPED_REDUCERS.items()}):
        host = cProfile.Profile()
        prof = profile_run(lambda: host.runcall(star_left, orders,
                                                customers),
                           "the left-join star query on cuda")
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
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("FAILED: torch.cuda.is_available() is False: chip_smoke.py "
              "needs a CUDA card", flush=True)
        return 1
    phase_device()
    phase_build()
    max_err = phase_kernel_vs_plain()
    times = phase_times()
    launches = phase_serve()
    rel_err = phase_relational_vs_plain()
    rel_times = phase_relational_times()
    rel_launches = phase_star()
    print(f"device: {smi_line()}")
    kernels = [dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:30",
        launches=launches["flash_attention"], max_abs_err=max_err,
        **times)]
    for name, (src, line) in REL_SOURCES.items():
        t = rel_times[name]
        kernels.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{src}",
            replaces=f"src/repro/kernels/relational.py:{line}",
            launches=rel_launches[name], max_abs_err=rel_err[name],
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
