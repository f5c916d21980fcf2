#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

1. Device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 off, so float32 products are full float32.
2. Kernels: builds the flash attention kernel from
   src/repro_torch/kernels/csrc with nvcc for sm_90a (set-up time) and
   holds it against its plain PyTorch version (``ref.attention_ref``) on
   the same CUDA tensors, at the serving shape and at the edge cases.
3. Times at the serving shape, from the card's clock: kernel, plain
   version, and PyTorch's ``scaled_dot_product_attention`` as a yardstick
   (timed only; the port never calls it), beside the kernel's bound.
4. Serve: smollm-135m at full width (30 layers, d_model 576, random
   weights from a seed) through ``ModelAPI`` + ``ServeEngine``, 2 rounds of
   batch 8, prompts of 256-512 tokens, max_seq 1024, 32 new tokens.  The
   launch counts are set to 0 just before and read just after: every
   prefill must launch the kernel once per layer.  Round 1's prefill
   logits are recomputed with attention forced to the model's plain path
   (``attention.chunked_attention``), in the served bf16 model and in a
   float32 copy of it.  A profiled warm round gives the device's busy
   share and its largest kernels.
5. A JSON line per kernel, then ``{"ok": true, "device": ...}`` as the
   last line.

Every check that fails exits non-zero before the last line is printed.
Without a CUDA card, or run from a directory without the repository's
``src/``, it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
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
from repro_torch.kernels import build, ops, ref  # noqa: E402
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


def phase_build():
    t0 = time.perf_counter()
    build.load("flash_attention")
    print(f"built flash_attention in {time.perf_counter() - t0:.1f} s")


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
    """Device busy share over one warm round (prefill + decode), from
    torch.profiler's CUDA kernel events.  The profiler adds host time, so
    the idle share it gives is an upper bound."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run_batch(reqs)
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print("profile: the profiler recorded no CUDA kernel: device busy "
              "share not measured")
        return
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, float("-inf")
    for s0, s1 in spans:                   # union of kernel intervals
        if s1 > end:
            busy += s1 - max(s0, end)
            end = s1
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"profile of one warm round: wall {wall_us / 1e3:.2f} ms, device "
          f"busy {busy / 1e3:.2f} ms ({busy / wall_us:.4f} of wall, idle "
          f"{1 - busy / wall_us:.4f}), {len(kernels)} kernels")
    for name, us in top:
        print(f"  {us / 1e3:9.3f} ms  {us / busy:.4f} of busy  {name[:90]}")


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
    print(f"device: {smi_line()}")
    print(json.dumps({"kernels": [dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:30",
        launches=launches["flash_attention"], max_abs_err=max_err,
        **times)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
