"""Tile variants of the flash kernel on one card: build, check and time
each at served prefill shapes.

    python3 flash_sweep.py [--dtype bfloat16] [--hd 192] [--extra NAME=PATH]
    python3 flash_sweep.py --dtype float32 [--extra NAME=PATH ...]

Each variant is ``src/repro_torch/kernels/csrc/flash_attention.cu`` with
one line of its tile table changed (``VARIANTS``: ``Bf16Tiles`` for
bfloat16, ``F32Tiles`` for float32), or another source with the same C
entry point ``flash_attention_fwd`` (``--extra``, such as an earlier
commit's).  All are built together (``sweeps.py``); ptxas's registers,
shared memory and spills of the kernel are printed, with what the card
reports for it (blocks an SM).

bfloat16: at nemotron-4-340b's prefill (``SHAPES``: B 8, S = T 512, 96
query and 8 KV heads of 192, causal) and at a ragged cut of it, at the
head dim ``--hd``.  float32: at the served prefill of each head dim
(``F32_CELLS``: smollm-135m's hd 64, qwen3-moe-30b-a3b's hd 128,
nemotron-4-340b's hd 192, recurrentgemma-9b's hd 256 with its 2048-token
window at B 8 x 512 and at one 3072-token request), where chip_smoke.py
times the kernel.  Each variant is held to ``ref.attention_ref`` at
chip_smoke.py's bound for the dtype (a failure is printed, not fatal),
then all are timed from CUDA-graph replays in turn
(``sweeps.interleaved``), beside the plain version (float32),
``scaled_dot_product_attention`` in the same dtype and the bound of
``kernels/costs.py``.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics

import torch
import torch.nn.functional as F

import chip_smoke as cs
import sweeps
from repro_torch.kernels import build, costs, ref

# dtype -> name -> [(text in flash_attention.cu, its replacement)]
VARIANTS = {
    torch.bfloat16: {
        "kernel": [],
        # KV tiles of 64 keys up to hd 192 (32 from hd 256 on)
        "bk64": [("static constexpr int BK = HD >= 192 ? 32 : 64;",
                  "static constexpr int BK = HD >= 256 ? 32 : 64;")],
    },
    torch.float32: {
        "kernel": [],
        # the loads of two depth units issued together (one in the kernel
        # but at hd 256)
        "dub2": [("DUB = HD == 256 ? HD / 4 / DG : 1;",
                  "DUB = HD == 256 ? HD / 4 / DG : 2;")],
        # one batch of all the depth units at every head dim
        "dub_all": [("DUB = HD == 256 ? HD / 4 / DG : 1;",
                     "DUB = HD / 4 / DG;")],
        # one unit a batch at every head dim
        "dub1": [("DUB = HD == 256 ? HD / 4 / DG : 1;", "DUB = 1;")],
        # P V's key loop unrolled by 2 and by 8 (4 in the kernel)
        "pv2": [("#pragma unroll 4\n    for (int j = 0; j < BK; ++j) {",
                 "#pragma unroll 2\n    for (int j = 0; j < BK; ++j) {")],
        "pv8": [("#pragma unroll 4\n    for (int j = 0; j < BK; ++j) {",
                 "#pragma unroll 8\n    for (int j = 0; j < BK; ++j) {")],
        # hd 64 in blocks of 2 warps (BQ 64) and 16-key tiles: 5 blocks an
        # SM, 576 blocks at smollm's prefill
        "hd64_bk16": [("WARPS = HD >= 192 ? 8 : HD >= 64 ? 4 : 1;",
                       "WARPS = HD >= 192 ? 8 : HD >= 128 ? 4 : HD == 64 ? "
                       "2 : 1;"),
                      ("BK = HD <= 32 ? 16 : 32;",
                       "BK = HD <= 32 || HD == 64 ? 16 : 32;")],
        # hd 192 in two blocks of 4 warps an SM (BQ 64) and 16-key tiles
        "hd192_bk16": [("WARPS = HD >= 192 ? 8 : HD >= 64 ? 4 : 1;",
                        "WARPS = HD == 256 ? 8 : HD >= 64 ? 4 : 1;"),
                       ("BK = HD <= 32 ? 16 : 32;",
                        "BK = HD <= 32 || HD == 192 ? 16 : 32;")],
    },
}
SHAPES = {"nemotron-4-340b prefill": dict(B=8, S=512, T=512, H=96, KV=8),
          "ragged S 300 T 333": dict(B=2, S=300, T=333, H=96, KV=8)}
# (shape, window) of each float32 cell; causal throughout
F32_CELLS = {
    "hd 64 smollm-135m": (cs.SERVE_SHAPE, 0),
    "hd 128 qwen3-moe-30b-a3b": (cs.MOE_SHAPE, 0),
    "hd 192 nemotron-4-340b": (cs.NEMOTRON_SHAPE, 0),
    **{f"hd 256 recurrentgemma-9b {label}": (dict(shp, T=shp["S"]),
                                            cs.WINDOW)
       for label, shp in cs.HD256_SHAPES.items()},
}


def entries(lib):
    fn = lib.flash_attention_fwd
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = ([P, P, P, P] + [I] * 7 + [L] * 9
                   + [I, I, ctypes.c_float, P])
    fn.restype = I
    attrs = lib.flash_attention_attrs
    attrs.argtypes = [I, I, ctypes.POINTER(I)]
    attrs.restype = I
    return fn, attrs


def caller(fn):
    def call(q, k, v, causal=True, window=0):
        B, S, H, hd = q.shape
        out = torch.empty_like(q)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 int(q.dtype == torch.bfloat16), B, S, k.shape[1], H,
                 k.shape[2], hd, *q.stride()[:3], *k.stride()[:3],
                 *v.stride()[:3], int(causal), window, hd ** -0.5,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"flash_attention_fwd: cudaError_t {err}")
        return out
    return call


def report_builds(built, dtype, hds) -> dict:
    """Each variant's ptxas report and card attributes at the head dims
    ``hds``; name -> its caller."""
    calls = {}
    bf16 = dtype == torch.bfloat16
    keys = ("registers", "smem", "spill_stores", "spill_loads")
    for name, (lib, usage) in built.items():
        fn, attrs = entries(lib)
        for hd in hds:
            tag = f"ILi{hd}E"
            rows = [{k: r.get(k) for k in keys} for r in usage
                    if tag in r["kernel"]
                    and ("bf16" in r["kernel"]) == bf16]
            out = (ctypes.c_int * len(build.ATTRS))()
            err = attrs(int(bf16), hd, out)
            print(f"{name}: ptxas for the {str(dtype)[6:]} kernel at hd "
                  f"{hd}: {rows}; the card: "
                  f"{dict(zip(build.ATTRS, out)) if not err else err}")
        calls[name] = caller(fn)
    return calls


def held(calls, q, k, v, label, causal=True, window=0) -> None:
    want = ref.attention_ref(q, k, v, causal=causal, window=window)
    tol = cs.TOL[q.dtype]
    for name, call in calls.items():
        got = call(q, k, v, causal, window)
        err = (got.float() - want.float()).abs().max().item()
        ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
        print(f"{name} [{label}] hd {q.shape[3]} {str(q.dtype)[6:]}: "
              f"max_abs_err {err!r} (tol {tol}) "
              f"{'ok' if ok else 'MISMATCH'}")


def bf16_sweep(calls, hd: int, smi: str) -> None:
    for label, shp in SHAPES.items():
        q, k, v = cs.attn_inputs(29, dtype=torch.bfloat16, hd=hd, **shp)
        held(calls, q, k, v, label)
        times = sweeps.interleaved(
            {n: (lambda c=c: c(q, k, v)) for n, c in calls.items()})
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        lib = cs.time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
        flops, nbytes, _ = costs.flash_attention(q, k, v, causal=True)
        bound_ms, by = cs.bound(nbytes, flops, cs.BF16_FLOP_PER_S)
        print(f"[{label}] {tuple(q.shape)} bf16 causal: bound {bound_ms!r} "
              f"ms by {by}; sdpa {cs.spread(lib)} [{smi}]")
        for n, t in times.items():
            print(f"  {n}: {cs.spread(t)}; "
                  f"{bound_ms / statistics.median(t):.4f} of the bound")


def f32_sweep(calls, smi: str) -> None:
    """Every float32 cell: each variant held and timed in turn, then the
    plain version, sdpa in float32 (a boolean mask where there is a
    window) and the bound at the CUDA cores' float32 rate."""
    for i, (label, (shp, window)) in enumerate(F32_CELLS.items()):
        q, k, v = cs.attn_inputs(300 + i, dtype=torch.float32, **shp)
        S, T = q.shape[1], k.shape[1]
        held(calls, q, k, v, label, window=window)
        times = sweeps.interleaved(
            {n: (lambda c=c: c(q, k, v, True, window))
             for n, c in calls.items()})
        heavy = S * T * q.shape[2] * q.shape[0] > 2 ** 30
        plain = cs.time_ms(lambda: ref.attention_ref(q, k, v, window=window),
                           iters=5 if heavy else 20, reps=3)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        if window:
            pos = torch.arange(S, device=cs.CUDA)
            mask = (pos[None, :] <= pos[:, None]) \
                & (pos[None, :] > pos[:, None] - window)
            kw = dict(attn_mask=mask)
        else:
            kw = dict(is_causal=True)
        lib = cs.time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True, **kw), iters=5 if heavy else 20,
            reps=5)
        flops, nbytes, _ = costs.flash_attention(q, k, v, window=window)
        bound_ms, by = cs.bound(nbytes, flops, cs.F32_FLOP_PER_S)
        print(f"[{label}] {tuple(q.shape)} KV {k.shape[2]} float32 causal "
              f"window {window}: bound {bound_ms!r} ms by {by} ({nbytes} "
              f"bytes, {flops:.0f} flop at {cs.F32_FLOP_PER_S:.3g}/s); "
              f"plain {cs.spread(plain)}; sdpa float32 {cs.spread(lib)} "
              f"[{smi}]")
        for n, t in times.items():
            print(f"  {n}: {cs.spread(t)}; "
                  f"{bound_ms / statistics.median(t):.4f} of the bound")
        del q, k, v, qt, kt, vt


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dtype", choices=("bfloat16", "float32"),
                   default="bfloat16")
    p.add_argument("--hd", type=int, default=192,
                   help="the bfloat16 sweep's head dim")
    p.add_argument("--extra", action="append", default=[],
                   metavar="NAME=PATH", help="another flash_attention.cu")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("flash_sweep.py needs a CUDA card")
    dtype = getattr(torch, args.dtype)
    cs.phase_device()
    built = sweeps.build_variants(sweeps.variant_sources(
        "flash_attention.cu", VARIANTS[dtype], args.extra))
    hds = [args.hd] if dtype == torch.bfloat16 else sorted(
        {shp["hd"] for shp, _ in F32_CELLS.values()})
    calls = report_builds(built, dtype, hds)
    smi = cs.smi_line()
    if dtype == torch.bfloat16:
        bf16_sweep(calls, args.hd, smi)
    else:
        f32_sweep(calls, smi)
    print(f"sweep done: {list(calls)}")


if __name__ == "__main__":
    main()
