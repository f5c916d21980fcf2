"""Tile variants of the bf16 flash kernel at one head dim on one card:
build, check and time each at a served prefill shape.

    python3 flash_sweep.py [--hd 192] [--extra NAME=PATH ...]

Each variant is ``src/repro_torch/kernels/csrc/flash_attention.cu`` with
one line of ``Bf16Tiles`` changed (``VARIANTS``: the other KV tile depth),
or another source with the same C entry point ``flash_attention_fwd``
(``--extra``).  All are built together (``sweeps.py``); ptxas's
registers, shared memory and spills of the bf16 kernel at the head dim
are printed, with the blocks an SM the card reports.  At nemotron-4-340b's prefill (``SHAPES``: B 8, S = T 512,
96 query and 8 KV heads of 192, causal) and at a ragged cut of it, each is
held to ``ref.attention_ref`` at chip_smoke.py's bf16 bound (a failure is
printed, not fatal), then timed from CUDA-graph replays in turn
(``sweeps.interleaved``), beside ``scaled_dot_product_attention`` and the
bound of ``kernels/costs.py``.
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

# name -> [(text in flash_attention.cu, its replacement)]
VARIANTS = {
    "kernel": [],
    # KV tiles of 64 keys up to hd 192 (32 from hd 256 on)
    "bk64": [("static constexpr int BK = HD >= 192 ? 32 : 64;",
              "static constexpr int BK = HD >= 256 ? 32 : 64;")],
}
SHAPES = {"nemotron-4-340b prefill": dict(B=8, S=512, T=512, H=96, KV=8),
          "ragged S 300 T 333": dict(B=2, S=300, T=333, H=96, KV=8)}


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
    def call(q, k, v, causal=True):
        B, S, H, hd = q.shape
        out = torch.empty_like(q)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 int(q.dtype == torch.bfloat16), B, S, k.shape[1], H,
                 k.shape[2], hd, *q.stride()[:3], *k.stride()[:3],
                 *v.stride()[:3], int(causal), 0, hd ** -0.5,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"flash_attention_fwd: cudaError_t {err}")
        return out
    return call


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--hd", type=int, default=192)
    p.add_argument("--extra", action="append", default=[],
                   metavar="NAME=PATH", help="another flash_attention.cu")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("flash_sweep.py needs a CUDA card")
    cs.phase_device()
    built = sweeps.build_variants(sweeps.variant_sources(
        "flash_attention.cu", VARIANTS, args.extra))
    calls = {}
    for name, (lib, usage) in built.items():
        fn, attrs = entries(lib)
        tag = f"flash_fwd_bf16_kernelILi{args.hd}E"
        keys = ("registers", "smem", "spill_stores", "spill_loads")
        rows = [{k: r.get(k) for k in keys} for r in usage
                if tag in r["kernel"]]
        out = (ctypes.c_int * len(build.ATTRS))()
        err = attrs(1, args.hd, out)
        print(f"{name}: ptxas for the bf16 kernel at hd {args.hd}: {rows}; "
              f"the card: {dict(zip(build.ATTRS, out)) if not err else err}")
        calls[name] = caller(fn)
    smi = cs.smi_line()
    for label, shp in SHAPES.items():
        q, k, v = cs.attn_inputs(29, dtype=torch.bfloat16, hd=args.hd, **shp)
        want = ref.attention_ref(q, k, v, causal=True)
        tol = cs.TOL[torch.bfloat16]
        for name, call in calls.items():
            got = call(q, k, v)
            err = (got.float() - want.float()).abs().max().item()
            ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
            print(f"{name} [{label}] hd {args.hd}: max_abs_err {err!r} "
                  f"(tol {tol}) {'ok' if ok else 'MISMATCH'}")
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
    print(f"sweep done: {list(calls)}")


if __name__ == "__main__":
    main()
