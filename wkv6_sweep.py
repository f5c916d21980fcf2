"""Variants of the WKV-6 kernel on one card: build, check, time, and
their output error on a served rwkv6-3b prefill.

    python3 wkv6_sweep.py [--dtype bfloat16] [--extra NAME=PATH ...] [--served]
    python3 wkv6_sweep.py --dtype float32 [--variants kernel,...] [--extra ...]

Each variant is ``src/repro_torch/kernels/csrc/wkv6.cu`` with one design
constant of ``ChunkTiles`` changed (``VARIANTS``), or another source with
the same C entry point ``wkv6_fwd`` (``--extra``, such as an earlier
commit's ``wkv6.cu``).  All are built together, one nvcc each, into the
ignored ``kernels/_build/sweep/``; ptxas's registers and spills of every
kernel at N 64 are printed.  Each is held to ``ref.wkv6_ref`` at the
bounds of chip_smoke.py phase 7 for the dtype (a failure is printed, not
fatal: a variant may trade accuracy away) and timed at rwkv6-3b's serving
shape (B 8, S 512, H 40, N 64; r, k, v in ``--dtype``) and at one batch
row, from CUDA-graph replays, forward over the variants and then
backward, so that drift on the card falls on every side; in float32 the
plain version is timed beside them, with the bound of
``kernels/costs.py`` for the float32 inputs.

With ``--served``, rwkv6-3b at full width (random weights from seed 0, the
prompts of chip_smoke.py phase 8) runs one bf16 prefill in which every wkv6
launch also goes to each variant and to a float64 recurrence on the same
inputs; the prefill itself goes on with the plain version's output, so that
every variant sees the same inputs.  Per launch and variant: the largest
distance of the bf16 output from the plain version's, how many elements
stand more than one bf16 ulp (of the plain value) from it, and how many
are not the float64 value correctly rounded.  Then the prefill's last
logits with wkv6 taken from each variant, from the plain version and from
the float64 recurrence rounded to bf16, against the plain path's (rel L2,
and how many of the 8 rows' argmax agree).
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import torch

import chip_smoke as cs
from repro_torch.kernels import build, costs, ops, ref

# name -> (text in wkv6.cu, its replacement); "kernel" is the source as is
VARIANTS = {
    "kernel": None,
    # each head's columns over two blocks (640 blocks at the serving shape)
    "two_blocks": ("static constexpr int NV = N;",
                   "static constexpr int NV = N >= 32 ? N / 2 : N;"),
    # a fourth input stage in bf16, a third in float32: copies two chunks
    # ahead
    "stages_plus1": ("static constexpr int STAGES = F32 ? 2 : 3;",
                     "static constexpr int STAGES = F32 ? 3 : 4;"),
    # two bf16 parts of each f32 operand (three products a pair of them)
    "two_parts": ("static constexpr int PARTS = 3;",
                  "static constexpr int PARTS = 2;"),
}
SWEEP_DIR = build.BUILD_DIR / "sweep"
CASES = [(dict(B=2, S=S, H=3, N=64), decay)
         for S in (1, 17, 512) for decay in ("near 1", "model", "tiny",
                                             "mixed")]


def sources(extra, names) -> dict:
    text = (build.CSRC / "wkv6.cu").read_text()
    out = {}
    for name, edit in VARIANTS.items():
        if name not in names:
            continue
        if edit is not None:
            assert text.count(edit[0]) == 1, f"{name}: {edit[0]!r} not found"
        out[name] = text if edit is None else text.replace(*edit)
    for item in extra:
        name, path = item.split("=", 1)
        out[name] = open(path).read()
    return out


def compile_one(name: str, text: str):
    SWEEP_DIR.mkdir(parents=True, exist_ok=True)
    src, lib = SWEEP_DIR / f"{name}.cu", SWEEP_DIR / f"{name}.so"
    src.write_text(text)
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v",
                           "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    # ptxas's report of each kernel's N 64 instantiation
    info = [{k: r.get(k) for k in ("kernel", "registers", "smem",
                                   "spill_stores", "spill_loads")}
            for r in build.parse_ptxas(proc.stderr) if "Li64E" in r["kernel"]]
    fn = ctypes.CDLL(str(lib)).wkv6_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, info


def caller(fn):
    """``ops.wkv6`` on contiguous CUDA tensors, through this library."""
    def call(r, k, v, w, u, state=None):
        B, S, H, N = r.shape
        r, k, v, w, u = (t.contiguous() for t in (r, k, v, w, u))
        out = torch.empty_like(r)
        s_out = torch.empty((B, H, N, N), dtype=torch.float32,
                            device=r.device)
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), None if state is None else
                 state.contiguous().data_ptr(), out.data_ptr(),
                 s_out.data_ptr(), int(r.dtype == torch.bfloat16), B, S, H,
                 N, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"wkv6_fwd: cudaError_t {err}")
        return out, s_out
    return call


def check(name, call, dtype) -> None:
    g = torch.Generator(device="cuda").manual_seed(7)
    worst, fails = [0.0, 0.0], []
    tol = cs.WKV_TOL[dtype]
    for shp, decay in CASES:
        r, k, v, w, u, st = cs.wkv_inputs(g, dtype=dtype, decay=decay, **shp)
        out, s_out = call(r, k, v, w, u, st)
        want, want_s = ref.wkv6_ref(r, k, v, w, u, st)
        e = ((out.float() - want.float()).abs().max().item(),
             (s_out - want_s).abs().max().item())
        worst = [max(a, b) for a, b in zip(worst, e)]
        if not (torch.allclose(out.float(), want.float(), rtol=tol, atol=tol)
                and torch.allclose(s_out, want_s, rtol=1e-4, atol=1e-4)):
            fails.append(f"S {shp['S']} {decay}: out {e[0]!r} state {e[1]!r}")
    print(f"{name}: {len(CASES)} {str(dtype)[6:]} cases against wkv6_ref, "
          f"max_abs_err out {worst[0]!r} state {worst[1]!r}; outside the "
          f"bounds ({tol} out, 1e-4 state): {fails or 'none'}")


def times(calls, dtype) -> None:
    g = torch.Generator(device="cuda").manual_seed(8)
    r, k, v, w, u, _ = cs.wkv_inputs(g, dtype=dtype, decay="model",
                                     **cs.WKV_SHAPE)
    B, _, H, N = r.shape
    st = torch.zeros(B, H, N, N, device="cuda")
    full = {n: [] for n in calls}
    one = {n: [] for n in calls}
    order = list(calls) + list(calls)[::-1]
    for name in order:
        call = calls[name]
        full[name] += cs.time_ms(lambda: call(r, k, v, w, u, st))
        one[name] += cs.time_ms(lambda: call(r[:1], k[:1], v[:1], w[:1], u,
                                             st[:1]))
    smi = cs.smi_line()
    kind = str(dtype)[6:]
    for name in calls:
        print(f"{name}: B 8 S 512 H 40 N 64 {kind} {cs.spread(full[name])}; "
              f"one batch row {cs.spread(one[name])} [{smi}]")
    if dtype == torch.float32:
        plain = cs.time_ms(lambda: ref.wkv6_ref(r, k, v, w, u, st), iters=2,
                           reps=3)
        flops, nbytes, _ = costs.wkv6(r, k, v, w, u, st)
        bound_ms, by = cs.bound(nbytes, flops, cs.F32_FLOP_PER_S)
        print(f"plain (float32): {cs.spread(plain)}; bound {bound_ms!r} ms "
              f"by {by} ({nbytes} bytes, {flops} flop; operations at "
              f"{cs.F32_FLOP_PER_S:.3g}/s) [{smi}]")


def served(calls) -> None:
    cfg, api = cs.build_model("rwkv6-3b")
    rng = np.random.default_rng(1)
    rounds = [cs.prompts(rng, cfg, 8, 256, 512, 32) for _ in range(2)]
    engine = cs.ServeEngine(api, batch=8, max_seq=1024)
    tokens = torch.from_numpy(cs.pad_prompts(rounds[0], 8)).to("cuda")
    total = {n: [0.0, 0, 0] for n in ["plain", *calls]}
    launch = [0]

    def recorder(r, k, v, w, u, state=None):
        want, want_s = ref.wkv6_ref(r, k, v, w, u, state)
        exact, _ = cs.wkv6_f64(r.double(), k.double(), v.double(), w, u,
                               state)
        rounded = exact.to(torch.bfloat16)
        parts = []
        for name, out in [("plain", want)] + [
                (n, c(r, k, v, w, u, state)[0]) for n, c in calls.items()]:
            row = ((out.float() - want.float()).abs().max().item(),
                   int((cs.ulps_from(out, want) > 1).sum()),
                   int((out != rounded).sum()))
            t = total[name]
            total[name] = [max(t[0], row[0]), t[1] + row[1], t[2] + row[2]]
            parts.append(f"{name} {row[0]:.4g}/{row[1]}/{row[2]}")
        print(f"launch {launch[0]}: " + ", ".join(parts))
        launch[0] += 1
        return want, want_s

    print(f"every wkv6 launch of a bf16 rwkv6-3b prefill {tuple(tokens.shape)}"
          ": per variant, max |out - plain| / elements more than one bf16 ulp "
          "(of the plain value) from plain / elements not the float64 value "
          "correctly rounded, of "
          f"{tokens.numel() * cfg.d_model} outputs a launch")
    with cs.compute_dtype(api, torch.bfloat16), \
            mock.patch.object(ops, "wkv6", recorder):
        api.prefill({"tokens": tokens}, engine.shape)
    for name, (mx, over, wrong) in total.items():
        print(f"{name} over {launch[0]} launches: max |out - plain| {mx!r},"
              f" {over} elements more than one ulp from plain, {wrong} not "
              "the float64 value correctly rounded")

    def rounded64(r, k, v, w, u, state=None):
        out, st = cs.wkv6_f64(r.double(), k.double(), v.double(), w, u, state)
        return out.to(r.dtype), st.float()
    logits = {}
    for name, fn in [("plain", ref.wkv6_ref), ("float64 rounded", rounded64),
                     *calls.items()]:
        with cs.compute_dtype(api, torch.bfloat16), \
                mock.patch.object(ops, "wkv6", fn):
            logits[name] = api.prefill({"tokens": tokens}, engine.shape)[0]
    base = logits["plain"]
    for name, lg in logits.items():
        agree = (lg[:, -1].argmax(-1) == base[:, -1].argmax(-1)).sum().item()
        print(f"bf16 prefill logits, wkv6 from {name} vs plain: rel L2 "
              f"{cs.rel_l2(lg, base)!r}, max |diff| / max |logit| "
              f"{cs.rel_max(lg, base)!r}, argmax agrees on {agree}/8")


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dtype", choices=("bfloat16", "float32"),
                   default="bfloat16", help="r, k and v's dtype")
    p.add_argument("--extra", action="append", default=[],
                   metavar="NAME=PATH", help="another wkv6.cu to compare")
    p.add_argument("--variants", default=",".join(VARIANTS),
                   help="comma-separated names of VARIANTS to build")
    p.add_argument("--served", action="store_true",
                   help="also the per-launch error in a served prefill")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("wkv6_sweep.py needs a CUDA card")
    dtype = getattr(torch, args.dtype)
    cs.phase_device()
    srcs = sources(args.extra, args.variants.split(","))
    with ThreadPoolExecutor(len(srcs)) as pool:
        built = dict(zip(srcs, pool.map(compile_one, srcs, srcs.values())))
    calls = {}
    for name, (fn, info) in built.items():
        print(f"{name}: built; ptxas for the kernels at N 64: {info}")
        calls[name] = caller(fn)
    for name, call in calls.items():
        check(name, call, dtype)
    times(calls, dtype)
    if args.served and dtype == torch.bfloat16:
        served(calls)
    print(f"sweep done: {list(calls)}")


if __name__ == "__main__":
    main()
