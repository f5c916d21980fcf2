"""Variants of the segreduce kernel's few-groups path on one card: build,
check and time each at the star query's group-by.

    python3 segreduce_sweep.py [--extra NAME=PATH ...]

Each variant is ``src/repro_torch/kernels/csrc/segreduce.cu`` with one
design choice changed (``VARIANTS``), or another source with the same C
entry point ``segreduce`` (``--extra``, such as an earlier commit's
``segreduce.cu``).  All are built together, one nvcc each, into the
ignored ``kernels/_build/sweep/``.  At the SF10 left join's group-by (n =
15,000,000 orders, G = 26 groups, int64 amount, from seed 0 as in
chip_smoke.py) each computes count, sum, min and max in one call on the
few-groups path, is held bit for bit to ``ref.segreduce_many_ref`` with
and without nulls (a failure is printed, not fatal), and is given an
``order`` that names a row twice, which it should flag (all but
``UNCHECKED``).  Then each is
timed from CUDA-graph replays, forward over the variants and then
backward, twice, so that drift on the card falls on every side; and one
profiled call of each splits its time into the map pass, pass two and
the rest.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import torch

import chip_smoke as cs
from repro_torch.core import vkernels
from repro_torch.kernels import build, ref, relational

# name -> (text in segreduce.cu, its replacement); "kernel" is the source
VARIANTS = {
    "kernel": None,
    # pass two without the check for a row that no position names
    "no_check": ("    bad |= in && m[k] == UNWRITTEN;\n    key[k] = in && "
                 "ok[k] && m[k] != UNWRITTEN ? m[k] : SKIP;",
                 "    key[k] = in && ok[k] ? m[k] : SKIP;"),
    # rows a thread loads before folding, in pass two
    "items8": ("constexpr int PRIVATE_ITEMS = 16;",
               "constexpr int PRIVATE_ITEMS = 8;"),
    "items32": ("constexpr int PRIVATE_ITEMS = 16;",
                "constexpr int PRIVATE_ITEMS = 32;"),
    # sorted positions a thread, in the map pass
    "map4": ("constexpr int MAP_ITEMS = 8;", "constexpr int MAP_ITEMS = 4;"),
    "map16": ("constexpr int MAP_ITEMS = 8;",
              "constexpr int MAP_ITEMS = 16;"),
}
# without the check, a row no position names indexes group 0xFF's slots,
# past the shared memory: such a variant is not given a duplicated order
UNCHECKED = {"no_check"}
SWEEP_DIR = build.BUILD_DIR / "sweep"
ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong] + [ctypes.c_void_p] * 7


def sources(extra) -> dict:
    text = (build.CSRC / "segreduce.cu").read_text()
    out = {}
    for name, edit in VARIANTS.items():
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
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                           str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    # ptxas's lines for pass two at 8-byte values and every op
    lines = proc.stderr.splitlines()
    info = [f"{lines[i - 1].strip()}; {ln.strip()}"
            for i, ln in enumerate(lines) if "Used" in ln and i > 1
            and "private_kernelILi8ELb1ELb1E" in lines[i - 2]]
    fn = ctypes.CDLL(str(lib)).segreduce
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    return fn, info


def star_group_by(seed: int = 0):
    """The left join's group keys and amounts at SF10, drawn as
    chip_smoke.star_tables draws the orders: (order, starts, values,
    validity with about 10 % nulls) on the card."""
    rng = np.random.default_rng(seed)
    cust = rng.integers(0, cs.N_CUST * 11 // 10, cs.N_ORDERS)
    amount = rng.integers(0, 1_000_000, cs.N_ORDERS)
    codes = np.where(cust < cs.N_CUST, cust % 25, 25)
    order, starts = vkernels.group_ranges([codes])
    valid = rng.random(cs.N_ORDERS) >= 0.1
    return tuple(cs.dev(a) for a in (order, starts, amount, valid))


def check(name, fused, order, starts, vals, valid) -> None:
    n = order.numel()
    fails = []
    for m in (None, valid):
        want, counts = ref.segreduce_many_ref(cs.HOWS, vals, order, starts, m)
        words, cnt, twice = fused(order, m)
        if not (torch.equal(cnt, counts) and twice.item() == 0 and all(
                torch.equal(words[h], want[h]) for h in cs.HOWS[1:])):
            fails.append("nulls" if m is not None else "no nulls")
    flagged = "not tried"
    if name not in UNCHECKED:
        dup = order.clone()
        dup[5] = dup[n // 2]
        flagged = fused(dup, None)[2].item() == 1
    print(f"{name}: against segreduce_many_ref bit for bit, differs on: "
          f"{fails or 'none'}; a duplicated order flagged: {flagged}")


def breakdown(call) -> dict:
    """One call's device time by kernel, ms, from torch.profiler."""
    call()
    cs.sync()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        call()
        cs.sync()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", 0) or 0
        if t > 0:
            key = next((k for k in ("map_kernel", "private_kernel",
                                    "init_kernel") if k in e.key), "other")
            out[key] = out.get(key, 0.0) + t / 1e3
    return out or {"device time": "not measured"}


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--extra", action="append", default=[],
                   metavar="NAME=PATH", help="another segreduce.cu")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("segreduce_sweep.py needs a CUDA card")
    cs.phase_device()
    srcs = sources(args.extra)
    with ThreadPoolExecutor(len(srcs)) as pool:
        built = dict(zip(srcs, pool.map(compile_one, srcs, srcs.values())))
    order, starts, vals, valid = star_group_by()
    n, G = order.numel(), starts.numel()
    key = ("segreduce", "segreduce")

    def caller(fn):
        def fused(o=order, m=None):
            with mock.patch.dict(relational._fns, {key: fn}):
                return relational.segreduce_cuda("private", cs.HOWS, vals, o,
                                                 starts, m, n)
        return fused
    calls = {}
    for name, (fn, info) in built.items():
        print(f"{name}: built; ptxas for pass two (8-byte values, every "
              f"op): {info}")
        calls[name] = caller(fn)
        check(name, calls[name], order, starts, vals, valid)
    times = {name: [] for name in calls}
    for names in (list(calls), list(calls)[::-1]) * 2:
        for name in names:
            times[name].append(statistics.median(cs.time_ms(
                calls[name], iters=5, reps=5)))
    smi = cs.smi_line()
    bound = (16 * n + 40 * G) / cs.HBM_BYTES_PER_S * 1e3
    for name, t in times.items():
        print(f"{name}: n={n} G={G} int64, count+sum+min+max in one call on "
              f"the few-groups path, ms (four turns' medians of 5 replays of "
              f"5 calls): {t}, median {statistics.median(t)!r}; bound "
              f"{bound!r} ms; by kernel {breakdown(calls[name])} [{smi}]")
    print(f"sweep done: {list(calls)}")


if __name__ == "__main__":
    main()
