"""Variants of the row gather (``csrc/take_gather.cu``) on one card: build,
check bit for bit and time each.

    python3 take_sweep.py [--extra NAME=PATH ...]

Each variant is ``src/repro_torch/kernels/csrc/take_gather.cu`` with its
design constants changed (``VARIANTS``), or another source with the same C
entry point ``gather_rows`` (``--extra``, such as an earlier commit's
``take_gather.cu``).  All are built together (``sweeps.py``); ptxas's
registers and spills are printed for each kernel.  At each cell of
``CELLS`` (chip_smoke.py phase 10's four; SF10's rows and indices over
tables of 3.2 to 96 MB, against the H100's 50 MB L2; rows of 64 to 512
bytes) every variant gathers on the path the wrapper takes there (the
dictionary staged in shared memory where it fits, else the word path) and
is held bit for bit to ``torch.index_select`` on the same tensors (a
mismatch is printed, not fatal).  Then each is timed from CUDA-graph
replays, in turn (``sweeps.interleaved``), beside ``index_select`` and the
byte bound of ``kernels/costs.py`` (the indices, each distinct row once,
the output).
"""

from __future__ import annotations

import argparse
import ctypes
import statistics

import torch

import chip_smoke as cs
import sweeps
from repro_torch.kernels import costs, take_gather

# name -> [(text in take_gather.cu, its replacement), ...]; "kernel" is
# the source as it stands
VARIANTS = {
    "kernel": [],
    # every row on PR 16's row-group path
    "no_narrow": [("constexpr bool NARROW = true;",
                   "constexpr bool NARROW = false;")],
}
# (label, table rows R, width W, dtype, M int32 indices, dictionary):
# phase 10's cells, SF10's rows over smaller and larger tables, then rows
# of 64 to 512 bytes
CELLS = [
    ("SF10 orders -> customers rows", cs.N_CUST, 8, torch.float32,
     cs.N_ORDERS, False),
    ("SF10 rows, a 3.2 MB table (fits L2)", 100_000, 8, torch.float32,
     cs.N_ORDERS, False),
    ("SF10 rows, a 24 MB table", 750_000, 8, torch.float32, cs.N_ORDERS,
     False),
    ("SF10 rows, a 96 MB table", 3_000_000, 8, torch.float32, cs.N_ORDERS,
     False),
    ("wide rows", 65_536, 256, torch.float32, 1_048_576, False),
    ("NATION dictionary, in shared memory", len(cs.NATIONS), 16,
     torch.float32, cs.N_ORDERS, True),
    ("large dictionary, through L2", 4096, 128, torch.bfloat16, 4_000_000,
     True),
    ("64-byte rows", 1_048_576, 16, torch.float32, 8_000_000, False),
    ("112-byte rows", 1_048_576, 28, torch.float32, 4_000_000, False),
    ("128-byte rows", 524_288, 32, torch.float32, 4_000_000, False),
    ("144-byte rows", 524_288, 36, torch.float32, 4_000_000, False),
    ("256-byte rows", 262_144, 64, torch.float32, 4_000_000, False),
    ("512-byte rows", 131_072, 128, torch.float32, 2_000_000, False),
]


def entry(lib):
    fn = lib.gather_rows
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [P, L, L, P, I, L, P, I, P]
    fn.restype = I
    return fn


def caller(fn, stage: bool):
    def call(table, idx):
        R, W = table.shape
        out = torch.empty((idx.numel(), W), dtype=table.dtype,
                          device=table.device)
        err = fn(table.data_ptr(), R, W * table.element_size(),
                 idx.data_ptr(), idx.element_size(), idx.numel(),
                 out.data_ptr(), int(stage),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"gather_rows: cudaError_t {err}")
        return out
    return call


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--extra", action="append", default=[],
                   metavar="NAME=PATH", help="another take_gather.cu")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("take_sweep.py needs a CUDA card")
    cs.phase_device()
    built = sweeps.build_variants(sweeps.variant_sources(
        "take_gather.cu", VARIANTS, args.extra))
    for name, (_, usage) in built.items():
        for k in usage:
            print(f"{name} ptxas: {k['kernel']}: {k['registers']} registers,"
                  f" {k['smem']} B static shared memory, spill stores / "
                  f"loads {k.get('spill_stores')} / {k.get('spill_loads')} B")
    smi = cs.smi_line()
    g = torch.Generator(device="cuda").manual_seed(12)
    for label, R, W, dtype, M, dictionary in CELLS:
        table = torch.randn(R, W, generator=g, device="cuda").to(dtype)
        idx = torch.randint(0, R, (M,), generator=g, device="cuda",
                            dtype=torch.int32)
        want = torch.index_select(table, 0, idx)
        stage = dictionary and take_gather.staged(table)
        calls = {}
        for name, (lib, _) in built.items():
            call = caller(entry(lib), stage)
            if not torch.equal(call(table, idx).view(torch.uint8),
                               want.view(torch.uint8)):
                print(f"MISMATCH: {name} [{label}]")
            calls[name] = (lambda c=call: c(table, idx))
        times = sweeps.interleaved(calls)
        library = cs.time_ms(lambda: torch.index_select(table, 0, idx))
        distinct = torch.unique(idx).numel()
        nbytes = costs.row_gather(table, idx, distinct).nbytes
        bound_ms = nbytes / cs.HBM_BYTES_PER_S * 1e3
        print(f"[{label}] {'staged' if stage else 'words'}: R {R} x W {W} "
              f"{str(dtype)[6:]} "
              f"({W * table.element_size()} B rows), M {M} int32: bound "
              f"{bound_ms!r} ms ({nbytes} bytes, {distinct} distinct rows); "
              f"index_select {cs.spread(library)} [{smi}]")
        for n, t in times.items():
            med = statistics.median(t)
            print(f"  {n}: {cs.spread(t)}; {bound_ms / med:.4f} of the "
                  "bound")
        del table, idx, want, calls
        torch.cuda.empty_cache()
    print(f"sweep done: {list(built)}")


if __name__ == "__main__":
    main()
