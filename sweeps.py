"""What the kernel sweeps ``take_sweep.py`` and ``flash_sweep.py`` share:
variants of a kernel's source, built together (one nvcc each), and their
times taken in turn so that drift on the card falls on every variant.

Not run on its own; each sweep imports it on a card:

    python3 take_sweep.py        python3 flash_sweep.py
"""

from __future__ import annotations

import ctypes
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import chip_smoke as cs
from repro_torch.kernels import build

SWEEP_DIR = build.BUILD_DIR / "sweep"


def variant_sources(cu: str, variants: dict, extra) -> dict:
    """``csrc/<cu>`` once for each variant, ``variants`` mapping a name to
    its edits ``[(text, replacement), ...]`` (none: the source as it
    stands), then each ``NAME=PATH`` of ``extra`` (another source with the
    same C entry point, such as an earlier commit's)."""
    text = (build.CSRC / cu).read_text()
    out = {}
    for name, edits in variants.items():
        out[name] = text
        for old, new in edits:
            assert text.count(old) == 1, f"{name}: {old!r} not found"
            out[name] = out[name].replace(old, new)
    for item in extra:
        name, path = item.split("=", 1)
        out[name] = Path(path).read_text()
    return out


def _compile(name: str, text: str):
    SWEEP_DIR.mkdir(parents=True, exist_ok=True)
    src, lib = SWEEP_DIR / f"{name}.cu", SWEEP_DIR / f"{name}.so"
    src.write_text(text)
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                           str(src)], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stdout}")
    return ctypes.CDLL(str(lib)), build.parse_ptxas(proc.stdout)


def build_variants(srcs: dict) -> dict:
    """Each source of ``srcs`` built into the ignored ``kernels/_build/
    sweep/``, all at once: name -> (the loaded library, ptxas's report of
    each kernel, as ``build.parse_ptxas`` gives it)."""
    with ThreadPoolExecutor(len(srcs)) as pool:
        return dict(zip(srcs, pool.map(_compile, srcs, srcs.values())))


def interleaved(calls: dict) -> dict:
    """name -> ``chip_smoke.time_ms`` of ``calls[name]()``, taken forward
    over the variants and then backward (14 graph replays each)."""
    times = {n: [] for n in calls}
    for n in list(calls) + list(calls)[::-1]:
        times[n] += cs.time_ms(calls[n])
    return times
