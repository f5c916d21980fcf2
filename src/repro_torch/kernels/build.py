"""Build the hand-written CUDA kernels and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
with ``nvcc`` for ``sm_90a`` into ``_build/<name>-<hash>.so`` inside this
package (``.gitignore`` lists it).  The hash is of the source and the
flags, so an edited source is rebuilt and never served stale.  Nothing is
built at import: the first ``load(name)`` builds, or ``build_all`` builds
several sources at once, one ``nvcc`` each.  What ptxas reports of each
kernel (``-Xptxas -v``) is kept beside the library (``ptxas_usage``).  A
failed build raises with the compiler's output.  There is no prebuilt
fallback: only the repository's sources are compiled.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or at /usr/local/cuda/bin/nvcc: the "
            "CUDA kernels of repro_torch are built from source at first use")
    return path


def _source(name: str) -> bytes:
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(f"no kernel source {src}")
    return src.read_bytes()


def source_sha256(name: str) -> str:
    """sha256 of ``csrc/<name>.cu`` as it stands (the core's fingerprints
    fold it in, so an edited kernel invalidates the cached outputs of the
    ops that launch it)."""
    return hashlib.sha256(_source(name)).hexdigest()


def library_path(name: str) -> Path:
    h = hashlib.sha256(_source(name) + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _compile(name: str) -> None:
    """Compile ``csrc/<name>.cu`` unless its library exists; raises with
    the compiler's output if nvcc fails."""
    out = library_path(name)
    if out.exists():
        return
    compiler = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run(
        [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {name} (exit "
                           f"{proc.returncode}):\n{proc.stdout}")
    out.with_suffix(".log").write_text(proc.stdout)
    os.replace(tmp, out)    # atomic: others see all or none


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it on first use."""
    lib = _loaded.get(name)
    if lib is None:
        _compile(name)
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def build_all(names: Sequence[str]) -> Dict[str, float]:
    """Build and load several sources with one nvcc each, all running
    together (``subprocess.run`` releases the GIL); returns each one's
    seconds from the common start until its library was loaded.  Raises
    the first failure."""
    t0 = time.perf_counter()

    def timed_load(name: str) -> float:
        load(name)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(max(len(names), 1)) as pool:
        return dict(zip(names, pool.map(timed_load, names)))


def ptxas_usage(name: str) -> List[dict]:
    """What ptxas reported (``-Xptxas -v``) for each kernel of the built
    ``csrc/<name>.cu`` (``parse_ptxas``)."""
    return parse_ptxas(library_path(name).with_suffix(".log").read_text())


def parse_ptxas(log: str) -> List[dict]:
    """Each kernel of a ptxas report (``-Xptxas -v``): its mangled name,
    registers a thread, static shared memory bytes a block, stack frame
    and spill store and load bytes a thread."""
    kernels, cur = [], {}
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = {"kernel": m.group(1)}
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur:
            cur.update(zip(("stack", "spill_stores", "spill_loads"),
                           map(int, m.groups())))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            smem = re.search(r"(\d+) bytes smem", line)
            kernels.append(dict(cur, registers=int(m.group(1)),
                                smem=int(smem.group(1)) if smem else 0))
            cur = {}
    return kernels


ATTRS = ("registers", "dynamic_smem", "static_smem", "local_bytes",
         "threads", "blocks_per_sm")


def kernel_attrs(name: str, bf16: bool, size: int) -> dict:
    """What the card reports for the kernel that ``csrc/<name>.cu`` launches
    for a dtype (bf16 or float32) and a template size (head dim, head
    size), through its ``<name>_attrs(is_bf16, size, out)`` entry point:
    registers and local (spill) bytes a thread, dynamic and static shared
    memory bytes and threads a block, blocks resident on one SM."""
    fn = getattr(load(name), f"{name}_attrs")
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * len(ATTRS))()
    err = fn(int(bf16), size, out)
    if err != 0:
        raise RuntimeError(f"{name}_attrs failed: cudaError_t {err} "
                           f"(bf16 {bf16}, size {size})")
    return dict(zip(ATTRS, out))
