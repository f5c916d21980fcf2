"""Kernel dispatch: the numpy <-> tensor edge of the relational hot path.

The port's counterpart of the JAX package's ``core/kdispatch.py``.  Key
hashing, join gathers and the integer segment reducers of ``core/ops.py``
run through here; ``grouped_reduce`` takes every aggregate of one column
to the device in one call.  The contract is the reference's: numpy arrays
in and out, with the same signatures as ``core/vkernels.py``; each call
copies its arrays to the device, runs the wrapper of
``repro_torch.kernels.ops`` and copies the result back.  The wrapper
launches the hand-written CUDA kernel for data on the card and the
kernel's plain PyTorch version for data on the CPU.

**Device.**  The default device is ``cuda``.  The CPU is taken only on
request, by ``set_device("cpu")`` or ``with using_device("cpu")``; no
environment variable is read.  With ``cuda`` asked for and no card
present, the first dispatch raises ``RuntimeError``: there is no warning
and no numpy fallback.

**Registry.**  ``REGISTRY`` has the reference's entries and reasons.  A
kernel enters it as eligible only when its results are bit-identical to
``vkernels`` across dtypes, nulls, duplicates and empties
(``tests/test_torch_relational.py`` on the CPU, ``chip_smoke.py`` and
``tests/test_torch_gpu.py`` on the card).  Kernels that *cannot* meet the
contract are documented ineligible with their reason and are served by
``vkernels`` on every device: the float segment reductions, whose
contract (``vkernels.grouped_sum`` / ``_grouped_extreme``) fixes a
sequential accumulation order (``np.bincount``
original-row-order for sums; left-to-right ``reduceat`` ties for min/max
over -0.0/NaN) that a block-parallel reduction cannot reproduce
bit-for-bit.  Var-length ``(offsets, values)`` keys of ``hash_keys`` go to
``vkernels`` structurally, as in the reference.

**No demotion.**  ``self_check()`` re-runs a compact differential on the
current device and raises on the first kernel whose bits diverge, naming
it.  Nothing is demoted at runtime.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, Iterator, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..kernels import ops as kops
from ..kernels import ref
from . import vkernels

__all__ = [
    "DEVICES", "REGISTRY", "Eligibility", "set_device", "using_device",
    "device", "eligible", "self_check",
    "hash_fixed", "combine_hashes", "hash_keys", "filter_join_gather",
    "gather_payload", "grouped_reduce", "GROUPED_REDUCERS",
]

DEVICES = ("cuda", "cpu")


# --------------------------------------------------------------------------
# device: cuda by default, the CPU only on request
# --------------------------------------------------------------------------

_device = "cuda"


def set_device(name: str) -> None:
    """Run the relational kernels on ``name``: ``cuda`` (the default) or
    ``cpu`` (their plain PyTorch versions).  Process-wide."""
    global _device
    if name not in DEVICES:
        raise ValueError(f"device {name!r}: choose one of {DEVICES}")
    _device = name


@contextlib.contextmanager
def using_device(name: str) -> Iterator[None]:
    """``set_device(name)`` for the body of a ``with`` block."""
    prev = _device
    set_device(name)
    try:
        yield
    finally:
        set_device(prev)


def device() -> torch.device:
    """The device calls run on; raises ``RuntimeError`` when it is
    ``cuda`` and no card is present."""
    return resolve_device(_device)


# --------------------------------------------------------------------------
# eligibility registry: bit-identity admission, documented refusals
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class Eligibility:
    eligible: bool
    reason: str


#: keyed ``kernel`` or ``kernel:dtypeclass`` (``int`` covers bool and all
#: integer widths, ``float`` all floats).  A kernel/dtype pair absent
#: from the registry is NOT admitted — numpy serves it.
REGISTRY: Dict[str, Eligibility] = {
    "hash_fixed": Eligibility(True,
        "splitmix64 over bit patterns: wrapping uint64 multiply and "
        "xor-shift are exact on every backend"),
    "combine_hashes": Eligibility(True,
        "ordered uint64 fold, same per-element exactness as hash_fixed"),
    "hash_keys": Eligibility(True,
        "fused per-column mix + ordered combine over fixed-width key "
        "buffers; var-length (offsets, values) keys route to numpy "
        "structurally (not expressible as a dense block kernel)"),
    "filter_join_gather": Eligibility(True,
        "index gather with -1 sentinel passthrough: no arithmetic"),
    "gather_payload": Eligibility(True,
        "payload-column gather with -1 fill: no arithmetic"),
    "grouped_count": Eligibility(True,
        "integer segment count: exact in any accumulation order"),
    "grouped_sum:int": Eligibility(True,
        "integer segment sum: associative and exact, any block order "
        "reproduces reduceat bits"),
    "grouped_sum:float": Eligibility(False,
        "sequential-sum contract: float sums accumulate sequentially in "
        "original row order (np.bincount); block-parallel reduction "
        "reorders the additions and changes low-order bits — "
        "position-dependent accumulation must not silently change "
        "results"),
    "grouped_min:int": Eligibility(True,
        "integer extremes are order-free"),
    "grouped_min:float": Eligibility(False,
        "-0.0/+0.0 ties and NaN propagation resolve by reduction order; "
        "the contract is reduceat's left-to-right result"),
    "grouped_max:int": Eligibility(True,
        "integer extremes are order-free"),
    "grouped_max:float": Eligibility(False,
        "-0.0/+0.0 ties and NaN propagation resolve by reduction order; "
        "the contract is reduceat's left-to-right result"),
    "grouped_mean": Eligibility(False,
        "composes the float segment sum, inheriting its sequential-"
        "accumulation contract"),
}


def _dtype_class(dt) -> str:
    dt = np.dtype(dt)
    return "float" if np.issubdtype(dt, np.floating) else "int"


def _registry_key(kernel: str, dtype=None) -> str:
    if dtype is not None and f"{kernel}:{_dtype_class(dtype)}" in REGISTRY:
        return f"{kernel}:{_dtype_class(dtype)}"
    return kernel


def eligible(kernel: str, dtype=None) -> bool:
    """Is this kernel (for this value dtype, if reductions) admitted?
    False for documented-ineligible entries and unknown kernels."""
    e = REGISTRY.get(_registry_key(kernel, dtype))
    return bool(e and e.eligible)


# --------------------------------------------------------------------------
# the edge: numpy arrays <-> tensors on the device
# --------------------------------------------------------------------------

_UNSIGNED = {2: torch.uint16, 4: torch.uint32, 8: torch.uint64}


def _to_tensor(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """``a`` on ``dev`` (a copy on the card, shared memory on the CPU) with
    the same dtype and bits.  Unsigned arrays wider than a byte cross as a
    signed view of the same width (``torch.from_numpy`` of them is uneven
    across torch versions)."""
    a = np.ascontiguousarray(a)
    if a.dtype.kind not in "biuf":
        raise TypeError(f"no relational kernel takes dtype {a.dtype}")
    if not a.flags.writeable:      # torch.from_numpy wants a writable array
        a = a.copy()
    if a.dtype.kind == "u" and a.dtype.itemsize > 1:
        return torch.from_numpy(a.view(f"i{a.dtype.itemsize}")).to(dev) \
            .view(_UNSIGNED[a.dtype.itemsize])
    return torch.from_numpy(a).to(dev)


def _to_numpy(t: torch.Tensor, dtype) -> np.ndarray:
    """The tensor's bits, on the host, as a numpy array of ``dtype`` (of
    the tensor's element width)."""
    if t.dtype in _UNSIGNED.values():
        t = t.view(ref.SIGNED[t.element_size()])
    return t.cpu().numpy().view(dtype)


def _index(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return _to_tensor(np.asarray(a, dtype=np.int64), dev)


def _prep_bits(values: np.ndarray) -> np.ndarray:
    """Bit-pattern prep shared with ``vkernels.hash_fixed``: float -0.0
    made +0.0, then the raw bits widened to uint64 (the host side of the
    fused ``hash_keys``, as in the reference)."""
    values = np.ascontiguousarray(values)
    if np.issubdtype(values.dtype, np.floating):
        values = np.where(values == 0, 0, values)
    w = values.dtype.itemsize
    return np.ascontiguousarray(values).view(f"u{w}").astype(np.uint64) \
        if w < 8 else np.ascontiguousarray(values).view(np.uint64)


# --------------------------------------------------------------------------
# dispatchers (numpy arrays in and out; signatures mirror vkernels)
# --------------------------------------------------------------------------

# Only the reducers consult the registry per call: every other entry is
# eligible for every dtype.

def hash_fixed(values: np.ndarray) -> np.ndarray:
    h = kops.hash_fixed(_to_tensor(values, device()))
    return _to_numpy(h, np.uint64)


def _combine(cols: np.ndarray, mix_first: bool) -> np.ndarray:
    t = _to_tensor(cols.view(np.int64), device())
    return _to_numpy(kops.combine_hashes(t, mix_first), np.uint64)


def _stack(cols: Sequence[np.ndarray], n: int) -> np.ndarray:
    if not cols:
        return np.empty((0, n), dtype=np.uint64)
    out = np.stack(cols)
    if out.shape[1] != n:
        raise ValueError(f"key columns of {out.shape[1]} rows for n={n}")
    return out


def combine_hashes(col_hashes: Sequence[np.ndarray], n: int) -> np.ndarray:
    return _combine(_stack([np.asarray(h, dtype=np.uint64)
                            for h in col_hashes], n), mix_first=False)


def hash_keys(keys: Sequence, n: int) -> np.ndarray:
    # var-length (offsets, values) keys are structurally numpy-only
    if any(isinstance(k, tuple) for k in keys):
        return vkernels.hash_keys(list(keys), n)
    return _combine(_stack([_prep_bits(k) for k in keys], n),
                    mix_first=True)


def filter_join_gather(sel: np.ndarray, idx: np.ndarray) -> np.ndarray:
    dev = device()
    out = kops.filter_join_gather(_index(sel, dev), _index(idx, dev))
    return _to_numpy(out, np.int64)


def gather_payload(values: np.ndarray, idx: np.ndarray,
                   fill=0) -> np.ndarray:
    dev = device()
    out = kops.gather_payload(_to_tensor(values, dev), _index(idx, dev),
                              fill)
    return _to_numpy(out, values.dtype)


def _extreme_dtype(dt) -> np.dtype:
    return np.dtype(np.uint8) if dt == np.bool_ else np.dtype(dt)


def grouped_reduce(values: np.ndarray, order: np.ndarray, starts: np.ndarray,
                   valid, hows: Sequence[str]) -> Dict[str, tuple]:
    """Every aggregate in ``hows`` of one column: {how: (values, counts)},
    each pair as ``vkernels.GROUPED_REDUCERS[how]`` returns it.  The
    aggregates the registry admits (the count, integer and bool sum / min /
    max) run in one ``kops.grouped_reduce`` call, which copies order,
    starts, values and valid to the device once (a count alone with no
    validity mask: starts alone); the ones it refuses (float sum / min /
    max, mean) go to ``vkernels`` one by one."""
    hows = list(dict.fromkeys(hows))
    kern = [h for h in hows if h == "count" or (
        h in ("sum", "min", "max") and eligible(f"grouped_{h}",
                                                values.dtype))]
    out = {h: vkernels.GROUPED_REDUCERS[h](values, order, starts, valid)
           for h in hows if h not in kern}
    if kern:
        dev = device()
        count_only = kern == ["count"]
        res, counts = kops.grouped_reduce(
            None if count_only else _to_tensor(values, dev),
            None if count_only and valid is None else _index(order, dev),
            _index(starts, dev),
            None if valid is None
            else _to_tensor(np.asarray(valid, dtype=bool), dev),
            kern, n=len(order))
        counts = _to_numpy(counts, np.int64)
        for h in kern:
            if h == "count":
                out[h] = (counts, counts)
                continue
            dt = _extreme_dtype(values.dtype) if h != "sum" else \
                np.uint64 if values.dtype == np.uint64 else np.int64
            out[h] = (_to_numpy(res[h], dt), counts)
    return {h: out[h] for h in hows}


def _reducer(how: str):
    def reduce(values, order, starts, valid=None):
        return grouped_reduce(values, order, starts, valid, [how])[how]
    reduce.__name__ = f"grouped_{how}"
    return reduce


#: drop-in for ``vkernels.GROUPED_REDUCERS`` with per-dtype dispatch: each
#: a one-op call of ``grouped_reduce``
GROUPED_REDUCERS = {how: _reducer(how)
                    for how in ("count", "sum", "min", "max", "mean")}


# --------------------------------------------------------------------------
# in-process differential: raise on the first kernel whose bits diverge
# --------------------------------------------------------------------------

def self_check(n: int = 4096, n_groups: int = 97) -> Dict[str, str]:
    """Compact differential over adversarial seeded inputs, on the current
    device: every *eligible* registry entry runs against ``vkernels`` and
    must match bit for bit (values and dtypes).  The first mismatch raises
    ``RuntimeError`` naming the kernel; nothing is demoted.  Returns
    ``"ok"`` per eligible key and the documented reason per ineligible
    one."""
    results: Dict[str, str] = {}
    rng = np.random.default_rng(0)
    f64 = rng.standard_normal(n)
    f64[rng.random(n) < 0.1] = -0.0
    f64[rng.random(n) < 0.05] = np.nan
    cols = {
        "int32": rng.integers(-50, 50, n).astype(np.int32),
        "int64": rng.integers(-(1 << 62), 1 << 62, n, dtype=np.int64),
        "uint64": rng.integers(0, 1 << 64, n, dtype=np.uint64),
        "float64": f64,
        "bool": rng.random(n) < 0.5,
    }
    valid = rng.random(n) < 0.8
    codes = rng.integers(0, n_groups, n)
    order, starts = vkernels.group_ranges([codes])
    sel = np.nonzero(rng.random(n // 2) < 0.5)[0]
    idx = rng.integers(-1, len(sel), n).astype(np.int64)
    pidx = rng.integers(-1, n, n).astype(np.int64)

    def check(key: str, got, want) -> None:
        gv, gc = got if isinstance(got, tuple) else (got, None)
        wv, wc = want if isinstance(want, tuple) else (want, None)
        same = (gv.dtype == wv.dtype
                and np.array_equal(gv, wv, equal_nan=True)
                and (gc is None or (gc.dtype == wc.dtype
                                    and np.array_equal(gc, wc))))
        if not same:
            raise RuntimeError(
                f"self_check: kernel {key} on {device()} does not match "
                f"vkernels bit for bit ({gv.dtype} vs {wv.dtype})")
        results[key] = "ok"

    for v in cols.values():
        check("hash_fixed", hash_fixed(v), vkernels.hash_fixed(v))
    hs = [vkernels.hash_fixed(cols["int64"]),
          vkernels.hash_fixed(cols["float64"]),
          vkernels.hash_fixed(cols["uint64"])]
    check("combine_hashes", combine_hashes(hs, n),
          vkernels.combine_hashes(hs, n))
    ks = [cols["int64"], cols["float64"], cols["int32"]]
    check("hash_keys", hash_keys(ks, n), vkernels.hash_keys(ks, n))
    check("filter_join_gather", filter_join_gather(sel, idx),
          vkernels.filter_join_gather(sel, idx))
    check("gather_payload", gather_payload(cols["int64"], pidx, 0),
          np.where(pidx >= 0, cols["int64"][np.where(pidx >= 0, pidx, 0)],
                   0))
    red = GROUPED_REDUCERS
    check("grouped_count", red["count"](cols["int64"], order, starts, valid),
          vkernels.grouped_count(cols["int64"], order, starts, valid))
    for name in ("int32", "int64", "uint64", "bool"):
        v = cols[name]
        fused = grouped_reduce(v, order, starts, valid,
                               ["count", "sum", "min", "max"])
        for how in ("sum", "min", "max"):
            want = vkernels.GROUPED_REDUCERS[how](v, order, starts, valid)
            check(f"grouped_{how}:int", red[how](v, order, starts, valid),
                  want)
            check(f"grouped_{how}:int", fused[how], want)
        check("grouped_count", fused["count"],
              vkernels.grouped_count(v, order, starts, valid))
    for key, e in REGISTRY.items():
        if not e.eligible:
            results[key] = f"ineligible: {e.reason}"
    return results
