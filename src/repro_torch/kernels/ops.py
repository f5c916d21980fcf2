"""Public wrappers for the hand-written kernels.

The tensor's device decides the path: a CUDA tensor launches the kernel
(or raises), a CPU tensor takes the plain PyTorch version in ``ref.py``.
There is no environment override and no fallback from CUDA to the plain
version.  Empty relational and gather outputs launch nothing on either
device (the recurrences refuse empty inputs), and so does one case with a
non-empty output: a sentinel gather from an empty source, where every
index is a miss.  As in the TPU wrapper (``_sentinel_gather`` of
``src/repro/kernels/relational.py``), it is answered with a tensor of the
fill made by ``torch.full`` on the card, and counts no launch.  Inputs
are validated the same way on both devices, so a call that the kernel
would refuse also fails on the CPU, with one exception: a segment
reduction whose ``order`` names a row twice (so is no permutation).  On
the card the few-groups path (G <= 32) raises ``ValueError``, the
many-groups path (the sorted-runs gather) returns its result, and the
CPU returns the result of ``vkernels``, whose bits it keeps at every G.
The relational ops always pass ``group_ranges``' permutation, so no call
of theirs sees this.

``launch_counts`` holds one plain integer per kernel, raised by one (under
a lock, since the executor's worker threads call the wrappers at once)
where the wrapper launches that kernel and nowhere else; a run sets them to 0
(``reset_launch_counts``) and reads them afterwards to show that its path
went through the kernels.  There is one count per kernel, named after
the function the main path calls it through: ``combine_hashes`` also
counts the fused ``hash_keys`` fold, and ``filter_join_gather`` also
counts ``gather_payload``, which share those kernels.

The relational wrappers take and return tensors: 64-bit hashes and uint64
sums travel as int64 tensors that carry the uint64 bits.

A ``meta`` tensor (a dry run counts a full-size step without memory,
``launch/dryrun.py``) is validated as a CPU or CUDA one is, as far as
shapes and dtypes go (its values cannot be read, so the index-range and
order checks are left out), and gets an empty ``meta`` output of the
kernel's shape and dtype: no launch, no count.  Any other device raises.

While a roofline count runs (``launch/roofline.py``'s ``StepCounter``,
listed in ``cost_counters``), each wrapper reports its kernel's work from
``costs.py`` once a call and hides its own ATen ops from the counter (the
plain version on the CPU, the output's allocation), so a step counts the
same on every device.

No kernel has a backward yet.  On a CUDA tensor every wrapper refuses,
with a ``RuntimeError`` before any launch, an input that requires grad
while grad is enabled (``_refuse_grad``): the kernel's output would carry
no ``grad_fn`` and cut the gradient without a word.  Serving runs under
``torch.inference_mode()`` and is not affected; the plain versions on the
CPU stay differentiable.  Training does not reach these wrappers: train
mode runs attention through ``models.attention.chunked_attention``, the
WKV-6 recurrence through ``models.rwkv6.wkv6_chunked`` and the RG-LRU
through ``models.rglru.rglru_scan``, plain PyTorch under autograd, as the
JAX package trains outside its Pallas kernels (ROADMAP.md queue 1, item
6); a backward kernel would be perf work (queue 2, item i).
"""

from __future__ import annotations

import functools
import threading
from typing import Dict, List, Optional, Tuple

import torch

from . import costs, ref, relational, take_gather
from .flash_attention import DTYPES, SUPPORTED_HD, flash_attention_cuda
from .rglru_scan import rglru_scan_cuda
from .wkv6 import SUPPORTED_N, wkv6_cuda

launch_counts: Dict[str, int] = {
    "flash_attention": 0, "wkv6": 0, "rglru_scan": 0, "hash_fixed": 0,
    "combine_hashes": 0, "filter_join_gather": 0, "segreduce": 0,
    "take_rows": 0, "dict_decode": 0}


_count_lock = threading.Lock()


def reset_launch_counts() -> None:
    with _count_lock:
        for name in launch_counts:
            launch_counts[name] = 0


def _count(name: str) -> None:
    with _count_lock:
        launch_counts[name] += 1


#: the roofline counts running now (``launch/roofline.py``'s
#: ``StepCounter``); each has ``hide()``, ``show()`` and ``add_kernel(name,
#: cost, out)``
cost_counters: List = []


def _costed(name: str, cost):
    """Decorate a wrapper of kernel ``name``: while a count runs, the
    wrapper's ATen ops are hidden from it and, once the call returns, its
    ``cost(*args, **kw)`` (``costs.KernelCost``) and output are added."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kw):
            if not cost_counters:
                return fn(*args, **kw)
            counters = list(cost_counters)
            for c in counters:
                c.hide()
            try:
                out = fn(*args, **kw)
            finally:
                for c in counters:
                    c.show()
            for c in counters:
                c.add_kernel(name, cost(*args, **kw), out)
            return out
        return wrapped
    return deco


def _device_type(*ts: torch.Tensor) -> str:
    """"cuda", "cpu" or "meta", the one device of ``ts``; raises for a mix
    or for another device."""
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError(f"tensors on different devices: "
                         f"{[str(t.device) for t in ts]}")
    if dev.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"no kernel for device {dev}")
    return dev.type


def _refuse_grad(name: str, *ts: torch.Tensor) -> None:
    """Raise before a launch when grad is enabled and an input requires
    it: the kernels have no backward yet."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError(
            f"{name}: an input requires grad, but the CUDA kernel has no "
            "backward yet (train mode runs attention, the WKV-6 recurrence "
            "and the RG-LRU scan in plain PyTorch, ROADMAP.md queue 1, item "
            "6; a backward kernel is queue 2, item i); call it under "
            "torch.no_grad() or torch.inference_mode(), or on CPU tensors, "
            "whose plain version is differentiable")


def _check_attention(q, k, v, window: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q (B,S,H,hd), k and v (B,T,KV,hd)"
                         f" expected, got {q.shape}, {k.shape}, {v.shape}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices "
                         f"({q.device}, {k.device}, {v.device})")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: float32 or bfloat16 q, k, v of "
                        f"one dtype expected, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    B, S, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"flash_attention: k/v shape {tuple(k.shape)}, "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    T, KV = k.shape[1], k.shape[2]
    if min(B, S, T, H, KV) < 1 or H % KV:
        raise ValueError(f"flash_attention: empty input or H={H} not a "
                         f"multiple of KV={KV}")
    if hd not in SUPPORTED_HD:
        raise ValueError(f"flash_attention: head dim {hd} not supported "
                         f"(supported: {SUPPORTED_HD})")
    if max(B, H) > 65535:
        raise ValueError(f"flash_attention: B={B} or H={H} exceeds the "
                         "kernel's grid limit of 65535")
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    if window and S >= T + window:
        # query rows >= T + window - 1 see no key: the TPU kernel skips all
        # their tiles (output 0) while its oracle averages every value, so
        # the function is not defined there
        raise ValueError(f"flash_attention: S={S} >= T={T} + window="
                         f"{window} leaves query rows with no visible key")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} must have stride 1 on"
                             f" the head dim, has strides {t.stride()}")


@_costed("flash_attention", costs.flash_attention)
def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """GQA attention forward.  q: (B, S, H, hd); k, v: (B, T, KV, hd) ->
    (B, S, H, hd) in q's dtype.  Causal positions count from 0 for both q
    and k; ``window`` > 0 keeps keys with kpos > qpos - window."""
    _check_attention(q, k, v, window)
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type == "meta":
        return q.new_empty(q.shape)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    _refuse_grad("flash_attention", q, k, v)
    out = flash_attention_cuda(q, k, v, causal=causal, window=window)
    _count("flash_attention")
    return out


# --------------------------------------------------------------------------
# recurrences (wkv6.cu, rglru_scan.cu)
# --------------------------------------------------------------------------

def _check_f32(name: str, t: torch.Tensor, shape) -> None:
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: float32 {tuple(shape)} expected, got "
                         f"{t.dtype} {tuple(t.shape)}")


@_costed("wkv6", costs.wkv6)
def wkv6(r, k, v, w, u, state=None):
    """RWKV-6 recurrence per (batch, head) with an N x N float32 state:
    o_t = r_t (diag(u) k_t v_t^T + S), S <- diag(w_t) S + k_t v_t^T.
    r, k, v: (B, S, H, N), float32 or bfloat16 of one dtype; w: float32
    (B, S, H, N) decays; u: float32 (H, N); state: float32 (B, H, N, N) or
    None (zeros).  Any S >= 1.  Returns (out (B, S, H, N) in r's dtype,
    final state (B, H, N, N) float32)."""
    if r.dim() != 4 or k.shape != r.shape or v.shape != r.shape:
        raise ValueError(f"wkv6: r, k, v (B, S, H, N) of one shape expected,"
                         f" got {tuple(r.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if r.dtype not in DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"wkv6: float32 or bfloat16 r, k, v of one dtype "
                        f"expected, got {r.dtype}, {k.dtype}, {v.dtype}")
    B, S, H, N = r.shape
    _check_f32("wkv6 w", w, r.shape)
    _check_f32("wkv6 u", u, (H, N))
    ts = [r, k, v, w, u]
    if state is not None:
        _check_f32("wkv6 state", state, (B, H, N, N))
        ts.append(state)
    kind = _device_type(*ts)
    if min(B, S, H) < 1 or N not in SUPPORTED_N:
        raise ValueError(f"wkv6: empty input or head size {N} not "
                         f"supported (B, S, H, N = {tuple(r.shape)}; "
                         f"supported N: {SUPPORTED_N})")
    if kind == "cpu":
        return ref.wkv6_ref(r, k, v, w, u, state)
    if kind == "meta":
        return r.new_empty(r.shape), w.new_empty((B, H, N, N))
    _refuse_grad("wkv6", *ts)
    out = wkv6_cuda(*(t.contiguous() for t in (r, k, v, w, u)),
                    None if state is None else state.contiguous())
    _count("wkv6")
    return out


@_costed("rglru_scan", costs.rglru_scan)
def rglru_scan(a, b, h0=None):
    """Linear recurrence h_t = a_t * h_{t-1} + b_t per channel, h_{-1} = h0
    (zeros when None).  a, b: float32 (B, S, W); h0: float32 (B, W).  Any
    S, W >= 1.  Returns (h (B, S, W), h_last (B, W)), float32."""
    if a.dim() != 3:
        raise ValueError(f"rglru_scan: a (B, S, W) expected, got "
                         f"{tuple(a.shape)}")
    _check_f32("rglru_scan a", a, a.shape)
    _check_f32("rglru_scan b", b, a.shape)
    B, S, W = a.shape
    ts = [a, b]
    if h0 is not None:
        _check_f32("rglru_scan h0", h0, (B, W))
        ts.append(h0)
    kind = _device_type(*ts)
    if min(B, S, W) < 1 or B > 65535:
        raise ValueError(f"rglru_scan: empty input or B={B} above the "
                         f"kernel's grid limit of 65535 ({tuple(a.shape)})")
    if kind == "cpu":
        return ref.rglru_ref(a, b, h0)
    if kind == "meta":
        return a.new_empty(a.shape), a.new_empty((B, W))
    _refuse_grad("rglru_scan", *ts)
    out = rglru_scan_cuda(a.contiguous(), b.contiguous(),
                          None if h0 is None else h0.contiguous())
    _count("rglru_scan")
    return out


# --------------------------------------------------------------------------
# relational kernels (splitmix64.cu, sentinel_gather.cu, segreduce.cu)
# --------------------------------------------------------------------------

INT_DTYPES = (torch.int8, torch.int16, torch.int32, torch.int64,
              torch.uint8, torch.uint16, torch.uint32, torch.uint64)
#: what hash_fixed and the gathers take: every 1/2/4/8-byte dtype that a
#: numpy column can have
FIXED_DTYPES = INT_DTYPES + (torch.bool, torch.float16, torch.float32,
                             torch.float64)
#: what the segment reducers take: float reductions are order-sensitive
#: and never reach the kernel (core.kdispatch.REGISTRY)
REDUCE_DTYPES = INT_DTYPES + (torch.bool,)


def _check_1d(name: str, t: torch.Tensor, dtypes) -> None:
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name}: a contiguous 1-D tensor expected, got "
                         f"shape {tuple(t.shape)} strides {t.stride()}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not supported "
                        f"(supported: {dtypes})")


@_costed("hash_fixed", costs.hash_fixed)
def hash_fixed(x: torch.Tensor) -> torch.Tensor:
    """uint64 splitmix64 hash of each element's bit pattern (float -0.0
    hashed as +0.0, NaN payloads kept, narrow widths zero-extended), as an
    int64 tensor of the same length carrying the uint64 bits
    (``vkernels.hash_fixed``)."""
    _check_1d("hash_fixed", x, FIXED_DTYPES)
    kind = _device_type(x)
    if x.numel() == 0 or kind == "meta":
        return torch.empty(x.numel(), dtype=torch.int64, device=x.device)
    if kind == "cpu":
        return ref.hash_fixed_ref(x)
    out = relational.hash_fixed_cuda(x)
    _count("hash_fixed")
    return out


@_costed("combine_hashes", costs.combine_hashes)
def combine_hashes(cols: torch.Tensor, mix_first: bool = False
                   ) -> torch.Tensor:
    """Ordered fold of the rows of an int64 (ncols, n) tensor of 64-bit
    words into one int64 row hash per column position
    (``vkernels.combine_hashes``); ``mix_first`` takes raw prepared bits
    and hashes each row first (the fused ``vkernels.hash_keys``)."""
    if cols.dim() != 2 or cols.dtype != torch.int64 \
            or not cols.is_contiguous():
        raise ValueError(f"combine_hashes: a contiguous int64 (ncols, n) "
                         f"tensor expected, got {cols.dtype} "
                         f"{tuple(cols.shape)} strides {cols.stride()}")
    kind = _device_type(cols)
    if cols.shape[1] == 0 or kind == "meta":
        return torch.empty(cols.shape[1], dtype=torch.int64,
                           device=cols.device)
    if kind == "cpu":
        return ref.combine_ref(cols, mix_first)
    out = relational.combine_cuda(cols, mix_first)
    _count("combine_hashes")
    return out


def _fill_word(fill, dtype: torch.dtype) -> int:
    """The bits of ``fill`` in ``dtype``, as a signed integer of its width."""
    w = dtype.itemsize
    if dtype.is_floating_point or dtype == torch.bool:
        return int(torch.tensor([fill], dtype=dtype).view(ref.SIGNED[w])[0])
    info = torch.iinfo(dtype)
    if not info.min <= fill <= info.max:
        raise OverflowError(f"fill {fill} out of bounds for {dtype}")
    return fill - (1 << 8 * w) if fill >= 1 << (8 * w - 1) else fill


@_costed("filter_join_gather", costs.sentinel_gather)
def _sentinel_gather(src: torch.Tensor, idx: torch.Tensor,
                     fill) -> torch.Tensor:
    _check_1d("sentinel gather src", src, FIXED_DTYPES)
    _check_1d("sentinel gather idx", idx, (torch.int64,))
    kind = _device_type(src, idx)
    cuda = kind == "cuda"
    m, w = idx.numel(), src.element_size()
    fill = _fill_word(fill, src.dtype)
    if m == 0 or kind == "meta":
        return torch.empty(m, dtype=src.dtype, device=src.device)
    lo, hi = torch.stack(torch.aminmax(idx)).tolist()     # one sync
    if lo < -1 or hi >= src.numel():
        raise IndexError(f"sentinel gather: index range [{lo}, {hi}] "
                         f"outside [-1, {src.numel()})")
    if not cuda or src.numel() == 0:   # empty src: all misses, see above
        return ref.sentinel_gather_ref(src, idx, fill)
    out = relational.sentinel_gather_cuda(src, idx,
                                          fill & ((1 << 8 * w) - 1))
    _count("filter_join_gather")
    return out


def filter_join_gather(sel: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Compose a selection with join gather indices, ``-1`` miss sentinels
    preserved: out[i] = sel[idx[i]] or -1 (``vkernels.filter_join_gather``).
    Both int64; raises IndexError for an index outside [-1, len(sel))."""
    _check_1d("filter_join_gather sel", sel, (torch.int64,))
    return _sentinel_gather(sel, idx, -1)


def gather_payload(values: torch.Tensor, idx: torch.Tensor,
                   fill=0) -> torch.Tensor:
    """out[i] = values[idx[i]], or ``fill`` (in values' dtype) where
    idx[i] == -1; bits are copied, so NaN payloads survive."""
    return _sentinel_gather(values, idx, fill)


#: the aggregates one segreduce launch computes together
SEGREDUCE_HOWS = ("count", "sum", "min", "max")


@_costed("segreduce", costs.segreduce)
def _segreduce(hows: Tuple[str, ...], values: Optional[torch.Tensor],
               order: Optional[torch.Tensor], starts: torch.Tensor,
               valid: Optional[torch.Tensor], n: Optional[int]
               ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    what = f"grouped_reduce {list(hows)}"
    if not hows or any(h not in SEGREDUCE_HOWS for h in hows):
        raise ValueError(f"{what}: aggregates of {SEGREDUCE_HOWS} expected")
    _check_1d(f"{what} starts", starts, (torch.int64,))
    ts = [starts]
    if order is None:
        if hows != ("count",) or valid is not None or n is None:
            raise ValueError(f"{what}: order may be left out only for a "
                             "count with no validity mask, with n given")
    else:
        _check_1d(f"{what} order", order, (torch.int64,))
        if n is not None and n != order.numel():
            raise ValueError(f"{what}: n={n} != {order.numel()} rows")
        n = order.numel()
        ts.append(order)
    if hows != ("count",):
        if values is None:
            raise ValueError(f"{what}: values expected")
        _check_1d(f"{what} values", values, REDUCE_DTYPES)
        ts.append(values)
    else:
        values = None
    if valid is not None:
        _check_1d(f"{what} valid", valid, (torch.bool,))
        ts.append(valid)
    lengths = [t.numel() for t in ts[1 + (order is not None):]]
    if any(m != n for m in lengths):
        raise ValueError(f"{what}: values/valid of length {lengths} != {n} "
                         "rows")
    kind = _device_type(*ts)
    cuda = kind == "cuda"
    G = starts.numel()
    if G == 0 or kind == "meta":
        return ({h: torch.empty(G, dtype=torch.int64, device=starts.device)
                 for h in hows if h != "count"},
                torch.empty(G, dtype=torch.int64, device=starts.device))
    # the kernel's memory safety rests on these: one sync for all of them
    bad = n == 0
    if not bad:
        bad = (starts[0] != 0) | (starts[-1] >= n) \
            | (starts[1:] <= starts[:-1]).any()
        if order is not None:
            lo, hi = torch.aminmax(order)
            bad = bad | (lo < 0) | (hi >= n)
    if bool(bad):
        raise ValueError(f"{what}: starts must begin at 0 and rise "
                         f"strictly below n={n}, and order must lie in "
                         f"[0, n)")
    if not cuda:
        return ref.segreduce_many_ref(hows, values, order, starts, valid, n)
    words, counts, twice = relational.segreduce_cuda(
        relational.segreduce_path(G), hows, values, order, starts, valid, n)
    _count("segreduce")
    if twice is not None and bool(twice):
        raise ValueError(f"{what}: order names a row twice, so it is not a "
                         f"permutation of [0, {n})")
    return words, counts


def _extreme_dtype(values: torch.Tensor) -> torch.dtype:
    return torch.uint8 if values.dtype == torch.bool else values.dtype


def _narrow(acc: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """64-bit result words -> ``dtype`` (the values fit; the bits of the
    low ``dtype``-wide part are kept)."""
    return acc.to(ref.SIGNED[dtype.itemsize]).view(dtype)


def grouped_reduce(values: Optional[torch.Tensor],
                   order: Optional[torch.Tensor], starts: torch.Tensor,
                   valid: Optional[torch.Tensor], hows, *,
                   n: Optional[int] = None
                   ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Every aggregate in ``hows`` (of count, sum, min, max) of one column
    over sorted group ranges, in one launch of the segreduce kernel:
    ({how: result}, counts int64).  Each result is what the one-op wrapper
    of its name returns (``vkernels.grouped_*``): counts; wrapping sums,
    int64 or uint64 for uint64 values; extremes in the values' dtype (uint8
    for bool), the type's max (min) for an all-null group.  On the card the
    path is picked by the number of groups (``relational.segreduce_path``);
    on the few-groups path an ``order`` that names a row twice raises
    ``ValueError`` (the CPU keeps the reference's result).  ``order`` may
    be None for a count alone with no validity mask, which reads no row;
    ``n`` then gives the number of rows."""
    hows = tuple(dict.fromkeys(hows))
    words, counts = _segreduce(hows, values, order, starts, valid, n)
    out = {}
    for h in hows:
        if h == "count":
            out[h] = counts
        elif h == "sum":
            out[h] = words[h].view(torch.uint64) \
                if values.dtype == torch.uint64 else words[h]
        else:
            out[h] = _narrow(words[h], _extreme_dtype(values))
    return out, counts


def grouped_count(order: torch.Tensor, starts: torch.Tensor,
                  valid: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-group count of non-null rows over sorted group ranges
    (``vkernels.grouped_count``): (counts, counts), int64."""
    _, counts = grouped_reduce(None, order, starts, valid, ("count",))
    return counts, counts


def grouped_sum(values: torch.Tensor, order: torch.Tensor,
                starts: torch.Tensor, valid: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-group wrapping sum over non-null rows, integer/bool values
    (``vkernels.grouped_sum``): (sums int64, or uint64 for uint64 values;
    counts int64)."""
    out, counts = grouped_reduce(values, order, starts, valid, ("sum",))
    return out["sum"], counts


def grouped_min(values: torch.Tensor, order: torch.Tensor,
                starts: torch.Tensor, valid: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-group min over non-null rows, integer/bool values, the type's
    max for an all-null group (``vkernels.grouped_min``): (mins in the
    values' dtype, uint8 for bool; counts int64)."""
    out, counts = grouped_reduce(values, order, starts, valid, ("min",))
    return out["min"], counts


def grouped_max(values: torch.Tensor, order: torch.Tensor,
                starts: torch.Tensor, valid: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-group max over non-null rows, integer/bool values, the type's
    min for an all-null group (``vkernels.grouped_max``): (maxs in the
    values' dtype, uint8 for bool; counts int64)."""
    out, counts = grouped_reduce(values, order, starts, valid, ("max",))
    return out["max"], counts


# --------------------------------------------------------------------------
# row gather and dictionary decode (take_gather.cu)
# --------------------------------------------------------------------------

#: what the gathers take: every 1/2/4/8-byte element type, copied as bits
GATHER_DTYPES = FIXED_DTYPES + (torch.bfloat16,)
INDEX_DTYPES = (torch.int32, torch.int64)


def _row_gather(what: str, table: torch.Tensor, idx: torch.Tensor, plain,
                kernel) -> torch.Tensor:
    """The host contract of the JAX wrappers (``repro.kernels.ops``): the
    indices as given (before any narrowing) must lie in [0, R), else
    ``IndexError``; zero rows give an empty (0, W) gather."""
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"{what}: a 2-D table and 1-D indices expected, got "
                         f"{tuple(table.shape)} and {tuple(idx.shape)}")
    if table.dtype not in GATHER_DTYPES or idx.dtype not in INDEX_DTYPES:
        raise TypeError(f"{what}: table of {GATHER_DTYPES} and indices of "
                        f"{INDEX_DTYPES} expected, got {table.dtype} and "
                        f"{idx.dtype}")
    kind = _device_type(table, idx)
    cuda = kind == "cuda"
    if cuda:
        _refuse_grad(what, table)
    R, W = table.shape
    M = idx.numel()
    if kind == "meta":
        return table.new_empty((M, W))
    if M:
        lo, hi = torch.stack(torch.aminmax(idx)).tolist()     # one sync
        if lo < 0 or hi >= R:
            raise IndexError(f"{what}: index {lo if lo < 0 else hi} out of "
                             f"range for {R} rows")
    if not cuda:
        return plain(table, idx)
    if M == 0 or W == 0:
        return torch.empty((M, W), dtype=table.dtype, device=table.device)
    out = kernel(table.contiguous(), idx.contiguous())
    _count(what)
    return out


@_costed("take_rows", costs.row_gather)
def take_rows(values: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """out[i] = values[indices[i]]: (R, W) x (M,) -> (M, W) in values'
    dtype, bits copied (``repro.kernels.ops.take_rows``).  Indices int32
    or int64; one outside [0, R) raises IndexError."""
    return _row_gather("take_rows", values, indices, ref.take_rows_ref,
                       take_gather.take_rows_cuda)


@_costed("dict_decode", lambda codes, dictionary: costs.row_gather(
    dictionary, codes))
def dict_decode(codes: torch.Tensor, dictionary: torch.Tensor
                ) -> torch.Tensor:
    """out[i] = dictionary[codes[i]]: (M,) x (R, W) -> (M, W), bits copied
    (``repro.kernels.ops.dict_decode``, with the gather contract of its
    oracle ``ref.dict_decode_ref``; the TPU kernel's one-hot matmul turns
    0 x inf into NaN, ROADMAP queue 3 item b).  Codes int32 or int64; one
    outside [0, R) raises IndexError."""
    return _row_gather("dict_decode", dictionary, codes,
                       lambda d, c: ref.dict_decode_ref(c, d),
                       lambda d, c: take_gather.dict_decode_cuda(c, d))
