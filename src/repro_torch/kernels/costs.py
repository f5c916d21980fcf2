"""The work of each hand-written kernel, from its arguments' shapes: the
operations it does and the bytes it must move (each input read once, each
output written once).  One definition serves two readers: the wrappers
in ``ops.py`` report it to a running roofline count
(``launch/roofline.py``'s ``StepCounter``), and ``chip_smoke.py`` divides
it by the card's rates for each kernel's bound.

Each function takes the wrapper's own arguments and returns a
``KernelCost``.  Nothing here reads a tensor's values, so a cost is the
same for a CUDA, a CPU or a ``meta`` tensor; where the work depends on
the data (the distinct rows a gather reads) the caller may pass what its
run's data needs.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class KernelCost(NamedTuple):
    flops: float
    nbytes: float
    #: the products run on the tensor cores (bf16 inputs); else on the
    #: CUDA cores, or there are none
    tensor_cores: bool


def _nbytes(*ts: Optional[torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def visible_pairs(S: int, T: int, causal: bool, window: int) -> float:
    """(query, key) pairs an attention scores: S x T, half of it when
    causal, and with a window those a row keeps exactly (keys j with
    i - window < j <= i, positions from 0 for both)."""
    if not window:
        return S * T * (0.5 if causal else 1.0)
    i = torch.arange(S, dtype=torch.int64)
    hi = torch.clamp(i, max=T - 1) if causal else torch.full_like(i, T - 1)
    lo = torch.clamp(i - window + 1, min=0)
    return float(torch.clamp(hi - lo + 1, min=0).sum())


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0
                    ) -> KernelCost:
    """4 B H hd flop a visible pair (the two products), q, k, v read and
    the output (q's shape) written."""
    B, S, H, hd = q.shape
    pairs = visible_pairs(S, k.shape[1], causal, window)
    return KernelCost(4.0 * B * H * hd * pairs, _nbytes(q, k, v, q),
                      q.dtype == torch.bfloat16)


def wkv6(r, k, v, w, u, state=None) -> KernelCost:
    """5 N^2 flop a (batch row, token, head); r, k, v, w, u and the state
    read, the output (r's shape) and the final state written."""
    B, S, H, N = r.shape
    final = B * H * N * N * 4
    return KernelCost(5.0 * N * N * B * S * H,
                      _nbytes(r, k, v, w, u, state, r) + final,
                      r.dtype == torch.bfloat16)


def rglru_scan(a, b, h0=None) -> KernelCost:
    """2 flop an element; a and b (and h0) read, h and the last h written,
    all float32."""
    B, S, W = a.shape
    return KernelCost(2.0 * B * S * W,
                      4 * (3 * B * S * W + B * W * (2 if h0 is not None
                                                    else 1)), False)


def hash_fixed(x) -> KernelCost:
    """Each key read, one 8-byte hash written."""
    return KernelCost(0.0, x.numel() * (x.element_size() + 8), False)


def combine_hashes(cols, mix_first: bool = False) -> KernelCost:
    """Every 8-byte word read, one 8-byte hash a row written."""
    return KernelCost(0.0, 8 * (cols.numel() + cols.shape[1]), False)


def sentinel_gather(src, idx, fill=None) -> KernelCost:
    """The source and the indices read, one element an index written."""
    w = src.element_size()
    return KernelCost(0.0, src.numel() * w + idx.numel() * (8 + w), False)


def segreduce(hows, values, order, starts, valid, n) -> KernelCost:
    """The rows' order, values and validity read (each that is given),
    the G starts read, and the counts and one 8-byte word a group for
    each other aggregate written: 16 n + 40 G bytes for count, sum, min
    and max of an int64 column with no validity."""
    G = starts.numel()
    words = sum(h != "count" for h in dict.fromkeys(hows))
    return KernelCost(0.0, _nbytes(order, values, valid) + 8 * G * (2 + words),
                      False)


def row_gather(table, idx, distinct: Optional[int] = None) -> KernelCost:
    """The indices read, each distinct source row once (``distinct``, or
    at most min(R, M) when the caller does not count them) and the output
    written."""
    R, W = table.shape
    M = idx.numel()
    row = W * table.element_size()
    if distinct is None:
        distinct = min(R, M)
    return KernelCost(0.0, M * idx.element_size() + distinct * row + M * row,
                      False)
