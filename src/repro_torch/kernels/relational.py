"""Bindings of the hand-written Hopper relational kernels.

Three sources in ``csrc/`` replace the four relational TPU kernels of the
JAX package (``src/repro/kernels/relational.py``); each source's header
says what bounds it on the H100 and how its design answers that:

- ``splitmix64.cu``: ``hash_fixed`` (``_hash_fixed_kernel``) and the
  ordered fold of ``combine_hashes`` / ``hash_keys`` (``_combine_kernel``,
  ``_hash_keys_kernel``);
- ``sentinel_gather.cu``: the ``-1``-sentinel gather behind
  ``filter_join_gather`` and ``gather_payload`` (``_gather_kernel``);
- ``segreduce.cu``: the segment reductions behind ``grouped_count`` /
  ``grouped_sum`` / ``grouped_min`` / ``grouped_max``
  (``_segreduce_kernel``).

This module only allocates outputs, passes pointers, sizes and the current
stream through ``ctypes`` and raises on a failed launch.  Callers go
through ``ops``, which validates the inputs first; nothing here checks
them again.  64-bit hashes and sums come back as int64 tensors that carry
the uint64 bits.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build

SEGREDUCE_OPS = {"count": 0, "sum": 1, "min": 2, "max": 3}

_fns = {}


def _bind(lib: str, fn: str, argtypes):
    key = (lib, fn)
    f = _fns.get(key)
    if f is None:
        f = getattr(build.load(lib), fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        _fns[key] = f
    return f


P, I, L, U = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
              ctypes.c_ulonglong)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError_t {err}")


def hash_fixed_cuda(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 of each element's bits (n >= 1, contiguous, 1/2/4/8-byte
    elements) -> int64 (n,) carrying the uint64 hashes."""
    out = torch.empty(x.numel(), dtype=torch.int64, device=x.device)
    err = _bind("splitmix64", "splitmix64_hash_fixed", [P, P, L, I, I, P])(
        x.data_ptr(), out.data_ptr(), x.numel(), x.element_size(),
        int(x.dtype.is_floating_point), _stream(x))
    _raise(err, f"hash_fixed ({x.dtype}, n={x.numel()})")
    return out


def combine_cuda(cols: torch.Tensor, mix_first: bool) -> torch.Tensor:
    """The ordered fold over the rows of an int64 (ncols, n) tensor of
    64-bit words (n >= 1) -> int64 (n,)."""
    ncols, n = cols.shape
    out = torch.empty(n, dtype=torch.int64, device=cols.device)
    err = _bind("splitmix64", "splitmix64_combine", [P, I, L, I, P, P])(
        cols.data_ptr(), ncols, n, int(mix_first), out.data_ptr(),
        _stream(cols))
    _raise(err, f"combine_hashes (ncols={ncols}, n={n})")
    return out


def sentinel_gather_cuda(src: torch.Tensor, idx: torch.Tensor,
                         fill_bits: int) -> torch.Tensor:
    """out[i] = src[idx[i]], or the element whose bits are the unsigned
    ``fill_bits`` where idx[i] == -1 (m >= 1, len(src) >= 1) -> tensor of
    src's dtype."""
    out = torch.empty(idx.numel(), dtype=src.dtype, device=src.device)
    err = _bind("sentinel_gather", "sentinel_gather", [P, P, L, I, U, P, P])(
        src.data_ptr(), idx.data_ptr(), idx.numel(), src.element_size(),
        fill_bits, out.data_ptr(), _stream(src))
    _raise(err, f"sentinel gather ({src.dtype}, m={idx.numel()})")
    return out


def segreduce_cuda(op: str, values: Optional[torch.Tensor],
                   order: torch.Tensor, starts: torch.Tensor,
                   valid: Optional[torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(acc, counts) of one segment reduction (n >= 1 rows, G >= 1
    groups): acc is int64 (G,) with the 64-bit result words (uint64 bits
    for sums and uint64 extremes; unset for count), counts int64 (G,)."""
    n, G = order.numel(), starts.numel()
    acc = torch.empty(G, dtype=torch.int64, device=order.device)
    cnt = torch.empty(G, dtype=torch.int64, device=order.device)
    signed = values is not None and values.dtype.is_signed
    err = _bind("segreduce", "segreduce", [I, P, I, I, P, P, P, L, L, P, P,
                                           P])(
        SEGREDUCE_OPS[op], None if values is None else values.data_ptr(),
        1 if values is None else values.element_size(), int(signed),
        order.data_ptr(), None if valid is None else valid.data_ptr(),
        starts.data_ptr(), n, G, acc.data_ptr(), cnt.data_ptr(),
        _stream(order))
    _raise(err, f"segreduce {op} (n={n}, G={G})")
    return acc, cnt
