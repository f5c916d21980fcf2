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
  (``_segreduce_kernel``), every requested op of a column in one launch,
  on a path picked by the number of groups (``segreduce_path``).

This module only allocates outputs, passes pointers, sizes and the current
stream through ``ctypes`` and raises on a failed launch.  Callers go
through ``ops``, which validates the inputs first; nothing here checks
them again.  64-bit hashes and sums come back as int64 tensors that carry
the uint64 bits.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch

from . import build

#: the paths of ``csrc/segreduce.cu`` (its C entry's ``path``), and the
#: bit of each op besides the count (its ``want``)
SEGREDUCE_PATHS = {"runs": 0, "private": 1}
SEGREDUCE_WANT = {"sum": 1, "min": 2, "max": 4}
#: PRIVATE_MAX of ``csrc/segreduce.cu``
PRIVATE_MAX_GROUPS = 32

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


def segreduce_path(G: int) -> str:
    """The path of ``csrc/segreduce.cu`` that ``ops.grouped_reduce`` takes
    for G groups: the few-groups path (``private``) up to 32 groups
    (it keeps 28 bytes a group and thread in shared memory), the sorted-run
    pass above."""
    return "private" if G <= PRIVATE_MAX_GROUPS else "runs"


def segreduce_cuda(path: str, hows: Sequence[str],
                   values: Optional[torch.Tensor],
                   order: Optional[torch.Tensor], starts: torch.Tensor,
                   valid: Optional[torch.Tensor], n: int
                   ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor,
                              Optional[torch.Tensor]]:
    """One launch of the segment reductions ``hows`` (count, sum, min,
    max; n >= 1 rows, G >= 1 groups) on ``path`` (``SEGREDUCE_PATHS``):
    ({how: int64 (G,) result words} for each op but the count, with uint64
    bits for sums and uint64 extremes; counts int64 (G,); on the
    few-groups path an int32 (1,) tensor that is 1 if ``order`` named a
    row twice, else None).  ``order`` and ``values`` may be None where ``hows`` is a
    count alone (and then ``order`` only without ``valid``)."""
    G = starts.numel()
    dev = starts.device
    ops = [h for h in SEGREDUCE_WANT if h in hows]
    words = {h: torch.empty(G, dtype=torch.int64, device=dev) for h in ops}
    cnt = torch.empty(G, dtype=torch.int64, device=dev)
    few = path == "private" and (ops or valid is not None)
    scratch = torch.empty(n, dtype=torch.uint8, device=dev) if few else None
    bad = torch.empty(1, dtype=torch.int32, device=dev) if few else None

    def ptr(t):
        return None if t is None else t.data_ptr()
    err = _bind("segreduce", "segreduce",
                [I, I, P, I, I, P, P, P, L, L, P, P, P, P, P, P, P])(
        SEGREDUCE_PATHS[path], sum(SEGREDUCE_WANT[h] for h in ops),
        ptr(values), 1 if values is None else values.element_size(),
        int(values is not None and values.dtype.is_signed), ptr(order),
        ptr(valid), starts.data_ptr(), n, G,
        *(ptr(words.get(h)) for h in SEGREDUCE_WANT), cnt.data_ptr(),
        ptr(scratch), ptr(bad), _stream(starts))
    _raise(err, f"segreduce {list(hows)} on {path} (n={n}, G={G})")
    return words, cnt, bad
