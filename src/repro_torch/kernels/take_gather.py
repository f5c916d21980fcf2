"""Binding of the hand-written Hopper row gather and dictionary decode.

``csrc/take_gather.cu`` replaces the two TPU kernels of
``src/repro/kernels/take_gather.py``, ``_take_kernel`` (``take_rows``) and
``_dict_kernel`` (``dict_decode``); its header says what bounds it on the
H100 and how the design answers that.  This module only allocates the
output, passes pointers, sizes and the current stream through ``ctypes``
and raises on a failed launch.  Callers go through ``ops.take_rows`` /
``ops.dict_decode``, which validate the inputs and the indices first.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

_fns = {}
_smem_limit = None


def _bind(fn: str, argtypes):
    f = _fns.get(fn)
    if f is None:
        f = getattr(build.load("take_gather"), fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        _fns[fn] = f
    return f


def smem_limit() -> int:
    """Bytes of shared memory one block may opt in to on the current
    device: the largest dictionary that ``dict_decode`` stages there."""
    global _smem_limit
    if _smem_limit is None:
        n = ctypes.c_int(0)
        err = _bind("take_gather_smem_limit",
                     [ctypes.POINTER(ctypes.c_int)])(ctypes.byref(n))
        if err != 0:
            raise RuntimeError(f"take_gather: reading the device's shared "
                               f"memory limit failed: cudaError_t {err}")
        _smem_limit = n.value
    return _smem_limit


def staged(table: torch.Tensor) -> bool:
    """Whether ``dict_decode`` stages this dictionary in shared memory."""
    return table.numel() * table.element_size() <= smem_limit()


def _gather(table: torch.Tensor, idx: torch.Tensor, stage: bool,
            what: str) -> torch.Tensor:
    R, W = table.shape
    M = idx.numel()
    out = torch.empty((M, W), dtype=table.dtype, device=table.device)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    err = _bind("gather_rows", [P, L, L, P, I, L, P, I, P])(
        table.data_ptr(), R, W * table.element_size(), idx.data_ptr(),
        idx.element_size(), M, out.data_ptr(), int(stage),
        torch.cuda.current_stream(table.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError_t {err} "
                           f"(table {tuple(table.shape)} {table.dtype}, "
                           f"{M} {idx.dtype} indices)")
    return out


def take_rows_cuda(values: torch.Tensor, indices: torch.Tensor
                   ) -> torch.Tensor:
    """out[i] = values[indices[i]] on contiguous CUDA tensors that
    ``ops.take_rows`` has validated (M >= 1 rows of W >= 1 elements)."""
    return _gather(values, indices, False, "take_rows")


def dict_decode_cuda(codes: torch.Tensor, dictionary: torch.Tensor
                     ) -> torch.Tensor:
    """out[i] = dictionary[codes[i]] on contiguous CUDA tensors that
    ``ops.dict_decode`` has validated; the dictionary is staged in shared
    memory when it fits (``staged``)."""
    return _gather(dictionary, codes, staged(dictionary), "dict_decode")
