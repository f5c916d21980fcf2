"""Binding of the hand-written Hopper RG-LRU scan kernel.

``csrc/rglru_scan.cu`` replaces the TPU kernel
``src/repro/kernels/rglru_scan.py::_rglru_kernel``; its header says what
bounds it on the H100 and how the design answers that.  This module only
allocates the outputs, passes pointers, sizes and the current stream
through ``ctypes`` and raises on a failed launch.  Callers go through
``ops.rglru_scan``, which validates the inputs first.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

_fn = None


def _bind():
    global _fn
    if _fn is None:
        fn = build.load("rglru_scan").rglru_scan_fwd
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 5 + [I] * 3 + [P]
        fn.restype = I
        _fn = fn
    return _fn


def rglru_scan_cuda(a, b, h0):
    """Launch the kernel on contiguous float32 CUDA tensors that
    ``ops.rglru_scan`` has validated; returns (h (B, S, W), h_last (B, W)),
    float32."""
    B, S, W = a.shape
    h = torch.empty_like(a)
    h_last = torch.empty((B, W), dtype=torch.float32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _bind()(a.data_ptr(), b.data_ptr(),
                  None if h0 is None else h0.data_ptr(), h.data_ptr(),
                  h_last.data_ptr(), B, S, W, stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: cudaError_t "
                           f"{err} (a {tuple(a.shape)})")
    return h, h_last
