"""Binding of the hand-written Hopper WKV-6 kernel.

``csrc/wkv6.cu`` replaces the TPU kernel
``src/repro/kernels/wkv6.py::_wkv6_kernel``; its header says what bounds
it on the H100 and how the design answers that (bf16 in the chunked form
on the tensor cores, float32 token by token on FMAs).  This module only
allocates the outputs, passes pointers, sizes and the current stream
through ``ctypes`` and raises on a failed launch.  Callers go through
``ops.wkv6``, which validates the inputs first.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

SUPPORTED_N = (16, 32, 64)
DTYPES = (torch.float32, torch.bfloat16)

_fn = None


def _bind():
    global _fn
    if _fn is None:
        fn = build.load("wkv6").wkv6_fwd
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 8 + [I] * 5 + [P]
        fn.restype = I
        _fn = fn
    return _fn


def wkv6_cuda(r, k, v, w, u, state):
    """Launch the kernel on contiguous CUDA tensors that ``ops.wkv6`` has
    validated; returns (out (B, S, H, N) in r's dtype, state (B, H, N, N)
    float32)."""
    B, S, H, N = r.shape
    out = torch.empty_like(r)
    s_out = torch.empty((B, H, N, N), dtype=torch.float32, device=r.device)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = _bind()(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        None if state is None else state.data_ptr(), out.data_ptr(),
        s_out.data_ptr(), int(r.dtype == torch.bfloat16), B, S, H, N, stream)
    if err != 0:
        raise RuntimeError(f"wkv6 kernel launch failed: cudaError_t {err} "
                           f"(r {tuple(r.shape)}, {r.dtype})")
    return out, s_out

