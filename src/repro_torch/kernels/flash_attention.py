"""Binding of the hand-written Hopper flash attention kernel.

``csrc/flash_attention.cu`` replaces the TPU kernel
``src/repro/kernels/flash_attention.py::_flash_kernel``; its header says
what bounds it on the H100 and how the design answers that (bf16 on the
tensor cores, float32 on FMAs).  This module only allocates the output,
passes pointers, strides and the current stream through ``ctypes`` and
raises on a failed launch.  Callers go through ``ops.flash_attention``,
which validates the inputs first.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

SUPPORTED_HD = (16, 32, 64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)

_fn = None


def _bind():
    global _fn
    if _fn is None:
        fn = build.load("flash_attention").flash_attention_fwd
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([P, P, P, P] + [I] * 7 + [L] * 9
                       + [I, I, ctypes.c_float, P])
        fn.restype = I
        _fn = fn
    return _fn


def flash_attention_cuda(q, k, v, *, causal: bool, window: int):
    """Launch the kernel on CUDA tensors that ``ops.flash_attention`` has
    validated; returns a contiguous (B, S, H, hd) tensor of q's dtype."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _bind()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        int(q.dtype == torch.bfloat16), B, S, T, H, KV, hd,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        int(causal), int(window), hd ** -0.5, stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: cudaError_t {err} "
            f"(q {tuple(q.shape)}, k {tuple(k.shape)}, {q.dtype})")
    return out

