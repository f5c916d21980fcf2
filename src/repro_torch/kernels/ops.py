"""Public wrappers for the hand-written kernels.

The tensor's device decides the path: a CUDA tensor launches the kernel
(or raises), a CPU tensor takes the plain PyTorch version in ``ref.py``.
There is no environment override and no fallback from CUDA to the plain
version.  Inputs are validated the same way on both devices, so a call
that the kernel would refuse also fails on the CPU.

``launch_counts`` holds one plain integer per kernel, raised by one where
the wrapper launches that kernel and nowhere else; a run sets them to 0
(``reset_launch_counts``) and reads them afterwards to show that its path
went through the kernels.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import ref
from .flash_attention import DTYPES, SUPPORTED_HD, flash_attention_cuda

launch_counts: Dict[str, int] = {"flash_attention": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


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


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """GQA attention forward.  q: (B, S, H, hd); k, v: (B, T, KV, hd) ->
    (B, S, H, hd) in q's dtype.  Causal positions count from 0 for both q
    and k; ``window`` > 0 keeps keys with kpos > qpos - window."""
    _check_attention(q, k, v, window)
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    out = flash_attention_cuda(q, k, v, causal=causal, window=window)
    launch_counts["flash_attention"] += 1
    return out
