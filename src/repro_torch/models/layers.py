"""Common model layers: plain functions on tensors, and ``nn.Module``s that
hold the weights and call them.

Weights keep the JAX package's shapes and names (``wi``/``wg``/``wo``, a
norm's scale), so ``convert.py`` copies a JAX pytree leaf for leaf.
Initializers draw from an explicit ``torch.Generator`` on the generator's
own device and copy to the weight's: a CPU generator gives the same
weights on every device, a CUDA generator draws a full-width model on the
card without a pass through host memory.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def draw_(w: torch.Tensor, generator: torch.Generator, fill) -> torch.Tensor:
    """Fill ``w`` with ``fill(t)``, where ``t`` is a float32 tensor of w's
    shape on the generator's device (``w`` itself when it is one)."""
    with torch.no_grad():
        if w.dtype == torch.float32 and w.device == generator.device:
            fill(w)
        else:
            t = torch.empty(w.shape, dtype=torch.float32,
                            device=generator.device)
            fill(t)
            w.copy_(t)
    return w


def trunc_normal_(w: torch.Tensor, std: float,
                  generator: torch.Generator) -> torch.Tensor:
    """Fill ``w`` from a normal of ``std`` truncated at two deviations."""
    return draw_(w, generator, lambda t: nn.init.trunc_normal_(
        t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator))


def normal_(w: torch.Tensor, std: float,
            generator: torch.Generator) -> torch.Tensor:
    """Fill ``w`` from a normal of ``std``."""
    return draw_(w, generator,
                 lambda t: t.normal_(0.0, std, generator=generator))


def uniform_(w: torch.Tensor, lo: float, hi: float,
             generator: torch.Generator) -> torch.Tensor:
    """Fill ``w`` from a uniform over [lo, hi)."""
    return draw_(w, generator,
                 lambda t: t.uniform_(lo, hi, generator=generator))


def dense_init_(w: torch.Tensor, in_dim: int, generator: torch.Generator,
                scale: float = 1.0) -> torch.Tensor:
    """Truncated-normal fan-in init for a (in, *out) weight."""
    return trunc_normal_(w, scale / math.sqrt(in_dim), generator)


def rms_norm(x, w, eps: float):
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * (1.0 + w.float())).to(dt)


def layer_norm(x, w, b, eps: float):
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(dt)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def rope_freqs(hd: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, hd, 2, dtype=np.float32) / hd))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: (..., S).  Rotates the two halves of
    the head dim (not interleaved pairs), in float32."""
    hd = x.shape[-1]
    freqs = torch.from_numpy(rope_freqs(hd, theta)).to(x.device)
    ang = positions[..., :, None].float() * freqs          # (..., S, hd/2)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# MLP variants
# --------------------------------------------------------------------------

def mlp_apply(x, wi, wo, kind: str, wg: Optional[torch.Tensor] = None):
    h = x @ wi.to(x.dtype)
    if kind == "swiglu":
        h = F.silu(x @ wg.to(x.dtype)) * h
    elif kind == "squared_relu":                 # nemotron-4
        h = F.relu(h).square()
    elif kind == "gelu":                         # whisper; jax.nn.gelu's
        h = F.gelu(h, approximate="tanh")        # default is the tanh form
    else:
        raise ValueError(kind)
    return h @ wo.to(x.dtype)


# --------------------------------------------------------------------------
# loss
# --------------------------------------------------------------------------

def softmax_xent(logits, labels, z_loss: float = 1e-4):
    """Cross entropy with optional z-loss; logits (..., V), labels (...)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * lse.square()
    return loss


# --------------------------------------------------------------------------
# modules
# --------------------------------------------------------------------------

class RMSNorm(nn.Module):
    """RMS norm scaling by ``1 + weight``; the weight starts at zero."""

    def __init__(self, d: int, eps: float, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.zeros(d, device=device))

    def forward(self, x):
        return rms_norm(x, self.weight, self.eps)


class MLP(nn.Module):
    def __init__(self, d: int, f: int, kind: str, dtype, device=None):
        super().__init__()
        self.kind = kind
        kw = dict(dtype=dtype, device=device)
        self.wi = nn.Parameter(torch.empty(d, f, **kw))
        self.wg = nn.Parameter(torch.empty(d, f, **kw)) \
            if kind == "swiglu" else None
        self.wo = nn.Parameter(torch.empty(f, d, **kw))

    def init(self, generator: torch.Generator) -> None:
        d, f = self.wi.shape
        dense_init_(self.wi, d, generator)
        if self.wg is not None:
            dense_init_(self.wg, d, generator)
        dense_init_(self.wo, f, generator)

    def forward(self, x):
        return mlp_apply(x, self.wi, self.wo, self.kind, self.wg)
