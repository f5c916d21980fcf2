"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).
Port of ``src/repro/models/rglru.py``.

Per channel:
    r_t = sigmoid(W_a x_t)              recurrence gate
    i_t = sigmoid(W_x x_t)              input gate
    log a_t = -c softplus(lam) r_t      (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t)

Block: two input projections, a short causal depthwise conv1d on the
recurrent branch, the RG-LRU, a gelu-gated merge and the output
projection.  The gates are block-diagonal over 16 heads.  Prefill runs the
recurrence through ``ops.rglru_scan`` (the hand-written kernel for CUDA
tensors, its plain version for CPU tensors) with the carried h as its h0;
the JAX model folds h0 into b_0 and takes an associative scan, which
agrees to rounding.  Train mode runs ``rglru_scan``: h0 folded into b_0 as
the JAX model does, then a log-depth doubling scan in plain PyTorch under
autograd (the kernel has no backward).  Decode is one plain step.  Caches
are updated in place.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops
from ..sharding.partition import constrain
from .layers import dense_init_, normal_, uniform_

C_FACTOR = 8.0
N_GATE_HEADS = 16


def gates(p, x):
    """Block-diagonal gate projections: x (B, S, w) -> r, i (B, S, w)."""
    B, S, w = x.shape
    xh = x.reshape(B, S, N_GATE_HEADS, w // N_GATE_HEADS)
    r = torch.einsum("bshk,hkj->bshj", xh, p.gate_a.to(x.dtype))
    i = torch.einsum("bshk,hkj->bshj", xh, p.gate_x.to(x.dtype))
    return (torch.sigmoid(r.reshape(B, S, w)),
            torch.sigmoid(i.reshape(B, S, w)))


def coeffs(p, x):
    """(a, b) of h_t = a_t h_{t-1} + b_t for x (B, S, w), float32."""
    r, i = gates(p, x)
    log_a = -C_FACTOR * F.softplus(p.lam).float() * r.float()
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9))
    return a, beta * (i.float() * x.float())


def rglru_scan(a, b, h0: Optional[torch.Tensor] = None):
    """h_t = a_t h_{t-1} + b_t over S, differentiable: a, b (B, S, w)
    float32; h0 (B, w) or None.  Returns (h (B, S, w) float32, h[:, -1]).

    The JAX model's ``associative_scan`` of (a_l a_r, b_l a_r + b_r), here
    as a doubling scan: after the pass of shift 2^j, position t holds the
    composition of the 2^(j+1) steps ending at t.  Out of place, so that
    autograd records every pass; it agrees with the JAX tree to rounding."""
    a, b = a.float(), b.float()
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0.float()[:, None], b[:, 1:]],
                      dim=1)
    S, shift = a.shape[1], 1
    while shift < S:
        b = torch.cat([b[:, :shift],
                       b[:, :-shift] * a[:, shift:] + b[:, shift:]], dim=1)
        a = torch.cat([a[:, :shift], a[:, :-shift] * a[:, shift:]], dim=1)
        shift *= 2
    return b, b[:, -1]


def rglru_step(p, x, h):
    """One decode step.  x: (B, 1, w); h: (B, w) float32.  Returns
    (y (B, 1, w) in x's dtype, new h float32)."""
    a, b = coeffs(p, x)
    h_new = a[:, 0] * h.float() + b[:, 0]
    return h_new[:, None].to(x.dtype), h_new


def conv1d_apply(conv_w, x, state: Optional[torch.Tensor] = None):
    """Depthwise causal conv of width W = conv_w.shape[0].  x: (B, S, w);
    state: the W - 1 inputs before x[:, 0], (B, W - 1, w) (zeros when
    None).  Returns (out, new state)."""
    W = conv_w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], W - 1, x.shape[2]))
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * conv_w[i].to(x.dtype)
              for i in range(W))
    return out, xp[:, xp.shape[1] - (W - 1):]


def rglru_axes() -> Dict[str, Tuple]:
    """Logical axes of the RG-LRU block's weights."""
    return {"wx": ("fsdp", "lru"), "wy": ("fsdp", "lru"),
            "conv": (None, "lru"),
            "gate_a": ("lru", None, None), "gate_x": ("lru", None, None),
            "lam": ("lru",), "wo": ("lru", "fsdp")}


def rglru_block_apply(p, x, cfg, mode: str, cache: Optional[Dict] = None):
    """The recurrent block.  cache: {"h": (B, w) float32, "conv": (B,
    conv_width - 1, w)}, updated in place.  Returns (out, cache)."""
    rec = x @ p.wx.to(x.dtype)
    gate = F.gelu(x @ p.wy.to(x.dtype), approximate="tanh")
    rec = constrain(rec, ("batch", "seq", "lru"))
    rec, new_conv = conv1d_apply(p.conv, rec,
                                 cache["conv"] if cache else None)
    if mode == "decode":
        y, h_last = rglru_step(p, rec, cache["h"])
    elif mode == "train":
        h, h_last = rglru_scan(*coeffs(p, rec),
                               cache["h"] if cache else None)
        y = h.to(rec.dtype)
    else:
        a, b = coeffs(p, rec)
        h, h_last = ops.rglru_scan(a, b, cache["h"] if cache else None)
        y = h.to(rec.dtype)
    out = (y * gate) @ p.wo.to(x.dtype)
    if cache is not None:
        cache["h"].copy_(h_last)
        cache["conv"].copy_(new_conv)
    return out, cache


class RGLRU(nn.Module):
    """RG-LRU block weights in the JAX package's shapes."""

    def __init__(self, cfg, dtype, device=None):
        super().__init__()
        d, w = cfg.d_model, cfg.lru_width or cfg.d_model
        hb = w // N_GATE_HEADS
        kw = dict(dtype=dtype, device=device)
        self.wx = nn.Parameter(torch.empty(d, w, **kw))
        self.wy = nn.Parameter(torch.empty(d, w, **kw))
        self.conv = nn.Parameter(torch.empty(cfg.conv_width, w, **kw))
        self.gate_a = nn.Parameter(torch.empty(N_GATE_HEADS, hb, hb, **kw))
        self.gate_x = nn.Parameter(torch.empty(N_GATE_HEADS, hb, hb, **kw))
        self.lam = nn.Parameter(torch.empty(w, dtype=torch.float32,
                                            device=device))
        self.wo = nn.Parameter(torch.empty(w, d, **kw))

    def init(self, generator: torch.Generator) -> None:
        d, w = self.wx.shape
        hb = w // N_GATE_HEADS
        # lam such that a = exp(-c softplus(lam)) lies in [0.9, 0.999]
        uniform_(self.lam, 0.9 ** 2, 0.999 ** 2, generator)
        with torch.no_grad():
            self.lam.copy_(torch.log(torch.exp(
                -torch.log(self.lam) / (2 * C_FACTOR)) - 1.0))
        dense_init_(self.wx, d, generator)
        dense_init_(self.wy, d, generator)
        normal_(self.conv, 0.02, generator)
        normal_(self.gate_a, 1.0 / math.sqrt(hb), generator)
        normal_(self.gate_x, 1.0 / math.sqrt(hb), generator)
        dense_init_(self.wo, w, generator)

    def forward(self, x, cfg, mode: str, cache: Optional[Dict] = None):
        return rglru_block_apply(self, x, cfg, mode, cache)
