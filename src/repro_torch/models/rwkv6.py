"""RWKV-6 'Finch' block (arXiv:2404.05892): attention-free, with a
data-dependent decay.  Port of ``src/repro/models/rwkv6.py``.

Time mix, per head of size N with an N x N state S:
    o_t = r_t (diag(u) k_t v_t^T + S_{t-1})
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
with w_t = exp(-exp(w0 + LoRA(x_t))) and the token-shift interpolation
x_t + mu (x_{t-1} - x_t).  Channel mix: k = relu(x_k Wk)^2, out =
sigmoid(x_r Wr) * (k Wv).

Prefill runs the recurrence through ``ops.wkv6`` (the hand-written kernel
for CUDA tensors, its plain version for CPU tensors) at any sequence
length: the JAX model's chunked form needs S to be a multiple of its chunk
(``wkv6_chunked`` asserts it), the function itself does not.  Train mode
runs ``wkv6_chunked``, the JAX model's chunked form in plain PyTorch under
autograd (the kernel has no backward), at any length.  Decode is one plain
step.  Caches are updated in place.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops
from ..sharding.partition import constrain
from .layers import RMSNorm, dense_init_, normal_, uniform_

LORA_R = 64
TRAIN_CHUNK = 16


def token_shift(x, last: Optional[torch.Tensor]):
    """(x_{t-1} over the sequence, x's last token); ``last`` (B, d) is the
    carried token before x[:, 0] (zeros when None)."""
    if last is None:
        last = torch.zeros_like(x[:, 0])
    prev = torch.cat([last[:, None].to(x.dtype), x[:, :-1]], dim=1)
    return prev, x[:, -1]


def wkv6_step(r, k, v, w, u, state):
    """One decode step.  r, k, v, w: (B, 1, H, N); state: (B, H, N, N)
    float32.  Returns (out (B, 1, H, N) in r's dtype, new state)."""
    r0, k0, v0, w0 = (a.float()[:, 0] for a in (r, k, v, w))
    kv = k0[..., :, None] * v0[..., None, :]
    out = torch.einsum("bhn,bhnm->bhm", r0,
                       state + u[None, :, :, None] * kv)
    state = state * w0[..., None] + kv
    return out[:, None].to(r.dtype), state


def wkv6_chunked(r, k, v, w, u, state: Optional[torch.Tensor] = None,
                 chunk: int = TRAIN_CHUNK):
    """The WKV-6 recurrence in chunks of ``min(chunk, S)`` tokens, in
    float32, differentiable: the JAX model's ``wkv6_chunked`` in the same
    order of operations.  r, k, v, w: (B, S, H, N), w the decays in (0, 1);
    u: (H, N); state: (B, H, N, N) float32 (zeros when None).  Returns (out
    (B, S, H, N) in r's dtype, final state float32).

    Within a chunk, with cum the inclusive cumulative log decay:
    o_t = (r_t e^{cum_t - log w_t}) S + sum_{s<t} A_ts v_s + (r_t . u k_t)
    v_t, where A = (r e^{cum - log w}) (k e^{-cum})^T; the decay floor of
    ``rwkv_time_apply`` (log w >= -4) keeps e^{-cum} inside float32 range
    at chunk 16.  Every term that depends on one chunk alone is computed
    for all chunks at once; only the state carried from chunk to chunk,
    S' = S e^{cum_last} + (k e^{cum_last - cum})^T v, runs as a loop, as
    the JAX scan runs it, so a step issues a few hundred kernels a layer
    rather than a few thousand.

    The JAX function asserts that S is a multiple of the chunk.  This one
    pads the tail to a multiple with r = k = v = 0 and w = 1, and drops the
    padding from the output: a zero key adds nothing to the state and a
    decay of 1 keeps it, so every real output and the final state are
    those of the unpadded recurrence."""
    B, S, H, N = r.shape
    f32 = torch.float32
    if state is None:
        state = torch.zeros((B, H, N, N), dtype=f32, device=r.device)
    C = min(chunk, S)
    pad = -S % C
    G = (S + pad) // C

    def chunks(x, fill=0.0):                       # (G, B, H, C, N)
        x = F.pad(x.float(), (0, 0, 0, 0, 0, pad), value=fill)
        return x.view(B, G, C, H, N).permute(1, 0, 3, 2, 4)
    rc, kc, vc, wc = chunks(r), chunks(k), chunks(v), chunks(w, 1.0)
    tri = torch.tril(torch.ones((C, C), dtype=f32, device=r.device), -1)
    logw = torch.log(torch.clamp(wc, min=1e-8))
    cum = torch.cumsum(logw, dim=3)                # inclusive
    rd = rc * torch.exp(cum - logw)                # decay to just before t
    A = torch.einsum("gbhtn,gbhsn->gbhts", rd, kc * torch.exp(-cum)) * tri
    out_intra = torch.einsum("gbhts,gbhsn->gbhtn", A, vc)
    diag = torch.einsum("gbhcn,gbhcn->gbhc", rc, kc * u.float()[:, None, :])
    k_tail = kc * torch.exp(cum[..., -1:, :] - cum)
    kv = torch.einsum("gbhcn,gbhcm->gbhnm", k_tail, vc)
    d_total = torch.exp(cum[..., -1, :])[..., None]
    st, before = state.float(), []
    for g in range(G):                             # the state entering g
        before.append(st)
        st = st * d_total[g] + kv[g]
    out_state = torch.einsum("gbhcn,gbhnm->gbhcm", rd, torch.stack(before))
    out = out_state + out_intra + diag[..., None] * vc
    out = out.permute(1, 0, 3, 2, 4).reshape(B, G * C, H, N)
    return out[:, :S].to(r.dtype), st


def rwkv_time_apply(p, x, cfg, mode: str, cache: Optional[Dict] = None):
    """Time-mix sub-block.  cache: {"shift": (B, d), "state": (B, H, N, N)
    float32}, updated in place.  Returns (out, cache)."""
    B, S, d = x.shape
    N = cfg.rwkv_head_dim
    H = d // N
    prev, new_shift = token_shift(x, cache["shift"] if cache else None)
    mu = p.mu.to(x.dtype)
    xr, xk, xv, xw, xg = (x + mu[i] * (prev - x) for i in range(5))
    r = (xr @ p.wr.to(x.dtype)).view(B, S, H, N)
    k = (xk @ p.wk.to(x.dtype)).view(B, S, H, N)
    v = (xv @ p.wv.to(x.dtype)).view(B, S, H, N)
    g = F.silu(xg @ p.wg.to(x.dtype))
    # data-dependent decay; the clip keeps log w >= -4 (decay floor e^-4),
    # as the JAX model does for its chunked form
    dw = torch.tanh(xw @ p.w_lora_a.to(x.dtype)) @ p.w_lora_b.to(x.dtype)
    w = torch.exp(-torch.exp(torch.clamp(p.w0 + dw.float(), -20.0,
                                         1.3862))).view(B, S, H, N)
    state = cache["state"] if cache else None
    if mode == "decode":
        out, new_state = wkv6_step(r, k, v, w, p.u, state)
    elif mode == "train":
        out, new_state = wkv6_chunked(r, k, v, w, p.u, state)
    else:
        out, new_state = ops.wkv6(r, k, v, w, p.u, state)
    # simplified group norm over each head
    oh = out.float()
    oh = oh * torch.rsqrt(oh.square().mean(dim=-1, keepdim=True) + 1e-5)
    out = (oh.reshape(B, S, d) * p.ln_w).to(x.dtype)
    out = (out * g) @ p.wo.to(x.dtype)
    if cache is not None:
        cache["shift"].copy_(new_shift)
        cache["state"].copy_(new_state)
    return out, cache


def rwkv_time_axes() -> Dict[str, Tuple]:
    """Logical axes of the time-mix weights."""
    return {"mu": (None, "fsdp"),
            "wr": ("fsdp", "tensor"), "wk": ("fsdp", "tensor"),
            "wv": ("fsdp", "tensor"), "wg": ("fsdp", "tensor"),
            "wo": ("tensor", "fsdp"),
            "w0": ("tensor",), "w_lora_a": ("fsdp", None),
            "w_lora_b": (None, "tensor"), "u": ("tensor", None),
            "ln_w": ("tensor",)}


def rwkv_channel_axes() -> Dict[str, Tuple]:
    """Logical axes of the channel-mix weights."""
    return {"mu": (None, "fsdp"), "wk": ("fsdp", "ffn"),
            "wv": ("ffn", "fsdp"), "wr": ("fsdp", "tensor")}


def rwkv_channel_apply(p, x, cfg, mode: str, cache: Optional[Dict] = None):
    """Channel-mix sub-block.  cache: {"shift": (B, d)}, updated in place.
    Returns (out, cache)."""
    prev, new_shift = token_shift(x, cache["shift"] if cache else None)
    mu = p.mu.to(x.dtype)
    xk = x + mu[0] * (prev - x)
    xr = x + mu[1] * (prev - x)
    k = F.relu(xk @ p.wk.to(x.dtype)).square()
    k = constrain(k, ("batch", "seq", "ffn"))
    out = torch.sigmoid(xr @ p.wr.to(x.dtype)) * (k @ p.wv.to(x.dtype))
    if cache is not None:
        cache["shift"].copy_(new_shift)
    return out, cache


class RWKVTime(nn.Module):
    def __init__(self, cfg, dtype, device=None):
        super().__init__()
        d, N = cfg.d_model, cfg.rwkv_head_dim
        kw = dict(dtype=dtype, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        self.mu = nn.Parameter(torch.empty(5, d, **kw))
        for name in ("wr", "wk", "wv", "wg", "wo"):
            setattr(self, name, nn.Parameter(torch.empty(d, d, **kw)))
        self.w0 = nn.Parameter(torch.empty(d, **f32))
        self.w_lora_a = nn.Parameter(torch.empty(d, LORA_R, **kw))
        self.w_lora_b = nn.Parameter(torch.empty(LORA_R, d, **kw))
        self.u = nn.Parameter(torch.empty(d // N, N, **f32))
        self.ln_w = nn.Parameter(torch.empty(d, **f32))

    def init(self, generator: torch.Generator) -> None:
        d = self.w0.shape[0]
        uniform_(self.mu, 0.0, 0.5, generator)
        for w in (self.wr, self.wk, self.wv, self.wg, self.wo):
            dense_init_(w, d, generator)
        with torch.no_grad():
            self.w0.fill_(-6.0)
            self.ln_w.fill_(1.0)
        dense_init_(self.w_lora_a, d, generator)
        dense_init_(self.w_lora_b, LORA_R, generator)
        normal_(self.u, 0.02, generator)

    def forward(self, x, cfg, mode: str, cache: Optional[Dict] = None):
        return rwkv_time_apply(self, x, cfg, mode, cache)


class RWKVChannel(nn.Module):
    def __init__(self, cfg, dtype, device=None):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        kw = dict(dtype=dtype, device=device)
        self.mu = nn.Parameter(torch.empty(2, d, **kw))
        self.wk = nn.Parameter(torch.empty(d, f, **kw))
        self.wv = nn.Parameter(torch.empty(f, d, **kw))
        self.wr = nn.Parameter(torch.empty(d, d, **kw))

    def init(self, generator: torch.Generator) -> None:
        d, f = self.wk.shape
        uniform_(self.mu, 0.0, 0.5, generator)
        dense_init_(self.wk, d, generator)
        dense_init_(self.wv, f, generator)
        dense_init_(self.wr, d, generator)

    def forward(self, x, cfg, mode: str, cache: Optional[Dict] = None):
        return rwkv_channel_apply(self, x, cfg, mode, cache)


class RWKVBlock(nn.Module):
    """One RWKV-6 layer: pre-norm time mix, then pre-norm channel mix."""

    def __init__(self, cfg, dtype, device=None):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.time = RWKVTime(cfg, dtype, device)
        self.ln2 = RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.channel = RWKVChannel(cfg, dtype, device)

    def init(self, generator: torch.Generator) -> None:
        self.time.init(generator)
        self.channel.init(generator)

    def forward(self, x, cfg, mode: str, cache: Optional[Dict], pos):
        o, _ = self.time(self.ln1(x), cfg, mode,
                         cache["time"] if cache else None)
        x = x + o
        o, _ = self.channel(self.ln2(x), cfg, mode,
                            cache["channel"] if cache else None)
        return x + o, cache, None
