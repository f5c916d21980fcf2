"""Plain PyTorch versions of the hand-written kernels (the allclose ground
truth, and the path a wrapper takes for tensors on the CPU)."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """Naive full-matrix attention.  q: (B,S,H,hd); k,v: (B,T,KV,hd).

    Masked scores take the finite ``NEG_INF`` (not -inf) and the math runs
    in float32, as in the JAX oracle; the result has q's dtype."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, hd).float()
    s = torch.einsum("bskgh,btkh->bskgt", qg, k.float()) * (hd ** -0.5)
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bskgt,btkh->bskgh", p, v.float())
    return o.reshape(B, S, H, hd).to(q.dtype)
