"""GQA attention: prefill through the hand-written flash kernel, training
and decode in plain PyTorch (decode over a preallocated KV cache updated
in place).  Cross-attention (``kv_override``, the enc-dec decoder's) runs
``chunked_attention`` or ``decode_attention`` in every mode, as the JAX
package never sends it to its kernel.

``chunked_attention`` is the JAX package's chunked online-softmax path
(its default ``attention_impl="xla"``) in plain PyTorch.  Train mode runs
through it, as the JAX package trains: no kernel of either package has a
backward, and the flash wrapper refuses inputs that require grad on the
card.  Under autograd each query block runs in ``torch.utils.checkpoint``,
so the backward pass recomputes the block's scores instead of saving them
(the port's counterpart of the JAX package's ``@jax.checkpoint``).  It is
also the model's plain reference, with which ``chip_smoke.py`` recomputes
a served prefill in place of the kernel.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels import ops
from ..sharding.partition import constrain, replicated_like
from .layers import apply_rope, dense_init_

NEG_INF = -1e30
# the attention core's layout under a mesh: sharded over the batch alone
BATCH_ONLY = ("batch", "seq", None, None)


def attn_axes():
    """Logical axes of the attention weights (wq, wk, wv, wo)."""
    return {"wq": ("fsdp", "heads", None),
            "wk": ("fsdp", "kv_heads", None),
            "wv": ("fsdp", "kv_heads", None),
            "wo": ("heads", "fsdp")}


def _online_softmax(qg, k, v, q_pos, *, causal: bool, window: int,
                    chunk: int, scale: float):
    """Online-softmax pass over KV chunks for one block of queries.

    qg: (B, Sq, KV, G, hd); k, v: (B, T, KV, hd); q_pos: (Sq,) absolute.
    Returns the normalized output (B, Sq, KV, G, hd) in float32.
    """
    B, Sq, KV, G, hd = qg.shape
    T = k.shape[1]
    chunk = min(chunk, T)
    f32 = dict(dtype=torch.float32)
    m = torch.full_like(qg[..., 0], NEG_INF, **f32)
    l = torch.zeros_like(qg[..., 0], **f32)
    acc = torch.zeros_like(qg, **f32)
    for i0 in range(0, T, chunk):
        kc, vc = k[:, i0:i0 + chunk], v[:, i0:i0 + chunk]
        # products of the inputs' dtype, accumulated in float32
        s = torch.einsum("bskgh,bckh->bskgc", qg.float(), kc.float()) * scale
        kv_pos = i0 + torch.arange(kc.shape[1], device=qg.device)
        mask = torch.ones((Sq, kc.shape[1]), dtype=torch.bool,
                          device=qg.device)
        if causal:
            mask &= kv_pos[None, :] <= q_pos[:, None]
        if window:
            mask &= kv_pos[None, :] > q_pos[:, None] - window
        mask = replicated_like(mask, s)
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bskgc,bckh->bskgh", p.to(vc.dtype).float(), vc.float())
        m = m_new
    return acc / torch.clamp(l[..., None], min=1e-37)


def chunked_attention(q, k, v, *, causal: bool, window: int = 0,
                      chunk: int = 1024, q_chunk: int = 512, q_offset=0):
    """Double-blocked online-softmax attention (flash semantics, plain
    PyTorch).  q: (B, S, H, hd); k, v: (B, T, KV, hd); GQA via head
    grouping.  ``q_offset``: absolute position of q[:, 0].  When autograd
    records, each block of ``q_chunk`` queries is recomputed in the
    backward pass (``torch.utils.checkpoint``), so the (S x T) scores are
    never saved.

    Under a mesh q, k, v, the output and their grads are sharded over the
    batch alone (the heads gathered): the einsums fold the batch and
    KV-head dims into one, which DTensor refuses when both are sharded
    (torch 2.11) or plans slowly (2.13)."""
    q, k, v = (constrain(t, BATCH_ONLY) for t in (q, k, v))
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    qc = min(q_chunk, S)
    if S % qc:
        qc = S          # odd small sizes: single block
    qg = q.reshape(B, S, KV, G, hd)
    recompute = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    kw = dict(causal=causal, window=window, chunk=chunk, scale=scale)
    outs = []
    for s0 in range(0, S, qc):
        q_pos = q_offset + s0 + torch.arange(qc, device=q.device)
        if recompute:
            outs.append(checkpoint(_online_softmax, qg[:, s0:s0 + qc], k, v,
                                   q_pos, use_reentrant=False, **kw))
        else:
            outs.append(_online_softmax(qg[:, s0:s0 + qc], k, v, q_pos,
                                        **kw))
    out = torch.cat(outs, dim=1).reshape(B, S, H, hd).to(q.dtype)
    return constrain(out, BATCH_ONLY)     # and its grad


def decode_attention(q, k_cache, v_cache, cache_len):
    """Single-token attention over a KV cache.

    q: (B, 1, H, hd); caches: (B, T, KV, hd); cache_len: valid entries (an
    int, or a (B,) tensor).  The dots run in the cache dtype; only the
    small score tensor is upcast for the softmax.
    """
    B, _, H, hd = q.shape
    T, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    scale = hd ** -0.5
    qg = q.reshape(B, KV, G, hd)
    s = torch.einsum("bkgh,btkh->bkgt", qg.to(k_cache.dtype), k_cache)
    s = s.float() * scale
    pos = torch.arange(T, device=q.device)
    limit = cache_len if isinstance(cache_len, int) \
        else cache_len.reshape(-1, 1)
    valid = pos[None, :] < limit
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkh->bkgh", p.to(v_cache.dtype), v_cache)
    return out.reshape(B, 1, H, hd).to(q.dtype)


def _attend(q, k, v, cfg, causal: bool, window: int, mode: str):
    """Attention of a whole sequence.  Prefill: the flash wrapper, the
    hand-written kernel for CUDA tensors and its plain version for CPU
    tensors.  Train: ``chunked_attention`` over ``cfg.attn_chunk`` keys,
    as the JAX package's default ``attention_impl="xla"`` trains, each
    query block recomputed in the backward pass.  ``cfg.attention_impl``
    selects nothing here."""
    if mode == "train":
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 chunk=cfg.attn_chunk)
    return ops.flash_attention(q, k, v, causal=causal, window=window)


def quant_kv(x):
    """Symmetric int8 per-(batch, position, kv-head): x (B,T,KV,hd) ->
    (int8 codes, f32 scales (B,T,KV)).  ``torch.round`` rounds half to
    even, as ``jnp.round`` does."""
    x = x.float()
    scale = x.abs().amax(dim=-1) / 127.0 + 1e-9
    q = torch.clamp(torch.round(x / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequant_kv(q, scale, dtype):
    return (q.float() * scale[..., None]).to(dtype)


def attn_apply(p, x, *, cfg, mode: str, cache: Optional[Dict] = None,
               pos=None, window: int = 0, causal: bool = True,
               kv_override: Optional[Tuple] = None):
    """Full attention sub-block: qkv proj + rope + attend + out proj.

    p: holds ``wq`` (d,H,hd), ``wk``/``wv`` (d,KV,hd), ``wo`` (H*hd,d).
    mode: 'train' | 'prefill' (writes the cache) | 'decode' (appends).
    cache: {"k": (B,T,KV,hd), "v": ..., "len": int[, "k_scale",
    "v_scale": (B,T,KV)]}, updated in place (the port's counterpart of
    JAX's donated cache).  kv_override: (k, v) of cross-attention, already
    projected (B,T,KV,hd): no rope, no cache, and no causal mask.
    Returns (out, cache).
    """
    B, S, d = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p.wq.reshape(d, H * hd).to(x.dtype)).view(B, S, H, hd)
    if kv_override is not None:
        k, v = kv_override
        out = decode_attention(q, k, v, k.shape[1]) if mode == "decode" \
            else chunked_attention(q, k, v, causal=False,
                                   chunk=cfg.attn_chunk)
        return out.reshape(B, S, H * hd) @ p.wo.to(x.dtype), cache
    k = (x @ p.wk.reshape(d, KV * hd).to(x.dtype)).view(B, S, KV, hd)
    v = (x @ p.wv.reshape(d, KV * hd).to(x.dtype)).view(B, S, KV, hd)
    if pos is None:
        pos = replicated_like(torch.arange(S, device=x.device)[None, :], x)
    if cfg.rope_theta > 0:
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    q = constrain(q, ("batch", "seq", "heads", None))

    if mode == "train" or (mode == "prefill" and cache is None):
        out = _attend(q, k, v, cfg, causal, window, mode)
    elif mode == "prefill":
        out = _attend(q, k, v, cfg, causal, window, mode)
        T = cache["k"].shape[1]
        kk, vv = (k[:, S - T:], v[:, S - T:]) if T < S else (k, v)
        n = kk.shape[1]
        if "k_scale" in cache:
            kk, ks = quant_kv(kk)
            vv, vs = quant_kv(vv)
            cache["k_scale"][:, :n] = ks
            cache["v_scale"][:, :n] = vs
        cache["k"][:, :n] = kk.to(cache["k"].dtype)
        cache["v"][:, :n] = vv.to(cache["v"].dtype)
        cache["len"] = min(S, T)
    elif mode == "decode":
        T = cache["k"].shape[1]
        # ring-buffer slot for windowed caches, plain append otherwise
        slot = cache["len"] % T if window else min(cache["len"], T - 1)
        cache_len = min(cache["len"] + 1, T)
        if "k_scale" in cache:
            kq, ks = quant_kv(k)
            vq, vs = quant_kv(v)
            cache["k"][:, slot:slot + 1] = kq
            cache["v"][:, slot:slot + 1] = vq
            cache["k_scale"][:, slot:slot + 1] = ks
            cache["v_scale"][:, slot:slot + 1] = vs
            out = decode_attention(
                q, dequant_kv(cache["k"], cache["k_scale"], x.dtype),
                dequant_kv(cache["v"], cache["v_scale"], x.dtype), cache_len)
        else:
            cache["k"][:, slot:slot + 1] = k.to(cache["k"].dtype)
            cache["v"][:, slot:slot + 1] = v.to(cache["v"].dtype)
            out = decode_attention(q, cache["k"], cache["v"], cache_len)
        cache["len"] += 1
    else:
        raise ValueError(mode)
    out = out.reshape(B, S, H * hd)
    return out @ p.wo.to(x.dtype), cache


class Attention(nn.Module):
    """GQA attention weights in the JAX package's shapes."""

    def __init__(self, d: int, n_heads: int, n_kv: int, hd: int, dtype,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.wq = nn.Parameter(torch.empty(d, n_heads, hd, **kw))
        self.wk = nn.Parameter(torch.empty(d, n_kv, hd, **kw))
        self.wv = nn.Parameter(torch.empty(d, n_kv, hd, **kw))
        self.wo = nn.Parameter(torch.empty(n_heads * hd, d, **kw))

    def init(self, generator: torch.Generator) -> None:
        d = self.wq.shape[0]
        for w in (self.wq, self.wk, self.wv):
            dense_init_(w, d, generator)
        dense_init_(self.wo, self.wo.shape[0], generator)

    def forward(self, x, **kw):
        return attn_apply(self, x, **kw)
