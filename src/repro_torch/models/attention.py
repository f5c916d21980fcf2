"""GQA attention: prefill through the hand-written flash kernel, training
and decode in plain PyTorch (decode over a preallocated KV cache updated
in place).  Cross-attention (``kv_override``, the enc-dec decoder's) runs
``chunked_attention`` or ``decode_attention`` in every mode, as the JAX
package never sends it to its kernel; under a mesh a prefill's
cross-attention over the length-sharded cross (k, v) takes the split-K
below, as decode's does.

``chunked_attention`` is the JAX package's chunked online-softmax path
(its default ``attention_impl="xla"``) in plain PyTorch.  Train mode runs
through it, as the JAX package trains: no kernel of either package has a
backward, and the flash wrapper refuses inputs that require grad on the
card.  Under autograd each query block runs in ``torch.utils.checkpoint``,
so the backward pass recomputes the block's scores instead of saving them
(the port's counterpart of the JAX package's ``@jax.checkpoint``).  It is
also the model's plain reference, with which ``chip_smoke.py`` recomputes
a served prefill in place of the kernel.

Under a mesh (the serve rules: heads over "model", the KV cache's length
``kv_seq`` over "model") prefill runs the flash kernel on each rank's
query heads and the KV heads they use (``_flash_per_shard``), each rank
writes the cache positions it holds (``write_positions``), and decode is
a split-K (flash decoding): each rank scores its own cache positions
(``decode_partials``) and a log-sum-exp combine over the length shards
(``combine_partials``) gives the output.  Without a mesh nothing of this
runs and every path is the one above.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from torch.distributed.tensor import DTensor, Replicate, Shard

from ..kernels import ops
from ..sharding.partition import (_contiguous_strides, constrain,
                                  current_mesh, per_shard, pin_grad,
                                  replicated_like, shard_range)
from .layers import apply_rope, dense_init_, split_heads

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
    small score tensor is upcast for the softmax.  A cache that is a
    DTensor (under a mesh) takes the split-K path, ``_decode_on_mesh``,
    with an int ``cache_len``; there q may hold Sq queries (B, Sq, H, hd),
    each against every valid position (a prefill's cross-attention).
    """
    if isinstance(k_cache, DTensor):
        return _decode_on_mesh(q, k_cache, v_cache, cache_len)
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


def decode_partials(q, k_part, v_part, cache_len, offset: int = 0):
    """One part of a split-K decode: q (B, Sq, H, hd) against the cache
    positions offset .. offset + T' - 1, k_part and v_part (B, T', KV, hd),
    every query against every valid position (no causal mask: a decode
    step's one query, or the Sq queries of a cross-attention).  A position
    is valid where it lies below ``cache_len`` (an int, or a (B,) tensor).
    Returns float32 (m, l, o): the row max of the scaled scores (B, Sq,
    KV, G), the sum of exp(s - m) over the part (B, Sq, KV, G) and the
    weighted sum of V (B, Sq, KV, G, hd), the probabilities in the cache
    dtype as ``decode_attention`` takes them.

    A part whose positions all lie at or past ``cache_len`` has every
    score at ``NEG_INF`` (finite): its m is NEG_INF and its l its own
    length, and ``combine_partials`` gives it the weight exp(NEG_INF - M),
    exactly 0, beside any part with a valid position."""
    B, Sq, H, hd = q.shape
    T, KV = k_part.shape[1], k_part.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd)
    s = torch.einsum("bskgh,btkh->bskgt", qg.to(k_part.dtype), k_part)
    s = s.float() * hd ** -0.5
    pos = offset + torch.arange(T, device=q.device)
    limit = cache_len if isinstance(cache_len, int) \
        else cache_len.reshape(-1, 1)
    valid = pos[None, :] < limit
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    o = torch.einsum("bskgt,btkh->bskgh", p.to(v_part.dtype), v_part)
    return m, p.sum(dim=-1), o.float()


def combine_partials(m, l, o):
    """The log-sum-exp combine of a split-K decode's parts, stacked on a
    leading dim (``decode_partials``' m, l (P, B, Sq, KV, G) and o (P, B,
    Sq, KV, G, hd)): each part weighted by exp(m_p - M), M the max over the
    parts.  Returns the attention output (B, Sq, KV, G, hd) in float32; the
    parts are summed in their order, so every rank that combines the same
    parts gets the same bits."""
    w = torch.exp(m - m.amax(dim=0))
    return (w[..., None] * o).sum(dim=0) / (w * l).sum(dim=0)[..., None]


def _decode_on_mesh(q, k_cache, v_cache, cache_len: int):
    """Split-K decode over a length-sharded KV cache (DTensors): each rank
    scores its own cache positions (its batch rows and KV heads, and q's
    heads of those KV heads) with validity in global positions, the
    parts (m, l, o) are gathered over the mesh dims that split the length,
    and every rank combines them (``combine_partials``).  q (B, Sq, H, hd)
    holds one decode query or the queries of a cross-attention; a rank's
    offset and length are its shard's own (``shard_range``), so an uneven
    split of the length (1500 frames in 8 parts) masks and combines in
    global positions as an even one does.  Returns (B, Sq, H, hd) placed as
    the cache's batch rows and KV heads, all of the length dims
    replicated."""
    mesh = k_cache.device_mesh
    pl = tuple(k_cache.placements)
    length = [i for i, p in enumerate(pl) if isinstance(p, Shard)
              and p.dim == 1]
    # q's heads split as the cache's KV heads: a block of KV heads holds
    # the block of query heads it serves (head h uses KV head h // G)
    qpl = [Replicate() if i in length else p for i, p in enumerate(pl)]
    q = q.redistribute(mesh, qpl)
    offset, _ = shard_range(k_cache, 1)
    parts = decode_partials(q.to_local(), k_cache.to_local(),
                            v_cache.to_local(), cache_len, offset)
    if length:
        # each part on a new leading dim, gathered over the length shards
        ppl = [Shard(0) if i in length else
               Shard(1) if isinstance(p, Shard) and p.dim == 0 else p
               for i, p in enumerate(pl)]
        gathered = [Replicate() if i in length else p
                    for i, p in enumerate(ppl)]
        n = math.prod(mesh.size(i) for i in length)
        B, KV = k_cache.shape[0], k_cache.shape[2]
        out = []
        for t in parts:
            shape = (n, B, KV) + tuple(t.shape[2:])
            dt = DTensor.from_local(t[None], mesh, ppl, run_check=False,
                                    shape=torch.Size(shape),
                                    stride=_contiguous_strides(shape))
            out.append(dt.redistribute(mesh, gathered).to_local())
        parts = out
    else:
        parts = [t[None] for t in parts]
    ql = q.to_local()
    o = combine_partials(*parts).reshape(ql.shape).to(ql.dtype)
    return DTensor.from_local(o, mesh, qpl, run_check=False,
                              shape=q.shape,
                              stride=_contiguous_strides(q.shape))


def _kv_of_heads(k, v, h0: int, Hl: int, G: int, k0: int):
    """The KV heads that query heads h0 .. h0 + Hl - 1 use (head h: KV
    head h // G) out of k, v (B, T, KV', hd), which hold KV heads k0 ..
    k0 + KV' - 1: a slice where the local heads group evenly, else one KV
    head per query head."""
    KVl = k.shape[2]
    lo, hi = h0 // G - k0, (h0 + Hl - 1) // G - k0 + 1
    if (h0 % G == 0 and Hl % G == 0) or (hi - lo == 1 and G % Hl == 0):
        if (lo, hi) == (0, KVl):
            return k, v
        return k[:, :, lo:hi], v[:, :, lo:hi]
    idx = (h0 + torch.arange(Hl, device=k.device)) // G - k0
    return k.index_select(2, idx), v.index_select(2, idx)


def _flash_per_shard(q, k, v, causal: bool, window: int):
    """``ops.flash_attention`` (the kernel for CUDA tensors) on each rank's
    query heads and the KV heads they use.  Where the KV heads do not
    divide the "model" axis but the query heads do, k and v come
    replicated and each rank takes the KV heads of its own block of query
    heads.  Outside a mesh, the wrapper on the whole tensors."""
    if current_mesh() is None or not isinstance(q, DTensor):
        return ops.flash_attention(q, k, v, causal=causal, window=window)
    q_ax, kv_ax = ("batch", None, "heads", None), ("batch", None,
                                                    "kv_heads", None)
    q = constrain(q, q_ax)
    k, v = constrain(k, kv_ax), constrain(v, kv_ax)
    (h0, Hl), (k0, _) = shard_range(q, 2), shard_range(k, 2)
    G = q.shape[2] // k.shape[2]

    def local(q, k, v):
        k, v = _kv_of_heads(k, v, h0, Hl, G, k0)
        return ops.flash_attention(q, k, v, causal=causal, window=window)
    return per_shard(local, (q, k, v), (None,) * 3, [(q_ax, q.shape)])


def write_part(part, src, start: int, offset: int = 0) -> None:
    """The share of cache[:, start:start + n] = src (B, n, ...) that falls
    in the positions offset .. offset + T' - 1 that ``part`` (B, T', ...)
    holds, in place, in the part's dtype; nothing where none does."""
    lo = max(start, offset)
    hi = min(start + src.shape[1], offset + part.shape[1])
    if lo < hi:
        part[:, lo - offset:hi - offset] = \
            src[:, lo - start:hi - start].to(part.dtype)


def write_positions(cache_t, src, start: int) -> None:
    """cache_t[:, start:start + n] = src (B, n, ...), in place, in the
    cache's dtype.  Under a mesh (a DTensor cache) each rank writes the
    share of the n positions that falls in the length range it holds
    (``shard_range``, ``write_part``), from src placed as the cache
    without its length split: a decode append (a plain slot, or the
    hybrid's ring slot len % T) lands on the one rank that holds it."""
    if not isinstance(cache_t, DTensor):
        write_part(cache_t, src, start)
        return
    mesh = cache_t.device_mesh
    spl = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p
           for p in cache_t.placements]
    write_part(cache_t.to_local(), src.redistribute(mesh, spl).to_local(),
               start, shard_range(cache_t, 1)[0])


def _attend(q, k, v, cfg, causal: bool, window: int, mode: str):
    """Attention of a whole sequence.  Prefill: the flash wrapper, the
    hand-written kernel for CUDA tensors and its plain version for CPU
    tensors, on each rank's heads under a mesh.  Train:
    ``chunked_attention`` over ``cfg.attn_chunk`` keys,
    as the JAX package's default ``attention_impl="xla"`` trains, each
    query block recomputed in the backward pass.  ``cfg.attention_impl``
    selects nothing here."""
    if mode == "train":
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 chunk=cfg.attn_chunk)
    return _flash_per_shard(q, k, v, causal, window)


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
    q = split_heads(x @ pin_grad(p.wq.reshape(d, H * hd)).to(x.dtype), H,
                     "heads")
    if kv_override is not None:
        k, v = kv_override
        if mode == "decode" or (mode == "prefill"
                                and isinstance(k, DTensor)):
            # under a mesh the cross (k, v) is the length-sharded cache of
            # ``cache_axes``: prefill's queries take the same split-K as
            # decode's one, and nothing of the cross is gathered
            out = decode_attention(q, k, v, k.shape[1])
        else:
            out = chunked_attention(q, k, v, causal=False,
                                    chunk=cfg.attn_chunk)
        return pin_grad(out.reshape(B, S, H * hd)) @ p.wo.to(x.dtype), cache
    k = split_heads(x @ pin_grad(p.wk.reshape(d, KV * hd)).to(x.dtype), KV,
                     "kv_heads")
    v = split_heads(x @ pin_grad(p.wv.reshape(d, KV * hd)).to(x.dtype), KV,
                     "kv_heads")
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
        if "k_scale" in cache:
            kk, ks = quant_kv(kk)
            vv, vs = quant_kv(vv)
            write_positions(cache["k_scale"], ks, 0)
            write_positions(cache["v_scale"], vs, 0)
        write_positions(cache["k"], kk, 0)
        write_positions(cache["v"], vv, 0)
        cache["len"] = min(S, T)
    elif mode == "decode":
        T = cache["k"].shape[1]
        # ring-buffer slot for windowed caches, plain append otherwise;
        # under a mesh only the rank that holds the slot writes it
        slot = cache["len"] % T if window else min(cache["len"], T - 1)
        cache_len = min(cache["len"] + 1, T)
        if "k_scale" in cache:
            kq, ks = quant_kv(k)
            vq, vs = quant_kv(v)
            write_positions(cache["k"], kq, slot)
            write_positions(cache["v"], vq, slot)
            write_positions(cache["k_scale"], ks, slot)
            write_positions(cache["v_scale"], vs, slot)
            out = decode_attention(
                q, dequant_kv(cache["k"], cache["k_scale"], x.dtype),
                dequant_kv(cache["v"], cache["v_scale"], x.dtype), cache_len)
        else:
            write_positions(cache["k"], k, slot)
            write_positions(cache["v"], v, slot)
            out = decode_attention(q, cache["k"], cache["v"], cache_len)
        cache["len"] += 1
    else:
        raise ValueError(mode)
    out = pin_grad(out.reshape(B, S, H * hd))
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
