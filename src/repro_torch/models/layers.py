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
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Shard

from ..sharding.partition import (NamedSharding, constrain, current_mesh,
                                  current_rules, logical_to_spec, per_shard,
                                  pin_grad, reduce_partial, replicated_like,
                                  shard_range, spec_to_placements,
                                  zeros_placed)


class Spec(tuple):
    """A tensor's shape (the tuple itself) and its ``dtype``, without
    storage: the port's stand-in for ``jax.ShapeDtypeStruct`` (inputs,
    train states, decode caches)."""

    def __new__(cls, shape: Tuple[int, ...], dtype: torch.dtype):
        self = super().__new__(cls, shape)
        self.dtype = dtype
        return self

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self)


def zero_caches(specs, axes, device):
    """Zero decode caches of a tree of ``Spec``s (lists and tuples of
    dicts: the port's cache layout), where a 0-d spec (an attention
    cache's "len") is the int 0.  Under an active ``DeviceMesh`` each
    tensor is a DTensor placed by its logical axes in ``axes`` (the same
    structure) and made in its shards, never whole on a rank first."""
    mesh = current_mesh()
    placed = mesh is not None and hasattr(mesh, "get_coordinate")
    rules = current_rules()

    def one(spec, ax):
        if isinstance(spec, dict):
            return {k: one(spec[k], ax[k]) for k in spec}
        if not isinstance(spec, Spec):
            return type(spec)(one(s, a) for s, a in zip(spec, ax))
        if not spec.shape:
            return 0
        if not placed:
            return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
        sh = NamedSharding(mesh, logical_to_spec(ax, mesh, rules,
                                                 spec.shape))
        return zeros_placed(spec.shape, sh, dtype=spec.dtype, device=device)
    return one(specs, axes)


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


def split_heads(t, n: int, axis: str):
    """t (B, S, n * hd) viewed as (B, S, n, hd).  Under a mesh the last dim
    is first placed as its n heads are under logical ``axis`` (whole heads
    on each rank, or all of them where n does not divide the mesh axis),
    and so is its grad: DTensor (torch 2.11) may leave a product's output
    (or, torch 2.13, its grad) sharded across a head, which no view can
    split."""
    B, S, f = t.shape
    if isinstance(t, DTensor):
        mesh = t.device_mesh
        pl = spec_to_placements(logical_to_spec(
            ("batch", "seq", axis), mesh, current_rules(), (B, S, n)), mesh)
        if tuple(t.placements) != pl:
            t = t.redistribute(mesh, pl)
        # and its grad, which DTensor may also shard across a head
        t = pin_grad(t)
    return t.view(B, S, n, f // n)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def rope_freqs(hd: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, hd, 2, dtype=np.float32) / hd))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: (..., S).  Rotates the two halves of
    the head dim (not interleaved pairs), in float32."""
    hd = x.shape[-1]
    freqs = replicated_like(
        torch.from_numpy(rope_freqs(hd, theta)).to(x.device), x)
    ang = positions[..., :, None].float() * freqs          # (..., S, hd/2)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# MLP variants
# --------------------------------------------------------------------------

def stacked_axes(tree: Dict) -> Dict:
    """Every axes leaf of a nested dict with a leading "layers" axis: the
    axes of a subtree the JAX package stacks over its layers."""
    return {k: stacked_axes(v) if isinstance(v, dict) else ("layers",) + v
            for k, v in tree.items()}


def mlp_axes(kind: str) -> Dict[str, Tuple]:
    """Logical axes of an MLP's weights."""
    if kind == "swiglu":
        return {"wi": ("fsdp", "ffn"), "wg": ("fsdp", "ffn"),
                "wo": ("ffn", "fsdp")}
    return {"wi": ("fsdp", "ffn"), "wo": ("ffn", "fsdp")}


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
    h = constrain(h, ("batch", "seq", "ffn"))
    # the output keeps the whole sequence, as an attention output does
    # (``lm.Block``, which gathers the input's)
    return constrain(h @ wo.to(x.dtype), ("batch", "seq", None))


def tied_table(embed):
    """The embedding table (vocab, d), placed ("vocab", "fsdp"), for one of
    its uses.  Under a mesh each use's grad is put back on the table's
    own placements in the backward pass, so the lookup's grad and a tied
    head's grad meet on the same placements when autograd adds them:
    torch 2.11 cannot turn the lookup's d-sharded grad into the partial
    sum the head's grad is ("redistribute from S(1) to P(sum) not
    supported yet")."""
    return constrain(embed, ("vocab", "fsdp"))


def embed_lookup(tokens, embed, dtype):
    """The rows of the embedding table ``embed`` (vocab, d) at the ids
    ``tokens`` (B, S), in ``dtype``: the JAX package's ``jnp.take``.

    Under a mesh each rank looks up its own batch shard of the ids in its
    own vocab shard of the table (``per_shard``; the table comes through
    ``tied_table`` with its "fsdp" dim gathered, as any weight is), with
    zeros for the ids outside that shard.  The result, a partial sum over
    the mesh axes that split the vocab, is reduced over those axes alone
    and placed ("batch", "seq", None).  Each row has one non-zero term,
    so the sum is exact: the lookup equals the unsharded one bit for bit,
    and no rank holds more than its batch shard of the output.  The ids
    keep no mesh axis that splits the vocab (SP_RULES maps "seq" there
    too): a rank's ids and its rows must meet whole over such an axis.
    In the backward pass the table's grad leaves ``per_shard`` a partial
    sum over the axes that split the batch, and ``tied_table`` puts it
    on the table's own placements, where a tied head's grad meets it."""
    table = tied_table(embed)
    if current_mesh() is None:
        return F.embedding(tokens, table).to(dtype)
    mesh = table.device_mesh
    rules = current_rules()
    vocab = [a for a, p in zip(mesh.mesh_dim_names, table.placements)
             if p == Shard(0)]

    def mesh_axes(name, n):
        e = (logical_to_spec((name,), mesh, rules, (n,)) or (None,))[0]
        return () if e is None else (e,) if isinstance(e, str) else e
    ids_axes = tuple(None if set(mesh_axes(a, n)) & set(vocab) else a
                     for a, n in zip(("batch", "seq"), tokens.shape))
    off, n = shard_range(table, 0)

    def local(ids, rows):
        if n == table.shape[0]:
            return F.embedding(ids, rows).to(dtype)
        ids = ids - off
        miss = (ids < 0) | (ids >= n)
        x = F.embedding(ids.clamp(0, n - 1), rows).to(dtype)
        return x.masked_fill_(miss[..., None], 0)
    x = per_shard(local, (tokens, table), (ids_axes, ("vocab", None)),
                  [(ids_axes + (None,), tuple(tokens.shape)
                    + (table.shape[1],), vocab)])
    return constrain(reduce_partial(x), ("batch", "seq", None))


# --------------------------------------------------------------------------
# loss
# --------------------------------------------------------------------------

def softmax_xent(logits, labels, z_loss: float = 1e-4):
    """Cross entropy with optional z-loss; logits (..., V), labels (...).

    Under a mesh whose rules shard "vocab", the logits are gathered over
    the vocab first: DTensor's masked gather of the label logits from a
    vocab-sharded tensor fails (torch 2.13), and ``loss_parallel`` covers
    ``F.cross_entropy`` alone, not the z-loss's logsumexp."""
    logits = constrain(logits, ("batch", "act_seq", None)).float()
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
