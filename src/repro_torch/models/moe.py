"""Mixture-of-Experts block (Qwen3-MoE style: 128 experts, top-8).  Port
of ``src/repro/models/moe.py``'s one-device path.

Sort-based capacity dispatch:

  1. router logits (float32) -> top-k experts and their probabilities,
     renormalised over the k, per token
  2. the (token, expert) pairs flattened and stably sorted by expert
  3. each pair's position within its expert's run; pairs past the
     capacity C = int(capacity_factor * k * T / E) (at least 1) drop
  4. the kept pairs' activations scattered into (E, C, d) buckets (a
     dropped pair lands in an overflow row past them)
  5. each expert's SwiGLU ffn as one batched product over the experts
  6. combine: the weighted outputs added back to their tokens, in the
     compute dtype, each token's in the order of its experts' ids (the
     order in which the JAX scatter-add of the sorted pairs adds them),
     so the sum is the same on every run: no atomic adds

Aux metrics: the Switch-style load-balancing loss, the router z-loss and
the share of pairs dropped.

The JAX package takes ``_dispatch_groups`` groups of tokens, one per data
shard of its mesh, and one without a mesh; the MoE under a mesh (its
expert-parallel path) waits for ROADMAP.md queue 1 item 8c, so this
module always dispatches the T tokens of a call as one group, and its
``constrain`` sites replicate that group.  (Without a mesh the JAX loop
that halves the group count until each group holds at least k tokens
ends at 0 groups, and fails, when T < k; one group needs no such loop.)
Capacity depends on the call's T: a decode step of B tokens has C =
int(1.25 * k * B / E) or 1, so it drops pairs that a prefill of the
same tokens keeps.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..sharding.partition import constrain
from .layers import dense_init_

AUX_KEYS = ("moe_lb_loss", "moe_z_loss", "moe_dropped")


def moe_axes() -> Dict[str, Tuple]:
    """Logical axes of the MoE weights."""
    return {"router": ("fsdp", None),
            "wi": ("expert", "fsdp", None),
            "wg": ("expert", "fsdp", None),
            "wo": ("expert", None, "fsdp")}


def _replicated(t):
    """The JAX module's constraint of a (groups, ...) dispatch tensor to
    ("batch", None, ...), for the one group this module dispatches: a
    "batch" axis over one group always drops, so the tensor is
    replicated."""
    return constrain(t, (None,) * t.dim())


def route(p, xt, cfg):
    """Router of x (T, d): (logits (T, E) float32, probs, gate_w (T, k),
    gate_e (T, k)); gate_w renormalised over the k."""
    logits = (xt @ p.router.to(xt.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_e = torch.topk(probs, cfg.top_k, dim=-1)
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, gate_w, gate_e


def dispatch(gate_e, gate_w, E: int, C: int):
    """The sorted pairs of a (T, k) routing: (slot, token, weight, keep,
    order), each (T * k,).  slot = expert * C + position in the expert's
    run for a kept pair, E * C (the overflow row) for a dropped one; order
    maps a sorted pair to its flat (token * k + j) index."""
    T, K = gate_e.shape
    dev = gate_e.device
    flat_e = gate_e.reshape(T * K)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    st = torch.arange(T, device=dev).repeat_interleave(K)[order]
    sw = gate_w.reshape(T * K)[order]
    # position in the expert's run: index - the run's first index
    pos = torch.arange(T * K, device=dev) - torch.searchsorted(se, se)
    keep = pos < C
    slot = torch.where(keep, se * C + pos, torch.full_like(se, E * C))
    return slot, st, sw, keep, order


def experts(p, xt, slot, st, sw, keep, order, E: int, C: int):
    """Dispatch -> each expert's SwiGLU -> weighted combine, in xt's
    dtype.  xt (T, d); returns (T, d)."""
    T, d = xt.shape
    TK = slot.shape[0]
    dt = xt.dtype
    buckets = xt.new_zeros((E * C + 1, d)).index_put((slot,), xt[st])
    xe = buckets[:E * C].view(E, C, d)
    h = torch.bmm(xe, p.wi.to(dt))
    g = torch.bmm(xe, p.wg.to(dt))
    ye = torch.bmm(F.silu(g) * h, p.wo.to(dt)).view(E * C, d)
    contrib = ye[torch.clamp(slot, max=E * C - 1)] * sw[:, None].to(dt)
    contrib = torch.where(keep[:, None], contrib, contrib.new_zeros(()))
    # each token's sorted positions, ascending: its experts in id order
    inv = torch.empty_like(order)
    inv[order] = torch.arange(TK, device=order.device)
    parts = contrib[inv.view(T, TK // T).sort(dim=1).values]   # (T, k, d)
    out = parts[:, 0]
    for j in range(1, parts.shape[1]):
        out = out + parts[:, j]
    return out


def moe_apply(p, x, cfg) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, S, d) -> ((B, S, d), aux {``AUX_KEYS``: float32 0-d})."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    xt = _replicated(x.reshape(T, d))
    logits, probs, gate_w, gate_e = route(p, xt, cfg)
    logits, probs = _replicated(logits), _replicated(probs)
    C = int(cfg.capacity_factor * K * T / E) or 1
    slot, st, sw, keep, order = dispatch(gate_e, gate_w, E, C)
    slot = _replicated(slot)
    out = experts(p, xt, slot, st, sw, keep, order, E, C)
    me = probs.mean(dim=0)
    ce = torch.zeros(E, device=x.device).index_add_(
        0, gate_e.reshape(-1), torch.ones(T * K, device=x.device)) / (T * K)
    aux = {"moe_lb_loss": E * torch.sum(me * ce),
           "moe_z_loss": torch.logsumexp(logits, dim=-1).square().mean(),
           "moe_dropped": 1.0 - keep.float().mean()}
    return out.view(B, S, d), aux


class MoE(nn.Module):
    """MoE weights in the JAX package's shapes: router (d, E), wi and wg
    (E, d, f), wo (E, f, d)."""

    def __init__(self, cfg, dtype, device=None):
        super().__init__()
        d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
        kw = dict(dtype=dtype, device=device)
        self.router = nn.Parameter(torch.empty(d, E, **kw))
        self.wi = nn.Parameter(torch.empty(E, d, f, **kw))
        self.wg = nn.Parameter(torch.empty(E, d, f, **kw))
        self.wo = nn.Parameter(torch.empty(E, f, d, **kw))

    def init(self, generator: torch.Generator) -> None:
        E, d, f = self.wi.shape
        for w in (self.router, self.wi, self.wg):
            dense_init_(w, d, generator)
        dense_init_(self.wo, f, generator)

    def forward(self, x, cfg):
        return moe_apply(self, x, cfg)
