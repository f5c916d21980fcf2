"""Mixture-of-Experts block (Qwen3-MoE style: 128 experts, top-8).  Port
of ``src/repro/models/moe.py``.

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

Without a mesh the T tokens of a call are one group.  Under a mesh they
are ``_dispatch_groups`` groups of T / G consecutive tokens, one per data
shard, as in the JAX package: G is the product of the mesh sizes of the
rules' "batch" axes, halved while it does not divide T or a group would
hold fewer than k tokens.  The loop stops at one group (the JAX one
halves to 0 and fails when T < k; so does its one-device path, which the
port does not follow).  Each group routes, sorts and takes its capacity
C = int(capacity_factor * k * T / (G * E)) or 1 on its own, on the rank
that holds it (``per_shard``): with more than one group a mesh keeps other
pairs than one group would whenever a group overflows.  Where "model"
has more than one rank, E divides by it and G is the pod x data rank
count, the expert-parallel path runs (the JAX ``shard_map`` path): each
rank runs only its E / model experts' rows of its group, adds their
weighted outputs into a (T / G, d) partial, and one all-reduce over
"model" sums the partials, in float32 (the JAX one sums them in the
compute dtype).  Every other mesh gathers the expert weights and runs
all E experts on each rank's groups (the JAX ``_token_path_auto``).
Capacity depends on the call's T: a decode step of B tokens has C =
int(1.25 * k * B / E) or 1, so it drops pairs that a prefill of the
same tokens keeps.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..sharding.partition import (constrain, current_mesh, current_rules,
                                  mesh_sizes, per_shard, rule_size)
from .layers import dense_init_

AUX_KEYS = ("moe_lb_loss", "moe_z_loss", "moe_dropped")


def moe_axes() -> Dict[str, Tuple]:
    """Logical axes of the MoE weights."""
    return {"router": ("fsdp", None),
            "wi": ("expert", "fsdp", None),
            "wg": ("expert", "fsdp", None),
            "wo": ("expert", None, "fsdp")}


def route(router, xt, cfg):
    """Router of x (T, d) with the (d, E) router weight: (logits (T, E)
    float32, probs, gate_w (T, k), gate_e (T, k)); gate_w renormalised
    over the k."""
    logits = (xt @ router.to(xt.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    return (logits, probs) + top_k(probs, cfg.top_k)


def top_k(probs, k: int):
    """(gate_w, gate_e) of router probabilities (..., E): the k largest
    and their experts, gate_w renormalised over the k."""
    gate_w, gate_e = torch.topk(probs, k, dim=-1)
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)
    return gate_w, gate_e


def _dispatch_groups(cfg) -> int:
    """Dispatch groups before the halving: the product of the active
    mesh's sizes of the rules' "batch" axes, 1 without a mesh (the JAX
    function; the mesh may be a ``MeshShape``)."""
    mesh = current_mesh()
    return 1 if mesh is None else rule_size("batch", mesh, current_rules())


def group_plan(T: int, cfg) -> Tuple[int, int, int]:
    """(G, T / G, C) of a call of T tokens: the group count halved while
    it does not divide T or a group would hold fewer than k tokens (down
    to one group), and each group's capacity."""
    G = _dispatch_groups(cfg)
    while G > 1 and (T % G or T // G < cfg.top_k):
        G //= 2
    Tl = T // G
    return G, Tl, int(cfg.capacity_factor * cfg.top_k * Tl
                      / cfg.n_experts) or 1


def expert_ranks(E: int, G: int) -> int:
    """The "model" rank count of the expert-parallel path under the active
    mesh, 0 where it does not apply: "model" has more than one rank, E
    divides by it and G is the pod x data rank count (the JAX
    ``_token_path``'s conditions)."""
    mesh = current_mesh()
    if mesh is None:
        return 0
    sizes = mesh_sizes(mesh)
    mp = sizes.get("model", 1)
    gm = sizes.get("pod", 1) * sizes.get("data", 1)
    return mp if mp > 1 and E % mp == 0 and G == gm else 0


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


def experts(wi, wg, wo, xt, slot, st, sw, keep, order, C: int, e0: int = 0):
    """Dispatch -> each expert's SwiGLU -> weighted combine, in xt's
    dtype, for the experts e0 .. e0 + E' - 1 whose weights wi, wg (E', d,
    f) and wo (E', f, d) are given (all E by default): a pair of another
    expert adds nothing.  xt (T, d); returns (T, d)."""
    T, d = xt.shape
    E_loc, TK = wi.shape[0], slot.shape[0]
    dt = xt.dtype
    rel = slot - e0 * C
    mine = keep & (rel >= 0) & (rel < E_loc * C)
    rel = torch.where(mine, rel, torch.full_like(rel, E_loc * C))
    buckets = xt.new_zeros((E_loc * C + 1, d)).index_put((rel,), xt[st])
    xe = buckets[:E_loc * C].view(E_loc, C, d)
    h = torch.bmm(xe, wi.to(dt))
    g = torch.bmm(xe, wg.to(dt))
    ye = torch.bmm(F.silu(g) * h, wo.to(dt)).view(E_loc * C, d)
    contrib = ye[torch.clamp(rel, max=E_loc * C - 1)] * sw[:, None].to(dt)
    contrib = torch.where(mine[:, None], contrib, contrib.new_zeros(()))
    # each token's sorted positions, ascending: its experts in id order
    inv = torch.empty_like(order)
    inv[order] = torch.arange(TK, device=order.device)
    parts = contrib[inv.view(T, TK // T).sort(dim=1).values]   # (T, k, d)
    out = parts[:, 0]
    for j in range(1, parts.shape[1]):
        out = out + parts[:, j]
    return out


def moe_apply(p, x, cfg) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, S, d) -> ((B, S, d), aux {``AUX_KEYS``: float32 0-d}).  The
    tokens are ``group_plan``'s G groups (one without a mesh) of xt (G,
    T / G, d) placed ("batch", None, None); each rank routes and
    dispatches the groups it holds (``per_shard``), on the
    expert-parallel path where ``expert_ranks`` says so."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    G, Tl, C = group_plan(T, cfg)
    grouped = ("batch", None, None)
    xt = constrain(x.reshape(G, Tl, d), grouped)
    mp = expert_ranks(E, G)
    rules = current_rules()
    e0 = 0
    if mp:
        # each "model" rank holds E / mp experts whatever "expert" maps to
        rules = rules.with_overrides(expert="model")
        e0 = xt.device_mesh.get_local_rank("model") * (E // mp)

    def local(xt, router, wi, wg, wo):
        outs, kept, counts, prob_sums, z_sums = [], [], [], [], []
        for g in range(xt.shape[0]):
            logits, probs, gate_w, gate_e = route(router, xt[g], cfg)
            slot, st, sw, keep, order = dispatch(gate_e, gate_w, E, C)
            outs.append(experts(wi, wg, wo, xt[g], slot, st, sw, keep,
                                order, C, e0))
            kept.append(keep.float().sum())
            counts.append(torch.zeros(E, device=xt.device).index_add_(
                0, gate_e.reshape(-1),
                torch.ones(Tl * K, device=xt.device)))
            prob_sums.append(probs.sum(dim=0))
            z_sums.append(torch.logsumexp(logits, dim=-1).square().sum())
        out, prob_sums, z_sums = (torch.stack(outs),
                                  torch.stack(prob_sums), torch.stack(z_sums))
        if mp:
            # the expert-parallel partial is summed over "model" in
            # float32; the router's sums, the same on every "model" rank,
            # enter that sum as 1 / mp of each, so their grads (each
            # rank's through its own routing) add up to one
            out, prob_sums, z_sums = out.float(), prob_sums / mp, z_sums / mp
        return out, torch.stack(kept), torch.stack(counts), prob_sums, z_sums
    w_axes = ("expert" if mp else None, None, None)
    partial = ("model",) if mp else ()
    out, kept, counts, prob_sums, z_sums = per_shard(
        local, (xt, p.router, p.wi, p.wg, p.wo),
        (grouped, (None, None), w_axes, w_axes, w_axes),
        [(grouped, (G, Tl, d), partial), (("batch",), (G,)),
         (("batch", None), (G, E)), (("batch", None), (G, E), partial),
         (("batch",), (G,), partial)], rules=rules)
    if mp:
        out = constrain(out, grouped)      # the all-reduce over "model"
    me = prob_sums.sum(dim=0) / T
    ce = counts.sum(dim=0) / (T * K)
    aux = {"moe_lb_loss": E * torch.sum(me * ce),
           "moe_z_loss": z_sums.sum() / T,
           "moe_dropped": 1.0 - kept.sum() / (T * K)}
    return out.to(x.dtype).reshape(B, S, d), aux


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
