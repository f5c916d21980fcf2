"""Gradient compression for the cross-pod all-reduce: the JAX package's
``runtime/compression.py`` over ``torch.distributed``.

int8 per-tensor symmetric quantization with error feedback: the pod axis
is the slow link, so shrinking that one all-reduce 4x (fp32 -> int8)
moves the collective term directly.  Error feedback keeps the scheme
unbiased over time (the residual is carried in fp32 state the same shape
as the grads, sharded like the params).

A grad may be a DTensor sharded over a pod's ("data", "model") sub-mesh.
Its scale is the maximum over the whole tensor, across those shards too,
as ``jnp.max`` is inside a ``shard_map`` manual over "pod" alone; then a
MAX crosses the pod group, so every pod and every shard quantizes with
one scale.  The int8 codes are summed over the pod group shard by shard:
the pod group joins the ranks that hold the same shard in each pod.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..sharding.partition import unshard


def _div(t: torch.Tensor, n) -> torch.Tensor:
    """``t / n`` rounded once on every device: CUDA divides by a Python
    number through its reciprocal (one more rounding), by a tensor
    exactly."""
    return t / torch.full((), float(n), device=t.device)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 codes, float32 scale): scale = max|x| / 127 + 1e-12."""
    scale = _div(x.float().abs().amax(), 127) + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _allreduce_sum(q: torch.Tensor, group) -> torch.Tensor:
    """``q`` summed over ``group``.  For a DTensor, its local shard is
    summed with the same shard of the other pods (whose sub-meshes are
    laid out alike) and wrapped back with the same placements."""
    if not isinstance(q, DTensor):
        dist.all_reduce(q, op=dist.ReduceOp.SUM, group=group)
        return q
    loc = q.to_local().contiguous()
    dist.all_reduce(loc, op=dist.ReduceOp.SUM, group=group)
    return DTensor.from_local(loc, q.device_mesh, q.placements,
                              run_check=False, shape=q.shape,
                              stride=q.stride())


def compress_grads_allreduce(grads: Dict[str, torch.Tensor],
                             residual: Dict[str, torch.Tensor],
                             group: Optional[dist.ProcessGroup] = None,
                             n_pods: int = 2,
                             codes: Optional[Dict] = None):
    """Quantize (grad + residual) with a scale shared across pods, sum a
    true int8 payload over ``group`` (the pod group; None: no other pod),
    dequantize, and carry the quantization error into the residual.

    The range is +-(127 // n_pods), so the int8 sum over ``n_pods`` pods
    cannot overflow: the wire payload really is one byte an element.
    ``codes``, when given, receives each key's (int8 codes, scale)
    before the sum.

    Returns (synced_grads, new_residual), dicts keyed as ``grads``."""
    qmax = max(127 // n_pods, 1)
    n = 1 if group is None else dist.get_world_size(group)
    synced, new_res = {}, {}
    for k, g in grads.items():
        g = g.float() + residual[k]
        # shared scale across shards and pods (one tiny MAX) so the int8
        # sum is exact
        amax = unshard(g.abs().amax())
        if group is not None:
            dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        scale = _div(amax, qmax) + 1e-12
        q = torch.clamp(torch.round(g / scale), -qmax, qmax).to(torch.int8)
        new_res[k] = g - q.float() * scale        # error feedback
        if codes is not None:
            codes[k] = (q.detach().clone(), scale.clone())
        if group is not None:
            q = _allreduce_sum(q, group)          # int8 on the wire
        synced[k] = _div(q.float() * scale, n)
    return synced, new_res


def init_residual(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """float32 zeros shaped (and, for DTensors, placed) like ``params``."""
    return {k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in params.items()}
