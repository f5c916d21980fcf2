"""Logical-axis partitioning (MaxText-style) on a torch ``DeviceMesh``:
the JAX package's ``sharding/partition.py``, with DTensor placements in
place of ``NamedSharding``.

Mesh axes:
  single-pod:  ("data", "model")            = (16, 16)   -> 256 ranks
  multi-pod:   ("pod", "data", "model")     = (2, 16, 16) -> 512 ranks

Logical axes used by the model code:
  "batch"        -> ("pod", "data")   activations' batch dim
  "fsdp"         -> "data"            param dim sharded ZeRO-style
  "tensor"       -> "model"           TP dim (heads / ffn / vocab / experts)
  "expert"       -> "model"           expert parallelism for MoE stacks
  "seq"          -> None by default; "model" under sequence parallelism
  "layers"/None  -> replicated

The "pod" axis is pure data parallelism: params are replicated across
pods (only the gradient all-reduce crosses pods, once per step), while
FSDP stays inside a pod.

``logical_to_spec`` gives the JAX ``PartitionSpec``'s entries as a
tuple: per tensor dim ``None``, one mesh axis name, or a tuple of names.
``spec_to_placements`` turns such a spec into one DTensor placement per
mesh dim: ``Shard(tensor_dim)`` where the dim's entry names that mesh
axis, else ``Replicate()``.  A tuple entry such as ``("pod", "data")``
shards one tensor dim over two mesh dims, major first, which is how
DTensor splits a dim that several mesh dims shard, provided the tuple
lists them in mesh order (asserted).

Every function here takes a ``DeviceMesh`` or a ``MeshShape`` (axis
names and sizes, no devices): specs depend on nothing else, so the
production meshes' specs are computed without 256 ranks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)


@dataclass(frozen=True)
class ShardingRules:
    """logical axis name -> mesh axis (or tuple of mesh axes)."""
    rules: Tuple[Tuple[str, Any], ...] = (
        ("batch", ("pod", "data")),
        ("fsdp", "data"),
        ("tensor", "model"),
        ("expert", "model"),
        ("heads", "model"),
        ("kv_heads", "model"),
        ("vocab", "model"),
        ("ffn", "model"),
        ("seq", None),
        ("act_seq", None),      # residual-stream seq dim between blocks
        ("kv_seq", None),       # decode KV-cache length dim (serving)
        ("lru", "model"),
        ("layers", None),
    )

    def to_dict(self) -> Dict[str, Any]:
        return dict(self.rules)

    def with_overrides(self, **kw) -> "ShardingRules":
        d = self.to_dict()
        d.update(kw)
        return ShardingRules(tuple(d.items()))


DEFAULT_RULES = ShardingRules()

# sequence-parallel variant for very long sequences
SP_RULES = DEFAULT_RULES.with_overrides(seq="model")

# activation sequence-sharding: the residual stream between blocks lives
# seq-sharded over 'model' and is re-gathered at each attention entry
ACT_SP_RULES = DEFAULT_RULES.with_overrides(act_seq="model")

# serving: weights replicated across 'data', TP over 'model', the KV
# cache length-sharded over 'model'
SERVE_RULES = DEFAULT_RULES.with_overrides(fsdp=None, kv_seq="model")

# big-model serving: the fsdp dim stays sharded over 'data' as well
SERVE_BIG_RULES = DEFAULT_RULES.with_overrides(kv_seq="model")

# pure FSDP (no tensor parallelism): params sharded over every rank,
# the batch over every rank
FSDP_RULES = DEFAULT_RULES.with_overrides(
    batch=("pod", "data", "model"),
    fsdp=("data", "model"), tensor=None, heads=None, kv_heads=None,
    vocab=None, ffn=None, lru=None, expert=None)


@dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, without devices."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]


def mesh_shape(mesh) -> MeshShape:
    """The axis names and sizes of a ``DeviceMesh`` (or a ``MeshShape``)."""
    if isinstance(mesh, MeshShape):
        return mesh
    return MeshShape(tuple(mesh.mesh_dim_names), tuple(mesh.mesh.shape))


Spec = Tuple[Any, ...]


def logical_to_spec(axes: Tuple[Optional[str], ...], mesh,
                    rules: ShardingRules = DEFAULT_RULES,
                    shape: Optional[Tuple[int, ...]] = None) -> Spec:
    """Map logical axis names to the entries of a partition spec valid for
    this mesh.

    If ``shape`` is given, mesh axes whose size does not divide the
    corresponding dimension are dropped (dim replicated) — e.g. smollm's
    9 attention heads cannot be TP-sharded 16 ways; multi-axis entries
    keep the longest dividing prefix (("pod","data") on a batch divisible
    by 2 but not 32 keeps just "pod").  Trailing ``None`` entries are
    trimmed, as ``PartitionSpec`` is.
    """
    ms = mesh_shape(mesh)
    table = rules.to_dict()
    mesh_axes = set(ms.axis_names)
    sizes = dict(zip(ms.axis_names, ms.shape))
    used = set()
    out: List[Any] = []
    for i, ax in enumerate(axes):
        if ax is None:
            out.append(None)
            continue
        m = table.get(ax, None)
        if m is None:
            out.append(None)
            continue
        cand = tuple(a for a in ((m,) if isinstance(m, str) else m)
                     if a in mesh_axes and a not in used)
        if shape is not None and i < len(shape):
            kept, prod = [], 1
            for a in cand:
                if shape[i] % (prod * sizes[a]) == 0:
                    kept.append(a)
                    prod *= sizes[a]
                else:
                    break
            cand = tuple(kept)
        for a in cand:
            used.add(a)
        out.append(cand if len(cand) > 1 else (cand[0] if cand else None))
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def spec_to_placements(spec: Spec, mesh) -> Tuple:
    """One DTensor placement per mesh dim: ``Shard(d)`` for the tensor dim
    ``d`` whose spec entry names that mesh axis, else ``Replicate()``.  A
    mesh dim of size 1 replicates: a shard over it is the whole tensor,
    and DTensor (torch 2.11) refuses to fold two dims that both carry a
    ``Shard``, even over size-1 mesh dims."""
    ms = mesh_shape(mesh)
    names = ms.axis_names
    dim_of: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        group = () if entry is None else \
            (entry,) if isinstance(entry, str) else tuple(entry)
        order = [names.index(a) for a in group]
        assert order == sorted(order), \
            f"spec entry {entry} is not in mesh order {names}"
        for a in group:
            dim_of[a] = d
    return tuple(Shard(dim_of[a]) if a in dim_of and n > 1 else Replicate()
                 for a, n in zip(names, ms.shape))


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec on it: the port's ``jax.sharding.NamedSharding``.
    ``placements`` are the DTensor placements of ``spec``."""
    mesh: Any
    spec: Spec

    @property
    def placements(self) -> Tuple:
        return spec_to_placements(self.spec, self.mesh)


def _is_axes_leaf(x) -> bool:
    return isinstance(x, tuple) and \
        all(a is None or isinstance(a, str) for a in x)


def _map_like(axes_tree, fn, specs_tree=None):
    """``axes_tree``'s structure with ``fn(axes, spec_leaf)`` at each axes
    leaf; ``spec_leaf`` is the matching node of ``specs_tree`` (None
    without one)."""
    if _is_axes_leaf(axes_tree):
        return fn(axes_tree, specs_tree)
    if isinstance(axes_tree, Mapping):
        if specs_tree is not None:
            assert set(specs_tree) == set(axes_tree), \
                (sorted(specs_tree), sorted(axes_tree))
        return {k: _map_like(v, fn, None if specs_tree is None
                             else specs_tree[k])
                for k, v in axes_tree.items()}
    if specs_tree is not None:
        assert len(specs_tree) == len(axes_tree), \
            (len(specs_tree), len(axes_tree))
    return type(axes_tree)(
        _map_like(v, fn, None if specs_tree is None else specs_tree[i])
        for i, v in enumerate(axes_tree))


def shardings_for_tree(logical_tree, mesh,
                       rules: ShardingRules = DEFAULT_RULES,
                       specs_tree=None):
    """Map a tree of logical-axis tuples to ``NamedSharding``s.

    ``specs_tree`` (a matching tree of tensors, or of anything with a
    ``.shape``) enables divisibility-aware axis dropping.
    """
    def one(axes, s):
        shape = None if s is None else tuple(s.shape)
        return NamedSharding(mesh, logical_to_spec(axes, mesh, rules, shape))
    return _map_like(logical_tree, one, specs_tree)


# module-level mesh/rules context so model code can constrain activations
# without threading a mesh handle through every layer
_CURRENT: Dict[str, Any] = {"mesh": None, "rules": DEFAULT_RULES}


def set_mesh(mesh, rules: ShardingRules = DEFAULT_RULES) -> None:
    _CURRENT["mesh"] = mesh
    _CURRENT["rules"] = rules


class use_mesh:
    """Context manager: activate a mesh (+rules) for logical constraints."""

    def __init__(self, mesh, rules: ShardingRules = DEFAULT_RULES):
        self.new = (mesh, rules)

    def __enter__(self):
        self.old = (_CURRENT["mesh"], _CURRENT["rules"])
        set_mesh(*self.new)
        return self.new[0]

    def __exit__(self, *exc):
        set_mesh(*self.old)
        return False


def current_mesh():
    return _CURRENT["mesh"]


def current_rules() -> ShardingRules:
    return _CURRENT["rules"]


class _GradTo(torch.autograd.Function):
    """Identity forward; the backward puts the grad on ``placements``."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g, None


def constrain_tree(tree, axes_tree, rules: Optional[ShardingRules] = None):
    """``constrain`` every leaf of ``tree`` with the matching logical axes
    from ``axes_tree`` (same structure, tuple-of-names leaves)."""
    return _map_like(axes_tree, lambda a, x: constrain(x, a, rules), tree)


def constrain(x, axes: Tuple[Optional[str], ...],
              rules: Optional[ShardingRules] = None):
    """Redistribute a DTensor to the placements of its logical axes, on
    its shape, and its grad in the backward pass to the same placements,
    as the transpose of ``with_sharding_constraint`` constrains the
    cotangent (a no-op outside a mesh).  Under a mesh a plain tensor with
    a dimension raises: it has fallen out of DTensor."""
    mesh = _CURRENT["mesh"]
    if mesh is None:
        return x
    if not isinstance(x, DTensor):
        if x.dim() == 0:
            return x
        raise TypeError(
            f"constrain{tuple(axes)}: a plain {tuple(x.shape)} tensor under "
            "an active mesh (it fell out of DTensor)")
    rules = rules or _CURRENT["rules"]
    axes = tuple(axes)[:x.dim()]
    spec = logical_to_spec(axes, mesh, rules, tuple(x.shape))
    placements = spec_to_placements(spec, x.device_mesh)
    if tuple(x.placements) != placements:
        x = x.redistribute(x.device_mesh, placements)
    return _GradTo.apply(x, placements) if x.requires_grad else x


def distribute(t: torch.Tensor, sharding: NamedSharding) -> DTensor:
    """``t`` (the same full tensor on every rank) as a DTensor placed by
    ``sharding``: each rank keeps its own shard, nothing is sent."""
    return distribute_tensor(t.detach(), sharding.mesh,
                             list(sharding.placements), src_data_rank=None)


def unshard(t: torch.Tensor) -> torch.Tensor:
    """``t`` whole: a DTensor gathered (``full_tensor()``, a collective
    over its mesh), a plain tensor as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def replicated_like(t: torch.Tensor, ref):
    """``t`` (the same on every rank) as a replicated DTensor on ``ref``'s
    mesh when ``ref`` is a DTensor, else ``t``: positions, masks and
    tables that the model builds beside its activations, so no plain
    tensor meets a DTensor."""
    if not isinstance(ref, DTensor):
        return t
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def divisible_pad(n: int, k: int) -> int:
    return -(-n // k) * k
