"""Planning and building sharded train and serve steps: the JAX
package's ``launch/dryrun.py`` up to its lowering functions.

``count_params``, ``active_params`` and ``auto_plan`` are the JAX
functions.  ``_lower_train``, ``_lower_prefill`` and ``_lower_decode``
build what the JAX ones lower: the weights (and the train state, or the
decode caches) placed on the mesh by their logical axes, the inputs'
placements, and the function, ready to run (torch has no separate
lowering).  Serving takes bf16 copies of the floating weights
(``_serve_param_specs``), the KV cache's length sharded over "model"
under ``SERVE_RULES`` and ``SERVE_BIG_RULES``.  Build the model on the
``meta`` device to count a full-size one without allocating it.
``lower_cell``, ``main`` and the roofline tools (``roofline.py``,
``reanalyze.py``) wait for a later slice (ROADMAP.md queue 1, item 8e).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch
from torch.distributed.tensor import DTensor

from ..models.convert import jax_leaves, nest, place_params
from ..models.layers import Spec, zero_caches
from ..sharding.partition import (ACT_SP_RULES, DEFAULT_RULES,
                                  SERVE_BIG_RULES, SERVE_RULES,
                                  ShardingRules, distribute, mesh_shape,
                                  shardings_for_tree, use_mesh)
from ..train.trainstep import init_state, make_train_step, shard_state


def count_params(api) -> int:
    return sum(p.numel() for p in api.model.parameters())


def active_params(api, total: int) -> int:
    cfg = api.cfg
    if not cfg.n_experts:
        return total
    per_expert = 3 * cfg.d_model * cfg.d_ff
    inactive = cfg.n_layers * (cfg.n_experts - cfg.top_k) * per_expert
    return total - inactive


def auto_plan(arch, shape, mesh):
    """Pick grad-accumulation count + activation sharding so the saved
    remat working set (~6 B/elem: bf16 stack + the f32 backward copy)
    stays under ~4 GB a device.  Serving shapes use SERVE_RULES (weights
    replicated over 'data', KV cache length-sharded over 'model').  The
    budget is the JAX package's, sized for a 16 GB chip."""
    ms = mesh_shape(mesh)
    sizes = dict(zip(ms.axis_names, ms.shape))
    if shape.kind != "train":
        mp = sizes.get("model", 1)
        if arch.param_count() * 2 / mp > 8e9:     # bf16 weights vs 16G HBM
            return 1, SERVE_BIG_RULES
        return 1, SERVE_RULES
    dp = sizes.get("data", 1) * sizes.get("pod", 1)
    mp = sizes.get("model", 1)
    budget = 4e9
    L = arch.n_layers + arch.encoder_layers
    max_accum = max(shape.global_batch // dp, 1)
    accum = 1

    def carry(acc, sp):
        tokens_dev = shape.global_batch * shape.seq_len / dp / acc
        return L * tokens_dev * arch.d_model * 6 / (mp if sp else 1)
    while carry(accum, False) > budget and accum < max_accum:
        accum *= 2
    if carry(accum, False) <= budget:
        return accum, DEFAULT_RULES
    return accum, ACT_SP_RULES


def _lower_train(api, shape, mesh, rules: ShardingRules, compress_grads,
                 accum=1, cast_bf16=False, *, generator=None, **step_kw):
    """(state, step): ``init_state`` (weights from ``generator``, or the
    model's own when it is None) placed on ``mesh`` under ``rules``, and
    ``make_train_step`` on it.  ``shape`` is the global batch the step
    takes; ``step_kw`` go to ``make_train_step`` (peak_lr, warmup,
    total_steps)."""
    if shape.global_batch % accum:
        raise ValueError(f"global batch {shape.global_batch} is no "
                         f"multiple of accum {accum}")
    state = shard_state(api, init_state(api, generator,
                                        grad_compression=compress_grads),
                        mesh, rules, grad_compression=compress_grads)
    step = make_train_step(api, mesh=mesh, rules=rules,
                           grad_compression=compress_grads, accum=accum,
                           cast_bf16=cast_bf16, **step_kw)
    return state, step


class Lowered(NamedTuple):
    """What a serve cell runs: the model (its weights DTensors on the
    mesh), the inputs' ``NamedSharding``s (from ``input_axes``), the
    decode caches placed on the mesh (None for prefill) and the function:
    ``fn(batch)`` for prefill, ``fn(batch, caches)`` for decode.  ``fn``
    places a batch of plain tensors (the same on every rank) by the
    inputs' shardings and runs under the mesh and the rules."""
    params: Any
    inputs: Dict[str, Any]
    caches: Any
    fn: Callable


def _param_specs(api, floating: Optional[torch.dtype] = None) -> Dict:
    """``Spec``s of the model's parameters in the JAX layout (stacked over
    the groups), the floating ones in ``floating`` when it is given."""
    def spec(leaf):
        p = leaf.params[0]
        dt = floating if floating is not None and p.is_floating_point() \
            else p.dtype
        return Spec((len(leaf.params),) * leaf.stacked + tuple(p.shape), dt)
    return nest({leaf.path: spec(leaf) for leaf in jax_leaves(api.model)})


def _serve_param_specs(api) -> Dict:
    """Serving runs bf16 weights: the parameters' ``Spec``s with every
    floating leaf in bfloat16, as the JAX function gives them (the model
    code casts at use anyway)."""
    return _param_specs(api, torch.bfloat16)


def _place_for_serving(api, shape, mesh, rules: ShardingRules,
                       param_specs=None) -> Dict[str, Any]:
    """Cast the model's weights to ``param_specs`` (``_serve_param_specs``
    by default) and place them by ``param_axes`` under ``rules``; returns
    the inputs' shardings at ``shape``."""
    specs = param_specs if param_specs is not None \
        else _serve_param_specs(api)
    place_params(api.model, shardings_for_tree(
        api.model.param_axes(), mesh, rules, specs), specs)
    return shardings_for_tree(api.input_axes(shape), mesh, rules,
                              api.input_specs(shape))


def _placed(batch: Dict[str, torch.Tensor], shardings) -> Dict:
    return {k: v if isinstance(v, DTensor) else distribute(v, shardings[k])
            for k, v in batch.items()}


def _lower_prefill(api, shape, mesh, rules: ShardingRules,
                   param_specs=None) -> Lowered:
    """Prefill under ``mesh`` and ``rules``: the weights in
    ``param_specs``' dtypes (bf16 by default) placed by ``param_axes``,
    and ``fn(batch)`` -> (last logits placed ("batch", "act_seq",
    "vocab"), the caches of ``shape.seq_len`` positions, placed by
    ``cache_axes``)."""
    b_sh = _place_for_serving(api, shape, mesh, rules, param_specs)

    def fn(batch):
        with use_mesh(mesh, rules):
            return api.prefill(_placed(batch, b_sh), shape)
    return Lowered(api.model, b_sh, None, fn)


def _lower_decode(api, shape, mesh, rules: ShardingRules,
                  param_specs=None) -> Lowered:
    """One decode step under ``mesh`` and ``rules``: the weights as for
    ``_lower_prefill``, zero caches of ``cache_specs(shape)`` placed by
    ``cache_axes(stacked=False)`` (made in their shards), and ``fn(batch,
    caches)`` -> (logits, caches), the caches updated in place (JAX
    donates them).  ``fn`` takes these caches or prefill's, which are
    placed the same way."""
    b_sh = _place_for_serving(api, shape, mesh, rules, param_specs)
    with use_mesh(mesh, rules):
        caches = zero_caches(api.cache_specs(shape),
                             api.cache_axes(stacked=False), api.device)

    def fn(batch, caches):
        with use_mesh(mesh, rules):
            return api.serve_step(_placed(batch, b_sh), caches)
    return Lowered(api.model, b_sh, caches, fn)
