"""Planning and building a sharded train step: the first part of the JAX
package's ``launch/dryrun.py``.

``count_params``, ``active_params`` and ``auto_plan`` are the JAX
functions.  ``_lower_train`` builds what the JAX one lowers: the train
state placed on the mesh by its logical axes and the step, ready to run
(torch has no separate lowering).  Build the model on the ``meta``
device to count a full-size one without allocating it.  Serving cells
(``lower_cell``, ``_lower_prefill``, ``_lower_decode``), ``main`` and the
roofline tools wait for a later slice (ROADMAP.md queue 1, item 8e).
"""

from __future__ import annotations

from ..sharding.partition import (ACT_SP_RULES, DEFAULT_RULES,
                                  SERVE_BIG_RULES, SERVE_RULES,
                                  ShardingRules, mesh_shape)
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
