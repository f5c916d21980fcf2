"""Training step: grads, optimizer update and grad norm, with microbatch
accumulation and bf16 compute copies of float32 master weights (the JAX
package's ``train/trainstep.py``).

The port's train state is ``{"params": the model, "opt": the optimizer
state in the JAX layout, "step": an int32 tensor}``.  A step owns the
state it is given, as the JAX step owns its donated buffers: the model's
parameters are updated in place under ``torch.no_grad()``, and the
optimizer's moments of each leaf are replaced in the given state's dicts,
which the step returns.  The optimizer works on JAX leaves
(``models.convert.jax_leaves``), one leaf at a time: its grads and params
are stacked over the layer groups for the update and written back per
layer, and a leaf's grads are freed (or, with AdamW, become its new
params) before the next one, so the peak holds the state, the float32
grads and one leaf's temporaries.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch
from torch.func import functional_call

from ..models.convert import Leaf, jax_leaves
from .optimizer import make_optimizer
from .schedule import warmup_cosine

_SHARDING = "ROADMAP.md queue 1, item 8 (sharding and more than one card)"


def _compute_params(leaves: List[Leaf], cast_bf16: bool) -> Dict:
    """name -> the tensor the forward uses in place of each parameter.
    ``cast_bf16`` casts the float32 leaves of two or more dims in the
    JAX layout to bf16, as the JAX step does once per step: every block
    parameter (its stacked leaf has a group or layer axis, so a block's
    norm weight too, an enc-dec's encoder and decoder blocks alike), the
    embedding, the head, ``vision_proj`` and ``dec_pos``, and not the
    final or encoder norm."""
    out = {}
    for leaf in leaves:
        cast = cast_bf16 and (leaf.stacked or leaf.params[0].dim() >= 2)
        for p in leaf.params:
            if cast and p.dtype == torch.float32:
                out[p] = p.detach().to(torch.bfloat16).requires_grad_()
            else:
                out[p] = p
    return out


def make_train_step(api, *, peak_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10000,
                    grad_compression: bool = False,
                    accum: int = 1,
                    cast_bf16: bool = False,
                    mesh=None) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    ``batch`` holds tensors on the model's device: {tokens, labels[,
    loss_mask][, patches | frames]}.  ``accum`` > 1 splits each of them
    into that many microbatches and averages their float32 grads and
    metrics.  ``cast_bf16``: the forward
    and backward run on bf16 copies of the float32 masters
    (``_compute_params``), and the update applies to the masters.
    metrics: loss, total_loss, grad_norm (the L2 norm of all float32
    grads) and lr, as 0-d tensors on the device.
    """
    if grad_compression or mesh is not None:
        raise NotImplementedError(
            f"grad_compression and mesh: {_SHARDING} brings them")
    opt = make_optimizer(api.cfg.optimizer)
    model = api.model
    leaves = jax_leaves(model)
    params = [p for leaf in leaves for p in leaf.params]
    names = {p: n for n, p in model.named_parameters()}

    def grads_of(batch):
        comp = _compute_params(leaves, cast_bf16)
        inputs = [comp[p] for p in params]
        if cast_bf16:
            loss, metrics = functional_call(
                model, {names[p]: comp[p] for p in params}, (batch,))
        else:
            loss, metrics = model.loss_fn(batch)
        grads = list(torch.autograd.grad(loss, inputs))
        for i, g in enumerate(grads):      # one bf16 grad freed at a time
            grads[i] = g.float()
        return grads, {k: v.detach().float() for k, v in metrics.items()}

    def accum_grads(batch):
        if accum <= 1:
            return grads_of(batch)
        micro = {k: v.reshape((accum, v.shape[0] // accum) + v.shape[1:])
                 for k, v in batch.items()}
        g_acc, m_acc = None, None
        for i in range(accum):
            g, m = grads_of({k: v[i] for k, v in micro.items()})
            if g_acc is None:
                g_acc, m_acc = g, m
            else:
                g_acc = [a + b for a, b in zip(g_acc, g)]
                m_acc = {k: m_acc[k] + m[k] for k in m_acc}
        inv = 1.0 / accum
        return [g * inv for g in g_acc], {k: v * inv
                                          for k, v in m_acc.items()}

    def step_fn(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        lr = warmup_cosine(state["step"], peak_lr=peak_lr, warmup=warmup,
                           total=total_steps)
        grads, metrics = accum_grads(batch)
        by_param = dict(zip(params, grads))
        del grads
        opt_state = state["opt"]
        count = opt_state["count"] + 1
        sq = []
        with torch.no_grad():
            for leaf in leaves:
                g = leaf.stack([by_param.pop(p) for p in leaf.params])
                flat = g.reshape(-1)
                sq.append(torch.dot(flat, flat))
                new = opt.update_leaf(
                    leaf.path, g, opt_state,
                    leaf.stack([p.detach() for p in leaf.params]), lr, count)
                del g, flat
                for p, t in zip(leaf.params, leaf.unstack(new)):
                    p.copy_(t)
                del new
            opt_state["count"] = count
            gn = torch.sqrt(sum(sq))
        metrics = dict(metrics, grad_norm=gn, lr=lr)
        return {"params": model, "opt": opt_state,
                "step": state["step"] + 1}, metrics

    return step_fn


def init_state(api, generator: Optional[torch.Generator] = None
               ) -> Dict[str, Any]:
    """A fresh train state: the model's weights drawn from ``generator``
    (kept as they are when it is None, e.g. after ``load_jax_params``),
    the optimizer state of ``cfg.optimizer`` and step 0."""
    model = api.model
    if generator is not None:
        model.init(generator)
    opt = make_optimizer(api.cfg.optimizer)
    p_leaves = {leaf.path: leaf.stack([p.detach() for p in leaf.params])
                for leaf in jax_leaves(model)}
    return {"params": model, "opt": opt.init(p_leaves),
            "step": torch.zeros((), dtype=torch.int32, device=model.device)}
