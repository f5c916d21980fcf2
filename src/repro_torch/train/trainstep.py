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

Under a mesh (``make_train_step(mesh=...)``, after ``shard_state``) the
state's tensors are DTensors placed by ``state_axes``: each parameter by
its JAX leaf's spec without the leading layer entry, the optimizer state
and the residual on their stacked shapes; the step and the count stay
0-d plain tensors, the same on every rank.  The step places the batch by
``ModelAPI.input_axes`` (ids too), runs the forward under ``use_mesh``
so the model's ``constrain`` sites redistribute its activations,
reduces each grad to its parameter's placements in float32 (the
data-parallel all-reduce, or FSDP's reduce-scatter), and updates leaf by
leaf on the shards.  With ``grad_compression`` and a "pod" axis each pod
runs that step on its ("data", "model") sub-mesh with its share of the
batch, and the grads cross pods once, through
``compress_grads_allreduce`` over the pod group: the port's counterpart
of the JAX step's ``shard_map`` manual over "pod".
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional

import torch
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.func import functional_call

from ..configs.base import ShapeConfig
from ..models.api import Spec
from ..models.convert import (Leaf, flatten_paths, jax_leaves, nest,
                              place_train_state)
from ..runtime.compression import compress_grads_allreduce, init_residual
from ..sharding.partition import (NamedSharding, current_rules,
                                  logical_to_spec, shardings_for_tree,
                                  spec_to_placements, unshard, use_mesh)
from .optimizer import make_optimizer
from .schedule import warmup_cosine


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


def _pod_split(mesh):
    """(the ("data", "model") sub-mesh, the pod group, this rank's pod,
    the pod count) of a mesh with a "pod" axis."""
    names = mesh.mesh_dim_names
    i = names.index("pod")
    return (mesh[tuple(n for n in names if n != "pod")],
            mesh.get_group("pod"), mesh.get_local_rank("pod"),
            mesh.mesh.shape[i])


def _batch_axes(api, batch: Dict[str, torch.Tensor]) -> Dict[str, tuple]:
    """Logical axes of a train batch's tensors (``ModelAPI.input_axes``;
    a loss mask as the labels)."""
    B, S = batch["tokens"].shape
    axes = api.input_axes(ShapeConfig("batch", "train", S, B))
    axes.setdefault("loss_mask", axes["labels"])
    return axes


def make_train_step(api, *, peak_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10000,
                    grad_compression: bool = False,
                    accum: int = 1,
                    cast_bf16: bool = False,
                    mesh=None, rules=None) -> Callable:
    """Returns train_step(state, batch[, capture]) -> (state, metrics).

    ``batch`` holds tensors on the model's device: {tokens, labels[,
    loss_mask][, patches | frames]}.  ``accum`` > 1 splits each of them
    into that many microbatches and averages their float32 grads and
    metrics; a batch whose rows do not divide by ``accum`` (or, under
    compression, by the pod count) raises ``ValueError``.
    ``cast_bf16``: the forward and backward run on bf16 copies of the
    float32 masters (``_compute_params``), and the update applies to the
    masters.
    metrics: loss, total_loss, grad_norm (the L2 norm of all float32
    grads) and lr, as 0-d tensors on the device.

    ``mesh``: a ``DeviceMesh`` the state was placed on by ``shard_state``
    (the same ``rules``, by default the active ones).  The batch is then
    either plain tensors, the whole global batch on every rank, or
    DTensors; either way each microbatch is placed by ``input_axes``.
    ``grad_compression`` with a "pod" axis: see the module's docstring.
    ``capture`` (a dict) receives each leaf's float32 grads (stacked as
    the JAX leaf), and on a compressed step also its residual, both
    before the compression, and its int8 codes and scale ({"grads",
    "residual", "codes"}, keyed by leaf path).
    """
    opt = make_optimizer(api.cfg.optimizer)
    model = api.model
    rules = rules or current_rules()
    do_compress = bool(grad_compression and mesh is not None
                       and "pod" in mesh.mesh_dim_names)
    run_mesh, pod_group, pod, n_pods = mesh, None, 0, 1
    if do_compress:
        run_mesh, pod_group, pod, n_pods = _pod_split(mesh)

    def place(batch) -> List[Dict[str, torch.Tensor]]:
        """The microbatches, each placed on the mesh (this pod's share of
        the batch under compression)."""
        full = {k: unshard(v) for k, v in batch.items()}
        B = full["tokens"].shape[0]
        if do_compress:
            if B % n_pods:
                raise ValueError(f"global batch {B} is no multiple of the "
                                 f"pod count {n_pods}")
            share = B // n_pods
            full = {k: v[pod * share:(pod + 1) * share]
                    for k, v in full.items()}
            B = share
        if B % accum:
            raise ValueError(f"batch {B} is no multiple of accum {accum}")
        n = B // accum
        micro = [{k: v[i * n:(i + 1) * n] for k, v in full.items()}
                 for i in range(accum)]
        if run_mesh is None:
            return micro
        axes = _batch_axes(api, micro[0])
        return [{k: distribute_tensor(
            v, run_mesh, spec_to_placements(logical_to_spec(
                axes[k], run_mesh, rules, tuple(v.shape)), run_mesh),
            src_data_rank=None) for k, v in mb.items()} for mb in micro]

    def grads_of(leaves, params, names, batch):
        comp = _compute_params(leaves, cast_bf16)
        inputs = [comp[p] for p in params]
        if cast_bf16:
            loss, metrics = functional_call(
                model, {names[p]: comp[p] for p in params}, (batch,))
        else:
            loss, metrics = model.loss_fn(batch)
        grads = list(torch.autograd.grad(loss, inputs))
        for i, g in enumerate(grads):      # one bf16 grad freed at a time
            g = g.float()
            if run_mesh is not None:
                # the sum over the batch's shards, placed like the param
                g = g.redistribute(run_mesh, params[i].placements)
            grads[i] = g
        return grads, {k: unshard(v.detach().float())
                       for k, v in metrics.items()}

    def accum_grads(leaves, params, names, micro):
        g_acc, m_acc = None, None
        for mb in micro:
            g, m = grads_of(leaves, params, names, mb)
            if g_acc is None:
                g_acc, m_acc = g, m
            else:
                g_acc = [a + b for a, b in zip(g_acc, g)]
                m_acc = {k: m_acc[k] + m[k] for k in m_acc}
        if len(micro) == 1:
            return g_acc, m_acc
        inv = 1.0 / len(micro)
        return [g * inv for g in g_acc], {k: v * inv
                                          for k, v in m_acc.items()}

    def step_fn(state: Dict[str, Any], batch: Dict[str, torch.Tensor],
                capture: Optional[Dict] = None):
        leaves = jax_leaves(model)
        params = [p for leaf in leaves for p in leaf.params]
        names = {p: n for n, p in model.named_parameters()}
        if run_mesh is not None:
            bad = [names[p] for p in params if not isinstance(p, DTensor)
                   or p.device_mesh != run_mesh]
            if bad:
                raise TypeError(f"{bad[0]} (and {len(bad) - 1} more) not "
                                "placed on the step's mesh: shard_state")
        lr = warmup_cosine(state["step"], peak_lr=peak_lr, warmup=warmup,
                           total=total_steps)
        with use_mesh(run_mesh, rules) if run_mesh is not None \
                else contextlib.nullcontext():
            grads, metrics = accum_grads(leaves, params, names,
                                         place(batch))
        if do_compress and n_pods > 1:
            # every pod's loss: the mean over the global batch
            for v in metrics.values():
                torch.distributed.all_reduce(v, group=pod_group)
                v.div_(n_pods)
        by_param = dict(zip(params, grads))
        del grads
        opt_state = state["opt"]
        residual = state.get("residual")
        if capture is not None:
            for key in ("grads", "residual", "codes"):
                capture.setdefault(key, {})
        count = opt_state["count"] + 1
        sq = []
        replicate = contextlib.nullcontext()
        if run_mesh is not None:
            _check_placed(opt_state, residual)
            # the lr and the count, 0-d plain tensors, meet the DTensors
            # here and only here
            replicate = implicit_replication()
        with torch.no_grad(), replicate:
            for leaf in leaves:
                g = leaf.stack([by_param.pop(p) for p in leaf.params])
                if capture is not None:
                    capture["grads"][leaf.path] = g.clone()
                if do_compress and residual is not None:
                    if capture is not None:
                        capture["residual"][leaf.path] = \
                            residual[leaf.path].clone()
                    synced, new_r = compress_grads_allreduce(
                        {leaf.path: g}, {leaf.path: residual[leaf.path]},
                        pod_group, codes=None if capture is None
                        else capture["codes"])
                    g = synced[leaf.path]
                    residual[leaf.path] = new_r[leaf.path]
                # per-leaf square and sum, not a dot of the raveled leaf:
                # flattening a 2-D-sharded DTensor would gather the whole
                # leaf; the CPU's float32 vector_norm also loses
                # precision over tens of millions of elements
                sq.append(unshard(torch.square(g).sum()))
                old = _placements(opt_state, leaf.path)
                p_stacked = leaf.stack([p.detach() for p in leaf.params])
                new = opt.update_leaf(leaf.path, g, opt_state, p_stacked,
                                      lr, count)
                _restore_placements(opt_state, leaf.path, old)
                if isinstance(new, DTensor) and \
                        new.placements != p_stacked.placements:
                    # Adafactor's factored step can come back sharded on
                    # the layer axis
                    new = new.redistribute(new.device_mesh,
                                           p_stacked.placements)
                del g, p_stacked
                for p, t in zip(leaf.params, leaf.unstack(new)):
                    p.copy_(t)
                del new
            opt_state["count"] = count
            gn = torch.sqrt(sum(sq))
        metrics = dict(metrics, grad_norm=gn, lr=lr)
        new_state = {"params": model, "opt": opt_state,
                     "step": state["step"] + 1}
        if residual is not None:
            new_state["residual"] = residual
        return new_state, metrics

    return step_fn


def _check_placed(opt_state: Dict, residual: Optional[Dict]) -> None:
    """Every optimizer and residual tensor with a dimension is a DTensor:
    under ``implicit_replication`` a plain one would pass unseen."""
    for key, tree in (("opt", opt_state), ("residual", residual or {})):
        for path, t in flatten_paths(tree).items():
            if t.dim() and not isinstance(t, DTensor):
                raise TypeError(f"{key}/{path}: a plain {tuple(t.shape)} "
                                "tensor in a sharded state: shard_state")


def _placements(opt_state: Dict, path: str) -> Dict:
    """{(slot, part): placements} of leaf ``path``'s DTensor moments."""
    out = {}
    for slot, per_leaf in opt_state.items():
        if not isinstance(per_leaf, dict) or path not in per_leaf:
            continue
        t = per_leaf[path]
        for part, x in (t.items() if isinstance(t, dict) else [(None, t)]):
            if isinstance(x, DTensor):
                out[(slot, part)] = (x.device_mesh, x.placements)
    return out


def _restore_placements(opt_state: Dict, path: str, old: Dict) -> None:
    """Put leaf ``path``'s new moments back on the placements its old
    ones had (Adafactor's means over a sharded dim come back partial or
    resharded)."""
    for (slot, part), (mesh, placements) in old.items():
        holder = opt_state[slot] if part is None else opt_state[slot][path]
        key = path if part is None else part
        x = holder[key]
        if x.placements != placements:
            holder[key] = x.redistribute(mesh, placements)


def init_state(api, generator: Optional[torch.Generator] = None, *,
               grad_compression: bool = False) -> Dict[str, Any]:
    """A fresh train state: the model's weights drawn from ``generator``
    (kept as they are when it is None, e.g. after ``load_jax_params``),
    the optimizer state of ``cfg.optimizer`` and step 0; with
    ``grad_compression``, a float32 zero residual per leaf."""
    model = api.model
    if generator is not None:
        model.init(generator)
    opt = make_optimizer(api.cfg.optimizer)
    p_leaves = {leaf.path: leaf.stack([p.detach() for p in leaf.params])
                for leaf in jax_leaves(model)}
    state = {"params": model, "opt": opt.init(p_leaves),
             "step": torch.zeros((), dtype=torch.int32, device=model.device)}
    if grad_compression:
        state["residual"] = init_residual(p_leaves)
    return state


def state_axes(api, *, grad_compression: bool = False) -> Dict[str, Any]:
    """Logical axes of the train state, in the JAX layout."""
    param_axes = api.model.param_axes()
    opt = make_optimizer(api.cfg.optimizer)
    axes = {"params": param_axes, "opt": opt.state_axes(param_axes),
            "step": (None,)}
    if grad_compression:
        axes["residual"] = param_axes
    return axes


def _state_shapes(state: Dict[str, Any]) -> Dict[str, Any]:
    """The train state's shapes in the JAX layout (params stacked by
    group), as ``Spec``s."""
    def spec(t):
        return Spec(tuple(t.shape), t.dtype)
    shapes = {"params": nest({
        leaf.path: Spec((len(leaf.params),) * leaf.stacked
                        + tuple(leaf.params[0].shape), leaf.params[0].dtype)
        for leaf in jax_leaves(state["params"])}),
        "step": spec(state["step"])}
    for key in ("opt", "residual"):
        if key in state:
            shapes[key] = nest({path: spec(t) for path, t in
                                flatten_paths(state[key]).items()})
    return shapes


def _on_mesh(tree, mesh):
    """Every ``NamedSharding`` of ``tree`` moved onto ``mesh``."""
    if isinstance(tree, dict):
        return {k: _on_mesh(v, mesh) for k, v in tree.items()}
    names = [a for e in tree.spec if e is not None
             for a in ((e,) if isinstance(e, str) else e)]
    assert "pod" not in names, tree.spec      # params never cross pods
    return NamedSharding(mesh, tree.spec)


def state_shardings(api, state: Dict[str, Any], mesh, rules=None, *,
                    grad_compression: bool = False) -> Dict[str, Any]:
    """``NamedSharding``s of the train state by ``state_axes`` under
    ``rules`` (default: the active ones), keyed as the JAX train state and
    computed on its stacked shapes.  With ``grad_compression`` and a
    "pod" axis they lie on the ("data", "model") sub-mesh: each pod holds
    the whole state."""
    sh = shardings_for_tree(
        state_axes(api, grad_compression=grad_compression), mesh,
        rules or current_rules(), _state_shapes(state))
    if grad_compression and "pod" in mesh.mesh_dim_names:
        sh = _on_mesh(sh, _pod_split(mesh)[0])
    return sh


def shard_state(api, state: Dict[str, Any], mesh, rules=None, *,
                grad_compression: bool = False) -> Dict[str, Any]:
    """Place a train state (the same full tensors on every rank) on
    ``mesh`` by ``state_shardings`` (``convert.place_train_state``).
    Returns the state, with the same model."""
    return place_train_state(state, state_shardings(
        api, state, mesh, rules, grad_compression=grad_compression))
