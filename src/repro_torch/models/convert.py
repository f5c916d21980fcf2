"""Carry weights and train states between the JAX package's layout and
the port's.

The JAX pytree comes as nested dicts of numpy arrays (``jax.tree.map(
np.asarray, params)``), so this module needs no JAX.  A ``DecoderLM``'s
``params["blocks"]`` holds one stacked subtree per block kind, ``b0`` ..
``b{k-1}``, with a leading group axis; group g's kind i becomes the
port's sub-block ``blocks.{g * k + i}``.  An ``EncDecLM``'s
``enc_blocks`` and ``dec_blocks`` are each one subtree stacked over its
layers; layer l becomes ``enc_blocks.{l}`` or ``dec_blocks.{l}``.  Names
map leaf for leaf (a norm leaf such as ``ln1`` becomes the norm's
``weight``; RWKV leaves nest as ``time.*`` and ``channel.*``, a MoE's as
``ffn.router``, ``ffn.wi`` (E, d, f) and so on, stacked to (groups, E, d,
f) in the JAX layout).  Values are copied as they are (float32 stays
float32), and a missing, extra or misshapen leaf raises.

A JAX leaf is the unit the optimizers decide and reduce over
(``train/optimizer.py``), so ``jax_leaves`` groups the port's parameters
by it, and a train state converts both ways: ``{"params", "opt",
"step"}`` with the optimizer state in the JAX layout (one tensor, or one
``vr``/``vc``/``v`` dict, per stacked leaf).  Checkpoints are written in
that layout, so either package restores the other's snapshots.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from ..configs.base import ArchConfig
from ..sharding.partition import distribute, unshard
from .lm import block_kinds, n_groups

_NORMS = ("ln1", "ln2", "lnx", "enc_norm", "final_norm")
# JAX subtrees stacked over the layers (or the layer groups)
_STACKED = ("blocks", "enc_blocks", "dec_blocks")


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for name, leaf in tree.items():
        key = prefix + name
        if isinstance(leaf, Mapping):
            out.update(_flatten(leaf, key + "."))
        else:
            out[key + ".weight" if name in _NORMS else key] = leaf
    return out


def _unstack(sd: Dict[str, torch.Tensor], tree: Mapping[str, Any],
             where: str, names: List[str]) -> None:
    """Each leaf of ``tree``, stacked over as many layers or groups as
    ``names`` holds, into ``sd``: slice g under ``names[g]`` + its port
    name."""
    for key, stacked in _flatten(tree).items():
        stacked = np.asarray(stacked)
        if stacked.shape[0] != len(names):
            raise ValueError(f"{where}.{key}: leading axis "
                             f"{stacked.shape[0]} != {len(names)} layers "
                             "or groups")
        for g, name in enumerate(names):
            sd[f"{name}.{key}"] = torch.from_numpy(np.array(stacked[g]))


def state_dict_from_jax(params: Mapping[str, Any],
                        cfg: ArchConfig) -> Dict[str, torch.Tensor]:
    """The port's state dict for a JAX ``DecoderLM`` or ``EncDecLM``
    pytree of ``cfg``."""
    top = {key: v for key, v in params.items() if key not in _STACKED}
    sd = {key: torch.from_numpy(np.array(v))
          for key, v in _flatten(top).items()}
    if cfg.is_encdec:
        for key, n in (("enc_blocks", cfg.encoder_layers),
                       ("dec_blocks", cfg.n_layers)):
            _unstack(sd, params[key], key, [f"{key}.{l}" for l in range(n)])
        return sd
    k, groups = len(block_kinds(cfg)), n_groups(cfg)
    blocks = params["blocks"]
    if set(blocks) != {f"b{i}" for i in range(k)}:
        raise ValueError(f"{cfg.name}: block kinds b0..b{k - 1} expected, "
                         f"got {sorted(blocks)}")
    for i in range(k):
        _unstack(sd, blocks[f"b{i}"], f"blocks.b{i}",
                 [f"blocks.{g * k + i}" for g in range(groups)])
    return sd


def load_jax_params(model: nn.Module,
                    params: Mapping[str, Any]) -> nn.Module:
    """Copy a JAX pytree of numpy arrays into ``model`` (on its device)."""
    sd = state_dict_from_jax(params, model.cfg)
    own = model.state_dict()
    for key, t in sd.items():
        if key in own and (own[key].shape != t.shape
                           or own[key].dtype != t.dtype):
            raise ValueError(f"{key}: {tuple(t.shape)} {t.dtype} does not "
                             f"fit {tuple(own[key].shape)} {own[key].dtype}")
    model.load_state_dict(sd, strict=True)
    return model


# --------------------------------------------------------------------------
# JAX leaves and train states
# --------------------------------------------------------------------------

@dataclass
class Leaf:
    """One leaf of the JAX pytree: its path (``"blocks/b0/mix/wq"``,
    ``"dec_blocks/cross/wk"``) and the port's parameters it stacks, one
    per layer group (or layer) for a leaf of a stacked subtree."""
    path: str
    params: List[nn.Parameter]
    stacked: bool

    def stack(self, ts: List[torch.Tensor]) -> torch.Tensor:
        """The leaf's tensor in the JAX layout from one tensor per param."""
        return torch.stack(ts) if self.stacked else ts[0]

    def unstack(self, t: torch.Tensor) -> List[torch.Tensor]:
        return list(t.unbind(0)) if self.stacked else [t]


def _jax_path(port_name: str, k: int) -> Tuple[str, int]:
    """(JAX leaf path, layer group) of a port parameter name; the group
    is -1 outside the stacked subtrees.  ``k``: the decoder LM's block
    kinds a group (``blocks.{j}`` is group j // k's kind j % k); an
    enc-dec's ``enc_blocks.{l}`` and ``dec_blocks.{l}`` are layer l."""
    parts = port_name.split(".")
    if parts[-1] == "weight" and parts[-2] in _NORMS:
        parts = parts[:-1]
    if parts[0] not in _STACKED:
        return "/".join(parts), -1
    j = int(parts[1])
    if parts[0] != "blocks":
        return "/".join([parts[0]] + parts[2:]), j
    return "/".join(["blocks", f"b{j % k}"] + parts[2:]), j // k


def jax_leaves(model: nn.Module) -> List[Leaf]:
    """The port's parameters (of a ``DecoderLM`` or an ``EncDecLM``)
    grouped by JAX leaf, in the order ``jax.tree.leaves`` gives the JAX
    pytree (dict keys sorted at every level)."""
    k = len(block_kinds(model.cfg))
    groups: Dict[str, Dict[int, nn.Parameter]] = {}
    for name, p in model.named_parameters():
        path, g = _jax_path(name, k)
        groups.setdefault(path, {})[g] = p
    out = []
    for path in sorted(groups, key=lambda p: p.split("/")):
        by_g = groups[path]
        out.append(Leaf(path, [by_g[g] for g in sorted(by_g)],
                        stacked=path.split("/")[0] in _STACKED))
    return out


def nest(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """{"a/b": x} -> {"a": {"b": x}}; values that are dicts nest too."""
    out: Dict[str, Any] = {}
    for path, v in flat.items():
        *head, last = path.split("/")
        d = out
        for key in head:
            d = d.setdefault(key, {})
        d[last] = nest(v) if isinstance(v, Mapping) else v
    return out


def flatten_paths(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """The inverse of ``nest`` down to the leaves: {"a": {"b": x}} ->
    {"a/b": x}."""
    out = {}
    for key, v in tree.items():
        path = f"{prefix}{key}"
        if isinstance(v, Mapping):
            out.update(flatten_paths(v, path + "/"))
        else:
            out[path] = v
    return out


def to_host(tree):
    """Every tensor of a nested dict as a numpy array on the host; a
    DTensor is gathered whole first (a collective: every rank of its mesh
    calls this)."""
    if isinstance(tree, Mapping):
        return {key: to_host(v) for key, v in tree.items()}
    return unshard(tree.detach()).to("cpu", copy=True).numpy()


def params_to_jax(model: nn.Module) -> Dict[str, Any]:
    """The JAX ``DecoderLM.init`` or ``EncDecLM.init`` pytree (numpy) of
    the port's weights."""
    return nest({leaf.path: to_host(leaf.stack([p.detach()
                                                for p in leaf.params]))
                 for leaf in jax_leaves(model)})


def train_state_to_jax(state: Mapping[str, Any]) -> Dict[str, Any]:
    """The port's train state ({"params": the model, "opt", "step"}) as
    the JAX package's train state pytree of numpy arrays: params stacked
    by group, the optimizer state nested by leaf path, int32 counters."""
    opt = {key: nest(v) if isinstance(v, Mapping) else v
           for key, v in to_host(state["opt"]).items()}
    out = {"params": params_to_jax(state["params"]), "opt": opt,
           "step": to_host(state["step"])}
    if "residual" in state:
        out["residual"] = nest(to_host(state["residual"]))
    return out


def train_state_from_jax(tree: Mapping[str, Any],
                         model: nn.Module) -> Dict[str, Any]:
    """A port train state from a JAX train state pytree of numpy arrays:
    the params copied into ``model`` (on its device), the optimizer state
    and the step as tensors on the model's device."""
    load_jax_params(model, tree["params"])
    dev = model.device
    paths = {leaf.path for leaf in jax_leaves(model)}

    def t(a):
        return torch.from_numpy(np.array(a)).to(dev)
    opt = {}
    for key, v in tree["opt"].items():
        if not isinstance(v, Mapping):
            opt[key] = t(v)
            continue
        per_leaf = {}
        for path, x in flatten_paths(v).items():
            leaf_path, _, part = path.rpartition("/")
            if path in paths:
                per_leaf[path] = t(x)
            elif leaf_path in paths and part in ("v", "vr", "vc"):
                per_leaf.setdefault(leaf_path, {})[part] = t(x)
            else:
                raise ValueError(f"opt/{key}/{path}: no such leaf")
        if set(per_leaf) != paths:
            raise ValueError(f"opt/{key}: leaves {sorted(paths ^ set(per_leaf))}"
                             " missing or extra")
        opt[key] = per_leaf
    out = {"params": model, "opt": opt, "step": t(tree["step"])}
    if "residual" in tree:
        res = {path: t(x) for path, x in flatten_paths(
            tree["residual"]).items()}
        if set(res) != paths:
            raise ValueError("residual: leaves "
                             f"{sorted(paths ^ set(res))} missing or extra")
        out["residual"] = res
    return out


# --------------------------------------------------------------------------
# placing a train state on a mesh
# --------------------------------------------------------------------------

def set_param(model: nn.Module, name: str, t: torch.Tensor) -> None:
    """Replace the parameter ``name`` of ``model`` by one holding ``t``."""
    mod_name, _, attr = name.rpartition(".")
    mod = model.get_submodule(mod_name) if mod_name else model
    setattr(mod, attr, nn.Parameter(t, requires_grad=True))


def place_train_state(state: Mapping[str, Any],
                      shardings: Mapping[str, Any]) -> Dict[str, Any]:
    """A port train state (the same full tensors on every rank) placed
    by ``shardings``: a tree of ``partition.NamedSharding``s keyed as the
    JAX train state (``trainstep.state_axes``), computed on its stacked
    shapes.  Each parameter of the model becomes a DTensor parameter
    placed by its JAX leaf's spec without the leading layer entry (always
    None: layers are never sharded); the optimizer state and the
    residual are placed leaf by leaf; 0-d leaves (step, count) stay
    plain.  Returns the state, with the same model."""
    model = state["params"]
    names = {p: n for n, p in model.named_parameters()}
    p_sh = flatten_paths(shardings["params"])
    for leaf in jax_leaves(model):
        sh = p_sh[leaf.path]
        if leaf.stacked:
            assert not sh.spec or sh.spec[0] is None, (leaf.path, sh.spec)
            sh = type(sh)(sh.mesh, sh.spec[1:])
        for p in leaf.params:
            set_param(model, names[p], distribute(p, sh))
    out = {"params": model, "step": state["step"]}
    for key in ("opt", "residual"):
        if key not in state:
            continue
        sh = flatten_paths(shardings[key])
        flat = {path: t if t.dim() == 0 else distribute(t, sh[path])
                for path, t in flatten_paths(state[key]).items()}
        out[key] = _unflatten_like(state[key], flat)
    return out


def _unflatten_like(tree: Mapping[str, Any], flat: Mapping[str, Any],
                    prefix: str = ""):
    """``tree``'s nesting (keys may hold "/") with ``flat``'s values, as
    ``flatten_paths`` keys them."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        out[k] = _unflatten_like(v, flat, path + "/") \
            if isinstance(v, Mapping) else flat[path]
    return out
