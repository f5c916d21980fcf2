"""Load the JAX package's ``DecoderLM.init`` pytree into the port's model.

The pytree comes as nested dicts of numpy arrays (``jax.tree.map(
np.asarray, params)``), so this module needs no JAX.  The stacked leading
layer axis of ``params["blocks"]["b0"]`` is split over the port's blocks;
names map leaf for leaf (a norm leaf such as ``ln1`` becomes the norm's
``weight``).  Values are copied as they are (float32 stays float32), and
a missing, extra or misshapen leaf raises.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .lm import DecoderLM

_NORMS = ("ln1", "ln2", "final_norm")


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for name, leaf in tree.items():
        key = prefix + name
        if isinstance(leaf, Mapping):
            out.update(_flatten(leaf, key + "."))
        else:
            out[key + ".weight" if name in _NORMS else key] = leaf
    return out


def state_dict_from_jax(params: Mapping[str, Any],
                        n_layers: int) -> Dict[str, torch.Tensor]:
    """The port's state dict for a JAX dense ``DecoderLM`` pytree."""
    blocks = params["blocks"]
    if set(blocks) != {"b0"}:
        raise ValueError(f"dense pytree expected one block kind 'b0', got "
                         f"{sorted(blocks)}")
    top = {k: v for k, v in params.items() if k != "blocks"}
    sd = {k: torch.from_numpy(np.array(v)) for k, v in _flatten(top).items()}
    for key, stacked in _flatten(blocks["b0"]).items():
        stacked = np.asarray(stacked)
        if stacked.shape[0] != n_layers:
            raise ValueError(f"blocks.b0.{key}: leading layer axis "
                             f"{stacked.shape[0]} != n_layers {n_layers}")
        for i in range(n_layers):
            sd[f"blocks.{i}.{key}"] = torch.from_numpy(np.array(stacked[i]))
    return sd


def load_jax_params(model: DecoderLM,
                    params: Mapping[str, Any]) -> DecoderLM:
    """Copy a JAX pytree of numpy arrays into ``model`` (on its device)."""
    sd = state_dict_from_jax(params, model.cfg.n_layers)
    own = model.state_dict()
    for key, t in sd.items():
        if key in own and (own[key].shape != t.shape
                           or own[key].dtype != t.dtype):
            raise ValueError(f"{key}: {tuple(t.shape)} {t.dtype} does not "
                             f"fit {tuple(own[key].shape)} {own[key].dtype}")
    model.load_state_dict(sd, strict=True)
    return model
