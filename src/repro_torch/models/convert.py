"""Load the JAX package's ``DecoderLM.init`` pytree into the port's model.

The pytree comes as nested dicts of numpy arrays (``jax.tree.map(
np.asarray, params)``), so this module needs no JAX.  ``params["blocks"]``
holds one stacked subtree per block kind, ``b0`` .. ``b{k-1}``, with a
leading group axis; group g's kind i becomes the port's sub-block
``blocks.{g * k + i}``.  Names map leaf for leaf (a norm leaf such as
``ln1`` becomes the norm's ``weight``; RWKV leaves nest as ``time.*`` and
``channel.*``).  Values are copied as they are (float32 stays float32),
and a missing, extra or misshapen leaf raises.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..configs.base import ArchConfig
from .lm import DecoderLM, block_kinds, n_groups

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
                        cfg: ArchConfig) -> Dict[str, torch.Tensor]:
    """The port's state dict for a JAX ``DecoderLM`` pytree of ``cfg``."""
    k, groups = len(block_kinds(cfg)), n_groups(cfg)
    blocks = params["blocks"]
    if set(blocks) != {f"b{i}" for i in range(k)}:
        raise ValueError(f"{cfg.name}: block kinds b0..b{k - 1} expected, "
                         f"got {sorted(blocks)}")
    top = {key: v for key, v in params.items() if key != "blocks"}
    sd = {key: torch.from_numpy(np.array(v))
          for key, v in _flatten(top).items()}
    for i in range(k):
        for key, stacked in _flatten(blocks[f"b{i}"]).items():
            stacked = np.asarray(stacked)
            if stacked.shape[0] != groups:
                raise ValueError(f"blocks.b{i}.{key}: leading group axis "
                                 f"{stacked.shape[0]} != {groups} groups")
            for g in range(groups):
                sd[f"blocks.{g * k + i}.{key}"] = torch.from_numpy(
                    np.array(stacked[g]))
    return sd


def load_jax_params(model: DecoderLM,
                    params: Mapping[str, Any]) -> DecoderLM:
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
