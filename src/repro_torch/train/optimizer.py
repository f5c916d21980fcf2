"""Optimizers as plain functions on tensors: AdamW and Adafactor
(sub-linear memory), in float32, as the JAX package's
``train/optimizer.py``.

They work on the JAX package's leaves, not on the port's parameters.
The JAX model stacks every block parameter over the layer groups, and
its optimizers decide and reduce per stacked leaf: AdamW decays a leaf of
two or more dims, which includes a block's (groups, d) norm weight, and
Adafactor factors that same norm across the layers and clips an update by
one RMS over all the groups of a leaf.  So ``update`` takes a dict from
each JAX leaf path (``"blocks/b0/ln1"``, see ``models.convert.
jax_leaves``) to that leaf's stacked tensor, of the grads and of the
params, and the state holds one tensor per leaf in the same layout.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

Leaves = Dict[str, torch.Tensor]


def _count(params: Leaves) -> torch.Tensor:
    dev = next(iter(params.values())).device
    return torch.zeros((), dtype=torch.int32, device=dev)


@dataclass(frozen=True)
class AdamW:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1

    def init(self, params: Leaves) -> Dict:
        z = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
        return {"mu": {k: z(p) for k, p in params.items()},
                "nu": {k: z(p) for k, p in params.items()},
                "count": _count(params)}

    def update(self, grads: Leaves, state: Dict, params: Leaves,
               lr: torch.Tensor) -> Tuple[Leaves, Dict]:
        c = state["count"] + 1
        b1, b2 = self.b1, self.b2
        cf = c.float()
        new_p, mu, nu = {}, {}, {}
        for k, p in params.items():
            g = grads[k].float()
            m = b1 * state["mu"][k] + (1 - b1) * g
            v = b2 * state["nu"][k] + (1 - b2) * g.square()
            mh = m / (1 - b1 ** cf)
            vh = v / (1 - b2 ** cf)
            step = mh / (torch.sqrt(vh) + self.eps)
            if p.dim() >= 2:
                step = step + self.weight_decay * p.float()
            new_p[k] = (p.float() - lr * step).to(p.dtype)
            mu[k], nu[k] = m, v
        return new_p, {"mu": mu, "nu": nu, "count": c}


@dataclass(frozen=True)
class Adafactor:
    """Factored second moments over the trailing two dims (leading stacked
    layer axes kept)."""
    decay: float = 0.8
    eps: float = 1e-30
    clip_threshold: float = 1.0

    def _factored(self, p: torch.Tensor) -> bool:
        return p.dim() >= 2 and p.shape[-1] >= 2 and p.shape[-2] >= 2

    def init(self, params: Leaves) -> Dict:
        def st(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if self._factored(p):
                return {"vr": torch.zeros(p.shape[:-1], **f32),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          **f32)}
            return {"v": torch.zeros(p.shape, **f32)}
        return {"v": {k: st(p) for k, p in params.items()},
                "count": _count(params)}

    def update(self, grads: Leaves, state: Dict, params: Leaves,
               lr: torch.Tensor) -> Tuple[Leaves, Dict]:
        c = state["count"] + 1
        beta = 1.0 - c.float() ** -self.decay
        new_p, new_v = {}, {}
        for k, p in params.items():
            g = grads[k].float()
            v = state["v"][k]
            g2 = g.square() + self.eps
            if self._factored(p):
                vr = beta * v["vr"] + (1 - beta) * g2.mean(-1)
                vc = beta * v["vc"] + (1 - beta) * g2.mean(-2)
                denom = (vr / torch.clamp(vr.mean(-1, keepdim=True),
                                          min=self.eps))[..., None] \
                    * vc[..., None, :]
                step = g * torch.rsqrt(torch.clamp(denom, min=self.eps))
                new_v[k] = {"vr": vr, "vc": vc}
            else:
                nv = beta * v["v"] + (1 - beta) * g2
                step = g * torch.rsqrt(torch.clamp(nv, min=self.eps))
                new_v[k] = {"v": nv}
            # update clipping (RMS)
            rms = torch.sqrt(step.square().mean() + 1e-12)
            step = step / torch.clamp(rms / self.clip_threshold, min=1.0)
            new_p[k] = (p.float() - lr * step).to(p.dtype)
        return new_p, {"v": new_v, "count": c}


def make_optimizer(name: str):
    return {"adamw": AdamW(), "adafactor": Adafactor()}[name]
