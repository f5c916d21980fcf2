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

``update`` returns a new state and leaves the one it was given as it was.
``update_leaf`` updates one leaf's state inside the state it is given
(AdamW writes its moments in place, and the new param into the grad it
is given; Adafactor replaces the leaf's entries).  The train step calls
it leaf by leaf on the state it owns (the port's counterpart of the JAX
step's donation of its optimizer state), so a 3 B-parameter model keeps
one leaf's temporaries beside its state at a time.
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
        new = {"mu": {k: t.clone() for k, t in state["mu"].items()},
               "nu": {k: t.clone() for k, t in state["nu"].items()},
               "count": c}
        return {k: self.update_leaf(k, grads[k].float().clone(), new, p, lr,
                                    c)
                for k, p in params.items()}, new

    def update_leaf(self, k: str, g: torch.Tensor, state: Dict,
                    p: torch.Tensor, lr: torch.Tensor,
                    c: torch.Tensor) -> torch.Tensor:
        """Leaf ``k``'s new param; state["mu"][k] and state["nu"][k] are
        updated in place.  ``c`` is the new count.  ``g`` (the leaf's
        float32 grad) is overwritten with the update and returned as the
        new param, so a float32 update allocates nothing: 3 B parameters
        touch no fresh memory."""
        b1, b2 = self.b1, self.b2
        cf = c.float()
        m = state["mu"][k].mul_(b1).add_(g, alpha=1 - b1)
        state["nu"][k].mul_(b2).addcmul_(g, g, value=1 - b2)
        # step = (m / (1 - b1^c)) / (sqrt(v / (1 - b2^c)) + eps), in g
        den = torch.div(state["nu"][k], 1 - b2 ** cf, out=g)
        den.sqrt_().add_(self.eps)
        step = torch.div(m, den, out=g).div_(1 - b1 ** cf)
        if p.dim() >= 2:
            step.add_(p.float(), alpha=self.weight_decay)
        step.mul_(lr)
        return torch.sub(p.float(), step, out=step).to(p.dtype)


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
        new = {"v": dict(state["v"]), "count": c}
        return {k: self.update_leaf(k, grads[k], new, p, lr, c)
                for k, p in params.items()}, new

    def update_leaf(self, k: str, g: torch.Tensor, state: Dict,
                    p: torch.Tensor, lr: torch.Tensor,
                    c: torch.Tensor) -> torch.Tensor:
        """Leaf ``k``'s new param; its new second moments replace
        state["v"][k].  ``c`` is the new count."""
        beta = 1.0 - c.float() ** -self.decay
        g = g.float()
        v = state["v"][k]
        g2 = g.square() + self.eps
        if self._factored(p):
            vr = beta * v["vr"] + (1 - beta) * g2.mean(-1)
            vc = beta * v["vc"] + (1 - beta) * g2.mean(-2)
            del g2
            denom = (vr / torch.clamp(vr.mean(-1, keepdim=True),
                                      min=self.eps))[..., None] \
                * vc[..., None, :]
            step = g * torch.rsqrt(torch.clamp(denom, min=self.eps))
            state["v"][k] = {"vr": vr, "vc": vc}
        else:
            nv = beta * v["v"] + (1 - beta) * g2
            step = g * torch.rsqrt(torch.clamp(nv, min=self.eps))
            state["v"][k] = {"v": nv}
        del v
        # update clipping (RMS)
        rms = torch.sqrt(step.square().mean() + 1e-12)
        step = step / torch.clamp(rms / self.clip_threshold, min=1.0)
        return (p.float() - lr * step).to(p.dtype)


def make_optimizer(name: str):
    return {"adamw": AdamW(), "adafactor": Adafactor()}[name]
