"""References for the port's sharded-step tests, computed in the test
process: the JAX package's step and the port's unsharded step, from the
same JAX-initialized state and numpy batches (smoke_variant(smollm-135m)
at float32)."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.models.api import ModelAPI as JModelAPI
from repro.train import trainstep as jtrainstep
from repro_torch import configs
from repro_torch.models.api import ModelAPI
from repro_torch.models.convert import (flatten_paths, train_state_from_jax,
                                        train_state_to_jax)
from repro_torch.train import trainstep

B, S, STEPS, ACCUM = 8, 32, 2, 2
KW = dict(peak_lr=1e-3, warmup=1, total_steps=10)
#: one compressed step that already updates the params (lr = peak_lr)
KW_COMPRESS = dict(peak_lr=1e-3, warmup=0, total_steps=10)
#: sharded against the port's unsharded step, relative L2 per leaf in
#: float32: the two differ in the order of their float32 sums (a
#: matmul's contraction split over shards, the batch mean over ranks)
SHARD_TOL = 1e-6
#: against the JAX step: ``tests/test_torch_train.py``'s trajectory bound
TRAJ_TOL = 1e-4


def smoke(opt: str = "adamw", jax_pkg: bool = False):
    c = (jconfigs if jax_pkg else configs)
    return dataclasses.replace(c.smoke_variant(c.ARCHS["smollm-135m"]),
                               optimizer=opt)


def jax_state(opt: str, seed: int = 0, grad_compression: bool = False):
    japi = JModelAPI(smoke(opt, jax_pkg=True))
    return japi, jtrainstep.init_state(japi, jax.random.key(seed),
                                       grad_compression=grad_compression)


def host(tree):
    return jax.tree.map(np.asarray, tree)


def make_batches(seed: int, n: int = STEPS, b: int = B):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(1, 256, (b, S)).astype(np.int32),
             "labels": rng.integers(1, 256, (b, S)).astype(np.int32)}
            for _ in range(n)]


def jax_run(opt, batches, accum=ACCUM, seed=0):
    """(initial state, final state, per-step metrics) of the JAX step."""
    japi, st = jax_state(opt, seed)
    first = host(st)
    step = jax.jit(jtrainstep.make_train_step(japi, accum=accum, **KW))
    metrics = []
    for b in batches:
        st, m = step(st, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return first, host(st), metrics


def port_run(opt, state, batches, accum=ACCUM, kw=KW):
    """(final state in the JAX layout, per-step metrics) of the port's
    unsharded step from a JAX state."""
    api = ModelAPI(smoke(opt), device="cpu")
    st = train_state_from_jax(state, api.model)
    step = trainstep.make_train_step(api, accum=accum, **kw)
    metrics = []
    for b in batches:
        st, m = step(st, {k: torch.from_numpy(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return train_state_to_jax(st), metrics


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def worst(got, want):
    """(the worst relative L2 over the leaves of two JAX-layout trees,
    its path); the trees must hold the same leaves."""
    g, w = flatten_paths(got), flatten_paths(want)
    assert sorted(g) == sorted(w), sorted(set(g) ^ set(w))
    errs = {p: rel_l2(g[p], w[p]) for p in w
            if np.asarray(w[p]).dtype.kind == "f"}
    p = max(errs, key=errs.get)
    return errs[p], p
