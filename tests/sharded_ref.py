"""References for the port's sharded-step tests, computed in the test
process: the JAX package's step and the port's unsharded step, from the
same initial state and numpy batches, for the smoke variant of any arch
(``smoke_variant(smollm-135m)`` by default) at float32; and the JAX step
under a mesh, in a subprocess (``JaxMeshRuns``).  The port's helpers
import no JAX, so the port-against-unsharded tests also run where JAX
cannot be imported; there ``first_state`` is the port's own seeded
initial state and the JAX comparisons skip."""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch

from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.models.api import ModelAPI
from repro_torch.models.convert import (flatten_paths, nest,
                                        train_state_from_jax,
                                        train_state_to_jax)
from repro_torch.train import trainstep
from torch_ranks import as_float64, double_params, float64_compute

#: the JAX package's references can run here (JAX importable)
HAVE_JAX = importlib.util.find_spec("jax") is not None
ARCH = "smollm-135m"
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
#: optimizer moments against the JAX step, relative L2 per leaf:
#: ``tests/test_torch_recurrent_train.py``'s bound (rwkv's u enters
#: through r . (u k) summed over tokens of both signs, so its grad and
#: moments carry that cancellation's float32 noise)
MOMENT_TOL = 1e-3
ROOT = os.path.join(os.path.dirname(__file__), "..")


def smoke(opt: str = "adamw", jax_pkg: bool = False, arch: str = ARCH,
          cfg: dict | None = None):
    """The smoke variant of ``arch`` with ``opt`` and the ``cfg``
    overrides."""
    if jax_pkg:
        from repro import configs as c
    else:
        c = configs
    return dataclasses.replace(c.smoke_variant(c.ARCHS[arch]),
                               optimizer=opt, **(cfg or {}))


def jax_state(opt: str, seed: int = 0, grad_compression: bool = False,
              arch: str = ARCH, cfg: dict | None = None):
    import jax

    from repro.models.api import ModelAPI as JModelAPI
    from repro.train import trainstep as jtrainstep
    japi = JModelAPI(smoke(opt, jax_pkg=True, arch=arch, cfg=cfg))
    return japi, jtrainstep.init_state(japi, jax.random.key(seed),
                                       grad_compression=grad_compression)


def host(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


def first_state(opt: str, seed: int = 0, arch: str = ARCH,
                cfg: dict | None = None):
    """An initial train state in the JAX layout (numpy): the JAX
    package's (``jax_state``) where JAX is installed, else the port's own
    drawn from a seeded generator."""
    if HAVE_JAX:
        return host(jax_state(opt, seed, arch=arch, cfg=cfg)[1])
    api = ModelAPI(smoke(opt, arch=arch, cfg=cfg), device="cpu")
    return train_state_to_jax(trainstep.init_state(
        api, torch.Generator().manual_seed(seed)))


def make_batches(seed: int, n: int = STEPS, b: int = B, arch: str = ARCH):
    """``n`` train batches of ``b`` rows by ``ModelAPI.input_specs`` at S:
    tokens and labels in [1, 256), and for the vlm and audio families
    seeded normal ``patches`` or ``frames``."""
    rng = np.random.default_rng(seed)
    specs = ModelAPI(smoke(arch=arch), device="meta").input_specs(
        ShapeConfig("t", "train", S, b))
    out = []
    for _ in range(n):
        batch = {k: rng.integers(1, 256, specs[k]).astype(np.int32)
                 for k in ("tokens", "labels")}
        for k in ("patches", "frames"):
            if k in specs:
                batch[k] = rng.standard_normal(specs[k]).astype(np.float32)
        out.append(batch)
    return out


def jax_run(opt, batches, accum=ACCUM, seed=0, arch: str = ARCH,
            cfg: dict | None = None):
    """(initial state, final state, per-step metrics) of the JAX step."""
    import jax
    import jax.numpy as jnp

    from repro.train import trainstep as jtrainstep
    japi, st = jax_state(opt, seed, arch=arch, cfg=cfg)
    first = host(st)
    step = jax.jit(jtrainstep.make_train_step(japi, accum=accum, **KW))
    metrics = []
    for b in batches:
        st, m = step(st, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return first, host(st), metrics


def port_run(opt, state, batches, accum=ACCUM, kw=KW, arch: str = ARCH,
             cfg: dict | None = None, float64: bool = False,
             capture: bool = False):
    """(final state in the JAX layout, per-step metrics[, the first
    step's grads by leaf path as numpy, with ``capture``]) of the port's
    unsharded step from a JAX state; with ``float64`` the weights, inputs
    and compute are float64 (``torch_ranks.float64_compute``)."""
    cfg = dict(cfg or {})
    if float64:
        cfg.update(dtype="float64", param_dtype="float64")
        state = as_float64(state)
        batches = [as_float64(b) for b in batches]
    api = ModelAPI(smoke(opt, arch=arch, cfg=cfg), device="cpu")
    if float64:
        double_params(api.model)
    st = train_state_from_jax(state, api.model)
    step = trainstep.make_train_step(api, accum=accum, **kw)
    metrics, grads = [], None
    with float64_compute() if float64 else contextlib.nullcontext():
        for j, b in enumerate(batches):
            cap = {} if capture and j == 0 else None
            st, m = step(st, {k: torch.from_numpy(v) for k, v in b.items()},
                         cap)
            metrics.append({k: float(v) for k, v in m.items()})
            if cap is not None:
                grads = {p: g.numpy().copy() for p, g in cap["grads"].items()}
    out = (train_state_to_jax(st), metrics)
    return out + (grads,) if capture else out


JAX_MESH = r"""
import json, sys
import numpy as np, jax, jax.numpy as jnp
import sharded_ref as ref
from repro.compat import make_mesh
from repro.sharding import partition
from repro.train import trainstep
from repro_torch.models.convert import flatten_paths
spec = json.load(open(sys.argv[1] + ".json"))
mesh = make_mesh(tuple(spec["shape"]), tuple(spec["names"]))
rules = getattr(partition, spec["rules"])
for run in spec["runs"]:
    data = np.load(sys.argv[1] + "." + run["name"] + ".in.npz")
    batches = [{k.split("/", 1)[1]: jnp.asarray(data[k]) for k in data.files
                if k.startswith(f"{i}/")} for i in range(run["steps"])]
    japi, st = ref.jax_state(run["optimizer"], run["seed"], arch=run["arch"],
                             cfg=run["cfg"])
    metrics = []
    with partition.use_mesh(mesh, rules):
        st = jax.device_put(st, partition.shardings_for_tree(
            trainstep.state_axes(japi), mesh, rules, st))
        step = jax.jit(trainstep.make_train_step(
            japi, mesh=mesh, accum=run["accum"], **ref.KW))
        for b in batches:
            st, m = step(st, b)
            metrics.append({k: float(v) for k, v in m.items()})
    out = sys.argv[1] + "." + run["name"]
    np.savez(out + ".npz", **flatten_paths(ref.host(st)))
    json.dump(metrics, open(out + ".out.json", "w"))
"""


def _jax_subprocess(script: str, path: str, n_devices: int):
    """``script`` run with ``path`` in a subprocess of ``n_devices`` host
    devices (the count is process-wide), the port and these helpers on
    its path."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={n_devices}",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(ROOT, "src"), os.path.dirname(__file__)]))
    return subprocess.Popen([sys.executable, "-c", script, path], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _wait(proc, timeout: float):
    try:
        _, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]


class JaxMeshRuns:
    """The JAX step under a mesh, in a subprocess with that many host
    devices (the device count is process-wide): each run {"name",
    "arch", "cfg", "optimizer", "seed", "accum", "batches"} starts from
    ``jax_state(optimizer, seed, arch=, cfg=)``, is placed by the JAX
    ``state_axes`` under ``rules`` and steps through its batches under
    ``use_mesh``.  ``results()`` waits and returns {name: (the final
    state in the JAX layout as numpy, per-step metrics)}."""

    def __init__(self, path: str, shape, names, rules: str, runs):
        self.path, self.names = path, [r["name"] for r in runs]
        for r in runs:
            np.savez(f"{path}.{r['name']}.in.npz",
                     **{f"{i}/{k}": v for i, b in enumerate(r["batches"])
                        for k, v in b.items()})
        with open(path + ".json", "w") as f:
            json.dump({"shape": list(shape), "names": list(names),
                       "rules": rules,
                       "runs": [dict({k: v for k, v in r.items()
                                      if k != "batches"},
                                     steps=len(r["batches"]))
                                for r in runs]}, f)
        self.proc = _jax_subprocess(JAX_MESH, path, int(np.prod(shape)))

    def results(self, timeout: float = 300.0):
        _wait(self.proc, timeout)
        out = {}
        for name in self.names:
            base = f"{self.path}.{name}"
            with open(base + ".out.json") as f:
                metrics = json.load(f)
            out[name] = (nest(dict(np.load(base + ".npz"))), metrics)
        return out


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def worst(got, want, prefix: str = ""):
    """(the worst relative L2 over the float leaves of two JAX-layout
    trees whose paths start with ``prefix``, its path); the trees must
    hold the same leaves."""
    g, w = flatten_paths(got), flatten_paths(want)
    assert sorted(g) == sorted(w), sorted(set(g) ^ set(w))
    errs = {p: rel_l2(g[p], w[p]) for p in w
            if np.asarray(w[p]).dtype.kind == "f" and p.startswith(prefix)}
    p = max(errs, key=errs.get)
    return errs[p], p


JAX_MESH_SERVE = r"""
import dataclasses, json, sys
import numpy as np, jax, jax.numpy as jnp
jax.devices()     # the device count is fixed before dryrun's import sets one
from repro import configs
from repro.compat import make_mesh
from repro.kernels import ref as jref
from repro.launch import dryrun
from repro.models import lm, rwkv6
from repro.models.api import ModelAPI
from repro.sharding import partition
from repro_torch.models.convert import nest
# the JAX rwkv prefill asserts S % 16 == 0 in its chunked form (ROADMAP
# queue 3 item h): the sequential oracle computes the same function
rwkv6.wkv6_chunked = lambda r, k, v, w, u, state=None, chunk=0: \
    jref.wkv6_ref(r, k, v, w, u, state)
record = []
moe_apply = lm.moe_apply
def recording_moe_apply(p, x, cfg):
    out, aux = moe_apply(p, x, cfg)
    xt = x.reshape(-1, x.shape[-1])
    probs = jax.nn.softmax((xt @ p["router"].astype(x.dtype))
                           .astype(jnp.float32), -1)
    _, gate_e = jax.lax.top_k(probs, cfg.top_k)
    jax.debug.callback(lambda e, d: record.append((np.asarray(e), float(d))),
                       gate_e, aux["moe_dropped"], ordered=False)
    return out, aux
lm.moe_apply = recording_moe_apply
spec = json.load(open(sys.argv[1] + ".json"))
for run in spec["runs"]:
    cfg = dataclasses.replace(
        configs.smoke_variant(configs.ARCHS[run["arch"]]), **run["cfg"])
    api = ModelAPI(cfg)
    mesh = make_mesh(tuple(run["shape"]), tuple(run["names"]))
    rules = getattr(partition, run["rules"])
    base = sys.argv[1] + "." + run["file"]
    data = np.load(base + ".in.npz")
    params = nest({k[2:]: data[k] for k in data.files if k.startswith("p/")})
    tokens = data["tokens"]
    extra = {k[2:]: data[k] for k in data.files if k.startswith("x/")}
    B, S = tokens.shape
    T, steps = run["cache"], run["steps"]
    # _lower_prefill / _lower_decode as they are, fed float32 weights and
    # a prompt of S tokens into caches of T positions
    f32 = jax.eval_shape(lambda: api.model.init(jax.random.key(0)))
    dryrun._serve_param_specs = lambda api: f32
    specs = api.input_specs
    api.input_specs = lambda shape: (
        {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32),
         **{k: jax.ShapeDtypeStruct(v.shape, v.dtype)
            for k, v in extra.items()}}
        if shape.kind == "prefill" else specs(shape))
    # decode continues after the patches and the text (a vlm's patches
    # take the first positions)
    start = S + (cfg.vision_tokens if "patches" in extra else 0)
    record.clear()
    with partition.use_mesh(mesh, rules):
        pre = dryrun._lower_prefill(
            api, configs.ShapeConfig("p", "prefill", T, B), mesh,
            rules).compile()
        dec = dryrun._lower_decode(
            api, configs.ShapeConfig("d", "decode", T, B), mesh,
            rules).compile()
        logits, caches = pre(*jax.device_put(
            (params, {"tokens": tokens, **extra}), pre.input_shardings[0]))
        out = [np.asarray(logits)]
        for i in range(steps):
            tok = out[-1][:, -1].argmax(-1).astype(np.int32)[:, None]
            b = {"tokens": tok,
                 "positions": np.full((B, 1), start + i, np.int32)}
            logits, caches = dec(*jax.device_put((params, b, caches),
                                                 dec.input_shardings[0]))
            out.append(np.asarray(logits))
    jax.effects_barrier()
    np.savez(base + ".out.npz",
             **{f"logits/{i}": x for i, x in enumerate(out)},
             **{f"route/{i}": e for i, (e, _) in enumerate(record)})
    json.dump([d for _, d in record], open(base + ".out.json", "w"))
"""


def _file(name: str) -> str:
    return name.replace("/", "-")


class JaxMeshServe:
    """The JAX package's serving under a mesh, in a subprocess of
    ``n_devices`` host devices: each run {"name", "arch", "cfg" (smoke
    overrides), "mesh": (shape, names), "rules", "params" (the JAX
    layout, numpy), "tokens" (B, S), "cache", "steps"[, "extra": patches
    or frames, numpy]} runs the jits that
    ``dryrun._lower_prefill`` and ``_lower_decode`` build, with their
    in_shardings, fed the float32 weights: the prompt, then greedy decode
    steps.  ``results()`` waits and returns {name: (each step's logits,
    each MoE call's moe_dropped, each MoE call's routing (T, k))}."""

    def __init__(self, path: str, runs, n_devices: int = 4):
        self.path, self.names = path, [r["name"] for r in runs]
        for r in runs:
            np.savez(f"{path}.{_file(r['name'])}.in.npz", tokens=r["tokens"],
                     **{f"p/{k}": v for k, v in
                        flatten_paths(r["params"]).items()},
                     **{f"x/{k}": v for k, v in r.get("extra", {}).items()})
        with open(path + ".json", "w") as f:
            json.dump({"runs": [dict(
                name=r["name"], file=_file(r["name"]), arch=r["arch"],
                cfg=r["cfg"],
                shape=list(r["mesh"][0]), names=list(r["mesh"][1]),
                rules=r["rules"], cache=r["cache"], steps=r["steps"])
                for r in runs]}, f)
        self.proc = _jax_subprocess(JAX_MESH_SERVE, path, n_devices)

    def results(self, timeout: float = 300.0):
        _wait(self.proc, timeout)
        out = {}
        for name in self.names:
            base = f"{self.path}.{_file(name)}"
            data = np.load(base + ".out.npz")
            with open(base + ".out.json") as f:
                dropped = json.load(f)
            n = sum(k.startswith("logits/") for k in data.files)
            out[name] = ([data[f"logits/{i}"] for i in range(n)], dropped,
                         [data[f"route/{i}"] for i in range(len(dropped))])
        return out
