"""Helpers for the port's multi-process tests: spawn gloo ranks on the
CPU with a deadline, and the functions the ranks run.

``run(fn, world, *args)`` (or ``Ranks(...)``, then ``.results()``)
starts ``world`` spawned processes, each with
one torch thread, joins a gloo process group on a free localhost port
(with a timeout) and calls ``fn(rank, world, *args)``; it returns every
rank's result in rank order.  A rank that raises, dies or outlives the
deadline fails the call, and every rank still alive is killed, so no
test can hang the suite.  This module imports torch and the port alone:
a spawned rank imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import os
import queue
import socket
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

#: the longest a group of ranks may take; each test's own deadline
DEADLINE_S = 150.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(fn, rank, world, port, q, args):
    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    try:
        from repro_torch.launch.mesh import init_distributed
        init_distributed("cpu", timeout_s=100.0)
        q.put((rank, True, fn(rank, world, *args)))
    except BaseException:
        q.put((rank, False, traceback.format_exc()))
        q.close()
        q.join_thread()        # the result reaches the parent before the
        os._exit(1)            # exit; peers that wait are killed there
    dist.destroy_process_group()


class Ranks:
    """A group of spawned ranks running ``fn``; ``results()`` waits for
    them (the caller may work meanwhile)."""

    def __init__(self, fn, world: int, *args,
                 deadline_s: float = DEADLINE_S):
        ctx = mp.get_context("spawn")
        self.q = ctx.Queue()
        port = _free_port()
        self.world = world
        self.deadline_s = deadline_s
        self.procs = [ctx.Process(target=_entry,
                                  args=(fn, r, world, port, self.q, args),
                                  daemon=True) for r in range(world)]
        for p in self.procs:
            p.start()
        self.end = time.monotonic() + deadline_s

    def results(self):
        procs, results = self.procs, {}
        try:
            while len(results) < self.world:
                left = self.end - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"{self.world} ranks outlived their "
                                       f"{self.deadline_s:.0f} s deadline")
                try:
                    rank, ok, val = self.q.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [i for i, p in enumerate(procs)
                            if p.exitcode not in (None, 0)
                            and i not in results]
                    if dead:
                        raise RuntimeError(f"ranks {dead} died without a "
                                           "result")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{val}")
                results[rank] = val
            for p in procs:
                p.join(max(0.1, self.end - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(5)
        return [results[r] for r in range(self.world)]


def run(fn, world: int, *args, deadline_s: float = DEADLINE_S):
    return Ranks(fn, world, *args, deadline_s=deadline_s).results()


# -- checks a rank makes on its own state ------------------------------------

def _dtensors(state):
    """(name, DTensor) of every DTensor of a port train state."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models.convert import flatten_paths
    out = [(f"params/{n}", p) for n, p in
           state["params"].named_parameters()]
    for key in ("opt", "residual"):
        if key in state:
            out += [(f"{key}/{p}", t) for p, t in
                    flatten_paths(state[key]).items()]
    return [(n, t) for n, t in out if isinstance(t, DTensor)]


def shard_report(state, shardings) -> list:
    """Faults of this rank's shards: a DTensor whose placements are not
    its leaf's sharding, a local shard whose shape is not the spec's,
    and (by an all-gather over each mesh dim that replicates it) a shard
    that differs in one bit from its replicas."""
    from torch.distributed.tensor import Replicate

    from repro_torch.models.convert import flatten_paths, jax_leaves
    faults = []
    want = {}
    p_sh = flatten_paths(shardings["params"])
    names = {p: n for n, p in state["params"].named_parameters()}
    for leaf in jax_leaves(state["params"]):
        sh = p_sh[leaf.path]
        spec = sh.spec[1:] if leaf.stacked else sh.spec
        for p in leaf.params:
            want[f"params/{names[p]}"] = (sh.mesh, spec)
    for key in ("opt", "residual"):
        for path, sh in flatten_paths(shardings.get(key, {})).items():
            want[f"{key}/{path}"] = (sh.mesh, sh.spec)
    from repro_torch.sharding.partition import spec_to_placements
    for name, t in _dtensors(state):
        mesh, spec = want[name]
        if tuple(t.placements) != spec_to_placements(spec, mesh):
            faults.append(f"{name}: placements {t.placements}, spec {spec}")
        sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
        local = list(t.shape)
        for d, e in enumerate(spec):
            for a in () if e is None else (e,) if isinstance(e, str) else e:
                local[d] //= sizes[a]
        if list(t.to_local().shape) != local:
            faults.append(f"{name}: local {tuple(t.to_local().shape)}, "
                          f"spec {spec} wants {tuple(local)}")
        mine = t.to_local().contiguous()
        for i, pl in enumerate(t.placements):
            if not isinstance(pl, Replicate) or t.device_mesh.size(i) == 1:
                continue
            group = t.device_mesh.get_group(i)
            got = [torch.empty_like(mine)
                   for _ in range(dist.get_world_size(group))]
            dist.all_gather(got, mine, group=group)
            if not all(torch.equal(g.view(torch.uint8) if g.is_floating_point()
                                   else g, mine.view(torch.uint8)
                                   if mine.is_floating_point() else mine)
                       for g in got):
                faults.append(f"{name}: replicas over "
                              f"{t.device_mesh.mesh_dim_names[i]} differ")
    return faults


@contextlib.contextmanager
def one_rank():
    """A gloo process group of world size 1 in this process (an in-memory
    store, no port), for a DeviceMesh of one rank."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def float64_compute():
    """Every ``.float()`` gives float64 while this is active, so a model
    whose weights and inputs are float64 computes in float64 throughout,
    its own float32 steps (norms, recurrences, router, loss, optimizer)
    included: ``chip_smoke.py``'s ``float64_grads`` twin."""
    from unittest import mock

    def f64(t, *a, **k):
        return t if t.dtype == torch.float64 else t.double()
    with mock.patch.object(torch.Tensor, "float", f64):
        yield


def double_params(model) -> None:
    """Every parameter of ``model`` as float64, the float32 ones of a
    float64 config (norm weights, decays) too."""
    for p in model.parameters():
        p.data = p.data.double()


def as_float64(tree):
    """A nested dict of numpy arrays with every float32 leaf as float64."""
    if isinstance(tree, dict):
        return {k: as_float64(v) for k, v in tree.items()}
    a = np.asarray(tree)
    return a.astype(np.float64) if a.dtype == np.float32 else a


def batches_torch(batches):
    return [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]


# -- rank functions ----------------------------------------------------------

def _mesh(shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))


def train_runs(rank, world, runs, save_dir=None):
    """Each run: {"name", "mesh": (shape, names), "rules", "optimizer",
    "accum", "compress", "state": the JAX train state (numpy), "batches",
    "kw": make_train_step's schedule[, "arch" (smollm-135m by default),
    "cfg": overrides of its smoke variant][, "float64": True: weights,
    inputs and compute in float64 (``float64_compute``)][, "capture":
    True][, "ckpt": a directory: the final state saved there and restored
    with ``shardings=``]}.  Each is built
    from the JAX state, placed by ``shard_state``, stepped through its
    batches, checked with ``shard_report``, and gathered.  Returns
    {name: (per-step metrics, the final state in the JAX layout on rank 0
    else None, faults[, the first step's capture, gathered: grads,
    residual, (codes, scale)])};
    with ``save_dir`` the first run's final state is also saved there
    (every rank calls ``save``)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models.api import ModelAPI
    from repro_torch.models.convert import (to_host, train_state_from_jax,
                                            train_state_to_jax)
    from repro_torch.runtime.checkpoint import CheckpointStore
    from repro_torch.sharding import partition
    from repro_torch.train import trainstep
    out = {}
    for i, r in enumerate(runs):
        over = dict(r.get("cfg", {}))
        f64 = r.get("float64", False)
        if f64:
            over.update(dtype="float64", param_dtype="float64")
        cfg = dataclasses.replace(
            configs.smoke_variant(configs.ARCHS[r.get("arch",
                                                      "smollm-135m")]),
            optimizer=r["optimizer"], **over)
        api = ModelAPI(cfg, device="cpu")
        if f64:
            double_params(api.model)
        state = train_state_from_jax(
            as_float64(r["state"]) if f64 else r["state"], api.model)
        mesh = _mesh(*r["mesh"])
        rules = getattr(partition, r["rules"])
        shardings = trainstep.state_shardings(
            api, state, mesh, rules, grad_compression=r["compress"])
        state = trainstep.shard_state(api, state, mesh, rules,
                                      grad_compression=r["compress"])
        step = trainstep.make_train_step(
            api, mesh=mesh, rules=rules, accum=r["accum"],
            grad_compression=r["compress"], **r["kw"])
        metrics, captured = [], None
        data = [as_float64(b) for b in r["batches"]] if f64 \
            else r["batches"]
        for j, b in enumerate(batches_torch(data)):
            cap = {} if r.get("capture") and j == 0 else None
            with float64_compute() if f64 else contextlib.nullcontext():
                state, m = step(state, b, cap)
            metrics.append({k: float(v) for k, v in m.items()})
            if cap is not None:
                captured = {k: {p: (to_host(x[0]), x[1].item())
                                if k == "codes" else to_host(x)
                                for p, x in v.items()}
                            for k, v in cap.items()}
        faults = shard_report(state, shardings)
        host = train_state_to_jax(state)
        if save_dir is not None and i == 0:
            CheckpointStore(save_dir, async_io=True).save(
                len(r["batches"]), state)
        out[r["name"]] = (metrics, host if rank == 0 else None, faults)
        if r.get("capture"):
            out[r["name"]] += (captured,)
        if r.get("ckpt"):
            out[r["name"]] += (_save_and_restore(r["ckpt"], cfg, state,
                                                 host, shardings, f64),)
    return out


def _save_and_restore(root, cfg, state, host, shardings, f64=False):
    """Save a sharded state in ``root`` (rank 0 writes), restore it with
    ``shardings=`` into a fresh state of ``cfg`` (float64 params with
    ``f64``) and compare: (every leaf equal to ``host`` bit for bit, the
    restored shards' faults)."""
    from repro_torch.models.api import ModelAPI
    from repro_torch.models.convert import flatten_paths, train_state_to_jax
    from repro_torch.runtime.checkpoint import CheckpointStore
    from repro_torch.train import trainstep
    store = CheckpointStore(root, async_io=False)
    store.save(int(state["step"]), state)
    api = ModelAPI(cfg, device="cpu")
    if f64:
        double_params(api.model)
    like = trainstep.init_state(api)
    restored, _ = store.restore(like=like, shardings=shardings)
    got, want = (flatten_paths(train_state_to_jax(restored)),
                 flatten_paths(host))
    same = sorted(got) == sorted(want) and all(
        np.asarray(got[k]).tobytes() == np.asarray(want[k]).tobytes()
        for k in want)
    return same, shard_report(restored, shardings)


def restore_and_step(rank, world, save_dir, mesh, rules, opt, batch, kw):
    """Restore the snapshot in ``save_dir`` onto ``mesh`` with
    ``shardings=`` and take one more step.  Returns (the restored state
    and the stepped state in the JAX layout, the loss, faults) on every
    rank (gathered on rank 0, None elsewhere)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models.api import ModelAPI
    from repro_torch.models.convert import train_state_to_jax
    from repro_torch.runtime.checkpoint import CheckpointStore
    from repro_torch.sharding import partition
    from repro_torch.train import trainstep
    cfg = dataclasses.replace(
        configs.smoke_variant(configs.ARCHS["smollm-135m"]), optimizer=opt)
    api = ModelAPI(cfg, device="cpu")
    like = trainstep.init_state(api)
    m = _mesh(*mesh)
    rules = getattr(partition, rules)
    shardings = trainstep.state_shardings(api, like, m, rules)
    store = CheckpointStore(save_dir, async_io=False)
    state, _ = store.restore(like=like, shardings=shardings)
    faults = shard_report(state, shardings)
    restored = train_state_to_jax(state)
    step = trainstep.make_train_step(api, mesh=m, rules=rules, **kw)
    state, metrics = step(state, batches_torch([batch])[0])
    faults += shard_report(state, shardings)
    stepped = train_state_to_jax(state)
    keep = rank == 0
    return (restored if keep else None, stepped if keep else None,
            float(metrics["loss"]), faults)


def odd_pod_batch(rank, world, batch):
    """The message of the ``ValueError`` that a compressed step over
    ``world`` pods, a (world, 1, 1) mesh, raises on ``batch``
    (numpy), on smoke_variant(smollm-135m)."""
    from repro_torch import configs
    from repro_torch.models.api import ModelAPI
    from repro_torch.train import trainstep
    api = ModelAPI(configs.smoke_variant(configs.ARCHS["smollm-135m"]),
                   device="cpu")
    mesh = _mesh((world, 1, 1), ("pod", "data", "model"))
    state = trainstep.shard_state(
        api, trainstep.init_state(api, torch.Generator().manual_seed(0),
                                  grad_compression=True),
        mesh, grad_compression=True)
    step = trainstep.make_train_step(api, mesh=mesh, grad_compression=True)
    try:
        step(state, batches_torch([batch])[0])
    except ValueError as e:
        return str(e)
    return None


def compress_steps(rank, world, grads, n_pods):
    """20 rounds of ``compress_grads_allreduce`` over the world (one pod
    a rank): rank r's grads are ``grads[r]`` ({name: array}) every
    round.  Returns each round's (synced, residual) as numpy."""
    from repro_torch.runtime.compression import (compress_grads_allreduce,
                                                 init_residual)
    g = {k: torch.from_numpy(v) for k, v in grads[rank].items()}
    res = init_residual(g)
    out = []
    for _ in range(20):
        synced, res = compress_grads_allreduce(g, res, dist.group.WORLD,
                                               n_pods=n_pods)
        out.append(({k: v.numpy() for k, v in synced.items()},
                    {k: v.numpy().copy() for k, v in res.items()}))
    return out


def numpy_tree(tree):
    """Every leaf of a nested dict as a numpy array."""
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


# -- serving under a mesh ----------------------------------------------------

def serve_once(api, tokens, cache_len: int, steps: int, mesh=None,
               rules=None, extra=None):
    """Prefill ``tokens`` (B, S) into caches of ``cache_len`` positions,
    then ``steps`` greedy decode steps, each token the argmax of the
    gathered logits.  ``extra`` (numpy) joins the prompt: a vlm's
    "patches" (B, V, d), whose V positions come before the text, or an
    enc-dec's "frames" (B, cache_len, d).  On ``mesh`` under ``rules`` the
    weights (float32, not cast) and caches are placed by
    ``dryrun._lower_prefill`` and ``_lower_decode``, else the model runs
    unsharded.  Returns (each
    step's gathered logits (B, 1, V) as numpy, the tokens chosen (B,
    steps), the caches, what the MoE recorded: each call's moe_dropped
    and each call's routing, the gate experts of this rank's groups)."""
    from unittest import mock

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.models import moe
    from repro_torch.sharding.partition import unshard
    B, S = tokens.shape
    pshape = ShapeConfig("p", "prefill", cache_len, B)
    dshape = ShapeConfig("d", "decode", cache_len, B)
    if mesh is None:
        prefill = lambda b: api.prefill(b, pshape)          # noqa: E731
        decode = api.serve_step
    else:
        specs = dryrun._param_specs(api)
        prefill = dryrun._lower_prefill(api, pshape, mesh, rules, specs).fn
        decode = dryrun._lower_decode(api, dshape, mesh, rules, specs).fn
    rec = {"dropped": [], "routes": [], "call": []}
    route, apply = moe.route, moe.moe_apply

    def recording_route(*a):
        out = route(*a)
        rec["call"].append(out[3].numpy().copy())
        return out

    def recording_apply(p, x, cfg):
        rec["call"] = []
        out, aux = apply(p, x, cfg)
        rec["dropped"].append(float(unshard(aux["moe_dropped"])))
        rec["routes"].append(np.concatenate(rec["call"]))
        return out, aux
    logits, toks = [], []
    prompt = {"tokens": torch.from_numpy(tokens),
              **{k: torch.from_numpy(v) for k, v in (extra or {}).items()}}
    S += api.cfg.vision_tokens if "patches" in prompt else 0
    with mock.patch.object(moe, "route", recording_route), \
            mock.patch.object(moe, "moe_apply", recording_apply):
        out, caches = prefill(prompt)
        for i in range(steps + 1):
            logits.append(unshard(out).numpy().copy())
            if i == steps:
                break
            tok = logits[-1][:, -1].argmax(-1).astype(np.int32)[:, None]
            toks.append(tok[:, 0])
            pos = np.full((B, 1), S + i, np.int32)
            out, caches = decode({"tokens": torch.from_numpy(tok),
                                  "positions": torch.from_numpy(pos)},
                                 caches)
    return logits, np.stack(toks, 1), caches, rec["dropped"], rec["routes"]


def tree_paths(tree, prefix: str = "") -> dict:
    """The leaves of a cache tree (dicts, and the lists and tuples of the
    port's layouts: a decoder LM's list of sub-block dicts, an enc-dec's
    (self caches, cross (k, v) pairs)) by path, "0/k" or "1/3/0"; a tuple
    of axis names is a leaf."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)) and not (
            isinstance(tree, tuple)
            and all(a is None or isinstance(a, str) for a in tree)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(tree_paths(v, f"{prefix}{k}/"))
    return out


def _spec_slices(spec, mesh, shape):
    """The global slices of a tensor of ``shape`` that this rank's shard
    holds under partition spec ``spec``, from the mesh coordinates
    alone."""
    out = []
    for d, n in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        idx, parts = 0, 1
        for a in () if entry is None else \
                (entry,) if isinstance(entry, str) else entry:
            size = mesh.size(mesh.mesh_dim_names.index(a))
            idx, parts = idx * size + mesh.get_local_rank(a), parts * size
        out.append(slice(idx * n // parts, (idx + 1) * n // parts))
    return tuple(out)


def cache_report(api, caches, mesh, rules) -> tuple:
    """(faults, specs, the caches gathered whole as numpy by path) of a
    run's caches: each leaf's placements must be its spec's under
    ``rules`` (``cache_axes(stacked=False)``), and this rank's shard must
    hold exactly the positions, batch rows and heads that spec names, bit
    for bit against the gathered tensor."""
    from torch.distributed.tensor import DTensor

    from repro_torch.sharding.partition import (logical_to_spec,
                                                spec_to_placements, unshard)
    axes = tree_paths(api.cache_axes(False))
    faults, specs, whole = [], {}, {}
    for path, t in tree_paths(caches).items():
        if not isinstance(t, torch.Tensor):
            whole[path] = t
            continue
        full = unshard(t)
        whole[path] = full.numpy().copy()
        if mesh is None:
            continue
        spec = logical_to_spec(axes[path], mesh, rules, tuple(t.shape))
        specs[path] = spec
        if not isinstance(t, DTensor) or \
                tuple(t.placements) != spec_to_placements(spec, mesh):
            placed = getattr(t, "placements", None)
            faults.append(f"{path}: placed {placed}, spec {spec}")
            continue
        local = t.to_local()
        want = full[_spec_slices(spec, mesh, t.shape)]
        if local.shape != want.shape or not torch.equal(local, want):
            faults.append(f"{path}: the shard is not the spec's slice "
                          f"{_spec_slices(spec, mesh, t.shape)}")
    return faults, specs, whole


#: the rule sets the token lookup is held under, on every mesh
LOOKUP_RULES = ("DEFAULT_RULES", "FSDP_RULES", "SERVE_RULES",
                "SERVE_BIG_RULES")
LOOKUP_DTYPES = (torch.float32, torch.bfloat16)


def lookup_bits(api, ids, mesh=None, rules=None) -> dict:
    """{dtype name: the raw bits (an int array) of the token embedding of
    ``ids`` (B, S) in that dtype}, gathered whole: a decoder LM's
    ``embed_inputs`` (its compute dtype patched), an enc-dec decoder's
    ``embed_lookup`` of its table.  On ``mesh`` under ``rules`` (a
    name) the float32 weights are first placed by ``param_axes`` and the
    ids by ("batch", "seq"); the local shape of each rank's output is
    kept beside the bits ("local")."""
    from repro_torch.launch import dryrun
    from repro_torch.models.convert import place_params
    from repro_torch.models.layers import embed_lookup
    from repro_torch.sharding import partition
    model = api.model
    ids = torch.from_numpy(ids)
    ctx = contextlib.nullcontext()
    if mesh is not None:
        r = getattr(partition, rules)
        specs = dryrun._param_specs(api)
        place_params(model, partition.shardings_for_tree(
            model.param_axes(), mesh, r, specs), specs)
        ids = partition.distribute(ids, partition.NamedSharding(
            mesh, partition.logical_to_spec(("batch", "seq"), mesh, r,
                                             tuple(ids.shape))))
        ctx = partition.use_mesh(mesh, r)
    out, cdtype = {}, model.cdtype
    with ctx, torch.no_grad():
        for dt in LOOKUP_DTYPES:
            if api.cfg.is_encdec:
                x = embed_lookup(ids, model.embed, dt)
            else:
                model.cdtype = dt
                try:
                    x = model.embed_inputs(ids)
                finally:
                    model.cdtype = cdtype
            name = str(dt)[6:]
            if mesh is not None:
                out[f"{name}/local"] = tuple(x.to_local().shape)
            x = partition.unshard(x)
            bits = torch.int32 if dt == torch.float32 else torch.int16
            out[name] = x.view(bits).numpy().copy()
    return out


def serve_runs(rank, world, runs):
    """Each run: {"name", "arch", "cfg" (overrides of its smoke variant),
    "mesh": (shape, names), "rules", "params" (the JAX layout, numpy),
    "tokens" (B, S) int32, "cache" (positions), "steps"[, "extra": the
    patches or frames][, "lookup": ids (B, S)]}: ``serve_once`` on the
    mesh from those weights, then ``cache_report``; with "lookup", then
    ``lookup_bits`` of those ids under each of ``LOOKUP_RULES``.  Returns
    {name: {"logits", "tokens", "caches" (gathered; rank 0 alone keeps
    the arrays), "specs", "faults", "dropped", "routes", "coord" (this
    rank's mesh coordinate), "seconds"[, "lookup": {rules: the bits}]}};
    the meshes are made once per shape, in the runs' order, on every
    rank."""
    import dataclasses
    import time

    from repro_torch import configs
    from repro_torch.models.api import ModelAPI
    from repro_torch.models.convert import load_jax_params
    from repro_torch.sharding import partition
    meshes, out = {}, {}
    for r in runs:
        shape, names = r["mesh"]
        if tuple(shape) not in meshes:
            meshes[tuple(shape)] = _mesh(shape, names)
        mesh = meshes[tuple(shape)]
        rules = getattr(partition, r["rules"])
        cfg = dataclasses.replace(
            configs.smoke_variant(configs.ARCHS[r["arch"]]), **r["cfg"])
        api = ModelAPI(cfg, device="cpu")
        load_jax_params(api.model, r["params"])
        t0 = time.perf_counter()
        logits, toks, caches, dropped, routes = serve_once(
            api, r["tokens"], r["cache"], r["steps"], mesh, rules,
            r.get("extra"))
        seconds = time.perf_counter() - t0
        faults, specs, whole = cache_report(api, caches, mesh, rules)
        keep = rank == 0
        out[r["name"]] = dict(
            logits=logits if keep else None, tokens=toks,
            caches=whole if keep else None, specs=specs, faults=faults,
            dropped=dropped, routes=routes, seconds=seconds,
            coord=tuple(mesh.get_coordinate()))
        if "lookup" in r:
            out[r["name"]]["lookup"] = {
                rn: lookup_bits(api, r["lookup"], mesh, rn)
                for rn in LOOKUP_RULES}
    return out
