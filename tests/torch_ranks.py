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


def batches_torch(batches):
    return [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]


# -- rank functions ----------------------------------------------------------

def _mesh(shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))


def train_runs(rank, world, runs, save_dir=None):
    """Each run: {"name", "mesh": (shape, names), "rules", "optimizer",
    "accum", "compress", "state": the JAX train state (numpy), "batches",
    "kw": make_train_step's schedule[, "capture": True]}.  Each is built
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
        cfg = dataclasses.replace(
            configs.smoke_variant(configs.ARCHS["smollm-135m"]),
            optimizer=r["optimizer"], **r.get("cfg", {}))
        api = ModelAPI(cfg, device="cpu")
        state = train_state_from_jax(r["state"], api.model)
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
        for j, b in enumerate(batches_torch(r["batches"])):
            cap = {} if r.get("capture") and j == 0 else None
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
    return out


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
