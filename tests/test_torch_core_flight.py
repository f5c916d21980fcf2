"""The port's Flight data plane against the JAX package's, on the CPU.

A wire frame round trip moves references and no data in both packages; a
star join + group-by through 2 spawned Flight workers equals thread mode
and the reference package bit for bit (held on the node outputs, not on a
reshare count that depends on how the chains were cut); the kernels'
device reaches the workers, and a worker asked for ``cuda`` with no card
fails its request once, with ``resolve_device``'s error, and is neither
retried nor respawned.  Spawning a worker imports torch, so each package
shares one module-scoped pool.
"""

import functools
import os

import numpy as np
import pytest
import torch

import repro.core as rcore
import repro_torch.core as tcore
from repro.core import ops as r_ops
from repro.core import zarquet as r_zq
from repro_torch.core import kdispatch
from repro_torch.core import ops as t_ops
from repro_torch.core import zarquet as t_zq

PKGS = {"repro": (rcore, r_ops, r_zq), "repro_torch": (tcore, t_ops, t_zq)}
AGGS = {"total": ("amount", "sum"), "lo": ("amount", "min"),
        "hi": ("amount", "max"), "n": ("amount", "count")}


@pytest.fixture(autouse=True)
def cpu_kernels():
    with kdispatch.using_device("cpu"):
        yield


# module-level node fns: picklable into the workers

def worker_device(tables):
    """The kernels' device inside the process that runs the node."""
    return tcore.Table.from_pydict({"device": [kdispatch.device_name()],
                                    "pid": np.array([os.getpid()])})


def hash_in_worker(tables):
    """Dispatches one relational kernel: on ``cuda`` with no card this
    raises ``resolve_device``'s RuntimeError inside the worker."""
    b = tables[0].combine().batches[0]
    h = kdispatch.hash_fixed(b.column("cust").values)
    return tcore.Table.from_pydict({"h": h})


def table_buffers(t) -> list:
    out = []
    for b in t.combine().batches:
        for f, c in zip(b.schema.fields, b.columns):
            bufs = [c.values, c.offsets, c.validity]
            if c.dictionary is not None:
                bufs += [c.dictionary.values, c.dictionary.offsets]
            out.append((f.name, str(c.type), [
                None if x is None else
                np.ascontiguousarray(x).view(np.uint8).tobytes()
                for x in bufs]))
    return out


def star_files(core, zq, d, n_orders=6000, n_cust=500, seed=0):
    rng = np.random.default_rng(seed)
    orders = core.Table.from_pydict({
        "cust": rng.integers(0, n_cust * 11 // 10, n_orders),
        "amount": rng.integers(0, 1_000_000, n_orders)})
    customers = core.Table.from_pydict({
        "cust": np.arange(n_cust, dtype=np.int64),
        "country": [f"nation{i % 25:02d}" for i in range(n_cust)]})
    po, pc = str(d / f"orders{seed}.zq"), str(d / f"customers{seed}.zq")
    zq.write_table(po, orders)
    zq.write_table(pc, customers)
    return po, pc


def star_dag(core, ops, po, pc, how, dict_country, name):
    return core.DAG([
        core.NodeSpec("orders", source=po, est_mem=1 << 20),
        core.NodeSpec("customers", source=pc, est_mem=1 << 18,
                      dict_columns=("country",) if dict_country else ()),
        core.NodeSpec("join", fn=functools.partial(ops.join_node, on="cust",
                                                   how=how),
                      deps=["orders", "customers"], est_mem=1 << 20,
                      keep_output=True),
        core.NodeSpec("group_by", fn=functools.partial(
            ops.group_by_node, keys="country", aggs=AGGS), deps=["join"],
            est_mem=1 << 14, keep_output=True),
    ], name=name)


class Env:
    """A store, a resource manager and an executor of one package."""

    def __init__(self, pkg, mode, root, workers=2):
        core, ops, zq = PKGS[pkg]
        self.core, self.ops, self.zq = core, ops, zq
        backing = "file" if mode == "process" else "ram"
        self.store = core.BufferStore(
            swap_dir=os.path.join(root, "swap"), backing=backing,
            data_dir=os.path.join(root, "store")
            if backing == "file" else None)
        self.rm = core.ResourceManager(self.store, core.RMConfig(
            workers=workers, workers_mode=mode))
        self.ex = core.make_executor(self.store, self.rm, workers=workers)

    def star(self, po, pc, how, dict_country):
        dag = star_dag(self.core, self.ops, po, pc, how, dict_country,
                       f"star-{how}")
        self.ex.run([dag])
        out = {}
        for n in ("join", "group_by"):
            msg = dag.nodes[n].output
            out[n] = table_buffers(
                self.core.SipcReader(self.store).read_table(msg))
            msg.release()
        return out

    def close(self):
        self.ex.close()
        self.store.close()


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    """One 2-worker process pool per package, started on the CPU device."""
    envs = {}
    with kdispatch.using_device("cpu"):
        for pkg in PKGS:
            root = str(tmp_path_factory.mktemp(f"pool-{pkg}"))
            envs[pkg] = Env(pkg, "process", root)
            envs[pkg].ex._ensure_pool()
    yield envs
    for e in envs.values():
        e.close()


# --------------------------------------------------------------------------
# wire
# --------------------------------------------------------------------------

def wire_case(core, ops, d, dict_s):
    store = core.BufferStore(backing="file", data_dir=str(d / "w"))
    reader_store = core.BufferStore(backing="file", data_dir=str(d / "r"))
    try:
        rng = np.random.default_rng(7)
        t = core.Table.from_pydict({
            "a": rng.integers(0, 1 << 30, 1200),
            "s": ["alpha", "beta", "gamma", "delta"] * 300})
        if dict_s:
            t = ops.dict_encode(t, ["s"])
        sb = core.Sandbox(store, core.KernelZero(store), "w", mode="zero")
        msg = sb.write_output(t, label="t")
        written = store.copied_bytes     # the write's partial pages
        frame = core.encode_message(msg, store)
        refs = core.frame_refs(frame)
        back = core.decode_message(frame, reader_store)
        again = core.decode_message(frame, store)      # into the producer
        obs = {"table": table_buffers(
            core.SipcReader(reader_store).read_table(back)),
            "refs": [(os.path.basename(p), o, n) for p, o, n in refs],
            "copied": (store.copied_bytes - written,
                       reader_store.copied_bytes),
            "new": back.new_bytes, "reshared": back.reshared_bytes,
            "again": (again.new_bytes, again.reshared_bytes > 0),
            "small": len(frame) < 2048}
        for m in (msg, back, again):
            m.release()
        return obs
    finally:
        store.close()
        reader_store.close()


@pytest.mark.parametrize("dict_s", [False, True])
def test_wire_roundtrip_matches_reference(tmp_path, dict_s):
    got = {}
    for pkg, (core, ops, _) in PKGS.items():
        (tmp_path / pkg).mkdir()
        got[pkg] = wire_case(core, ops, tmp_path / pkg, dict_s)
    assert got["repro_torch"] == got["repro"]
    obs = got["repro"]
    assert obs["copied"] == (0, 0) and obs["small"]
    assert obs["new"] > 0 and obs["reshared"] == 0
    assert obs["again"] == (0, True)


# --------------------------------------------------------------------------
# the star query through 2 Flight workers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("how,dict_country", [
    ("left", False), ("inner", False), ("left", True)])
def test_process_star_equals_thread_and_reference(tmp_path, pools, how,
                                                  dict_country):
    out = {}
    for pkg in PKGS:
        d = tmp_path / pkg
        d.mkdir()
        po, pc = star_files(PKGS[pkg][0], PKGS[pkg][2], d)
        thread = Env(pkg, "thread", str(d / "thread"), workers=4)
        try:
            out[pkg, "thread"] = thread.star(po, pc, how, dict_country)
        finally:
            thread.close()
        out[pkg, "process"] = pools[pkg].star(po, pc, how, dict_country)
    want = out["repro", "thread"]
    for key, got in out.items():
        assert got == want, key
    for pkg in PKGS:
        ex = pools[pkg].ex
        assert ex.fallback_inline == 0 and ex.worker_retries == 0


def test_device_reaches_the_workers(tmp_path, pools):
    """The workers were spawned while the parent ran on the CPU: each
    runs its kernels there (no count of a launch on the card)."""
    env = pools["repro_torch"]
    po, _ = star_files(tcore, t_zq, tmp_path)
    dags = [tcore.DAG([
        tcore.NodeSpec("load", source=po, est_mem=1 << 20),
        tcore.NodeSpec("where", fn=worker_device, deps=["load"],
                       est_mem=1 << 12, keep_output=True)],
        name=f"where{i}") for i in range(4)]
    env.ex.run(dags)
    seen = set()
    for g in dags:
        msg = g.nodes["where"].output
        t = tcore.SipcReader(env.store).read_table(msg).to_pydict()
        seen.update(zip(t["device"], t["pid"]))
        msg.release()
    assert {dev for dev, _ in seen} == {"cpu"}
    assert all(pid != os.getpid() for _, pid in seen)
    assert not any(v for k, v in env.ex.worker_stats.items()
                   if k.startswith("launches:"))


def test_cuda_worker_without_a_card_fails_once(tmp_path):
    """A pool spawned for ``cuda`` on a host with no card: the first
    kernel dispatch in the worker raises, the run fails with that error
    once, the worker is neither retried nor respawned, and nothing falls
    back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the worker would run the kernel")
    po, _ = star_files(tcore, t_zq, tmp_path)
    with kdispatch.using_device("cuda"):
        env = Env("repro_torch", "process", str(tmp_path / "env"),
                  workers=1)
        try:
            dag = tcore.DAG([
                tcore.NodeSpec("load", source=po, est_mem=1 << 20),
                tcore.NodeSpec("hash", fn=hash_in_worker, deps=["load"],
                               est_mem=1 << 16, keep_output=True)],
                name="cuda")
            with pytest.raises(tcore.FlightWorkerError,
                               match="no CUDA device is available"):
                env.ex.run([dag])
            pool = env.ex._pool
            assert pool.device == "cuda"
            assert env.ex.worker_retries == 0 and pool.respawns == 0
            assert pool.live_workers == 1
            assert dag.nodes["hash"].output is None
        finally:
            env.close()
