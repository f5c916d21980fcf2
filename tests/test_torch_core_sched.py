"""The port's scheduler (``core/sched``, ``core/rm``) against the JAX
package's, on the CPU.

The same hand-wired DAGs, over the same zarquet files, run through
``repro.core`` and ``repro_torch.core`` under every eviction policy of
``POLICIES`` and every schedule of ``SCHEDULES``: the order the nodes
ran in, the final node states, the run and eviction counters and every
output buffer must be equal.  The DAGs mix the paper's column-adding
chains with a star join and group-by, so the port's path reaches its
relational kernels (their plain versions here) under the scheduler.
"""

import functools

import numpy as np
import pytest

import repro.core as rcore
import repro_torch.core as tcore
from repro.core import ops as r_ops
from repro.core import zarquet as r_zq
from repro_torch.core import kdispatch
from repro_torch.core import ops as t_ops
from repro_torch.core import zarquet as t_zq

PKGS = {"repro": (rcore, r_ops, r_zq), "repro_torch": (tcore, t_ops, t_zq)}
AGGS = {"n": ("amount", "count"), "total": ("amount", "sum"),
        "hi": ("amount", "max")}


@pytest.fixture(autouse=True)
def cpu_kernels():
    with kdispatch.using_device("cpu"):
        yield


def same(a, b, where="") -> None:
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert a.tobytes() == b.tobytes(), where
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{where}[{i}]")
    else:
        assert a == b, f"{where}: {a!r} != {b!r}"


def table_buffers(t) -> list:
    out = []
    for b in t.combine().batches:
        for f, c in zip(b.schema.fields, b.columns):
            bufs = [c.values, c.offsets, c.validity]
            if c.dictionary is not None:
                bufs += [c.dictionary.values, c.dictionary.offsets]
            out.append((f.name, str(c.type), [
                None if x is None else
                np.ascontiguousarray(x).view(np.uint8).copy()
                for x in bufs]))
    return out


def write_sources(zq, core, d, n_chains):
    """Column tables for the chains, and a small star schema."""
    paths = []
    for i in range(n_chains):
        p = str(d / f"s{i}.zq")
        zq.write_table(p, zq.gen_int_table(4, 1 << 14, seed=i))
        paths.append(p)
    rng = np.random.default_rng(11)
    orders = core.Table.from_pydict({
        "cust": rng.integers(0, 110, 1500),
        "amount": rng.integers(0, 1000, 1500)})
    customers = core.Table.from_pydict({
        "cust": np.arange(100, dtype=np.int64),
        "country": [f"n{i % 7}" for i in range(100)]})
    po, pc = str(d / "orders.zq"), str(d / "customers.zq")
    zq.write_table(po, orders)
    zq.write_table(pc, customers)
    return paths, po, pc


def traced(trace, dag, name, fn):
    def run(ts):
        trace.append((dag, name))
        return fn(ts)
    return run


def chain_dag(core, ops, path, depth, name, trace, est=1 << 16):
    """load -> ``depth`` column-adding nodes -> a one-row sum (kept)."""
    nodes = [core.NodeSpec("load", source=path, est_mem=est)]
    prev = "load"
    for i in range(depth):
        fn = functools.partial(ops.add_columns_compute, a="i0", b="i1",
                               out_name=f"n{i}")
        nodes.append(core.NodeSpec(
            f"add{i}", fn=traced(trace, name, f"add{i}",
                                 lambda ts, fn=fn: fn(ts[0])),
            deps=[prev], est_mem=est // 2))
        prev = f"add{i}"
    nodes.append(core.NodeSpec(
        "sum", fn=lambda ts: core.Table.from_pydict({"total": np.array(
            [ops.sum_all_ints(ts[0])], dtype=np.int64)}),
        deps=[prev], est_mem=1 << 12, keep_output=True))
    return core.DAG(nodes, name=name)


def star_dag(core, ops, po, pc, name, trace, how="left"):
    return core.DAG([
        core.NodeSpec("orders", source=po, est_mem=1 << 16),
        core.NodeSpec("customers", source=pc, est_mem=1 << 14),
        core.NodeSpec("join", fn=traced(trace, name, "join", functools.partial(
            ops.join_node, on="cust", how=how)),
            deps=["orders", "customers"], est_mem=1 << 16),
        core.NodeSpec("group_by", fn=traced(
            trace, name, "group_by", functools.partial(
                ops.group_by_node, keys="country", aggs=AGGS)),
            deps=["join"], est_mem=1 << 12, keep_output=True),
    ], name=name)


#: the budget that makes these DAGs evict.  Rollback under a schedule that
#: interleaves DAGs (breadth, fair) re-runs evicted nodes whose consumers
#: are evicted in turn, and never finishes at it, in both packages
#: (ROADMAP.md queue 3, item o): those two run under a budget that fits.
LIMIT = 3 << 15
LIVELOCKS = {("rollback", "breadth"), ("rollback", "fair")}


def sched_case(core, ops, zq, d, policy, schedule):
    paths, po, pc = write_sources(zq, core, d, 2)
    store = core.BufferStore(swap_dir=str(d / "swap"))
    rm = core.ResourceManager(store, core.RMConfig(
        memory_limit=LIMIT if (policy, schedule) not in LIVELOCKS
        else 1 << 20, policy=policy, schedule=schedule, decache=False))
    ex = core.Executor(store, rm, workers=1)
    trace = []
    try:
        dags = [chain_dag(core, ops, p, 4, f"c{i}", trace)
                for i, p in enumerate(paths)]
        dags.append(star_dag(core, ops, po, pc, "star", trace))
        dags[-1].deadline = 1.0                  # urgent under "deadline"
        ex.run(dags)
        outs = {}
        for g in dags:
            for n, st in g.nodes.items():
                if st.spec.keep_output:
                    outs[f"{g.name}.{n}"] = table_buffers(
                        core.SipcReader(store).read_table(st.output))
        obs = {"trace": trace, "outs": outs,
               "status": {f"{g.name}.{n}": st.status for g in dags
                          for n, st in g.nodes.items()},
               "node_runs": ex.node_runs, "load_runs": ex.load_runs}
        if policy != "adaptive":       # adaptive picks by measured latency
            obs["evictions"] = dict(rm.evictions)
        return obs
    finally:
        ex.close()
        store.close()


@pytest.mark.parametrize("schedule", list(rcore.SCHEDULES))
@pytest.mark.parametrize("policy", list(rcore.POLICIES))
def test_schedule_and_eviction_match_reference(tmp_path, policy, schedule):
    assert list(tcore.POLICIES) == list(rcore.POLICIES)
    assert list(tcore.SCHEDULES) == list(rcore.SCHEDULES)
    got = {}
    for name, (core, ops, zq) in PKGS.items():
        d = tmp_path / name
        d.mkdir()
        got[name] = sched_case(core, ops, zq, d, policy, schedule)
    same(got["repro_torch"], got["repro"], f"{policy}/{schedule}")
    if policy in ("rollback", "limitdrop") and (policy,
                                                 schedule) not in LIVELOCKS:
        assert got["repro"]["evictions"][policy] > 0


# --------------------------------------------------------------------------
# ResourceManager: admission, reservations and refcount-safe GC
# --------------------------------------------------------------------------

def admission_case(core, ops, zq, d):
    paths, _, _ = write_sources(zq, core, d, 1)
    store = core.BufferStore(swap_dir=str(d / "swap"))
    rm = core.ResourceManager(store, core.RMConfig(memory_limit=100))
    try:
        g = chain_dag(core, ops, paths[0], 1, "r", [], est=60)
        load, add = g.nodes["load"], g.nodes["add0"]
        seen = [rm.admit(load)]
        rm.admission.reserve(load)
        seen += [rm.available(), rm.admit(load), rm.admit(add)]
        rm.admission.reserve(load)
        seen += [rm.available(), rm.admit(add)]
        rm.admission.unreserve(load)
        rm.admission.unreserve(load)
        seen.append(rm.available())
        return seen
    finally:
        store.close()


def test_admission_matches_reference(tmp_path):
    got = {}
    for name, (core, ops, zq) in PKGS.items():
        (tmp_path / name).mkdir()
        got[name] = admission_case(core, ops, zq, tmp_path / name)
    assert got["repro_torch"] == got["repro"] == \
        [True, 40, False, True, -20, False, 100]


def gc_case(core, ops, zq, d, policy):
    """Outputs of finished DAGs are collected (files deleted, charges
    freed) except the kept sinks, whose release frees the rest."""
    paths, po, pc = write_sources(zq, core, d, 2)
    store = core.BufferStore(swap_dir=str(d / "swap"))
    rm = core.ResourceManager(store, core.RMConfig(
        memory_limit=LIMIT, policy=policy, decache=False))
    ex = core.Executor(store, rm, workers=2)
    try:
        dags = [chain_dag(core, ops, p, 3, f"c{i}", [])
                for i, p in enumerate(paths)]
        dags.append(star_dag(core, ops, po, pc, "star", [], how="inner"))
        ex.run(dags)
        kept = [st.output for g in dags for st in g.nodes.values()
                if st.spec.keep_output]
        live = len(store.files)
        out = table_buffers(core.SipcReader(store).read_table(kept[-1]))
        for m in kept:
            m.release()
            rm._gc(m)
        return {"kept_files": live > 0, "out": out,
                "after": len(store.files), "charged": store.global_charged,
                "completed": len(rm.completed_nodes)}
    finally:
        ex.close()
        store.close()


@pytest.mark.parametrize("policy", ["rollback", "limitdrop"])
def test_gc_matches_reference(tmp_path, policy):
    got = {}
    for name, (core, ops, zq) in PKGS.items():
        (tmp_path / name).mkdir()
        got[name] = gc_case(core, ops, zq, tmp_path / name, policy)
    same(got["repro_torch"], got["repro"], policy)
    assert got["repro"]["kept_files"]
    assert got["repro"]["after"] == 0 and got["repro"]["charged"] == 0


# --------------------------------------------------------------------------
# the thread pool under more workers than cores
# --------------------------------------------------------------------------

@pytest.mark.parametrize("workers", [2, 4])
def test_concurrent_star_equals_sequential(tmp_path, workers):
    """Several star DAGs at once through the pool: every output equals
    the sequential run's and the reference package's, whatever order the
    workers took the nodes in."""
    got = {}
    for name, (core, ops, zq) in PKGS.items():
        d = tmp_path / name
        d.mkdir()
        _, po, pc = write_sources(zq, core, d, 0)
        res = {}
        for w in (1, workers):
            store = core.BufferStore(swap_dir=str(d / f"swap{w}"))
            rm = core.ResourceManager(store, core.RMConfig(workers=w))
            ex = core.Executor(store, rm, workers=w)
            try:
                dags = [star_dag(core, ops, po, pc, f"s{i}", [],
                                 how=("left", "inner")[i % 2])
                        for i in range(6)]
                ex.run(dags)
                res[w] = [table_buffers(core.SipcReader(store).read_table(
                    g.nodes["group_by"].output)) for g in dags]
            finally:
                ex.close()
                store.close()
        same(res[workers], res[1], f"{name} workers={workers}")
        got[name] = res[1]
    same(got["repro_torch"], got["repro"], "star")
