"""The port's persistent cache and fingerprints, on the CPU.

A re-run over a ``cache_root`` adopts every node of a plan-compiled star
query (``CACHED``, no load, no de-anonymized byte) in both packages
alike; the port's fingerprints fold in the kernels' device and, on
``cuda``, the sha256 of each CUDA source an op launches, so a device flip
or an edited kernel source invalidates exactly the join and group-by
cones and nothing upstream of them.
"""

import hashlib

import numpy as np
import pytest

import repro.core as rcore
import repro_torch.core as tcore
from repro.core import fingerprint as r_fp
from repro.core import plan as r_plan
from repro.core import zarquet as r_zq
from repro_torch.core import fingerprint as t_fp
from repro_torch.core import kdispatch
from repro_torch.core import plan as t_plan
from repro_torch.core import zarquet as t_zq
from repro_torch.kernels import build

PKGS = {"repro": (rcore, r_zq, r_plan, r_fp),
        "repro_torch": (tcore, t_zq, t_plan, t_fp)}
AGGS = {"total": ("amount", "sum"), "n": ("amount", "count"),
        "hi": ("amount", "max")}


@pytest.fixture(autouse=True)
def cpu_kernels():
    with kdispatch.using_device("cpu"):
        yield


def star_files(core, zq, d, seed=0):
    rng = np.random.default_rng(seed)
    po, pc = str(d / "orders.zq"), str(d / "customers.zq")
    zq.write_table(po, core.Table.from_pydict({
        "cust": rng.integers(0, 440, 4000),
        "amount": rng.integers(0, 1_000_000, 4000)}))
    zq.write_table(pc, core.Table.from_pydict({
        "cust": np.arange(400, dtype=np.int64),
        "country": [f"nation{i % 25:02d}" for i in range(400)]}))
    return po, pc


def star_plans(plan, po, pc):
    cust = plan.scan(pc)
    return {"left": plan.scan(po).join(cust, on="cust", how="left")
            .group_by("country", AGGS),
            "filtered": plan.scan(po).filter(plan.col("amount") >= 500_000)
            .join(cust, on="cust", how="inner").group_by("country", AGGS)}


def cached_run(pkg, d, root, mode="thread"):
    core, zq, plan, fp = PKGS[pkg]
    fp.reset_caches()
    store = core.BufferStore(backing="file", root=root)
    rm = core.ResourceManager(store, core.RMConfig(
        cache_root=root, workers=2, workers_mode=mode))
    ex = core.make_executor(store, rm, workers=2)
    try:
        cp = plan.compile_plans(star_plans(plan, *star_files(core, zq, d)))
        ex.run([cp.dag])
        out = {s: cp.read(store, s).to_pydict() for s in cp.sinks}
        for s in cp.sinks:
            cp.dag.nodes[cp.sinks[s]].output.release()
        return {"out": out, "runs": ex.node_runs, "loads": ex.load_runs,
                "hits": ex.cache_hits,
                "status": sorted({st.status for st in
                                  cp.dag.nodes.values()}),
                "bytes_deanon": store.stats.bytes_deanon}
    finally:
        ex.close()
        store.close()


def test_cache_root_rerun_adopts_every_node(tmp_path):
    got = {}
    for pkg in PKGS:
        d = tmp_path / pkg
        d.mkdir()
        root = str(d / "cache")
        got[pkg] = (cached_run(pkg, d, root), cached_run(pkg, d, root))
        # a cold run's de-anonymized bytes depend on where the allocator
        # put its buffers (whole pages move): not compared across packages
        got[pkg][0].pop("bytes_deanon")
    assert got["repro_torch"] == got["repro"]
    cold, warm = got["repro"]
    assert cold["runs"] > 0 and cold["hits"] == 0
    assert warm["out"] == cold["out"]
    assert warm["status"] == ["cached"]
    assert (warm["runs"], warm["loads"], warm["bytes_deanon"]) == (0, 0, 0)
    assert warm["hits"] == cold["runs"]


def test_cache_root_rerun_adopts_across_modes(tmp_path):
    """A cache written by thread mode is adopted by a process-mode re-run
    (the Flight workers are never asked for anything)."""
    root = str(tmp_path / "cache")
    cold = cached_run("repro_torch", tmp_path, root)
    warm = cached_run("repro_torch", tmp_path, root, mode="process")
    assert warm["out"] == cold["out"] and warm["runs"] == 0
    assert warm["status"] == ["cached"]


def _fingerprints(d, device, sha=None):
    """{node name: fingerprint} of the compiled star plans on ``device``,
    with ``build.source_sha256`` overridden by ``sha`` where given."""
    t_fp.reset_caches()
    cp = t_plan.compile_plans(star_plans(t_plan, *star_files(tcore, t_zq,
                                                             d)))
    real = build.source_sha256
    try:
        if sha is not None:
            build.source_sha256 = lambda name: sha.get(name) or real(name)
        with kdispatch.using_device(device):
            fps = tcore.fingerprint_dag(cp.dag)
    finally:
        build.source_sha256 = real
    ops = {n: getattr(st.spec.fn, "func", st.spec.fn).__name__
           if st.spec.fn is not None else "load"
           for n, st in cp.dag.nodes.items()}
    return fps, ops


JOINS = ("join_node", "filter_join_exec")
GROUP_BYS = ("group_by_node",)


def _nodes(ops, kinds):
    return {n for n, op in ops.items() if op in kinds}


def test_device_flip_invalidates_exactly_the_relational_cones(tmp_path):
    cpu, ops = _fingerprints(tmp_path, "cpu")
    cuda, _ = _fingerprints(tmp_path, "cuda")
    assert all(v is not None for v in cpu.values())
    assert _nodes(ops, ("load",)) == {"scan_orders", "scan_customers"}
    changed = {n for n in cpu if cpu[n] != cuda[n]}
    # every join and group-by changes; the scans upstream keep theirs
    assert changed == _nodes(ops, JOINS + GROUP_BYS) == set(cpu) - \
        _nodes(ops, ("load",))


@pytest.mark.parametrize("source,kinds", [
    ("splitmix64", JOINS + GROUP_BYS),
    ("sentinel_gather", JOINS + GROUP_BYS),
    ("segreduce", GROUP_BYS),
])
def test_kernel_edit_invalidates_exactly_its_cones(tmp_path, source, kinds):
    """On ``cuda`` an edited source changes the ops that launch it and the
    group-bys downstream of them; on the CPU it changes nothing."""
    base, ops = _fingerprints(tmp_path, "cuda")
    edited, _ = _fingerprints(tmp_path, "cuda", {source: "0" * 64})
    assert {n for n in base if base[n] != edited[n]} == _nodes(ops, kinds)
    cpu, _ = _fingerprints(tmp_path, "cpu")
    cpu_edited, _ = _fingerprints(tmp_path, "cpu", {source: "0" * 64})
    assert cpu == cpu_edited


def test_source_sha256_is_the_file_hash():
    for name in ("splitmix64", "sentinel_gather", "segreduce"):
        data = (build.CSRC / f"{name}.cu").read_bytes()
        assert build.source_sha256(name) == hashlib.sha256(data).hexdigest()


def test_cpu_cache_misses_the_cuda_cones(tmp_path):
    """Outputs cached by a CPU run are not adopted for the relational
    nodes of a ``cuda`` run of the same plans: their fingerprints are not
    in the manifest, while every scan's is."""
    root = str(tmp_path / "cache")
    cached_run("repro_torch", tmp_path, root)
    cuda, ops = _fingerprints(tmp_path, "cuda")
    store = tcore.BufferStore(backing="file", root=root)
    try:
        hit = {n for n, f in cuda.items() if f in store.manifest}
    finally:
        store.close()
    assert hit == _nodes(ops, ("load",))
