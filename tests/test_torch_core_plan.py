"""The port's query frontend and streaming ingest against the JAX
package's, on the CPU.

The same plans explain to the same text and compile to DAGs whose
outputs, run through the thread executor, are bit-identical to the
reference package's numpy backend; ``IncrementalRecompute`` over the
same micro-batches gives the same snapshots and recomputes the same
cones.
"""

import numpy as np
import pytest

import repro.core as rcore
import repro_torch.core as tcore
from repro.core import fingerprint as r_fp
from repro.core import ops as r_ops
from repro.core import plan as r_plan
from repro.core import zarquet as r_zq
from repro_torch.core import fingerprint as t_fp
from repro_torch.core import kdispatch
from repro_torch.core import ops as t_ops
from repro_torch.core import plan as t_plan
from repro_torch.core.plan import compiler as t_compiler
from repro_torch.core import zarquet as t_zq

PKGS = {"repro": (rcore, r_ops, r_zq, r_plan, r_fp),
        "repro_torch": (tcore, t_ops, t_zq, t_plan, t_fp)}
AGGS = {"total": ("amount", "sum"), "lo": ("amount", "min"),
        "hi": ("amount", "max"), "n": ("amount", "count")}


@pytest.fixture(autouse=True)
def cpu_kernels():
    with kdispatch.using_device("cpu"):
        yield


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


def star_files(core, zq, d, n_orders=8000, n_cust=600, null_frac=0.0):
    rng = np.random.default_rng(3)
    validity = None
    if null_frac:
        validity = core.pack_validity(rng.random(n_orders) >= null_frac)
    orders = core.Table.from_pydict({
        "cust": core.Column.primitive(
            rng.integers(0, max(n_cust * 11 // 10, 1), n_orders),
            validity),
        "amount": rng.integers(0, 1_000_000, n_orders),
        "pad": rng.random(n_orders)})
    customers = core.Table.from_pydict({
        "cust": np.arange(n_cust, dtype=np.int64),
        "country": [f"nation{i % 25:02d}" for i in range(n_cust)],
        "segment": [f"seg{i % 5}" for i in range(n_cust)]})
    po, pc = str(d / "orders.zq"), str(d / "customers.zq")
    zq.write_table(po, orders)
    zq.write_table(pc, customers)
    return po, pc


def star_plans(plan, po, pc, dict_country=False):
    """The two star queries of the SF10 smoke run, and a pair of marts
    that share their staging join (pushdown, pruning, dedup, fusion)."""
    cdict = ("country",) if dict_country else ()
    cust = plan.scan(pc, dict_columns=cdict)
    staging = (plan.scan(po).filter(plan.col("amount") > 250_000)
               .join(cust, on="cust"))
    return {
        "left": plan.scan(po).join(cust, on="cust", how="left")
        .group_by("country", AGGS),
        "filtered": plan.scan(po).filter(plan.col("amount") >= 500_000)
        .join(cust, on="cust", how="inner").group_by("country", AGGS),
        "mart_country": staging.group_by(
            "country", {"revenue": ("amount", "sum"),
                        "n": ("amount", "count")}),
        "mart_segment": staging.group_by(
            "segment", {"revenue": ("amount", "max")}),
    }


def run_plans(pkg, d, optimize=True, workers=4, **star_kw):
    core, ops, zq, plan, fp = PKGS[pkg]
    dict_country = star_kw.pop("dict_country", False)
    po, pc = star_files(core, zq, d, **star_kw)
    plans = star_plans(plan, po, pc, dict_country)
    store = core.BufferStore(swap_dir=str(d / "swap"))
    rm = core.ResourceManager(store, core.RMConfig(workers=workers))
    ex = core.make_executor(store, rm, workers=workers)
    try:
        cp = plan.compile_plans(plans, optimize=optimize)
        ex.run([cp.dag])
        out = {s: table_buffers(cp.read(store, s)) for s in cp.sinks}
        explain = plan.explain_plans(plans).replace(str(d), "<dir>")
        return out, explain, len(cp.dag.nodes)
    finally:
        ex.close()
        store.close()


@pytest.mark.parametrize("optimize", [True, False])
@pytest.mark.parametrize("case", [
    dict(), dict(null_frac=0.2), dict(dict_country=True),
    dict(n_orders=0), dict(n_cust=0)])
def test_star_plans_match_reference(tmp_path, optimize, case):
    got = {}
    for pkg in PKGS:
        d = tmp_path / pkg
        d.mkdir()
        got[pkg] = run_plans(pkg, d, optimize=optimize, **dict(case))
    out, explain, n_nodes = got["repro"]
    assert got["repro_torch"][2] == n_nodes
    assert got["repro_torch"][1] == explain
    assert got["repro_torch"][0] == out


def test_fusion_rewrites_the_filtered_star_onto_filter_join(tmp_path):
    _, explain, _ = run_plans("repro_torch", tmp_path)
    assert "filter_join on=('cust',) how='inner' left_pred=(col('amount')" \
        " >= lit(500000))" in explain
    opt = t_plan.compile_plans(star_plans(
        t_plan, *star_files(tcore, t_zq, tmp_path)))
    fns = [getattr(st.spec.fn, "func", None) for st in
           opt.dag.nodes.values()]
    assert t_compiler.filter_join_exec in fns


def test_optimized_equals_naive(tmp_path):
    (tmp_path / "opt").mkdir()
    (tmp_path / "naive").mkdir()
    out_opt, _, n_opt = run_plans("repro_torch", tmp_path / "opt")
    out_naive, _, n_naive = run_plans("repro_torch", tmp_path / "naive",
                                      optimize=False)
    assert out_opt == out_naive
    assert n_opt < n_naive                 # dedup shares the scans


# --------------------------------------------------------------------------
# streaming ingest: IncrementalRecompute
# --------------------------------------------------------------------------

def _micro_batch(core, i, n=200):
    return core.Table.from_pydict({
        "k": (np.arange(n, dtype=np.int64) + i) % 7,
        "v": np.arange(n, dtype=np.int64) * (i + 1),
        "s": [f"t{(j + i) % 5}" for j in range(n)]})


def _group_ref(tables):
    """Per-row-group map stage through the reference's group_by."""
    return r_ops.group_by(tables[0], "k", {"n": ("v", "count"),
                                           "hi": ("v", "max"),
                                           "total": ("v", "sum")})


def _group_port(tables):
    """The same stage through the port's group_by (segreduce)."""
    return t_ops.group_by(tables[0], "k", {"n": ("v", "count"),
                                           "hi": ("v", "max"),
                                           "total": ("v", "sum")})


MAPS = {"repro": _group_ref, "repro_torch": _group_port}


def ingest_case(pkg, d):
    core, ops, zq, plan, fp = PKGS[pkg]
    path, root = str(d / "s.zq"), str(d / "cache")
    fp.reset_caches()
    w = zq.StreamWriter(path)
    store = core.BufferStore(backing="file", root=root)
    rm = core.ResourceManager(store, core.RMConfig(cache_root=root))
    ex = core.make_executor(store, rm)
    drv = core.IncrementalRecompute(path, store=store, rm=rm, executor=ex,
                                    map_fn=MAPS[pkg])
    seen = []
    try:
        for i in range(5):
            w.ingest(_micro_batch(core, i))
            w.flush()
            s = drv.refresh()
            with drv.snapshot() as (t, version):
                seen.append((s.groups, s.nodes_total, s.nodes_executed,
                             s.cache_hits, version, table_buffers(t)))
        return seen
    finally:
        w.close()
        drv.close()
        ex.close()
        store.close()


def test_incremental_recompute_matches_reference(tmp_path):
    got = {}
    for pkg in PKGS:
        (tmp_path / pkg).mkdir()
        got[pkg] = ingest_case(pkg, tmp_path / pkg)
    assert got["repro_torch"] == got["repro"]
    # after the first refresh each micro-batch recomputes its own cone:
    # load + map of the new group, and the reduce
    assert [s[2] for s in got["repro"]] == [3, 3, 3, 3, 3]
