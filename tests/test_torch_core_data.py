"""The port's Zerrow data plane against the JAX package's, on the CPU.

BufferStore charging and swap, KernelZero's ownership transfer, SIPC's
reference passing with resharing and dictionary sharing, and the DeCache
run the same scenario from the same numpy inputs through ``repro.core``
and ``repro_torch.core``; every observable (store counters, cgroup
charges, message sizes, output buffers) must be equal, buffers bit for
bit.  Read-only columns, which is what the store hands out, must reach
the port's ``kdispatch`` with no host copy.
"""

import numpy as np
import pytest
import torch

import repro.core as rcore
import repro_torch.core as tcore
from repro.core import ops as r_ops
from repro.core import vkernels
from repro.core import zarquet as r_zq
from repro_torch.core import kdispatch
from repro_torch.core import ops as t_ops
from repro_torch.core import zarquet as t_zq
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref

PKGS = {"repro": (rcore, r_ops, r_zq), "repro_torch": (tcore, t_ops, t_zq)}


@pytest.fixture(autouse=True)
def cpu_kernels():
    """The port's relational kernels on the CPU (their plain versions)
    for this test only: the device is process-wide state."""
    with kdispatch.using_device("cpu"):
        yield


def same(a, b, where="") -> None:
    """Equal observables; numpy arrays by dtype, shape and bits."""
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), where
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


def column_buffers(c) -> list:
    """A column's type and raw buffers (values, offsets, validity, then
    its dictionary's), as bytes."""
    out = [str(c.type)]
    for name in ("values", "offsets", "validity"):
        buf = getattr(c, name)
        out.append(None if buf is None else
                   np.ascontiguousarray(buf).view(np.uint8).copy())
    if c.dictionary is not None:
        out.append(column_buffers(c.dictionary))
    return out


def table_buffers(t) -> list:
    """Every column's raw buffers, batch by batch."""
    return [(f.name, column_buffers(c)) for b in t.batches
            for f, c in zip(b.schema.fields, b.columns)]


#: what de-anonymizing a buffer that is not page-aligned costs depends on
#: where the allocator put it: the pages it spans are moved, its partial
#: head and tail pages copied (the buffer cases align theirs and compare
#: these too)
ADDRESS_DEPENDENT = ("bytes_copied", "partial_page_bytes", "bytes_deanon")


def stable_stats(store) -> dict:
    return {k: v for k, v in store.stats.snapshot().items()
            if k not in ADDRESS_DEPENDENT}


def in_both(scenario, tmp_path, *args):
    """Run ``scenario(core, ops, zarquet, tmp_dir, *args)`` in each package
    and hold the port's observables to the reference's."""
    got = {}
    for name, (core, ops, zq) in PKGS.items():
        d = tmp_path / name
        d.mkdir()
        got[name] = scenario(core, ops, zq, d, *args)
    same(got["repro_torch"], got["repro"], scenario.__name__)
    return got["repro"]


# --------------------------------------------------------------------------
# BufferStore and KernelZero
# --------------------------------------------------------------------------

def buffer_case(core, ops, zq, d, case):
    PAGE = core.PAGE
    store = core.BufferStore(swap_dir=str(d / "swap"),
                             system_limit=PAGE * 8
                             if case in ("oom", "kswap") else None)
    try:
        if case == "oom":
            store.kswap_enabled = False
        kz = core.KernelZero(store)
        cg = store.new_cgroup("sb", limit=PAGE * 8
                              if case == "cgroup_reclaim" else None)
        obs = {}
        if case in ("deanon_aligned", "writer_copy", "partial_pages"):
            f = kz.new_file(cg)
            base = core.alloc_aligned(8 * PAGE)
            base[:] = np.random.default_rng(0).integers(0, 256, base.size,
                                                        dtype=np.uint8)
            src = base[100:100 + 2 * PAGE] if case == "partial_pages" \
                else base
            how = kz.writer_copy if case == "writer_copy" else kz.deanon
            off, n = how(f, src)
            view = f.read(off, n)
            obs.update(off=off, n=n, data=view.copy(),
                       shares=bool(np.shares_memory(view, src)),
                       frozen=not src.flags.writeable)
        elif case == "charge_transfer":
            files = store.new_cgroup("files")
            region = core.AnonRegion(core.alloc_aligned(PAGE * 4), cg)
            obs["before"] = cg.charged
            kz.deanon(kz.new_file(files), region)
            obs.update(sb=cg.charged, files=files.charged,
                       glob=store.global_charged)
        elif case == "swap_roundtrip":
            f = kz.new_file(cg)
            src = core.alloc_aligned(PAGE * 16)
            src[:] = np.random.default_rng(1).integers(0, 255, PAGE * 16,
                                                       dtype=np.uint8)
            off, n = kz.deanon(f, src)
            obs["swapped"] = store.swap_out_file(f.file_id)
            obs.update(charged=cg.charged, swap=cg.swap_charged)
            obs["data"] = f.read(off, n).copy()
            obs["after"] = cg.charged
        elif case in ("direct_swap", "indirect_swap"):
            arr = core.alloc_aligned(PAGE * 8)
            arr[:] = 7
            region = core.AnonRegion(arr, cg)
            region.swap_out(store)
            f = kz.new_file(cg)
            off, n = kz.deanon(f, region,
                               direct_swap=case == "direct_swap")
            obs["data"] = f.read(off, n).copy()
        elif case in ("cgroup_reclaim", "kswap", "oom"):
            f = kz.new_file(cg)
            try:
                for i in range(4):
                    a = core.alloc_aligned(PAGE * 4)
                    a[:] = i
                    kz.deanon(f, a)
                obs["oom"] = False
            except core.OOMError:
                obs["oom"] = True
            obs["charged"] = cg.charged
        elif case == "delete":
            f = kz.new_file(cg)
            kz.deanon(f, core.alloc_aligned(PAGE * 4))
            obs["charged"] = cg.charged
            store.delete_file(f.file_id)
            obs["after"] = cg.charged
        obs["stats"] = store.stats.snapshot()
        return obs
    finally:
        store.close()


BUFFER_CASES = ("deanon_aligned", "partial_pages", "writer_copy",
                "charge_transfer", "swap_roundtrip", "direct_swap",
                "indirect_swap", "cgroup_reclaim", "kswap", "oom", "delete")


@pytest.mark.parametrize("case", BUFFER_CASES)
def test_buffer_store_matches_reference(tmp_path, case):
    obs = in_both(buffer_case, tmp_path, case)
    if case == "deanon_aligned":                  # the paper's zero copy
        assert obs["shares"] and obs["frozen"]
        assert obs["stats"]["bytes_copied"] == 0
    if case == "oom":
        assert obs["oom"]


# --------------------------------------------------------------------------
# SIPC: reference passing, resharing, dictionary sharing
# --------------------------------------------------------------------------

def _every_other(x):
    mask = np.zeros(x.num_rows, dtype=bool)
    mask[::2] = True
    return mask


SIPC_NODES = {
    "identity": lambda ops, x: x,
    "drop_columns": lambda ops, x: ops.drop_columns(x, ["i0"]),
    "slice_rows": lambda ops, x: ops.slice_rows(x, 5, 100),
    "add_column": lambda ops, x: ops.add_column(
        x, "new", np.arange(x.num_rows, dtype=np.int64)),
    "concat": lambda ops, x: ops.concat_tables([x, x]),
    "filter_dict": lambda ops, x: ops.filter_rows(x, _every_other(x)),
    "upper": lambda ops, x: ops.upper(x, "s0"),
    "join_group_by": lambda ops, x: ops.group_by(
        ops.join(x, x, on="i0", how="inner"), "s0",
        {"n": ("i1", "count"), "hi": ("i1", "max")}),
}


def sipc_case(core, ops, zq, d, node, mode):
    store = core.BufferStore(swap_dir=str(d / "swap"))
    try:
        kz = core.KernelZero(store)
        cg = store.new_cgroup("sb")
        rng = np.random.default_rng(3)
        n = 1 << 12
        t = core.Table.from_pydict({
            "i0": rng.integers(0, 64, n), "i1": rng.integers(-9, 9, n),
            "s0": [f"w{int(v)}" for v in rng.integers(0, 20, n)]})
        if node == "filter_dict":
            t = ops.dict_encode(t, ["s0"])
        msg = core.SipcWriter(store, kz, cg, mode=mode).write_table(t)
        inp = core.SipcReader(store, mode=mode).read_table(msg)
        obs = {"in": table_buffers(inp), "wire": msg.wire_nbytes}
        reader = core.SipcReader(store, mode=mode)
        x = reader.read_table(msg)
        out = core.SipcWriter(store, kz, store.new_cgroup("out"), mode=mode,
                              input_map=reader.map).write_table(
            SIPC_NODES[node](ops, x))
        back = core.SipcReader(store, mode=mode).read_table(out)
        obs.update(new=out.new_bytes, reshared=out.reshared_bytes,
                   out=table_buffers(back), files=len(out.files_referenced()),
                   stats=stable_stats(store))
        msg.release()
        out.release()
        return obs
    finally:
        store.close()


@pytest.mark.parametrize("mode", ["zero", "writer_copy"])
@pytest.mark.parametrize("node", sorted(SIPC_NODES))
def test_sipc_matches_reference(tmp_path, node, mode):
    obs = in_both(sipc_case, tmp_path, node, mode)
    if mode == "zero" and node in ("drop_columns", "slice_rows", "concat"):
        assert obs["new"] == 0 and obs["reshared"] > 0
    if mode == "zero" and node == "filter_dict":
        assert obs["reshared"] > 0                 # the dictionary


# --------------------------------------------------------------------------
# DeCache: one load shared by many DAGs
# --------------------------------------------------------------------------

def _sum_node(ts):
    t = ts[0].combine().batches[0]
    return type(ts[0]).from_pydict(
        {"total": np.array([int(t.column("i0").values.sum())],
                           dtype=np.int64)})


def decache_case(core, ops, zq, d, enabled):
    path = str(d / "t.zq")
    zq.write_table(path, zq.gen_int_table(4, 1 << 14, seed=7))
    store = core.BufferStore(swap_dir=str(d / "swap"))
    rm = core.ResourceManager(store, core.RMConfig(decache=enabled))
    ex = core.Executor(store, rm)
    try:
        dags = [core.DAG([
            core.NodeSpec("load", source=path, est_mem=1 << 16),
            core.NodeSpec("sum", fn=_sum_node, deps=["load"],
                          est_mem=1 << 12, keep_output=True)],
            name=f"d{i}") for i in range(5)]
        ex.run(dags)
        outs = [table_buffers(core.SipcReader(store).read_table(
            g.nodes["sum"].output)) for g in dags]
        return {"load_runs": ex.load_runs, "hits": rm.decache.hits,
                "outs": outs, "stats": stable_stats(store)}
    finally:
        ex.close()
        store.close()


@pytest.mark.parametrize("enabled", [True, False])
def test_decache_matches_reference(tmp_path, enabled):
    obs = in_both(decache_case, tmp_path, enabled)
    assert obs["load_runs"] == (1 if enabled else 5)


# --------------------------------------------------------------------------
# read-only arrays reach kdispatch with no host copy
# --------------------------------------------------------------------------

def _read_only(a: np.ndarray) -> np.ndarray:
    a = np.array(a)
    a.flags.writeable = False
    return a


def _host_view(t: torch.Tensor) -> np.ndarray:
    if t.dtype in (torch.uint16, torch.uint32, torch.uint64):
        t = t.view(ref.SIGNED[t.element_size()])
    return t.numpy()


@pytest.fixture()
def seen(monkeypatch):
    """The CPU tensors each kernel wrapper is handed, by wrapper."""
    got = {}
    for name in ("hash_fixed", "combine_hashes", "filter_join_gather",
                 "gather_payload", "grouped_reduce"):
        wrapped = getattr(kops, name)

        def spy(*args, _w=wrapped, _n=name, **kw):
            got.setdefault(_n, []).extend(
                a for a in args if isinstance(a, torch.Tensor))
            return _w(*args, **kw)
        monkeypatch.setattr(kops, name, spy)
    return got


def _shared(arrays, tensors) -> bool:
    """Every array shares memory with a tensor handed to the kernel."""
    views = [_host_view(t) for t in tensors]
    return all(any(np.shares_memory(a, v) for v in views) for a in arrays)


def _inputs(n=4096, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "i64": rng.integers(-(1 << 62), 1 << 62, n, dtype=np.int64),
        "u64": rng.integers(0, 1 << 64, n, dtype=np.uint64),
        "i32": rng.integers(-50, 50, n).astype(np.int32),
        "u32": rng.integers(0, 1 << 32, n, dtype=np.uint64)
        .astype(np.uint32),
        "b": rng.random(n) < 0.5,
        "codes": rng.integers(0, 97, n),
        "valid": rng.random(n) < 0.8,
        "sel": np.nonzero(rng.random(n // 2) < 0.5)[0].astype(np.int64),
        "pidx": rng.integers(-1, n, n).astype(np.int64),
    }


@pytest.mark.parametrize("col", ["i64", "u64", "i32", "u32", "b"])
def test_read_only_hash_fixed_no_copy(seen, col):
    x = _read_only(_inputs()[col])
    before = x.copy()
    got = kdispatch.hash_fixed(x)
    same(got, vkernels.hash_fixed(before))
    same(x, before)
    assert _shared([x], seen["hash_fixed"])


@pytest.mark.parametrize("ncols", [1, 2])
def test_read_only_combine_and_hash_keys_no_copy(seen, ncols):
    """One column crosses as a view of its own bits (the star query's
    one-key join); several are stacked into the (ncols, n) matrix the
    fold takes, which is the one copy these entries make."""
    inp = _inputs()
    n = len(inp["i64"])
    names = ("i64", "u64")[:ncols]
    hs = [_read_only(vkernels.hash_fixed(inp[c])) for c in names]
    same(kdispatch.combine_hashes(hs, n),
         vkernels.combine_hashes([h.copy() for h in hs], n))
    keys = [_read_only(inp[c]) for c in names]
    same(kdispatch.hash_keys(keys, n),
         vkernels.hash_keys([k.copy() for k in keys], n))
    for k, c in zip(keys, names):
        same(k, inp[c])
    assert "hash_fixed" not in seen            # hash_keys is one fused fold
    assert _shared(hs + keys, seen["combine_hashes"]) == (ncols == 1)


def test_read_only_gathers_no_copy(seen):
    inp = _inputs()
    sel, idx = _read_only(inp["sel"]), _read_only(
        np.random.default_rng(1).integers(-1, len(inp["sel"]), 4096))
    same(kdispatch.filter_join_gather(sel, idx),
         vkernels.filter_join_gather(sel.copy(), idx.copy()))
    assert _shared([sel, idx], seen["filter_join_gather"])
    vals, pidx = _read_only(inp["i64"]), _read_only(inp["pidx"])
    want = np.where(pidx >= 0, vals[np.where(pidx >= 0, pidx, 0)], 0)
    same(kdispatch.gather_payload(vals, pidx, 0), want)
    assert _shared([vals, pidx], seen["gather_payload"])
    same(vals, inp["i64"])
    same(pidx, inp["pidx"])


@pytest.mark.parametrize("col", ["i64", "u64", "i32", "b"])
def test_read_only_grouped_reduce_no_copy(seen, col):
    inp = _inputs()
    order, starts = vkernels.group_ranges([inp["codes"]])
    vals, order, starts = (_read_only(a) for a in (inp[col], order, starts))
    valid = _read_only(inp["valid"])
    hows = ["count", "sum", "min", "max"]
    got = kdispatch.grouped_reduce(vals, order, starts, valid, hows)
    for h in hows:
        same(got[h], vkernels.GROUPED_REDUCERS[h](
            vals.copy(), order.copy(), starts.copy(), valid.copy()), h)
    same(vals, inp[col])
    assert _shared([vals, order, starts, valid], seen["grouped_reduce"])


def test_store_mapped_columns_reach_kdispatch_without_copy(tmp_path, seen):
    """A column de-anonymized into the store and read back through SIPC is
    read-only; hashing it hands the kernel wrapper the store's memory."""
    store = tcore.BufferStore(swap_dir=str(tmp_path / "swap"))
    try:
        kz = tcore.KernelZero(store)
        vals = np.random.default_rng(5).integers(0, 1 << 40, 1 << 14)
        msg = tcore.SipcWriter(store, kz, store.new_cgroup("sb")) \
            .write_table(tcore.Table.from_pydict({"k": vals}))
        col = tcore.SipcReader(store).read_table(msg) \
            .combine().batches[0].column("k").values
        assert not col.flags.writeable
        copied = store.stats.bytes_copied
        same(kdispatch.hash_fixed(col), vkernels.hash_fixed(vals))
        assert _shared([col], seen["hash_fixed"])
        assert store.stats.bytes_copied == copied
        msg.release()
    finally:
        store.close()


def test_edge_bytes_count_only_card_copies():
    kdispatch.reset_edge_bytes()
    kdispatch.hash_fixed(_inputs()["i64"])
    assert kdispatch.edge_bytes == {"to_device": 0, "from_device": 0}
