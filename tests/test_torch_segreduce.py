"""The fused segment reductions on the CPU, held bit for bit to the JAX
package.

* ``kops.grouped_reduce`` (every aggregate of a column in one call) gives
  ``repro.core.vkernels.grouped_*``'s bits for every subset of count, sum,
  min and max, every integer dtype and bool, with and without nulls, at G
  = 1, 26, 32, 33, 254, 255, 256 (both sides of the few-groups path's
  limit in ``csrc/segreduce.cu`` and of the 255 groups a byte map could
  name) and many groups, with
  wrapping int64 and uint64 sums and an all-null group.
* The port's ``group_by`` with several aggregates over one column and
  aggregates over two columns (one float, which stays on ``vkernels``)
  gives ``repro.core.ops.group_by``'s buffers, and makes one
  ``kdispatch.grouped_reduce`` call per column.
* ``kernel_twin`` repeats the few-groups path of ``csrc/segreduce.cu`` in
  plain PyTorch, which the kernel cannot do here: pass one's byte map
  map[order[p]] = g (tile by tile, 0xFF for a row no position names);
  pass two's split of the rows over a persistent grid; the slots
  [group][thread] in each block and their combine (each lane folds 8
  threads' slots, then a butterfly over the warp's lanes); the words in
  compare space (uint64 extremes
  with the sign bit flipped) and the sentinels the outputs start from; one
  commit per (block, group, op).  The twin is held to ``vkernels`` on the
  same cases, and raises its flag on an ``order`` that is no permutation.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import arrow as jarrow, ops as jops, vkernels as jvk  # noqa
from repro_torch.core import arrow as tarrow, kdispatch as kd  # noqa: E402
from repro_torch.core import ops as tops  # noqa: E402
from repro_torch.kernels import ops as kops, relational  # noqa: E402

INTS = [np.int8, np.int16, np.int32, np.int64, np.uint8, np.uint16,
        np.uint32, np.uint64, np.bool_]
HOWS = ("count", "sum", "min", "max")
SUBSETS = [s for r in range(1, 5) for s in itertools.combinations(HOWS, r)]
# both sides of the private (32) and few-groups (255) thresholds, and many
GROUPS = [1, 26, 32, 33, 254, 255, 256, 4000]
CPU = torch.device("cpu")


@pytest.fixture
def on_cpu():
    with kd.using_device("cpu"):
        yield


def values_of(rng, n, dtype):
    dt = np.dtype(dtype)
    if dt.kind == "b":
        return rng.random(n) < 0.5
    return rng.integers(0, 256, n * dt.itemsize, dtype=np.uint8).view(dt)


def segments(rng, n, G):
    """(order, starts) of ``group_ranges`` over codes that use all G
    groups (G <= n), or about G of them where G is the many-groups case."""
    if G > 256:
        codes = rng.integers(0, G, n)
    else:
        codes = np.concatenate([np.arange(G), rng.integers(0, G, n - G)])
        rng.shuffle(codes)
    return jvk.group_ranges([codes])


def case(seed, dtype, G, nulls, n=3000):
    """values, order, starts and valid, with an all-null group (group 0
    where there are nulls) and, for int64 and uint64, a group whose sum
    wraps."""
    rng = np.random.default_rng(seed)
    order, starts = segments(rng, n, G)
    v = values_of(rng, n, dtype)
    valid = None
    if nulls:
        valid = rng.random(n) < 0.6
        end = starts[1] if len(starts) > 1 else n
        valid[order[starts[0]:end]] = False
    if dtype in (np.int64, np.uint64):
        last = order[starts[-1]:]
        v[last] = np.array((1 << 62) + 1 if dtype == np.int64
                           else (1 << 64) - 3, dtype)
    return v, order, starts, valid


def tensor(a):
    return None if a is None else kd._to_tensor(np.asarray(a), CPU)


def same(got, want):
    """Same dtype, shape and bits."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def numpy_of(t: torch.Tensor, how: str, dtype) -> np.ndarray:
    if how in ("count", "sum"):
        dt = np.uint64 if how == "sum" and dtype == np.uint64 else np.int64
    else:
        dt = np.uint8 if dtype == np.bool_ else dtype
    return kd._to_numpy(t, dt)


def check_against_vkernels(got, counts, hows, v, order, starts, valid):
    """{how: tensor} and counts against ``vkernels.grouped_*``, bit for
    bit."""
    for how in hows:
        want, want_counts = jvk.GROUPED_REDUCERS[how](v, order, starts, valid)
        same(numpy_of(got[how], how, v.dtype.type), want)
        same(kd._to_numpy(counts, np.int64), want_counts)


# --------------------------------------------------------------------------
# kops.grouped_reduce vs repro.core.vkernels
# --------------------------------------------------------------------------

@pytest.mark.parametrize("nulls", [False, True], ids=["valid", "nulls"])
@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("dtype", INTS, ids=lambda d: np.dtype(d).name)
def test_grouped_reduce_matches_vkernels(dtype, G, nulls):
    v, order, starts, valid = case(G * 13 + nulls, dtype, G, nulls,
                                   n=6000 if G > 256 else 3000)
    if G <= 256:
        assert len(starts) == G
    args = (tensor(v), tensor(order), tensor(starts), tensor(valid))
    for hows in SUBSETS:
        got, counts = kops.grouped_reduce(*args, hows)
        assert list(got) == list(hows)
        check_against_vkernels(got, counts, hows, v, order, starts, valid)


def test_grouped_reduce_wraps_and_keeps_sentinels():
    """The wrapping int64 and uint64 sums and an all-null group's
    sentinels, with the expected values written out."""
    order, starts = torch.arange(5), torch.tensor([0, 2])
    u = torch.tensor([2 ** 64 - 1, 2, 2 ** 63, 2 ** 63, 5],
                     dtype=torch.uint64)
    got, counts = kops.grouped_reduce(u, order, starts, None, HOWS)
    assert got["sum"].view(torch.int64).tolist() == [1, 5]
    assert counts.tolist() == [2, 3]
    i = torch.tensor([(1 << 62) + 1] * 4 + [-5])
    got, _ = kops.grouped_reduce(i, order, torch.tensor([0]), None, ("sum",))
    assert got["sum"].tolist() == [-1]     # 4 (2^62 + 1) wraps to 4; less 5
    valid = torch.tensor([False, False, True, True, True])
    # group 0 is all null: the type's max for min, its min for max (bits
    # read as signed words of the output's width)
    for dtype, lo, hi in ((torch.int8, 127, -128), (torch.uint64, -1, 0),
                          (torch.bool, -1, 0)):
        v = torch.ones(5, dtype=dtype)
        got, counts = kops.grouped_reduce(v, order, starts, valid, HOWS)
        assert counts.tolist() == [0, 3]
        w = kops.ref.SIGNED[got["min"].element_size()]
        assert got["min"].view(w).tolist() == [lo, 1]
        assert got["max"].view(w).tolist() == [hi, 1]


def test_grouped_reduce_count_alone_reads_no_row():
    """A count with no validity mask takes only starts and n; order is
    refused as missing anywhere else."""
    starts = torch.tensor([0, 4, 9])
    got, counts = kops.grouped_reduce(None, None, starts, None, ("count",),
                                      n=10)
    assert counts.tolist() == [4, 5, 1] and got["count"] is counts
    with pytest.raises(ValueError):
        kops.grouped_reduce(torch.arange(10), None, starts, None,
                            ("count", "sum"), n=10)
    with pytest.raises(ValueError):
        kops.grouped_reduce(None, None, starts,
                            torch.ones(10, dtype=torch.bool), ("count",),
                            n=10)
    with pytest.raises(ValueError):
        kops.grouped_reduce(torch.arange(10), torch.arange(10), starts, None,
                            ("sum", "mean"))


def test_grouped_reduce_keeps_the_reference_on_a_duplicated_order():
    """On the CPU an order that names a row twice gives what vkernels
    gives (the reference does not check it); the card's few-groups path
    raises instead (tests/test_torch_gpu.py)."""
    rng = np.random.default_rng(3)
    v = rng.integers(-50, 50, 100)
    order = np.arange(100)
    order[7] = 8
    starts = np.array([0, 30, 64])
    got, counts = kops.grouped_reduce(tensor(v), tensor(order),
                                      tensor(starts), None, HOWS)
    check_against_vkernels(got, counts, HOWS, v, order, starts, None)


# --------------------------------------------------------------------------
# kdispatch.grouped_reduce and group_by vs repro.core
# --------------------------------------------------------------------------

def test_kdispatch_grouped_reduce_splits_by_registry(on_cpu, monkeypatch):
    """Admitted aggregates go to the kernel in one call, the rest to
    vkernels; a count alone with no validity sends no order."""
    calls = []
    real = kops.grouped_reduce

    def spy(values, order, starts, valid, hows, **kw):
        calls.append((values is None, order is None, tuple(hows)))
        return real(values, order, starts, valid, hows, **kw)
    monkeypatch.setattr(kops, "grouped_reduce", spy)
    rng = np.random.default_rng(4)
    order, starts = segments(rng, 500, 9)
    valid = rng.random(500) < 0.7
    f = rng.standard_normal(500)
    i = rng.integers(-9, 9, 500).astype(np.int32)
    hows = ["mean", "max", "count", "sum", "min", "count"]
    for v, m in ((f, valid), (i, valid), (i, None)):
        got = kd.grouped_reduce(v, order, starts, m, hows)
        assert list(got) == ["mean", "max", "count", "sum", "min"]
        for how, pair in got.items():
            want = jvk.GROUPED_REDUCERS[how](v, order, starts, m)
            same(pair[0], want[0])
            same(pair[1], want[1])
    kd.grouped_reduce(i, order, starts, None, ["count"])
    assert calls == [(True, False, ("count",)),
                     (False, False, ("max", "count", "sum", "min")),
                     (False, False, ("max", "count", "sum", "min")),
                     (True, True, ("count",))]


def table_pair(cols, validity=None):
    """The same table in the JAX package and in the port."""
    validity = validity or {}
    return tuple(arrow.Table.from_pydict({
        k: arrow.Column.primitive(v, validity=validity.get(k))
        for k, v in cols.items()}) for arrow in (jarrow, tarrow))


def raw_table(t):
    b = t.combine().batches[0]
    return [(f.name, c.type.to_json(), c.values.dtype.str, c.values.tobytes(),
             None if c.validity is None else c.validity.tobytes())
            for f, c in zip(b.schema.fields, b.columns)]


GROUP_BY_AGGS = {
    "n": ("amount", "count"), "total": ("amount", "sum"),
    "lo": ("amount", "min"), "hi": ("amount", "max"),
    "f_hi": ("price", "max"), "f_n": ("price", "count"),
    "f_tot": ("price", "sum"), "again": ("amount", "sum"),
    "f_avg": ("price", "mean")}


@pytest.mark.parametrize("amount", [np.int64, np.uint64, np.int16, np.bool_],
                         ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("n_keys", [1, 26, 300])
def test_group_by_matches_reference_with_fused_aggregates(on_cpu, amount,
                                                          n_keys,
                                                          monkeypatch):
    """Several aggregates over one column and some over a float column:
    the same buffers as repro.core.ops.group_by, and one
    kdispatch.grouped_reduce call per column."""
    rng = np.random.default_rng(n_keys)
    n = 2000
    cols = {"k": rng.integers(0, n_keys, n),
            "amount": values_of(rng, n, amount),
            "price": rng.standard_normal(n)}
    validity = {"amount": np.packbits(rng.random(n) < 0.8,
                                      bitorder="little"),
                "price": np.packbits(rng.random(n) < 0.9,
                                     bitorder="little")}
    jt, tt = table_pair(cols, validity)
    aggs = dict(GROUP_BY_AGGS)
    if amount == np.bool_:
        aggs = {k: v for k, v in aggs.items() if v != ("amount", "sum")}
    calls = []
    real = kd.grouped_reduce

    def counting(values, order, starts, valid, hows):
        calls.append(list(hows))
        return real(values, order, starts, valid, hows)
    monkeypatch.setattr(kd, "grouped_reduce", counting)
    got = tops.group_by(tt, "k", aggs)
    assert raw_table(got) == raw_table(jops.group_by(jt, "k", aggs))
    assert [f.name for f in got.schema.fields] == ["k", *aggs]
    by_col = {}
    for col, how in aggs.values():
        by_col.setdefault(col, []).append(how)
    assert calls == list(by_col.values())


def test_star_group_by_makes_one_call(on_cpu, monkeypatch):
    """The star query's four aggregates over `amount`: one call."""
    rng = np.random.default_rng(8)
    jt, tt = table_pair({"country": rng.integers(0, 25, 3000),
                         "amount": rng.integers(0, 1_000_000, 3000)})
    aggs = {"total": ("amount", "sum"), "lo": ("amount", "min"),
            "hi": ("amount", "max"), "n": ("amount", "count")}
    calls = []
    real = kd.grouped_reduce
    monkeypatch.setattr(kd, "grouped_reduce", lambda *a: calls.append(a[4])
                        or real(*a))
    assert raw_table(tops.group_by(tt, "country", aggs)) == \
        raw_table(jops.group_by(jt, "country", aggs))
    assert calls == [["sum", "min", "max", "count"]]


# --------------------------------------------------------------------------
# a plain twin of the few-groups path of csrc/segreduce.cu
# --------------------------------------------------------------------------

NT, PRIVATE_MAX, MAP_ITEMS, PRIVATE_ITEMS = 256, 32, 8, 16
SKIP, UNWRITTEN = 0xFFFF, 0xFF
BIG, SMALL = (1 << 63) - 1, -(1 << 63)


def extend(values: np.ndarray) -> torch.Tensor:
    """``extend<W>``: the raw bits zero-extended to 64, then, for a signed
    type narrower than 8 bytes, shifted up and arithmetically back."""
    w = values.dtype.itemsize
    x = torch.from_numpy(values.view(f"i{w}").astype(np.int64))
    if w < 8:
        x = x & ((1 << 8 * w) - 1)
        if values.dtype.kind == "i":
            x = (x << 64 - 8 * w) >> 64 - 8 * w
    return x


def sentinels(values: np.ndarray):
    """mn0, mx0 of the C entry: an all-null group's min and max words."""
    w, signed = values.dtype.itemsize, values.dtype.kind == "i"
    if w == 8:
        return (BIG, SMALL) if signed else (-1, 0)
    if signed:
        return (1 << 8 * w - 1) - 1, -(1 << 8 * w - 1)
    return (1 << 8 * w) - 1, 0


def find_group(starts: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return torch.searchsorted(starts, p, right=True) - 1


def byte_map(order: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """Pass one: tiles of NT * MAP_ITEMS sorted positions; a tile whose
    first and last positions share a group writes it without a search."""
    n, tile = order.numel(), NT * MAP_ITEMS
    p = torch.arange(n)
    t0 = p // tile * tile
    g0 = find_group(starts, t0)
    g1 = find_group(starts, torch.clamp(t0 + tile, max=n) - 1)
    m = torch.full((n,), UNWRITTEN, dtype=torch.int64)
    m[order] = torch.where(g0 == g1, g0, find_group(starts, p))
    return m


def atomic(op, a, b, flip):
    """atomicMin / atomicMax on the output words: unsigned for uint64
    (flip set)."""
    return op(a ^ flip, b ^ flip) ^ flip


def commit(out, c, s, lo, hi, flip):
    """One block's results (G each) into the outputs, where its count is
    not 0: sums wrap, extremes leave compare space (flip undone)."""
    g = (c > 0).nonzero().flatten()
    out["cnt"][g] += c[g]
    out["sum"][g] += s[g]
    out["mn"][g] = atomic(torch.minimum, out["mn"][g], lo[g] ^ flip, flip)
    out["mx"][g] = atomic(torch.maximum, out["mx"][g], hi[g] ^ flip, flip)


def fold(n_slots, index, x, keep, flip):
    """Rows folded into slots: count, wrapping sum, min and max of the
    compare words x ^ flip."""
    i, xs = index[keep], x[keep]
    cnt = torch.zeros(n_slots, dtype=torch.int64).index_add_(
        0, i, torch.ones_like(i))
    s = torch.zeros(n_slots, dtype=torch.int64).index_add_(0, i, xs)
    lo = torch.full((n_slots,), BIG).scatter_reduce_(0, i, xs ^ flip, "amin")
    hi = torch.full((n_slots,), SMALL).scatter_reduce_(0, i, xs ^ flip,
                                                       "amax")
    return cnt, s, lo, hi


def butterfly(v, op):
    """The xor-shuffle reduction over the last axis of 32 lanes: every
    lane ends with the whole warp's value."""
    lane = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        v = op(v, v[..., lane ^ off])
    return v


def kernel_twin(values, order, starts, valid, blocks=3):
    """What the few-groups path computes, step by step: (cnt, sum, mn, mx
    words of G each, bad flag)."""
    n, G = order.numel(), starts.numel()
    assert G <= PRIVATE_MAX
    m = byte_map(order, starts)
    bad = bool((m == UNWRITTEN).any())
    ok = torch.ones(n, dtype=torch.bool) if valid is None else valid
    key = torch.where(ok & (m != UNWRITTEN), m, SKIP)
    x = extend(values)
    flip = SMALL if values.dtype == np.uint64 else 0
    mn0, mx0 = sentinels(values)
    out = {"cnt": torch.zeros(G, dtype=torch.int64),
           "sum": torch.zeros(G, dtype=torch.int64),
           "mn": torch.full((G,), mn0), "mx": torch.full((G,), mx0)}
    i = torch.arange(n)
    keep = key != SKIP
    k = torch.where(keep, key, 0)
    # block b takes chunks b, b + blocks, ...; thread t row i % NT
    block = i // (NT * PRIVATE_ITEMS) % blocks
    slot = (block * G + k) * NT + i % NT           # [block][g][t]
    c, s, lo, hi = (a.view(blocks, G, NT // 32, 32)
                    for a in fold(blocks * G * NT, slot, x, keep, flip))
    # lane l folds threads l, l + 32, ...; then the butterfly
    c, s = butterfly(c.sum(2), torch.add), butterfly(s.sum(2), torch.add)
    lo = butterfly(lo.amin(2), torch.minimum)
    hi = butterfly(hi.amax(2), torch.maximum)
    for b in range(blocks):
        commit(out, c[b, :, 0], s[b, :, 0], lo[b, :, 0], hi[b, :, 0], flip)
    return out, bad


def twin_results(v, order, starts, valid):
    out, bad = kernel_twin(v, tensor(order), tensor(starts), tensor(valid))
    assert not bad
    words = {"count": out["cnt"], "sum": out["sum"], "min": out["mn"],
             "max": out["mx"]}
    tv = tensor(v)
    res = {"count": out["cnt"],
           "sum": out["sum"].view(torch.uint64) if v.dtype == np.uint64
           else out["sum"]}
    for how in ("min", "max"):
        res[how] = kops._narrow(words[how], kops._extreme_dtype(tv))
    return res, out["cnt"]


@pytest.mark.parametrize("nulls", [False, True], ids=["valid", "nulls"])
@pytest.mark.parametrize("G", [1, 2, 7, 17, 26, 31, 32])
@pytest.mark.parametrize("dtype", INTS, ids=lambda d: np.dtype(d).name)
def test_kernel_twin_matches_vkernels(dtype, G, nulls):
    """Many blocks, many chunks a block and a ragged last chunk: 3 blocks
    resident, 20011 rows."""
    v, order, starts, valid = case(G + 7 * nulls, dtype, G, nulls, n=20011)
    got, counts = twin_results(v, order, starts, valid)
    check_against_vkernels(got, counts, HOWS, v, order, starts, valid)


@pytest.mark.parametrize("G", [1, 26, 32])
def test_kernel_twin_flags_an_order_that_is_no_permutation(G):
    rng = np.random.default_rng(2)
    order, starts = segments(rng, 5000, G)
    order = order.copy()
    order[100] = order[4000]
    _, bad = kernel_twin(rng.integers(0, 9, 5000), tensor(order),
                         tensor(starts), None)
    assert bad


def test_path_thresholds():
    """The paths the wrapper picks, at the threshold of the source."""
    picks = {G: relational.segreduce_path(G) for G in (1, 32, 33, 255, 256)}
    assert picks == {1: "private", 32: "private", 33: "runs", 255: "runs",
                     256: "runs"}
    src = (relational.build.CSRC / "segreduce.cu").read_text()
    assert f"PRIVATE_MAX = {relational.PRIVATE_MAX_GROUPS};" in src


def test_ptxas_usage_reads_the_build_log(tmp_path, monkeypatch):
    """``build.ptxas_usage`` reads what ``-Xptxas -v`` printed at the build,
    kept beside the library."""
    from repro_torch.kernels import build
    assert ("-Xptxas", "-v") == build.NVCC_FLAGS[-2:]
    lib = tmp_path / "segreduce-0.so"
    monkeypatch.setattr(build, "library_path", lambda name: lib)
    k = "_ZN12_GLOBAL__N_114private_kernelILi8ELb1ELb1EEEvNS_4ArgsE"
    lib.with_suffix(".log").write_text(
        "ptxas info    : 0 bytes gmem\n"
        f"ptxas info    : Compiling entry function '{k}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for {k}\n"
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 40 registers, used 1 barriers, 8192 bytes "
        "smem, 400 bytes cmem[0]\n"
        "ptxas info    : Function properties for _ZN2f1E\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 8 registers, 360 bytes cmem[0]\n")
    assert build.ptxas_usage("segreduce") == [
        dict(kernel=k, stack=0, spill_stores=8, spill_loads=4, registers=40,
             smem=8192),
        dict(kernel="_ZN2f1E", stack=0, spill_stores=0, spill_loads=0,
             registers=8, smem=0)]
