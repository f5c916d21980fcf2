"""The relational port on the CPU, held bit for bit to the JAX package.

* Each relational kernel's plain PyTorch version, reached through the
  port's ``core.kdispatch`` on the ``cpu`` device, gives exactly the bits
  of ``repro.core.vkernels`` (the reference semantics), over every dtype
  family (int/uint widths, float16/32/64 with -0.0 and NaN payloads, bool)
  and edge (empty, one row, sizes off the kernels' block and tile, -1
  sentinels, an empty source, 1 / 26 / many groups, nulls, a uint64 sum
  that wraps).
* ``repro_torch.core.ops.join`` / ``filter_join`` / ``group_by`` (and
  their ``*_node`` forms) on the ``cpu`` device give raw buffers (values,
  validity, offsets, dictionaries, dtypes) identical to ``repro.core.ops``
  on tables built in both packages from the same columns.
* With the default device and no card, the ops raise.

The Pallas module ``repro.kernels.relational`` is not used: it does not
import on the installed jax (ROADMAP queue 3, item a).
"""
import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import arrow as jarrow, ops as jops, vkernels as jvk  # noqa
from repro_torch.core import arrow as tarrow, kdispatch as kd  # noqa: E402
from repro_torch.core import ops as tops  # noqa: E402
from repro_torch.kernels import ops as kops, ref  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

FIXED = [np.int8, np.int16, np.int32, np.int64, np.uint8, np.uint16,
         np.uint32, np.uint64, np.float16, np.float32, np.float64, np.bool_]
INTS = [d for d in FIXED if np.dtype(d).kind in "iub"]
# empty, one row, and sizes off the 256-thread block and 2048-row tile
SIZES = [0, 1, 7, 2048 + 3]


@pytest.fixture
def on_cpu():
    with kd.using_device("cpu"):
        yield


def fixed_array(rng, n, dtype):
    """Values of ``dtype`` over its whole bit range; floats mix in -0.0,
    +0.0, infinities and NaNs of two payloads."""
    dt = np.dtype(dtype)
    if dt.kind == "b":
        return rng.random(n) < 0.5
    if dt.kind == "f":
        a = rng.standard_normal(n).astype(dt)
        specials = np.array([-0.0, 0.0, np.inf, -np.inf, np.nan], dt)
        pick = rng.random(n) < 0.3
        a[pick] = specials[rng.integers(0, 5, int(pick.sum()))]
        bits = a.view(f"u{dt.itemsize}")
        nan2 = np.array([np.nan], dt).view(f"u{dt.itemsize}") | 1
        bits[rng.random(n) < 0.05] = nan2
        return a
    return rng.integers(0, 256, n * dt.itemsize, dtype=np.uint8).view(dt)


def same(got, want):
    """Same dtype, shape and bits (NaN payloads included)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def same_pair(got, want):
    same(got[0], want[0])
    same(got[1], want[1])


# --------------------------------------------------------------------------
# plain versions vs repro.core.vkernels
# --------------------------------------------------------------------------

def test_mix64_on_int64_words_matches_uint64():
    """The masked logical shift and the wrapping int64 multiply give the
    uint64 splitmix64 bits."""
    rng = np.random.default_rng(0)
    u = rng.integers(0, 1 << 64, 4096, dtype=np.uint64)
    u[:4] = [0, 1, (1 << 63), (1 << 64) - 1]
    got = ref.mix64_ref(torch.from_numpy(u.view(np.int64))).numpy()
    same(got.view(np.uint64), jvk._mix64(u))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", FIXED, ids=lambda d: np.dtype(d).name)
def test_hash_fixed_matches_vkernels(on_cpu, dtype, n):
    v = fixed_array(np.random.default_rng(n), n, dtype)
    same(kd.hash_fixed(v), jvk.hash_fixed(v))


def test_hash_fixed_canonicalises_zero_and_keeps_nan_bits(on_cpu):
    v = np.array([0.0, -0.0, np.nan, -np.nan], np.float64)
    h = kd.hash_fixed(v)
    assert h[0] == h[1] and h[2] != h[3]
    same(h, jvk.hash_fixed(v))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("ncols", [0, 1, 3])
def test_combine_and_hash_keys_match_vkernels(on_cpu, ncols, n):
    rng = np.random.default_rng(ncols * 100 + n)
    hs = [rng.integers(0, 1 << 64, n, dtype=np.uint64) for _ in range(ncols)]
    same(kd.combine_hashes(hs, n), jvk.combine_hashes(hs, n))
    keys = [fixed_array(rng, n, d) for d in (np.int64, np.float64,
                                              np.int32)[:ncols]]
    same(kd.hash_keys(keys, n), jvk.hash_keys(keys, n))


def test_hash_keys_var_length_keys_stay_on_vkernels(on_cpu):
    off = np.array([0, 2, 2, 5], np.int64)
    vals = np.frombuffer(b"abcde", np.uint8)
    keys = [np.arange(3, dtype=np.int64), (off, vals)]
    same(kd.hash_keys(keys, 3), jvk.hash_keys(keys, 3))


@pytest.mark.parametrize("case", ["mixed", "all_hit", "all_miss",
                                  "empty_sel", "no_idx"])
def test_filter_join_gather_matches_vkernels(on_cpu, case):
    rng = np.random.default_rng(1)
    sel = np.sort(rng.choice(5000, 2048 + 3, replace=False)).astype(np.int64)
    idx = {"mixed": rng.integers(-1, len(sel), 3001),
           "all_hit": rng.integers(0, len(sel), 3001),
           "all_miss": np.full(17, -1),
           "empty_sel": np.full(9, -1),
           "no_idx": np.empty(0)}[case].astype(np.int64)
    if case == "empty_sel":
        sel = sel[:0]
    same(kd.filter_join_gather(sel, idx), jvk.filter_join_gather(sel, idx))


def test_filter_join_gather_rejects_out_of_range_index(on_cpu):
    with pytest.raises(IndexError):
        kd.filter_join_gather(np.arange(3), np.array([3]))
    with pytest.raises(IndexError):
        kd.filter_join_gather(np.arange(3), np.array([-2]))


@pytest.mark.parametrize("nsrc", [0, 1, 2048 + 3])
@pytest.mark.parametrize("dtype", FIXED, ids=lambda d: np.dtype(d).name)
def test_gather_payload_matches_numpy(on_cpu, dtype, nsrc):
    rng = np.random.default_rng(nsrc)
    src = fixed_array(rng, nsrc, dtype)
    idx = (rng.integers(-1, nsrc, 3001) if nsrc
           else np.full(3001, -1)).astype(np.int64)
    fill = np.nan if np.dtype(dtype).kind == "f" else 1
    want = np.full(len(idx), fill, dtype=dtype)
    want[idx >= 0] = src[idx[idx >= 0]]
    same(kd.gather_payload(src, idx, fill), want)


def segments(rng, n, n_groups):
    codes = rng.integers(0, n_groups, n)
    return jvk.group_ranges([codes]) if n else (np.empty(0, np.int64),
                                                np.empty(0, np.int64))


@pytest.mark.parametrize("nulls", [False, True], ids=["valid", "nulls"])
@pytest.mark.parametrize("n,n_groups", [(0, 1), (1, 1), (2048 + 3, 1),
                                        (5000, 26), (6000, 4000)])
@pytest.mark.parametrize("dtype", INTS, ids=lambda d: np.dtype(d).name)
def test_reducers_match_vkernels(on_cpu, dtype, n, n_groups, nulls):
    rng = np.random.default_rng(n + n_groups)
    order, starts = segments(rng, n, n_groups)
    v = fixed_array(rng, n, dtype)
    valid = rng.random(n) < 0.6 if nulls else None
    for how in ("count", "sum", "min", "max"):
        same_pair(kd.GROUPED_REDUCERS[how](v, order, starts, valid),
                  jvk.GROUPED_REDUCERS[how](v, order, starts, valid))


def test_uint64_sum_wraps_like_vkernels(on_cpu):
    v = np.array([2 ** 64 - 1, 2, 2 ** 63, 2 ** 63, 5], np.uint64)
    order, starts = np.arange(5), np.array([0, 2])
    got = kd.GROUPED_REDUCERS["sum"](v, order, starts)
    same_pair(got, jvk.grouped_sum(v, order, starts))
    assert got[0].tolist() == [1, 5]
    big = np.full(4, (1 << 62) + 1, np.int64)          # int64 wraps too
    same_pair(kd.GROUPED_REDUCERS["sum"](big, np.arange(4), np.array([0])),
              jvk.grouped_sum(big, np.arange(4), np.array([0])))


@pytest.mark.parametrize("how", ["sum", "min", "max", "mean"])
def test_float_reducers_stay_on_vkernels(on_cpu, how, monkeypatch):
    """The registry's documented-ineligible entries never reach a kernel
    or its plain version, on any device."""
    assert not kd.eligible(f"grouped_{how}", np.float64)
    monkeypatch.setattr(kops, "_segreduce", None)      # must not be called
    rng = np.random.default_rng(7)
    v = fixed_array(rng, 500, np.float64)
    order, starts = segments(rng, 500, 9)
    valid = rng.random(500) < 0.7
    same_pair(kd.GROUPED_REDUCERS[how](v, order, starts, valid),
              jvk.GROUPED_REDUCERS[how](v, order, starts, valid))


@pytest.mark.parametrize("bad", ["float_values", "starts_not_0",
                                 "starts_not_rising", "starts_past_n",
                                 "order_out_of_range", "short_valid",
                                 "hash_2d", "idx_int32", "meta_device"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    """The same checks on every device, so the CPU raises wherever the
    kernel would refuse or read out of bounds."""
    order, starts = torch.arange(6), torch.tensor([0, 2, 5])
    vals, valid = torch.arange(6), None
    if bad == "hash_2d":
        call = lambda: kops.hash_fixed(torch.zeros(2, 3))          # noqa
    elif bad == "idx_int32":
        call = lambda: kops.filter_join_gather(                    # noqa
            torch.arange(3), torch.zeros(2, dtype=torch.int32))
    elif bad == "meta_device":
        call = lambda: kops.hash_fixed(                            # noqa
            torch.empty(3, dtype=torch.int64, device="meta"))
    else:
        if bad == "float_values":
            vals = vals.double()
        elif bad == "starts_not_0":
            starts = torch.tensor([1, 2, 5])
        elif bad == "starts_not_rising":
            starts = torch.tensor([0, 2, 2])
        elif bad == "starts_past_n":
            starts = torch.tensor([0, 2, 6])
        elif bad == "order_out_of_range":
            order = torch.tensor([0, 1, 2, 3, 4, 6])
        elif bad == "short_valid":
            valid = torch.ones(5, dtype=torch.bool)
        call = lambda: kops.grouped_sum(vals, order, starts, valid)  # noqa
    with pytest.raises((ValueError, TypeError)):
        call()


def test_self_check_on_the_cpu(on_cpu):
    res = kd.self_check()
    assert {k for k, v in res.items() if v == "ok"} == \
        {k for k, e in kd.REGISTRY.items() if e.eligible}
    assert all(res[k].startswith("ineligible")
               for k, e in kd.REGISTRY.items() if not e.eligible)


def test_self_check_raises_naming_the_kernel(on_cpu, monkeypatch):
    monkeypatch.setattr(kops, "hash_fixed",
                        lambda x: torch.zeros(len(x), dtype=torch.int64))
    with pytest.raises(RuntimeError, match="hash_fixed"):
        kd.self_check()


def test_registry_matches_the_reference():
    """The same entries, each admitted or refused as in the reference and
    with its reason."""
    from repro.core import kdispatch as jkd
    assert {k: e.eligible for k, e in kd.REGISTRY.items()} == \
        {k: e.eligible for k, e in jkd.REGISTRY.items()}
    assert all(e.reason for e in kd.REGISTRY.values())


def test_vkernels_code_is_the_reference_code():
    """The port's vkernels differs from the JAX package's in its docstring
    only."""
    def body(path):
        tree = ast.parse(path.read_text())
        return [ast.dump(node) for node in tree.body[1:]]
    assert body(ROOT / "src/repro_torch/core/vkernels.py") == \
        body(ROOT / "src/repro/core/vkernels.py")


# --------------------------------------------------------------------------
# device: cuda by default, no fallback
# --------------------------------------------------------------------------

def test_default_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t = tarrow.Table.from_pydict({"k": np.arange(4), "v": np.arange(4)})
    with pytest.raises(RuntimeError, match="CUDA"):
        tops.join(t, t, "k")
    with pytest.raises(RuntimeError, match="CUDA"):
        tops.group_by(t, "k", {"s": ("v", "sum")})
    with pytest.raises(RuntimeError, match="CUDA"):
        kd.self_check()


def test_set_device_and_using_device():
    with pytest.raises(ValueError):
        kd.set_device("numpy")
    with kd.using_device("cpu"):
        assert kd.device().type == "cpu"
        with kd.using_device("cuda"):
            assert kd._device == "cuda"
        assert kd.device().type == "cpu"
    assert kd._device == "cuda"


def test_port_reads_no_backend_env(monkeypatch):
    monkeypatch.setenv("ZERROW_KERNEL_BACKEND", "numpy")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        kd.hash_fixed(np.arange(3))


# --------------------------------------------------------------------------
# ops: raw buffers identical to repro.core.ops
# --------------------------------------------------------------------------

def column_spec(rng, n, kind, card=4, null_frac=0.0):
    """(kind, values, validity bitmap or None) — numpy buffers that either
    package builds a Column from."""
    validity = None
    if null_frac > 0 and n:
        validity = np.packbits(rng.random(n) >= null_frac, bitorder="little")
    if kind == "int":
        vals = rng.integers(0, card, n).astype(np.int64)
    elif kind == "int32":
        vals = rng.integers(-card, card, n).astype(np.int32)
    elif kind == "uint":
        vals = rng.integers(0, card, n).astype(np.uint64)
    elif kind == "uint64big":
        vals = (rng.integers(0, card, n).astype(np.uint64)
                + np.uint64((1 << 63) + 5))
    elif kind == "float":
        vals = rng.integers(-card, card, n).astype(np.float64) / 2
        vals[rng.random(n) < 0.1] = -0.0
        vals[rng.random(n) < 0.05] = np.nan
    elif kind == "bool":
        vals = rng.random(n) < 0.5
    elif kind in ("utf8", "dict"):
        vals = [f"k{int(v)}" * int(1 + v % 3)
                for v in rng.integers(0, card, n)]
    else:
        raise ValueError(kind)
    return kind, vals, validity


def build(arrow, spec):
    kind, vals, validity = spec
    if kind in ("utf8", "dict"):
        c = arrow.Column.from_strings(vals, validity=validity)
        if kind == "dict":
            codes, uoff, uvals = jvk.dict_encode_var(c.offsets, c.values)
            c = arrow.Column.dictionary_encoded(
                codes, arrow.Column.utf8(uoff, uvals), validity=validity)
        return c
    return arrow.Column.primitive(np.array(vals), validity=validity)


def tables(specs):
    """The same table in the JAX package and in the port."""
    return (jarrow.Table.from_pydict({k: build(jarrow, s)
                                      for k, s in specs.items()}),
            tarrow.Table.from_pydict({k: build(tarrow, s)
                                      for k, s in specs.items()}))


def raw(col):
    if col is None:
        return None
    return (col.type.to_json(), col.length, col.values.dtype.str,
            col.values.tobytes(),
            None if col.offsets is None else col.offsets.tobytes(),
            None if col.validity is None else col.validity.tobytes(),
            raw(col.dictionary))


def raw_table(t):
    b = t.combine().batches[0]
    return [(f.name, raw(c)) for f, c in zip(b.schema.fields, b.columns)]


def rand_specs(rng, n, key_kinds, payload_kinds, prefix, key_nulls=0.15,
               card=4):
    specs = {f"k{i}": column_spec(rng, n, kk, card=card, null_frac=key_nulls)
             for i, kk in enumerate(key_kinds)}
    specs.update({f"{prefix}{i}": column_spec(rng, n, pk, card=50,
                                              null_frac=0.2)
                  for i, pk in enumerate(payload_kinds)})
    return specs


KEY_MIXES = [("int",), ("int32",), ("uint",), ("float",), ("utf8",),
             ("dict",), ("int", "utf8"), ("dict", "float", "int")]
ALL_AGGS = {"n": ("p0", "count"), "tot": ("p0", "sum"), "lo": ("p0", "min"),
            "hi": ("p0", "max"), "avg": ("p0", "mean")}


@pytest.mark.parametrize("how", ["inner", "left"])
@pytest.mark.parametrize("key_kinds", KEY_MIXES,
                         ids=["-".join(k) for k in KEY_MIXES])
def test_join_matches_reference(on_cpu, key_kinds, how):
    rng = np.random.default_rng(len(key_kinds) * 31 + len(how))
    keys = [f"k{i}" for i in range(len(key_kinds))]
    lj, lt = tables(rand_specs(rng, int(rng.integers(30, 300)), key_kinds,
                               ("float", "int", "utf8"), "l"))
    rj, rt = tables(rand_specs(rng, int(rng.integers(30, 300)), key_kinds,
                               ("int", "dict", "bool"), "r"))
    assert raw_table(tops.join(lt, rt, on=keys, how=how)) == \
        raw_table(jops.join(lj, rj, on=keys, how=how))


def test_join_mixed_key_dtypes_and_dict_vs_utf8(on_cpu):
    rng = np.random.default_rng(2)
    lj, lt = tables({"k0": column_spec(rng, 200, "int32", card=8),
                     "k1": column_spec(rng, 200, "dict"),
                     "lv": column_spec(rng, 200, "int")})
    rj, rt = tables({"k0": column_spec(rng, 150, "int", card=8),
                     "k1": column_spec(rng, 150, "utf8"),
                     "rv": column_spec(rng, 150, "float")})
    for how in ("inner", "left"):
        assert raw_table(tops.join(lt, rt, ["k0", "k1"], how)) == \
            raw_table(jops.join(lj, rj, ["k0", "k1"], how))


@pytest.mark.parametrize("side", ["left", "right", "both"])
@pytest.mark.parametrize("how", ["inner", "left"])
def test_join_empty_sides(on_cpu, how, side):
    rng = np.random.default_rng(3)
    nl = 0 if side in ("left", "both") else 40
    nr = 0 if side in ("right", "both") else 40
    lj, lt = tables(rand_specs(rng, nl, ("int", "utf8"), ("float",), "l"))
    rj, rt = tables(rand_specs(rng, nr, ("int", "utf8"), ("utf8", "dict"),
                               "r"))
    assert raw_table(tops.join(lt, rt, ["k0", "k1"], how)) == \
        raw_table(jops.join(lj, rj, ["k0", "k1"], how))


def test_join_duplicate_heavy_keys(on_cpu):
    rng = np.random.default_rng(4)
    lj, lt = tables(rand_specs(rng, 120, ("int",), ("int",), "l",
                               key_nulls=0.0, card=1))
    rj, rt = tables(rand_specs(rng, 90, ("int",), ("float",), "r",
                               key_nulls=0.1, card=1))
    out = tops.join(lt, rt, "k0")
    assert out.num_rows > 120 * 70
    assert raw_table(out) == raw_table(jops.join(lj, rj, "k0"))


@pytest.mark.parametrize("masked", ["left", "right", "both"])
@pytest.mark.parametrize("how", ["inner", "left"])
def test_filter_join_matches_reference(on_cpu, how, masked):
    rng = np.random.default_rng(900 + len(masked) + len(how))
    lj, lt = tables(rand_specs(rng, 250, ("int", "utf8"), ("int", "float"),
                               "l"))
    rj, rt = tables(rand_specs(rng, 180, ("int", "utf8"), ("float", "utf8"),
                               "r"))
    lm = rng.random(250) < 0.6 if masked in ("left", "both") else None
    rm = rng.random(180) < 0.6 if masked in ("right", "both") else None
    got = tops.filter_join(lt, rt, ["k0", "k1"], how, left_mask=lm,
                           right_mask=rm)
    want = jops.filter_join(lj, rj, ["k0", "k1"], how, left_mask=lm,
                            right_mask=rm)
    assert raw_table(got) == raw_table(want)


@pytest.mark.parametrize("key_kinds", KEY_MIXES,
                         ids=["-".join(k) for k in KEY_MIXES])
def test_group_by_matches_reference(on_cpu, key_kinds):
    rng = np.random.default_rng(len(key_kinds) * 7 + 1)
    keys = [f"k{i}" for i in range(len(key_kinds))]
    for payload in ("int", "float", "int32", "bool", "uint"):
        specs = rand_specs(rng, int(rng.integers(40, 400)), key_kinds,
                           (payload,), "p")
        jt, tt = tables(specs)
        aggs = dict(ALL_AGGS)
        if payload == "bool":
            del aggs["avg"]
        assert raw_table(tops.group_by(tt, keys, aggs)) == \
            raw_table(jops.group_by(jt, keys, aggs)), payload


def test_group_by_uint64_sum_wraps(on_cpu):
    rng = np.random.default_rng(5)
    jt, tt = tables({"k0": column_spec(rng, 300, "int", card=3),
                     "p0": column_spec(rng, 300, "uint64big", card=1000,
                                       null_frac=0.1)})
    aggs = {"tot": ("p0", "sum"), "lo": ("p0", "min"), "hi": ("p0", "max")}
    got = tops.group_by(tt, "k0", aggs)
    assert raw_table(got) == raw_table(jops.group_by(jt, "k0", aggs))
    tot = got.combine().batches[0].column("tot").values
    assert tot.dtype == np.uint64 and len(tot) == 3    # ~100 x 2^63 wraps


def test_group_by_all_null_payload_group(on_cpu):
    vals = np.array([9, 8, 7, 6], np.int64)
    keys = np.array([1, 1, 2, 3], np.int64)
    validity = np.packbits(np.array([False, False, True, False]),
                           bitorder="little")
    specs = {"k0": ("int", keys, None), "p0": ("int", vals, validity)}
    jt, tt = tables(specs)
    got = tops.group_by(tt, "k0", ALL_AGGS)
    assert raw_table(got) == raw_table(jops.group_by(jt, "k0", ALL_AGGS))
    assert got.to_pydict()["tot"] == [None, 7, None]


def test_group_by_zero_rows_and_single_group(on_cpu):
    specs = {"k0": ("int", np.array([5, 5, 5], np.int64), None),
             "p0": ("int", np.array([1, -2, 3], np.int64), None)}
    jt, tt = tables(specs)
    assert raw_table(tops.group_by(tt, "k0", ALL_AGGS)) == \
        raw_table(jops.group_by(jt, "k0", ALL_AGGS))
    assert raw_table(tops.group_by(tops.slice_rows(tt, 0, 0), "k0",
                                   ALL_AGGS)) == \
        raw_table(jops.group_by(jops.slice_rows(jt, 0, 0), "k0", ALL_AGGS))


def test_star_query_and_node_forms(on_cpu):
    """The star join + group-by of the chip run, at a small size, through
    the DAG-node forms, with the launch counts of a CPU run at 0."""
    rng = np.random.default_rng(6)
    nations = [f"nation{i:02d}" for i in range(25)]
    orders = {"cust": ("int", rng.integers(0, 550, 5000), None),
              "amount": ("int", rng.integers(0, 1_000_000, 5000), None)}
    cust = {"cust": ("int", np.arange(500, dtype=np.int64), None),
            "country": ("utf8", [nations[i % 25] for i in range(500)], None)}
    (oj, ot), (cj, ct) = tables(orders), tables(cust)
    aggs = {"total": ("amount", "sum"), "lo": ("amount", "min"),
            "hi": ("amount", "max"), "n": ("amount", "count")}
    kops.reset_launch_counts()
    j = tops.join_node([ot, ct], on="cust", how="left")
    got = tops.group_by_node([j], "country", aggs)
    want = jops.group_by_node([jops.join_node([oj, cj], on="cust",
                                              how="left")], "country", aggs)
    assert raw_table(got) == raw_table(want)
    assert got.num_rows == 26                      # 25 nations + null group
    mask = ot.combine().batches[0].column("amount").values >= 500_000
    got = tops.filter_join_node([ot, ct], on="cust", left_mask=mask)
    want = jops.filter_join_node([oj, cj], on="cust", left_mask=mask)
    assert raw_table(got) == raw_table(want)
    assert set(kops.launch_counts.values()) == {0}
