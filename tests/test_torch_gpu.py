"""The hand-written CUDA kernels against their plain versions on the card:
flash attention at the shapes of tests/test_torch_kernels.py, in float32
and bfloat16, at the bf16 tensor-core kernel's tile edges, and at hd 256
with a window; the WKV-6 and RG-LRU scans at
ragged lengths and widths; the relational kernels (splitmix64, sentinel
gather, segment reductions) bit for bit over every dtype family and edge
case, and the relational ops on the card against the same ops on the CPU;
the row gather and dictionary decode bit for bit, and the gradient guard
of every wrapper that takes floats.  Skips without a CUDA card; run it
there with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import kdispatch, ops as rops  # noqa: E402
from repro_torch.core.arrow import Table  # noqa: E402
from repro_torch.kernels import ops, ref, take_gather  # noqa: E402

pytestmark = pytest.mark.gpu

# bf16: the output's rounding and the bf16 kernel's rounding of P before
# the P V product, about one bf16 ulp each; f32: summation order over T
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


FLASH_CASES = [  # (B, S, T, H, KV, hd, causal, window), float32 and bf16
    (1, 128, 128, 2, 2, 32, True, 0),
    (2, 256, 256, 4, 2, 64, True, 0),
    (1, 128, 256, 4, 1, 32, True, 0),
    (1, 128, 128, 2, 2, 32, False, 0),
    (1, 256, 256, 2, 2, 32, True, 32),
    (1, 200, 200, 3, 1, 64, True, 0),
    (2, 100, 130, 4, 2, 16, False, 48),
    (1, 96, 96, 2, 1, 128, True, 0),
]
# the bf16 tensor-core kernel's tile edges (BQ 64; BK 64, 32 at hd 256),
# with q_pad: q sliced out of padded heads ("heads", strides stay 16-byte
# multiples) or a padded head dim ("hd", strides of hd + 4 elements)
BF16_EDGES = [
    (2, 100, 130, 4, 2, 64, True, 0, None),        # ragged, S < T
    (1, 100, 300, 4, 2, 128, True, 0, None),       # ragged, S < T, hd 128
    (2, 200, 200, 9, 3, 64, True, 0, None),        # G 3
    (2, 256, 256, 4, 2, 16, True, 0, None),        # hd 16
    (1, 256, 256, 4, 2, 32, True, 64, None),       # hd 32
    (1, 160, 160, 4, 1, 128, False, 0, None),      # hd 128
    (1, 300, 300, 16, 1, 256, True, 0, None),      # hd 256, G 16
    (2, 77, 150, 16, 1, 256, False, 0, None),      # hd 256 ragged, S < T
    (1, 1000, 1000, 6, 2, 64, True, 128, None),    # window: first tile > 0
    (1, 1000, 1000, 16, 1, 256, True, 128, None),
    (2, 200, 200, 4, 2, 64, True, 0, "heads"),
    (2, 200, 200, 4, 2, 64, True, 0, "hd"),
]


@pytest.mark.parametrize(
    "dtype,B,S,T,H,KV,hd,causal,window,q_pad",
    [(dtype, *c, None) for c in FLASH_CASES
     for dtype in (torch.float32, torch.bfloat16)]
    + [(torch.bfloat16, *c) for c in BF16_EDGES])
def test_kernel_matches_plain(cuda, dtype, B, S, T, H, KV, hd, causal,
                              window, q_pad):
    g = torch.Generator(device=cuda).manual_seed(S + T + hd)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(dtype)
               for s in ((B, S, H, hd), (B, T, KV, hd), (B, T, KV, hd)))
    if q_pad == "heads":
        q = torch.nn.functional.pad(q, (0, 0, 0, 1))[:, :, :H]
    elif q_pad == "hd":
        q = torch.nn.functional.pad(q, (0, 4))[..., :hd]
    assert q_pad is None or not q.is_contiguous()
    before = ops.launch_counts["flash_attention"]
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert ops.launch_counts["flash_attention"] == before + 1
    want = ref.attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == want.shape
    torch.testing.assert_close(out.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("S,window", [(200, 64), (300, 128)])
def test_kernel_hd256_window_matches_plain(cuda, S, window):
    """recurrentgemma's local attention: hd 256, MQA (G 16), a window."""
    g = torch.Generator(device=cuda).manual_seed(S)
    q, k, v = (torch.randn(s, generator=g, device=cuda).bfloat16()
               for s in ((1, S, 16, 256), (1, S, 1, 256), (1, S, 1, 256)))
    out = ops.flash_attention(q, k, v, causal=True, window=window)
    want = ref.attention_ref(q, k, v, causal=True, window=window)
    torch.testing.assert_close(out.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


def wkv_inputs(g, B, S, H, N, dtype, decay="model"):
    """w over the model's range [0.018, 1), near 1, tiny (log-uniform in
    [1e-30, 1e-3], past what the bf16 kernel's factorised chunk takes) or
    mixed (the model's range with one token in twenty tiny)."""
    r, k = (0.5 * torch.randn(B, S, H, N, generator=g, device="cuda")
            for _ in range(2))
    v = torch.randn(B, S, H, N, generator=g, device="cuda")
    z = torch.rand(B, S, H, N, generator=g, device="cuda")
    model = 0.018 + (1 - 0.018) * z
    tiny = torch.pow(10.0, -30.0 + 27.0 * z)
    if decay == "mixed":
        pick = torch.rand(B, S, H, 1, generator=g, device="cuda") < 0.05
        w = torch.where(pick, tiny, model)
    else:
        w = {"model": model, "near 1": 1.0 - 1e-3 * z, "tiny": tiny}[decay]
    u = 0.1 * torch.randn(H, N, generator=g, device="cuda")
    st = 0.1 * torch.randn(B, H, N, N, generator=g, device="cuda")
    return r.to(dtype), k.to(dtype), v.to(dtype), w, u, st


def at_offset(x, offset):
    """x's values in a contiguous tensor that starts ``offset`` elements
    into a flat buffer: at 1 its base is not 16-byte aligned, and the bf16
    kernel stages it element by element."""
    if offset == 0:
        return x
    buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    return buf[offset:].view(x.shape).copy_(x)


# lengths at the bf16 kernel's chunk edges (16 tokens) and S = 1, at every
# head size (one block a head, a warp per 16 columns of the state)
WKV_CASES = [(1, 1, 2, 16), (2, 17, 3, 32), (1, 100, 2, 64), (2, 64, 5, 64),
             (1, 1, 2, 64), (1, 15, 2, 64), (2, 16, 3, 64), (1, 33, 2, 32),
             (2, 47, 2, 16)]


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("decay", ["model", "near 1", "tiny", "mixed"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,N", WKV_CASES)
def test_wkv6_matches_plain(cuda, dtype, B, S, H, N, decay, offset):
    g = torch.Generator(device=cuda).manual_seed(S * N)
    r, k, v, w, u, st = wkv_inputs(g, B, S, H, N, dtype, decay)
    r, k, v, w = (at_offset(x, offset) for x in (r, k, v, w))
    assert (r.data_ptr() % 16 == 0) == (offset == 0) and r.is_contiguous()
    for state in (st, None):
        before = ops.launch_counts["wkv6"]
        out, s_out = ops.wkv6(r, k, v, w, u, state)
        assert ops.launch_counts["wkv6"] == before + 1
        want, want_s = ref.wkv6_ref(r, k, v, w, u, state)
        torch.cuda.synchronize()
        assert out.dtype == dtype and s_out.dtype == torch.float32
        tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
        torch.testing.assert_close(out.float(), want.float(), rtol=tol,
                                   atol=tol)
        torch.testing.assert_close(s_out, want_s, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("B,S,W", [(1, 1, 64), (2, 3, 100), (3, 70, 4100),
                                   (1, 512, 4096)])
def test_rglru_scan_matches_plain_bit_for_bit(cuda, B, S, W):
    g = torch.Generator(device=cuda).manual_seed(S + W)
    a = torch.rand(B, S, W, generator=g, device=cuda)
    b = torch.randn(B, S, W, generator=g, device=cuda)
    h0 = torch.randn(B, W, generator=g, device=cuda)
    for init in (h0, None):
        before = ops.launch_counts["rglru_scan"]
        h, h_last = ops.rglru_scan(a, b, init)
        assert ops.launch_counts["rglru_scan"] == before + 1
        want, want_last = ref.rglru_ref(a, b, init)
        torch.cuda.synchronize()
        assert torch.equal(h, want) and torch.equal(h_last, want_last)


def test_kernel_reads_strided_inputs(cuda):
    """q/k/v sliced out of one fused projection: strided, not copied."""
    g = torch.Generator(device=cuda).manual_seed(0)
    qkv = torch.randn(2, 64, 4 + 2 + 2, 32, generator=g, device=cuda)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    assert not q.is_contiguous()
    out = ops.flash_attention(q, k, v)
    torch.testing.assert_close(out, ref.attention_ref(q, k, v), rtol=2e-5,
                               atol=2e-5)


# --------------------------------------------------------------------------
# relational kernels: bit for bit against their plain versions
# --------------------------------------------------------------------------

FIXED = [np.int8, np.int16, np.int32, np.int64, np.uint8, np.uint16,
         np.uint32, np.uint64, np.float16, np.float32, np.float64, np.bool_]
INTS = [d for d in FIXED if np.dtype(d).kind in "iub"]
SIZES = [1, 7, 2048 + 3, 100_003]       # not multiples of a block or tile


def fixed_array(rng, n, dtype):
    """Values of ``dtype`` over its whole bit range; floats mix in -0.0,
    +0.0, infinities and NaNs of two payloads (as in
    tests/test_torch_relational.py, which imports jax and so cannot be
    imported here)."""
    dt = np.dtype(dtype)
    if dt.kind == "b":
        return rng.random(n) < 0.5
    if dt.kind == "f":
        a = rng.standard_normal(n).astype(dt)
        specials = np.array([-0.0, 0.0, np.inf, -np.inf, np.nan], dt)
        pick = rng.random(n) < 0.3
        a[pick] = specials[rng.integers(0, 5, int(pick.sum()))]
        nan2 = np.array([np.nan], dt).view(f"u{dt.itemsize}") | 1
        a.view(f"u{dt.itemsize}")[rng.random(n) < 0.05] = nan2
        return a
    return rng.integers(0, 256, n * dt.itemsize, dtype=np.uint8).view(dt)


def to_cuda(a):
    """A numpy array on the card, as ``core.kdispatch`` moves it."""
    return kdispatch._to_tensor(np.asarray(a), torch.device("cuda"))


def bits(t):
    return t.view(ref.SIGNED[t.element_size()]) if t.dtype != torch.bool \
        else t.view(torch.int8)


def assert_same_bits(got, want):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(bits(got), bits(want))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", FIXED, ids=lambda d: np.dtype(d).name)
def test_hash_fixed_matches_plain(cuda, dtype, n):
    x = to_cuda(fixed_array(np.random.default_rng(n), n, dtype))
    before = ops.launch_counts["hash_fixed"]
    got = ops.hash_fixed(x)
    assert ops.launch_counts["hash_fixed"] == before + 1
    assert_same_bits(got, ref.hash_fixed_ref(x))


@pytest.mark.parametrize("mix_first", [False, True])
@pytest.mark.parametrize("ncols", [0, 1, 3])
@pytest.mark.parametrize("n", SIZES)
def test_combine_matches_plain(cuda, ncols, n, mix_first):
    rng = np.random.default_rng(ncols * 10 + n)
    cols = to_cuda(rng.integers(-(1 << 63), (1 << 63) - 1, (ncols, n),
                                dtype=np.int64))
    before = ops.launch_counts["combine_hashes"]
    got = ops.combine_hashes(cols, mix_first)
    assert ops.launch_counts["combine_hashes"] == before + 1
    assert_same_bits(got, ref.combine_ref(cols, mix_first))


@pytest.mark.parametrize("nsrc", [1, 5, 100_003])
@pytest.mark.parametrize("dtype", FIXED, ids=lambda d: np.dtype(d).name)
def test_gather_matches_plain(cuda, dtype, nsrc):
    rng = np.random.default_rng(nsrc)
    src = to_cuda(fixed_array(rng, nsrc, dtype))
    idx = to_cuda(rng.integers(-1, nsrc, 2048 + 3).astype(np.int64))
    fill = np.nan if np.dtype(dtype).kind == "f" else 1
    got = ops.gather_payload(src, idx, fill)
    want = ref.sentinel_gather_ref(src, idx, ops._fill_word(fill, src.dtype))
    assert_same_bits(got, want)


def test_gather_edges(cuda):
    before = ops.launch_counts["filter_join_gather"]
    empty = torch.empty(0, dtype=torch.int64, device="cuda")
    misses = torch.full((9,), -1, dtype=torch.int64, device="cuda")
    assert ops.filter_join_gather(empty, misses).tolist() == [-1] * 9
    assert ops.filter_join_gather(misses, empty).numel() == 0
    assert ops.launch_counts["filter_join_gather"] == before    # no launch
    sel = torch.arange(10, 20, device="cuda")
    got = ops.filter_join_gather(sel, torch.tensor([3, -1, 0, 9],
                                                   device="cuda"))
    assert got.tolist() == [13, -1, 10, 19]
    with pytest.raises(IndexError):
        ops.filter_join_gather(sel, torch.tensor([10], device="cuda"))


def segments(rng, n, n_groups):
    """(order, starts) of ``vkernels.group_ranges`` over random codes."""
    from repro_torch.core import vkernels
    codes = rng.integers(0, n_groups, n) if n_groups > 1 \
        else np.zeros(n, np.int64)
    return vkernels.group_ranges([codes])


SEGREDUCE_HOWS = ("count", "sum", "min", "max")


@pytest.mark.parametrize("nulls", [False, True])
@pytest.mark.parametrize("n,n_groups", [(1, 1), (2048 + 3, 1),
                                        (100_003, 26), (300_000, 150_000),
                                        (100_003, 32), (100_003, 33),
                                        (100_003, 254), (100_003, 255),
                                        (100_003, 256)])
@pytest.mark.parametrize("dtype", INTS, ids=lambda d: np.dtype(d).name)
def test_segreduce_matches_plain(cuda, dtype, n, n_groups, nulls):
    """The one-op wrappers, the fused wrapper for every op set, and every
    path of segreduce.cu that takes the groups (through the binding),
    each against the plain version, bit for bit; one launch a call."""
    from repro_torch.kernels import relational
    rng = np.random.default_rng(n + n_groups)
    order, starts = segments(rng, n, n_groups)
    vals = to_cuda(fixed_array(rng, n, dtype))
    order, starts = to_cuda(order), to_cuda(starts)
    valid = to_cuda(rng.random(n) < 0.7) if nulls else None
    for op, fn in (("sum", ops.grouped_sum), ("min", ops.grouped_min),
                   ("max", ops.grouped_max)):
        before = ops.launch_counts["segreduce"]
        got, counts = fn(vals, order, starts, valid)
        assert ops.launch_counts["segreduce"] == before + 1
        acc, want_counts = ref.segreduce_ref(op, vals, order, starts, valid)
        want = acc.view(got.dtype) if op == "sum" \
            else ops._narrow(acc, got.dtype)
        assert_same_bits(got, want)
        assert_same_bits(counts, want_counts)
    counts, _ = ops.grouped_count(order, starts, valid)
    assert_same_bits(counts, ref.segreduce_ref("count", None, order, starts,
                                               valid)[1])
    words, want_counts = ref.segreduce_many_ref(SEGREDUCE_HOWS, vals, order,
                                                starts, valid)
    G = starts.numel()
    paths = [p for p, most in (("private", relational.PRIVATE_MAX_GROUPS),
                               ("runs", G)) if G <= most]
    for r in range(1, 5):
        for hows in itertools.combinations(SEGREDUCE_HOWS, r):
            before = ops.launch_counts["segreduce"]
            got, counts = ops.grouped_reduce(vals, order, starts, valid, hows)
            assert ops.launch_counts["segreduce"] == before + 1
            assert_same_bits(counts, want_counts)
            for h in hows[hows[0] == "count":]:
                want = words[h].view(got[h].dtype) if h == "sum" \
                    else ops._narrow(words[h], got[h].dtype)
                assert_same_bits(got[h], want)
            for path in paths:
                w, c, twice = relational.segreduce_cuda(
                    path, hows, vals, order, starts, valid, n)
                assert twice is None or twice.item() == 0
                assert_same_bits(c, want_counts)
                for h in w:
                    assert_same_bits(w[h], words[h])


@pytest.mark.parametrize("n_groups", [26, 200])
def test_segreduce_raises_on_a_duplicated_order(cuda, n_groups):
    """The few-groups path flags an order that names a row twice, and the
    wrapper raises where it takes that path (G <= 32); the sorted-run pass
    gives the plain version's result, as the CPU does."""
    from repro_torch.kernels import relational
    rng = np.random.default_rng(n_groups)
    order, starts = segments(rng, 50_000, n_groups)
    order[3] = order[40_000]
    vals = to_cuda(rng.integers(-9, 9, 50_000))
    order, starts = to_cuda(order), to_cuda(starts)
    if n_groups <= relational.PRIVATE_MAX_GROUPS:
        _, _, twice = relational.segreduce_cuda(
            "private", SEGREDUCE_HOWS, vals, order, starts, None, 50_000)
        assert twice.item() == 1
    want, want_counts = ref.segreduce_many_ref(SEGREDUCE_HOWS, vals, order,
                                               starts, None)
    if relational.segreduce_path(n_groups) != "runs":
        with pytest.raises(ValueError, match="permutation"):
            ops.grouped_reduce(vals, order, starts, None, SEGREDUCE_HOWS)
    else:
        got, counts = ops.grouped_reduce(vals, order, starts, None,
                                         SEGREDUCE_HOWS)
        assert_same_bits(counts, want_counts)
    words, counts, _ = relational.segreduce_cuda(
        "runs", SEGREDUCE_HOWS, vals, order, starts, None, 50_000)
    assert_same_bits(counts, want_counts)
    for h in words:
        assert_same_bits(words[h], want[h])


def test_segreduce_uint64_sum_wraps(cuda):
    vals = to_cuda(np.array([2 ** 64 - 1, 2, 2 ** 63, 2 ** 63, 5],
                            dtype=np.uint64))
    order = to_cuda(np.arange(5, dtype=np.int64))
    starts = to_cuda(np.array([0, 2], dtype=np.int64))
    sums, counts = ops.grouped_sum(vals, order, starts)
    torch.cuda.synchronize()
    assert sums.view(torch.int64).tolist() == [1, 5]      # both wrap
    assert counts.tolist() == [2, 3]


def test_self_check_on_the_card(cuda):
    with kdispatch.using_device("cuda"):
        res = kdispatch.self_check()
    assert all(v == "ok" or v.startswith("ineligible") for v in res.values())


def star_tables(seed, n_orders, n_cust):
    rng = np.random.default_rng(seed)
    nations = [f"nation{i:02d}" for i in range(25)]
    orders = {"cust": rng.integers(0, int(n_cust * 1.1), n_orders),
              "amount": rng.integers(0, 1_000_000, n_orders)}
    cust = {"cust": np.arange(n_cust, dtype=np.int64),
            "country": [nations[i % 25] for i in range(n_cust)]}
    return Table.from_pydict(orders), Table.from_pydict(cust)


def raw_buffers(t):
    b = t.combine().batches[0]
    return [(f.name, f.type, c.values.dtype, c.values.tobytes(),
             None if c.offsets is None else c.offsets.tobytes(),
             None if c.validity is None else c.validity.tobytes())
            for f, c in zip(b.schema.fields, b.columns)]


def test_star_query_on_the_card_equals_the_cpu(cuda):
    orders, cust = star_tables(0, 200_000, 20_000)
    aggs = {"total": ("amount", "sum"), "lo": ("amount", "min"),
            "hi": ("amount", "max"), "n": ("amount", "count")}
    out = {}
    for dev in ("cuda", "cpu"):
        with kdispatch.using_device(dev):
            j = rops.join(orders, cust, "cust", how="left")
            out[dev] = raw_buffers(rops.group_by(j, "country", aggs))
    assert out["cuda"] == out["cpu"]


# --------------------------------------------------------------------------
# row gather and dictionary decode: bit for bit against the plain versions
# --------------------------------------------------------------------------

GATHER_DTYPES = [torch.float32, torch.bfloat16, torch.int32, torch.int64,
                 torch.uint8]


def gather_table(g, R, W, dtype):
    """R x W elements over the whole bit range of ``dtype`` (NaNs of
    random payloads among them); a float table begins with -0.0, inf,
    -inf and NaN."""
    size = torch.empty(0, dtype=dtype).element_size()
    t = torch.randint(0, 256, (R, W * size), dtype=torch.uint8, generator=g,
                      device="cuda").view(dtype)
    if dtype.is_floating_point:
        specials = torch.tensor([-0.0, float("inf"), float("-inf"),
                                 float("nan")], dtype=dtype, device="cuda")
        n = min(4, t.numel())
        t.view(-1)[:n] = specials[:n]
    return t


def gather(kind, table, idx):
    return ops.take_rows(table, idx) if kind == "take_rows" \
        else ops.dict_decode(idx, table)


def plain_gather(kind, table, idx):
    return ref.take_rows_ref(table, idx) if kind == "take_rows" \
        else ref.dict_decode_ref(idx, table)


@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64],
                         ids=["int32", "int64"])
@pytest.mark.parametrize("W", [1, 7, 8, 130])
@pytest.mark.parametrize("dtype", GATHER_DTYPES, ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("kind", ["take_rows", "dict_decode"])
def test_gather_matches_plain_bit_for_bit(cuda, kind, dtype, W, idx_dtype):
    g = torch.Generator(device=cuda).manual_seed(W)
    table = gather_table(g, 25 if kind == "dict_decode" else 1000, W, dtype)
    for M in (1, 7, 257, 100_003):
        idx = torch.randint(0, table.shape[0], (M,), generator=g,
                            device=cuda, dtype=idx_dtype)
        before = ops.launch_counts[kind]
        got = gather(kind, table, idx)
        assert ops.launch_counts[kind] == before + 1
        assert_same_bits(got, plain_gather(kind, table, idx))


@pytest.mark.parametrize("side", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=lambda d: str(d)[6:])
def test_dict_decode_on_both_sides_of_the_shared_memory_limit(cuda, dtype,
                                                             side):
    """A dictionary that just fits the per-block shared memory is staged
    there; one row more is read through L2."""
    W = 64
    R = take_gather.smem_limit() // (W * torch.empty(0, dtype=dtype)
                                     .element_size()) + side
    g = torch.Generator(device=cuda).manual_seed(R)
    table = gather_table(g, R, W, dtype)
    assert take_gather.staged(table) == (side == 0)
    idx = torch.randint(0, R, (100_003,), generator=g, device=cuda)
    assert_same_bits(ops.dict_decode(idx, table),
                     ref.dict_decode_ref(idx, table))


@pytest.mark.parametrize("kind", ["take_rows", "dict_decode"])
def test_gather_unaligned_and_strided_tables(cuda, kind):
    g = torch.Generator(device=cuda).manual_seed(1)
    idx = torch.randint(0, 1000, (10_001,), generator=g, device=cuda)
    for dtype, shift in ((torch.float32, 1), (torch.bfloat16, 3),
                         (torch.uint8, 5)):
        flat = gather_table(g, 1, 1000 * 8 + shift, dtype).view(-1)
        for table in (flat[shift:].view(1000, 8),
                      flat[:8000].view(1000, 8)[:, 1:7]):
            assert_same_bits(gather(kind, table, idx),
                             plain_gather(kind, table, idx))


@pytest.mark.parametrize("kind", ["take_rows", "dict_decode"])
def test_gather_edges_launch_nothing(cuda, kind):
    table = torch.randn(5, 3, device=cuda)
    before = ops.launch_counts[kind]
    for bad, dtype in (([0, -1], torch.int32), ([5], torch.int32),
                       ([2 ** 31], torch.int64), ([2 ** 32 + 1], torch.int64)):
        with pytest.raises(IndexError, match="out of range"):
            gather(kind, table, torch.tensor(bad, dtype=dtype, device=cuda))
    with pytest.raises(IndexError, match="out of range"):
        gather(kind, table[:0], torch.zeros(2, dtype=torch.int64,
                                            device=cuda))
    out = gather(kind, table, torch.empty(0, dtype=torch.int32, device=cuda))
    assert out.shape == (0, 3) and out.dtype == table.dtype
    assert ops.launch_counts[kind] == before


@pytest.mark.parametrize("kind", ["flash_attention", "wkv6", "rglru_scan",
                                  "take_rows", "dict_decode"])
def test_wrappers_refuse_inputs_that_require_grad(cuda, kind):
    """The kernels have no backward yet: with grad enabled, an input that
    requires grad is refused before any launch; under no_grad the same
    call launches."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(1, 16, h, 16, generator=g, device=cuda)
               for h in (2, 1, 1))
    r, kk, vv, w, u, _ = wkv_inputs(g, 1, 4, 2, 16, torch.float32)
    a, b = torch.rand(2, 1, 4, 8, generator=g, device=cuda)
    table = torch.randn(5, 3, generator=g, device=cuda)
    idx = torch.tensor([0, 4, 2], device=cuda)
    call, x = {"flash_attention": (lambda x: ops.flash_attention(x, k, v), q),
               "wkv6": (lambda x: ops.wkv6(r, kk, vv, w, x), u),
               "rglru_scan": (lambda x: ops.rglru_scan(x, b), a),
               "take_rows": (lambda x: ops.take_rows(x, idx), table),
               "dict_decode": (lambda x: ops.dict_decode(idx, x), table)
               }[kind]
    x = x.detach().requires_grad_()
    before = ops.launch_counts[kind]
    with torch.enable_grad(), pytest.raises(RuntimeError,
                                            match="queue 1, item 6"):
        call(x)
    assert ops.launch_counts[kind] == before
    with torch.no_grad():
        call(x)
    assert ops.launch_counts[kind] == before + 1
