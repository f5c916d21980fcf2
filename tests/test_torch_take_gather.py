"""The port's row gather and dictionary decode on CPU tensors (their plain
versions) against the JAX package, bit for bit: ``ops.take_rows`` /
``ops.dict_decode`` against the Pallas kernels in interpret mode (through
``repro.kernels.ops``, at tests/test_kernels.py's shapes, and in bfloat16)
on finite inputs, and against the oracles ``repro.kernels.ref.
take_rows_ref`` / ``dict_decode_ref`` with inf, NaN and -0.0 in the
table; the wrappers' edges (zero rows, the lengths the JAX wrapper pads,
out-of-range and 64-bit indices) against the JAX wrappers' behaviour, and
the gradient guard that the CUDA branches of the wrappers share.  On the
card the wrappers launch csrc/take_gather.cu instead;
tests/test_torch_gpu.py and chip_smoke.py hold it to the same plain
versions there."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

# numpy dtype (ml_dtypes' bfloat16 for JAX) -> torch dtype of the same bits
DTYPES = {"float32": (np.float32, torch.float32),
          "int32": (np.int32, torch.int32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SIGNED = {1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}


def to_torch(a: np.ndarray) -> torch.Tensor:
    """A numpy array (bfloat16 too) as a CPU tensor of the same bits."""
    a = np.ascontiguousarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def bits(x) -> np.ndarray:
    """The bits of a torch tensor or a JAX/numpy array, as signed ints."""
    if isinstance(x, torch.Tensor):
        return x.view(getattr(torch, SIGNED[x.element_size()].__name__)) \
            .numpy()
    a = np.asarray(x)
    return a.view(SIGNED[a.dtype.itemsize])


def assert_same_bits(got: torch.Tensor, want) -> None:
    want_dtype = np.asarray(want).dtype.name
    assert str(got.dtype)[6:] == want_dtype
    assert tuple(got.shape) == np.asarray(want).shape
    np.testing.assert_array_equal(bits(got), bits(want))


def port_take(values, idx):
    return ops.take_rows(to_torch(values), to_torch(idx))


def port_decode(codes, dictionary):
    return ops.dict_decode(to_torch(codes), to_torch(dictionary))


def nonfinite_table(rng, R, W, name):
    """Normals with -0.0, +-inf and NaNs (the quiet NaN and, in float32,
    one with its own payload) at random places, in ``name``'s dtype."""
    np_dtype, _ = DTYPES[name]
    a = rng.normal(size=(R, W)).astype(np.float32)
    nan2 = (np.array([np.nan], np.float32).view(np.uint32) | 0x2a) \
        .view(np.float32)[0]
    specials = np.array([-0.0, np.inf, -np.inf, np.nan, nan2], np.float32)
    pick = rng.random((R, W)) < 0.3
    a[pick] = specials[rng.integers(0, len(specials), int(pick.sum()))]
    a.flat[:len(specials)] = specials
    return a.astype(np_dtype)


# ---------------------------------------------------------------------------
# against the Pallas kernels (interpret mode), finite inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["float32", "int32", "bfloat16"])
@pytest.mark.parametrize("R,W,M", [(64, 128, 32), (128, 256, 128)])
def test_take_rows_matches_pallas(R, W, M, name):
    rng = np.random.default_rng(R + M)
    vals = rng.integers(0, 100, (R, W)).astype(DTYPES[name][0])
    idx = rng.integers(0, R, (M,)).astype(np.int32)
    assert_same_bits(port_take(vals, idx),
                     jops.take_rows(jnp.asarray(vals), jnp.asarray(idx)))


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("R,W,M,bm", [(16, 128, 256, 64),
                                      (64, 128, 512, 256)])
def test_dict_decode_matches_pallas(R, W, M, bm, name):
    rng = np.random.default_rng(R + M)
    dic = rng.normal(size=(R, W)).astype(np.float32).astype(DTYPES[name][0])
    codes = rng.integers(0, R, (M,)).astype(np.int32)
    assert_same_bits(port_decode(codes, dic),
                     jops.dict_decode(jnp.asarray(codes), jnp.asarray(dic),
                                      bm=bm))


# ---------------------------------------------------------------------------
# against the oracles, with inf, NaN and -0.0
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("R,W,M", [(9, 1, 40), (33, 7, 103), (64, 130, 257)])
def test_take_rows_matches_oracle_on_nonfinite(R, W, M, name, idx_dtype):
    rng = np.random.default_rng(W + M)
    vals = nonfinite_table(rng, R, W, name)
    idx = rng.integers(0, R, (M,)).astype(idx_dtype)
    assert_same_bits(port_take(vals, idx),
                     jref.take_rows_ref(jnp.asarray(vals),
                                        jnp.asarray(idx.astype(np.int32))))


@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("R,W,M", [(4, 2, 64), (25, 16, 257), (6, 7, 103)])
def test_dict_decode_matches_oracle_on_nonfinite(R, W, M, name, idx_dtype):
    rng = np.random.default_rng(R + W + M)
    dic = nonfinite_table(rng, R, W, name)
    codes = rng.integers(0, R, (M,)).astype(idx_dtype)
    assert_same_bits(port_decode(codes, dic),
                     jref.dict_decode_ref(jnp.asarray(codes.astype(np.int32)),
                                          jnp.asarray(dic)))


@pytest.mark.parametrize("kind", ["take_rows", "dict_decode"])
def test_bfloat16_nan_payloads_survive(kind):
    """The gathers copy bits, NaN payloads of bfloat16 included.  XLA's
    CPU gather in bfloat16 returns the quiet NaN 0x7fc0 for them (a NaN
    all the same), so the payloads are held to numpy's gather of the
    bits."""
    table = np.full((3, 2), 0x7fc5, np.uint16)
    table[1] = [0x3f80, 0xffa1]                   # 1.0, a negative NaN
    idx = np.array([2, 1, 0, 1], np.int32)
    got = port_call(kind, table.view(jnp.bfloat16), idx)
    np.testing.assert_array_equal(bits(got), table.view(np.int16)[idx])


def test_dict_decode_follows_the_oracle_where_pallas_does_not():
    """ROADMAP queue 3 item b: the Pallas one-hot matmul turns 0 x inf into
    NaN across the block; the port gathers, as the oracle does."""
    dic = np.array([[1, 2], [np.inf, 3], [4, np.nan], [5, 6]], np.float32)
    codes = np.array([0, 3, 0, 3], np.int32)
    want = jref.dict_decode_ref(jnp.asarray(codes), jnp.asarray(dic))
    np.testing.assert_array_equal(np.asarray(want),
                                  [[1, 2], [5, 6], [1, 2], [5, 6]])
    assert_same_bits(port_decode(codes, dic), want)
    pallas = np.asarray(jops.dict_decode(jnp.asarray(codes),
                                         jnp.asarray(dic)))
    assert np.isnan(pallas).any() and not np.isnan(np.asarray(want)).any()


# ---------------------------------------------------------------------------
# the edges, against the JAX wrappers' behaviour
# ---------------------------------------------------------------------------

def jax_call(kind, table, idx):
    if kind == "take_rows":
        return jops.take_rows(jnp.asarray(table), idx)
    return jops.dict_decode(idx, jnp.asarray(table), bm=64)


def port_call(kind, table, idx):
    return port_take(table, idx) if kind == "take_rows" \
        else port_decode(idx, table)


KINDS = ["take_rows", "dict_decode"]


@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("kind", KINDS)
def test_zero_rows_give_an_empty_gather(kind, idx_dtype):
    table = np.random.default_rng(0).normal(size=(9, 7)).astype(np.float32)
    idx = np.zeros(0, idx_dtype)
    got, want = port_call(kind, table, idx), jax_call(kind, table, idx)
    assert_same_bits(got, want)
    assert got.shape == (0, 7)


@pytest.mark.parametrize("M", [1, 7, 103, 257])
@pytest.mark.parametrize("kind", KINDS)
def test_lengths_the_jax_wrapper_pads(kind, M):
    """Any M: the JAX dict_decode pads M up to its block and slices the pad
    off; the port needs no padding."""
    rng = np.random.default_rng(M)
    table = rng.normal(size=(6, 8)).astype(np.float32)
    idx = rng.integers(0, 6, (M,)).astype(np.int32)
    assert_same_bits(port_call(kind, table, idx),
                     jax_call(kind, table, jnp.asarray(idx)))


@pytest.mark.parametrize("bad", [[0, -1], [5], [2 ** 31], [2 ** 32]])
@pytest.mark.parametrize("kind", KINDS)
def test_out_of_range_raises_as_in_jax(kind, bad):
    """An index outside [0, R) raises IndexError in both packages, checked
    on the indices as given: an int64 index of 2**31 or 2**32 is not
    narrowed to int32 first."""
    table = np.ones((5, 4), np.float32)
    idx = np.array(bad, np.int64 if max(bad) >= 2 ** 31 else np.int32)
    with pytest.raises(IndexError, match="out of range"):
        jax_call(kind, table, idx)
    with pytest.raises(IndexError, match="out of range"):
        port_call(kind, table, idx)


@pytest.mark.parametrize("kind", KINDS)
def test_a_table_of_zero_rows_raises(kind):
    table = np.ones((0, 4), np.float32)
    idx = np.zeros(3, np.int32)
    with pytest.raises(IndexError, match="out of range"):
        jax_call(kind, table, idx)
    with pytest.raises(IndexError, match="out of range"):
        port_call(kind, table, idx)


@pytest.mark.parametrize("kind", KINDS)
def test_int64_indices_gather_as_int32_ones(kind):
    rng = np.random.default_rng(3)
    table = rng.integers(-2 ** 31, 2 ** 31, (50, 3)).astype(np.int32)
    idx = rng.integers(0, 50, (200,))
    got = port_call(kind, table, idx.astype(np.int64))
    assert_same_bits(got, port_call(kind, table, idx.astype(np.int32)))
    assert_same_bits(got, jax_call(kind, table,
                                   jnp.asarray(idx.astype(np.int32))))


@pytest.mark.parametrize("case", ["float indices", "1-D table",
                                  "2-D indices", "complex table"])
@pytest.mark.parametrize("kind", KINDS)
def test_bad_inputs_are_refused(kind, case):
    table, idx = torch.ones(5, 3), torch.zeros(4, dtype=torch.int64)
    if case == "float indices":
        idx = idx.float()
    elif case == "1-D table":
        table = table[:, 0]
    elif case == "2-D indices":
        idx = idx[None]
    else:
        table = table.to(torch.complex64)
    fn = ops.take_rows if kind == "take_rows" \
        else (lambda t, i: ops.dict_decode(i, t))
    with pytest.raises((TypeError, ValueError)):
        fn(table, idx)


def test_cpu_gathers_count_no_launch_and_stay_differentiable():
    ops.reset_launch_counts()
    values = torch.arange(12.0).reshape(4, 3).requires_grad_()
    idx = torch.tensor([3, 0, 3], dtype=torch.int32)
    out = ops.take_rows(values, idx) + ops.dict_decode(idx, values)
    out.sum().backward()
    np.testing.assert_array_equal(values.grad.numpy(),
                                  [[2] * 3, [0] * 3, [0] * 3, [4] * 3])
    assert set(ops.launch_counts.values()) == {0}


def test_the_gradient_guard_names_the_roadmap_item():
    """The CUDA branch of every wrapper calls this before a launch: with
    grad enabled, an input that requires grad is refused, since the kernels
    have no backward yet; serving's inference mode and no_grad pass."""
    x, idx = torch.ones(3, requires_grad=True), torch.zeros(2)
    with pytest.raises(RuntimeError, match="queue 1, item 6"):
        ops._refuse_grad("take_rows", x, idx)
    with torch.no_grad():
        ops._refuse_grad("take_rows", x, idx)
    with torch.inference_mode():
        ops._refuse_grad("take_rows", x)
    ops._refuse_grad("take_rows", x.detach(), idx)
