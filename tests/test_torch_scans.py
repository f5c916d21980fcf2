"""The port's recurrence wrappers on CPU tensors (their plain versions)
against the JAX package: ``ops.wkv6`` against ``ref.wkv6_ref`` and the
Pallas ``wkv6`` kernel in interpret mode, ``ops.rglru_scan`` against
``ref.rglru_ref`` and the Pallas ``rglru_scan``, at the shapes of
tests/test_kernels.py and with its tolerances (1e-4 and 1e-5 in float32),
plus lengths the Pallas tiling refuses (S = 1, S no multiple of 16, a
ragged width) against the oracles.  On the card the wrappers launch
csrc/wkv6.cu and csrc/rglru_scan.cu instead; tests/test_torch_gpu.py and
chip_smoke.py hold them to the same plain versions there."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

WKV_TOL, LRU_TOL = 1e-4, 1e-5


def close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


def wkv_inputs(seed, B, S, H, N):
    """r, k, v, w, u, state as tests/test_kernels.py draws them."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return [rng.normal(size=(B, S, H, N)).astype(f) * 0.5,
            rng.normal(size=(B, S, H, N)).astype(f) * 0.5,
            rng.normal(size=(B, S, H, N)).astype(f),
            rng.uniform(0.05, 0.999, (B, S, H, N)).astype(f),
            (rng.normal(size=(H, N)) * 0.1).astype(f),
            rng.normal(size=(B, H, N, N)).astype(f) * 0.1]


def lru_inputs(seed, B, S, W, lo=0.8, hi=0.999):
    rng = np.random.default_rng(seed)
    return [rng.uniform(lo, hi, (B, S, W)).astype(np.float32),
            rng.normal(size=(B, S, W)).astype(np.float32),
            rng.normal(size=(B, W)).astype(np.float32)]


def port(fn, arrays):
    return [t.numpy() for t in fn(*(None if a is None else torch.from_numpy(a)
                                    for a in arrays))]


def jax_(fn, arrays, **kw):
    return [np.asarray(t) for t in fn(*(None if a is None else jnp.asarray(a)
                                        for a in arrays), **kw)]


@pytest.mark.parametrize("with_state", [True, False])
@pytest.mark.parametrize("B,S,H,N,chunk", [
    (1, 32, 2, 16, 8), (2, 64, 4, 32, 16), (1, 48, 2, 64, 16)])
def test_wkv6_cpu_matches_jax(B, S, H, N, chunk, with_state):
    arrays = wkv_inputs(B * S + N, B, S, H, N)
    if not with_state:
        arrays[5] = None
    out, state = port(ops.wkv6, arrays)
    for fn, kw in ((jref.wkv6_ref, {}), (jops.wkv6, {"chunk": chunk})):
        want, want_state = jax_(fn, arrays, **kw)
        close(out, want, WKV_TOL)
        close(state, want_state, WKV_TOL)


@pytest.mark.parametrize("S", [1, 15, 17, 20, 37])
def test_wkv6_any_length_matches_the_oracle(S):
    """The Pallas kernel and the JAX model's chunked form need S to be a
    multiple of their chunk; the function, and the port, do not."""
    arrays = wkv_inputs(S, 2, S, 3, 16)
    out, state = port(ops.wkv6, arrays)
    want, want_state = jax_(jref.wkv6_ref, arrays)
    assert out.shape == (2, S, 3, 16) and state.shape == (2, 3, 16, 16)
    close(out, want, WKV_TOL)
    close(state, want_state, WKV_TOL)


def test_wkv6_bf16_inputs():
    """bf16 r, k, v (f32 w), as the model feeds them: f32 math, the output
    rounded once to bf16, the state in f32."""
    arrays = wkv_inputs(5, 2, 24, 2, 32)
    t = [torch.from_numpy(a) for a in arrays]
    for i in range(3):
        t[i] = t[i].bfloat16()
    out, state = ops.wkv6(*t)
    assert out.dtype == torch.bfloat16 and state.dtype == torch.float32
    want, want_state = jref.wkv6_ref(
        *(jnp.asarray(x.float().numpy(), jnp.bfloat16) if i < 3
          else jnp.asarray(x.numpy()) for i, x in enumerate(t)))
    close(out.float(), np.asarray(want, np.float32), 2e-2)   # one bf16 ulp
    close(state, want_state, WKV_TOL)


@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("B,S,W,chunk,bw", [
    (1, 64, 128, 16, 128), (2, 256, 256, 64, 128), (1, 128, 512, 128, 512),
    (1, 32, 128, 16, 128)])
def test_rglru_cpu_matches_jax(B, S, W, chunk, bw, with_h0):
    arrays = lru_inputs(S + W, B, S, W)
    if not with_h0:
        arrays[2] = None
    h, h_last = port(ops.rglru_scan, arrays)
    for fn, kw in ((jref.rglru_ref, {}),
                   (jops.rglru_scan, {"chunk": chunk, "bw": bw})):
        want, want_last = jax_(fn, arrays, **kw)
        close(h, want, LRU_TOL)
        close(h_last, want_last, LRU_TOL)


@pytest.mark.parametrize("B,S,W", [(1, 1, 64), (2, 3, 100), (3, 17, 4100)])
def test_rglru_any_shape_matches_the_oracle(B, S, W):
    arrays = lru_inputs(W, B, S, W, lo=0.0, hi=1.0)
    h, h_last = port(ops.rglru_scan, arrays)
    want, want_last = jax_(jref.rglru_ref, arrays)
    close(h, want, LRU_TOL)
    close(h_last, want_last, LRU_TOL)
    close(h[:, -1], h_last, 0)


@pytest.mark.parametrize("case", ["N 8", "w bf16", "u shape", "state dtype",
                                  "empty S", "r 3-D"])
def test_wkv6_rejects_what_the_kernel_does_not_take(case):
    r, k, v, w, u, st = (torch.from_numpy(a) for a in
                         wkv_inputs(0, 1, 4, 2, 16))
    if case == "N 8":
        r, k, v, w = (x[..., :8] for x in (r, k, v, w))
        u, st = u[:, :8], st[..., :8, :8]
    elif case == "w bf16":
        w = w.bfloat16()
    elif case == "u shape":
        u = u[:1]
    elif case == "state dtype":
        st = st.double()
    elif case == "empty S":
        r, k, v, w = (x[:, :0] for x in (r, k, v, w))
    else:
        r = r[0]
    with pytest.raises((ValueError, TypeError)):
        ops.wkv6(r, k, v, w, u, st)


@pytest.mark.parametrize("case", ["b shape", "a bf16", "h0 shape", "empty"])
def test_rglru_rejects_what_the_kernel_does_not_take(case):
    a, b, h0 = (torch.from_numpy(x) for x in lru_inputs(0, 2, 5, 8))
    if case == "b shape":
        b = b[:, :4]
    elif case == "a bf16":
        a = a.bfloat16()
    elif case == "h0 shape":
        h0 = h0[:1]
    else:
        a, b = a[:, :0], b[:, :0]
    with pytest.raises(ValueError):
        ops.rglru_scan(a, b, h0)


def test_cpu_tensors_launch_nothing():
    ops.reset_launch_counts()
    ops.wkv6(*(torch.from_numpy(a) for a in wkv_inputs(1, 1, 3, 1, 16)))
    ops.rglru_scan(*(torch.from_numpy(a) for a in lru_inputs(1, 1, 3, 8)))
    assert ops.launch_counts["wkv6"] == ops.launch_counts["rglru_scan"] == 0
