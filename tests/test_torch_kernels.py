"""The port's flash attention wrapper on CPU tensors (its plain version)
against the JAX package: the jnp oracle, the Pallas kernel in interpret
mode and the model's chunked path.  Same numpy inputs, tolerance 2e-5 in
float32 as in tests/test_kernels.py.  On the card the wrapper launches
the CUDA kernel instead; chip_smoke.py holds it to the same plain
version there."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models.attention import chunked_attention as j_chunked  # noqa
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.models.attention import chunked_attention  # noqa: E402

TOL = 2e-5


def inputs(seed, B, S, T, H, KV, hd):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((B, S, H, hd), (B, T, KV, hd), (B, T, KV, hd))]


def port(fn, arrays, **kw):
    return fn(*(torch.from_numpy(a) for a in arrays), **kw).numpy()


def jax_(fn, arrays, **kw):
    return np.asarray(fn(*(jnp.asarray(a) for a in arrays), **kw))


def close(a, b):
    np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


CASES = [
    # (B, S, T, H, KV, hd, causal, window) at the shapes of test_kernels.py
    (1, 128, 128, 2, 2, 32, True, 0),
    (2, 256, 256, 4, 2, 64, True, 0),      # GQA G=2
    (1, 128, 256, 4, 1, 32, True, 0),      # MQA, cross-length
    (1, 128, 128, 2, 2, 32, False, 0),     # non-causal
    (1, 256, 256, 2, 2, 32, True, 32),     # local windows
    (1, 256, 256, 2, 2, 32, True, 64),
    (1, 256, 256, 2, 2, 32, True, 128),
    (2, 128, 128, 4, 2, 32, True, 0),      # test_flash_matches_model_chunked
]


@pytest.mark.parametrize("B,S,T,H,KV,hd,causal,window", CASES)
def test_flash_cpu_matches_jax(B, S, T, H, KV, hd, causal, window):
    arrays = inputs(hash((B, S, T, H, KV, hd, window)) % 2**32,
                    B, S, T, H, KV, hd)
    out = port(ops.flash_attention, arrays, causal=causal, window=window)
    close(out, jax_(jref.attention_ref, arrays, causal=causal,
                    window=window))
    close(out, jax_(jops.flash_attention, arrays, causal=causal,
                    window=window, bq=64, bk=64))
    close(out, jax_(j_chunked, arrays, causal=causal, window=window,
                    chunk=64))


@pytest.mark.parametrize("B,S,T,H,KV,hd,causal,window", CASES)
def test_chunked_matches_jax(B, S, T, H, KV, hd, causal, window):
    arrays = inputs(7, B, S, T, H, KV, hd)
    kw = dict(causal=causal, window=window, chunk=64, q_chunk=64)
    close(port(chunked_attention, arrays, **kw),
          jax_(j_chunked, arrays, **kw))


def test_ref_bf16_matches_jax():
    """bf16 in, f32 math, bf16 out: equal up to one bf16 rounding."""
    arrays = inputs(3, 2, 64, 64, 4, 2, 32)
    out = ref.attention_ref(*(torch.from_numpy(a).bfloat16()
                              for a in arrays), causal=True)
    assert out.dtype == torch.bfloat16
    want = jref.attention_ref(*(jnp.asarray(a, jnp.bfloat16)
                                for a in arrays), causal=True)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_ragged_lengths():
    """S and T that are not tile multiples need no fallback."""
    arrays = inputs(5, 1, 200, 200, 3, 1, 64)
    close(port(ops.flash_attention, arrays, causal=True),
          jax_(jref.attention_ref, arrays, causal=True))


@pytest.mark.parametrize("bad", ["hd", "dtype", "stride", "heads", "shape",
                                 "no visible key"])
def test_wrapper_rejects(bad):
    q, k, v = (torch.from_numpy(a) for a in inputs(1, 1, 16, 16, 4, 2, 32))
    if bad == "hd":
        q, k, v = q[..., :24].contiguous(), k[..., :24].contiguous(), \
            v[..., :24].contiguous()
    elif bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "stride":
        q = q.transpose(1, 3).contiguous().transpose(1, 3)
    elif bad == "heads":
        q = q[:, :, :3]
    elif bad == "shape":
        v = v[:, :8]
    else:                                   # S=16 >= T=8 + window=8
        k, v = k[:, :8], v[:, :8]
    with pytest.raises((ValueError, TypeError)):
        ops.flash_attention(q, k, v, window=8)


def test_cpu_calls_leave_the_launch_count_at_zero():
    ops.reset_launch_counts()
    arrays = inputs(2, 1, 64, 64, 2, 1, 16)
    port(ops.flash_attention, arrays, causal=True)
    assert set(ops.launch_counts.values()) == {0}


def test_other_devices_get_no_fallback():
    q, k, v = (torch.empty(s, device="meta")
               for s in ((1, 16, 2, 32), (1, 16, 2, 32), (1, 16, 2, 32)))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops.flash_attention(q, k, v)


def test_build_fails_loudly_without_nvcc(monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(build.os.path, "exists", lambda _: False)
    monkeypatch.setattr(build, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load("flash_attention")
    with pytest.raises(FileNotFoundError):
        build.load("no_such_kernel")
    assert build.library_path("flash_attention").parent == build.BUILD_DIR
