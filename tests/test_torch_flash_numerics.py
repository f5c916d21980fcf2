"""The numerics contract of the bf16 tensor-core flash kernel, on the CPU.

``csrc/flash_attention.cu`` computes bf16 attention on the tensor cores
and cannot run here.  ``kernel_twin`` repeats its arithmetic in plain
PyTorch: per block of BQ query rows, an online softmax over BK-key tiles
from the first tile that holds a visible key to the causal diagonal,
scores scaled by scale * log2(e) and masked with the finite NEG_INF (keys
past T with -inf), P = exp2(s - m) summed unrounded into l and rounded to
bf16 before the f32 P V product, out = acc / max(l, 1e-30) in bf16.

The twin is held, on the same bf16 inputs made from a numpy seed, to the
JAX Pallas kernel in interpret mode (bq = bk = 64, as
tests/test_torch_kernels.py runs it) and to the JAX oracle
``attention_ref`` at rtol = atol = 2e-2, the bound that holds the CUDA
kernel to the port's ``ref.attention_ref`` on the card (chip_smoke.py,
tests/test_torch_gpu.py).  Without the P rounding the twin is the oracle
in float32 (2e-5): the tile bounds, the base-2 softmax and the masks change
nothing, and the P rounding, about one bf16 ulp of the output, is the
kernel's only new error.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

TOL = 2e-2
LOG2E = 1.4426950408889634
NEG_INF = -1e30

# (B, S, T, H, KV, hd, causal, window); S and T multiples of 64 for Pallas
PALLAS_CASES = {
    "hd 64 GQA causal": (2, 256, 256, 6, 3, 64, True, 0),
    "hd 256 MQA window": (1, 256, 256, 16, 1, 256, True, 64),
}
# the twin alone against the oracle at the kernel's other edges
EDGE_CASES = {
    "ragged S=T 200": (1, 200, 200, 3, 1, 64, True, 0),
    "ragged cross S 100 T 130 window": (2, 100, 130, 4, 2, 16, False, 48),
    "window's first tile not 0": (1, 1000, 1000, 2, 1, 64, True, 128),
    "hd 256 MQA non-causal": (1, 96, 150, 16, 1, 256, False, 0),
}
# (BQ, BK) tiles the kernel can be built with; hd <= 128 takes 64 x 64 and
# hd 256 64 x 32 by default (Bf16Tiles in the source)
TILES = [(64, 64), (64, 32), (128, 64)]


def bf16_inputs(seed, B, S, T, H, KV, hd):
    """Normal inputs rounded to bf16, as float32 numpy arrays (exactly
    representable in bf16)."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            .bfloat16().float().numpy()
            for s in ((B, S, H, hd), (B, T, KV, hd), (B, T, KV, hd))]


def kernel_twin(q, k, v, *, causal, window, bq, bk, round_p=True):
    """The bf16 kernel's arithmetic in plain PyTorch (float32 tensors of
    bf16 values in); float32 out, before the final cast to bf16."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale2 = float(np.float32(hd ** -0.5) * np.float32(LOG2E))
    qg = q.reshape(B, S, KV, G, hd)
    nk = -(-T // bk)
    out = torch.empty(B, S, KV, G, hd)
    for q0 in range(0, S, bq):
        rows = torch.arange(q0, min(q0 + bq, S))
        kt_lo = max(0, q0 - window + 1) // bk if window else 0
        kt_hi = min(nk, (min(q0 + bq, S) - 1) // bk + 1) if causal else nk
        m = torch.full((B, len(rows), KV, G), NEG_INF)
        l = torch.zeros(B, len(rows), KV, G)
        acc = torch.zeros(B, len(rows), KV, G, hd)
        for kt in range(kt_lo, kt_hi):
            keys = torch.arange(kt * bk, (kt + 1) * bk)
            kk = keys.clamp(max=T - 1)
            s = torch.einsum("bskgh,btkh->bskgt", qg[:, rows], k[:, kk]) \
                * scale2
            visible = torch.ones(len(rows), bk, dtype=torch.bool)
            if causal:
                visible &= keys[None, :] <= rows[:, None]
            if window:
                visible &= keys[None, :] > rows[:, None] - window
            s = torch.where(visible[None, :, None, None, :], s, NEG_INF)
            s = torch.where(keys >= T, float("-inf"), s)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            pv = p.bfloat16().float() if round_p else p
            acc = acc * alpha[..., None] + torch.einsum(
                "bskgt,btkh->bskgh", pv, v[:, kk])
            m = m_new
        out[:, rows] = acc / l.clamp(min=1e-30)[..., None]
    return out.reshape(B, S, H, hd)


@functools.lru_cache(maxsize=None)
def jax_outputs(name):
    """The Pallas kernel (interpret mode) and the oracle on bf16 inputs."""
    B, S, T, H, KV, hd, causal, window = PALLAS_CASES[name]
    arrays = bf16_inputs(S + hd, B, S, T, H, KV, hd)
    jin = [jnp.asarray(a, jnp.bfloat16) for a in arrays]
    pallas = jops.flash_attention(*jin, causal=causal, window=window, bq=64,
                                  bk=64)
    oracle = jref.attention_ref(*jin, causal=causal, window=window)
    return arrays, np.asarray(pallas, np.float32), \
        np.asarray(oracle, np.float32)


def twin_bf16(arrays, case, bq, bk):
    *_, causal, window = case
    out = kernel_twin(*(torch.from_numpy(a) for a in arrays), causal=causal,
                      window=window, bq=bq, bk=bk)
    return out.bfloat16().float().numpy()


@pytest.mark.parametrize("bq,bk", TILES)
@pytest.mark.parametrize("name", list(PALLAS_CASES))
def test_twin_matches_pallas_and_oracle(name, bq, bk):
    arrays, pallas, oracle = jax_outputs(name)
    out = twin_bf16(arrays, PALLAS_CASES[name], bq, bk)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, pallas, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out, oracle, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("bq,bk", TILES)
@pytest.mark.parametrize("name", list(EDGE_CASES))
def test_twin_matches_oracle_at_the_edges(name, bq, bk):
    case = EDGE_CASES[name]
    B, S, T, H, KV, hd, causal, window = case
    arrays = bf16_inputs(S + T + hd, B, S, T, H, KV, hd)
    out = twin_bf16(arrays, case, bq, bk)
    want = ref.attention_ref(*(torch.from_numpy(a).bfloat16()
                               for a in arrays), causal=causal,
                             window=window).float().numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", list(PALLAS_CASES) + list(EDGE_CASES))
def test_p_rounding_is_the_only_change(name):
    """Without the P rounding the twin is the oracle in float32: the tile
    bounds, the base-2 softmax and the masks are exact."""
    case = {**PALLAS_CASES, **EDGE_CASES}[name]
    B, S, T, H, KV, hd, causal, window = case
    arrays = bf16_inputs(1, B, S, T, H, KV, hd)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    exact = kernel_twin(q, k, v, causal=causal, window=window, bq=64, bk=64,
                        round_p=False)
    np.testing.assert_allclose(
        exact.numpy(), ref.attention_ref(q, k, v, causal=causal,
                                         window=window).numpy(),
        rtol=2e-5, atol=2e-5)
    rounded = kernel_twin(q, k, v, causal=causal, window=window, bq=64,
                          bk=64)
    err = (rounded - exact).abs().max().item()
    assert 0 < err <= TOL * max(1.0, exact.abs().max().item())
