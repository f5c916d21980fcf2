"""The hand-written CUDA flash attention kernel against its plain version
on the card, at the shapes of tests/test_torch_kernels.py, in float32 and
bfloat16.  Skips without a CUDA card; run it there with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402

pytestmark = pytest.mark.gpu

# bf16: one rounding of the same f32 math; f32: summation order over T
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,T,H,KV,hd,causal,window", [
    (1, 128, 128, 2, 2, 32, True, 0),
    (2, 256, 256, 4, 2, 64, True, 0),
    (1, 128, 256, 4, 1, 32, True, 0),
    (1, 128, 128, 2, 2, 32, False, 0),
    (1, 256, 256, 2, 2, 32, True, 32),
    (1, 200, 200, 3, 1, 64, True, 0),
    (2, 100, 130, 4, 2, 16, False, 48),
    (1, 96, 96, 2, 1, 128, True, 0),
])
def test_kernel_matches_plain(cuda, dtype, B, S, T, H, KV, hd, causal,
                              window):
    g = torch.Generator(device=cuda).manual_seed(S + T + hd)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(dtype)
               for s in ((B, S, H, hd), (B, T, KV, hd), (B, T, KV, hd)))
    before = ops.launch_counts["flash_attention"]
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert ops.launch_counts["flash_attention"] == before + 1
    want = ref.attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == want.shape
    torch.testing.assert_close(out.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_kernel_reads_strided_inputs(cuda):
    """q/k/v sliced out of one fused projection: strided, not copied."""
    g = torch.Generator(device=cuda).manual_seed(0)
    qkv = torch.randn(2, 64, 4 + 2 + 2, 32, generator=g, device=cuda)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    assert not q.is_contiguous()
    out = ops.flash_attention(q, k, v)
    torch.testing.assert_close(out, ref.attention_ref(q, k, v), rtol=2e-5,
                               atol=2e-5)
