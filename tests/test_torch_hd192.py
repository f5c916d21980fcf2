"""Attention at head dim 192 (nemotron-4-340b's 18432 / 96) in the port on
the CPU, against the JAX package: ``ops.flash_attention`` (its plain
version here; the CUDA kernel on the card) against the jnp oracle, the
Pallas kernel in interpret mode and the model's chunked path, at 1e-4 in
float32; its meta path; the head dim of every configured arch with
attention within the kernel's reach; a two-layer dense model with heads of
192 and nemotron's squared-ReLU MLP, prefill and decode, against the JAX
model with the same weights; and nemotron-4-340b's ``prefill_32k`` cell at
full width, cut to one layer, through ``lower_cell`` on meta."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models.api import ModelAPI as JModelAPI  # noqa: E402
from repro.models.attention import chunked_attention as j_chunked  # noqa
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import SUPPORTED_HD  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models.api import ModelAPI  # noqa: E402
from repro_torch.models.convert import load_jax_params  # noqa: E402

TOL = 1e-4
HD = 192

CASES = [  # (B, S, T, H, KV, causal, window)
    (1, 128, 128, 2, 2, True, 0),
    (2, 128, 128, 12, 1, True, 0),         # GQA G 12, as nemotron's 96 / 8
    (1, 64, 128, 4, 2, True, 0),           # cross-length
    (1, 128, 128, 4, 1, False, 0),         # non-causal
    (1, 128, 128, 4, 2, True, 32),         # a local window
    (2, 100, 100, 12, 1, True, 0),         # ragged: no Pallas comparison
]


def inputs(seed, B, S, T, H, KV):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((B, S, H, HD), (B, T, KV, HD), (B, T, KV, HD))]


def close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("B,S,T,H,KV,causal,window", CASES)
def test_flash_at_hd192_matches_jax(B, S, T, H, KV, causal, window):
    arrays = inputs(S + T + H, B, S, T, H, KV)
    ops.reset_launch_counts()
    out = ops.flash_attention(*(torch.from_numpy(a) for a in arrays),
                              causal=causal, window=window).numpy()
    assert out.shape == (B, S, H, HD)
    assert ops.launch_counts["flash_attention"] == 0     # the plain version
    j = [jnp.asarray(a) for a in arrays]
    close(out, jref.attention_ref(*j, causal=causal, window=window))
    if S % 64 == 0 and T % 64 == 0:        # the Pallas kernel's tiling
        close(out, jops.flash_attention(*j, causal=causal, window=window,
                                        bq=64, bk=64))
    close(out, j_chunked(*j, causal=causal, window=window, chunk=64))


def test_meta_at_hd192_counts_no_launch():
    q = torch.empty(2, 512, 96, HD, device="meta")
    k = v = torch.empty(2, 512, 8, HD, device="meta")
    ops.reset_launch_counts()
    out = ops.flash_attention(q, k, v, causal=True)
    assert out.device.type == "meta" and out.shape == q.shape
    assert sum(ops.launch_counts.values()) == 0


@pytest.mark.parametrize("name", sorted(
    n for n, c in configs.ARCHS.items() if c.family != "ssm"))
def test_every_attention_head_dim_is_in_reach(name):
    """Every configured arch that runs attention (all but the RWKV-6 ssm)
    has a head dim the kernel is built for."""
    assert configs.ARCHS[name].hd in SUPPORTED_HD


def test_tiny_hd192_model_matches_jax():
    """Two dense layers of 2 query and 1 KV heads of 192 with nemotron's
    squared-ReLU MLP: prefill logits, the caches' lengths and 4 decode
    steps against the JAX model with the converted weights, at the 2e-4
    of tests/test_torch_model.py."""
    over = dict(n_layers=2, d_model=96, n_heads=2, n_kv_heads=1,
                head_dim=HD, d_ff=128, vocab=256)
    jcfg = dataclasses.replace(
        jconfigs.smoke_variant(jconfigs.ARCHS["nemotron-4-340b"]), **over)
    tcfg = dataclasses.replace(
        configs.smoke_variant(configs.ARCHS["nemotron-4-340b"]), **over)
    assert tcfg.mlp == "squared_relu" and tcfg.hd == HD
    japi = JModelAPI(jcfg)
    params = japi.model.init(jax.random.key(3))
    api = ModelAPI(tcfg, device="cpu")
    load_jax_params(api.model, jax.tree.map(np.asarray, params))
    B, S = 2, 12
    rng = np.random.default_rng(5)
    toks = rng.integers(1, tcfg.vocab, (B, S)).astype(np.int32)
    jlogits, jcaches = jax.jit(lambda p, b: japi.prefill(
        p, b, jconfigs.ShapeConfig("p", "prefill", 32, B)))(
            params, {"tokens": jnp.asarray(toks)})
    logits, caches = api.prefill({"tokens": torch.from_numpy(toks)},
                                 configs.ShapeConfig("p", "prefill", 32, B))
    close(logits.numpy(), jlogits, 2e-4)
    assert [c["len"] for c in caches] == [int(n)
                                          for n in jcaches["b0"]["len"]]
    step = jax.jit(japi.serve_step)
    for t in range(4):
        nxt = rng.integers(1, tcfg.vocab, (B, 1)).astype(np.int32)
        pos = np.full((B, 1), S + t, np.int32)
        jlogits, jcaches = step(params, {"tokens": jnp.asarray(nxt),
                                         "positions": jnp.asarray(pos)},
                                jcaches)
        logits, caches = api.serve_step({"tokens": torch.from_numpy(nxt),
                                         "positions": torch.from_numpy(pos)},
                                        caches)
        close(logits.numpy(), jlogits, 2e-4)


def test_nemotron_prefill_32k_on_meta():
    """nemotron-4-340b at full width (d_model 18432, 96 + 8 heads of 192,
    d_ff 73728), one of its 96 layers, ``prefill_32k`` on the "single"
    mesh: 256 ranks of a fake group, flash counted once on each rank's
    heads, no launch."""
    arch = dataclasses.replace(configs.ARCHS["nemotron-4-340b"], n_layers=1)
    ops.reset_launch_counts()
    ok, info = dryrun.lower_cell(arch, "prefill_32k", "single", save=False)
    assert ok and info["chips"] == 256 and info["device"] == "meta"
    assert info["counts"]["kernels"]["flash_attention"]["calls"] == 1
    assert sum(ops.launch_counts.values()) == 0
    roof = info["roofline"]
    assert roof["flops_tensor_cores"] > 0 and roof["step_time_bound_s"] > 0
    assert info["peak_bytes_per_device"] >= info["arg_bytes_per_device"] > 0
