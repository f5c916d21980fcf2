"""The port's dense DecoderLM on the CPU against the JAX package's, at
float32 on smoke_variant(smollm-135m), with the same weights (converted
from ``DecoderLM.init``) and the same numpy tokens: prefill logits, every
layer's KV cache and length, and decode steps, allclose at 2e-4 as in
tests/test_models_smoke.py."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.api import ModelAPI as JModelAPI  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.api import ModelAPI  # noqa: E402
from repro_torch.models.convert import load_jax_params  # noqa: E402

TOL = 2e-4
B, S, STEPS = 2, 12, 4


def build(seed, **over):
    """(JAX api, JAX params, port api) with the same weights."""
    jcfg = dataclasses.replace(
        jconfigs.smoke_variant(jconfigs.ARCHS["smollm-135m"]), **over)
    tcfg = dataclasses.replace(
        configs.smoke_variant(configs.ARCHS["smollm-135m"]), **over)
    japi = JModelAPI(jcfg)
    params = japi.model.init(jax.random.key(seed))
    api = ModelAPI(tcfg, device="cpu")
    load_jax_params(api.model, jax.tree.map(np.asarray, params))
    return japi, params, api


def close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


def check_caches(jc, tc):
    jc = jc["b0"]
    for i, c in enumerate(tc):
        assert int(jc["len"][i]) == c["len"]
        for name in ("k", "v", "k_scale", "v_scale"):
            if name not in c:
                assert name not in jc
                continue
            want = np.asarray(jc[name][i])
            if want.dtype == np.int8:       # int8 codes are equal
                np.testing.assert_array_equal(c[name].numpy(), want)
            else:
                close(c[name].numpy(), want)


@pytest.mark.parametrize("cache_len", [32, 8])        # 8 < S: ring cut
@pytest.mark.parametrize("variant", ["model", "int8", "pallas"])
def test_prefill_and_decode_match_jax(variant, cache_len):
    over = {"int8": {"kv_cache_dtype": "int8"},
            "pallas": {"attention_impl": "pallas"}}.get(variant, {})
    japi, params, api = build(11, **over)
    rng = np.random.default_rng(cache_len)
    vocab = api.cfg.vocab
    toks = rng.integers(1, vocab, (B, S)).astype(np.int32)
    shape = jconfigs.ShapeConfig("p", "prefill", cache_len, B)

    jlogits, jcaches = jax.jit(lambda p, b: japi.prefill(p, b, shape))(
        params, {"tokens": jnp.asarray(toks)})
    ops.reset_launch_counts()
    logits, caches = api.prefill({"tokens": torch.from_numpy(toks)},
                                 configs.ShapeConfig("p", "prefill",
                                                     cache_len, B))
    assert logits.shape == (B, 1, vocab)
    close(logits.numpy(), jlogits)
    check_caches(jcaches, caches)

    step = jax.jit(japi.serve_step)
    for t in range(STEPS):
        nxt = rng.integers(1, vocab, (B, 1)).astype(np.int32)
        pos = np.full((B, 1), S + t, np.int32)
        jlogits, jcaches = step(params, {"tokens": jnp.asarray(nxt),
                                         "positions": jnp.asarray(pos)},
                                jcaches)
        logits, caches = api.serve_step({"tokens": torch.from_numpy(nxt),
                                         "positions": torch.from_numpy(pos)},
                                        caches)
        close(logits.numpy(), jlogits)
        check_caches(jcaches, caches)
    assert ops.launch_counts["flash_attention"] == 0    # CPU: plain version


def test_decode_matches_prefill_dense():
    """Teacher-forced full-forward logits == prefill + step-by-step decode,
    on the port alone (tests/test_models_smoke.py's check)."""
    api = ModelAPI(configs.smoke_variant(configs.ARCHS["smollm-135m"]),
                   device="cpu")
    api.model.init(torch.Generator().manual_seed(2))
    m = api.model
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, api.cfg.vocab, (1, 8)).astype(np.int32))
    with torch.inference_mode():
        h, _ = m.backbone(m.embed_inputs(toks), "train", None,
                          torch.arange(8)[None, :])
        full = m.head(h)
    logits, caches = m.prefill({"tokens": toks[:, :4]}, cache_len=8)
    close(logits[0, 0], full[0, 3])
    for t in range(4, 8):
        step_logits, caches = m.decode_step(toks[:, t:t + 1], caches,
                                            torch.full((1, 1), t))
        if t < 7:
            close(step_logits[0, 0], full[0, t])


def test_weights_convert_leaf_for_leaf():
    japi, params, api = build(3)
    sd = api.model.state_dict()
    blocks = params["blocks"]["b0"]
    assert len(api.model.blocks) == api.cfg.n_layers
    close(sd["embed"], params["embed"], 0)
    close(sd["blocks.1.mix.wq"], blocks["mix"]["wq"][1], 0)
    close(sd["blocks.0.ln2.weight"], blocks["ln2"][0], 0)
    assert all(t.dtype == torch.float32 for t in sd.values())


@pytest.mark.parametrize("name", ["internvl2-26b", "whisper-medium"])
def test_vlm_and_audio_run_one_forward(name):
    """One train forward of each family on the CPU, from the inputs that
    ``input_specs`` describes, gives a finite loss."""
    api = ModelAPI(configs.smoke_variant(configs.ARCHS[name]), device="cpu")
    api.model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {}
    for k, spec in api.input_specs(configs.ShapeConfig("t", "train", 24,
                                                       2)).items():
        a = rng.integers(1, api.cfg.vocab, spec.shape) \
            if spec.dtype == torch.int32 else rng.normal(size=spec.shape)
        batch[k] = torch.from_numpy(a).to(spec.dtype)
    with torch.no_grad():
        loss, m = api.train_loss(batch)
    assert torch.isfinite(loss) and sorted(m) == ["loss", "total_loss"]


@pytest.mark.parametrize("fn", ["rms_norm", "layer_norm", "apply_rope",
                                "swiglu", "squared_relu", "gelu",
                                "softmax_xent"])
def test_layers_match_jax(fn):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 6, 4, 16)).astype(np.float32)
    w, b = (rng.normal(size=16).astype(np.float32) for _ in range(2))
    mats = [rng.normal(size=s).astype(np.float32) / 4
            for s in ((16, 32), (32, 16), (16, 32))]
    pos = np.arange(6, dtype=np.int32)[None, :] + 3
    labels = rng.integers(0, 16, size=(2, 6, 4)).astype(np.int32)
    t, j = torch.from_numpy, jnp.asarray
    if fn == "rms_norm":
        got = layers.rms_norm(t(x), t(w), 1e-5)
        want = jlayers.rms_norm(j(x), j(w), 1e-5)
    elif fn == "layer_norm":
        got = layers.layer_norm(t(x), t(w), t(b), 1e-5)
        want = jlayers.layer_norm(j(x), j(w), j(b), 1e-5)
    elif fn == "apply_rope":
        got = layers.apply_rope(t(x), t(pos), 10000.0)
        want = jlayers.apply_rope(j(x), j(pos), 10000.0)
    elif fn == "softmax_xent":
        got = layers.softmax_xent(t(x), t(labels))
        want = jlayers.softmax_xent(j(x), j(labels))
    else:
        wi, wo, wg = mats
        got = layers.mlp_apply(t(x), t(wi), t(wo), fn, t(wg))
        want = jlayers.mlp_apply({"wi": j(wi), "wo": j(wo), "wg": j(wg)},
                                 j(x), fn)
    close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_input_specs_match_jax(kind):
    tcfg = configs.ARCHS["smollm-135m"]
    jspecs = JModelAPI(jconfigs.ARCHS["smollm-135m"]).input_specs(
        jconfigs.ShapeConfig("s", kind, 64, 4))
    api = ModelAPI(configs.smoke_variant(tcfg), device="cpu")
    specs = api.input_specs(configs.ShapeConfig("s", kind, 64, 4))
    assert specs == {k: tuple(v.shape) for k, v in jspecs.items()}
