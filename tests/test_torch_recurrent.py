"""The port's ssm (rwkv6-3b) and hybrid (recurrentgemma-9b) families on the
CPU against the JAX package, at float32 on their smoke variants, with the
same weights (converted from the JAX init) and the same numpy inputs:

- the RWKV-6 time mix and channel mix and the RG-LRU block, with and
  without a cache, in prefill and decode, every output and cache leaf;
- the whole model: prefill logits and every cache leaf, then 4 decode
  steps, at S 12 and S 48 (for the hybrid S 48 > its window of 32, so
  prefill keeps the last 32 keys and decode writes a ring);
- the JAX rwkv model's chunked prefill asserts S % 16 == 0 once S > 16,
  so at such lengths the port's time mix is held against the JAX time mix
  with its chunked form swapped for the sequential oracle;
- the converter's group/kind order and its refusals;
- ServeEngine and launch/serve.py on both families.

Tolerance 2e-4, as in tests/test_torch_model.py and
tests/test_models_smoke.py."""
import dataclasses
import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.models import rwkv6 as jrwkv  # noqa: E402
from repro.models.api import ModelAPI as JModelAPI  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import lm, rglru, rwkv6  # noqa: E402
from repro_torch.models.api import ModelAPI  # noqa: E402
from repro_torch.models.convert import (load_jax_params,  # noqa: E402
                                        state_dict_from_jax)
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

TOL = 2e-4
ARCHS = ["rwkv6-3b", "recurrentgemma-9b"]


def cfgs(name, **over):
    return (dataclasses.replace(jconfigs.smoke_variant(jconfigs.ARCHS[name]),
                                **over),
            dataclasses.replace(configs.smoke_variant(configs.ARCHS[name]),
                                **over))


def close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


def t(a):
    return torch.from_numpy(np.asarray(a).copy())


def module_from(cls, jparams, cfg):
    m = cls(cfg, torch.float32, "cpu")
    m.load_state_dict({k: t(v) for k, v in jparams.items()}, strict=True)
    return m


def sub_block_inputs(seed, cfg, S, cache_leaves):
    """x (B, S, d) and a random cache of the given leaf shapes."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, S, cfg.d_model)).astype(np.float32)
    cache = {k: (rng.normal(size=s) * 0.3).astype(np.float32)
             for k, s in cache_leaves.items()}
    return x, cache


CASES = [("prefill", 12, True), ("train", 12, False), ("decode", 1, True),
         ("prefill", 1, True)]


@pytest.mark.parametrize("mode,S,cached", CASES)
@pytest.mark.parametrize("part", ["time", "channel"])
def test_rwkv_sub_blocks_match_jax(part, mode, S, cached):
    jcfg, cfg = cfgs("rwkv6-3b")
    init, apply_j, cls = {
        "time": (jrwkv.rwkv_time_init, jrwkv.rwkv_time_apply, rwkv6.RWKVTime),
        "channel": (jrwkv.rwkv_channel_init, jrwkv.rwkv_channel_apply,
                    rwkv6.RWKVChannel)}[part]
    jp = jax.tree.map(np.asarray, init(jax.random.key(1), jcfg, jnp.float32))
    m = module_from(cls, jp, cfg)
    N = cfg.rwkv_head_dim
    H = cfg.d_model // N
    leaves = {"shift": (2, cfg.d_model)}
    if part == "time":
        leaves["state"] = (2, H, N, N)
    x, cache = sub_block_inputs(S, cfg, S, leaves)
    jcache = {k: jnp.asarray(v) for k, v in cache.items()} if cached else None
    tcache = {k: t(v) for k, v in cache.items()} if cached else None
    want, jnew = apply_j(jp, jnp.asarray(x), jcfg, mode, jcache)
    with torch.inference_mode():
        got, tnew = m(t(x), cfg, mode, tcache)
    close(got, want)
    if cached:
        assert tnew is tcache                       # updated in place
        for k in leaves:
            close(tcache[k], jnew[k])
    else:
        assert tnew is None


@pytest.mark.parametrize("S", [20, 33])
def test_rwkv_time_mix_at_any_length(monkeypatch, S):
    """At S 20 the JAX time mix's chunked prefill asserts (chunk 16); with
    it swapped for the sequential oracle, the port agrees."""
    jcfg, cfg = cfgs("rwkv6-3b")
    jp = jax.tree.map(np.asarray, jrwkv.rwkv_time_init(
        jax.random.key(2), jcfg, jnp.float32))
    m = module_from(rwkv6.RWKVTime, jp, cfg)
    N = cfg.rwkv_head_dim
    x, cache = sub_block_inputs(S, cfg, S, {
        "shift": (2, cfg.d_model), "state": (2, cfg.d_model // N, N, N)})
    jcache = {k: jnp.asarray(v) for k, v in cache.items()}
    with pytest.raises(AssertionError, match="divisible by chunk"):
        jrwkv.rwkv_time_apply(jp, jnp.asarray(x), jcfg, "prefill", jcache)
    monkeypatch.setattr(jrwkv, "wkv6_chunked",
                        lambda r, k, v, w, u, state=None, chunk=0:
                        jref.wkv6_ref(r, k, v, w, u, state))
    want, jnew = jrwkv.rwkv_time_apply(jp, jnp.asarray(x), jcfg, "prefill",
                                       jcache)
    tcache = {k: t(v) for k, v in cache.items()}
    with torch.inference_mode():
        got, _ = m(t(x), cfg, "prefill", tcache)
    close(got, want)
    for k in cache:
        close(tcache[k], jnew[k])


@pytest.mark.parametrize("mode,S,cached", CASES)
def test_rglru_block_matches_jax(mode, S, cached):
    jcfg, cfg = cfgs("recurrentgemma-9b")
    jp = jax.tree.map(np.asarray, jrglru.rglru_init(jax.random.key(3), jcfg,
                                                   jnp.float32))
    m = module_from(rglru.RGLRU, jp, cfg)
    w = cfg.lru_width
    leaves = {"h": (2, w), "conv": (2, cfg.conv_width - 1, w)}
    x, cache = sub_block_inputs(S + 7, cfg, S, leaves)
    jcache = {k: jnp.asarray(v) for k, v in cache.items()} if cached else None
    tcache = {k: t(v) for k, v in cache.items()} if cached else None
    want, jnew = jrglru.rglru_block_apply(jp, jnp.asarray(x), jcfg, mode,
                                          jcache)
    with torch.inference_mode():
        got, tnew = m(t(x), cfg, mode, tcache)
    close(got, want)
    if cached:
        assert tnew is tcache
        for k in leaves:
            close(tcache[k], jnew[k])


def test_rglru_pieces_match_jax():
    """Gates, coefficients and the causal conv with a carried state."""
    jcfg, cfg = cfgs("recurrentgemma-9b")
    jp = jax.tree.map(np.asarray, jrglru.rglru_init(jax.random.key(4), jcfg,
                                                   jnp.float32))
    m = module_from(rglru.RGLRU, jp, cfg)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 9, cfg.lru_width)).astype(np.float32)
    st = rng.normal(size=(2, cfg.conv_width - 1, cfg.lru_width)).astype(
        np.float32)
    with torch.inference_mode():
        got = rglru.coeffs(m, t(x))
    for g, w in zip(got, jrglru._coeffs(jp, jnp.asarray(x))):
        close(g, w, 1e-6)
    for s in (None, st):
        with torch.inference_mode():
            got = rglru.conv1d_apply(m.conv, t(x),
                                     None if s is None else t(s))
        want = jrglru.conv1d_apply(jp["conv"], jnp.asarray(x),
                                   None if s is None else jnp.asarray(s))
        for g, w in zip(got, want):
            close(g, w, 1e-6)


# --------------------------------------------------------------------------
# the whole model
# --------------------------------------------------------------------------

def build(name, seed, **over):
    """(JAX api, JAX params, port api) with the same weights."""
    jcfg, cfg = cfgs(name, **over)
    japi = JModelAPI(jcfg)
    params = japi.model.init(jax.random.key(seed))
    api = ModelAPI(cfg, device="cpu")
    load_jax_params(api.model, jax.tree.map(np.asarray, params))
    return japi, params, api


def flat_leaves(c, prefix=""):
    for k, v in c.items():
        if isinstance(v, dict):
            yield from flat_leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


def check_caches(model, jc, tc):
    k = len(model.kinds)
    assert len(tc) == model.groups * k
    for idx, c in enumerate(tc):
        g, i = divmod(idx, k)
        jleaves = dict(flat_leaves(jc[f"b{i}"]))
        tleaves = dict(flat_leaves(c))
        assert set(jleaves) == set(tleaves), (jleaves.keys(), tleaves.keys())
        for name, v in tleaves.items():
            want = np.asarray(jleaves[name][g])
            if name == "len":
                assert v == int(want)
            else:
                assert tuple(v.shape) == want.shape, name
                close(v.numpy(), want)


@pytest.mark.parametrize("S", [12, 48])
@pytest.mark.parametrize("name", ARCHS)
def test_prefill_and_decode_match_jax(name, S):
    japi, params, api = build(name, 21)
    rng = np.random.default_rng(S)
    vocab, B, cache_len, steps = api.cfg.vocab, 2, 64, 4
    toks = rng.integers(1, vocab, (B, S)).astype(np.int32)
    shape = jconfigs.ShapeConfig("p", "prefill", cache_len, B)
    jlogits, jcaches = jax.jit(lambda p, b: japi.prefill(p, b, shape))(
        params, {"tokens": jnp.asarray(toks)})
    ops.reset_launch_counts()
    logits, caches = api.prefill(
        {"tokens": torch.from_numpy(toks)},
        configs.ShapeConfig("p", "prefill", cache_len, B))
    assert logits.shape == (B, 1, vocab)
    close(logits.numpy(), jlogits)
    check_caches(api.model, jcaches, caches)
    if name == "recurrentgemma-9b":
        ring = caches[2]
        assert ring["k"].shape[1] == api.cfg.local_window == 32
        assert ring["len"] == min(S, 32)

    step = jax.jit(japi.serve_step)
    for i in range(steps):
        nxt = rng.integers(1, vocab, (B, 1)).astype(np.int32)
        pos = np.full((B, 1), S + i, np.int32)
        jlogits, jcaches = step(params, {"tokens": jnp.asarray(nxt),
                                         "positions": jnp.asarray(pos)},
                                jcaches)
        logits, caches = api.serve_step({"tokens": torch.from_numpy(nxt),
                                         "positions": torch.from_numpy(pos)},
                                        caches)
        close(logits.numpy(), jlogits)
        check_caches(api.model, jcaches, caches)
    assert all(n == 0 for n in ops.launch_counts.values())   # CPU: plain


@pytest.mark.parametrize("name", ARCHS)
def test_decode_matches_prefill_recurrent(name):
    """Prefill of 4 tokens then decode == the full forward, on the port
    alone (tests/test_models_smoke.py's check, at its 5e-3)."""
    api = ModelAPI(configs.smoke_variant(configs.ARCHS[name]), device="cpu")
    api.model.init(torch.Generator().manual_seed(3))
    m = api.model
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, api.cfg.vocab, (1, 8)).astype(np.int32))
    with torch.inference_mode():
        h, _ = m.backbone(m.embed_inputs(toks), "train", None,
                          torch.arange(8)[None, :])
        full = m.head(h)
    logits, caches = m.prefill({"tokens": toks[:, :4]}, cache_len=8)
    close(logits[0, 0], full[0, 3], 5e-3)
    for i in range(4, 7):
        step_logits, caches = m.decode_step(toks[:, i:i + 1], caches,
                                            torch.full((1, 1), i))
        close(step_logits[0, 0], full[0, i], 5e-3)


# --------------------------------------------------------------------------
# structure, converter, init
# --------------------------------------------------------------------------

def test_hybrid_groups_drop_the_remainder():
    """38 layers of (rec, rec, attn) make 12 groups, 36 sub-blocks, as in
    the JAX package's n_groups."""
    from repro.models.lm import n_groups as j_n_groups
    full = configs.ARCHS["recurrentgemma-9b"]
    assert lm.n_groups(full) == j_n_groups(jconfigs.ARCHS[full.name]) == 12
    _, cfg = cfgs("recurrentgemma-9b", n_layers=7)
    m = lm.DecoderLM(cfg, device="cpu")
    assert m.groups == 2 and len(m.blocks) == 6
    assert [b.kind for b in m.blocks] == ["rec", "rec", "attn"] * 2
    assert lm.n_groups(configs.ARCHS["rwkv6-3b"]) == 32


def test_converter_orders_group_then_kind():
    japi, params, api = build("recurrentgemma-9b", 5, n_layers=6)
    sd = api.model.state_dict()
    b = params["blocks"]
    for g in range(2):
        for i, leaf in ((0, "wx"), (1, "lam"), (2, "wq")):
            key = f"blocks.{3 * g + i}.mix.{leaf}"
            close(sd[key], b[f"b{i}"]["mix"][leaf][g], 0)
        close(sd[f"blocks.{3 * g + 2}.ln2.weight"], b["b2"]["ln2"][g], 0)
    japi, params, api = build("rwkv6-3b", 5, n_layers=3)
    sd = api.model.state_dict()
    close(sd["blocks.2.time.u"], params["blocks"]["b0"]["time"]["u"][2], 0)
    close(sd["blocks.1.channel.wk"],
          params["blocks"]["b0"]["channel"]["wk"][1], 0)


@pytest.mark.parametrize("fault", ["missing", "extra", "misshapen",
                                   "kinds", "groups"])
def test_converter_refuses_a_bad_pytree(fault):
    japi, params, api = build("recurrentgemma-9b", 6)
    p = jax.tree.map(np.asarray, params)
    if fault == "missing":
        del p["blocks"]["b1"]["mix"]["lam"]
    elif fault == "extra":
        p["blocks"]["b0"]["mix"]["extra"] = p["blocks"]["b0"]["mix"]["lam"]
    elif fault == "misshapen":
        p["blocks"]["b2"]["mix"]["wq"] = p["blocks"]["b2"]["mix"]["wq"][
            ..., :8]
    elif fault == "kinds":
        p["blocks"]["b3"] = p["blocks"]["b2"]
    else:
        p["blocks"]["b0"] = jax.tree.map(lambda a: np.concatenate([a, a]),
                                         p["blocks"]["b0"])
    with pytest.raises((ValueError, RuntimeError)):
        load_jax_params(api.model, p)


def test_state_dict_covers_every_leaf():
    for name in ARCHS:
        japi, params, api = build(name, 7)
        sd = state_dict_from_jax(jax.tree.map(np.asarray, params), api.cfg)
        assert set(sd) == set(api.model.state_dict())


def test_cpu_generator_gives_the_same_weights_as_before():
    """Drawing on the generator's device leaves the CPU generator's weights
    as they were: the sha256 of smollm-135m's smoke weights from seed 0,
    as the init that always drew on the CPU gave them."""
    api = ModelAPI(configs.smoke_variant(configs.ARCHS["smollm-135m"]),
                   device="cpu")
    api.model.init(torch.Generator().manual_seed(0))
    h = hashlib.sha256()
    for k, v in api.model.state_dict().items():
        h.update(k.encode())
        h.update(v.numpy().tobytes())
    assert h.hexdigest() == ("cd52060001a48e9fdd28de4af55c99a29eda81d61f2ef"
                             "bef42e98e85949fa871")


@pytest.mark.parametrize("name", ARCHS)
def test_init_draws_the_jax_distributions(name):
    """Fixed leaves equal the JAX init's; random ones have its mean and
    spread (at d_model 512, so that each leaf holds enough draws)."""
    jcfg, cfg = cfgs(name, d_model=512, lru_width=512 * (name != ARCHS[0]))
    jp = jax.tree.map(np.asarray,
                      JModelAPI(jcfg).model.init(jax.random.key(0)))
    m = lm.DecoderLM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    sd = m.state_dict()
    jflat = {}
    k = len(m.kinds)
    for i in range(k):
        for leaf, v in flat_leaves(jp["blocks"][f"b{i}"]):
            jflat[f"blocks.{i}.{leaf}"] = v[0]
    for key, v in jflat.items():
        key = key.replace("ln1", "ln1.weight").replace("ln2", "ln2.weight")
        got = sd[key].numpy()
        if key.endswith(("w0", "ln_w", "weight")):
            close(got, v, 0)
        else:       # another generator: the same mean and spread
            assert abs(got.mean() - v.mean()) <= 0.3 * v.std(), key
            assert abs(got.std() - v.std()) <= 0.3 * v.std(), key


# --------------------------------------------------------------------------
# engine and launcher
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_engine_matches_jax_engine(monkeypatch, name):
    """Greedy tokens of the port's engine == the JAX engine's, until a
    near-tie (top-2 gap within the tolerance); the JAX rwkv prefill runs
    with the sequential oracle for its chunked form, which asserts at
    these padded lengths."""
    monkeypatch.setattr(jrwkv, "wkv6_chunked",
                        lambda r, k, v, w, u, state=None, chunk=0:
                        jref.wkv6_ref(r, k, v, w, u, state))
    japi, params, api = build(name, 8)
    rng = np.random.default_rng(10)
    prompts = [rng.integers(1, api.cfg.vocab, n).astype(np.int32)
               for n in (5, 19, 40)]
    batch, max_seq, max_new = 3, 64, 5
    jengine = JServeEngine(japi, params, batch=batch, max_seq=max_seq)
    jouts = jengine.run_batch([JRequest(p, max_new) for p in prompts])
    engine = ServeEngine(api, batch=batch, max_seq=max_seq)
    outs = engine.run_batch([Request(p, max_new) for p in prompts])
    assert engine.stats["decode_steps"] == max_new
    assert [len(o) for o in outs] == [max_new] * batch
    for i in range(batch):
        if outs[i] != jouts[i]:
            # the first disagreement must be a rounding tie: recompute
            # JAX's logits teacher-forced on its own tokens up to there
            t0 = next(j for j in range(max_new) if outs[i][j] != jouts[i][j])
            toks = np.concatenate([prompts[i], jouts[i][:t0]])[None]
            jl, _ = japi.prefill(params, {"tokens": jnp.asarray(
                toks.astype(np.int32))}, jconfigs.ShapeConfig(
                    "p", "prefill", max_seq, 1))
            top2 = np.sort(np.asarray(jl[0, -1]))[-2:]
            assert top2[1] - top2[0] <= 2 * TOL, (i, t0)


@pytest.mark.parametrize("name", ARCHS)
def test_serve_main_runs_recurrent_on_cpu(name, capsys):
    engine = serve.main(["--arch", name, "--smoke", "--device", "cpu",
                         "--rounds", "2", "--batch", "2", "--max-new", "3",
                         "--max-seq", "80"])
    assert engine.stats["decode_steps"] == 6
    assert engine.stats["prefill_tokens"] > 0
    zeros = dict.fromkeys(ops.launch_counts, 0)
    assert f"kernel launches {zeros}" in capsys.readouterr().out
